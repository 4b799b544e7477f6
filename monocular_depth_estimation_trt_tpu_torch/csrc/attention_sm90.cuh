// The Hopper attention mainloop of kernels K1 (flash_attention_packed.cu),
// K2 (flash_attention.cu) and K3 (flash_attention_batched.cu), bf16 only:
// non-causal softmax(q k^T * scale) v over (B, H, N, d) operands that are
// read through their own strides, with the output written as (B, N, H, d),
// for a head width d of 64 or 128 (a template parameter, Config::kD) and,
// in its wide form (attention_wide, below), any multiple of 64 above 128.
//
// Replaces the bf16 forms of the TPU kernels
//   monocular_depth_estimation_trt_tpu/ops/pallas/flash_attention.py::_attn_kernel_packed (K1)
//   monocular_depth_estimation_trt_tpu/ops/pallas/flash_attention.py::_attn_kernel (K2)
//   monocular_depth_estimation_trt_tpu/ops/pallas/flash_attention.py::_attn_kernel_batched (K3)
// at every head width the JAX entry takes (it pads d > 128 to a multiple of
// 128, d_pad). What bounds it on the H100: 4*B*H*N^2*d operations at 989
// TFLOP/s against 4*B*H*N*d*2 bytes at 3.35 TB/s; operations at every path
// shape but Depth Pro's patch (35, 16, 577, 64), where the two meet. Its
// answer: TMA keeps the tiles coming without the consumer's registers, wgmma
// keeps S, P and O in registers, and one CTA's softmax overlaps another's
// wgmma where two fit an SM.
//
// CTA: one producer warpgroup, whose first thread issues every copy, and
// one consumer warpgroup of 64 query rows; two CTAs are resident on an SM,
// and setmaxnreg moves registers from the producer (24 a thread) to the
// consumer (232). Grid (ceil(N / 64), H, B).
//
// Tiles. Each head width has a default instantiation (tile 0, below) and
// other candidates of the per-shape tuner (ops/cuda/autotune.py, role K5),
// which the C entries take by index (dispatch_tile):
//   d = 64:  0 Head64 (128 keys x 3 stages, two CTAs an SM),
//            1 Head64Keys64 (64 keys x 4 stages, two CTAs an SM);
//   d = 128: 0 Head128 (64 keys x 2 stages, two CTAs an SM),
//            1 Head128Keys128 (128 keys x 3 stages, one CTA an SM).
// A one-CTA instantiation runs no setmaxnreg: every thread keeps the
// registers of its launch (up to 255).
// * d = 64 (Head64): K/V tiles of 128 keys in a ring of three stages. This
//   measured 9 to 14 % faster on the H100 than one CTA an SM with two
//   consumer warpgroups sharing its ring (scripts/torch_kernel_ab.py,
//   PERF.md): the two CTAs' prologues, epilogues and waits can interleave.
//   Three CTAs an SM give the kernel 80 registers a thread at launch, and
//   ptxas refuses the m64n128 wgmma at that count.
// * d = 128 (Head128): K/V tiles of 64 keys (a (K, V) stage is 32 KB) in a
//   ring of two stages beside the 16 KB Q tile; the consumer holds S (32
//   fp32), P (16) and O (64). Measured on the H100 against 128-key tiles in
//   a ring of three 64 KB stages at one CTA an SM, with every thread at 255
//   registers (scripts/torch_kernel_ab.py, PERF.md): K2 0.054 against 0.070
//   ms at (1, 32, 1029, 128), K3 0.18 against 0.25 ms at (16, 16, 577,
//   128). Three 64-key stages would leave two CTAs 112 bytes short of the
//   SM's shared memory.
//
// Loads: one rank-4 TMA tensor map per operand over (d, N, H, B), with the
// view's own byte strides, a box of 64 (d) x the tile's rows and the 128-byte
// swizzle. Under that swizzle a box row is at most 128 bytes (64 bf16), so a
// tile is kHalves = d / 64 boxes side by side in d, each its own region of
// rows x 128 bytes (one swizzle atom wide). TMA fills the rows past N of a
// head with zeros; scores of keys >= N are set to -inf on the last key tile.
// K and V stream through a ring of kStages (K tile, V tile) stages of kBlockK
// keys, guarded by full and empty mbarriers (an empty stage takes one
// arrival per consumer warp).
//
// S = Q.K^T: wgmma m64n{kBlockK}k16 (fp32 <- bf16 x bf16), Q and K both from
// shared memory and both K-major, d / 16 k16 steps (step kk reads region
// kk / 4 at byte 32 * (kk % 4)); S stays in registers. The softmax runs on
// the accumulator fragment: a row lives on the four threads of a quad, so a
// row reduction takes two shuffles; exp2 with scale*log2(e) folded into one
// FMA. P is cast to bf16 in registers and fed as the register A operand of
// wgmma m64n{d}k16 against the V tile in shared memory (V is (keys, d) with d
// contiguous: an MN-major B operand, transposed; at d = 128 its N extent
// spans two atoms, kTileHalf bytes apart: the descriptor's leading offset).
// O (64 x d fp32 a warpgroup) stays in registers for the whole loop. The
// epilogue stages O, cast to bf16, in the Q tile and writes it with one TMA
// store per 64-column region, which clips rows >= N.
//
// Two softmax modes, chosen by the kernel:
// * online (K1, K2): one pass over K/V; a running row max and sum, O
//   rescaled in registers by exp(m_old - m_new) on every tile, the
//   unnormalised exponentials cast before P.V, and the row sum divides once
//   at the end.
// * exact (K3): the TPU kernel's division before the cast. Pass 1 streams
//   only K tiles and keeps the row max m and the rescaled row sum l; pass 2
//   streams K and V again, recomputes S and forms P = exp(s*scale - m) / l,
//   as exp2(s*scale*log2(e) - (m*scale*log2(e) + log2(l))), cast to bf16
//   before P.V; O accumulates with no rescaling and the epilogue only casts.
//
// Left for later: ping-pong scheduling of two consumer warpgroups and
// overlap of the softmax with the next tile's wgmma inside a warpgroup (the
// wide form, at one CTA an SM, gains most from it); a persistent tile
// scheduler; RoPE fused into the Q/K tile load.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {
namespace sm90 {

// One instantiation of the mainloop: head width D, keys per K/V tile BlockK,
// stages of the ring, CTAs resident on an SM.
template <int D, int BlockK, int Stages, int MinCtas = 2>
struct Config {
  static_assert(D == 64 || D == 128, "head width 64 or 128");
  static_assert(BlockK == 64 || BlockK == 128, "64- or 128-key tiles");
  static constexpr int kD = D;
  static constexpr int kBlockQ = 64;  // query rows per CTA: the consumer warpgroup's wgmma M
  static constexpr int kBlockK = BlockK;
  static constexpr int kStages = Stages;
  static constexpr int kThreads = 256;  // the consumer warpgroup, then the producer warpgroup
  static_assert(MinCtas == 1 || MinCtas == 2, "one or two CTAs an SM");
  static constexpr int kMinCtas = MinCtas;  // CTAs resident on an SM
  static constexpr int kHalves = D / 64;  // 64-column regions of a tile
  static constexpr int kS = BlockK / 2;   // scores a consumer thread holds
  static constexpr int kO = D / 2;        // outputs a consumer thread holds
  // setmaxnreg (two CTAs an SM only): a CTA holds the registers of its
  // launch (the largest multiple of 8 a thread that lets two CTAs share the
  // SM's 64K: 128); the producer keeps 24 a thread and the consumer takes the
  // rest (232).
  static constexpr bool kSetMaxNReg = kMinCtas == 2;
  static constexpr int kLaunchRegs = 65536 / (kMinCtas * kThreads) / 8 * 8;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = (2 * kLaunchRegs - kProducerRegs) / 8 * 8;
  static constexpr uint32_t kQHalf = kBlockQ * 128;      // one 64-column region of Q
  static constexpr uint32_t kQBytes = kQHalf * kHalves;  // 8 KB at d = 64
  static constexpr uint32_t kTileHalf = kBlockK * 128;
  static constexpr uint32_t kTileBytes = kTileHalf * kHalves;  // 16 KB at d = 64
  // Shared memory, from a 1024-byte aligned base (the 128-byte swizzle
  // repeats every 8 rows of 128 bytes): the Q tile, the K tiles, the V tiles,
  // then the mbarriers: q_full, full[kStages], empty[kStages].
  static constexpr uint32_t kOffK = kQBytes;
  static constexpr uint32_t kOffV = kOffK + kStages * kTileBytes;
  static constexpr uint32_t kOffBar = kOffV + kStages * kTileBytes;
  static constexpr uint32_t kSmemBytes = kOffBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment
  static_assert(kMinCtas * (kSmemBytes + 1024) <= 233472,
                "kMinCtas CTAs must fit the SM's 228 KB of shared memory");
  static_assert(kSmemBytes <= 232448, "a CTA takes at most 227 KB of shared memory");
};

using Head64 = Config<64, 128, 3>;
using Head64Keys64 = Config<64, 64, 4>;
using Head128 = Config<128, 64, 2>;
using Head128Keys128 = Config<128, 128, 3, 1>;

// Calls launch_fn(Cfg{}) with the instantiation of tile `tile` at head width
// D (the table above); an index that width lacks is cudaErrorInvalidValue.
template <int D, typename F>
int dispatch_tile(int tile, F&& launch_fn) {
  static_assert(D == 64 || D == 128, "head width 64 or 128");
  if constexpr (D == 64) {
    switch (tile) {
      case 0: return launch_fn(Head64{});
      case 1: return launch_fn(Head64Keys64{});
    }
  } else {
    switch (tile) {
      case 0: return launch_fn(Head128{});
      case 1: return launch_fn(Head128Keys128{});
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// --- wgmma -----------------------------------------------------------------------

// d[64x128] (+)= A[64x16] . B[16x128], A and B from shared memory, both
// K-major; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64x64] (+)= A[64x16] . B[16x64], A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64x64] += A[64x16] . B[16x64], A from registers (a0..a3: this
// thread's fragment), B from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// d[64x128] += A[64x16] . B[16x128], A from registers, B from shared memory,
// MN-major (transposed): two 64-column atoms, the descriptor's leading
// offset apart.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                                    uint32_t a2, uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// S (+)= Q . K^T over one k16 step: N = kBlockK keys.
template <int N>
__device__ __forceinline__ void wgmma_scores(float (&s)[N / 2], uint64_t desc_q, uint64_t desc_k,
                                             int accumulate) {
  if constexpr (N == 128) {
    wgmma_m64n128k16_ss(s, desc_q, desc_k, accumulate);
  } else {
    wgmma_m64n64k16_ss(s, desc_q, desc_k, accumulate);
  }
}

// O += P . V over one k16 step: N = d.
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&o)[N / 2], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc_v) {
  if constexpr (N == 128) {
    wgmma_m64n128k16_rs(o, a0, a1, a2, a3, desc_v);
  } else {
    wgmma_m64n64k16_rs(o, a0, a1, a2, a3, desc_v);
  }
}

// --- softmax helpers -----------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator fragment of a 64 x (8c) wgmma tile: warp w of the
// warpgroup, lane l hold element i at row 16w + l/4 + 8*((i/2)%2) and column
// 8*(i/4) + 2*(l%4) + i%2. So s[4c + j] (j < 2) lie on this thread's first
// row, s[4c + 2 + j] on its second, and consecutive pairs (s[2i], s[2i+1])
// are exactly the register A fragment of the P.V wgmma for keys 16*(i/4) to
// 16*(i/4) + 15.

// Sets the scores of keys >= n to -inf (only the last tile has any).
template <int S>
__device__ __forceinline__ void mask_keys(float (&s)[S], int key0, int n, int lane) {
#pragma unroll
  for (int c = 0; c < S / 4; ++c) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (key0 + 8 * c + 2 * (lane % 4) + j >= n) {
        s[4 * c + j] = -INFINITY;
        s[4 * c + 2 + j] = -INFINITY;
      }
    }
  }
}

// The row maxima of this thread's two rows over the tile, reduced over the quad.
template <int S>
__device__ __forceinline__ void row_max(const float (&s)[S], float& mx0, float& mx1) {
  mx0 = fmaxf(s[0], s[1]);
  mx1 = fmaxf(s[2], s[3]);
#pragma unroll
  for (int c = 1; c < S / 4; ++c) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * c], s[4 * c + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * c + 2], s[4 * c + 3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
}

// s <- exp2(s * c - bias) per row, in place; returns this thread's part of
// the two row sums.
template <int S>
__device__ __forceinline__ void exp_rows(float (&s)[S], float c, float bias0, float bias1,
                                         float& sum0, float& sum1) {
  sum0 = 0.0f;
  sum1 = 0.0f;
#pragma unroll
  for (int i = 0; i < S / 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[4 * i + j] = ex2(fmaf(s[4 * i + j], c, -bias0));
      s[4 * i + 2 + j] = ex2(fmaf(s[4 * i + 2 + j], c, -bias1));
      sum0 += s[4 * i + j];
      sum1 += s[4 * i + 2 + j];
    }
  }
}

// Scales this thread's two rows of O by f0 and f1.
template <int O>
__device__ __forceinline__ void scale_rows(float (&o)[O], float f0, float f1) {
#pragma unroll
  for (int c = 0; c < O / 4; ++c) {
    o[4 * c] *= f0;
    o[4 * c + 1] *= f0;
    o[4 * c + 2] *= f1;
    o[4 * c + 3] *= f1;
  }
}

// --- the kernel body -----------------------------------------------------------

// One CTA of Cfg::kThreads threads per (64-row query tile, head, batch item),
// grid (ceil(n / 64), heads, batch), Cfg::kSmemBytes of dynamic shared
// memory. kExact selects the two-pass exact softmax (K3) over the online one
// (K1, K2). Each kernel wraps it in a __global__ of its own name.
template <typename Cfg, bool kExact>
__device__ __forceinline__ void attention(const CUtensorMap& tq, const CUtensorMap& tk,
                                          const CUtensorMap& tv, const CUtensorMap& to, int n,
                                          float scale_log2) {
  constexpr int kD = Cfg::kD, kBlockQ = Cfg::kBlockQ, kBlockK = Cfg::kBlockK;
  constexpr int kStages = Cfg::kStages, kHalves = Cfg::kHalves;
  constexpr uint32_t kQHalf = Cfg::kQHalf, kTileHalf = Cfg::kTileHalf, kTileBytes = Cfg::kTileBytes;
  // V's leading offset: the distance between its 64-column atoms (at d = 64
  // there is one atom and the field is never read)
  constexpr uint32_t kVLead = kHalves > 1 ? kTileHalf : 1024;

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t k_s = base + Cfg::kOffK;
  const uint32_t v_s = base + Cfg::kOffV;
  const uint32_t bar_q = base + Cfg::kOffBar;
  const uint32_t bar_full = bar_q + 8;               // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 * stage

  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int tiles = (n + kBlockK - 1) / kBlockK;
  const int steps = kExact ? 2 * tiles : tiles;  // K tiles, then (exact) K and V tiles

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // The producer: one thread issues every copy.
    if constexpr (Cfg::kSetMaxNReg) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Cfg::kProducerRegs));
    }
    if (threadIdx.x == 128) {
      mbar_expect_tx(bar_q, Cfg::kQBytes);
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        tma_load_4d(q_s + h * kQHalf, tq, bar_q, 64 * h, q0, head, batch);
      }
      for (int it = 0; it < steps; ++it) {
        const int st = it % kStages;
        const uint32_t round = it / kStages;
        const bool with_v = !kExact || it >= tiles;
        const int key0 = (kExact && it >= tiles ? it - tiles : it) * kBlockK;
        const uint32_t full = bar_full + 8 * st;
        mbar_wait(bar_empty + 8 * st, (round & 1) ^ 1);  // the first round passes
        mbar_expect_tx(full, with_v ? 2 * kTileBytes : kTileBytes);
#pragma unroll
        for (int h = 0; h < kHalves; ++h) {
          tma_load_4d(k_s + st * kTileBytes + h * kTileHalf, tk, full, 64 * h, key0, head, batch);
          if (with_v) {
            tma_load_4d(v_s + st * kTileBytes + h * kTileHalf, tv, full, 64 * h, key0, head,
                        batch);
          }
        }
      }
    }
  } else {
    // The consumer warpgroup: query rows [q0, q0 + 64).
    if constexpr (Cfg::kSetMaxNReg) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Cfg::kConsumerRegs));
    }
    const int tid = threadIdx.x;
    const int lane = tid % 32;

    float s[Cfg::kS];
    float o[Cfg::kO];
    uint32_t p[Cfg::kS / 2];
#pragma unroll
    for (int i = 0; i < Cfg::kS; ++i) s[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < Cfg::kO; ++i) o[i] = 0.0f;
    // Per row (this thread's two rows): the running max (raw scores), this
    // thread's part of the running sum, and, for the exact pass 2, the bias
    // m * scale * log2(e) + log2(l).
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f, bias0 = 0.0f, bias1 = 0.0f;

    mbar_wait(bar_q, 0);
    for (int it = 0; it < steps; ++it) {
      const int st = it % kStages;
      const bool pass2 = !kExact || it >= tiles;
      const int key0 = (kExact && it >= tiles ? it - tiles : it) * kBlockK;
      mbar_wait(bar_full + 8 * st, (it / kStages) & 1);

      // S = Q . K^T over d in d / 16 k16 steps; step kk reads the
      // 64-column region kk / 4 of Q and K.
      const uint32_t k_tile = k_s + st * kTileBytes;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t off = 32 * (kk % 4);
        wgmma_scores<kBlockK>(s, smem_desc(q_s + (kk / 4) * kQHalf + off, 16),
                              smem_desc(k_tile + (kk / 4) * kTileHalf + off, 16), kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      if (!pass2 && lane == 0) mbar_arrive(bar_empty + 8 * st);  // exact pass 1 reads K only

      if (key0 + kBlockK > n) mask_keys(s, key0, n, lane);

      if (!pass2) {
        // Exact pass 1: the row max and the rescaled row sum.
        float mx0, mx1, sum0, sum1;
        row_max(s, mx0, mx1);
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        l0 *= ex2((m0 - mn0) * scale_log2);
        l1 *= ex2((m1 - mn1) * scale_log2);
        exp_rows(s, scale_log2, mn0 * scale_log2, mn1 * scale_log2, sum0, sum1);
        l0 += sum0;
        l1 += sum1;
        m0 = mn0;
        m1 = mn1;
        continue;
      }

      if (kExact) {
        if (it == tiles) {  // the first tile of pass 2: m and l are final
          bias0 = m0 * scale_log2 + log2f(quad_sum(l0));
          bias1 = m1 * scale_log2 + log2f(quad_sum(l1));
        }
        float sum0, sum1;
        exp_rows(s, scale_log2, bias0, bias1, sum0, sum1);  // P = exp(s*scale - m) / l
      } else {
        float mx0, mx1, sum0, sum1;
        row_max(s, mx0, mx1);
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float alpha0 = ex2((m0 - mn0) * scale_log2);  // 0 on the first tile
        const float alpha1 = ex2((m1 - mn1) * scale_log2);
        exp_rows(s, scale_log2, mn0 * scale_log2, mn1 * scale_log2, sum0, sum1);
        l0 = l0 * alpha0 + sum0;
        l1 = l1 * alpha1 + sum1;
        m0 = mn0;
        m1 = mn1;
        scale_rows(o, alpha0, alpha1);
      }

      // O += P . V over the tile's keys in kBlockK / 16 k16 steps, P from
      // registers; a k16 step is 16 key rows of 128 bytes.
#pragma unroll
      for (int i = 0; i < Cfg::kS / 2; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
      const uint32_t v_tile = v_s + st * kTileBytes;
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        wgmma_pv<kD>(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                     smem_desc(v_tile + kk * 16 * 128, kVLead));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(p);
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
    }

    if (!kExact) scale_rows(o, 1.0f / quad_sum(l0), 1.0f / quad_sum(l1));  // deferred division

    // Epilogue: O as bf16 into the Q tile (no wgmma reads it any more), in
    // the 128-byte swizzle of the output map, one 64-column region after the
    // other, then one TMA store per region.
    const int row = (tid / 32) * 16 + lane / 4;  // and row + 8; row % 8 == lane / 4
#pragma unroll
    for (int c = 0; c < kD / 8; ++c) {
      uint8_t* region = smem + (c / 8) * kQHalf;
      const int chunk = ((c % 8) ^ (lane / 4)) * 16 + 4 * (lane % 4);
      *reinterpret_cast<uint32_t*>(region + row * 128 + chunk) = pack_bf16(o[4 * c], o[4 * c + 1]);
      *reinterpret_cast<uint32_t*>(region + (row + 8) * 128 + chunk) =
          pack_bf16(o[4 * c + 2], o[4 * c + 3]);
    }
    fence_proxy_async();
    asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the consumer warpgroup alone
    if (tid == 0) {
#pragma unroll
      for (int h = 0; h < kHalves; ++h) tma_store_4d(to, q_s + h * kQHalf, 64 * h, q0, head, batch);
      tma_store_wait();
    }
  }
}

// --- the wide form: head widths above 128 ------------------------------------------

// K2's and K3's bf16 heads wider than 128 (the JAX entry's d_pad > 128) on the
// same TMA + wgmma mainloop, at a head width d that is a runtime multiple of
// 64 (the wrapper zero-pads to it; zero columns change no result). The head
// splits into two widths:
// * the width of the S reduction, d: Q and K are d / 64 swizzle regions, and
//   S = Q.K^T sums m64n64k16 wgmma over all of them;
// * the output chunk, at most 256 columns (kORegions regions): O of 64 rows x
//   256 fp32 is 128 registers a consumer thread. A head of at most 256
//   columns computes S once; a wider one recomputes it for each chunk.
// CTA: one producer warpgroup (its first thread issues every copy) and one
// consumer warpgroup of 64 query rows, one CTA an SM with no setmaxnreg: the
// consumer holds O, S and P in about 200 registers, which neither two CTAs
// an SM (128 a thread) nor two consumer
// warpgroups (168 a thread at 384 threads: ptxas allocates the whole kernel
// at the launch's count, setmaxnreg or not) leave it: both spilled and
// serialized their wgmma. Grid (ceil(N / 64), H * chunks, B), chunks =
// ceil(d / 256).
// The ring's items are slots of min(d / 64, 4) regions of 64 keys: a K piece
// (up to kPieceRegions regions of a key tile; a key tile is ceil(d / 256)
// pieces) or the V chunk of a key tile (up to kORegions regions); an empty
// slot takes one arrival per consumer warp. Q stays resident for the whole
// loop where it fits beside two slots (d <= 1280), with as many slots as
// fit, up to kMaxStages (6 at d = 192 and 256, 3 at 1024); a wider Q is
// streamed: each K piece's slot carries Q's regions of the same columns
// beside it (three 64 KB slots), read again from L2 for every key tile. A
// chunk's regions past d are neither loaded, computed nor stored. Modes as
// above: online for K2, exact (two passes) for K3. Each wgmma group is one
// whole instantiation of wide_scores / wide_pv picked by a switch on the
// region count, so that no wgmma sits under a condition (ptxas serializes
// such a chain). The epilogue stages the output chunk in the first slot,
// which every consumed item has left.
struct Wide {
  static constexpr int kBlockQ = 64;    // query rows of a CTA: the consumer warpgroup's wgmma M
  static constexpr int kBlockK = 64;
  static constexpr int kThreads = 256;  // the consumer warpgroup, then the producer warpgroup
  static constexpr int kPieceRegions = 4;  // 64-column regions of K in one ring item
  static constexpr int kORegions = 4;      // 64-column regions of an output chunk
  static constexpr int kMaxStages = 6;
  static constexpr int kS = kBlockK / 2;   // scores a consumer thread holds
  static constexpr uint32_t kRegion = 64 * 128;  // 64 rows of one 64-column region: 8 KB
  static constexpr uint32_t kBarBytes = 8 * (1 + 2 * kMaxStages);
  static constexpr uint32_t kSmemLimit = 232448;  // a CTA's 227 KB
  static_assert(kORegions <= kPieceRegions, "the epilogue stages a chunk in one slot");
  static_assert(kBlockQ == kBlockK, "a region of Q and of a key tile are both 8 KB");
};

// What a wide launch computes at: the head's regions and chunks, the ring.
struct WideArgs {
  int n;
  float scale_log2;
  int regions;     // d / 64
  int chunks;      // ceil(regions / kORegions)
  int stages;      // slots of the ring
  int q_streamed;  // 1: Q rides in each K piece's slot
  uint32_t piece;  // bytes of a K piece or a V chunk: min(regions, 4) regions
};

// Shared memory of a wide CTA: Q (resident) or nothing, the ring, the
// mbarriers q_full, full[kMaxStages], empty[kMaxStages], 1024 for alignment.
__host__ __device__ inline uint32_t wide_q_bytes(const WideArgs& a) {
  return a.q_streamed ? 0u : static_cast<uint32_t>(a.regions) * Wide::kRegion;
}
__host__ __device__ inline uint32_t wide_stage_bytes(const WideArgs& a) {
  return a.q_streamed ? 2 * a.piece : a.piece;  // the K piece, then Q's
}
inline uint32_t wide_smem_bytes(const WideArgs& a) {
  return wide_q_bytes(a) + a.stages * wide_stage_bytes(a) + Wide::kBarBytes + 1024;
}

inline WideArgs wide_args(int d, int n, float scale) {
  WideArgs a;
  a.n = n;
  a.scale_log2 = scale * 1.4426950408889634f;
  a.regions = d / 64;
  a.chunks = (a.regions + Wide::kORegions - 1) / Wide::kORegions;
  a.piece = (a.regions < Wide::kPieceRegions ? a.regions : Wide::kPieceRegions) * Wide::kRegion;
  uint32_t left = Wide::kSmemLimit - Wide::kBarBytes - 1024;
  const uint32_t q_bytes = a.regions * Wide::kRegion;
  a.q_streamed = q_bytes + 2 * a.piece > left;
  if (!a.q_streamed) left -= q_bytes;
  a.stages = static_cast<int>(left / wide_stage_bytes(a));
  if (a.stages > Wide::kMaxStages) a.stages = Wide::kMaxStages;
  return a;
}

// S (+)= Q . K^T over the N regions of one K piece at ka (Q's at qa) as one
// wgmma group, region j in 4 k16 steps (step kk at byte 32 * kk of the
// region); first: S is overwritten. The loop picks the instantiation of a
// piece's region count in a switch, so that no wgmma sits under a condition.
template <int N>
__device__ __forceinline__ void wide_scores(float (&s)[Wide::kS], uint32_t qa, uint32_t ka,
                                            bool first) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_m64n64k16_ss(s, smem_desc(qa + j * Wide::kRegion + 32 * kk, 16),
                         smem_desc(ka + j * Wide::kRegion + 32 * kk, 16), !first || j || kk);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
}

// O += P . V over the N regions of a V chunk at va as one wgmma group, one
// 64-column region after the other (region j is one swizzle atom wide:
// MN-major, no leading offset), 4 k16 steps of 16 key rows each; N as above.
template <int N>
__device__ __forceinline__ void wide_pv(float (&o)[Wide::kORegions][32],
                                        uint32_t (&p)[Wide::kS / 2], uint32_t va) {
#pragma unroll
  for (int j = 0; j < Wide::kORegions; ++j) fence_regs(o[j]);
  fence_regs(p);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int kk = 0; kk < Wide::kBlockK / 16; ++kk) {
      wgmma_m64n64k16_rs(o[j], p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                         smem_desc(va + j * Wide::kRegion + kk * 16 * 128, 1024));
    }
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int j = 0; j < Wide::kORegions; ++j) fence_regs(o[j]);
  fence_regs(p);
}

// One CTA of Wide::kThreads threads per (64-row query tile, head x chunk,
// batch item), grid (ceil(n / 64), heads * a.chunks, batch),
// wide_smem_bytes(a) of dynamic shared memory.
template <bool kExact>
__device__ __forceinline__ void attention_wide(const CUtensorMap& tq, const CUtensorMap& tk,
                                               const CUtensorMap& tv, const CUtensorMap& to,
                                               const WideArgs& a) {
  constexpr uint32_t kRegion = Wide::kRegion;
  constexpr int kORegions = Wide::kORegions, kPieceRegions = Wide::kPieceRegions;

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t q_bytes = wide_q_bytes(a);
  const uint32_t stage_bytes = wide_stage_bytes(a);
  const uint32_t q_s = base;  // region r at + r * kRegion
  const uint32_t ring = base + q_bytes;
  const uint32_t bar_q = ring + a.stages * stage_bytes;
  const uint32_t bar_full = bar_q + 8;                         // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * Wide::kMaxStages;  // + 8 * stage

  const int n = a.n, regions = a.regions;
  const int q0 = blockIdx.x * Wide::kBlockQ;
  const int head = blockIdx.y / a.chunks;
  const int col0 = (blockIdx.y % a.chunks) * kORegions * 64;  // this CTA's first output column
  const int o_regions = min(kORegions, regions - col0 / 64);  // the chunk's regions inside d
  const int batch = blockIdx.z;
  const int tiles = (n + Wide::kBlockK - 1) / Wide::kBlockK;
  const int pieces = (regions + kPieceRegions - 1) / kPieceRegions;  // K pieces a key tile
  const int passes = kExact ? 2 : 1;  // (exact) K tiles, then K and V tiles

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < a.stages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // The producer: one thread issues every copy, item after item.
    if (threadIdx.x != 128) return;
    if (!a.q_streamed) {
      mbar_expect_tx(bar_q, regions * kRegion);
      for (int r = 0; r < regions; ++r) {
        tma_load_4d(q_s + r * kRegion, tq, bar_q, 64 * r, q0, head, batch);
      }
    }
    int st = 0;
    uint32_t phase = 0;
    for (int pass = 0; pass < passes; ++pass) {
      const bool with_v = !kExact || pass == 1;
      for (int t = 0; t < tiles; ++t) {
        const int key0 = t * Wide::kBlockK;
        for (int pc = 0; pc <= pieces; ++pc) {
          const bool v_item = pc == pieces;
          if (v_item && !with_v) break;
          const uint32_t slot = ring + st * stage_bytes;
          const uint32_t full = bar_full + 8 * st;
          mbar_wait(bar_empty + 8 * st, phase ^ 1);  // the first round passes
          if (v_item) {
            mbar_expect_tx(full, o_regions * kRegion);
            for (int j = 0; j < o_regions; ++j) {
              tma_load_4d(slot + j * kRegion, tv, full, col0 + 64 * j, key0, head, batch);
            }
          } else {
            const int r0 = pc * kPieceRegions;
            const int nr = min(kPieceRegions, regions - r0);
            mbar_expect_tx(full, nr * kRegion * (a.q_streamed ? 2 : 1));
            for (int j = 0; j < nr; ++j) {
              tma_load_4d(slot + j * kRegion, tk, full, 64 * (r0 + j), key0, head, batch);
              if (a.q_streamed) {
                tma_load_4d(slot + a.piece + j * kRegion, tq, full, 64 * (r0 + j), q0, head,
                            batch);
              }
            }
          }
          if (++st == a.stages) {
            st = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // The consumer warpgroup: query rows [q0, q0 + 64), output columns
    // [col0, col0 + 64 * o_regions).
    const int tid = threadIdx.x;
    const int lane = tid % 32;

    float o[kORegions][32];
#pragma unroll
    for (int j = 0; j < kORegions; ++j) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[j][i] = 0.0f;
    }
    float l0 = 0.0f, l1 = 0.0f;  // this thread's parts of its two rows' sums

    if (!a.q_streamed) mbar_wait(bar_q, 0);
    float s[Wide::kS];
    uint32_t p[Wide::kS / 2];
#pragma unroll
    for (int i = 0; i < Wide::kS; ++i) s[i] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY, bias0 = 0.0f, bias1 = 0.0f;
    int st = 0;
    uint32_t phase = 0;
    for (int pass = 0; pass < passes; ++pass) {
      const bool pass2 = !kExact || pass == 1;
      for (int t = 0; t < tiles; ++t) {
        const int key0 = t * Wide::kBlockK;
        // S = Q . K^T over d, piece after piece of the key tile.
        for (int pc = 0; pc < pieces; ++pc) {
          const uint32_t slot = ring + st * stage_bytes;
          const uint32_t qa = a.q_streamed ? slot + a.piece : q_s + pc * kPieceRegions * kRegion;
          const bool first = pc == 0;
          mbar_wait(bar_full + 8 * st, phase);
          switch (min(kPieceRegions, regions - pc * kPieceRegions)) {
            case 1: wide_scores<1>(s, qa, slot, first); break;
            case 2: wide_scores<2>(s, qa, slot, first); break;
            case 3: wide_scores<3>(s, qa, slot, first); break;
            default: wide_scores<4>(s, qa, slot, first); break;
          }
          if (lane == 0) mbar_arrive(bar_empty + 8 * st);
          if (++st == a.stages) {
            st = 0;
            phase ^= 1;
          }
        }

        if (key0 + Wide::kBlockK > n) mask_keys(s, key0, n, lane);

        if (!pass2) {
          // Exact pass 1: the row max and the rescaled row sum.
          float mx0, mx1, sum0, sum1;
          row_max(s, mx0, mx1);
          const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
          l0 *= ex2((m0 - mn0) * a.scale_log2);
          l1 *= ex2((m1 - mn1) * a.scale_log2);
          exp_rows(s, a.scale_log2, mn0 * a.scale_log2, mn1 * a.scale_log2, sum0, sum1);
          l0 += sum0;
          l1 += sum1;
          m0 = mn0;
          m1 = mn1;
          continue;
        }

        if (kExact) {
          if (t == 0) {  // the first tile of pass 2: m and l are final
            bias0 = m0 * a.scale_log2 + log2f(quad_sum(l0));
            bias1 = m1 * a.scale_log2 + log2f(quad_sum(l1));
          }
          float sum0, sum1;
          exp_rows(s, a.scale_log2, bias0, bias1, sum0, sum1);  // P = exp(s*scale - m) / l
        } else {
          float mx0, mx1, sum0, sum1;
          row_max(s, mx0, mx1);
          const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
          const float alpha0 = ex2((m0 - mn0) * a.scale_log2);  // 0 on the first tile
          const float alpha1 = ex2((m1 - mn1) * a.scale_log2);
          exp_rows(s, a.scale_log2, mn0 * a.scale_log2, mn1 * a.scale_log2, sum0, sum1);
          l0 = l0 * alpha0 + sum0;
          l1 = l1 * alpha1 + sum1;
          m0 = mn0;
          m1 = mn1;
#pragma unroll
          for (int j = 0; j < kORegions; ++j) scale_rows(o[j], alpha0, alpha1);
        }

        // O += P . V over the tile's keys and the chunk's regions.
#pragma unroll
        for (int i = 0; i < Wide::kS / 2; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
        const uint32_t slot = ring + st * stage_bytes;
        mbar_wait(bar_full + 8 * st, phase);
        switch (o_regions) {
          case 1: wide_pv<1>(o, p, slot); break;
          case 2: wide_pv<2>(o, p, slot); break;
          case 3: wide_pv<3>(o, p, slot); break;
          default: wide_pv<4>(o, p, slot); break;
        }
        if (lane == 0) mbar_arrive(bar_empty + 8 * st);
        if (++st == a.stages) {
          st = 0;
          phase ^= 1;
        }
      }
    }

    if (!kExact) {  // deferred division
      const float inv0 = 1.0f / quad_sum(l0), inv1 = 1.0f / quad_sum(l1);
#pragma unroll
      for (int j = 0; j < kORegions; ++j) scale_rows(o[j], inv0, inv1);
    }

    // Epilogue: the chunk as bf16 into the ring's first slot in the output
    // map's swizzle, region after region, then one TMA store per region
    // (rows >= n clipped).
    const uint32_t out_s = ring;
    uint8_t* out = smem + q_bytes;
    const int row = (tid / 32) * 16 + lane / 4;  // and row + 8; row % 8 == lane / 4
#pragma unroll
    for (int j = 0; j < kORegions; ++j) {
      if (j < o_regions) {
        uint8_t* region = out + j * kRegion;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int chunk = (c ^ (lane / 4)) * 16 + 4 * (lane % 4);
          *reinterpret_cast<uint32_t*>(region + row * 128 + chunk) =
              pack_bf16(o[j][4 * c], o[j][4 * c + 1]);
          *reinterpret_cast<uint32_t*>(region + (row + 8) * 128 + chunk) =
              pack_bf16(o[j][4 * c + 2], o[j][4 * c + 3]);
        }
      }
    }
    fence_proxy_async();
    asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the consumer warpgroup alone
    if (tid == 0) {
      for (int j = 0; j < o_regions; ++j) {
        tma_store_4d(to, out_s + j * kRegion, col0 + 64 * j, q0, head, batch);
      }
      tma_store_wait();
    }
  }
}

// --- host side -----------------------------------------------------------------

// A rank-4 map over one bf16 operand's (d, N, H, B) with element strides
// (token, head, batch) and a box of 64 x `box_rows`. The stride of an axis
// of extent 1 is never stepped; it gets a legal value whatever the view says.
inline bool encode_operand(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, int d, int n,
                           int heads, int batch, int64_t s_n, int64_t s_h, int64_t s_b,
                           int box_rows) {
  constexpr uint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t sn = n > 1 ? s_n * e : d * e;
  const cuuint64_t sh = heads > 1 ? s_h * e : sn * n;
  const cuuint64_t sb = batch > 1 ? s_b * e : sh * heads;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {sn, sh, sb};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

typedef void (*Kernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap, const CUtensorMap,
                       int, float);

// Encodes the four tensor maps and launches `kernel` (a __global__ wrapper of
// attention<Cfg, ...>) over `batch` x `heads` problems of `n` tokens on
// `stream`. strides: 12 element strides, (batch, head, token) of q, k, v,
// then o. Returns a cudaError_t (0 on success).
template <typename Cfg>
int launch(Kernel kernel, const void* q, const void* k, const void* v, void* o,
           const int64_t* strides, int batch, int heads, int n, float scale, void* stream) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, o};
  const int box_rows[4] = {Cfg::kBlockQ, Cfg::kBlockK, Cfg::kBlockK, Cfg::kBlockQ};
  for (int i = 0; i < 4; ++i) {
    const int64_t* st = strides + 3 * i;
    if (!encode_operand(encode, &maps[i], ptrs[i], Cfg::kD, n, heads, batch, st[2], st[1], st[0],
                        box_rows[i])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), Cfg::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + Cfg::kBlockQ - 1) / Cfg::kBlockQ, heads, batch);
  kernel<<<grid, Cfg::kThreads, Cfg::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], n, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

typedef void (*WideKernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                           const CUtensorMap, const WideArgs);

// The same for `kernel`, a __global__ wrapper of attention_wide<...>, at a
// head width d above 128 that is a multiple of 64.
inline int launch_wide(WideKernel kernel, const void* q, const void* k, const void* v, void* o,
                       const int64_t* strides, int batch, int heads, int n, int d, float scale,
                       void* stream) {
  if (d <= 128 || d % 64 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i) {
    const int64_t* st = strides + 3 * i;
    if (!encode_operand(encode, &maps[i], ptrs[i], d, n, heads, batch, st[2], st[1], st[0],
                        Wide::kBlockK)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const WideArgs a = wide_args(d, n, scale);
  if (static_cast<int64_t>(heads) * a.chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the largest a wide launch takes, raised once; each launch asks for its own
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), Wide::kSmemLimit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + Wide::kBlockQ - 1) / Wide::kBlockQ, heads * a.chunks, batch);
  kernel<<<grid, Wide::kThreads, wide_smem_bytes(a), static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace
