// The fp32 Hopper attention mainloop of kernels K1 (flash_attention_packed.cu),
// K2 (flash_attention.cu) and K3 (flash_attention_batched.cu),
// precision="fp32": non-causal softmax(q k^T * scale) v over (B, H, N, d)
// fp32 operands read through their own strides, the output written as
// (B, N, H, d), for a head width d of 64 or 128 (Config::kD) and, in its
// wide form (attention_wide, below), any multiple of 64 above 128. The bf16
// forms run attention_sm90.cuh.
//
// Replaces the fp32 forms of the TPU kernels
//   monocular_depth_estimation_trt_tpu/ops/pallas/flash_attention.py::_attn_kernel_packed (K1)
//   monocular_depth_estimation_trt_tpu/ops/pallas/flash_attention.py::_attn_kernel (K2)
//   monocular_depth_estimation_trt_tpu/ops/pallas/flash_attention.py::_attn_kernel_batched (K3)
// whose two products take fp32 operands with preferred_element_type=fp32:
// full fp32 accuracy, which this loop keeps on the tensor cores. K3's TPU
// kernel divides P by the row sum before P.V, to cast P to the operand type
// first; in fp32 there is no cast to stand before, so K3 runs this loop's
// online mode as K1 and K2 do: moving the division changes only fp32
// rounding (tests/test_torch_attention_tiling.py holds the model against
// _attn_kernel_batched at 1e-4). K3 keeps its entry's N <= 1024.
//
// Numerics: split TF32 ("3xTF32"). Each fp32 operand x is taken as hi + lo
// with hi = x truncated to TF32 (the tensor core reads a raw fp32 register or
// shared-memory word as TF32 by dropping its low 13 mantissa bits, so hi is x
// itself) and lo = x - hi (exact in fp32; truncated to TF32 in turn where it
// is read). Each product is hi.hi + hi.lo + lo.hi on TF32 wgmma (m64nNk8)
// with fp32 accumulation: about 21 bits of each operand, the lo.lo term
// dropped. A single TF32 pass would round the operands to about 11 bits, which
// the fp32 path's bars do not allow. Scores and softmax in fp32, exp2 with
// scale*log2(e) folded into one FMA; the division by the row sum once, after
// P.V (the TPU kernel divides before; both are fp32). Keys >= N are masked to
// -inf. tests/test_torch_attention_tiling.py models this arithmetic on the CPU
// against the JAX kernels.
//
// What bounds it on the H100: 4*B*H*N^2*d operations, taken three times on the
// TF32 tensor cores (495 TFLOP/s): 3 * ops / 495 TFLOP/s, below ops / 67
// TFLOP/s on the fp32 pipes; B*N*4*H*d*4 bytes are far below either at the
// paths' shapes. At ViT-S 518^2 (1, 1370, 6 heads) 0.0175 ms; at Depth Pro's
// patch shape (K3, 35 windows x 16 heads of 577 tokens) 0.2893 ms, where
// N = 577 pads to 640 rows and keys (at most 81 % of the bound is reachable
// with 64-row tiles) and 5,600 CTAs each pay Q's load, Q lo's conversion and
// the ring's fill.
//
// Design. One CTA per (64-row query tile, head, batch item), grid
// (ceil(N / 64), H, B), one CTA an SM (shared memory), three roles:
// * producer (warp 8, one thread): TMA loads of Q once and of K and V tiles
//   into a ring of kStages stages (full / empty mbarriers), through one
//   rank-4 tensor map per operand over (d, N, H, B) with the view's own
//   strides, a box of 32 (d) x rows and the 128-byte swizzle: a 32-float row
//   is one swizzle atom, so a tile is d / 32 regions of rows x 128 bytes side
//   by side in d. TMA fills rows past N with zeros.
// * converter (warps 4-7): for each stage, K lo beside K (elementwise, same
//   layout), and V transposed in place: TF32 wgmma takes only K-major
//   operands from shared memory (its transpose bits exist for 16-bit types
//   only), and a (keys, d) V tile is MN-major as the B operand of P.V. The
//   converter reads the raw tile into registers, syncs its warpgroup, and
//   writes V^T (d rows of keys, 32-key regions, 128-byte swizzle) over it and
//   V^T lo beside it, with 16-byte accesses free of bank conflicts (each
//   8-lane phase touches 8 distinct 16-byte columns), then fences them for
//   the async proxy and arrives on the stage's ready barrier. Q lo likewise,
//   once. This runs ahead of the consumer, in its own registers, off the
//   consumer's critical path.
// * consumer (warps 0-3, one warpgroup of 64 query rows): S = Q.K^T as the
//   three SS wgmma chains over d / 8 k8 steps (step kk at region kk / 4,
//   byte 32 * (kk % 4), as the bf16 loop steps k16); the online softmax on
//   the accumulator fragment (running max and sum, O rescaled in registers);
//   then O += P.V with P from registers as the A operand: hi is the score
//   register itself, lo = p - trunc(p). TF32's register A fragment holds rows
//   (g, g + 8) and columns (t, t + 4) of a k8 step (g = lane / 4, t = lane %
//   4), while the accumulator holds columns (2t, 2t + 1): so within each
//   group of 8 keys, V^T stores key 2p at column p and key 2p + 1 at column
//   p + 4 (p < 4), and the fragment is (s[4c], s[4c+2], s[4c+1], s[4c+3]).
//   No shuffle. O (64 x d fp32) stays in registers; the epilogue divides by
//   the row sum and stages O in the Q tile in the output map's swizzle for one
//   TMA store per 32-column region, which clips rows >= N.
// The other way to P.V, mma.sync m16n8k8 TF32 per warp with B read from the
// raw V tile (no transpose; V's lo split in registers), measured 16-18 %
// slower on the H100 at the ViT-S, VGGT frame and (1, 32, 1029, 128) shapes
// (PERF.md), and was taken out.
// Tiles: d = 64 (Head64) 64 keys x 3 stages; d = 128 (Head128) 32 keys x 2
// stages. A stage holds K, K lo, V (then V^T) and V^T lo: 64 KB, beside Q and
// Q lo (32 or 64 KB). Heads wider than 128 run the wide form below.
//
// Left on the table: one consumer warpgroup an SM (no ping-pong of two,
// no overlap of the softmax with wgmma); Q read from shared memory by each of
// the three S chains (register A would halve S's shared-memory reads); 32-key
// tiles at d = 128 (shared memory), whose m64n32 S wgmma reads A and B faster
// than shared memory delivers.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"
#include "sm90_common.cuh"

namespace {
namespace sm90f32 {

using sm90::fence_proxy_async;
using sm90::fence_regs;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_desc;
using sm90::smem_u32;
using sm90::tma_load_4d;
using sm90::tma_store_4d;
using sm90::tma_store_wait;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait_all;

// One instantiation: head width D, keys per K/V tile BlockK, stages of the ring.
template <int D, int BlockK, int Stages>
struct Config {
  static_assert(D == 64 || D == 128, "head width 64 or 128");
  static_assert(BlockK == 32 || BlockK == 64, "32- or 64-key tiles");
  static constexpr int kD = D;
  static constexpr int kBlockQ = 64;  // query rows per CTA: the consumer warpgroup's wgmma M
  static constexpr int kBlockK = BlockK;
  static constexpr int kStages = Stages;
  static constexpr int kThreads = 288;  // consumer warpgroup, converter warpgroup, producer warp
  static constexpr int kRegions = D / 32;  // 32-float regions of a Q, K or V row
  static constexpr int kS = BlockK / 2;    // scores a consumer thread holds
  static constexpr int kO = D / 2;         // outputs a consumer thread holds
  static constexpr uint32_t kQRegion = kBlockQ * 128;
  static constexpr uint32_t kQBytes = kQRegion * kRegions;
  static constexpr uint32_t kKRegion = BlockK * 128;  // a region of a K or raw V tile
  static constexpr uint32_t kVtRegion = D * 128;      // 32 keys of a V^T tile
  static constexpr uint32_t kTileBytes = BlockK * D * 4;
  static constexpr uint32_t kStageBytes = 4 * kTileBytes;  // K, K lo, V (V^T), V^T lo
  // Shared memory, from a 1024-byte aligned base: Q, Q lo, the stages, then
  // the mbarriers q_full, q_ready, full[kStages], ready[kStages], empty[kStages].
  static constexpr uint32_t kOffQLo = kQBytes;
  static constexpr uint32_t kOffStages = 2 * kQBytes;
  static constexpr uint32_t kOffBar = kOffStages + kStages * kStageBytes;
  static constexpr uint32_t kSmemBytes = kOffBar + 8 * (2 + 3 * kStages) + 1024;  // + alignment
  static_assert(kSmemBytes <= 232448, "a CTA takes at most 227 KB of shared memory");
  static_assert(D * BlockK / 16 % 128 == 0, "the converter's 4 x 4 blocks");
};

using Head64 = Config<64, 64, 3>;
using Head128 = Config<128, 32, 2>;

// --- TF32 wgmma ------------------------------------------------------------------

// d[64x32] (+)= A[64x8] . B[8x32] in TF32, A and B from shared memory, both
// K-major; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n32k8_ss(float (&d)[16], uint64_t desc_a,
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64x64] (+)= A[64x8] . B[8x64] in TF32, A and B from shared memory, both
// K-major; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k8_ss(float (&d)[32], uint64_t desc_a,
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64x64] += A[64x8] . B[8x64] in TF32, A from registers (a0..a3: this
// thread's fragment), B from shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n64k8_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                                  uint32_t a2, uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// d[64x128] += A[64x8] . B[8x128] in TF32, A from registers (a0..a3: this
// thread's fragment), B from shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n128k8_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                                  uint32_t a2, uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// S (+)= Q . K^T over one k8 step: N = kBlockK keys.
template <int N>
__device__ __forceinline__ void wgmma_scores(float (&s)[N / 2], uint64_t desc_q, uint64_t desc_k,
                                             int accumulate) {
  if constexpr (N == 64) {
    wgmma_m64n64k8_ss(s, desc_q, desc_k, accumulate);
  } else {
    wgmma_m64n32k8_ss(s, desc_q, desc_k, accumulate);
  }
}

// O += P . V over one k8 step: N = d.
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&o)[N / 2], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc_v) {
  if constexpr (N == 128) {
    wgmma_m64n128k8_rs(o, a0, a1, a2, a3, desc_v);
  } else {
    wgmma_m64n64k8_rs(o, a0, a1, a2, a3, desc_v);
  }
}

// --- the split -------------------------------------------------------------------

// x - trunc_tf32(x): exact in fp32.
__device__ __forceinline__ float tf32_lo(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

__device__ __forceinline__ float4 tf32_lo(float4 v) {
  return make_float4(tf32_lo(v.x), tf32_lo(v.y), tf32_lo(v.z), tf32_lo(v.w));
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// dst = lo(src) over kBytes of shared memory, in the same layout, by the 128
// converter threads (ct).
template <uint32_t kBytes>
__device__ __forceinline__ void split_lo(const uint8_t* src, uint8_t* dst, int ct) {
#pragma unroll
  for (uint32_t off = ct * 16; off < kBytes; off += 128 * 16) {
    *reinterpret_cast<float4*>(dst + off) = tf32_lo(*reinterpret_cast<const float4*>(src + off));
  }
}

// The raw V tile at v (kRegions regions of kBlockK key rows x 32 floats, as TMA
// wrote it) -> V^T over it and V^T lo at vt_lo (kBlockK / 32 regions of d rows
// x 32 key columns, key 8c + 2p at column 8c + p and key 8c + 2p + 1 at column
// 8c + p + 4), by the 128 converter threads. A thread moves blocks of 4 keys
// (8c + 2j + parity, j < 4: one 16-byte column of V^T) x 4 head columns (one
// 16-byte column of V). Lane x of an 8-lane phase takes V^T column x (mod 8)
// and V column ((x & 6) ^ 2r) | c (mod 8), r and c fixed across the phase: its
// reads then hit 8 distinct 16-byte columns of the swizzled rows, and so do its
// writes. All reads come before the warpgroup's barrier, all writes after.
template <typename Cfg>
__device__ __forceinline__ void transpose_v(uint8_t* v, uint8_t* vt_lo, int ct) {
  constexpr int kIters = Cfg::kD * Cfg::kBlockK / 16 / 128;  // blocks a thread moves
  constexpr int kKeyRegions = Cfg::kBlockK / 32;
  const int x = ct % 8;
  float4 val[kIters][4];
  int dq[kIters], kc[kIters];
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int g = (i * 4 + ct / 32) * 4 + (ct % 32) / 8;  // the phase's block group
    const int r = g % 4, c = (g / 4) % 2, rest = g / 8;
    kc[i] = (rest % kKeyRegions) * 8 + x;                        // V^T column of 4 keys
    dq[i] = (rest / kKeyRegions) * 8 + (((x & 6) ^ (r << 1)) | c);  // V column of 4 heads
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = 8 * (kc[i] / 2) + 2 * j + kc[i] % 2;
      val[i][j] = *reinterpret_cast<const float4*>(
          v + (dq[i] / 8) * Cfg::kKRegion + key * 128 + (((dq[i] % 8) ^ (key % 8)) << 4));
    }
  }
  asm volatile("bar.sync 2, 128;\n" ::: "memory");  // the converter warpgroup alone
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 4 * dq[i] + e;
      const uint32_t off =
          (kc[i] / 8) * Cfg::kVtRegion + row * 128 + (((kc[i] % 8) ^ (row % 8)) << 4);
      const float4 hi = make_float4(lane_of(val[i][0], e), lane_of(val[i][1], e),
                                    lane_of(val[i][2], e), lane_of(val[i][3], e));
      *reinterpret_cast<float4*>(v + off) = hi;
      *reinterpret_cast<float4*>(vt_lo + off) = tf32_lo(hi);
    }
  }
}

// --- the kernel body -------------------------------------------------------------

// One CTA of Cfg::kThreads threads per (64-row query tile, head, batch item),
// grid (ceil(n / 64), heads, batch), Cfg::kSmemBytes of dynamic shared memory.
// Each kernel wraps it in a __global__ of its own name.
template <typename Cfg>
__device__ __forceinline__ void attention(const CUtensorMap& tq, const CUtensorMap& tk,
                                          const CUtensorMap& tv, const CUtensorMap& to, int n,
                                          float scale_log2) {
  constexpr int kD = Cfg::kD, kBlockK = Cfg::kBlockK, kStages = Cfg::kStages;
  constexpr int kRegions = Cfg::kRegions;
  constexpr uint32_t kQRegion = Cfg::kQRegion, kKRegion = Cfg::kKRegion;
  constexpr uint32_t kVtRegion = Cfg::kVtRegion, kTileBytes = Cfg::kTileBytes;

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t q_hi = base;
  const uint32_t q_lo = base + Cfg::kOffQLo;
  const uint32_t bar_q_full = base + Cfg::kOffBar;
  const uint32_t bar_q_ready = bar_q_full + 8;
  const uint32_t bar_full = bar_q_ready + 8;            // + 8 * stage
  const uint32_t bar_ready = bar_full + 8 * kStages;    // + 8 * stage
  const uint32_t bar_empty = bar_ready + 8 * kStages;   // + 8 * stage

  const int q0 = blockIdx.x * Cfg::kBlockQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int tiles = (n + kBlockK - 1) / kBlockK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q_full, 1);
    mbar_init(bar_q_ready, 128);  // every converter thread
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_ready + 8 * st, 128);
      mbar_init(bar_empty + 8 * st, 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // The producer: one thread issues every copy.
    if (threadIdx.x != 256) return;
    mbar_expect_tx(bar_q_full, Cfg::kQBytes);
#pragma unroll
    for (int r = 0; r < kRegions; ++r) {
      tma_load_4d(q_hi + r * kQRegion, tq, bar_q_full, 32 * r, q0, head, batch);
    }
    for (int it = 0; it < tiles; ++it) {
      const int st = it % kStages;
      const uint32_t stage = base + Cfg::kOffStages + st * Cfg::kStageBytes;
      const uint32_t full = bar_full + 8 * st;
      mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1);  // the first round passes
      mbar_expect_tx(full, 2 * kTileBytes);
#pragma unroll
      for (int r = 0; r < kRegions; ++r) {
        tma_load_4d(stage + r * kKRegion, tk, full, 32 * r, it * kBlockK, head, batch);
        tma_load_4d(stage + 2 * kTileBytes + r * kKRegion, tv, full, 32 * r, it * kBlockK, head,
                    batch);
      }
    }
  } else if (threadIdx.x >= 128) {
    // The converter warpgroup: the lo tiles and V^T of every stage.
    const int ct = threadIdx.x - 128;
    mbar_wait(bar_q_full, 0);
    split_lo<Cfg::kQBytes>(smem, smem + Cfg::kOffQLo, ct);
    fence_proxy_async();
    mbar_arrive(bar_q_ready);
    for (int it = 0; it < tiles; ++it) {
      const int st = it % kStages;
      uint8_t* stage = smem + Cfg::kOffStages + st * Cfg::kStageBytes;
      mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
      split_lo<kTileBytes>(stage, stage + kTileBytes, ct);
      transpose_v<Cfg>(stage + 2 * kTileBytes, stage + 3 * kTileBytes, ct);
      fence_proxy_async();
      mbar_arrive(bar_ready + 8 * st);
    }
  } else {
    // The consumer warpgroup: query rows [q0, q0 + 64).
    const int tid = threadIdx.x;
    const int lane = tid % 32;

    float s[Cfg::kS];
    float o[Cfg::kO];
    uint32_t p_lo[Cfg::kS];
#pragma unroll
    for (int i = 0; i < Cfg::kS; ++i) s[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < Cfg::kO; ++i) o[i] = 0.0f;
    // per row (this thread's two rows): the running max (raw scores) and this
    // thread's part of the running sum
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

    mbar_wait(bar_q_ready, 0);
    for (int it = 0; it < tiles; ++it) {
      const int st = it % kStages;
      const int key0 = it * kBlockK;
      const uint32_t k_hi = base + Cfg::kOffStages + st * Cfg::kStageBytes;
      const uint32_t k_lo = k_hi + kTileBytes;
      const uint32_t vt_hi = k_hi + 2 * kTileBytes;
      const uint32_t vt_lo = k_hi + 3 * kTileBytes;
      mbar_wait(bar_ready + 8 * st, (it / kStages) & 1);

      // S = Qlo.Khi + Qhi.Klo + Qhi.Khi over d in d / 8 k8 steps.
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 8; ++kk) {
        const uint32_t qa = (kk / 4) * kQRegion + 32 * (kk % 4);
        const uint32_t kb = (kk / 4) * kKRegion + 32 * (kk % 4);
        wgmma_scores<kBlockK>(s, smem_desc(q_lo + qa, 16), smem_desc(k_hi + kb, 16), kk);
        wgmma_scores<kBlockK>(s, smem_desc(q_hi + qa, 16), smem_desc(k_lo + kb, 16), 1);
        wgmma_scores<kBlockK>(s, smem_desc(q_hi + qa, 16), smem_desc(k_hi + kb, 16), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      if (key0 + kBlockK > n) sm90::mask_keys(s, key0, n, lane);

      float mx0, mx1, sum0, sum1;
      sm90::row_max(s, mx0, mx1);
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: key0 < n
      const float alpha0 = sm90::ex2((m0 - mn0) * scale_log2);  // 0 on the first tile
      const float alpha1 = sm90::ex2((m1 - mn1) * scale_log2);
      sm90::exp_rows(s, scale_log2, mn0 * scale_log2, mn1 * scale_log2, sum0, sum1);
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
      m0 = mn0;
      m1 = mn1;
      sm90::scale_rows(o, alpha0, alpha1);

      // O += Plo.Vhi + Phi.Vlo + Phi.Vhi over the tile's keys in kBlockK / 8
      // k8 steps; P's hi is the score register itself. The A fragment of keys
      // 8c .. 8c + 7 in V^T's column order: (s[4c], s[4c+2], s[4c+1], s[4c+3]).
#pragma unroll
      for (int i = 0; i < Cfg::kS; ++i) p_lo[i] = __float_as_uint(tf32_lo(s[i]));
      fence_regs(o);
      fence_regs(s);
      fence_regs(p_lo);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kBlockK / 8; ++c) {
        const uint32_t vb = (c / 4) * kVtRegion + 32 * (c % 4);
        const uint32_t h0 = __float_as_uint(s[4 * c]), h1 = __float_as_uint(s[4 * c + 2]);
        const uint32_t h2 = __float_as_uint(s[4 * c + 1]), h3 = __float_as_uint(s[4 * c + 3]);
        wgmma_pv<kD>(o, p_lo[4 * c], p_lo[4 * c + 2], p_lo[4 * c + 1], p_lo[4 * c + 3],
                     smem_desc(vt_hi + vb, 16));
        wgmma_pv<kD>(o, h0, h1, h2, h3, smem_desc(vt_lo + vb, 16));
        wgmma_pv<kD>(o, h0, h1, h2, h3, smem_desc(vt_hi + vb, 16));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(s);
      fence_regs(p_lo);
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
    }

    // Epilogue: O / l into the Q tile (no wgmma reads it any more) in the
    // 128-byte swizzle of the output map, 32 columns a region, then one TMA
    // store per region.
    const float inv0 = 1.0f / sm90::quad_sum(l0), inv1 = 1.0f / sm90::quad_sum(l1);
    const int row = (tid / 32) * 16 + lane / 4;  // and row + 8; row % 8 == lane / 4
    const int t = lane % 4;
#pragma unroll
    for (int c = 0; c < kD / 8; ++c) {
      uint8_t* region = smem + (c / 4) * kQRegion;
      const int chunk = ((2 * (c % 4) + t / 2) ^ (lane / 4)) * 16 + 8 * (t % 2);
      *reinterpret_cast<float2*>(region + row * 128 + chunk) =
          make_float2(o[4 * c] * inv0, o[4 * c + 1] * inv0);
      *reinterpret_cast<float2*>(region + (row + 8) * 128 + chunk) =
          make_float2(o[4 * c + 2] * inv1, o[4 * c + 3] * inv1);
    }
    fence_proxy_async();
    asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the consumer warpgroup alone
    if (tid == 0) {
#pragma unroll
      for (int r = 0; r < kRegions; ++r) {
        tma_store_4d(to, q_hi + r * kQRegion, 32 * r, q0, head, batch);
      }
      tma_store_wait();
    }
  }
}

// --- the wide form: head widths above 128 ------------------------------------------

// K2's and K3's fp32 heads wider than 128, with the arithmetic above (split
// TF32 on both products, the online softmax, the division after P.V), at a
// head width d that is a runtime multiple of 64 (the wrapper zero-pads to it;
// zero columns change no result). As the bf16 wide form (attention_sm90.cuh,
// attention_wide), the head splits into two widths:
// * the S reduction over all of d: Q and K are d / 32 regions of 32 columns
//   (one 128-byte swizzle atom), and the ring carries a key tile's K in
//   pieces of up to kPieceRegions regions, S summing the three TF32 chains
//   over each piece's regions in turn;
// * the output chunk of kD = 128 columns: O of 64 rows x 128 fp32 is 64
//   registers a consumer thread, in two 64-column groups. A head wider than
//   the chunk recomputes S for each chunk: grid (ceil(N / 64), H * chunks, B).
// Key tiles of 64 keys: the S wgmma (m64n64k8) reads Q once for twice the keys
// of a 32-key tile (m64n32k8, as Head128), which reads A and B faster than
// shared memory delivers. A chunk's V (then V^T) and V^T lo are 64 KB.
// Shared memory is the hard part: in fp32 every operand has a lo copy, so a
// column costs four times its bf16 bytes. Q and Q lo of 64 rows stay resident
// where they fit beside two ring slots (d <= 192); a wider head streams Q:
// each K piece's slot carries Q's regions of the same columns beside it, read
// again from L2 for every key tile, and the converter makes their lo copies
// per piece. A slot holds the larger of a K piece (K and K lo, with Q and Q lo
// when streamed) and a V chunk; the ring has as many slots as fit, up to
// kMaxStages; a streamed piece narrows until two slots fit (3 regions).
// Roles as in attention() above: the producer (warp 8) issues every TMA load,
// item after item (a key tile's K pieces, then its V chunk); the converter
// warpgroup makes K lo (and Q lo) of a K piece and transposes a V chunk into
// V^T and V^T lo; the consumer warpgroup runs S piece by piece, the softmax,
// and O += P.V over the chunk's groups. 288 threads give a thread at most 168
// registers (ptxas and the launch count registers by whole warpgroups); the
// consumer takes about 155 (O 64, S 32, P lo 32). A 256-column chunk would
// need about 195: its CTA must drop the producer warp and issue from the
// consumer, and it measured slower (PERF.md, PR 20). Each wgmma group is one
// whole instantiation of wide_scores / wide_pv picked by the region or group
// count, so that no wgmma sits under a runtime condition (ptxas serializes
// such a chain). A chunk's columns past d are neither loaded, computed nor
// stored (the V^T rows past them hold stale bytes no wgmma reads). The
// epilogue stages the chunk in the ring, which every consumed item has left.
struct Wide {
  static constexpr int kBlockQ = 64;  // query rows per CTA: the consumer warpgroup's wgmma M
  static constexpr int kBlockK = 64;
  static constexpr int kThreads = 288;  // consumer warpgroup, converter warpgroup, producer warp
  static constexpr int kOGroups = 2;             // 64-column groups of an output chunk
  static constexpr int kD = 64 * kOGroups;       // columns of an output chunk (transpose_v's kD)
  static constexpr int kPieceRegions = kD / 32;  // 32-column regions of the widest K piece
  static constexpr int kS = kBlockK / 2;         // scores a consumer thread holds
  static constexpr int kMaxStages = 6;
  static constexpr uint32_t kQRegion = kBlockQ * 128;  // 32 columns of the query tile
  static constexpr uint32_t kKRegion = kBlockK * 128;  // 32 columns of a key tile
  static constexpr uint32_t kVtRegion = kD * 128;      // 32 keys of a chunk's V^T
  static constexpr uint32_t kVtBytes = kD * kBlockK * 4;  // a chunk's V^T; V^T lo follows
  static constexpr uint32_t kBarBytes = 8 * (2 + 3 * kMaxStages);
  static constexpr uint32_t kSmemLimit = 232448;  // a CTA's 227 KB
};

// What a wide launch computes at: the head's regions and chunks, the ring.
struct WideArgs {
  int n;
  float scale_log2;
  int regions;        // d / 32
  int chunks;         // ceil(d / Wide::kD)
  int piece_regions;  // regions of a K piece (the last piece of a key tile may hold fewer)
  int stages;         // slots of the ring
  int q_streamed;     // 1: Q and Q lo ride in each K piece's slot
  uint32_t slot;      // bytes of a slot
};

// Shared memory of a wide CTA: Q and Q lo (resident) or nothing, the ring,
// the mbarriers q_full, q_ready, full[kMaxStages], ready[kMaxStages],
// empty[kMaxStages], 1024 for alignment.
__host__ __device__ inline uint32_t wide_q_bytes(const WideArgs& a) {
  return a.q_streamed ? 0u : 2u * static_cast<uint32_t>(a.regions) * Wide::kQRegion;
}

inline uint32_t wide_smem_bytes(const WideArgs& a) {
  return wide_q_bytes(a) + a.stages * a.slot + Wide::kBarBytes + 1024;
}

inline WideArgs wide_args(int d, int n, float scale) {
  const auto slot_of = [](int p, bool q_streamed) {
    const uint32_t piece = 2u * p * (Wide::kKRegion + (q_streamed ? Wide::kQRegion : 0u));
    return piece > 2 * Wide::kVtBytes ? piece : 2 * Wide::kVtBytes;
  };
  WideArgs a;
  a.n = n;
  a.scale_log2 = scale * 1.4426950408889634f;
  a.regions = d / 32;
  a.chunks = (d + Wide::kD - 1) / Wide::kD;
  uint32_t room = Wide::kSmemLimit - Wide::kBarBytes - 1024;
  const uint32_t q_bytes = 2u * a.regions * Wide::kQRegion;
  int p = a.regions < Wide::kPieceRegions ? a.regions : Wide::kPieceRegions;
  a.q_streamed = q_bytes + 2 * slot_of(p, false) > room;
  if (a.q_streamed) {
    while (p > 1 && 2 * slot_of(p, true) > room) --p;  // the widest piece that leaves two slots
  } else {
    room -= q_bytes;
  }
  a.piece_regions = p;
  a.slot = slot_of(p, a.q_streamed);
  a.stages = static_cast<int>(room / a.slot);
  if (a.stages > Wide::kMaxStages) a.stages = Wide::kMaxStages;
  return a;
}

// dst = lo(src) over `bytes` (a multiple of 2048) of shared memory, by the 128
// converter threads (ct).
__device__ __forceinline__ void split_lo_n(const uint8_t* src, uint8_t* dst, uint32_t bytes,
                                           int ct) {
  for (uint32_t off = ct * 16; off < bytes; off += 128 * 16) {
    *reinterpret_cast<float4*>(dst + off) = tf32_lo(*reinterpret_cast<const float4*>(src + off));
  }
}

// S (+)= Qlo.Khi + Qhi.Klo + Qhi.Khi over the N regions of one K piece (K at
// kh, K lo at kl, Q's regions of the same columns at qh and ql) as one wgmma
// group, region j in 4 k8 steps (step kk at byte 32 * kk of the region);
// first: S is overwritten.
template <int N>
__device__ __forceinline__ void wide_scores(float (&s)[Wide::kS], uint32_t qh, uint32_t ql,
                                            uint32_t kh, uint32_t kl, bool first) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t qa = j * Wide::kQRegion + 32 * kk;
      const uint32_t ka = j * Wide::kKRegion + 32 * kk;
      wgmma_scores<Wide::kBlockK>(s, smem_desc(ql + qa, 16), smem_desc(kh + ka, 16),
                                  (!first || j || kk) ? 1 : 0);
      wgmma_scores<Wide::kBlockK>(s, smem_desc(qh + qa, 16), smem_desc(kl + ka, 16), 1);
      wgmma_scores<Wide::kBlockK>(s, smem_desc(qh + qa, 16), smem_desc(kh + ka, 16), 1);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
}

// wide_scores at the piece's region count nr (1 to N), one instantiation a count.
template <int N>
__device__ __forceinline__ void wide_scores_of(int nr, float (&s)[Wide::kS], uint32_t qh,
                                               uint32_t ql, uint32_t kh, uint32_t kl, bool first) {
  if constexpr (N > 1) {
    if (nr < N) {
      wide_scores_of<N - 1>(nr, s, qh, ql, kh, kl, first);
      return;
    }
  }
  wide_scores<N>(s, qh, ql, kh, kl, first);
}

// O += Plo.Vhi + Phi.Vlo + Phi.Vhi over the tile's keys and the first N
// 64-column groups of the chunk (V^T at vh, V^T lo at vl) as one wgmma group;
// P's hi is the score register itself, its A fragment in V^T's key order as in
// attention() above.
template <int N>
__device__ __forceinline__ void wide_pv(float (&o)[Wide::kOGroups][32], float (&s)[Wide::kS],
                                        uint32_t (&p_lo)[Wide::kS], uint32_t vh, uint32_t vl) {
#pragma unroll
  for (int j = 0; j < Wide::kOGroups; ++j) fence_regs(o[j]);
  fence_regs(s);
  fence_regs(p_lo);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < Wide::kBlockK / 8; ++c) {
    const uint32_t h0 = __float_as_uint(s[4 * c]), h1 = __float_as_uint(s[4 * c + 2]);
    const uint32_t h2 = __float_as_uint(s[4 * c + 1]), h3 = __float_as_uint(s[4 * c + 3]);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const uint32_t vb = (c / 4) * Wide::kVtRegion + j * 64 * 128 + 32 * (c % 4);
      wgmma_m64n64k8_rs(o[j], p_lo[4 * c], p_lo[4 * c + 2], p_lo[4 * c + 1], p_lo[4 * c + 3],
                        smem_desc(vh + vb, 16));
      wgmma_m64n64k8_rs(o[j], h0, h1, h2, h3, smem_desc(vl + vb, 16));
      wgmma_m64n64k8_rs(o[j], h0, h1, h2, h3, smem_desc(vh + vb, 16));
    }
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int j = 0; j < Wide::kOGroups; ++j) fence_regs(o[j]);
  fence_regs(s);
  fence_regs(p_lo);
}

// One CTA of Wide::kThreads threads per (64-row query tile, head x chunk,
// batch item), grid (ceil(n / 64), heads * a.chunks, batch),
// wide_smem_bytes(a) of dynamic shared memory.
__device__ __forceinline__ void attention_wide(const CUtensorMap& tq, const CUtensorMap& tk,
                                               const CUtensorMap& tv, const CUtensorMap& to,
                                               const WideArgs& a) {
  constexpr int kBlockK = Wide::kBlockK, kOGroups = Wide::kOGroups;
  constexpr uint32_t kQRegion = Wide::kQRegion, kKRegion = Wide::kKRegion;
  constexpr int kMaxStages = Wide::kMaxStages;

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t q_bytes = wide_q_bytes(a);
  const uint32_t q_hi = base;               // resident: region r at + r * kQRegion
  const uint32_t q_lo = base + q_bytes / 2;
  const uint32_t ring = base + q_bytes;
  const uint32_t bar_q_full = ring + a.stages * a.slot;
  const uint32_t bar_q_ready = bar_q_full + 8;
  const uint32_t bar_full = bar_q_ready + 8;             // + 8 * stage
  const uint32_t bar_ready = bar_full + 8 * kMaxStages;  // + 8 * stage
  const uint32_t bar_empty = bar_ready + 8 * kMaxStages;  // + 8 * stage

  const int n = a.n, regions = a.regions, pr = a.piece_regions, stages = a.stages;
  const bool q_streamed = a.q_streamed;
  const int q0 = blockIdx.x * Wide::kBlockQ;
  const int head = blockIdx.y / a.chunks;
  const int col0 = (blockIdx.y % a.chunks) * Wide::kD;  // this CTA's first output column
  const int o_regions = min(Wide::kD / 32, regions - col0 / 32);  // the chunk's regions inside d
  const int batch = blockIdx.z;
  const int tiles = (n + kBlockK - 1) / kBlockK;
  const int pieces = (regions + pr - 1) / pr;  // K pieces a key tile
  // a K piece's slot: K (pr regions), K lo, then (streamed) Q and Q lo
  const uint32_t k_lo_off = pr * kKRegion;
  const uint32_t q_off = 2 * pr * kKRegion;
  const uint32_t q_lo_off = q_off + pr * kQRegion;

  if (threadIdx.x == 0) {
    mbar_init(bar_q_full, 1);
    mbar_init(bar_q_ready, 128);  // every converter thread
    for (int st = 0; st < stages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_ready + 8 * st, 128);
      mbar_init(bar_empty + 8 * st, 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // The producer: one thread issues every copy, item after item.
    if (threadIdx.x != 256) return;
    if (!q_streamed) {
      mbar_expect_tx(bar_q_full, regions * kQRegion);
      for (int r = 0; r < regions; ++r) {
        tma_load_4d(q_hi + r * kQRegion, tq, bar_q_full, 32 * r, q0, head, batch);
      }
    }
    int st = 0;
    uint32_t phase = 0;
    for (int t = 0; t < tiles; ++t) {
      const int key0 = t * kBlockK;
      for (int pc = 0; pc <= pieces; ++pc) {
        const uint32_t slot = ring + st * a.slot;
        const uint32_t full = bar_full + 8 * st;
        mbar_wait(bar_empty + 8 * st, phase ^ 1);  // the first round passes
        if (pc == pieces) {  // the V chunk
          mbar_expect_tx(full, o_regions * kKRegion);
          for (int j = 0; j < o_regions; ++j) {
            tma_load_4d(slot + j * kKRegion, tv, full, col0 + 32 * j, key0, head, batch);
          }
        } else {
          const int r0 = pc * pr;
          const int nr = min(pr, regions - r0);
          mbar_expect_tx(full, nr * (kKRegion + (q_streamed ? kQRegion : 0u)));
          for (int j = 0; j < nr; ++j) {
            tma_load_4d(slot + j * kKRegion, tk, full, 32 * (r0 + j), key0, head, batch);
            if (q_streamed) {
              tma_load_4d(slot + q_off + j * kQRegion, tq, full, 32 * (r0 + j), q0, head, batch);
            }
          }
        }
        if (++st == stages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  if (threadIdx.x >= 128) {
    // The converter warpgroup: the lo copies of every K piece (and streamed Q),
    // V^T and V^T lo of every V chunk, item after item.
    const int ct = threadIdx.x - 128;
    if (!q_streamed) {
      mbar_wait(bar_q_full, 0);
      split_lo_n(smem, smem + q_bytes / 2, q_bytes / 2, ct);
      fence_proxy_async();
      mbar_arrive(bar_q_ready);
    }
    int st = 0;
    uint32_t phase = 0;
    for (int t = 0; t < tiles; ++t) {
      for (int pc = 0; pc <= pieces; ++pc) {
        uint8_t* slot = smem + q_bytes + st * a.slot;
        mbar_wait(bar_full + 8 * st, phase);
        if (pc == pieces) {
          transpose_v<Wide>(slot, slot + Wide::kVtBytes, ct);
        } else {
          const int nr = min(pr, regions - pc * pr);
          split_lo_n(slot, slot + k_lo_off, nr * kKRegion, ct);
          if (q_streamed) split_lo_n(slot + q_off, slot + q_lo_off, nr * kQRegion, ct);
        }
        fence_proxy_async();
        mbar_arrive(bar_ready + 8 * st);
        if (++st == stages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // The consumer warpgroup: query rows [q0, q0 + 64), output columns
  // [col0, col0 + 32 * o_regions).
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int o_groups = o_regions / 2;  // d is a multiple of 64

  float o[kOGroups][32];
#pragma unroll
  for (int j = 0; j < kOGroups; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.0f;
  }
  float s[Wide::kS];
  uint32_t p_lo[Wide::kS];
#pragma unroll
  for (int i = 0; i < Wide::kS; ++i) s[i] = 0.0f;
  // per row (this thread's two rows): the running max (raw scores) and this
  // thread's part of the running sum
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  if (!q_streamed) mbar_wait(bar_q_ready, 0);
  int st = 0;
  uint32_t phase = 0;
  for (int t = 0; t < tiles; ++t) {
    const int key0 = t * kBlockK;
    // S = Q . K^T over d, piece after piece of the key tile.
    for (int pc = 0; pc < pieces; ++pc) {
      const uint32_t slot = ring + st * a.slot;
      const int r0 = pc * pr;
      const uint32_t qh = q_streamed ? slot + q_off : q_hi + r0 * kQRegion;
      const uint32_t ql = q_streamed ? slot + q_lo_off : q_lo + r0 * kQRegion;
      mbar_wait(bar_ready + 8 * st, phase);
      wide_scores_of<Wide::kPieceRegions>(min(pr, regions - r0), s, qh, ql, slot,
                                          slot + k_lo_off, pc == 0);
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
      if (++st == stages) {
        st = 0;
        phase ^= 1;
      }
    }

    if (key0 + kBlockK > n) sm90::mask_keys(s, key0, n, lane);

    float mx0, mx1, sum0, sum1;
    sm90::row_max(s, mx0, mx1);
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: key0 < n
    const float alpha0 = sm90::ex2((m0 - mn0) * a.scale_log2);  // 0 on the first tile
    const float alpha1 = sm90::ex2((m1 - mn1) * a.scale_log2);
    sm90::exp_rows(s, a.scale_log2, mn0 * a.scale_log2, mn1 * a.scale_log2, sum0, sum1);
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < kOGroups; ++j) sm90::scale_rows(o[j], alpha0, alpha1);

    // O += P . V over the tile's keys and the chunk's groups, one instantiation
    // a group count.
#pragma unroll
    for (int i = 0; i < Wide::kS; ++i) p_lo[i] = __float_as_uint(tf32_lo(s[i]));
    const uint32_t slot = ring + st * a.slot;
    mbar_wait(bar_ready + 8 * st, phase);
    if (o_groups == kOGroups) {
      wide_pv<kOGroups>(o, s, p_lo, slot, slot + Wide::kVtBytes);
    } else {
      wide_pv<1>(o, s, p_lo, slot, slot + Wide::kVtBytes);
    }
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);
    if (++st == stages) {
      st = 0;
      phase ^= 1;
    }
  }

  // Epilogue: O / l into the ring (every item consumed, none in flight) in the
  // 128-byte swizzle of the output map, 32 columns a region, then one TMA
  // store per region inside d (rows >= n clipped).
  const float inv0 = 1.0f / sm90::quad_sum(l0), inv1 = 1.0f / sm90::quad_sum(l1);
  const int row = (tid / 32) * 16 + lane / 4;  // and row + 8; row % 8 == lane / 4
  const int t4 = lane % 4;
  uint8_t* out = smem + q_bytes;
#pragma unroll
  for (int j = 0; j < kOGroups; ++j) {
    if (j < o_groups) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = 8 * j + i;  // 8-column group of the chunk
        uint8_t* region = out + (c / 4) * kQRegion;
        const int chunk = ((2 * (c % 4) + t4 / 2) ^ (lane / 4)) * 16 + 8 * (t4 % 2);
        *reinterpret_cast<float2*>(region + row * 128 + chunk) =
            make_float2(o[j][4 * i] * inv0, o[j][4 * i + 1] * inv0);
        *reinterpret_cast<float2*>(region + (row + 8) * 128 + chunk) =
            make_float2(o[j][4 * i + 2] * inv1, o[j][4 * i + 3] * inv1);
      }
    }
  }
  fence_proxy_async();
  asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the consumer warpgroup alone
  if (tid == 0) {
    for (int r = 0; r < o_regions; ++r) {
      tma_store_4d(to, ring + r * kQRegion, col0 + 32 * r, q0, head, batch);
    }
    tma_store_wait();
  }
}

// --- host side -------------------------------------------------------------------

// A rank-4 map over one fp32 operand's (d, N, H, B) with element strides
// (token, head, batch) and a box of 32 x `box_rows`. The stride of an axis of
// extent 1 is never stepped; it gets a legal value whatever the view says.
inline bool encode_operand(sm90::EncodeTiledFn encode, CUtensorMap* map, const void* ptr, int d,
                           int n, int heads, int batch, int64_t s_n, int64_t s_h, int64_t s_b,
                           int box_rows) {
  constexpr uint64_t e = sizeof(float);
  const cuuint64_t sn = n > 1 ? s_n * e : d * e;
  const cuuint64_t sh = heads > 1 ? s_h * e : sn * n;
  const cuuint64_t sb = batch > 1 ? s_b * e : sh * heads;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {sn, sh, sb};
  const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Encodes the four tensor maps and launches `kernel` (a __global__ wrapper of
// attention<Cfg>) over `batch` x `heads` problems of `n` tokens on `stream`.
// strides: 12 element strides, (batch, head, token) of q, k, v, then o.
// Returns a cudaError_t (0 on success).
template <typename Cfg>
int launch(sm90::Kernel kernel, const void* q, const void* k, const void* v, void* o,
           const int64_t* strides, int batch, int heads, int n, float scale, void* stream) {
  const sm90::EncodeTiledFn encode = sm90::encode_tiled();
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
  const cudaError_t err = sm90::allow_smem(reinterpret_cast<const void*>(kernel), Cfg::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + Cfg::kBlockQ - 1) / Cfg::kBlockQ, heads, batch);
  kernel<<<grid, Cfg::kThreads, Cfg::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], n, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

typedef void (*WideKernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                           const CUtensorMap, const WideArgs);

// The same for `kernel`, a __global__ wrapper of attention_wide, at a head
// width d above 128 that is a multiple of 64.
inline int launch_wide(WideKernel kernel, const void* q, const void* k, const void* v, void* o,
                       const int64_t* strides, int batch, int heads, int n, int d, float scale,
                       void* stream) {
  if (d <= 128 || d % 64 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const sm90::EncodeTiledFn encode = sm90::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, o};
  const int box_rows[4] = {Wide::kBlockQ, Wide::kBlockK, Wide::kBlockK, Wide::kBlockQ};
  for (int i = 0; i < 4; ++i) {
    const int64_t* st = strides + 3 * i;
    if (!encode_operand(encode, &maps[i], ptrs[i], d, n, heads, batch, st[2], st[1], st[0],
                        box_rows[i])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const WideArgs a = wide_args(d, n, scale);
  if (a.stages < 2 || static_cast<int64_t>(heads) * a.chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the largest a wide launch takes, raised once; each launch asks for its own
  const cudaError_t err = sm90::allow_smem(reinterpret_cast<const void*>(kernel),
                                           Wide::kSmemLimit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + Wide::kBlockQ - 1) / Wide::kBlockQ, heads * a.chunks, batch);
  kernel<<<grid, Wide::kThreads, wide_smem_bytes(a), static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90f32
}  // namespace
