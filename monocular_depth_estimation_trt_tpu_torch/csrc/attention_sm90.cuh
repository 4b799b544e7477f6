// The Hopper attention mainloop of kernels K2 (flash_attention.cu) and K3
// (flash_attention_batched.cu), bf16 only: non-causal softmax(q k^T * scale) v
// over (B, H, N, 64) operands that are read through their own strides, with
// the output written as (B, N, H, 64).
//
// CTA: one producer warpgroup, whose first thread issues every copy, and
// one consumer warpgroup of 64 query rows; setmaxnreg moves registers from
// the producer (24 a thread) to the consumer (232). Two CTAs are resident
// on an SM. Grid (ceil(N / 64), H, B). This measured 9 to 14 % faster on
// the H100 than one CTA an SM with two consumer warpgroups sharing its ring
// (scripts/torch_kernel_ab.py, PERF.md): the two CTAs' prologues, epilogues
// and waits can interleave. Three CTAs an SM give the kernel 80 registers a
// thread at launch, and ptxas refuses the m64n128 wgmma at that count.
//
// Loads: one rank-4 TMA tensor map per operand over (d, N, H, B), with the
// view's own byte strides, a box of 64 (d) x the tile's rows and the 128-byte
// swizzle (a 64-wide bf16 row is 128 bytes). TMA fills the rows past N of a
// head with zeros; scores of keys >= N are set to -inf on the last key tile.
// K and V stream through a ring of kStages (K tile, V tile) stages of 128
// keys, guarded by full and empty mbarriers (an empty stage takes one
// arrival per consumer warp).
//
// S = Q.K^T: wgmma m64n128k16 (fp32 <- bf16 x bf16), Q and K both from shared
// memory and both K-major; S stays in registers (64 fp32 a thread). The
// softmax runs on the accumulator fragment: a row lives on the four threads
// of a quad, so a row reduction takes two shuffles; exp2 with scale*log2(e)
// folded into one FMA. P is cast to bf16 in registers and fed as the
// register A operand of wgmma m64n64k16 against the V tile in shared memory
// (V is (keys, d) with d contiguous: an MN-major B operand, transposed). O
// (64 x 64 fp32 a warpgroup) stays in registers for the whole loop. The
// epilogue stages O, cast to bf16, in the Q tile and writes it with a TMA
// store, which clips rows >= N.
//
// Two softmax modes, chosen by the kernel:
// * online (K2): one pass over K/V; a running row max and sum, O rescaled
//   in registers by exp(m_old - m_new) on every tile, the unnormalised
//   exponentials cast before P.V, and the row sum divides once at the end.
// * exact (K3): the TPU kernel's division before the cast. Pass 1 streams
//   only K tiles and keeps the row max m and the rescaled row sum l; pass 2
//   streams K and V again, recomputes S and forms P = exp(s*scale - m) / l,
//   as exp2(s*scale*log2(e) - (m*scale*log2(e) + log2(l))), cast to bf16
//   before P.V; O accumulates with no rescaling and the epilogue only casts.
//
// Left for later: ping-pong scheduling of two consumer warpgroups and
// overlap of the softmax with the next tile's wgmma inside a warpgroup; a
// persistent tile scheduler; RoPE fused into the Q/K tile load.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {
namespace sm90 {

constexpr int kD = 64;        // head_dim
constexpr int kBlockQ = 64;   // query rows per CTA: the consumer warpgroup's wgmma M
constexpr int kBlockK = 128;  // keys per K/V tile
constexpr int kStages = 3;    // (K, V) stages of the ring
constexpr int kThreads = 256;  // the consumer warpgroup, then the producer warpgroup
constexpr int kMinCtas = 2;    // CTAs resident on an SM
// setmaxnreg: a CTA holds the registers of its launch (the largest multiple
// of 8 a thread that lets kMinCtas CTAs share the SM's 64K: 128); the
// producer keeps 24 a thread and the consumer takes the rest.
constexpr int kLaunchRegs = 65536 / (kMinCtas * kThreads) / 8 * 8;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = (2 * kLaunchRegs - kProducerRegs) / 8 * 8;  // 232
constexpr uint32_t kQBytes = kBlockQ * kD * 2;     // 8 KB
constexpr uint32_t kTileBytes = kBlockK * kD * 2;  // 16 KB

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle repeats
// every 8 rows of 128 bytes): the Q tile, the K tiles, the V tiles, then the
// mbarriers: q_full, full[kStages], empty[kStages].
constexpr uint32_t kOffK = kQBytes;
constexpr uint32_t kOffV = kOffK + kStages * kTileBytes;
constexpr uint32_t kOffBar = kOffV + kStages * kTileBytes;
constexpr uint32_t kSmemBytes = kOffBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
static_assert(kMinCtas * (kSmemBytes + 1024) <= 233472,
              "kMinCtas CTAs must fit the SM's 228 KB of shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
// No wait of this kernel lasts longer than one tile's copy or compute, so a
// wait that has not ended after 2^30 tries (seconds) is a fault: it traps,
// and the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 30)) __trap();
  }
}

// --- TMA -----------------------------------------------------------------------

// The box at (0, row, head, batch) of `map` into shared memory at `dst`;
// completion is reported to `bar` as transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                         int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(0), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// Shared memory at `src` to the box at (0, row, head, batch) of `map`; waits
// until the copy has read shared memory.
__device__ __forceinline__ void tma_store(const CUtensorMap& map, uint32_t src, int row, int head,
                                          int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(&map)),
      "r"(src), "r"(0), "r"(row), "r"(head), "r"(batch)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// --- wgmma ---------------------------------------------------------------------

// Shared-memory matrix descriptor of a tile of 128-byte rows under the
// 128-byte swizzle: start address, leading byte offset, stride byte offset
// 1024 (from one group of 8 rows to the next), layout type 1 (128B swizzle).
// K-major operands (Q, K) step along d by adding 32 bytes to the start
// address; the leading offset is not used for them. For the MN-major V tile,
// 1024 is the stride between groups of 8 keys, and a 64-wide d is one
// swizzle atom, so the leading offset (between atoms along d) is never
// stepped; it is set to 1024 as well.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the wgmma's wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

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
__device__ __forceinline__ void mask_keys(float (&s)[64], int key0, int n, int lane) {
#pragma unroll
  for (int c = 0; c < 16; ++c) {
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
__device__ __forceinline__ void row_max(const float (&s)[64], float& mx0, float& mx1) {
  mx0 = fmaxf(s[0], s[1]);
  mx1 = fmaxf(s[2], s[3]);
#pragma unroll
  for (int c = 1; c < 16; ++c) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * c], s[4 * c + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * c + 2], s[4 * c + 3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
}

// s <- exp2(s * c - bias) per row, in place; returns this thread's part of
// the two row sums.
__device__ __forceinline__ void exp_rows(float (&s)[64], float c, float bias0, float bias1,
                                         float& sum0, float& sum1) {
  sum0 = 0.0f;
  sum1 = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[4 * i + j] = ex2(fmaf(s[4 * i + j], c, -bias0));
      s[4 * i + 2 + j] = ex2(fmaf(s[4 * i + 2 + j], c, -bias1));
      sum0 += s[4 * i + j];
      sum1 += s[4 * i + 2 + j];
    }
  }
}

// --- the kernel body -----------------------------------------------------------

// One CTA of kThreads threads per (64-row query tile, head, batch item),
// grid (ceil(n / 64), heads, batch), kSmemBytes of dynamic shared memory.
// kExact selects the two-pass exact softmax (K3) over the online one (K2).
// Each kernel wraps it in a __global__ of its own name.
template <bool kExact>
__device__ __forceinline__ void attention(const CUtensorMap& tq, const CUtensorMap& tk,
                                          const CUtensorMap& tv, const CUtensorMap& to, int n,
                                          float scale_log2) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t k_s = base + kOffK;
  const uint32_t v_s = base + kOffV;
  const uint32_t bar_q = base + kOffBar;
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128) {
      mbar_expect_tx(bar_q, kQBytes);
      tma_load(q_s, tq, bar_q, q0, head, batch);
      for (int it = 0; it < steps; ++it) {
        const int st = it % kStages;
        const uint32_t round = it / kStages;
        const bool with_v = !kExact || it >= tiles;
        const int key0 = (kExact && it >= tiles ? it - tiles : it) * kBlockK;
        mbar_wait(bar_empty + 8 * st, (round & 1) ^ 1);  // the first round passes
        mbar_expect_tx(bar_full + 8 * st, with_v ? 2 * kTileBytes : kTileBytes);
        tma_load(k_s + st * kTileBytes, tk, bar_full + 8 * st, key0, head, batch);
        if (with_v) tma_load(v_s + st * kTileBytes, tv, bar_full + 8 * st, key0, head, batch);
      }
    }
  } else {
    // The consumer warpgroup: query rows [q0, q0 + 64).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x;
    const int lane = tid % 32;

    float s[64];
    float o[32];
    uint32_t p[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
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

      // S = Q . K^T over d in four k16 steps.
      const uint32_t k_tile = k_s + st * kTileBytes;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_m64n128k16_ss(s, smem_desc(q_s + 32 * kk, 16), smem_desc(k_tile + 32 * kk, 16),
                            kk);
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
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          o[4 * c] *= alpha0;
          o[4 * c + 1] *= alpha0;
          o[4 * c + 2] *= alpha1;
          o[4 * c + 3] *= alpha1;
        }
      }

      // O += P . V over the tile's keys in eight k16 steps, P from registers.
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
      const uint32_t v_tile = v_s + st * kTileBytes;
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        wgmma_m64n64k16_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                           smem_desc(v_tile + kk * 16 * 128, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(p);
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
    }

    if (!kExact) {  // the deferred division by the row sum
      const float inv0 = 1.0f / quad_sum(l0), inv1 = 1.0f / quad_sum(l1);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        o[4 * c] *= inv0;
        o[4 * c + 1] *= inv0;
        o[4 * c + 2] *= inv1;
        o[4 * c + 3] *= inv1;
      }
    }

    // Epilogue: O as bf16 into the Q tile (no wgmma reads it any more), in
    // the 128-byte swizzle of the output map, then one TMA store.
    uint8_t* stage = smem;
    const int row = (tid / 32) * 16 + lane / 4;  // and row + 8; row % 8 == lane / 4
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int chunk = (c ^ (lane / 4)) * 16 + 4 * (lane % 4);
      *reinterpret_cast<uint32_t*>(stage + row * 128 + chunk) = pack_bf16(o[4 * c], o[4 * c + 1]);
      *reinterpret_cast<uint32_t*>(stage + (row + 8) * 128 + chunk) =
          pack_bf16(o[4 * c + 2], o[4 * c + 3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the consumer warpgroup alone
    if (tid == 0) tma_store(to, q_s, q0, head, batch);
  }
}

// --- host side -----------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found once through the CUDA runtime
// (no link against libcuda); null if the installed libcuda lacks it.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(ptr)
               : nullptr;
  }();
  return fn;
}

// A rank-4 map over one bf16 operand's (d, N, H, B) with element strides
// (token, head, batch) and a box of 64 x `box_rows`. The stride of an axis
// of extent 1 is never stepped; it gets a legal value whatever the view says.
inline bool encode_operand(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, int n,
                           int heads, int batch, int64_t s_n, int64_t s_h, int64_t s_b,
                           int box_rows) {
  constexpr uint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t sn = n > 1 ? s_n * e : kD * e;
  const cuuint64_t sh = heads > 1 ? s_h * e : sn * n;
  const cuuint64_t sb = batch > 1 ? s_b * e : sh * heads;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kD), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {sn, sh, sb};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kD), static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

typedef void (*Kernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap, const CUtensorMap,
                       int, float);

// Encodes the four tensor maps and launches `kernel` (a __global__ wrapper of
// attention<>) over `batch` x `heads` problems of `n` tokens on `stream`.
// strides: 12 element strides, (batch, head, token) of q, k, v, then o.
// Returns a cudaError_t (0 on success).
inline int launch(Kernel kernel, const void* q, const void* k, const void* v, void* o,
                  const int64_t* strides, int batch, int heads, int n, float scale, void* stream) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, o};
  const int box_rows[4] = {kBlockQ, kBlockK, kBlockK, kBlockQ};
  for (int i = 0; i < 4; ++i) {
    const int64_t* st = strides + 3 * i;
    if (!encode_operand(encode, &maps[i], ptrs[i], n, heads, batch, st[2], st[1], st[0],
                        box_rows[i])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, heads, batch);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], n, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace
