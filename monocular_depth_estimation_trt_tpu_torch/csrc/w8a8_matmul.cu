// Static-scale int8 (w8a8) matmul for Hopper (sm_90a), kernel K4.
//
// Replaces the TPU kernel
//   monocular_depth_estimation_trt_tpu/ops/pallas/quant_matmul.py::_w8a8_kernel
// (entry w8a8_matmul). Same function, in one pass over the output:
//   xq  = clip(round(x * qmul[k]), -127, 127)           int8, per input channel k
//   acc = xq . weight_q^T                               int8 x int8 -> int32, exact
//   out = float(acc) * out_scale[n] (+ bias[n])         fp32, cast to the output type
// x is (M, K) row-major bf16 or fp32; weight_q is (N, K) int8 row-major, the
// layout of nn.Linear's weight and the "col" operand of a row.col product.
// The output (M, N) has the type of x.
//
// Numerics: bit-exact with the plain version (ops/cuda/quant_matmul.py::
// w8a8_matmul_reference). The product is an exact integer sum; every float
// step is an explicit round-to-nearest intrinsic (__fmul_rn, a conversion
// that rounds half to even like jnp.round, __int2float_rn, __fadd_rn,
// __float2bfloat16_rn), so nvcc cannot contract the rescale and the bias
// into one FMA and move the result by an ulp. Clamping before or after the
// rounding gives the same integer, since +-127 are integers.
//
// What bounds it on the H100: 2*M*K*N int8 operations at 1979 TOP/s
// against M*K*itemsize + N*K + M*N*itemsize bytes at 3.35 TB/s. At every
// ViT shape of the paths (M = 577 to 20,195, K and N of 1024 to 4096) the
// operations dominate: 4.4 us of operations against 2.2 us of bytes for
// ViT-L's qkv at M = 1370.
//
// Design (bf16 x, what int8 serving runs): a persistent, warp-specialised
// TMA + wgmma GEMM. One CTA an SM walks the 128 x BN output tiles (tile t,
// t + gridDim.x, ...; n fastest, so that consecutive tiles share x rows and
// the weight stays in L2), BN = 128 or 256 as the caller asks (by default
// 256 where that leaves no more SMs idle than 128 would by a wave: the waves
// rule of ops/cuda/autotune.py, whose tuner may measure the other), with
// three warpgroups:
// * a producer, two of whose threads issue the TMA loads of each 128-wide
//   K step, each into a ring of its own behind full and empty mbarriers (3
//   stages each at BN = 256, 4 at 128): the bf16 x tile (128 rows x 128
//   columns, 32 KB, as two boxes of 64 columns under the 128-byte swizzle)
//   and the int8 weight tile (BN rows of 128 bytes, 128-byte swizzle). An x
//   stage is free again once quantized, a weight stage once its wgmmas are
//   done, so each ring keeps two stages loading. TMA zero-fills rows past M
//   and N and the K tail, and zero times anything is zero, so the sum stays
//   exact and nothing is padded in memory;
// * two consumer warpgroups of 64 output rows each. Each quantizes its own
//   rows of the landed x tile straight into the register A fragments of
//   wgmma m64n128k32 (s32 <- s8 x s8, A from registers, B K-major from
//   shared memory): times qmul, clamp, round half to even, four int8 to a
//   register. A step's quantize runs while the previous step's wgmmas are in
//   flight (two fragment buffers), so the quantize and the tensor cores
//   overlap, the quantize is spread over eight warps, and the quantized
//   activation reaches neither shared nor device memory. BN / 128 wgmmas per
//   k32 step on as many accumulators of 64 registers a thread; then the
//   epilogue rescales the accumulators in registers (out_scale and bias are
//   loaded when the tile starts and staged in shared memory, so that their
//   latency hides behind the mainloop) and, 64 columns at a time, stages the
//   bf16 slice in shared memory and writes rows with 16-byte stores,
//   clipping rows past M and columns past N, while the producer already
//   fills the next tile's stages.
// The quantize runs in the consumers because it is what bounds the kernel:
// a warpgroup of its own writing an int8 A tile for SS wgmmas measured up to
// 1.4x slower, and the consumers' quantize still sets most of the time above
// the TMA pipeline's (PERF.md).
// The C entry takes K % 16 == 0 and 16-byte aligned x and weight (the
// strides of the TMA maps); the wrapper zero-pads K where it is not.
//
// fp32 x (precision="fp32", a parity route) keeps the earlier kernel: one
// CTA of 8 warps per 128 x 128 output tile walks K in steps of 64, the
// quantize step fused into the A-tile load (16-byte vectors where K % 16 ==
// 0 and the operands are 16-byte aligned, else one element at a time), the
// product on the int8 tensor cores through nvcuda::wmma (m16n16k16), shared
// tiles as four 16-wide K slices, the epilogue through a per-warp scratch.
//
// Left on the table (later work): a cheaper quantize (its unpack, clamp
// and pack run on the half-rate ALU pipe), split-K or narrower tiles where
// M x N gives fewer tiles than SMs (proj and fc2 at M = 1370: 88 tiles of
// 128 columns for 132 SMs), an epilogue that overlaps the next tile's
// wgmmas, TMA stores of the output.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

// --- bf16 x: the TMA + wgmma kernel ---------------------------------------------

namespace gemm {

constexpr int kBM = 128;       // output rows per tile: two consumer warpgroups of 64
constexpr int kBK = 128;       // K per step: one 128-byte swizzle row of int8
constexpr int kThreads = 384;  // consumers (warpgroups 0 and 1), producer (2)
// setmaxnreg: the launch gives every thread 168 registers (65536 / 384,
// rounded down to a multiple of 8); the producer drops to 24 and the
// consumers, which hold up to 128 accumulators and two A fragments of 16
// registers a thread, rise to 240.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr uint32_t kXBytes = kBM * kBK * 2;  // bf16 x tile, 32 KB: two 64-column halves
constexpr uint32_t kXHalf = kBM * 128;       // one half: 128 rows of 128 bytes
constexpr uint32_t kOutBytes = 64 * 128;     // a consumer's 64 x 64 bf16 staging tile, 8 KB

// One instantiation: BN output columns per tile, and the stages of the x
// ring and of the weight ring that fit beside the two staging tiles.
template <int BN>
struct Config {
  static_assert(BN == 128 || BN == 256, "128- or 256-column tiles");
  static constexpr int kBN = BN;
  static constexpr int kHalves = BN / 128;  // m64n128k32 wgmmas per k32 step and warpgroup
  static constexpr int kXStages = BN == 256 ? 3 : 4;
  static constexpr int kBStages = BN == 256 ? 3 : 4;
  static constexpr uint32_t kBBytes = BN * kBK;  // int8 weight tile, 16 or 32 KB
  // Shared memory from a 1024-byte aligned base: the x tiles, the weight
  // tiles, the two staging tiles, each consumer's copy of the tile's
  // out_scale and bias (BN floats each), then the mbarriers
  // x_full[kXStages], x_empty[kXStages], b_full[kBStages], b_empty[kBStages].
  static constexpr uint32_t kOffB = kXStages * kXBytes;
  static constexpr uint32_t kOffOut = kOffB + kBStages * kBBytes;
  static constexpr uint32_t kOffScales = kOffOut + 2 * kOutBytes;
  static constexpr uint32_t kOffBar = kOffScales + 2 * 2 * BN * 4;
  static constexpr uint32_t kSmemBytes = kOffBar + 8 * 2 * (kXStages + kBStages) + 1024;
  static_assert(kSmemBytes <= 232448, "one CTA must fit 227 KB of shared memory");
};

// d[64x128] (+)= A[64x32] . B[32x128], s32 <- s8 x s8: A from registers
// (a0..a3, this thread's fragment), B from shared memory, K-major;
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k32_s8_rs(int32_t (&d)[64], uint32_t a0, uint32_t a1,
                                                       uint32_t a2, uint32_t a3, uint64_t desc_b,
                                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Two packed bf16 (the low one first) as floats.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// clip(round(x * q), -127, 127), as the low byte of a float: adding 1.5 *
// 2^23 to a value in [-127, 127] rounds it to the nearest integer, ties to
// even (the add's own rounding, at a spacing of 1), and leaves that integer,
// two's complement, in the low mantissa bits. Four full-rate float
// instructions, where a float-to-int conversion runs at a quarter rate.
__device__ __forceinline__ uint32_t quantize(float x, float q) {
  const float v = fminf(fmaxf(__fmul_rn(x, q), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(v, 12582912.0f));
}

// Four bf16 (one 8-byte word) of x times their qmul, as four int8 packed
// little-endian into one register.
__device__ __forceinline__ uint32_t quantize4(uint2 x, float4 q) {
  const uint32_t a = quantize(bf16_lo(x.x), q.x), b = quantize(bf16_hi(x.x), q.y);
  const uint32_t c = quantize(bf16_lo(x.y), q.z), d = quantize(bf16_hi(x.y), q.w);
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// This thread's A fragments of one K step, quantized from the landed x tile
// (its two 64-column halves, each 128 rows of 128 bytes under the 128-byte
// swizzle: 16-byte chunk j of row r at chunk j ^ (r % 8)). For the k32 step
// kk, registers 4 kk + i (i = 0, 1) hold row `row` + 8 i at columns 32 kk +
// 4 (lane % 4) + 0..3 and registers 4 kk + 2 + i the same rows 16 columns
// on: the wgmma A fragment, row = 16 w + lane / 4 within the warpgroup's 64
// for warp w, so row % 8 = lane / 4. Columns at or past k read a zero qmul
// (x is zero-filled there; k % 16 == 0 keeps each group of four whole).
__device__ __forceinline__ void quantize_fragments(uint32_t (&a)[16], const uint8_t* x_tile,
                                                   int row, int lane,
                                                   const float* __restrict__ qmul, int k0,
                                                   int k) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kBK / 32; ++kk) {
    const uint8_t* half = x_tile + (kk / 2) * kXHalf + 8 * (t % 2);
    const int chunk = 4 * (kk % 2) + t / 2;  // columns 32 kk + 4 t .. + 3 within the half
    const int col = k0 + 32 * kk + 4 * t;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 q_lo = col < k ? __ldg(reinterpret_cast<const float4*>(qmul + col)) : zero;
    const float4 q_hi =
        col + 16 < k ? __ldg(reinterpret_cast<const float4*>(qmul + col + 16)) : zero;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint8_t* r = half + (row + 8 * i) * 128;
      const uint2 lo = *reinterpret_cast<const uint2*>(r + ((chunk ^ g) * 16));
      const uint2 hi = *reinterpret_cast<const uint2*>(r + (((chunk + 2) ^ g) * 16));
      a[4 * kk + i] = quantize4(lo, q_lo);
      a[4 * kk + 2 + i] = quantize4(hi, q_hi);
    }
  }
}

// One K step of a consumer warpgroup: quantize the landed x tile into
// `cur` while the previous step's wgmmas, which read `prev`, are in flight,
// and release the x stage at once (its values are in registers now); wait
// for the weight tile and issue this step's wgmmas; then wait for the
// previous step's group, so that its weight stage and `prev` are free again
// (fence_regs keeps each fragment's registers untouched until that wait).
template <int Halves>
__device__ __forceinline__ void consumer_step(int32_t (&acc)[Halves][64], uint32_t (&cur)[16],
                                              uint32_t (&prev)[16], const uint8_t* x_tile,
                                              uint32_t x_empty, uint32_t b_tile, uint32_t b_full,
                                              uint32_t b_parity, int row, int lane,
                                              const float* __restrict__ qmul, int k0, int k,
                                              bool first) {
  quantize_fragments(cur, x_tile, row, lane, qmul, k0, k);
  __syncwarp();
  if (lane == 0) sm90::mbar_arrive(x_empty);
  sm90::mbar_wait(b_full, b_parity);
#pragma unroll
  for (int h = 0; h < Halves; ++h) sm90::fence_regs(acc[h]);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 32; ++kk) {
#pragma unroll
    for (int h = 0; h < Halves; ++h) {
      wgmma_m64n128k32_s8_rs(acc[h], cur[4 * kk], cur[4 * kk + 1], cur[4 * kk + 2],
                             cur[4 * kk + 3], sm90::smem_desc(b_tile + h * 128 * kBK + 32 * kk, 16),
                             !first || kk > 0);
    }
  }
  sm90::wgmma_commit();
  wgmma_wait_one();
#pragma unroll
  for (int h = 0; h < Halves; ++h) sm90::fence_regs(acc[h]);
  sm90::fence_regs(prev);
}

// The persistent kernel: gridDim.x CTAs of kThreads threads, Cfg::kSmemBytes
// of dynamic shared memory. tx: bf16 x (M, K); tw: int8 weight (N, K).
// Step `it` of a CTA's walk (its tiles one after the other, K steps within
// each) uses x stage it % Cfg::kXStages and weight stage it % Cfg::kBStages.
template <typename Cfg>
__global__ void __launch_bounds__(kThreads, 1)
    w8a8_kernel_sm90(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                     const float* __restrict__ qmul, const float* __restrict__ out_scale,
                     const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int m, int n,
                     int k) {
  constexpr int kBN = Cfg::kBN, kXStages = Cfg::kXStages, kBStages = Cfg::kBStages;
  constexpr int kHalves = Cfg::kHalves;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t x_full = base + Cfg::kOffBar;     // + 8 * x stage
  const uint32_t x_empty = x_full + 8 * kXStages;  // + 8 * x stage
  const uint32_t b_full = x_empty + 8 * kXStages;  // + 8 * weight stage
  const uint32_t b_empty = b_full + 8 * kBStages;  // + 8 * weight stage

  const int tiles_n = (n + kBN - 1) / kBN;
  const int tiles = (m + kBM - 1) / kBM * tiles_n;
  const int k_steps = (k + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kXStages; ++s) {
      sm90::mbar_init(x_full + 8 * s, 1);
      sm90::mbar_init(x_empty + 8 * s, 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < kBStages; ++s) {
      sm90::mbar_init(b_full + 8 * s, 1);
      sm90::mbar_init(b_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // The producer: the first thread of warp 0 issues the x copies, that of
    // warp 1 the weight copies, so that neither ring waits on the other.
    // The first round of each ring passes its empty barriers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid != 0 && tid != 32) return;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / tiles_n * kBM, n0 = t % tiles_n * kBN;
      for (int ks = 0; ks < k_steps; ++ks, ++it) {
        if (tid == 0) {
          const int xs = it % kXStages;
          sm90::mbar_wait(x_empty + 8 * xs, ((it / kXStages) & 1) ^ 1);
          sm90::mbar_expect_tx(x_full + 8 * xs, kXBytes);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            sm90::tma_load_2d(base + xs * kXBytes + h * kXHalf, tx, x_full + 8 * xs,
                              ks * kBK + 64 * h, m0);
          }
        } else {
          const int bs = it % kBStages;
          sm90::mbar_wait(b_empty + 8 * bs, ((it / kBStages) & 1) ^ 1);
          sm90::mbar_expect_tx(b_full + 8 * bs, Cfg::kBBytes);
          sm90::tma_load_2d(base + Cfg::kOffB + bs * Cfg::kBBytes, tw, b_full + 8 * bs, ks * kBK,
                            n0);
        }
      }
    }
  } else {
    // A consumer warpgroup: rows [64 wg, 64 wg + 64) of each tile, its
    // columns as kHalves accumulators of 128.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int row = 64 * wg + 16 * warp + lane / 4;  // of fragment registers 4 kk and 4 kk + 2
    uint8_t* stage_out = smem + Cfg::kOffOut + wg * kOutBytes;
    float* scales = reinterpret_cast<float*>(smem + Cfg::kOffScales) + wg * 2 * kBN;  // then bias
    int32_t acc[kHalves][64];
    uint32_t frag0[16] = {}, frag1[16] = {};
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / tiles_n * kBM, n0 = t % tiles_n * kBN;
      // This tile's out_scale and bias, columns tid + 128 j: loaded now, so
      // that the mainloop hides their latency, and staged for the epilogue.
      float tile_scale[kHalves], tile_bias[kHalves];
#pragma unroll
      for (int j = 0; j < kHalves; ++j) {
        const int col = n0 + tid + 128 * j;
        tile_scale[j] = col < n ? __ldg(out_scale + col) : 0.0f;
        tile_bias[j] = col < n && bias != nullptr ? __ldg(bias + col) : 0.0f;
      }
      int prev = -1;  // the weight stage of the group still in flight
      for (int ks = 0; ks < k_steps; ++ks, ++it) {
        const int xs = it % kXStages, bs = it % kBStages;
        sm90::mbar_wait(x_full + 8 * xs, (it / kXStages) & 1);
        const uint8_t* x_tile = smem + xs * kXBytes;
        const uint32_t b_tile = base + Cfg::kOffB + bs * Cfg::kBBytes;
        const uint32_t b_parity = (it / kBStages) & 1;
        if (ks % 2 == 0) {
          consumer_step<kHalves>(acc, frag0, frag1, x_tile, x_empty + 8 * xs, b_tile,
                                 b_full + 8 * bs, b_parity, row, lane, qmul, ks * kBK, k, ks == 0);
        } else {
          consumer_step<kHalves>(acc, frag1, frag0, x_tile, x_empty + 8 * xs, b_tile,
                                 b_full + 8 * bs, b_parity, row, lane, qmul, ks * kBK, k, false);
        }
        if (prev >= 0 && lane == 0) sm90::mbar_arrive(b_empty + 8 * prev);
        prev = bs;
      }
      sm90::wgmma_wait_all();
#pragma unroll
      for (int h = 0; h < kHalves; ++h) sm90::fence_regs(acc[h]);
      sm90::fence_regs(frag0);
      sm90::fence_regs(frag1);
      if (lane == 0) sm90::mbar_arrive(b_empty + 8 * prev);
#pragma unroll
      for (int j = 0; j < kHalves; ++j) {
        scales[tid + 128 * j] = tile_scale[j];
        scales[kBN + tid + 128 * j] = tile_bias[j];
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

      // Epilogue, 64 columns at a time: rescale, cast, stage the 64 x 64
      // bf16 slice (rows of 128 bytes, 16-byte chunks swizzled by row % 8),
      // then 16-byte stores. The accumulator fragment: warp w, lane l hold
      // acc[h][i] at row 16 w + l/4 + 8 ((i/2) % 2), column 128 h + 8 (i/4)
      // + 2 (l%4) + i%2.
      const int srow = warp * 16 + lane / 4;  // and srow + 8; both % 8 == lane / 4
      const bool vec = n % 8 == 0;            // rows of out are 16-byte aligned
#pragma unroll
      for (int s64 = 0; s64 < kBN / 64; ++s64) {
#pragma unroll
        for (int c8 = 0; c8 < 8; ++c8) {
          const int i0 = 4 * (8 * (s64 % 2) + c8);  // acc[s64 / 2][i0 + j]
          const int col = 64 * s64 + 8 * c8 + 2 * (lane % 4);  // within the tile
          const float2 sc = *reinterpret_cast<const float2*>(scales + col);
          const float2 bi = *reinterpret_cast<const float2*>(scales + kBN + col);
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[j] = __fmul_rn(__int2float_rn(acc[s64 / 2][i0 + j]), j % 2 ? sc.y : sc.x);
            if (bias != nullptr) v[j] = __fadd_rn(v[j], j % 2 ? bi.y : bi.x);
          }
          const int chunk = ((c8 ^ (lane / 4)) * 16) + 4 * (lane % 4);
          *reinterpret_cast<__nv_bfloat162*>(stage_out + srow * 128 + chunk) =
              __floats2bfloat162_rn(v[0], v[1]);
          *reinterpret_cast<__nv_bfloat162*>(stage_out + (srow + 8) * 128 + chunk) =
              __floats2bfloat162_rn(v[2], v[3]);
        }
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        const int cc = tid % 8;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tid / 8 + 16 * j;
          const int gm = m0 + 64 * wg + r, gn = n0 + 64 * s64 + 8 * cc;
          if (gm >= m || gn >= n) continue;
          const uint4 word =
              *reinterpret_cast<const uint4*>(stage_out + r * 128 + ((cc ^ (r % 8)) * 16));
          __nv_bfloat16* dst = out + static_cast<int64_t>(gm) * n + gn;
          if (vec) {
            *reinterpret_cast<uint4*>(dst) = word;
          } else {
            const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&word);
            for (int i = 0; i < 8 && gn + i < n; ++i) dst[i] = e[i];
          }
        }
        // the staging tile (and, after the last slice, the scales) free again
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int BN>
int launch_tiles(const CUtensorMap& tx, sm90::EncodeTiledFn encode, const void* wq,
                 const void* qmul, const void* out_scale, const void* bias, void* out, int m,
                 int n, int k, int sms, cudaStream_t stream) {
  using Cfg = Config<BN>;
  CUtensorMap tw;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {kBK, BN};
  const cuuint32_t steps[2] = {1, 1};
  if (encode(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wq), dims, strides, box,
             steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err =
      sm90::allow_smem(reinterpret_cast<const void*>(w8a8_kernel_sm90<Cfg>), Cfg::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (m + kBM - 1) / kBM * ((n + BN - 1) / BN);
  w8a8_kernel_sm90<Cfg><<<tiles < sms ? tiles : sms, kThreads, Cfg::kSmemBytes, stream>>>(
      tx, tw, static_cast<const float*>(qmul), static_cast<const float*>(out_scale),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

int launch_sm90(const void* x, const void* wq, const void* qmul, const void* out_scale,
                const void* bias, void* out, int m, int n, int k, int tile_n, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if ((tile_n != 128 && tile_n != 256) || k <= 0 || k % 16 != 0 || !aligned16(x) || !aligned16(wq) || !aligned16(qmul) ||
      !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const sm90::EncodeTiledFn encode = sm90::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tx;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t box[2] = {64, kBM};  // a half: under the 128-byte swizzle a box row is 128 bytes
  const cuuint32_t steps[2] = {1, 1};
  if (encode(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides, box,
             steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  const cudaError_t err = sm90::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tile_n == 256
             ? launch_tiles<256>(tx, encode, wq, qmul, out_scale, bias, out, m, n, k, sms, s)
             : launch_tiles<128>(tx, encode, wq, qmul, out_scale, bias, out, m, n, k, sms, s);
}

}  // namespace gemm

// --- fp32 x: the wmma kernel ----------------------------------------------------

using namespace nvcuda;

constexpr int kBM = 128;  // output rows per CTA
constexpr int kBN = 128;  // output columns per CTA
constexpr int kBK = 64;   // K per step
constexpr int kSlice = 16;  // K per wmma step, and the row length of a shared slice
constexpr int kSlices = kBK / kSlice;
constexpr int kWarpsM = 4;
constexpr int kWarpsN = 2;
constexpr int kThreads = kWarpsM * kWarpsN * 32;
constexpr int kWarpRows = kBM / kWarpsM;  // 32
constexpr int kWarpCols = kBN / kWarpsN;  // 64
constexpr int kFragM = kWarpRows / 16;    // 2
constexpr int kFragN = kWarpCols / 16;    // 4

__device__ __forceinline__ int8_t quantize(float x, float qmul) {
  const float r = rintf(__fmul_rn(x, qmul));
  return static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
}

// Shared tile of `rows` x kBK int8 values, stored as kSlices slices of
// (rows x 16): element (r, k) at slice k / 16, offset r * 16 + k % 16.
template <int Rows>
__device__ __forceinline__ int8_t* slot(int8_t* tile, int r, int k) {
  return tile + (k / kSlice) * Rows * kSlice + r * kSlice + (k % kSlice);
}

// A tile: rows [m0, m0 + kBM) and K columns [k0, k0 + kBK) of x, quantized.
template <bool Vec>
__device__ __forceinline__ void load_a(int8_t* a_s, const float* __restrict__ x,
                                       const float* __restrict__ qmul, int m, int k, int m0,
                                       int k0) {
  if constexpr (Vec) {
    constexpr int kVec = 4;  // elements per 16-byte load
    constexpr int kVecPerRow = kBK / kVec;
    for (int i = threadIdx.x; i < kBM * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * kVec;
      const int gm = m0 + r, gk = k0 + c;
      alignas(16) int8_t q[kVec];
      if (gm < m && gk < k) {  // K % 16 == 0: a vector lies wholly inside or outside
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + static_cast<int64_t>(gm) * k + gk));
        const float* v = reinterpret_cast<const float*>(&raw);
#pragma unroll
        for (int j = 0; j < kVec; j += 4) {
          const float4 s = __ldg(reinterpret_cast<const float4*>(qmul + gk + j));
          q[j + 0] = quantize(v[j + 0], s.x);
          q[j + 1] = quantize(v[j + 1], s.y);
          q[j + 2] = quantize(v[j + 2], s.z);
          q[j + 3] = quantize(v[j + 3], s.w);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) q[j] = 0;
      }
      int8_t* dst = slot<kBM>(a_s, r, c);  // kVec consecutive k inside one slice
      *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(q);
    }
  } else {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int gm = m0 + r, gk = k0 + c;
      int8_t q = 0;
      if (gm < m && gk < k) {
        q = quantize(x[static_cast<int64_t>(gm) * k + gk], __ldg(qmul + gk));
      }
      *slot<kBM>(a_s, r, c) = q;
    }
  }
}

// B tile: rows [n0, n0 + kBN) and K columns [k0, k0 + kBK) of weight_q.
template <bool Vec>
__device__ __forceinline__ void load_b(int8_t* b_s, const int8_t* __restrict__ wq, int n, int k,
                                       int n0, int k0) {
  if constexpr (Vec) {
    for (int i = threadIdx.x; i < kBN * kSlices; i += kThreads) {
      const int r = i / kSlices;
      const int c = (i % kSlices) * kSlice;
      const int gn = n0 + r, gk = k0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gn < n && gk < k) {
        v = __ldg(reinterpret_cast<const uint4*>(wq + static_cast<int64_t>(gn) * k + gk));
      }
      *reinterpret_cast<uint4*>(slot<kBN>(b_s, r, c)) = v;
    }
  } else {
    for (int i = threadIdx.x; i < kBN * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int gn = n0 + r, gk = k0 + c;
      *slot<kBN>(b_s, r, c) = (gn < n && gk < k) ? wq[static_cast<int64_t>(gn) * k + gk] : 0;
    }
  }
}

template <bool Vec>
__global__ void __launch_bounds__(kThreads)
    w8a8_kernel_f32(const float* __restrict__ x, const int8_t* __restrict__ wq,
                const float* __restrict__ qmul, const float* __restrict__ out_scale,
                const float* __restrict__ bias, float* __restrict__ out, int m, int n, int k) {
  __shared__ __align__(128) int8_t a_s[kBM * kBK];
  __shared__ __align__(128) int8_t b_s[kBN * kBK];
  __shared__ __align__(128) int c_s[kThreads / 32][16 * 16];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[kFragM][kFragN];
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < k; k0 += kBK) {
    load_a<Vec>(a_s, x, qmul, m, k, m0, k0);
    load_b<Vec>(b_s, wq, n, k, n0, k0);
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kSlices; ++s) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b[kFragN];
#pragma unroll
      for (int i = 0; i < kFragM; ++i) {
        wmma::load_matrix_sync(a[i], slot<kBM>(a_s, wm * kWarpRows + i * 16, s * kSlice), kSlice);
      }
#pragma unroll
      for (int j = 0; j < kFragN; ++j) {
        // weight_q^T as a col-major (K x N) matrix: element (k, c) at c * 16 + k
        wmma::load_matrix_sync(b[j], slot<kBN>(b_s, wn * kWarpCols + j * 16, s * kSlice), kSlice);
      }
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
#pragma unroll
        for (int j = 0; j < kFragN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  int* scratch = c_s[warp];
#pragma unroll
  for (int i = 0; i < kFragM; ++i) {
#pragma unroll
    for (int j = 0; j < kFragN; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row0 = m0 + wm * kWarpRows + i * 16;
      const int col0 = n0 + wn * kWarpCols + j * 16;
#pragma unroll
      for (int e = lane; e < 256; e += 32) {
        const int gm = row0 + e / 16, gn = col0 + e % 16;
        if (gm < m && gn < n) {
          float v = __fmul_rn(__int2float_rn(scratch[e]), __ldg(out_scale + gn));
          if (bias != nullptr) v = __fadd_rn(v, __ldg(bias + gn));
          out[static_cast<int64_t>(gm) * n + gn] = v;
        }
      }
      __syncwarp();
    }
  }
}

int launch_w8a8_f32(const void* x, const void* wq, const void* qmul, const void* out_scale,
                const void* bias, void* out, int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  const bool vec = k % 16 == 0 && gemm::aligned16(x) && gemm::aligned16(wq) && gemm::aligned16(qmul);
  auto kernel = vec ? &w8a8_kernel_f32<true> : &w8a8_kernel_f32<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(wq), static_cast<const float*>(qmul),
      static_cast<const float*>(out_scale), static_cast<const float*>(bias), static_cast<float*>(out),
      m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (m, k) contiguous, bf16 or fp32; weight_q: (n, k) int8 contiguous;
// qmul: (k,), out_scale: (n,), bias: (n,) or null, all fp32; out: (m, n)
// contiguous, the type of x. bf16 takes k > 0, k % 16 == 0 and 16-byte aligned x,
// weight_q, qmul and out. tile_n: the bf16 kernel's output tile width, 128 or
// 256 (ops/cuda/autotune.py picks it: by the waves rule unless a tuned entry
// says otherwise); the fp32 entry takes 128, its one width. Launches on
// `stream`, allocates nothing, does not synchronise. Returns the cudaError_t
// of the launch (0 on success).
int mdet_w8a8_matmul_bf16(const void* x, const void* weight_q, const void* qmul,
                          const void* out_scale, const void* bias, void* out, int m, int n, int k,
                          int tile_n, void* stream) {
  return gemm::launch_sm90(x, weight_q, qmul, out_scale, bias, out, m, n, k, tile_n, stream);
}

int mdet_w8a8_matmul_f32(const void* x, const void* weight_q, const void* qmul,
                         const void* out_scale, const void* bias, void* out, int m, int n, int k,
                         int tile_n, void* stream) {
  if (tile_n != kBN) return static_cast<int>(cudaErrorInvalidValue);
  return launch_w8a8_f32(x, weight_q, qmul, out_scale, bias, out, m, n, k, stream);
}

}  // extern "C"
