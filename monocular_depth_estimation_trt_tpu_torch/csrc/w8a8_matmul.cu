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
// step is an explicit round-to-nearest intrinsic (__fmul_rn, an add that
// rounds half to even like jnp.round, __int2float_rn, __fadd_rn,
// __float2bfloat16_rn), so nvcc cannot contract the rescale and the bias
// into one FMA and move the result by an ulp. Clamping before or after the
// rounding gives the same integer, since +-127 are integers.
//
// What bounds it on the H100: 2*M*K*N int8 operations at 1979 TOP/s
// against M*K*itemsize + N*K + M*N*itemsize bytes at 3.35 TB/s. In bf16 the
// operations dominate at every ViT shape of the paths (M = 577 to 20,195, K
// and N of 1024 to 4096): 4.4 us of operations against 2.2 us of bytes for
// ViT-L's qkv at M = 1370. In fp32 the bytes do at every such shape: the
// fp32 output is most of them (331 of 418 MB at Depth Pro's fc1).
//
// Design, for both types: a persistent, warp-specialised TMA + wgmma GEMM.
// One CTA an SM walks the 128 x BN output tiles (tile t, t + gridDim.x, ...;
// n fastest, so that consecutive tiles share x rows and the weight stays in
// L2), with three warpgroups. bf16 takes BN = 128 or 256 as the caller asks
// (by default 256 where that leaves no more SMs idle than 128 would by a
// wave: the waves rule of ops/cuda/autotune.py, whose tuner may measure the
// other); fp32 takes BN = 128 alone, as at 256 ptxas serializes its wgmma
// chain (warning C7512) within the 168 registers a thread of this 384-thread
// CTA gets, whatever setmaxnreg gives the consumers afterwards (PERF.md):
// * a producer, two of whose threads issue the TMA loads of each K step,
//   each into a ring of its own behind full and empty mbarriers: the x tile
//   (128 rows as two boxes of 128-byte rows under the 128-byte swizzle: in
//   bf16 a K step of 128, each box 64 columns; in fp32 a K step of 64, each
//   box 32 columns; 32 KB either way) and the int8 weight tile (BN rows of
//   one K step: 128 bytes under the 128-byte swizzle in bf16, 64 bytes under
//   the 64-byte swizzle in fp32). An x stage is free again once quantized, a
//   weight stage once its wgmmas are done. TMA zero-fills rows past M and N
//   and the K tail, and zero times anything is zero, so the sum stays exact
//   and nothing is padded in memory;
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
//   latency hides behind the mainloop) and stages the output in slices of
//   64 rows x 128 bytes in shared memory, while the producer already fills
//   the next tile's stages. bf16 writes each 64-column slice with 16-byte
//   stores. fp32 stages 32-column slices in two buffers, and one thread
//   writes each with a TMA store, which drains while the next slice is
//   staged and the next tile's K steps run; where no tensor map can describe
//   the output rows (N % 4 != 0) every thread stores its elements instead.
// The quantize runs in the consumers because it is what bounds the bf16
// kernel: a warpgroup of its own writing an int8 A tile for SS wgmmas
// measured up to 1.4x slower, and the consumers' quantize still sets most
// of the time above the TMA pipeline's (PERF.md). The fp32 x tile costs
// twice the bytes of a bf16 one per K column, hence its K step of 64.
// The C entries take K % 16 == 0 and 16-byte aligned x, weight and qmul
// (the strides of the TMA maps, the float4 loads of qmul); the wrapper
// zero-pads K where it is not.
//
// Left on the table (later work): a cheaper quantize (bf16: its unpack,
// clamp and pack run on the half-rate ALU pipe), split-K or narrower tiles
// where M x N gives fewer tiles than SMs (proj and fc2 at M = 1370: 88 tiles
// of 128 columns for 132 SMs), an epilogue that overlaps the next tile's
// wgmmas (two consumers taking tiles in turn), TMA stores of the bf16
// output, and a cluster of two CTAs sharing one x tile by TMA multicast,
// which would halve the fp32 x reads from L2.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_common.cuh"

namespace {
namespace gemm {

constexpr int kBM = 128;       // output rows per tile: two consumer warpgroups of 64
constexpr int kThreads = 384;  // consumers (warpgroups 0 and 1), producer (2)
// setmaxnreg: the launch gives every thread 168 registers (65536 / 384,
// rounded down to a multiple of 8); the producer drops to 24 and the
// consumers, which hold up to 128 accumulators and two A fragments of up to
// 16 registers a thread, rise to 240.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr uint32_t kXBox = kBM * 128;     // one x box: 128 rows of 128 bytes, 16 KB
constexpr uint32_t kOutBytes = 64 * 128;  // a consumer's staging slice: 64 rows of 128 bytes

// One instantiation: the type X of x and of the output, BN output columns
// per tile, the K step, and the stages of the x ring and of the weight ring
// that fit beside the staging slices.
template <typename X, int BN>
struct Config {
  static_assert(BN == 128 || BN == 256, "128- or 256-column tiles");
  using Type = X;
  static constexpr bool kF32 = std::is_same<X, float>::value;
  static constexpr int kBN = BN;
  static constexpr int kHalves = BN / 128;  // m64n128k32 wgmmas per k32 step and warpgroup
  static constexpr int kBK = kF32 ? 64 : 128;                 // K per step
  static constexpr int kBoxCols = 128 / static_cast<int>(sizeof(X));  // x columns per box
  static constexpr int kSteps32 = kBK / 32;                   // k32 steps per K step
  static constexpr int kFrags = 4 * kSteps32;                 // A fragment registers per step
  static constexpr uint32_t kXBytes = kBM * kBK * sizeof(X);  // 32 KB: two boxes
  static constexpr int kXStages = BN == 128 ? 4 : 3;
  static constexpr int kBStages = BN == 128 ? 4 : 3;
  static constexpr uint32_t kBBytes = BN * kBK;  // int8 weight tile: 8, 16 or 32 KB
  static constexpr int kOutSlices = kF32 ? 2 : 1;  // staging slices per consumer
  // Shared memory from a 1024-byte aligned base: the x tiles, the weight
  // tiles, the staging slices, each consumer's copy of the tile's out_scale
  // and bias (BN floats each), then the mbarriers x_full[kXStages],
  // x_empty[kXStages], b_full[kBStages], b_empty[kBStages].
  static constexpr uint32_t kOffB = kXStages * kXBytes;
  static constexpr uint32_t kOffOut = kOffB + kBStages * kBBytes;
  static constexpr uint32_t kOffScales = kOffOut + 2 * kOutSlices * kOutBytes;
  static constexpr uint32_t kOffBar = kOffScales + 2 * 2 * BN * 4;
  static constexpr uint32_t kSmemBytes = kOffBar + 8 * 2 * (kXStages + kBStages) + 1024;
  static_assert(kXBytes == 2 * kXBox, "an x stage is two boxes");
  static_assert(kSmemBytes <= 232448, "one CTA must fit 227 KB of shared memory");

  // The weight tile's descriptor at byte `offset` (a k32 step) of the
  // 128-row half h.
  static __device__ __forceinline__ uint64_t b_desc(uint32_t b_tile, int h, int offset) {
    const uint32_t addr = b_tile + h * 128 * kBK + offset;
    return kF32 ? sm90::smem_desc_sw64(addr) : sm90::smem_desc(addr, 16);
  }
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

__device__ __forceinline__ void bar_warpgroup(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
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

// Four int8 (the low bytes of a, b, c, d) packed little-endian into one register.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// Four bf16 (one 8-byte word) of x times their qmul, as four packed int8.
__device__ __forceinline__ uint32_t quantize4(uint2 x, float4 q) {
  return pack4(quantize(bf16_lo(x.x), q.x), quantize(bf16_hi(x.x), q.y),
               quantize(bf16_lo(x.y), q.z), quantize(bf16_hi(x.y), q.w));
}

// Four fp32 (one 16-byte chunk) of x times their qmul, as four packed int8.
__device__ __forceinline__ uint32_t quantize4(float4 x, float4 q) {
  return pack4(quantize(x.x, q.x), quantize(x.y, q.y), quantize(x.z, q.z), quantize(x.w, q.w));
}

// qmul of columns col .. col + 3, zero at or past k.
__device__ __forceinline__ float4 qmul4(const float* __restrict__ qmul, int col, int k) {
  return col < k ? __ldg(reinterpret_cast<const float4*>(qmul + col))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// This thread's A fragments of one K step, quantized from the landed x tile
// (two boxes, each 128 rows of 128 bytes under the 128-byte swizzle: 16-byte
// chunk j of row r at chunk j ^ (r % 8)). For the k32 step kk, registers
// 4 kk + i (i = 0, 1) hold row `row` + 8 i at columns 32 kk + 4 (lane % 4) +
// 0..3 and registers 4 kk + 2 + i the same rows 16 columns on: the wgmma A
// fragment, row = 16 w + lane / 4 within the warpgroup's 64 for warp w, so
// row % 8 = lane / 4. Columns at or past k read a zero qmul (x is
// zero-filled there; k % 16 == 0 keeps each group of four whole).
// bf16: a box holds 64 columns, two k32 steps; each group of four is an
// 8-byte word.
__device__ __forceinline__ void quantize_fragments(uint32_t (&a)[16], const uint8_t* x_tile,
                                                   int row, int lane,
                                                   const float* __restrict__ qmul, int k0,
                                                   int k) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint8_t* half = x_tile + (kk / 2) * kXBox + 8 * (t % 2);
    const int chunk = 4 * (kk % 2) + t / 2;  // columns 32 kk + 4 t .. + 3 within the half
    const int col = k0 + 32 * kk + 4 * t;
    const float4 q_lo = qmul4(qmul, col, k), q_hi = qmul4(qmul, col + 16, k);
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

// fp32: box kk holds the 32 columns of k32 step kk, each group of four a
// 16-byte chunk (t and 4 + t for the two halves of the fragment). A lane of
// an odd row group (lane / 4) reads its chunk 4 + t first, so that each
// quarter warp's 16-byte loads meet the 32 banks once.
__device__ __forceinline__ void quantize_fragments(uint32_t (&a)[8], const uint8_t* x_tile,
                                                   int row, int lane,
                                                   const float* __restrict__ qmul, int k0,
                                                   int k) {
  const int g = lane / 4, t = lane % 4;
  const int swap = g & 1;  // 1: the high chunk first
  const int first = ((t + 4 * swap) ^ g) * 16, second = first ^ 64;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const uint8_t* box = x_tile + kk * kXBox;
    const int col = k0 + 32 * kk + 4 * t + 16 * swap;  // the first chunk's columns
    const float4 q_first = qmul4(qmul, col, k), q_second = qmul4(qmul, col + 16 - 32 * swap, k);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint8_t* r = box + (row + 8 * i) * 128;
      const uint32_t p = quantize4(*reinterpret_cast<const float4*>(r + first), q_first);
      const uint32_t s = quantize4(*reinterpret_cast<const float4*>(r + second), q_second);
      a[4 * kk + i] = swap ? s : p;
      a[4 * kk + 2 + i] = swap ? p : s;
    }
  }
}

// One K step of a consumer warpgroup: quantize the landed x tile into
// `cur` while the previous step's wgmmas, which read `prev`, are in flight,
// and release the x stage at once (its values are in registers now); wait
// for the weight tile and issue this step's wgmmas; then wait for the
// previous step's group, so that its weight stage and `prev` are free again
// (fence_regs keeps each fragment's registers untouched until that wait).
template <typename Cfg>
__device__ __forceinline__ void consumer_step(int32_t (&acc)[Cfg::kHalves][64],
                                              uint32_t (&cur)[Cfg::kFrags],
                                              uint32_t (&prev)[Cfg::kFrags], const uint8_t* x_tile,
                                              uint32_t x_empty, uint32_t b_tile, uint32_t b_full,
                                              uint32_t b_parity, int row, int lane,
                                              const float* __restrict__ qmul, int k0, int k,
                                              bool first) {
  quantize_fragments(cur, x_tile, row, lane, qmul, k0, k);
  __syncwarp();
  if (lane == 0) sm90::mbar_arrive(x_empty);
  sm90::mbar_wait(b_full, b_parity);
#pragma unroll
  for (int h = 0; h < Cfg::kHalves; ++h) sm90::fence_regs(acc[h]);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Cfg::kSteps32; ++kk) {
#pragma unroll
    for (int h = 0; h < Cfg::kHalves; ++h) {
      wgmma_m64n128k32_s8_rs(acc[h], cur[4 * kk], cur[4 * kk + 1], cur[4 * kk + 2],
                             cur[4 * kk + 3], Cfg::b_desc(b_tile, h, 32 * kk), !first || kk > 0);
    }
  }
  sm90::wgmma_commit();
  wgmma_wait_one();
#pragma unroll
  for (int h = 0; h < Cfg::kHalves; ++h) sm90::fence_regs(acc[h]);
  sm90::fence_regs(prev);
}

// The accumulator fragment: warp w, lane l hold acc[h][i] at row 16 w + l/4
// + 8 ((i/2) % 2), column 128 h + 8 (i/4) + 2 (l%4) + i%2. rescale gives the
// four values at acc[h][i0 .. i0 + 3], columns `col` and `col` + 1 (within
// the tile) of the upper row, then the same of the lower.
template <int Halves>
__device__ __forceinline__ void rescale(float (&v)[4], const int32_t (&acc)[Halves][64], int h,
                                        int i0, const float* scales, int bn, int col,
                                        bool has_bias) {
  const float2 sc = *reinterpret_cast<const float2*>(scales + col);
  const float2 bi = *reinterpret_cast<const float2*>(scales + bn + col);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = __fmul_rn(__int2float_rn(acc[h][i0 + j]), j % 2 ? sc.y : sc.x);
    if (has_bias) v[j] = __fadd_rn(v[j], j % 2 ? bi.y : bi.x);
  }
}

// bf16 epilogue of a consumer warpgroup (rows m0 + 64 wg ..), 64 columns at
// a time: rescale, cast, stage the 64 x 64 bf16 slice (rows of 128 bytes,
// 16-byte chunks swizzled by row % 8), then 16-byte stores, clipping rows
// past M and columns past N.
template <typename Cfg>
__device__ __forceinline__ void store_tile(const int32_t (&acc)[Cfg::kHalves][64],
                                           const float* scales, uint8_t* stage_out, int wg,
                                           int tid, const CUtensorMap*, __nv_bfloat16* out, int m0,
                                           int n0, int m, int n, bool has_bias) {
  const int lane = tid % 32, warp = tid / 32;
  const int srow = warp * 16 + lane / 4;  // and srow + 8; both % 8 == lane / 4
  const bool vec = n % 8 == 0;            // rows of out are 16-byte aligned
#pragma unroll
  for (int s64 = 0; s64 < Cfg::kBN / 64; ++s64) {
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
      float v[4];
      rescale(v, acc, s64 / 2, 4 * (8 * (s64 % 2) + c8), scales, Cfg::kBN,
              64 * s64 + 8 * c8 + 2 * (lane % 4), has_bias);
      const int chunk = ((c8 ^ (lane / 4)) * 16) + 4 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(stage_out + srow * 128 + chunk) =
          __floats2bfloat162_rn(v[0], v[1]);
      *reinterpret_cast<__nv_bfloat162*>(stage_out + (srow + 8) * 128 + chunk) =
          __floats2bfloat162_rn(v[2], v[3]);
    }
    bar_warpgroup(wg);
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
    // the staging slice (and, after the last slice, the scales) free again
    bar_warpgroup(wg);
  }
}

// fp32 epilogue of a consumer warpgroup, 32 columns at a time: rescale,
// stage the 64 x 32 fp32 slice (rows of 128 bytes, 16-byte chunks swizzled
// by row % 8: the output map's 128-byte swizzle) in slice buffer s % 2, then
// the warpgroup's first thread stores it with TMA (the map `to`), which
// clips rows past M and columns past N. Before each barrier that thread
// waits until its previous store has read its buffer, so that the buffer
// the next slice is staged in is free: one barrier a slice. Without a map
// (N % 4 != 0) every thread stores its elements of the slice, and the
// barrier of the next slice frees the buffer.
template <typename Cfg>
__device__ __forceinline__ void store_tile(const int32_t (&acc)[Cfg::kHalves][64],
                                           const float* scales, uint8_t* stage_out, int wg,
                                           int tid, const CUtensorMap* to, float* out, int m0,
                                           int n0, int m, int n, bool has_bias) {
  const int lane = tid % 32, warp = tid / 32;
  const int srow = warp * 16 + lane / 4;  // and srow + 8; both % 8 == lane / 4
#pragma unroll
  for (int s = 0; s < Cfg::kBN / 32; ++s) {
    uint8_t* buf = stage_out + (s % 2) * kOutBytes;
#pragma unroll
    for (int c8 = 0; c8 < 4; ++c8) {
      float v[4];
      rescale(v, acc, s / 4, 4 * (4 * (s % 4) + c8), scales, Cfg::kBN,
              32 * s + 8 * c8 + 2 * (lane % 4), has_bias);
      const int chunk = (((2 * c8 + (lane % 4) / 2) ^ (lane / 4)) * 16) + 8 * (lane % 2);
      *reinterpret_cast<float2*>(buf + srow * 128 + chunk) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(buf + (srow + 8) * 128 + chunk) = make_float2(v[2], v[3]);
    }
    if (to != nullptr) {
      sm90::fence_proxy_async();  // this thread's staged values, visible to the TMA store
      if (tid == 0) sm90::tma_store_wait();
    }
    bar_warpgroup(wg);
    if (to != nullptr) {
      if (tid == 0) sm90::tma_store_2d(*to, sm90::smem_u32(buf), n0 + 32 * s, m0 + 64 * wg);
    } else {
      const int cc = tid % 8;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tid / 8 + 16 * j;
        const int gm = m0 + 64 * wg + r, gn = n0 + 32 * s + 4 * cc;
        if (gm >= m || gn >= n) continue;
        const float4 word =
            *reinterpret_cast<const float4*>(buf + r * 128 + ((cc ^ (r % 8)) * 16));
        const float e[4] = {word.x, word.y, word.z, word.w};
        float* dst = out + static_cast<int64_t>(gm) * n + gn;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (gn + i < n) dst[i] = e[i];
        }
      }
    }
  }
}

// The persistent kernel's body: gridDim.x CTAs of kThreads threads,
// Cfg::kSmemBytes of dynamic shared memory. tx: x (M, K); tw: int8 weight
// (N, K); to: the fp32 output's map, or null (bf16, or fp32 rows that no map
// describes). Step `it` of a CTA's walk (its tiles one after the other, K
// steps within each) uses x stage it % Cfg::kXStages and weight stage
// it % Cfg::kBStages.
template <typename Cfg>
__device__ __forceinline__ void gemm_body(const CUtensorMap& tx, const CUtensorMap& tw,
                                          const CUtensorMap* to, const float* __restrict__ qmul,
                                          const float* __restrict__ out_scale,
                                          const float* __restrict__ bias,
                                          typename Cfg::Type* __restrict__ out, int m, int n,
                                          int k) {
  constexpr int kBN = Cfg::kBN, kBK = Cfg::kBK, kXStages = Cfg::kXStages;
  constexpr int kBStages = Cfg::kBStages, kHalves = Cfg::kHalves;
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
          sm90::mbar_expect_tx(x_full + 8 * xs, Cfg::kXBytes);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            sm90::tma_load_2d(base + xs * Cfg::kXBytes + h * kXBox, tx, x_full + 8 * xs,
                              ks * kBK + Cfg::kBoxCols * h, m0);
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
    const int row = 64 * wg + 16 * (tid / 32) + lane / 4;  // of fragment registers 4 kk, 4 kk + 2
    uint8_t* stage_out = smem + Cfg::kOffOut + wg * Cfg::kOutSlices * kOutBytes;
    float* scales = reinterpret_cast<float*>(smem + Cfg::kOffScales) + wg * 2 * kBN;  // then bias
    int32_t acc[kHalves][64];
    uint32_t frag0[Cfg::kFrags] = {}, frag1[Cfg::kFrags] = {};
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
        const uint8_t* x_tile = smem + xs * Cfg::kXBytes;
        const uint32_t b_tile = base + Cfg::kOffB + bs * Cfg::kBBytes;
        const uint32_t b_parity = (it / kBStages) & 1;
        if (ks % 2 == 0) {
          consumer_step<Cfg>(acc, frag0, frag1, x_tile, x_empty + 8 * xs, b_tile, b_full + 8 * bs,
                             b_parity, row, lane, qmul, ks * kBK, k, ks == 0);
        } else {
          consumer_step<Cfg>(acc, frag1, frag0, x_tile, x_empty + 8 * xs, b_tile, b_full + 8 * bs,
                             b_parity, row, lane, qmul, ks * kBK, k, false);
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
      bar_warpgroup(wg);
      store_tile<Cfg>(acc, scales, stage_out, wg, tid, to, out, m0, n0, m, n, bias != nullptr);
    }
    if (to != nullptr && tid == 0) sm90::tma_store_wait();  // the staging read out before exit
  }
}

template <typename Cfg>
__global__ void __launch_bounds__(kThreads, 1)
    w8a8_kernel_sm90(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                     const float* __restrict__ qmul, const float* __restrict__ out_scale,
                     const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int m, int n,
                     int k) {
  gemm_body<Cfg>(tx, tw, nullptr, qmul, out_scale, bias, out, m, n, k);
}

// fp32: tma_out says whether `to` maps the output (N % 4 == 0).
template <typename Cfg>
__global__ void __launch_bounds__(kThreads, 1)
    w8a8_kernel_f32_sm90(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tw,
                         const __grid_constant__ CUtensorMap to, const float* __restrict__ qmul,
                         const float* __restrict__ out_scale, const float* __restrict__ bias,
                         float* __restrict__ out, int m, int n, int k, int tma_out) {
  gemm_body<Cfg>(tx, tw, tma_out ? &to : nullptr, qmul, out_scale, bias, out, m, n, k);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// A rank-2 map of a row-major (rows, cols) tensor, in boxes of (box_cols,
// box_rows).
bool encode_2d(sm90::EncodeTiledFn encode, CUtensorMap* map, CUtensorMapDataType type,
               const void* ptr, int cols, int rows, int elem_bytes, int box_cols, int box_rows,
               CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Cfg>
int launch_tiles(const CUtensorMap& tx, sm90::EncodeTiledFn encode, const void* wq,
                 const void* qmul, const void* out_scale, const void* bias, void* out, int m,
                 int n, int k, int sms, cudaStream_t stream) {
  constexpr int kBN = Cfg::kBN;
  CUtensorMap tw;
  if (!encode_2d(encode, &tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, k, n, 1, Cfg::kBK, kBN,
                 Cfg::kF32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (m + kBM - 1) / kBM * ((n + kBN - 1) / kBN);
  const int grid = tiles < sms ? tiles : sms;
  const float* q = static_cast<const float*>(qmul);
  const float* sc = static_cast<const float*>(out_scale);
  const float* bi = static_cast<const float*>(bias);
  cudaError_t err;
  if constexpr (Cfg::kF32) {
    // rows of a multiple of 16 bytes: TMA stores of 64 rows x 32 columns
    CUtensorMap to = {};
    const int tma_out = n % 4 == 0;
    if (tma_out && !encode_2d(encode, &to, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, out, n, m, 4, 32, 64,
                              CU_TENSOR_MAP_SWIZZLE_128B)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    err = sm90::allow_smem(reinterpret_cast<const void*>(w8a8_kernel_f32_sm90<Cfg>),
                           Cfg::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    w8a8_kernel_f32_sm90<Cfg><<<grid, kThreads, Cfg::kSmemBytes, stream>>>(
        tx, tw, to, q, sc, bi, static_cast<float*>(out), m, n, k, tma_out);
  } else {
    err = sm90::allow_smem(reinterpret_cast<const void*>(w8a8_kernel_sm90<Cfg>), Cfg::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    w8a8_kernel_sm90<Cfg><<<grid, kThreads, Cfg::kSmemBytes, stream>>>(
        tx, tw, q, sc, bi, static_cast<__nv_bfloat16*>(out), m, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename X>
int launch_sm90(const void* x, const void* wq, const void* qmul, const void* out_scale,
                const void* bias, void* out, int m, int n, int k, int tile_n, void* stream) {
  constexpr bool kF32 = std::is_same<X, float>::value;
  if (m <= 0 || n <= 0) return 0;
  if ((tile_n != 128 && (tile_n != 256 || kF32)) || k <= 0 || k % 16 != 0 || !aligned16(x) ||
      !aligned16(wq) || !aligned16(qmul) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const sm90::EncodeTiledFn encode = sm90::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // a box row is 128 bytes under the 128-byte swizzle: 64 bf16 or 32 fp32 columns
  CUtensorMap tx;
  if (!encode_2d(encode, &tx,
                 kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, k,
                 m, sizeof(X), 128 / sizeof(X), kBM, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  const cudaError_t err = sm90::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (!kF32) {
    if (tile_n == 256) {
      return launch_tiles<Config<X, 256>>(tx, encode, wq, qmul, out_scale, bias, out, m, n, k,
                                          sms, s);
    }
  }
  return launch_tiles<Config<X, 128>>(tx, encode, wq, qmul, out_scale, bias, out, m, n, k, sms,
                                      s);
}

}  // namespace gemm
}  // namespace

extern "C" {

// x: (m, k) contiguous, bf16 or fp32; weight_q: (n, k) int8 contiguous;
// qmul: (k,), out_scale: (n,), bias: (n,) or null, all fp32; out: (m, n)
// contiguous, the type of x. Both take k > 0, k % 16 == 0 and 16-byte
// aligned x, weight_q, qmul and out. tile_n: the output tile width, 128 or
// 256 in bf16 (ops/cuda/autotune.py picks it: by the waves rule unless a
// tuned entry says otherwise), 128 in fp32. Launches on `stream`, allocates
// nothing, does not synchronise. Returns the cudaError_t of the launch (0 on
// success).
int mdet_w8a8_matmul_bf16(const void* x, const void* weight_q, const void* qmul,
                          const void* out_scale, const void* bias, void* out, int m, int n, int k,
                          int tile_n, void* stream) {
  return gemm::launch_sm90<__nv_bfloat16>(x, weight_q, qmul, out_scale, bias, out, m, n, k,
                                          tile_n, stream);
}

int mdet_w8a8_matmul_f32(const void* x, const void* weight_q, const void* qmul,
                         const void* out_scale, const void* bias, void* out, int m, int n, int k,
                         int tile_n, void* stream) {
  return gemm::launch_sm90<float>(x, weight_q, qmul, out_scale, bias, out, m, n, k, tile_n,
                                  stream);
}

}  // extern "C"
