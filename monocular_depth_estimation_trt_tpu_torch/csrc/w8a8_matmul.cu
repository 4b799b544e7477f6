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
// step is an explicit round-to-nearest intrinsic (__fmul_rn, rintf, which
// rounds half to even like jnp.round, __int2float_rn, __fadd_rn,
// __float2bfloat16_rn), so nvcc cannot contract the rescale and the bias
// into one FMA and move the result by an ulp.
//
// What bounds it on the H100: 2*M*K*N int8 operations at 1979 TOP/s
// against M*K*itemsize + N*K + M*N*itemsize bytes at 3.35 TB/s. At every
// ViT shape of the paths (M = 577 to 20,195, K and N of 1024 to 4096) the
// operations dominate: 4.4 us of operations against 2.2 us of bytes for
// ViT-L's qkv at M = 1370.
//
// Design. One CTA of 8 warps per 128 x 128 output tile walks K in steps of
// 64. The A-tile load fuses the quantize step: x is read (16-byte vectors
// where K % 16 == 0 and the operands are 16-byte aligned, else one element
// at a time), multiplied by qmul, rounded, clamped and stored to shared
// memory as int8; the quantized activation never reaches device memory.
// The B tile is copied as int8. The product runs on the int8 tensor cores
// through nvcuda::wmma (m16n16k16, signed char, int32 accumulators); each
// warp owns a 32 x 64 block of the tile. Shared tiles are kept as four
// 16-wide K slices, each (rows x 16) contiguous, so that every fragment
// starts on a 32-byte boundary. Rows and columns past M and N and the K
// tail are zero-filled in shared memory; nothing is padded in memory. The
// epilogue stages each 16 x 16 accumulator through a per-warp shared
// scratch and writes the rescaled output.
//
// Left on the table (later work): no wgmma, no TMA, no cp.async double
// buffering, no warp specialisation; the output tile is not staged for
// 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

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

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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
template <typename T, bool Vec>
__device__ __forceinline__ void load_a(int8_t* a_s, const T* __restrict__ x,
                                       const float* __restrict__ qmul, int m, int k, int m0,
                                       int k0) {
  if constexpr (Vec) {
    constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
    constexpr int kVecPerRow = kBK / kVec;
    for (int i = threadIdx.x; i < kBM * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * kVec;
      const int gm = m0 + r, gk = k0 + c;
      alignas(16) int8_t q[kVec];
      if (gm < m && gk < k) {  // K % 16 == 0: a vector lies wholly inside or outside
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + static_cast<int64_t>(gm) * k + gk));
        const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < kVec; j += 4) {
          const float4 s = __ldg(reinterpret_cast<const float4*>(qmul + gk + j));
          q[j + 0] = quantize(to_float<T>(v[j + 0]), s.x);
          q[j + 1] = quantize(to_float<T>(v[j + 1]), s.y);
          q[j + 2] = quantize(to_float<T>(v[j + 2]), s.z);
          q[j + 3] = quantize(to_float<T>(v[j + 3]), s.w);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) q[j] = 0;
      }
      int8_t* dst = slot<kBM>(a_s, r, c);  // kVec consecutive k inside one slice
      if constexpr (kVec == 8) {
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(q);
      } else {
        *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(q);
      }
    }
  } else {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int gm = m0 + r, gk = k0 + c;
      int8_t q = 0;
      if (gm < m && gk < k) {
        q = quantize(to_float<T>(x[static_cast<int64_t>(gm) * k + gk]), __ldg(qmul + gk));
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

template <typename T, bool Vec>
__global__ void __launch_bounds__(kThreads)
    w8a8_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                const float* __restrict__ qmul, const float* __restrict__ out_scale,
                const float* __restrict__ bias, T* __restrict__ out, int m, int n, int k) {
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
    load_a<T, Vec>(a_s, x, qmul, m, k, m0, k0);
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
          out[static_cast<int64_t>(gm) * n + gn] = from_float<T>(v);
        }
      }
      __syncwarp();
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch_w8a8(const void* x, const void* wq, const void* qmul, const void* out_scale,
                const void* bias, void* out, int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  const bool vec = k % 16 == 0 && aligned16(x) && aligned16(wq) && aligned16(qmul);
  auto kernel = vec ? &w8a8_kernel<T, true> : &w8a8_kernel<T, false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(wq), static_cast<const float*>(qmul),
      static_cast<const float*>(out_scale), static_cast<const float*>(bias), static_cast<T*>(out),
      m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (m, k) contiguous, bf16 or fp32; weight_q: (n, k) int8 contiguous;
// qmul: (k,), out_scale: (n,), bias: (n,) or null, all fp32; out: (m, n)
// contiguous, the type of x. Launches on `stream`, allocates nothing, does
// not synchronise. Returns the cudaError_t of the launch (0 on success).
int mdet_w8a8_matmul_bf16(const void* x, const void* weight_q, const void* qmul,
                          const void* out_scale, const void* bias, void* out, int m, int n, int k,
                          void* stream) {
  return launch_w8a8<__nv_bfloat16>(x, weight_q, qmul, out_scale, bias, out, m, n, k, stream);
}

int mdet_w8a8_matmul_f32(const void* x, const void* weight_q, const void* qmul,
                         const void* out_scale, const void* bias, void* out, int m, int n, int k,
                         void* stream) {
  return launch_w8a8<float>(x, weight_q, qmul, out_scale, bias, out, m, n, k, stream);
}

}  // extern "C"
