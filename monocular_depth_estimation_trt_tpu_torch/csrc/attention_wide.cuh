// Attention at head widths above 128 for kernels K2 (flash_attention.cu) and
// K3 (flash_attention_batched.cu), fp32 only (precision="fp32"). The bf16
// forms of those heads run the wide form of the Hopper mainloop
// (attention_sm90.cuh, attention_wide).
//
// Replaces the fp32 form of the part of the TPU entry
//   monocular_depth_estimation_trt_tpu/ops/pallas/flash_attention.py::flash_attention
// that pads a head wider than 128 to a multiple of 128 (d_pad) and computes
// it on _attn_kernel / _attn_kernel_batched. The wrapper zero-pads d to that
// multiple here too; this loop takes any multiple of 128.
//
// Numerics: scores, softmax and both products in fp32 (P is never rounded),
// keys >= N masked to -inf, an online softmax (running row max and sum, O
// rescaled per key tile), the division by the row sum once at the end.
//
// What bounds it: no model of the zoo has such a head, so this loop is
// written to be simple and right, not fast. It does 4*B*H*N^2*d operations
// on the fp32 pipes (67 TFLOP/s), plus the scores recomputed once per output
// chunk; split TF32 on the tensor cores (attention_sm90_f32.cuh, 3 x ops at
// 495 TFLOP/s) would bound it lower, and is the next step for these heads.
//
// Design: one CTA of 128 threads per (16 query rows, head, 128-column chunk
// of the output, batch item); grid (ceil(N/16), H * d/128, B). A key tile
// is 64 keys: S (16 x 64) accumulates over the head in 128-column chunks of
// Q and K staged in shared memory; then the online softmax; then the V tile
// of this CTA's output chunk and O += P.V. Thread t owns query row t / 8,
// the keys and the output columns t % 8 + 8 i, and keeps its row's max,
// sum and 16 output columns in registers; the 8 threads of a row reduce
// with shuffles. Rows and keys past N are zero-filled in shared memory and
// masked; nothing is padded in memory.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace wide {

constexpr int kRows = 16;         // query rows per CTA
constexpr int kKeys = 64;         // keys per K/V tile
constexpr int kChunk = 128;       // head columns per chunk
constexpr int kThreads = 128;
constexpr int kLanesPerRow = kThreads / kRows;   // 8
constexpr int kKeysPerThread = kKeys / kLanesPerRow;   // 8
constexpr int kColsPerThread = kChunk / kLanesPerRow;  // 16
constexpr int kLd = kChunk + 4;   // row stride (floats) of the Q, K and V tiles
constexpr int kLdS = kKeys + 1;   // row stride (floats) of P

// K2's and K3's C entries: 12 element strides, (batch, head, token) of q,
// k, v, then o; head_dim (a multiple of 128) has stride 1.
struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int64_t s[12];
  int n;
  int d;
  float scale;
};

// Columns [c0, c0 + 128) of tokens [row0, row0 + rows) of one head into a
// shared tile; tokens >= n become zeros.
__device__ __forceinline__ void load_chunk(float* dst, const float* src, int64_t row_stride,
                                           int row0, int rows, int n, int c0) {
  for (int i = threadIdx.x; i < rows * kChunk; i += kThreads) {
    const int r = i / kChunk;
    const int c = i % kChunk;
    float x = 0.0f;
    if (row0 + r < n) x = src[static_cast<int64_t>(row0 + r) * row_stride + c0 + c];
    dst[r * kLd + c] = x;
  }
}

// The body of a kernel (each of K2 and K3 wraps it in a __global__ of its
// own name): grid (ceil(n / 16), heads * d / 128, batch), kThreads threads.
__device__ __forceinline__ void attention(const Args& a) {
  __shared__ __align__(16) float q_s[kRows * kLd];
  __shared__ __align__(16) float kv_s[kKeys * kLd];  // a K chunk, then the V chunk
  __shared__ float p_s[kRows * kLdS];

  const int chunks = a.d / kChunk;
  const int n = a.n;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y / chunks;
  const int oc = (blockIdx.y % chunks) * kChunk;  // first output column of this CTA
  const int64_t b = blockIdx.z;
  const float* q = a.q + b * a.s[0] + h * a.s[1];
  const float* k = a.k + b * a.s[3] + h * a.s[4];
  const float* v = a.v + b * a.s[6] + h * a.s[7];
  const int r = threadIdx.x / kLanesPerRow;
  const int j0 = threadIdx.x % kLanesPerRow;

  float m = -INFINITY, l = 0.0f;
  float acc[kColsPerThread];
#pragma unroll
  for (int i = 0; i < kColsPerThread; ++i) acc[i] = 0.0f;

  for (int k0 = 0; k0 < n; k0 += kKeys) {
    float s[kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) s[i] = 0.0f;
    for (int c0 = 0; c0 < a.d; c0 += kChunk) {
      __syncthreads();  // every thread is done with the previous tiles
      load_chunk(q_s, q, a.s[2], q0, kRows, n, c0);
      load_chunk(kv_s, k, a.s[5], k0, kKeys, n, c0);
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kChunk; ++c) {
        const float qv = q_s[r * kLd + c];
#pragma unroll
        for (int i = 0; i < kKeysPerThread; ++i) {
          s[i] = fmaf(qv, kv_s[(j0 + kLanesPerRow * i) * kLd + c], s[i]);
        }
      }
    }

    // online softmax over the row's 64 keys, held by its 8 threads
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      s[i] = (k0 + j0 + kLanesPerRow * i < n) ? s[i] * a.scale : -INFINITY;
      mx = fmaxf(mx, s[i]);
    }
#pragma unroll
    for (int off = kLanesPerRow / 2; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    const float m_new = fmaxf(m, mx);  // finite: key k0 is always valid
    const float alpha = expf(m - m_new);  // 0 on the first tile
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const float p = expf(s[i] - m_new);
      sum += p;
      p_s[r * kLdS + j0 + kLanesPerRow * i] = p;
    }
#pragma unroll
    for (int off = kLanesPerRow / 2; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    l = l * alpha + sum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < kColsPerThread; ++i) acc[i] *= alpha;

    __syncthreads();  // P is written; every thread is done with the K chunk
    load_chunk(kv_s, v, a.s[8], k0, kKeys, n, oc);
    __syncthreads();
    for (int key = 0; key < kKeys; ++key) {
      const float p = p_s[r * kLdS + key];
#pragma unroll
      for (int i = 0; i < kColsPerThread; ++i) {
        acc[i] = fmaf(p, kv_s[key * kLd + j0 + kLanesPerRow * i], acc[i]);
      }
    }
  }

  const int row = q0 + r;
  if (row < n) {
    float* dst = a.o + b * a.s[9] + h * a.s[10] + static_cast<int64_t>(row) * a.s[11] + oc;
    const float inv = 1.0f / l;
#pragma unroll
    for (int i = 0; i < kColsPerThread; ++i) {
      dst[j0 + kLanesPerRow * i] = acc[i] * inv;
    }
  }
}

inline Args make_args(const void* q, const void* k, const void* v, void* o, const int64_t* strides,
                      int n, int d, float scale) {
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(o);
  for (int i = 0; i < 12; ++i) a.s[i] = strides[i];
  a.n = n;
  a.d = d;
  a.scale = scale;
  return a;
}

// Launches `kernel` (a __global__ wrapper of attention) on `stream`;
// returns the cudaError_t of the launch (0 on success).
inline int launch(void (*kernel)(const Args), const void* q, const void* k, const void* v, void* o,
                  const int64_t* strides, int batch, int heads, int n, int head_dim, float scale,
                  void* stream) {
  if (head_dim <= 0 || head_dim % kChunk || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kRows - 1) / kRows, heads * (head_dim / kChunk), batch);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      make_args(q, k, v, o, strides, n, head_dim, scale));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wide
