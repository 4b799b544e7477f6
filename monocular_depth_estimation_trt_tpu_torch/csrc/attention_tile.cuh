// The fp32 attention tile loop of kernels K1 (flash_attention_packed.cu) and
// K2 (flash_attention.cu) for precision="fp32": non-causal
// softmax(q k^T * scale) v for one head of head_dim D (64 or 128, a template
// parameter), with a unit stride along head_dim. The loop is a template on a
// layout that says where each head's rows of q, k, v and o are:
// PackedLayout (K1) derives every stride from H and D, as the packed qkv
// tensor and the proj input fix them; StridedLayout (K2) reads each
// operand's (batch, head, token) strides from the kernel's parameters. The
// bf16 K1 and K2 run the Hopper mainloop of attention_sm90.cuh instead.
//
// Numerics: scores, softmax and both products in fp32 FMAs (not TF32, which
// would round the operands), the division by the row sum once after P.V,
// key columns >= N masked to -inf.
//
// What bounds it on the H100: 4*B*H*N^2*D operations on the fp32 pipes (67
// TFLOP/s) against B*N*4*H*D*4 bytes; the operations dominate at every
// shape of the paths. fp32 serves parity, not speed.
//
// Design. K/V stream through shared memory in tiles of 64 keys with an
// online softmax (running row max and sum, the O accumulator rescaled per
// tile). One CTA of 4 warps per (64-row q tile, head, batch item); each warp
// owns 16 query rows end to end; a lane owns key columns lane and lane + 32
// of a score tile and output columns lane + 32 j of O. Rows and keys past N
// are zero-filled in shared memory and masked; nothing is padded in memory.
//
// Left on the table (later work): no TMA, no double-buffered K/V tiles; S
// and O round-trip through shared memory on every tile.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;     // query rows per CTA
constexpr int kBlockK = 64;     // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;  // 16
constexpr int kLdS = kBlockK + 4;               // row stride (floats) of S and P

// Row stride (floats) of the Q, K, V and O tiles: 16 bytes of padding per
// row spreads rows over the banks.
template <int D>
__host__ __device__ constexpr int tile_ld() { return D + 4; }

// A layout gives, for batch item b and head h, the first row of q, k, v and
// o of that head (q_ptr .. o_ptr) and the element stride between rows
// (q_row .. o_row); head_dim has stride 1. Every pointer and every row
// stride times 4 bytes is a multiple of 16 bytes (the wrappers check it), so
// rows load as 16-byte vectors.

// K1: q, k, v are the three H*D-wide regions of rows of the packed
// (B, N, 3*H*D) qkv tensor; o is the (B, N, H*D) proj input.
template <int D>
struct PackedLayout {
  static constexpr int kD = D;
  const float* qkv;
  float* out;
  int n;
  int heads;
  float scale;

  __device__ __forceinline__ int64_t hd() const { return static_cast<int64_t>(heads) * D; }
  __device__ __forceinline__ const float* q_ptr(int64_t b, int h) const {
    return qkv + b * n * 3 * hd() + h * D;
  }
  __device__ __forceinline__ const float* k_ptr(int64_t b, int h) const {
    return q_ptr(b, h) + hd();
  }
  __device__ __forceinline__ const float* v_ptr(int64_t b, int h) const {
    return q_ptr(b, h) + 2 * hd();
  }
  __device__ __forceinline__ float* o_ptr(int64_t b, int h) const {
    return out + b * n * hd() + h * D;
  }
  __device__ __forceinline__ int64_t q_row() const { return 3 * hd(); }
  __device__ __forceinline__ int64_t k_row() const { return 3 * hd(); }
  __device__ __forceinline__ int64_t v_row() const { return 3 * hd(); }
  __device__ __forceinline__ int64_t o_row() const { return hd(); }
};

// K2 and K3: each operand through its own (batch, head, token) strides, in
// elements.
template <int D>
struct StridedLayout {
  static constexpr int kD = D;
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int64_t q_b, q_h, q_n;
  int64_t k_b, k_h, k_n;
  int64_t v_b, v_h, v_n;
  int64_t o_b, o_h, o_n;
  int n;
  float scale;

  __device__ __forceinline__ const float* q_ptr(int64_t b, int h) const {
    return q + b * q_b + h * q_h;
  }
  __device__ __forceinline__ const float* k_ptr(int64_t b, int h) const {
    return k + b * k_b + h * k_h;
  }
  __device__ __forceinline__ const float* v_ptr(int64_t b, int h) const {
    return v + b * v_b + h * v_h;
  }
  __device__ __forceinline__ float* o_ptr(int64_t b, int h) const { return o + b * o_b + h * o_h; }
  __device__ __forceinline__ int64_t q_row() const { return q_n; }
  __device__ __forceinline__ int64_t k_row() const { return k_n; }
  __device__ __forceinline__ int64_t v_row() const { return v_n; }
  __device__ __forceinline__ int64_t o_row() const { return o_n; }
};

// The layout of K2's and K3's C entries: 12 element strides, (batch, head,
// token) of q, k, v, then o.
template <int D>
StridedLayout<D> strided_layout(const void* q, const void* k, const void* v, void* o,
                                const int64_t* strides, int n, float scale) {
  StridedLayout<D> a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(o);
  a.q_b = strides[0];
  a.q_h = strides[1];
  a.q_n = strides[2];
  a.k_b = strides[3];
  a.k_h = strides[4];
  a.k_n = strides[5];
  a.v_b = strides[6];
  a.v_h = strides[7];
  a.v_n = strides[8];
  a.o_b = strides[9];
  a.o_h = strides[10];
  a.o_n = strides[11];
  a.n = n;
  a.scale = scale;
  return a;
}

template <int D>
constexpr size_t smem_bytes() {
  return (4 * static_cast<size_t>(kBlockQ) * tile_ld<D>()  // Q K V O
          + 2 * static_cast<size_t>(kBlockQ) * kLdS         // S P
          + 2 * static_cast<size_t>(kBlockQ))               // m l
         * sizeof(float);
}

// Copies tokens [row0, row0 + 64) of one head (D wide) into a shared tile
// with 16-byte loads through the read-only path (no kernel writes its
// inputs); tokens >= n become zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int64_t row_stride,
                                          int row0, int n) {
  constexpr int kVecPerRow = D / 4;
  constexpr int ld = tile_ld<D>();
  for (int i = threadIdx.x; i < kBlockK * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < n) v = __ldg(reinterpret_cast<const float4*>(src + (row0 + r) * row_stride + c));
    *reinterpret_cast<float4*>(dst + r * ld + c) = v;
  }
}

// S[r0:r0+16, 0:64] = Q[r0:r0+16] . K^T (unscaled).
template <int D>
__device__ __forceinline__ void tile_scores(const float* q_s, const float* k_s, float* s_s,
                                            int r0, int lane) {
  constexpr int ld = tile_ld<D>();
  for (int r = r0; r < r0 + kRowsPerWarp; ++r) {
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 16
    for (int k = 0; k < D; ++k) {
      const float q = q_s[r * ld + k];
      a0 = fmaf(q, k_s[lane * ld + k], a0);
      a1 = fmaf(q, k_s[(lane + 32) * ld + k], a1);
    }
    s_s[r * kLdS + lane] = a0;
    s_s[r * kLdS + lane + 32] = a1;
  }
}

// O[r0:r0+16, 0:D] += P[r0:r0+16] . V (the accumulator in shared memory).
template <int D>
__device__ __forceinline__ void tile_pv(const float* p_s, const float* v_s, float* o_s, int r0,
                                        int lane) {
  constexpr int ld = tile_ld<D>();
  constexpr int kCols = D / 32;  // output columns of a lane: lane + 32 j
  for (int r = r0; r < r0 + kRowsPerWarp; ++r) {
    float acc[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] = o_s[r * ld + lane + 32 * j];
#pragma unroll 16
    for (int key = 0; key < kBlockK; ++key) {
      const float p = p_s[r * kLdS + key];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[j] = fmaf(p, v_s[key * ld + lane + 32 * j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) o_s[r * ld + lane + 32 * j] = acc[j];
  }
}

// The body of a kernel: one CTA of kThreads threads per (64-row q tile,
// head, batch item), grid = (ceil(n / 64), heads, batch), smem_bytes<D>() of
// dynamic shared memory. Each kernel (K1, K2) wraps it in a __global__ of
// its own name, so that a profile tells the two apart.
template <typename Layout>
__device__ __forceinline__ void attn_tile(const Layout& a) {
  constexpr int D = Layout::kD;
  constexpr int ld = tile_ld<D>();
  constexpr int kCols = D / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + kBlockQ * ld;
  float* v_s = k_s + kBlockK * ld;
  float* o_s = v_s + kBlockK * ld;
  float* s_s = o_s + kBlockQ * ld;
  float* p_s = s_s + kBlockQ * kLdS;
  float* m_s = p_s + kBlockQ * kLdS;
  float* l_s = m_s + kBlockQ;

  const int n = a.n;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const float* k_base = a.k_ptr(b, h);
  const float* v_base = a.v_ptr(b, h);
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * kRowsPerWarp;

  load_tile<D>(q_s, a.q_ptr(b, h), a.q_row(), q0, n);
  for (int i = threadIdx.x; i < kBlockQ * ld; i += kThreads) o_s[i] = 0.0f;
  for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.0f;
  }

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(k_s, k_base, a.k_row(), k0, n);
    load_tile<D>(v_s, v_base, a.v_row(), k0, n);
    __syncthreads();

    tile_scores<D>(q_s, k_s, s_s, r0, lane);
    __syncwarp();

    // Online softmax over this warp's rows; lane owns key columns lane and
    // lane + 32 of the tile.
    const bool valid0 = k0 + lane < n;
    const bool valid1 = k0 + lane + 32 < n;
    for (int r = r0; r < r0 + kRowsPerWarp; ++r) {
      const float s0 = valid0 ? s_s[r * kLdS + lane] * a.scale : -INFINITY;
      const float s1 = valid1 ? s_s[r * kLdS + lane + 32] * a.scale : -INFINITY;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);  // finite: column k0 is always valid
      const float e0 = expf(s0 - m_new);
      const float e1 = expf(s1 - m_new);
      float sum = e0 + e1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      const float alpha = expf(m_old - m_new);  // 0 on the first tile
      p_s[r * kLdS + lane] = e0;
      p_s[r * kLdS + lane + 32] = e1;
#pragma unroll
      for (int j = 0; j < kCols; ++j) o_s[r * ld + lane + 32 * j] *= alpha;
      __syncwarp();  // every lane has read m_s[r] and l_s[r]
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
      }
    }
    __syncwarp();

    tile_pv<D>(p_s, v_s, o_s, r0, lane);
    __syncwarp();
  }

  float* o_base = a.o_ptr(b, h);
  for (int r = r0; r < r0 + kRowsPerWarp; ++r) {
    const int row = q0 + r;
    if (row >= n) break;
    const float l = l_s[r];
    float* dst = o_base + row * a.o_row();
#pragma unroll
    for (int j = 0; j < kCols; ++j) dst[lane + 32 * j] = o_s[r * ld + lane + 32 * j] / l;
  }
}

// Launches `kernel` (a __global__ wrapper of attn_tile over a layout of head
// width D, taking `args`) over `batch` x `heads` problems of `n` tokens on
// `stream`; returns the cudaError_t of the launch (0 on success).
template <int D, typename... Params, typename... Args>
int launch_attention(void (*kernel)(Params...), int n, int batch, int heads, void* stream,
                     Args... args) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, heads, batch);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
