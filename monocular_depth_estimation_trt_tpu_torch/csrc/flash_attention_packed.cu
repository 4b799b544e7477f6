// Packed-qkv attention for Hopper (sm_90a), read straight from the qkv
// matmul's output.
//
// Replaces the TPU kernel
//   monocular_depth_estimation_trt_tpu/ops/pallas/flash_attention.py::_attn_kernel_packed
// (entry flash_attention_packed). Same function: non-causal
// softmax(q k^T * scale) v per head, read from the packed (B, N, 3*H*d)
// tensor (q | k | v regions, each H*d wide, head-major) and written as the
// (B, N, H*d) input of the proj matmul. Scores and softmax in fp32, the
// exponentials cast to the operand type before P.V, fp32 accumulation, the
// division by the row sum once after P.V, key columns >= N masked to -inf.
//
// What bounds it on the H100: 4*B*H*N^2*d operations against
// B*N*4*H*d*itemsize bytes. At ViT-S 518^2 (B=1, N=1370, H=6, d=64, bf16)
// that is 2.9 GFLOP (2.9 us at 989 TFLOP/s) against 4.2 MB (1.3 us at
// 3.35 TB/s): the tensor cores bound it, as they do at every DINOv2 shape.
//
// Design. The TPU kernel holds the whole-N K/V of a head in VMEM and does
// one exact softmax pass; that does not fit 227 KB of shared memory, so this
// kernel streams K/V in tiles of 64 keys with an online softmax (running row
// max and sum, the O accumulator rescaled per tile). One CTA of 4 warps per
// (64-row q tile, head, batch item): 22 x 6 = 132 CTAs at ViT-S, one wave.
// Each warp owns 16 query rows end to end. Q.K^T and P.V run on the tensor
// cores through nvcuda::wmma (bf16 operands, fp32 accumulation); the fp32
// instantiation does both products with fp32 FMAs instead, so that
// precision="fp32" keeps full fp32 (TF32 would not). Rows and keys past N
// are zero-filled in shared memory and masked; nothing is padded in memory.
//
// Left on the table (later work): no wgmma, no TMA, no warp specialisation;
// K/V tiles are not double-buffered; S and the O accumulator round-trip
// through shared memory on every tile because wmma's fragment layout is
// opaque; 4 warps per SM at ViT-S leave most of each SM idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;          // head_dim: every DINOv2 encoder
constexpr int kBlockQ = 64;     // query rows per CTA
constexpr int kBlockK = 64;     // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;  // 16
constexpr int kLdF = kBlockK + 4;               // row stride (floats) of S and O

// Row stride (elements) of the Q/K/V/P tiles: 16 bytes of padding per row
// keeps wmma's 32-byte pointer alignment and spreads rows over the banks.
template <typename T>
__host__ __device__ constexpr int tile_ld() { return kD + 16 / static_cast<int>(sizeof(T)); }

template <typename T>
constexpr size_t smem_bytes() {
  return 4 * static_cast<size_t>(kBlockQ) * tile_ld<T>() * sizeof(T)  // Q K V P
         + 2 * static_cast<size_t>(kBlockQ) * kLdF * sizeof(float)   // S O
         + 2 * static_cast<size_t>(kBlockQ) * sizeof(float);         // m l
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copies rows [row0, row0 + 64) of one 64-wide column block of the packed
// tensor into a shared tile with 16-byte loads; rows >= n become zeros.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t row_stride,
                                          int row0, int n) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = kD / kVec;
  constexpr int ld = tile_ld<T>();
  for (int i = threadIdx.x; i < kBlockK * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) {
      v = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

// S[r0:r0+16, 0:64] = Q[r0:r0+16] . K^T (unscaled, fp32).
__device__ __forceinline__ void tile_scores(const __nv_bfloat16* q_s, const __nv_bfloat16* k_s,
                                            float* s_s, int r0, int /*lane*/) {
  using namespace nvcuda;
  constexpr int ld = tile_ld<__nv_bfloat16>();
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < kD; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::load_matrix_sync(a, q_s + r0 * ld + kk, ld);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // K^T as a col-major (d x keys) matrix: element (k, n) at k_s[n*ld + k].
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(b, k_s + j * 16 * ld + kk, ld);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::store_matrix_sync(s_s + r0 * kLdF + j * 16, acc[j], kLdF, wmma::mem_row_major);
  }
}

__device__ __forceinline__ void tile_scores(const float* q_s, const float* k_s, float* s_s,
                                            int r0, int lane) {
  constexpr int ld = tile_ld<float>();
  for (int r = r0; r < r0 + kRowsPerWarp; ++r) {
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 16
    for (int k = 0; k < kD; ++k) {
      const float q = q_s[r * ld + k];
      a0 = fmaf(q, k_s[lane * ld + k], a0);
      a1 = fmaf(q, k_s[(lane + 32) * ld + k], a1);
    }
    s_s[r * kLdF + lane] = a0;
    s_s[r * kLdF + lane + 32] = a1;
  }
}

// O[r0:r0+16, 0:64] += P[r0:r0+16] . V (fp32 accumulator in shared memory).
__device__ __forceinline__ void tile_pv(const __nv_bfloat16* p_s, const __nv_bfloat16* v_s,
                                        float* o_s, int r0, int /*lane*/) {
  using namespace nvcuda;
  constexpr int ld = tile_ld<__nv_bfloat16>();
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::load_matrix_sync(acc[j], o_s + r0 * kLdF + j * 16, kLdF, wmma::mem_row_major);
  }
#pragma unroll
  for (int kk = 0; kk < kBlockK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::load_matrix_sync(a, p_s + r0 * ld + kk, ld);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(b, v_s + kk * ld + j * 16, ld);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::store_matrix_sync(o_s + r0 * kLdF + j * 16, acc[j], kLdF, wmma::mem_row_major);
  }
}

__device__ __forceinline__ void tile_pv(const float* p_s, const float* v_s, float* o_s, int r0,
                                        int lane) {
  constexpr int ld = tile_ld<float>();
  for (int r = r0; r < r0 + kRowsPerWarp; ++r) {
    float a0 = o_s[r * kLdF + lane];
    float a1 = o_s[r * kLdF + lane + 32];
#pragma unroll 16
    for (int j = 0; j < kBlockK; ++j) {
      const float p = p_s[r * ld + j];
      a0 = fmaf(p, v_s[j * ld + lane], a0);
      a1 = fmaf(p, v_s[j * ld + lane + 32], a1);
    }
    o_s[r * kLdF + lane] = a0;
    o_s[r * kLdF + lane + 32] = a1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_packed_kernel(const T* __restrict__ qkv, T* __restrict__ out, int n, int heads,
                       float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = tile_ld<T>();
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + kBlockQ * ld;
  T* v_s = k_s + kBlockK * ld;
  T* p_s = v_s + kBlockK * ld;
  float* s_s = reinterpret_cast<float*>(p_s + kBlockQ * ld);
  float* o_s = s_s + kBlockQ * kLdF;
  float* m_s = o_s + kBlockQ * kLdF;
  float* l_s = m_s + kBlockQ;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int64_t hd = static_cast<int64_t>(heads) * kD;
  const int64_t row_stride = 3 * hd;
  const T* base = qkv + static_cast<int64_t>(blockIdx.z) * n * row_stride;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * kRowsPerWarp;

  load_tile(q_s, base + h * kD, row_stride, q0, n);
  for (int i = threadIdx.x; i < kBlockQ * kLdF; i += kThreads) o_s[i] = 0.0f;
  for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.0f;
  }

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(k_s, base + hd + h * kD, row_stride, k0, n);
    load_tile(v_s, base + 2 * hd + h * kD, row_stride, k0, n);
    __syncthreads();

    tile_scores(q_s, k_s, s_s, r0, lane);
    __syncwarp();

    // Online softmax over this warp's rows; lane owns key columns lane and
    // lane + 32 of the tile.
    const bool valid0 = k0 + lane < n;
    const bool valid1 = k0 + lane + 32 < n;
    for (int r = r0; r < r0 + kRowsPerWarp; ++r) {
      const float s0 = valid0 ? s_s[r * kLdF + lane] * scale : -INFINITY;
      const float s1 = valid1 ? s_s[r * kLdF + lane + 32] * scale : -INFINITY;
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
      p_s[r * ld + lane] = from_float<T>(e0);
      p_s[r * ld + lane + 32] = from_float<T>(e1);
      o_s[r * kLdF + lane] *= alpha;
      o_s[r * kLdF + lane + 32] *= alpha;
      __syncwarp();  // every lane has read m_s[r] and l_s[r]
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
      }
    }
    __syncwarp();

    tile_pv(p_s, v_s, o_s, r0, lane);
    __syncwarp();
  }

  for (int r = r0; r < r0 + kRowsPerWarp; ++r) {
    const int row = q0 + r;
    if (row >= n) break;
    const float l = l_s[r];
    T* dst = out + (static_cast<int64_t>(blockIdx.z) * n + row) * hd + h * kD;
    dst[lane] = from_float<T>(o_s[r * kLdF + lane] / l);
    dst[lane + 32] = from_float<T>(o_s[r * kLdF + lane + 32] / l);
  }
}

template <typename T>
int launch(const void* qkv, void* out, int batch, int n, int heads, float scale,
           void* stream) {
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(attn_packed_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, heads, batch);
  attn_packed_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), n, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qkv: (batch, n, 3*heads*64) contiguous, 16-byte aligned; out: (batch, n,
// heads*64) contiguous. Launches on `stream`, allocates nothing, does not
// synchronise. Returns the cudaError_t of the launch (0 on success).
int mdet_flash_attention_packed_bf16(const void* qkv, void* out, int batch, int n, int heads,
                                     float scale, void* stream) {
  return launch<__nv_bfloat16>(qkv, out, batch, n, heads, scale, stream);
}

int mdet_flash_attention_packed_f32(const void* qkv, void* out, int batch, int n, int heads,
                                    float scale, void* stream) {
  return launch<float>(qkv, out, batch, n, heads, scale, stream);
}

}  // extern "C"
