// Whole-row attention for many short heads, for Hopper (sm_90a) (kernel K3).
//
// Replaces the TPU kernel
//   monocular_depth_estimation_trt_tpu/ops/pallas/flash_attention.py::_attn_kernel_batched
// (entry flash_attention(blk_b > 1)). Same function: non-causal
// softmax(q k^T * scale) v per (batch, head) on (B, H, N, d) operands, for
// the regime the JAX package sends there: many heads (b*h >= 256) of at most
// 1024 tokens. Its caller is Depth Pro's patch encoder: 35 windows x 16 heads
// of 577 tokens.
//
// Numerics: those of the TPU kernel, exactly. Scores in fp32 (Q.K^T with
// fp32 accumulation, then * scale), keys >= N masked to -inf, the row max,
// exp, the row sum, P = e / sum divided BEFORE its cast to the operand type,
// then P.V accumulated in fp32 and cast once. A streaming (online-softmax)
// kernel cannot divide before the cast, because the row sum is known only
// after the last key; this one holds the whole row.
//
// What bounds it on the H100: 4*B*H*N^2*d operations against
// 4*B*H*N*d*itemsize bytes. At (35, 16, 577, 64) bf16 that is 4.8e10
// operations (0.048 ms at 989 TFLOP/s) against 165 MB (0.049 ms at 3.35
// TB/s): the two bounds meet, so neither the tensor cores nor the memory
// can be left idle.
//
// Design. One CTA of 8 warps per (query tile, head, batch item). Pass 1
// computes S = Q.K^T over 64-key tiles into a shared-memory score block
// that holds the query tile's whole rows (N <= 1024, padded to 64); then
// each warp takes its rows through max, exp, sum and the division, and
// writes P, cast to the operand type, over the front of the same row; pass
// 2 accumulates O = P.V over 64-key V tiles in registers (wmma fragments),
// with no rescaling. bf16 products run on the tensor cores through
// nvcuda::wmma; fp32 takes fp32 FMAs (TF32 would round), as K1 and K2 do.
// The occupancy trade: a query tile of 64 rows holds 183 KB at N = 577
// (bf16), so one CTA, 8 warps, runs on an SM; a tile of 32 rows holds 96
// KB, two CTAs share an SM, and each K/V tile is read twice as often (from
// L2). With nothing else to hide the latency of the tile loads, the 16
// resident warps win: 1.66 ms against 2.37 ms a call at (35, 16, 577, 64)
// on an H100 (PERF.md). The launcher asks the runtime's occupancy
// calculator which tile keeps more CTAs resident, and takes the 64-row
// tile on a tie (small N) and the 32-row tile wherever the 64-row score
// block does not fit (bf16 N > 832, fp32 N > 768). At N = 577: a grid of
// 19 x 16 x 35 = 10,640 CTAs.
//
// Left on the table (later work): no wgmma, no TMA, no double-buffered K/V
// tiles (each load's latency is exposed but for the other resident CTA);
// each K/V tile is read by every query tile of its head (19 times at
// N = 577, from L2).

#include "attention_tile.cuh"

namespace {

constexpr int kMaxKeys = 1024;  // the wrapper's contract
constexpr int kBWarps = 8;
constexpr int kBThreads = kBWarps * 32;
constexpr int kKeysPerLane = kMaxKeys / 32;
constexpr size_t kSmemPerBlock = 232448;  // H100: 227 KB of dynamic shared memory per block

__host__ __device__ constexpr int round_up64(int n) { return (n + 63) / 64 * 64; }

// Row stride (floats) of the score block: 16 bytes of padding per row.
__host__ __device__ constexpr int score_ld(int n_pad) { return n_pad + 4; }

template <typename T, int BQ>
size_t batched_smem_bytes(int n_pad) {
  return static_cast<size_t>(BQ) * score_ld(n_pad) * sizeof(float)  // S, then P, then O
         + static_cast<size_t>(BQ) * tile_ld<T>() * sizeof(T)        // Q tile
         + static_cast<size_t>(kBlockK) * tile_ld<T>() * sizeof(T);  // K or V tile
}

// Copies rows [row0, row0 + kRows) of one head (64 wide) into a shared
// tile with 16-byte loads through the read-only path; rows >= n become zeros.
template <typename T, int kRows>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int64_t row_stride, int row0,
                                          int n) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = kD / kVec;
  constexpr int ld = tile_ld<T>();
  for (int i = threadIdx.x; i < kRows * kVecPerRow; i += kBThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) {
      v = __ldg(reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c));
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

// Writes rows [row0, row0 + kRows) of the fp32 tile o_s (row stride kLdF)
// to dst, cast to T, with 16-byte stores; rows >= n are not written.
template <typename T, int kRows>
__device__ __forceinline__ void store_rows(T* dst, int64_t row_stride, const float* o_s, int row0,
                                           int n) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = kD / kVec;
  for (int i = threadIdx.x; i < kRows * kVecPerRow; i += kBThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    if (row0 + r >= n) continue;
    uint4 packed;
    T* vals = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int e = 0; e < kVec; ++e) vals[e] = from_float<T>(o_s[r * kLdF + c + e]);
    *reinterpret_cast<uint4*>(dst + (row0 + r) * row_stride + c) = packed;
  }
}

// A warp's share of a 64-wide tile: rows [r0, r0 + 16), columns [c0, c0 + WC).

// S[r0:r0+16, c0:c0+WC] of one 64-key tile = Q . K^T, unscaled fp32, into
// s_dst (the score block at the tile's first key, row stride lds).
template <int WC>
__device__ __forceinline__ void warp_scores(const __nv_bfloat16* q_s, const __nv_bfloat16* k_s,
                                            float* s_dst, int lds, int r0, int c0, int /*lane*/) {
  using namespace nvcuda;
  constexpr int ld = tile_ld<__nv_bfloat16>();
  constexpr int kFrags = WC / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFrags];
#pragma unroll
  for (int j = 0; j < kFrags; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < kD; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::load_matrix_sync(a, q_s + r0 * ld + kk, ld);
#pragma unroll
    for (int j = 0; j < kFrags; ++j) {
      // K^T as a col-major (d x keys) matrix: element (k, n) at k_s[n*ld + k].
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(b, k_s + (c0 + j * 16) * ld + kk, ld);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kFrags; ++j) {
    wmma::store_matrix_sync(s_dst + r0 * lds + c0 + j * 16, acc[j], lds, wmma::mem_row_major);
  }
}

template <int WC>
__device__ __forceinline__ void warp_scores(const float* q_s, const float* k_s, float* s_dst,
                                            int lds, int r0, int c0, int lane) {
  constexpr int ld = tile_ld<float>();
  constexpr int kStep = 32 / WC;  // lanes per column: a lane's rows are kStep apart
  const int c = c0 + lane % WC;
  for (int r = r0 + lane / WC; r < r0 + 16; r += kStep) {
    float acc = 0.0f;
#pragma unroll 16
    for (int k = 0; k < kD; ++k) acc = fmaf(q_s[r * ld + k], k_s[c * ld + k], acc);
    s_dst[r * lds + c] = acc;
  }
}

// One score row -> P, in place: scale, mask keys >= n, max, exp, sum, divide,
// cast to T. The row is read whole into registers before the front of its
// storage is overwritten by P (n_pad values of T).
template <typename T>
__device__ __forceinline__ void softmax_row(float* row, int n, int n_pad, float scale,
                                            int lane) {
  float v[kKeysPerLane];
  float mx = -INFINITY;
#pragma unroll
  for (int t = 0; t < kKeysPerLane; ++t) {
    const int j = lane + 32 * t;
    v[t] = j < n ? row[j] * scale : -INFINITY;
    mx = fmaxf(mx, v[t]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float sum = 0.0f;
#pragma unroll
  for (int t = 0; t < kKeysPerLane; ++t) {
    v[t] = lane + 32 * t < n ? expf(v[t] - mx) : 0.0f;  // mx is finite: key 0 is valid
    sum += v[t];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  __syncwarp();  // every lane holds its part of the row before P overwrites it
  T* p = reinterpret_cast<T*>(row);
#pragma unroll
  for (int t = 0; t < kKeysPerLane; ++t) {
    const int j = lane + 32 * t;
    if (j < n_pad) p[j] = from_float<T>(v[t] / sum);
  }
}

// The P.V accumulator of a warp's (16 x WC) share of the output, kept in
// registers over every key tile.
template <typename T, int WC>
struct PVAccumulator;

template <int WC>
struct PVAccumulator<__nv_bfloat16, WC> {
  static constexpr int kFrags = WC / 16;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> f[kFrags];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < kFrags; ++j) nvcuda::wmma::fill_fragment(f[j], 0.0f);
  }

  // p: P at (r0, the tile's first key), row stride ldp; v_s: the V tile.
  __device__ __forceinline__ void step(const __nv_bfloat16* p, int ldp, const __nv_bfloat16* v_s,
                                       int c0, int /*lane*/) {
    using namespace nvcuda;
    constexpr int ld = tile_ld<__nv_bfloat16>();
#pragma unroll
    for (int kk = 0; kk < kBlockK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, p + kk, ldp);
#pragma unroll
      for (int j = 0; j < kFrags; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, v_s + kk * ld + c0 + j * 16, ld);
        wmma::mma_sync(f[j], a, b, f[j]);
      }
    }
  }

  __device__ __forceinline__ void store(float* o_s, int r0, int c0, int /*lane*/) const {
#pragma unroll
    for (int j = 0; j < kFrags; ++j) {
      nvcuda::wmma::store_matrix_sync(o_s + r0 * kLdF + c0 + j * 16, f[j], kLdF,
                                      nvcuda::wmma::mem_row_major);
    }
  }
};

template <int WC>
struct PVAccumulator<float, WC> {
  static constexpr int kStep = 32 / WC;
  static constexpr int kRows = 16 / kStep;  // rows of one lane
  float acc[kRows];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = 0.0f;
  }

  __device__ __forceinline__ void step(const float* p, int ldp, const float* v_s, int c0,
                                       int lane) {
    constexpr int ld = tile_ld<float>();
    const int c = c0 + lane % WC;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float* p_row = p + (lane / WC + i * kStep) * ldp;
#pragma unroll 16
      for (int k = 0; k < kBlockK; ++k) acc[i] = fmaf(p_row[k], v_s[k * ld + c], acc[i]);
    }
  }

  __device__ __forceinline__ void store(float* o_s, int r0, int c0, int lane) const {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      o_s[(r0 + lane / WC + i * kStep) * kLdF + c0 + lane % WC] = acc[i];
    }
  }
};

// One CTA of kBThreads threads per (BQ-row query tile, head, batch item),
// grid = (ceil(n / BQ), heads, batch), batched_smem_bytes<T, BQ>(n_pad) of
// dynamic shared memory.
template <typename T, int BQ>
__global__ void __launch_bounds__(kBThreads) attn_batched_kernel(const StridedLayout<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = tile_ld<T>();
  constexpr int kRowTiles = BQ / 16;
  constexpr int kWC = kD * kRowTiles / kBWarps;  // columns of a 64-wide tile per warp
  constexpr int kSoftmaxRows = BQ / kBWarps;
  static_assert(kWC % 16 == 0 && kWC <= 32, "a warp takes one or two 16-column fragments");

  const int n = a.n;
  const int n_pad = round_up64(n);
  const int lds = score_ld(n_pad);
  float* s_s = reinterpret_cast<float*>(smem);
  T* q_s = reinterpret_cast<T*>(s_s + BQ * lds);
  T* kv_s = q_s + BQ * ld;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = (warp % kRowTiles) * 16;
  const int c0 = (warp / kRowTiles) * kWC;

  load_rows<T, BQ>(q_s, a.q_ptr(b, h), a.q_row(), q0, n);

  // Pass 1: the query tile's whole score rows, one 64-key tile at a time.
  for (int k0 = 0; k0 < n_pad; k0 += kBlockK) {
    __syncthreads();  // Q is in; every warp is done with the previous K tile
    load_rows<T, kBlockK>(kv_s, a.k_ptr(b, h), a.k_row(), k0, n);
    __syncthreads();
    warp_scores<kWC>(q_s, kv_s, s_s + k0, lds, r0, c0, lane);
  }
  __syncthreads();

  // The exact softmax of each row, divided before the cast.
  for (int r = warp * kSoftmaxRows; r < (warp + 1) * kSoftmaxRows; ++r) {
    softmax_row<T>(s_s + r * lds, n, n_pad, a.scale, lane);
  }

  // Pass 2: O = P.V, accumulated in fp32 over the V tiles.
  const T* p_s = reinterpret_cast<const T*>(s_s);
  const int ldp = lds * static_cast<int>(sizeof(float) / sizeof(T));
  PVAccumulator<T, kWC> acc;
  acc.zero();
  for (int k0 = 0; k0 < n_pad; k0 += kBlockK) {
    __syncthreads();  // P is complete; every warp is done with the previous V tile
    load_rows<T, kBlockK>(kv_s, a.v_ptr(b, h), a.v_row(), k0, n);
    __syncthreads();
    acc.step(p_s + r0 * ldp + k0, ldp, kv_s, c0, lane);
  }
  __syncthreads();  // every warp is done reading P: O is staged over it
  acc.store(s_s, r0, c0, lane);
  __syncthreads();
  store_rows<T, BQ>(a.o_ptr(b, h), a.o_row(), s_s, q0, n);
}

// How many CTAs of the BQ-row tile the runtime keeps resident on one SM
// (0 if its shared memory does not fit a block), and their shared memory.
template <typename T, int BQ>
cudaError_t resident_ctas(int n_pad, size_t* smem, int* ctas) {
  *smem = batched_smem_bytes<T, BQ>(n_pad);
  *ctas = 0;
  if (*smem > kSmemPerBlock) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      attn_batched_kernel<T, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, attn_batched_kernel<T, BQ>,
                                                       kBThreads, *smem);
}

template <typename T, int BQ>
int launch_tile(const StridedLayout<T>& a, int batch, int heads, size_t smem, void* stream) {
  const dim3 grid((a.n + BQ - 1) / BQ, heads, batch);
  attn_batched_kernel<T, BQ><<<grid, kBThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// strides: 12 element strides, (batch, head, token) of q, k, v, then o.
template <typename T>
int launch_batched(const void* q, const void* k, const void* v, void* o, const int64_t* strides,
                   int batch, int heads, int n, float scale, void* stream) {
  if (n < 1 || n > kMaxKeys) return static_cast<int>(cudaErrorInvalidValue);
  StridedLayout<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.o = static_cast<T*>(o);
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
  // The query tile that keeps more warps resident on an SM (both tiles run
  // 8 warps a CTA); on a tie the 64-row tile, which reads each K/V tile half
  // as often. At N = 577 one 64-row CTA (183 KB) or two 32-row CTAs (96 KB
  // each) fit an SM, and the 32-row tile is the faster (PERF.md).
  const int n_pad = round_up64(n);
  size_t smem64 = 0, smem32 = 0;
  int ctas64 = 0, ctas32 = 0;
  cudaError_t err = resident_ctas<T, 64>(n_pad, &smem64, &ctas64);
  if (err == cudaSuccess) err = resident_ctas<T, 32>(n_pad, &smem32, &ctas32);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ctas64 > 0 && ctas64 >= ctas32) return launch_tile<T, 64>(a, batch, heads, smem64, stream);
  return launch_tile<T, 32>(a, batch, heads, smem32, stream);
}

}  // namespace

extern "C" {

// q, k, v: (batch, heads, n, 64) with unit stride on the last axis, n <= 1024;
// o: any layout given by its strides. Pointers and strides (times the element
// size) are multiples of 16 bytes. Launches on `stream`, allocates nothing,
// does not synchronise. Returns the cudaError_t of the launch (0 on success).
int mdet_flash_attention_batched_bf16(const void* q, const void* k, const void* v, void* o,
                                      const int64_t* strides, int batch, int heads, int n,
                                      float scale, void* stream) {
  return launch_batched<__nv_bfloat16>(q, k, v, o, strides, batch, heads, n, scale, stream);
}

int mdet_flash_attention_batched_f32(const void* q, const void* k, const void* v, void* o,
                                     const int64_t* strides, int batch, int heads, int n,
                                     float scale, void* stream) {
  return launch_batched<float>(q, k, v, o, strides, batch, heads, n, scale, stream);
}

}  // extern "C"
