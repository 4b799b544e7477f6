// Exact-softmax attention for many short heads, for Hopper (sm_90a) (kernel K3).
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
// then P.V accumulated in fp32 and cast once. A one-pass streaming
// (online-softmax) kernel cannot divide before the cast, because the row sum
// is known only after the last key; this one takes two passes over the keys
// (bf16) or holds the whole row (fp32).
//
// What bounds it on the H100: 4*B*H*N^2*d operations against
// 4*B*H*N*d*itemsize bytes. At (35, 16, 577, 64) bf16 that is 4.8e10
// operations (0.048 ms at 989 TFLOP/s) against 165 MB (0.049 ms at 3.35
// TB/s): the two bounds meet, so neither the tensor cores nor the memory
// can be left idle. The two passes do 1.5x those operations on the tensor
// cores (Q.K^T twice); the second read of K comes from L2 (K of a head is
// at most 128 KB at N <= 1024).
//
// Design (bf16): the Hopper mainloop of attention_sm90.cuh in its exact
// mode. One CTA of a producer warpgroup (TMA loads through per-operand
// tensor maps: Q once, then K tiles of 128 keys, then K and V tiles, through
// a ring of full/empty mbarriers) and a consumer warpgroup of 64 query rows,
// two CTAs an SM. Pass 1 computes S = Q.K^T on wgmma with S in registers and keeps each
// row's max m and rescaled sum l in registers; pass 2 recomputes S, forms
// P = exp(s*scale - m) / l, casts it to bf16 in registers and feeds it to the
// P.V wgmma as its register operand; O accumulates in registers with no
// rescaling and leaves by a TMA store, written (B, N, H, d). N = 577 pads to
// 640 keys and rows. Grid (ceil(N/64), H, B): 10 x 16 x 35 = 5,600 CTAs at
// the Depth Pro patch shape.
//
// Head widths: 64 and 128, as K2 (the wrapper zero-pads narrower heads);
// wider heads, padded to a multiple of 128, run the simple loop of
// attention_wide.cuh, as K2's do (its online softmax never rounds P, so it
// is no further from the exact softmax than the two passes).
//
// Design (fp32, precision="fp32": fp32 FMAs, since one TF32 pass would round;
// K1 and K2 keep fp32 accuracy on split TF32 wgmma instead,
// attention_sm90_f32.cuh): one CTA of 8 warps per (query tile, head, batch
// item). Pass 1
// computes S = Q.K^T over 64-key tiles into a shared-memory score block
// that holds the query tile's whole rows (N <= 1024, padded to 64); then
// each warp takes its rows through max, exp, sum and the division, and
// writes P over the same row; pass 2 accumulates O = P.V over
// 64-key V tiles in registers, with no rescaling. The launcher asks the
// runtime's occupancy calculator which query tile (64 or 32 rows) keeps more
// CTAs resident, and takes the 64-row tile on a tie and the 32-row tile
// wherever the 64-row score block does not fit (N > 768 at d = 64, N > 640
// at d = 128).
//
// Left on the table (later work): for bf16, those of attention_sm90.cuh
// (ping-pong consumers, softmax/wgmma overlap, a persistent scheduler); for
// fp32, no TMA and no double-buffered K/V tiles.

#include "attention_sm90.cuh"
#include "attention_wide.cuh"

namespace {

constexpr int kBlockK = 64;  // keys per K/V tile

// Row stride (floats) of the Q and K/V tiles: 16 bytes of padding per row
// spreads rows over the banks.
template <int D>
__host__ __device__ constexpr int tile_ld() { return D + 4; }

// The operands of a head: each through its own (batch, head, token) strides,
// in elements, with a unit stride along head_dim. Every pointer and every row
// stride times 4 bytes is a multiple of 16 bytes (the wrapper checks it), so
// rows load as 16-byte vectors.
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

constexpr int kMaxKeys = 1024;  // the wrapper's contract
constexpr int kBWarps = 8;
constexpr int kBThreads = kBWarps * 32;
constexpr int kKeysPerLane = kMaxKeys / 32;
constexpr size_t kSmemPerBlock = 232448;  // H100: 227 KB of dynamic shared memory per block

__host__ __device__ constexpr int round_up64(int n) { return (n + 63) / 64 * 64; }

// Row stride (floats) of the score block, which also stages the output
// (D wide) at the end: 16 bytes of padding per row.
template <int D>
__host__ __device__ constexpr int score_ld(int n_pad) { return (n_pad > D ? n_pad : D) + 4; }

template <int D, int BQ>
size_t batched_smem_bytes(int n_pad) {
  return (static_cast<size_t>(BQ) * score_ld<D>(n_pad)  // S, then P, then O
          + static_cast<size_t>(BQ) * tile_ld<D>()       // Q tile
          + static_cast<size_t>(kBlockK) * tile_ld<D>())  // K or V tile
         * sizeof(float);
}

// Copies rows [row0, row0 + kRows) of one head (D wide) into a shared
// tile with 16-byte loads through the read-only path; rows >= n become zeros.
template <int D, int kRows>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int64_t row_stride,
                                          int row0, int n) {
  constexpr int kVecPerRow = D / 4;
  constexpr int ld = tile_ld<D>();
  for (int i = threadIdx.x; i < kRows * kVecPerRow; i += kBThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < n) v = __ldg(reinterpret_cast<const float4*>(src + (row0 + r) * row_stride + c));
    *reinterpret_cast<float4*>(dst + r * ld + c) = v;
  }
}

// Writes rows [row0, row0 + kRows) of the tile o_s (row stride lds) to dst
// with 16-byte stores; rows >= n are not written.
template <int D, int kRows>
__device__ __forceinline__ void store_rows(float* dst, int64_t row_stride, const float* o_s,
                                           int lds, int row0, int n) {
  constexpr int kVecPerRow = D / 4;
  for (int i = threadIdx.x; i < kRows * kVecPerRow; i += kBThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 4;
    if (row0 + r >= n) continue;
    *reinterpret_cast<float4*>(dst + (row0 + r) * row_stride + c) =
        *reinterpret_cast<const float4*>(o_s + r * lds + c);
  }
}

// A warp's share of a tile: rows [r0, r0 + 16), columns [c0, c0 + WC).

// S[r0:r0+16, c0:c0+WC] of one 64-key tile = Q . K^T, unscaled, into s_dst
// (the score block at the tile's first key, row stride lds).
template <int D, int WC>
__device__ __forceinline__ void warp_scores(const float* q_s, const float* k_s, float* s_dst,
                                            int lds, int r0, int c0, int lane) {
  constexpr int ld = tile_ld<D>();
  constexpr int kStep = 32 / WC;  // lanes per column: a lane's rows are kStep apart
  const int c = c0 + lane % WC;
  for (int r = r0 + lane / WC; r < r0 + 16; r += kStep) {
    float acc = 0.0f;
#pragma unroll 16
    for (int k = 0; k < D; ++k) acc = fmaf(q_s[r * ld + k], k_s[c * ld + k], acc);
    s_dst[r * lds + c] = acc;
  }
}

// One score row -> P, in place: scale, mask keys >= n, max, exp, sum,
// divide; keys in [n, n_pad) get P = 0.
__device__ __forceinline__ void softmax_row(float* row, int n, int n_pad, float scale, int lane) {
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
#pragma unroll
  for (int t = 0; t < kKeysPerLane; ++t) {
    const int j = lane + 32 * t;
    if (j < n_pad) row[j] = v[t] / sum;
  }
}

// The P.V accumulator of a warp's (16 x WC) share of the output, kept in
// registers over every key tile: a lane owns columns c0 + lane % kCols +
// 32 j and rows lane / kCols + kStep i of the share.
template <int D, int WC>
struct PVAccumulator {
  static constexpr int kCols = WC < 32 ? WC : 32;
  static constexpr int kReps = WC / kCols;   // columns of one lane
  static constexpr int kStep = 32 / kCols;
  static constexpr int kRows = 16 / kStep;  // rows of one lane
  float acc[kRows][kReps];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kReps; ++j) acc[i][j] = 0.0f;
  }

  // p: P at (r0, the tile's first key), row stride ldp; v_s: the V tile.
  __device__ __forceinline__ void step(const float* p, int ldp, const float* v_s, int c0,
                                       int lane) {
    constexpr int ld = tile_ld<D>();
    const int c = c0 + lane % kCols;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float* p_row = p + (lane / kCols + i * kStep) * ldp;
#pragma unroll 16
      for (int k = 0; k < kBlockK; ++k) {
        const float pk = p_row[k];
#pragma unroll
        for (int j = 0; j < kReps; ++j) acc[i][j] = fmaf(pk, v_s[k * ld + c + 32 * j], acc[i][j]);
      }
    }
  }

  __device__ __forceinline__ void store(float* o_s, int lds, int r0, int c0, int lane) const {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kReps; ++j) {
        o_s[(r0 + lane / kCols + i * kStep) * lds + c0 + lane % kCols + 32 * j] = acc[i][j];
      }
  }
};

// One CTA of kBThreads threads per (BQ-row query tile, head, batch item),
// grid = (ceil(n / BQ), heads, batch), batched_smem_bytes<D, BQ>(n_pad) of
// dynamic shared memory.
template <int D, int BQ>
__global__ void __launch_bounds__(kBThreads) attn_batched_kernel(const StridedLayout<D> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kRowTiles = BQ / 16;
  constexpr int kWS = kBlockK * kRowTiles / kBWarps;  // key columns of a score tile per warp
  constexpr int kWO = D * kRowTiles / kBWarps;        // output columns per warp
  constexpr int kSoftmaxRows = BQ / kBWarps;
  static_assert(kWS % 16 == 0 && kWS <= 32, "a warp takes one or two 16-key slices");
  static_assert(kWO % 16 == 0 && (kWO <= 32 || kWO % 32 == 0), "a warp's output columns");

  const int n = a.n;
  const int n_pad = round_up64(n);
  const int lds = score_ld<D>(n_pad);
  float* s_s = reinterpret_cast<float*>(smem);
  float* q_s = s_s + BQ * lds;
  float* kv_s = q_s + BQ * tile_ld<D>();

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = (warp % kRowTiles) * 16;

  load_rows<D, BQ>(q_s, a.q_ptr(b, h), a.q_row(), q0, n);

  // Pass 1: the query tile's whole score rows, one 64-key tile at a time.
  for (int k0 = 0; k0 < n_pad; k0 += kBlockK) {
    __syncthreads();  // Q is in; every warp is done with the previous K tile
    load_rows<D, kBlockK>(kv_s, a.k_ptr(b, h), a.k_row(), k0, n);
    __syncthreads();
    warp_scores<D, kWS>(q_s, kv_s, s_s + k0, lds, r0, (warp / kRowTiles) * kWS, lane);
  }
  __syncthreads();

  // The exact softmax of each row, divided before P.V.
  for (int r = warp * kSoftmaxRows; r < (warp + 1) * kSoftmaxRows; ++r) {
    softmax_row(s_s + r * lds, n, n_pad, a.scale, lane);
  }

  // Pass 2: O = P.V, accumulated over the V tiles.
  const int c0 = (warp / kRowTiles) * kWO;
  PVAccumulator<D, kWO> acc;
  acc.zero();
  for (int k0 = 0; k0 < n_pad; k0 += kBlockK) {
    __syncthreads();  // P is complete; every warp is done with the previous V tile
    load_rows<D, kBlockK>(kv_s, a.v_ptr(b, h), a.v_row(), k0, n);
    __syncthreads();
    acc.step(s_s + r0 * lds + k0, lds, kv_s, c0, lane);
  }
  __syncthreads();  // every warp is done reading P: O is staged over it
  acc.store(s_s, lds, r0, c0, lane);
  __syncthreads();
  store_rows<D, BQ>(a.o_ptr(b, h), a.o_row(), s_s, lds, q0, n);
}

// How many CTAs of the BQ-row tile the runtime keeps resident on one SM
// (0 if its shared memory does not fit a block), and their shared memory.
template <int D, int BQ>
cudaError_t resident_ctas(int n_pad, size_t* smem, int* ctas) {
  *smem = batched_smem_bytes<D, BQ>(n_pad);
  *ctas = 0;
  if (*smem > kSmemPerBlock) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      attn_batched_kernel<D, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, attn_batched_kernel<D, BQ>,
                                                       kBThreads, *smem);
}

template <int D, int BQ>
int launch_tile(const StridedLayout<D>& a, int batch, int heads, size_t smem, void* stream) {
  const dim3 grid((a.n + BQ - 1) / BQ, heads, batch);
  attn_batched_kernel<D, BQ><<<grid, kBThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_batched_f32(const void* q, const void* k, const void* v, void* o,
                       const int64_t* strides, int batch, int heads, int n, float scale,
                       void* stream) {
  const StridedLayout<D> a = strided_layout<D>(q, k, v, o, strides, n, scale);
  // The query tile that keeps more warps resident on an SM (both tiles run
  // 8 warps a CTA); on a tie the 64-row tile, which reads each K/V tile half
  // as often.
  const int n_pad = round_up64(n);
  size_t smem64 = 0, smem32 = 0;
  int ctas64 = 0, ctas32 = 0;
  cudaError_t err = resident_ctas<D, 64>(n_pad, &smem64, &ctas64);
  if (err == cudaSuccess) err = resident_ctas<D, 32>(n_pad, &smem32, &ctas32);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ctas64 > 0 && ctas64 >= ctas32) return launch_tile<D, 64>(a, batch, heads, smem64, stream);
  return launch_tile<D, 32>(a, batch, heads, smem32, stream);
}

template <typename Cfg>
__global__ void __launch_bounds__(Cfg::kThreads, Cfg::kMinCtas) attn_batched_kernel_sm90(
    const __grid_constant__ CUtensorMap q, const __grid_constant__ CUtensorMap k,
    const __grid_constant__ CUtensorMap v, const __grid_constant__ CUtensorMap o, int n,
    float scale_log2) {
  sm90::attention<Cfg, /*kExact=*/true>(q, k, v, o, n, scale_log2);
}

template <typename T>
__global__ void __launch_bounds__(wide::kThreads) attn_batched_wide_kernel(const wide::Args<T> a) {
  wide::attention<T>(a);
}

}  // namespace

extern "C" {

// q, k, v: (batch, heads, n, head_dim) with unit stride on the last axis,
// n <= 1024, head_dim 64, 128 or a multiple of 128 (the wrapper zero-pads
// other widths); o:
// any layout given by its strides. strides: 12 element strides, (batch,
// head, token) of q, k, v, then o. Pointers and strides (times the element
// size) are multiples of 16 bytes. tile: the mainloop's instantiation at
// head_dim 64 or 128 (attention_sm90.cuh, dispatch_tile; 0 is the default);
// every other width, and the fp32 entry, take 0 only. Launches on `stream`,
// allocates nothing, does not synchronise. Returns the cudaError_t of the
// launch (0 on success).
int mdet_flash_attention_batched_bf16(const void* q, const void* k, const void* v, void* o,
                                      const int64_t* strides, int batch, int heads, int n,
                                      int head_dim, float scale, int tile, void* stream) {
  if (n < 1 || n > kMaxKeys) return static_cast<int>(cudaErrorInvalidValue);
  const auto launch_fn = [&](auto cfg) {
    using Cfg = decltype(cfg);
    return sm90::launch<Cfg>(attn_batched_kernel_sm90<Cfg>, q, k, v, o, strides, batch, heads, n,
                             scale, stream);
  };
  if (head_dim == 64) return sm90::dispatch_tile<64>(tile, launch_fn);
  if (head_dim == 128) return sm90::dispatch_tile<128>(tile, launch_fn);
  if (tile != 0) return static_cast<int>(cudaErrorInvalidValue);
  return wide::launch<__nv_bfloat16>(attn_batched_wide_kernel<__nv_bfloat16>, q, k, v, o,
                                     strides, batch, heads, n, head_dim, scale, stream);
}

int mdet_flash_attention_batched_f32(const void* q, const void* k, const void* v, void* o,
                                     const int64_t* strides, int batch, int heads, int n,
                                     int head_dim, float scale, int tile, void* stream) {
  if (tile != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n < 1 || n > kMaxKeys) return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim == 64) {
    return launch_batched_f32<64>(q, k, v, o, strides, batch, heads, n, scale, stream);
  }
  if (head_dim == 128) {
    return launch_batched_f32<128>(q, k, v, o, strides, batch, heads, n, scale, stream);
  }
  return wide::launch<float>(attn_batched_wide_kernel<float>, q, k, v, o, strides, batch, heads,
                             n, head_dim, scale, stream);
}

}  // extern "C"
