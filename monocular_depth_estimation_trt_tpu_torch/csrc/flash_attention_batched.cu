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
// Numerics (bf16): those of the TPU kernel, exactly. Scores in fp32 (Q.K^T
// with fp32 accumulation, then * scale), keys >= N masked to -inf, the row
// max, exp, the row sum, P = e / sum divided BEFORE its cast to the operand
// type, then P.V accumulated in fp32 and cast once. A one-pass streaming
// (online-softmax) kernel cannot divide before the cast, because the row sum
// is known only after the last key; this one takes two passes over the keys.
// In fp32 there is no cast for the division to stand before: the fp32 K3
// divides once after P.V, which changes only fp32 rounding.
//
// What bounds it on the H100: 4*B*H*N^2*d operations against
// 4*B*H*N*d*itemsize bytes. At (35, 16, 577, 64) bf16 that is 4.8e10
// operations (0.048 ms at 989 TFLOP/s) against 165 MB (0.049 ms at 3.35
// TB/s): the two bounds meet, so neither the tensor cores nor the memory
// can be left idle. The two passes do 1.5x those operations on the tensor
// cores (Q.K^T twice); the second read of K comes from L2 (K of a head is
// at most 128 KB at N <= 1024). In fp32 the operations bound it: 3 x ops on
// the TF32 tensor cores (split TF32), 0.2893 ms at the patch shape.
//
// Design (bf16): the Hopper mainloop of attention_sm90.cuh in its exact
// mode. One CTA of a producer warpgroup (TMA loads through per-operand
// tensor maps: Q once, then K tiles of 128 keys, then K and V tiles, through
// a ring of full/empty mbarriers) and a consumer warpgroup of 64 query rows,
// two CTAs an SM. Pass 1 computes S = Q.K^T on wgmma with S in registers and
// keeps each row's max m and rescaled sum l in registers; pass 2 recomputes
// S, forms P = exp(s*scale - m) / l, casts it to bf16 in registers and feeds
// it to the P.V wgmma as its register operand; O accumulates in registers
// with no rescaling and leaves by a TMA store, written (B, N, H, d). N = 577
// pads to 640 keys and rows. Grid (ceil(N/64), H, B): 10 x 16 x 35 = 5,600
// CTAs at the Depth Pro patch shape. Head widths 64 and 128, as K2 (the
// wrapper zero-pads narrower heads); a wider head, zero-padded to a multiple
// of 64, runs the mainloop's wide form in the same exact mode (the S
// reduction over every 64-column region, 256-column output chunks, one CTA
// an SM).
//
// Design (fp32, precision="fp32"): the split TF32 mainloop of
// attention_sm90_f32.cuh, as the fp32 K1 and K2 (TMA ring, a converter
// warpgroup for the lo tiles and V^T, both products as three TF32 wgmma
// chains, fp32-accurate; one CTA an SM), at 64 keys x 3 stages (d = 64) and
// 32 keys x 2 stages (d = 128). It replaced a loop on the fp32 pipes that
// held a query tile's whole score rows in shared memory (no TMA, 0 wgmma):
// 6.88 against 0.73 ms at the patch shape on the H100 (PERF.md). An fp32
// head wider than 128, zero-padded to a multiple of 64, runs that mainloop's
// wide form in the same online mode, as K2's (128-column output chunks,
// 64-key tiles, Q streamed beside each K piece where it does not fit
// resident).
//
// Left on the table (later work): those of the two mainloops (ping-pong
// consumers, softmax/wgmma overlap, a persistent scheduler: each of the
// patch shape's 5,600 CTAs pays Q's load and the ring's fill).

#include "attention_sm90.cuh"
#include "attention_sm90_f32.cuh"

namespace {

constexpr int kMaxKeys = 1024;  // the wrapper's contract

template <typename Cfg>
__global__ void __launch_bounds__(Cfg::kThreads, Cfg::kMinCtas) attn_batched_kernel_sm90(
    const __grid_constant__ CUtensorMap q, const __grid_constant__ CUtensorMap k,
    const __grid_constant__ CUtensorMap v, const __grid_constant__ CUtensorMap o, int n,
    float scale_log2) {
  sm90::attention<Cfg, /*kExact=*/true>(q, k, v, o, n, scale_log2);
}

__global__ void __launch_bounds__(sm90::Wide::kThreads, 1) attn_batched_wide_kernel_sm90(
    const __grid_constant__ CUtensorMap q, const __grid_constant__ CUtensorMap k,
    const __grid_constant__ CUtensorMap v, const __grid_constant__ CUtensorMap o,
    const sm90::WideArgs a) {
  sm90::attention_wide</*kExact=*/true>(q, k, v, o, a);
}

template <typename Cfg>
__global__ void __launch_bounds__(Cfg::kThreads, 1) attn_batched_kernel_f32_sm90(
    const __grid_constant__ CUtensorMap q, const __grid_constant__ CUtensorMap k,
    const __grid_constant__ CUtensorMap v, const __grid_constant__ CUtensorMap o, int n,
    float scale_log2) {
  sm90f32::attention<Cfg>(q, k, v, o, n, scale_log2);
}

__global__ void __launch_bounds__(sm90f32::Wide::kThreads, 1) attn_batched_wide_kernel_f32_sm90(
    const __grid_constant__ CUtensorMap q, const __grid_constant__ CUtensorMap k,
    const __grid_constant__ CUtensorMap v, const __grid_constant__ CUtensorMap o,
    const sm90f32::WideArgs a) {
  sm90f32::attention_wide(q, k, v, o, a);
}

template <typename Cfg>
int launch_batched_f32(const void* q, const void* k, const void* v, void* o,
                       const int64_t* strides, int batch, int heads, int n, float scale,
                       void* stream) {
  return sm90f32::launch<Cfg>(attn_batched_kernel_f32_sm90<Cfg>, q, k, v, o, strides, batch, heads,
                              n, scale, stream);
}

}  // namespace

extern "C" {

// q, k, v: (batch, heads, n, head_dim) with unit stride on the last axis,
// n <= 1024, head_dim 64, 128 or a multiple of 64 above 128 (the wrapper
// zero-pads other widths); o: any layout given by its strides. strides: 12
// element strides, (batch, head, token) of q, k, v, then o. Pointers and
// strides (times the element size) are multiples of 16 bytes. tile: the
// mainloop's instantiation at head_dim 64 or 128 (attention_sm90.cuh,
// dispatch_tile; 0 is the default); every other width, and the fp32 entry
// (one tile a width, attention_sm90_f32.cuh), take 0 only. Launches on
// `stream`, allocates nothing, does not synchronise. Returns the cudaError_t
// of the launch (0 on success).
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
  return sm90::launch_wide(attn_batched_wide_kernel_sm90, q, k, v, o, strides, batch, heads, n,
                           head_dim, scale, stream);
}

int mdet_flash_attention_batched_f32(const void* q, const void* k, const void* v, void* o,
                                     const int64_t* strides, int batch, int heads, int n,
                                     int head_dim, float scale, int tile, void* stream) {
  if (tile != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n < 1 || n > kMaxKeys) return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim == 64) {
    return launch_batched_f32<sm90f32::Head64>(q, k, v, o, strides, batch, heads, n, scale, stream);
  }
  if (head_dim == 128) {
    return launch_batched_f32<sm90f32::Head128>(q, k, v, o, strides, batch, heads, n, scale,
                                                stream);
  }
  return sm90f32::launch_wide(attn_batched_wide_kernel_f32_sm90, q, k, v, o, strides, batch,
                              heads, n, head_dim, scale, stream);
}

}  // extern "C"
