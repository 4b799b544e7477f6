// (B, H, N, d) attention for Hopper (sm_90a) (kernel K2).
//
// Replaces the TPU kernel
//   monocular_depth_estimation_trt_tpu/ops/pallas/flash_attention.py::_attn_kernel
// (entry flash_attention). Same function: non-causal softmax(q k^T * scale) v
// per (batch, head) on (B, H, N, d) operands, every key past N masked. Its
// callers are the attentions that rotate q and k between the qkv matmul and
// attention (2D RoPE: the VGGT aggregator's frame and global blocks, rope
// ViTs) and attn_impl="flash".
//
// Numerics: scores and softmax in fp32, keys >= N masked to -inf. The TPU
// kernel divides by the row sum before it casts P to the operand type; a
// streaming kernel does not know the row sum until the last key tile, so
// this one defers the division: the unnormalised exponentials are cast to
// the operand type, P.V accumulates in fp32 and the sum divides once at the
// end. Against the TPU-rounded plain version that differs by a rounding of
// P, well inside the bf16 output mantissa.
//
// What bounds it on the H100: 4*B*H*N^2*d operations against
// 4*B*H*N*d*itemsize bytes. VGGT's global attention at S=4 views is
// (1, 16, 5496, 64): 1.24e11 operations, 0.125 ms at 989 TFLOP/s, against
// 22.5 MB, 6.7 us at 3.35 TB/s; the frame attention at S=4 (4, 16, 1374, 64)
// 0.031 ms against 1.7 us. Operations bound it at every VGGT shape.
//
// Design. What the TPU kernel does in one whole-N pass (K/V of a head in
// VMEM, 0.7 to 1.4 MB at VGGT's N) does not fit shared memory, so K/V
// stream through a ring of 128-key tiles with an online softmax.
// bf16 runs the Hopper mainloop of attention_sm90.cuh in its online mode:
// TMA loads of Q and of K/V tiles through per-operand tensor maps (each
// operand read through its own strides: v may be a strided view of the qkv
// output, q and k VGGT's rotated buffer), a producer warpgroup and a
// consumer warpgroup of 64 query rows per CTA, two CTAs an SM, S = Q.K^T
// and O += P.V on wgmma with S, P and O in registers, O rescaled in
// registers per tile. The output is written (B, N, H, d) by a TMA store,
// which makes the reshape before the proj matmul free. The TPU's padding of
// N to 128 is not carried over (TMA zero-fills the ragged last tile, which
// is masked). Grid (ceil(N/64), H, B):
// 86 x 16 = 1,376 CTAs at the S=4 global shape, 22 x 16 x 4 = 1,408 at the
// S=4 frame shape.
//
// Head widths: 64 and 128 (Head64 and Head128 of attention_sm90.cuh); the
// wrapper zero-pads d < 64 to 64 and 64 < d < 128 to 128, as the JAX entry
// pads d > 64 to a multiple of 128. A wider bf16 head, zero-padded to a
// multiple of 64 (not 128: zero columns change no result, and d = 192
// computes 25 % less), runs the mainloop's wide form (attention_wide: the S
// reduction over every 64-column region, the output in 256-column chunks,
// one CTA an SM, Q streamed beside K past d = 1280). It replaced a loop on
// the fp32 pipes (16 query rows a CTA, no TMA or wgmma) that took 2.66 ms at
// (1, 16, 1029, 192) on the H100, about 37x the wide form's time (PERF.md).
//
// fp32 (precision="fp32") runs the fp32 Hopper mainloop of
// attention_sm90_f32.cuh at either width: split TF32 ("3xTF32") wgmma, which
// keeps fp32 accuracy on the tensor cores, fed by a TMA ring through the same
// four tensor maps (fp32 boxes) and written (B, N, H, d) by a TMA store. A
// wider fp32 head, zero-padded to a multiple of 64 as in bf16, runs that
// mainloop's wide form (attention_wide: the S reduction over every 32-column
// region in K pieces, the output in 128-column chunks, 64-key tiles, Q
// resident beside the ring where it fits and streamed beside each K piece
// where it does not, one CTA an SM). It replaced the same loop on the fp32
// pipes (PERF.md).
//
// Left on the table (later work, attention_sm90.cuh): ping-pong scheduling
// of consumer warpgroups and overlap of the softmax with the next tile's
// wgmma; a persistent tile scheduler (1,376 CTAs are 5.2 waves of 2 x 132);
// RoPE fused into the Q/K tile load.

#include "attention_sm90.cuh"
#include "attention_sm90_f32.cuh"

namespace {

template <typename Cfg>
__global__ void __launch_bounds__(Cfg::kThreads, 1) attn_bhnd_kernel_f32_sm90(
    const __grid_constant__ CUtensorMap q, const __grid_constant__ CUtensorMap k,
    const __grid_constant__ CUtensorMap v, const __grid_constant__ CUtensorMap o, int n,
    float scale_log2) {
  sm90f32::attention<Cfg>(q, k, v, o, n, scale_log2);
}

template <typename Cfg>
__global__ void __launch_bounds__(Cfg::kThreads, Cfg::kMinCtas) attn_bhnd_kernel_sm90(
    const __grid_constant__ CUtensorMap q, const __grid_constant__ CUtensorMap k,
    const __grid_constant__ CUtensorMap v, const __grid_constant__ CUtensorMap o, int n,
    float scale_log2) {
  sm90::attention<Cfg, /*kExact=*/false>(q, k, v, o, n, scale_log2);
}

__global__ void __launch_bounds__(sm90::Wide::kThreads, 1) attn_bhnd_wide_kernel_sm90(
    const __grid_constant__ CUtensorMap q, const __grid_constant__ CUtensorMap k,
    const __grid_constant__ CUtensorMap v, const __grid_constant__ CUtensorMap o,
    const sm90::WideArgs a) {
  sm90::attention_wide</*kExact=*/false>(q, k, v, o, a);
}

__global__ void __launch_bounds__(sm90f32::Wide::kThreads, 1) attn_bhnd_wide_kernel_f32_sm90(
    const __grid_constant__ CUtensorMap q, const __grid_constant__ CUtensorMap k,
    const __grid_constant__ CUtensorMap v, const __grid_constant__ CUtensorMap o,
    const sm90f32::WideArgs a) {
  sm90f32::attention_wide(q, k, v, o, a);
}

template <typename Cfg>
int launch_bhnd_f32(const void* q, const void* k, const void* v, void* o, const int64_t* strides,
                    int batch, int heads, int n, float scale, void* stream) {
  return sm90f32::launch<Cfg>(attn_bhnd_kernel_f32_sm90<Cfg>, q, k, v, o, strides, batch, heads, n,
                              scale, stream);
}

}  // namespace

extern "C" {

// q, k, v: (batch, heads, n, head_dim) with unit stride on the last axis,
// head_dim 64, 128 or a multiple of 64 above 128 (the wrapper zero-pads other
// widths); o: any layout
// given by its strides. strides: 12 element strides, (batch, head, token) of
// q, k, v, then o. Pointers and strides (times the element size) are
// multiples of 16 bytes. tile: the mainloop's instantiation at head_dim 64
// or 128 (attention_sm90.cuh, dispatch_tile; 0 is the default); every other
// width, and the fp32 entry (one tile a width, attention_sm90_f32.cuh), take 0
// only. Launches on `stream`, allocates
// nothing, does not synchronise. Returns the cudaError_t of the launch (0 on
// success).
int mdet_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                              const int64_t* strides, int batch, int heads, int n, int head_dim,
                              float scale, int tile, void* stream) {
  const auto launch_fn = [&](auto cfg) {
    using Cfg = decltype(cfg);
    return sm90::launch<Cfg>(attn_bhnd_kernel_sm90<Cfg>, q, k, v, o, strides, batch, heads, n,
                             scale, stream);
  };
  if (head_dim == 64) return sm90::dispatch_tile<64>(tile, launch_fn);
  if (head_dim == 128) return sm90::dispatch_tile<128>(tile, launch_fn);
  if (tile != 0) return static_cast<int>(cudaErrorInvalidValue);
  return sm90::launch_wide(attn_bhnd_wide_kernel_sm90, q, k, v, o, strides, batch, heads, n,
                           head_dim, scale, stream);
}

int mdet_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                             const int64_t* strides, int batch, int heads, int n, int head_dim,
                             float scale, int tile, void* stream) {
  if (tile != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim == 64) {
    return launch_bhnd_f32<sm90f32::Head64>(q, k, v, o, strides, batch, heads, n, scale, stream);
  }
  if (head_dim == 128) {
    return launch_bhnd_f32<sm90f32::Head128>(q, k, v, o, strides, batch, heads, n, scale, stream);
  }
  return sm90f32::launch_wide(attn_bhnd_wide_kernel_f32_sm90, q, k, v, o, strides, batch, heads,
                              n, head_dim, scale, stream);
}

}  // extern "C"
