// Packed-qkv attention for Hopper (sm_90a), read straight from the qkv
// matmul's output (kernel K1).
//
// Replaces the TPU kernel
//   monocular_depth_estimation_trt_tpu/ops/pallas/flash_attention.py::_attn_kernel_packed
// (entry flash_attention_packed). Same function: non-causal
// softmax(q k^T * scale) v per head, read from the packed (B, N, 3*H*64)
// tensor (q | k | v regions, each H*64 wide, head-major) and written as the
// (B, N, H*64) input of the proj matmul. Like the TPU kernel, it casts the
// unnormalised exponentials before P.V and divides by the row sum after it.
//
// What bounds it on the H100: 4*B*H*N^2*d operations against
// B*N*4*H*d*itemsize bytes. At ViT-S 518^2 (B=1, N=1370, H=6, d=64, bf16)
// that is 2.9 GFLOP (2.9 us at 989 TFLOP/s) against 4.2 MB (1.3 us at
// 3.35 TB/s): the tensor cores bound it, as they do at every DINOv2 shape.
//
// Design (bf16): the packed tensor is three strided (B, H, N, 64) views, q
// at column 0, k at H*64 and v at 2*H*64, with element strides N*3*H*64
// (batch), 64 (head) and 3*H*64 (token); the output is (B, N, H, 64)
// contiguous. Those are the rank-4 tensor maps of the Hopper mainloop of
// attention_sm90.cuh (every stride a multiple of 16 bytes, a 64-wide row
// 128 bytes), which K1 runs in its online mode, as K2 does: TMA loads, a
// producer warpgroup and a consumer warpgroup of 64 query rows, two CTAs an
// SM, wgmma with S, P and O in registers. No per-head copy exists. Grid
// (ceil(N/64), H, B): 22 x 6 = 132 CTAs at ViT-S, one wave at two CTAs an SM
// of which only one is filled, so the prologue shows.
//
// fp32 (precision="fp32") runs the fp32 Hopper mainloop of
// attention_sm90_f32.cuh over the same three strided views (four tensor maps a
// call, fp32 boxes): split TF32 wgmma, which keeps fp32 accuracy on the
// tensor cores, fed by a TMA ring.

#include "attention_sm90.cuh"
#include "attention_sm90_f32.cuh"

namespace {

template <typename Cfg>
__global__ void __launch_bounds__(Cfg::kThreads, 1)
    attn_packed_kernel_f32_sm90(const __grid_constant__ CUtensorMap q,
                                const __grid_constant__ CUtensorMap k,
                                const __grid_constant__ CUtensorMap v,
                                const __grid_constant__ CUtensorMap o, int n, float scale_log2) {
  sm90f32::attention<Cfg>(q, k, v, o, n, scale_log2);
}

template <typename Cfg>
__global__ void __launch_bounds__(Cfg::kThreads, Cfg::kMinCtas)
    attn_packed_kernel_sm90(const __grid_constant__ CUtensorMap q,
                            const __grid_constant__ CUtensorMap k,
                            const __grid_constant__ CUtensorMap v,
                            const __grid_constant__ CUtensorMap o, int n, float scale_log2) {
  sm90::attention<Cfg, /*kExact=*/false>(q, k, v, o, n, scale_log2);
}

}  // namespace

extern "C" {

// qkv: (batch, n, 3*heads*64) contiguous, 16-byte aligned; out: (batch, n,
// heads*64) contiguous. tile: the mainloop's instantiation at d = 64
// (attention_sm90.cuh, dispatch_tile; 0 is the default); the fp32 entry
// takes 0 only. Launches on `stream`, allocates nothing, does not
// synchronise. Returns the cudaError_t of the launch (0 on success).
int mdet_flash_attention_packed_bf16(const void* qkv, void* out, int batch, int n, int heads,
                                     float scale, int tile, void* stream) {
  const int64_t hd = static_cast<int64_t>(heads) * 64;
  const int64_t row = 3 * hd;
  // (batch, head, token) element strides of q, k, v, then o
  const int64_t strides[12] = {n * row, 64, row, n * row, 64, row,
                               n * row, 64, row, n * hd,  64, hd};
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(qkv);
  return sm90::dispatch_tile<64>(tile, [&](auto cfg) {
    using Cfg = decltype(cfg);
    return sm90::launch<Cfg>(attn_packed_kernel_sm90<Cfg>, base, base + hd, base + 2 * hd, out,
                             strides, batch, heads, n, scale, stream);
  });
}

int mdet_flash_attention_packed_f32(const void* qkv, void* out, int batch, int n, int heads,
                                    float scale, int tile, void* stream) {
  if (tile != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t hd = static_cast<int64_t>(heads) * 64;
  const int64_t row = 3 * hd;
  const int64_t strides[12] = {n * row, 64, row, n * row, 64, row,
                               n * row, 64, row, n * hd,  64, hd};
  const float* base = static_cast<const float*>(qkv);
  using Cfg = sm90f32::Head64;
  return sm90f32::launch<Cfg>(attn_packed_kernel_f32_sm90<Cfg>, base, base + hd, base + 2 * hd, out,
                              strides, batch, heads, n, scale, stream);
}

}  // extern "C"
