// Packed-qkv attention for Hopper (sm_90a), read straight from the qkv
// matmul's output (kernel K1).
//
// Replaces the TPU kernel
//   monocular_depth_estimation_trt_tpu/ops/pallas/flash_attention.py::_attn_kernel_packed
// (entry flash_attention_packed). Same function: non-causal
// softmax(q k^T * scale) v per head, read from the packed (B, N, 3*H*d)
// tensor (q | k | v regions, each H*d wide, head-major) and written as the
// (B, N, H*d) input of the proj matmul. The numerics and the tile loop are
// those of attention_tile.cuh, shared with kernel K2.
//
// What bounds it on the H100: 4*B*H*N^2*d operations against
// B*N*4*H*d*itemsize bytes. At ViT-S 518^2 (B=1, N=1370, H=6, d=64, bf16)
// that is 2.9 GFLOP (2.9 us at 989 TFLOP/s) against 4.2 MB (1.3 us at
// 3.35 TB/s): the tensor cores bound it, as they do at every DINOv2 shape.
//
// Design. No per-head copies exist: each CTA (64 query rows, one head, one
// batch item) reads q, k and v at column offsets h*64, H*64 + h*64 and
// 2*H*64 + h*64 of rows 3*H*64 apart, and writes its rows into the proj
// input at column h*64. One CTA of 4 warps per (q tile, head, batch item):
// 22 x 6 = 132 CTAs at ViT-S, one wave.

#include "attention_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_packed_kernel(const T* __restrict__ qkv, T* __restrict__ out, int n, int heads,
                       float scale) {
  attn_tile<T>(PackedLayout<T>{qkv, out, n, heads, scale});
}

template <typename T>
int launch_packed(const void* qkv, void* out, int batch, int n, int heads, float scale,
                  void* stream) {
  return launch_attention<T>(attn_packed_kernel<T>, n, batch, heads, stream,
                             static_cast<const T*>(qkv), static_cast<T*>(out), n, heads, scale);
}

}  // namespace

extern "C" {

// qkv: (batch, n, 3*heads*64) contiguous, 16-byte aligned; out: (batch, n,
// heads*64) contiguous. Launches on `stream`, allocates nothing, does not
// synchronise. Returns the cudaError_t of the launch (0 on success).
int mdet_flash_attention_packed_bf16(const void* qkv, void* out, int batch, int n, int heads,
                                     float scale, void* stream) {
  return launch_packed<__nv_bfloat16>(qkv, out, batch, n, heads, scale, stream);
}

int mdet_flash_attention_packed_f32(const void* qkv, void* out, int batch, int n, int heads,
                                    float scale, void* stream) {
  return launch_packed<float>(qkv, out, batch, n, heads, scale, stream);
}

}  // extern "C"
