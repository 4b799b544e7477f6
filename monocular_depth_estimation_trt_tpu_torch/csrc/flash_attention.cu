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
// Numerics: those of attention_tile.cuh. The TPU kernel divides by the row
// sum before it casts P to the operand type; a streaming kernel does not
// know the row sum until the last key tile, so this one keeps K1's deferred
// division: the unnormalized exponentials are cast to the operand type,
// P.V accumulates in fp32 and the sum divides once at the end. Against the
// TPU-rounded plain version that differs by a rounding of P, well inside
// the bf16 output mantissa.
//
// What bounds it on the H100: 4*B*H*N^2*d operations against
// 4*B*H*N*d*itemsize bytes. VGGT's global attention at S=4 views is
// (1, 16, 5496, 64): 1.24e11 operations, 0.13 ms at 989 TFLOP/s, against
// 22.5 MB, 6.7 us at 3.35 TB/s. Operations bound it at every VGGT shape.
//
// Design: what the TPU kernel does in one whole-N pass (K/V of a head in
// VMEM, 0.7 to 1.4 MB at VGGT's N) does not fit shared memory, so K/V
// stream through the shared tile loop with an online softmax. The TPU's
// padding of N to 128 and of d to 64 is not carried over: the ragged last
// tile is masked in shared memory, and the wrapper pads d < 64 to 64. Each
// operand is read through its own strides (v may be a strided view of the
// qkv output), and the output is written as (B, N, H, d), which makes the
// reshape before the proj matmul free. Grid (ceil(N/64), H, B): 86 x 16 =
// 1376 CTAs at the S=4 global shape.

#include "attention_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads) attn_bhnd_kernel(const StridedLayout<T> a) {
  attn_tile<T>(a);
}

// strides: 12 element strides, (batch, head, token) of q, k, v, then o.
template <typename T>
int launch_bhnd(const void* q, const void* k, const void* v, void* o, const int64_t* strides,
                int batch, int heads, int n, float scale, void* stream) {
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
  return launch_attention<T>(attn_bhnd_kernel<T>, n, batch, heads, stream, a);
}

}  // namespace

extern "C" {

// q, k, v: (batch, heads, n, 64) with unit stride on the last axis; o: any
// layout given by its strides. Pointers and strides (times the element
// size) are multiples of 16 bytes. Launches on `stream`, allocates nothing,
// does not synchronise. Returns the cudaError_t of the launch (0 on success).
int mdet_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                              const int64_t* strides, int batch, int heads, int n,
                              float scale, void* stream) {
  return launch_bhnd<__nv_bfloat16>(q, k, v, o, strides, batch, heads, n, scale, stream);
}

int mdet_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                             const int64_t* strides, int batch, int heads, int n,
                             float scale, void* stream) {
  return launch_bhnd<float>(q, k, v, o, strides, batch, heads, n, scale, stream);
}

}  // extern "C"
