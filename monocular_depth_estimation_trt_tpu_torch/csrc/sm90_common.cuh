// Hopper (sm_90a) building blocks shared by the TMA + wgmma kernels: the
// attention mainloop of K1 to K3 (attention_sm90.cuh) and the w8a8 GEMM K4
// (w8a8_matmul.cu). mbarriers, TMA loads and stores, wgmma fences and the
// shared-memory matrix descriptors of 128- and 64-byte-swizzled tiles; on the host,
// the lookup of cuTensorMapEncodeTiled and the per-device facts a launch
// needs, each queried once.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <utility>
#include <vector>

namespace {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
// No wait of these kernels lasts longer than one tile's copy or compute, so
// a wait that has not ended after 2^30 tries (seconds) is a fault: it traps,
// and the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 30)) __trap();
  }
}

// --- TMA -----------------------------------------------------------------------

// The box at (c0, c1) of a rank-2 `map` into shared memory at `dst`;
// completion is reported to `bar` as transaction bytes.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The same for a rank-4 map at (c0, c1, c2, c3).
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared memory at `src` to the box at (c0, c1, c2, c3) of a rank-4 `map`,
// committed as a bulk group (wait with tma_store_wait).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap& map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(&map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Shared memory at `src` to the box at (c0, c1) of a rank-2 `map`, committed
// as a bulk group (wait with tma_store_wait).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap& map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(&map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until every committed TMA store has read shared memory.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (TMA stores, wgmma operand reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- wgmma ---------------------------------------------------------------------

// Shared-memory matrix descriptor of a tile of 128-byte rows under the
// 128-byte swizzle (layout type 1), from a 1024-byte aligned atom: start
// address, leading byte offset, stride byte offset 1024 (from one group of 8
// rows to the next). K-major operands step along K by adding 32 bytes to the
// start address and do not use the leading offset. An MN-major operand reads
// its N extent in atoms of 128 bytes; the leading offset is the distance
// between those atoms.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// The same for a K-major tile of 64-byte rows under the 64-byte swizzle
// (layout type 2), from a 512-byte aligned atom: stride byte offset 512 (8
// rows of 64 bytes); a step along K adds 32 bytes to the start address.
__device__ __forceinline__ uint64_t smem_desc_sw64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (static_cast<uint64_t>(2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the wgmma's wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// --- host side -----------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found once through the CUDA runtime
// (no link against libcuda); null if the installed libcuda lacks it.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(ptr)
               : nullptr;
  }();
  return fn;
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes` (a kernel always
// asks for the same) on the current device, with one driver call per kernel
// and device, not one per launch.
inline cudaError_t allow_smem(const void* kernel, int bytes) {
  static std::mutex mu;
  static std::vector<std::pair<const void*, int>> raised;  // (kernel, device)
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  for (const auto& r : raised) {
    if (r.first == kernel && r.second == device) return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) raised.emplace_back(kernel, device);
  return err;
}

// The current device's SM count, read once per device.
inline cudaError_t sm_count(int* sms) {
  static std::mutex mu;
  static std::vector<int> counts;  // by device; 0 until read
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  if (device < static_cast<int>(counts.size()) && counts[device] > 0) {
    *sms = counts[device];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (device >= static_cast<int>(counts.size())) counts.resize(device + 1, 0);
  counts[device] = *sms;
  return cudaSuccess;
}

}  // namespace sm90
}  // namespace
