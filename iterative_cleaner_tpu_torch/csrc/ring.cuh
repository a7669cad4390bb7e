// ring.cuh: the primitives of a ring of stages in shared memory, shared by
// the kernels under csrc/ (ordered_template.cu, fused_fit_moments.cu):
// mbarrier initialisation, waits and arrivals, and the asynchronous copies
// that fill a stage (4-, 8- and 16-byte cp.async, the TMA's 1-D bulk copy).
// A wait that has not completed after kHangNs traps, so a fault in a ring's
// handshake is a launch failure that the wrapper raises, never a hang.
// On the host, allow_dynamic_smem: a kernel's shared memory above 48 KB,
// allowed once per device.
// ops/cuda_build.py keys every build on this header as well as its source.

#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr unsigned long long kHangNs = 20000000000ull;  // 20 s: no stage waits that long

// Devices whose allowance a kernel remembers; on a device past these it is
// set again at each launch (setting it is idempotent).
constexpr int kMaxAllowDevices = 64;

// Allow `kernel` `bytes` of dynamic shared memory on the current device (the
// wrappers make the operands' device current), once per device: the
// attribute belongs to the function in that device's context, so a process
// that launches on a second card must set it there too.  `allowed` is the
// caller's flags, one array per kernel instantiation.  Two threads that race
// here both set the attribute, which is harmless; a failure is not
// remembered.
inline cudaError_t allow_dynamic_smem(const void* kernel, int bytes,
                                      std::atomic<bool> (&allowed)[kMaxAllowDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool tracked = dev >= 0 && dev < kMaxAllowDevices;
  if (tracked && allowed[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && tracked) allowed[dev].store(true, std::memory_order_release);
  return err;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of parity `parity` to complete; trap after kHangNs.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > kHangNs) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// An arrival that also expects `bytes` of asynchronous copies to land.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// The TMA's 1-D copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const float* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

// The barrier's phase completes once this thread's earlier cp.async copies
// have landed; counts as one of its expected arrivals.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

}  // namespace
