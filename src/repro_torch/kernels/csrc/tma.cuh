// Hopper's producer/consumer building blocks, for kernels whose tiles reach
// shared memory by TMA (the bf16 body of flash_attention.cu): mbarriers
// (arrival counts and TMA byte counts, waited for by phase parity), tiled
// TMA loads through a tensor map that lies in the kernel's parameter space
// (a __grid_constant__ argument), named barriers between warpgroups, and
// setmaxnreg, which moves registers from a producer warpgroup to its
// consumers.
#pragma once

#include <cuda.h>
#include <stdint.h>

namespace hopper {

// Initialise the mbarrier at shared address `bar` for `count` arrivals a
// phase. One thread initialises; fence_barrier_init() then publishes it.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count));
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic the phase waits
// for (the producer's arrival on a full barrier).
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Spin until the phase of parity `parity` has completed. A barrier starts
// in phase 0, so a wait on parity 1 passes at once (a producer's first wait
// on an empty slot) and one on parity 0 waits for the first completion.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// A box of the 4-D tensor map `map` at coordinates (c0 innermost .. c3)
// into shared memory at `dst`, its completion counted on the mbarrier `bar`
// in bytes. Coordinates past the tensor's extent read as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap& map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Named barrier `id` (1 .. 15; 0 is __syncthreads) over `threads` threads:
// wait for them, or count this warp's threads in and go on.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// This warpgroup's registers a thread, lowered (a producer) or raised (a
// consumer); every thread of the warpgroup executes it.
template <int N>
__device__ __forceinline__ void regs_lower() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void regs_raise() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

}  // namespace hopper
