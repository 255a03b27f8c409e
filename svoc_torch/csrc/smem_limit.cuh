// The dynamic shared-memory limit of a kernel, raised once per device,
// host side: shared by the flash bodies (flash_attention.cu,
// flash_attention_bwd.cu) and the consensus kernels (fused_consensus.cu,
// gated_claims_consensus.cu).
//
// A kernel that takes more than 48 KB of dynamic shared memory must say
// so on each device it runs on (cudaFuncSetAttribute). One SmemLimit per
// kernel (a static in its launcher) remembers, per device, that the
// attribute is set; a set that failed is not remembered and is tried
// again on the next call. Devices past kMaxDevices set it on every call.
// A launcher whose need varies with its inputs sets kMaxBytes, the most
// one block may take on sm_90, so that no later, larger launch needs it
// raised again; such a kernel keeps no static shared memory.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace svoc {

constexpr int kSmallSmemBytes = 48 * 1024;  // what a launch may take without the attribute
constexpr int kMaxSmemBytes = 232448;       // 227 KB: one block's most on sm_90

struct SmemLimit {
    static constexpr int kMaxDevices = 64;
    std::atomic<bool> set[kMaxDevices] = {};

    template <typename Kernel>
    cudaError_t ensure(Kernel* kernel, int bytes) {
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return err;
        const bool cached = dev >= 0 && dev < kMaxDevices;
        if (cached && set[dev].load(std::memory_order_acquire)) return cudaSuccess;
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err == cudaSuccess && cached) set[dev].store(true, std::memory_order_release);
        return err;
    }
};

}  // namespace svoc
