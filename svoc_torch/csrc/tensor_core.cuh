// Device helpers shared by the bf16 tensor-core bodies of the flash
// kernels (flash_attention.cu, flash_attention_bwd.cu), for Hopper
// (sm_90a): 16- and 4-byte cp.async with zero fill, ldmatrix, the
// m16n8k16 bf16 mma.sync with fp32 accumulators, and 16-byte row loads
// and stores of the [B, T, H, D] layout.
//
// Host side: SmemLimit raises a body's dynamic shared-memory limit once
// per device.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 g + t): A (16 x 16, row
// major) holds rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9,
// as four bf16 pairs {(g, 2t), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8)};
// B (16 x 8, column major) holds column g, rows 2t, 2t + 1 and 2t + 8,
// 2t + 9; C (16 x 8, fp32) holds rows g and g + 8, columns 2t, 2t + 1.
// So the C fragments of two neighbouring 8-column tiles, rounded to bf16
// in registers, are the A fragment of the next product over those 16
// columns: P and dS never leave the registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace tc {

// A kernel that takes more than 48 KB of dynamic shared memory must say
// so on each device it runs on. One SmemLimit per kernel (a static in
// its launcher) remembers, per device, that the attribute is set; a set
// that failed is not remembered and is tried again on the next call.
// Devices past kMaxDevices set it on every call.
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

constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; with valid false nothing is
// read (src-size 0) and the 16 bytes are zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}

// 4 bytes global -> shared, zero when valid is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8i .. 8i + 7 give
// the row addresses of matrix i, and register i of lane 4g + t holds
// row g, columns 2t and 2t + 1 of matrix i (with .trans: column g, rows
// 2t and 2t + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p))
                 : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p))
                 : "memory");
}

// c += a b for one 16 x 8 tile, k = 16: bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (relative error about 2^-22; 0 for
// x below -126, which is how a masked score's -1e30 sentinel ends).
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// Two floats rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// Rows of a [B, T, H, D] tensor, 16 bytes a thread per step, into a
// shared tile of `rows` rows of LD bf16; rows at or past `seq` are
// zero. `src` points at (batch row, token 0, head, 0).
template <int D, int LD, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t tok_stride, int r0, int seq) {
    constexpr int CH = D / 8;  // 16-byte chunks per row
#pragma unroll
    for (int c = threadIdx.x; c < ROWS * CH; c += THREADS) {
        const int r = c / CH, col = (c % CH) * 8;
        const bool ok = r0 + r < seq;
        cp_async16(dst + r * LD + col, src + (size_t)(ok ? r0 + r : 0) * tok_stride + col, ok);
    }
}

// A warp's 16 staged rows (shared, LD bf16 apart) to rows [r0, r0 + 16)
// of a [B, T, H, D] output (clipped at seq), 16 bytes a lane per step.
template <int D, int LD>
__device__ __forceinline__ void store_rows16(__nv_bfloat16* dst, const __nv_bfloat16* staged,
                                             size_t tok_stride, int r0, int seq, int lane) {
    constexpr int CH = D / 8;
#pragma unroll
    for (int c = lane; c < 16 * CH; c += 32) {
        const int r = c / CH, col = (c % CH) * 8;
        if (r0 + r < seq)
            *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * tok_stride + col) =
                *reinterpret_cast<const uint4*>(staged + r * LD + col);
    }
}

}  // namespace tc
