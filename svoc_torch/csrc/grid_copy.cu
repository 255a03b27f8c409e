// Gridded block copy for Hopper (sm_90a), with a plain C interface for
// ctypes: each thread block of a 3-D grid copies one [br, bc] tile of a
// contiguous [G, R, C] array from the input to the output.
//
// Replaces tools/tpu_probe.py::copy_kernel (line 99), the Pallas TPU
// kernel of the probe tool's `grid_copy` probe: a 2-D-grid pallas_call
// whose BlockSpecs (1, 128, 128) with index map (i, j) -> (i, j, 0) cut a
// [4, 256, 128] float32 array into eight tiles. It exists to settle
// whether a kernel with a multi-dimensional grid builds and launches on
// the chip at all; its plain PyTorch version is
// svoc_torch/ops/grid_copy.py::grid_copy_plain.
//
// What bounds it: bytes. Every element is read once and written once
// and nothing is computed, so the least time is 2 * bytes over the
// card's 3.35 TB/s. At the probe's shape (512 KiB each way) that is
// 0.0003 ms, far under the few microseconds a launch costs: there the
// kernel measures launch latency. At [64, 8192, 128] float32 (256 MiB
// each way) the bound is 0.16 ms and the copy is bandwidth-bound.
//
// Design: not the TPU kernel carried over. There the pipeline stages
// each block through VMEM; here a tile goes from device memory through
// registers straight back to device memory, since nothing reuses it.
// - Grid (G, R/br, C/bc): blockIdx.x picks the leading index, blockIdx.y
//   the row tile, blockIdx.z the column tile, so the block computes its
//   own offset where a BlockSpec's index map did.
// - The threads of a block stride over the tile in row-major order, so
//   neighbouring threads touch neighbouring addresses of one row.
// - Where every row of the tile starts on a 16-byte boundary and is a
//   multiple of 16 bytes wide (the wrapper checks the base pointers, the
//   row pitch C and the tile width bc), each thread moves 16 bytes per
//   load and store (uint4); otherwise it moves one element.
// - Elements are copied as raw bits of 2 or 4 bytes, so the copy is bit
//   for bit for any dtype of that size (NaN payloads included).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void grid_copy_kernel(const T* __restrict__ x, T* __restrict__ out, int rows,
                                 int cols, int br, int bc, int vec) {
    // First element of this block's tile.
    const size_t base = ((size_t)blockIdx.x * rows + (size_t)blockIdx.y * br) * cols +
                        (size_t)blockIdx.z * bc;
    if (vec) {
        const int per_row = bc * (int)sizeof(T) / 16;  // uint4 per tile row
        const int total = br * per_row;
        for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
            const int r = idx / per_row;
            const int c = idx - r * per_row;
            const size_t row = base + (size_t)r * cols;
            const uint4* src = reinterpret_cast<const uint4*>(x + row) + c;
            uint4* dst = reinterpret_cast<uint4*>(out + row) + c;
            *dst = *src;
        }
    } else {
        const int total = br * bc;
        for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
            const int r = idx / bc;
            const int c = idx - r * bc;
            const size_t at = base + (size_t)r * cols + c;
            out[at] = x[at];
        }
    }
}

}  // namespace

extern "C" {

// Launches the copy of a contiguous [g, rows, cols] array of `elem_size`
// bytes per element (2 or 4) in tiles of [br, bc] on `stream`, and returns
// cudaGetLastError(). The caller checks that br and bc divide rows and
// cols, that the grid fits CUDA's limits, and whether the 16-byte path
// applies (`vec`).
int svoc_grid_copy(const void* x, void* out, int elem_size, int g, int rows, int cols, int br,
                   int bc, int vec, void* stream) {
    const dim3 grid((unsigned)g, (unsigned)(rows / br), (unsigned)(cols / bc));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (elem_size == 4) {
        grid_copy_kernel<uint32_t><<<grid, kThreads, 0, s>>>(
            static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), rows, cols, br, bc, vec);
    } else if (elem_size == 2) {
        grid_copy_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
            static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), rows, cols, br, bc, vec);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
