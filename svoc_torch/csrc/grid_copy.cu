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
// - Grid (G, R/br, C/bc), one block per tile; the block computes its own
//   offset where a BlockSpec's index map did. It numbers itself in launch
//   order (blockIdx.x fastest) and takes the tile of that number in
//   memory order (the column tile fastest, then the row tile, then the
//   leading index), so that the blocks resident at once read and write
//   one contiguous stretch, as a memcpy does.
// - 1024 threads a block; they stride over the tile in row-major order,
//   so neighbouring threads touch neighbouring addresses of one row.
//   The memory order and the block size are what brought the copy of
//   [64, 8192, 128] float32 from 84 % of the bandwidth to about x.clone()'s
//   rate on an H100 (chip_smoke.py phase 1b times both, and the parent
//   tree with --parent); a sweep of block sizes (256, 512, 1024) and
//   loads in flight a thread (1 to 8) found the loads made no difference.
// - Where every row of the tile starts on a 16-byte boundary and is a
//   multiple of 16 bytes wide (the wrapper checks the base pointers, the
//   row pitch C and the tile width bc), each thread moves 16-byte words
//   (uint4); otherwise it moves one element at a time.
// - Each thread issues kUnroll loads before its first store; its (row,
//   column) in the tile advances by a whole stride with one compare, not
//   a division per word.
// - Elements are copied as raw bits of 2 or 4 bytes, so the copy is bit
//   for bit for any dtype of that size (NaN payloads included).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 2;

// Copies one tile of `total` words, `per_row` words a row, whose rows lie
// `pitch` words apart in both arrays.
template <typename W>
__device__ __forceinline__ void copy_tile(const W* __restrict__ src, W* __restrict__ dst,
                                          int per_row, int pitch, int total) {
    const int stride = blockDim.x;
    const int dr = stride / per_row, dc = stride - dr * per_row;  // the stride as rows, words
    int r = threadIdx.x / per_row, c = threadIdx.x - r * per_row;
    for (int idx = threadIdx.x; idx < total; idx += kUnroll * stride) {
        W v[kUnroll];
        size_t at[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            at[u] = (size_t)r * pitch + c;
            if (idx + u * stride < total) v[u] = src[at[u]];
            r += dr;
            c += dc;
            if (c >= per_row) {
                c -= per_row;
                ++r;
            }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
            if (idx + u * stride < total) dst[at[u]] = v[u];
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
grid_copy_kernel(const T* __restrict__ x, T* __restrict__ out, int rows, int cols, int br, int bc,
                 int vec) {
    // This block's tile, in memory order, and its first element.
    const size_t row_tiles = gridDim.y, col_tiles = gridDim.z;
    const size_t t = blockIdx.x + gridDim.x * (blockIdx.y + row_tiles * blockIdx.z);
    const size_t g = t / (row_tiles * col_tiles), i = t / col_tiles % row_tiles,
                 j = t % col_tiles;
    const size_t base = (g * rows + i * br) * cols + j * bc;
    if (vec) {
        constexpr int words = 16 / (int)sizeof(T);  // elements a uint4 holds
        copy_tile(reinterpret_cast<const uint4*>(x + base), reinterpret_cast<uint4*>(out + base),
                  bc / words, cols / words, br * (bc / words));
    } else {
        copy_tile(x + base, out + base, bc, cols, br * bc);
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
