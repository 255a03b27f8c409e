// Fused two-pass Cairo-order consensus over one oracle fleet, for Hopper
// (sm_90a), with a plain C interface for ctypes.
//
// Replaces svoc_tpu/ops/pallas_consensus.py::_consensus_kernel (line 209),
// the Pallas TPU kernel behind fused_consensus (line 339). Its plain
// PyTorch version is svoc_torch/ops/fused_consensus.py::fused_consensus_plain.
//
// What bounds it: nothing the card is short of. At the flagship fleet
// (N = 1024 oracles, M = 6) the inputs are 24.6 KB and the outputs about
// 12 KB, well under a microsecond of memory traffic. What costs time is
// latency: one launch, and the barriers between the dependent steps,
// inside one block on one SM.
//
// Design, and why:
// - One thread block per fleet; values [N, M] is staged once in shared
//   memory, column by column, and every step reads it there.
// - Only three steps depend on one another: the first-pass medians, the
//   risk ranking and the second-pass medians. Each reads a few ranks of
//   the Cairo order (ascending key, ties by DESCENDING index;
//   contract/src/sort.cairo), never the whole order: both smooth-median
//   ranks of every column, and the cut m of the risk. So each step is one
//   radix select of all its ranks at once (cairo_select.cuh: a composite
//   key of the float's order-preserving bits over the inverted index, so
//   no two keys tie and -0.0 ties with +0.0 as `<` makes it), about ten
//   barriers at N = 1024 whatever M is up to 8 columns. The first port
//   ran 13 bitonic sorts of 1024 keys one after another, 715 stages each
//   ending in a barrier; a bitonic sort of all M columns at once would
//   need M * NP keys in shared memory and not fit the fleets that fit now.
// - The reliable rows are those whose composite risk key lies below the
//   key at rank m = N - n_failing (m is not clamped: m <= 0 passes none,
//   m >= N all).
// - Masked rows (the unreliable oracles in the second pass) are keyed
//   +inf, as in the TPU kernel; the value read at a rank is the row's
//   own value, not its key, and a rank outside [0, N) reads 0, which is
//   what the TPU kernel's one-hot selection gives.
// - The quadratic risk of each row is summed in column order with
//   __fmul_rn/__fadd_rn, so that no contraction into an FMA can move a
//   near-tie in the risk ranking away from the plain version's order.
// - The means, both reliabilities and the three moments take one block
//   reduction per quantity for up to 8 columns at once (three in all):
//   a warp shuffle tree, then warp 0 adds the warps' partial sums in warp
//   order (letting every thread add them, as the first port did, cost as
//   much as a select at 1024 threads: measured on an H100).
//
// Shared memory: fused_layout(n, dim) below, the one place that knows it
// (svoc_fused_consensus_smem_bytes returns its size); the wrapper refuses
// a fleet whose need exceeds one block's 227 KB (N up to 6159 at M = 6).
// Above 48 KB the launcher raises the kernel's limit to those 227 KB once
// per device (smem_limit.cuh), not on every launch.
// The TPU-only limits (N % 128 == 0, N <= 1024) do not apply.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cairo_select.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kCols = cairo::kQueries / 2;  // columns a select covers: two ranks each
constexpr int kSums = 16;                    // values one block reduction adds at most

struct Layout {
    size_t vals, qr, rel, ess1, red, select, bytes;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Byte offsets into dynamic shared memory for an [n, dim] fleet.
__host__ __device__ inline Layout fused_layout(int n, int dim) {
    Layout l;
    l.vals = 0;                                           // [dim][n] float
    l.qr = l.vals + sizeof(float) * (size_t)n * dim;      // [n] float
    l.rel = l.qr + sizeof(float) * (size_t)n;             // [n] int
    l.ess1 = l.rel + sizeof(int) * (size_t)n;             // [dim] float
    l.red = align16(l.ess1 + sizeof(float) * (size_t)dim);  // [33][kSums] float
    l.select = l.red + sizeof(float) * 33 * kSums;          // cairo::Scratch
    l.bytes = l.select + sizeof(cairo::Scratch);
    return l;
}

// Adds each of the first k (<= kSums) of this thread's x[] over the block;
// every thread gets the totals in x[]: a warp shuffle tree, then warp 0
// adds the warps' partial sums in warp order (one lane a value) into
// red[32 * kSums + j]. Two barriers; red is free again once every thread
// has read the totals, which the next call's first barrier ensures.
__device__ void block_sums(float (&x)[kSums], int k, float* red) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
    float* total = red + 32 * kSums;
#pragma unroll
    for (int j = 0; j < kSums; ++j) {
        if (j < k) {
            float v = x[j];
            for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(cairo::FULL, v, off);
            if (lane == 0) red[warp * kSums + j] = v;
        }
    }
    __syncthreads();
    if (warp == 0 && lane < k) {
        float t = 0.f;
        for (int w = 0; w < warps; ++w) t += red[w * kSums + lane];
        total[lane] = t;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kSums; ++j)
        if (j < k) x[j] = total[j];
}

__device__ __forceinline__ float reliability(float mean_qr, int dim, int constrained,
                                             float max_spread) {
    if (constrained) return 1.0f - 2.0f * sqrtf(mean_qr / (float)dim);
    return 1.0f - fminf(max_spread, sqrtf(mean_qr)) / max_spread;
}

__global__ void __launch_bounds__(kMaxThreads)
fused_consensus_kernel(const float* __restrict__ values, float* __restrict__ essence,
                       float* __restrict__ essence1, float* __restrict__ rel_out,
                       uint8_t* __restrict__ mask_out, float* __restrict__ qr_out,
                       float* __restrict__ moments, int n, int dim, int m, int r_lo_all,
                       int r_hi_all, int r_lo_rel, int r_hi_rel, int constrained,
                       float max_spread) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Layout L = fused_layout(n, dim);
    float* vals = reinterpret_cast<float*>(smem + L.vals);
    float* qr = reinterpret_cast<float*>(smem + L.qr);
    int* rel = reinterpret_cast<int*>(smem + L.rel);
    float* ess1 = reinterpret_cast<float*>(smem + L.ess1);
    float* red = reinterpret_cast<float*>(smem + L.red);
    cairo::Scratch& ws = *reinterpret_cast<cairo::Scratch*>(smem + L.select);
    const int tid = threadIdx.x, threads = blockDim.x;
    const int lbits = cairo::index_bits(n);

    for (int e = tid; e < n * dim; e += threads) vals[(e % dim) * n + e / dim] = values[e];

    // The value of column c at a selected rank: 0 for a rank outside [0, n).
    auto value_at = [&](uint64_t answer, int c) {
        return answer == cairo::kNone ? 0.f : vals[c * n + cairo::row_of(answer, n, lbits)];
    };

    // ---- FIRST PASS: both smooth-median ranks of every column over all N ----
    for (int c0 = 0; c0 < dim; c0 += kCols) {
        const int kc = min(kCols, dim - c0);
        cairo::select_ranks<2>([&](int q, int i) { return vals[(c0 + q / 2) * n + i]; },
                               [&](int q) { return q & 1 ? r_hi_all : r_lo_all; }, n, 2 * kc, ws);
        if (tid < kc) {
            const int c = c0 + tid;
            const float med =
                (value_at(ws.answer[2 * tid], c) + value_at(ws.answer[2 * tid + 1], c)) * 0.5f;
            ess1[c] = med;
            essence1[c] = med;
        }
    }
    __syncthreads();

    float qr_sum = 0.f;
    for (int i = tid; i < n; i += threads) {
        float acc = 0.f;
        for (int c = 0; c < dim; ++c) {
            const float d = __fsub_rn(vals[c * n + i], ess1[c]);
            acc = __fadd_rn(acc, __fmul_rn(d, d));
        }
        qr[i] = acc;
        qr_out[i] = acc;
        qr_sum += acc;
    }

    // Worst n_failing by risk are unreliable (contract.cairo:345-363): rank
    // < m passes, i.e. a composite key below the one at rank m.
    uint64_t cut = m <= 0 ? 0 : cairo::kNone;
    if (m > 0 && m < n) {
        cairo::select_ranks<1>([&](int, int i) { return qr[i]; }, [&](int) { return m; }, n, 1, ws);
        cut = ws.answer[0];
    }
    for (int i = tid; i < n; i += threads) {
        const int r = cairo::composite(qr[i], i, n, lbits) < cut ? 1 : 0;
        rel[i] = r;
        mask_out[i] = (uint8_t)r;
    }
    __syncthreads();

    // ---- SECOND PASS over the reliable subset (m = n - n_failing) ----
    const float mf = (float)m;
    for (int c0 = 0; c0 < dim; c0 += kCols) {
        const int kc = min(kCols, dim - c0);
        if (constrained) {
            cairo::select_ranks<2>(
                [&](int q, int i) { return rel[i] ? vals[(c0 + q / 2) * n + i] : INFINITY; },
                [&](int q) { return q & 1 ? r_hi_rel : r_lo_rel; }, n, 2 * kc, ws);
            if (tid < kc) {
                const int c = c0 + tid;
                essence[c] =
                    (value_at(ws.answer[2 * tid], c) + value_at(ws.answer[2 * tid + 1], c)) * 0.5f;
            }
        }

        // The reliable means of these columns (x[0, kc)); with the first
        // columns, both reliabilities' risk sums (x[kCols], x[kCols + 1];
        // the second pass stays centred on essence1, contract.cairo:414,
        // :484). Registers are indexed by constants only: loops over j
        // are unrolled to kCols and test j < kc.
        float x[kSums];
#pragma unroll
        for (int j = 0; j < kSums; ++j) x[j] = 0.f;
        for (int i = tid; i < n; i += threads) {
            const bool r = rel[i] != 0;
#pragma unroll
            for (int j = 0; j < kCols; ++j)
                if (j < kc) x[j] += r ? vals[(c0 + j) * n + i] : 0.f;
            if (c0 == 0) x[kCols + 1] += r ? qr[i] : 0.f;
        }
        if (c0 == 0) x[kCols] = qr_sum;
        block_sums(x, c0 == 0 ? kCols + 2 : kc, red);
        float mean[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) mean[j] = x[j] / mf;
        if (tid == 0) {
#pragma unroll
            for (int j = 0; j < kCols; ++j)
                if (!constrained && j < kc) essence[c0 + j] = mean[j];  // unconstrained: the mean
            if (c0 == 0) {
                rel_out[0] = reliability(x[kCols] / (float)n, dim, constrained, max_spread);
                rel_out[1] = reliability(x[kCols + 1] / mf, dim, constrained, max_spread);
            }
        }

        // Moments of the reliable subset (contract.cairo:491-500).
#pragma unroll
        for (int j = 0; j < kSums; ++j) x[j] = 0.f;
        for (int i = tid; i < n; i += threads) {
            const bool r = rel[i] != 0;
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                if (j < kc) {
                    const float d = r ? vals[(c0 + j) * n + i] - mean[j] : 0.f;
                    x[j] += d * d;
                }
            }
        }
        block_sums(x, kc, red);
        float std_c[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) std_c[j] = fmaxf(sqrtf(x[j] / mf), 1e-30f);
#pragma unroll
        for (int j = 0; j < kSums; ++j) x[j] = 0.f;
        for (int i = tid; i < n; i += threads) {
            const bool r = rel[i] != 0;
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                if (j < kc) {
                    const float z = (r ? vals[(c0 + j) * n + i] - mean[j] : 0.f) / std_c[j];
                    const float z2 = z * z;
                    x[2 * j] += z2 * z;
                    x[2 * j + 1] += z2 * z2;
                }
            }
        }
        block_sums(x, 2 * kc, red);
        if (tid == 0) {
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                if (j >= kc) continue;
                const int c = c0 + j;
                moments[c] = x[2 * j] * mf / ((mf - 1.0f) * (mf - 2.0f));
                const float t1 = x[2 * j + 1] * mf * (mf + 1.0f) / (mf - 1.0f);
                moments[dim + c] =
                    (t1 - 3.0f * (mf - 1.0f) * (mf - 1.0f)) / ((mf - 2.0f) * (mf - 3.0f));
            }
        }
    }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the kernel takes for an [n, dim] fleet.
size_t svoc_fused_consensus_smem_bytes(int n, int dim) { return fused_layout(n, dim).bytes; }

// Launches the kernel on `stream` and returns cudaGetLastError(). The
// caller checks shapes, dtypes and the shared-memory need first.
int svoc_fused_consensus(const float* values, float* essence, float* essence1,
                         float* rel, uint8_t* mask, float* qr, float* moments, int n, int dim,
                         int m, int r_lo_all, int r_hi_all, int r_lo_rel, int r_hi_rel,
                         int constrained, float max_spread, void* stream) {
    const size_t smem = svoc_fused_consensus_smem_bytes(n, dim);
    if (smem > svoc::kSmallSmemBytes) {  // once per device, to the most any fleet may take
        static svoc::SmemLimit limit;
        const cudaError_t err = limit.ensure(fused_consensus_kernel, svoc::kMaxSmemBytes);
        if (err != cudaSuccess) return (int)err;
    }
    int threads = ((n + 31) / 32) * 32;
    threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
    fused_consensus_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        values, essence, essence1, rel, mask, qr, moments, n, dim, m, r_lo_all, r_hi_all,
        r_lo_rel, r_hi_rel, constrained, max_spread);
    return (int)cudaGetLastError();
}

}  // extern "C"
