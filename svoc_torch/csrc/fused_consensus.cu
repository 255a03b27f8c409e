// Fused two-pass Cairo-order consensus over one oracle fleet, for Hopper
// (sm_90a), with a plain C interface for ctypes.
//
// Replaces svoc_tpu/ops/pallas_consensus.py::_consensus_kernel (line 209),
// the Pallas TPU kernel behind fused_consensus (line 339). Its plain
// PyTorch version is svoc_torch/ops/fused_consensus.py::fused_consensus_plain.
//
// What bounds it: nothing the card is short of. At the flagship fleet
// (N = 1024 oracles, M = 6) the inputs are 24.6 KB and the outputs about
// 12 KB, well under a microsecond of memory traffic; the work is 13 sorts
// of 1024 keys. What costs time is latency: one launch, and the barriers
// between the steps of the sorts, inside one block on one SM.
//
// Design:
// - One thread block per fleet. values [N, M] is staged once in shared
//   memory and every step reads it there.
// - Order statistics come from an in-shared-memory bitonic sort of
//   (key, index) pairs in the exact Cairo order: ascending key, ties by
//   DESCENDING index (contract/src/sort.cairo; the TPU kernel counted
//   ranks with (k_j < k_i) || (k_j == k_i && j > i), because Mosaic has
//   no sort). Position p of the sorted array is rank p, so selection by
//   rank is a read. Padding up to a power of two sorts last: key +inf
//   and negative indices, which lose every tie with a real index.
// - Masked rows (the unreliable oracles in the second pass) are keyed
//   +inf, as in the TPU kernel; the value read at a rank is the row's
//   own value, not its key, and a rank outside [0, N) reads 0, which is
//   what the TPU kernel's one-hot selection gives.
// - The quadratic risk of each row is summed in column order with
//   __fmul_rn/__fadd_rn, so that no contraction into an FMA can move a
//   near-tie in the risk ranking away from the plain version's order.
// - Block reductions are fp32: a warp shuffle, then one partial sum per
//   warp added in warp order by every thread.
//
// Shared memory: 4 * (N*M + 2*NP + 2*N + M) bytes, NP = N rounded up to
// a power of two (svoc_fused_consensus_smem_bytes, the one place that
// knows the layout); the wrapper asks it and refuses a fleet whose need
// exceeds one block's 227 KB. The TPU-only limits (N % 128 == 0,
// N <= 1024) do not apply.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 1024;

int pow2_at_least(int n) {
    int np = 1;
    while (np < n) np <<= 1;
    return np;
}

// a sorts strictly before b in the Cairo order.
__device__ __forceinline__ bool cairo_before(float ka, int ia, float kb, int ib) {
    return ka < kb || (ka == kb && ia > ib);
}

// Bitonic sort of key[0, np) with idx[] riding along; np is a power of two.
// Ends with a barrier.
__device__ void cairo_sort(float* key, int* idx, int np) {
    for (int k = 2; k <= np; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = threadIdx.x; i < np; i += blockDim.x) {
                const int ixj = i ^ j;
                if (ixj > i) {
                    const bool ascending = (i & k) == 0;
                    const bool out_of_order =
                        ascending ? cairo_before(key[ixj], idx[ixj], key[i], idx[i])
                                  : cairo_before(key[i], idx[i], key[ixj], idx[ixj]);
                    if (out_of_order) {
                        const float tk = key[i];
                        key[i] = key[ixj];
                        key[ixj] = tk;
                        const int ti = idx[i];
                        idx[i] = idx[ixj];
                        idx[ixj] = ti;
                    }
                }
            }
            __syncthreads();
        }
    }
}

// Sum of x over the block, the same value in every thread.
__device__ float block_sum(float x, float* red) {
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();  // red[] is free: every thread has read the last call's sums
    if (lane == 0) red[warp] = x;
    __syncthreads();
    float total = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += red[w];
    return total;
}

__device__ __forceinline__ float reliability(float mean_qr, int dim, int constrained,
                                             float max_spread) {
    if (constrained) return 1.0f - 2.0f * sqrtf(mean_qr / (float)dim);
    return 1.0f - fminf(max_spread, sqrtf(mean_qr)) / max_spread;
}

// Sorts column c of vals (rows with rel[i] == 0 keyed +inf when rel is
// given) and returns the mean of the values at ranks r_lo and r_hi: the
// Cairo smooth median (math.cairo:113-126). Same result in every thread.
__device__ float column_smooth_median(const float* vals, const int* rel, float* key,
                                      int* idx, int n, int np, int dim, int c,
                                      int r_lo, int r_hi) {
    __syncthreads();  // key/idx free: the previous sort's readers are done
    for (int i = threadIdx.x; i < np; i += blockDim.x) {
        if (i < n) {
            key[i] = (rel == nullptr || rel[i]) ? vals[i * dim + c] : INFINITY;
            idx[i] = i;
        } else {
            key[i] = INFINITY;
            idx[i] = -1 - (i - n);
        }
    }
    __syncthreads();
    cairo_sort(key, idx, np);
    const float a = (r_lo >= 0 && r_lo < n) ? vals[idx[r_lo] * dim + c] : 0.f;
    const float b = (r_hi >= 0 && r_hi < n) ? vals[idx[r_hi] * dim + c] : 0.f;
    return (a + b) * 0.5f;
}

__global__ void __launch_bounds__(kMaxThreads)
fused_consensus_kernel(const float* __restrict__ values, float* __restrict__ essence,
                       float* __restrict__ essence1, float* __restrict__ rel_out,
                       int* __restrict__ mask_out, float* __restrict__ qr_out,
                       float* __restrict__ moments, int n, int np, int dim, int m,
                       int r_lo_all, int r_hi_all, int r_lo_rel, int r_hi_rel,
                       int constrained, float max_spread) {
    // Layout sized by svoc_fused_consensus_smem_bytes.
    extern __shared__ float smem[];
    float* vals = smem;                             // [n * dim]
    float* key = vals + n * dim;                    // [np]
    int* idx = reinterpret_cast<int*>(key + np);    // [np]
    float* qr = reinterpret_cast<float*>(idx + np); // [n]
    int* rel = reinterpret_cast<int*>(qr + n);      // [n]
    float* ess1 = reinterpret_cast<float*>(rel + n);  // [dim]
    __shared__ float red[32];

    for (int e = threadIdx.x; e < n * dim; e += blockDim.x) vals[e] = values[e];
    __syncthreads();

    // ---- FIRST PASS: smooth median of every column over all N ----
    for (int c = 0; c < dim; ++c) {
        const float med =
            column_smooth_median(vals, nullptr, key, idx, n, np, dim, c, r_lo_all, r_hi_all);
        if (threadIdx.x == 0) {
            ess1[c] = med;
            essence1[c] = med;
        }
    }
    __syncthreads();

    float qr_sum = 0.f;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        float acc = 0.f;
        for (int c = 0; c < dim; ++c) {
            const float d = __fsub_rn(vals[i * dim + c], ess1[c]);
            acc = __fadd_rn(acc, __fmul_rn(d, d));
        }
        qr[i] = acc;
        qr_out[i] = acc;
        qr_sum += acc;
    }
    const float rel1 = reliability(block_sum(qr_sum, red) / (float)n, dim, constrained,
                                   max_spread);

    // Worst n_failing by risk are unreliable (contract.cairo:345-363).
    for (int i = threadIdx.x; i < np; i += blockDim.x) {
        key[i] = i < n ? qr[i] : INFINITY;
        idx[i] = i < n ? i : -1 - (i - n);
    }
    __syncthreads();
    cairo_sort(key, idx, np);
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
        const int r = p < m ? 1 : 0;
        rel[idx[p]] = r;
        mask_out[idx[p]] = r;
    }
    __syncthreads();

    // ---- SECOND PASS over the reliable subset (m = n - n_failing) ----
    const float mf = (float)m;
    for (int c = 0; c < dim; ++c) {
        float part = 0.f;
        for (int i = threadIdx.x; i < n; i += blockDim.x)
            part += rel[i] ? vals[i * dim + c] : 0.f;
        const float mean_c = block_sum(part, red) / mf;
        float ess2 = mean_c;  // unconstrained mode: the mean
        if (constrained)
            ess2 = column_smooth_median(vals, rel, key, idx, n, np, dim, c, r_lo_rel,
                                        r_hi_rel);

        // Moments of the reliable subset (contract.cairo:491-500).
        float sq = 0.f;
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const float d = rel[i] ? vals[i * dim + c] - mean_c : 0.f;
            sq += d * d;
        }
        const float std_c = fmaxf(sqrtf(block_sum(sq, red) / mf), 1e-30f);
        float s3 = 0.f, s4 = 0.f;
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const float z = (rel[i] ? vals[i * dim + c] - mean_c : 0.f) / std_c;
            const float z2 = z * z;
            s3 += z2 * z;
            s4 += z2 * z2;
        }
        s3 = block_sum(s3, red);
        s4 = block_sum(s4, red);
        if (threadIdx.x == 0) {
            essence[c] = ess2;
            moments[c] = s3 * mf / ((mf - 1.0f) * (mf - 2.0f));
            const float t1 = s4 * mf * (mf + 1.0f) / (mf - 1.0f);
            moments[dim + c] =
                (t1 - 3.0f * (mf - 1.0f) * (mf - 1.0f)) / ((mf - 2.0f) * (mf - 3.0f));
        }
    }

    // Second-pass risk stays centred on essence1 (contract.cairo:414, :484).
    float rel_qr = 0.f;
    for (int i = threadIdx.x; i < n; i += blockDim.x) rel_qr += rel[i] ? qr[i] : 0.f;
    const float rel2 = reliability(block_sum(rel_qr, red) / mf, dim, constrained, max_spread);
    if (threadIdx.x == 0) {
        rel_out[0] = rel1;
        rel_out[1] = rel2;
    }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the kernel takes for an [n, dim] fleet.
size_t svoc_fused_consensus_smem_bytes(int n, int dim) {
    const size_t np = (size_t)pow2_at_least(n);
    return sizeof(float) * ((size_t)n * dim + 2 * np + 2 * (size_t)n + dim);
}

// Launches the kernel on `stream` and returns cudaGetLastError(). The
// caller checks shapes, dtypes and the shared-memory need first.
int svoc_fused_consensus(const float* values, float* essence, float* essence1,
                         float* rel, int* mask, float* qr, float* moments, int n, int dim,
                         int m, int r_lo_all, int r_hi_all, int r_lo_rel, int r_hi_rel,
                         int constrained, float max_spread, void* stream) {
    const int np = pow2_at_least(n);
    const size_t smem = svoc_fused_consensus_smem_bytes(n, dim);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            fused_consensus_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    int threads = ((n + 31) / 32) * 32;
    threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
    fused_consensus_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        values, essence, essence1, rel, mask, qr, moments, n, np, dim, m, r_lo_all,
        r_hi_all, r_lo_rel, r_hi_rel, constrained, max_spread);
    return (int)cudaGetLastError();
}

}  // extern "C"
