// Gated two-pass Cairo-order consensus over a claim cube, for Hopper
// (sm_90a), with a plain C interface for ctypes.
//
// Replaces svoc_tpu/ops/pallas_consensus.py::_gated_claims_kernel (line
// 411), the Pallas TPU kernel behind fused_consensus_gated_claims (line
// 608). Its plain PyTorch version is
// svoc_torch/ops/fused_consensus.py::fused_consensus_gated_claims_plain.
// Per claim it computes what consensus_step_gated computes
// (svoc_tpu/consensus/kernel.py:138-210), op for op: the neutral fill,
// the first pass over the admitted rows, the gated ranking, the second
// pass over the reliable rows, the moments with clamped denominators,
// interval_valid, and the isfinite zeroing of both essences.
//
// What bounds it: nothing the card is short of. A [64, 1024, 6] cube is
// about 2 MB in and out, under a microsecond of memory traffic; the work
// is 13 sorts of 1024 keys per claim. What costs time is latency: the
// barriers between the steps of the sorts inside each block. The claims
// run side by side, one block each, so a cube of up to 132 claims takes
// about the time of one.
//
// Design:
// - One thread block per claim. The claim's [N, M] block, neutral-filled
//   (a quarantined row or a non-finite value reads 0), is staged once in
//   shared memory, with the admission and reliability flags beside it.
// - Order statistics come from B2's in-shared-memory bitonic sort of
//   (key, index) pairs in the Cairo order: ascending key, ties by
//   DESCENDING index. Masked rows key +inf. The power-of-two padding
//   slots key +inf too, with negative indices, so they lose every tie and
//   sort after every real row, +inf ones included: the order is
//   (key, is_padding, -index).
// - The counts are read at run time in the block: n_ok from the
//   admission mask, n_rel from the reliability mask. The smooth median
//   reads the KEYS at ranks clip(count/2 - 1, 0, N-1) and
//   clip(count/2, 0, N-1), so a rank that lands on a masked row reads
//   the +inf sentinel, as the TPU kernel's _masked_value_at_rank keeps
//   it (an all-quarantined claim has essence1 = +inf and risks +inf
//   before the essences are zeroed). The reliability cut is
//   rank < n_ok - n_failing, and a row must also be admitted; the cut
//   may be negative, and then no row is reliable.
// - The quadratic risk of each row is summed in column order with
//   __fsub_rn/__fmul_rn/__fadd_rn, as in B2, so the plain version rounds
//   it the same way and the risk ranking matches it exactly.
// - A mask selects: a masked row adds an exact 0 even where its risk is
//   +inf, as the reference's product with a boolean mask (a select in
//   XLA) does.
// - Padding claims (claim_mask false) write the outputs that
//   _mask_padded_claims gives them (zeros, no reliable row, invalid) and
//   return at once.
// - Built without --use_fast_math: IEEE inf and NaN semantics hold.
//
// Shared memory: 4 * (N*M + 2*NP + 3*N + M) bytes, NP = N rounded up to
// a power of two (svoc_gated_claims_smem_bytes, the one place that knows
// the layout); the wrapper asks it and refuses a fleet whose need
// exceeds one block's 227 KB.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ bool interval_ok(float x) { return x >= 0.0f && x <= 1.0f; }

// Sorts column c of vals with the rows whose keep[] flag is 0 keyed +inf,
// and returns the mean of the KEYS at ranks clip(count/2 - 1) and
// clip(count/2): the Cairo smooth median of the `count` kept rows
// (math.cairo:113-126), +inf where a rank lands on a dropped row. Same
// result in every thread.
__device__ float gated_column_median(const float* vals, const int* keep, float* key, int* idx,
                                     int n, int np, int dim, int c, int count) {
    __syncthreads();  // key/idx free: the previous sort's readers are done
    for (int i = threadIdx.x; i < np; i += blockDim.x) {
        if (i < n) {
            key[i] = keep[i] ? vals[i * dim + c] : INFINITY;
            idx[i] = i;
        } else {
            key[i] = INFINITY;
            idx[i] = -1 - (i - n);
        }
    }
    __syncthreads();
    cairo_sort(key, idx, np);
    const int mid = count / 2;
    const int lo = min(max(mid - 1, 0), n - 1);
    const int hi = min(max(mid, 0), n - 1);
    return (key[lo] + key[hi]) * 0.5f;
}

__global__ void __launch_bounds__(kMaxThreads)
gated_claims_kernel(const float* __restrict__ values, const uint8_t* __restrict__ ok_in,
                    const uint8_t* __restrict__ claim_mask, float* __restrict__ essence,
                    float* __restrict__ essence1, float* __restrict__ rel1_out,
                    float* __restrict__ rel2_out, uint8_t* __restrict__ reliable_out,
                    float* __restrict__ qr_out, float* __restrict__ skew_out,
                    float* __restrict__ kurt_out, uint8_t* __restrict__ valid_out, int n,
                    int np, int dim, int n_failing, int constrained, float max_spread) {
    // Layout sized by svoc_gated_claims_smem_bytes.
    extern __shared__ float smem[];
    float* vals = smem;                               // [n * dim] neutral-filled
    float* key = vals + n * dim;                      // [np]
    int* idx = reinterpret_cast<int*>(key + np);      // [np]
    float* qr = reinterpret_cast<float*>(idx + np);   // [n]
    int* ok = reinterpret_cast<int*>(qr + n);         // [n] admitted
    int* rel = ok + n;                                // [n] reliable
    float* ess1 = reinterpret_cast<float*>(rel + n);  // [dim]
    __shared__ float red[32];

    const int c = blockIdx.x;
    const size_t row0 = (size_t)c * n;  // this claim's first row
    float* essence_c = essence + (size_t)c * dim;
    float* essence1_c = essence1 + (size_t)c * dim;
    float* skew_c = skew_out + (size_t)c * dim;
    float* kurt_c = kurt_out + (size_t)c * dim;

    if (!claim_mask[c]) {
        // A padding claim: what _mask_padded_claims makes of any output.
        for (int e = threadIdx.x; e < dim; e += blockDim.x) {
            essence_c[e] = 0.f;
            essence1_c[e] = 0.f;
            skew_c[e] = 0.f;
            kurt_c[e] = 0.f;
        }
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            reliable_out[row0 + i] = 0;
            qr_out[row0 + i] = 0.f;
        }
        if (threadIdx.x == 0) {
            rel1_out[c] = 0.f;
            rel2_out[c] = 0.f;
            valid_out[c] = 0;
        }
        return;
    }

    // ---- Neutral fill, before any arithmetic (0 * NaN is NaN) ----
    float admitted = 0.f;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int a = ok_in[row0 + i] != 0;
        ok[i] = a;
        admitted += (float)a;
    }
    const float n_ok_f = block_sum(admitted, red);  // its barrier publishes ok[]
    const int n_ok = (int)n_ok_f;
    for (int e = threadIdx.x; e < n * dim; e += blockDim.x) {
        const float v = values[row0 * dim + e];
        vals[e] = (ok[e / dim] && isfinite(v)) ? v : 0.f;
    }

    // ---- FIRST PASS over the admitted rows ----
    for (int col = 0; col < dim; ++col) {
        const float med = gated_column_median(vals, ok, key, idx, n, np, dim, col, n_ok);
        if (threadIdx.x == 0) ess1[col] = med;
    }
    __syncthreads();

    float qr_ok_sum = 0.f;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        float acc = 0.f;
        for (int col = 0; col < dim; ++col) {
            const float d = __fsub_rn(vals[i * dim + col], ess1[col]);
            acc = __fadd_rn(acc, __fmul_rn(d, d));
        }
        qr[i] = acc;
        qr_out[row0 + i] = acc;
        if (ok[i]) qr_ok_sum += acc;
    }
    const float rel1 = reliability(block_sum(qr_ok_sum, red) / fmaxf(n_ok_f, 1.f), dim,
                                   constrained, max_spread);

    // ---- Gated ranking: quarantined rows key +inf, the cut counts from
    // n_ok (sort_ops.gated_reliability_mask). block_sum's barriers above
    // have retired every reader of key[] and published qr[]. ----
    for (int i = threadIdx.x; i < np; i += blockDim.x) {
        key[i] = (i < n && ok[i]) ? qr[i] : INFINITY;
        idx[i] = i < n ? i : -1 - (i - n);
    }
    __syncthreads();
    cairo_sort(key, idx, np);
    const int cut = n_ok - n_failing;
    float reliable = 0.f;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
        const int row = idx[p];
        const int r = (p < cut && ok[row]) ? 1 : 0;
        rel[row] = r;
        reliable_out[row0 + row] = (uint8_t)r;
        reliable += (float)r;
    }
    const float n_rel = block_sum(reliable, red);  // its barrier publishes rel[]
    const float denom = fmaxf(n_rel, 1.f);

    // ---- SECOND PASS over the reliable rows (risk still centred on
    // essence1: contract.cairo:414, :484) ----
    for (int col = 0; col < dim; ++col) {
        float part = 0.f;
        for (int i = threadIdx.x; i < n; i += blockDim.x)
            part += rel[i] ? vals[i * dim + col] : 0.f;
        const float mean_c = block_sum(part, red) / denom;
        float ess2 = mean_c;  // unconstrained mode: the mean
        if (constrained)
            ess2 = gated_column_median(vals, rel, key, idx, n, np, dim, col, (int)n_rel);

        // Moments of the reliable rows, count-clamped denominators
        // (stats.masked_* formula for formula).
        float sq = 0.f;
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const float d = rel[i] ? vals[i * dim + col] - mean_c : 0.f;
            sq += d * d;
        }
        const float sd = fmaxf(sqrtf(block_sum(sq, red) / denom), 1e-30f);
        float s3 = 0.f, s4 = 0.f;
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const float z = rel[i] ? (vals[i * dim + col] - mean_c) / sd : 0.f;
            const float z2 = z * z;
            s3 += z2 * z;
            s4 += z2 * z2;
        }
        s3 = block_sum(s3, red);
        s4 = block_sum(s4, red);
        if (threadIdx.x == 0) {
            essence_c[col] = isfinite(ess2) ? ess2 : 0.f;
            skew_c[col] = s3 * n_rel / fmaxf((n_rel - 1.0f) * (n_rel - 2.0f), 1.0f);
            const float t1 = s4 * n_rel * (n_rel + 1.0f) / fmaxf(n_rel - 1.0f, 1.0f);
            kurt_c[col] = (t1 - 3.0f * (n_rel - 1.0f) * (n_rel - 1.0f)) /
                          fmaxf((n_rel - 2.0f) * (n_rel - 3.0f), 1.0f);
        }
    }

    float rel_qr = 0.f;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
        rel_qr += rel[i] ? qr[i] : 0.f;  // a reliable row is admitted
    const float rel2 = reliability(block_sum(rel_qr, red) / denom, dim, constrained, max_spread);
    if (threadIdx.x == 0) {
        for (int col = 0; col < dim; ++col)
            essence1_c[col] = isfinite(ess1[col]) ? ess1[col] : 0.f;
        rel1_out[c] = rel1;
        rel2_out[c] = rel2;
        valid_out[c] = (uint8_t)(interval_ok(rel1) && interval_ok(rel2) && n_ok >= 2 &&
                                 n_rel >= 2.0f);
    }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the kernel takes for an [n, dim] fleet.
size_t svoc_gated_claims_smem_bytes(int n, int dim) {
    const size_t np = (size_t)pow2_at_least(n);
    return sizeof(float) * ((size_t)n * dim + 2 * np + 3 * (size_t)n + dim);
}

// Launches one block per claim on `stream` and returns cudaGetLastError().
// The caller checks shapes, dtypes and the shared-memory need first.
int svoc_gated_claims_consensus(const float* values, const uint8_t* ok,
                                const uint8_t* claim_mask, float* essence, float* essence1,
                                float* rel1, float* rel2, uint8_t* reliable, float* qr,
                                float* skew, float* kurt, uint8_t* valid, int claims, int n,
                                int dim, int n_failing, int constrained, float max_spread,
                                void* stream) {
    const int np = pow2_at_least(n);
    const size_t smem = svoc_gated_claims_smem_bytes(n, dim);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            gated_claims_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    int threads = ((n + 31) / 32) * 32;
    threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
    gated_claims_kernel<<<claims, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        values, ok, claim_mask, essence, essence1, rel1, rel2, reliable, qr, skew, kurt, valid,
        n, np, dim, n_failing, constrained, max_spread);
    return (int)cudaGetLastError();
}

}  // extern "C"
