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
// about 2 MB in and out, under a microsecond of memory traffic. What
// costs time is latency: the barriers between the dependent steps inside
// each block. The claims run side by side, one block each, so a cube of
// up to 132 claims takes about the time of one.
//
// Design, and why (fused_consensus.cu is the same kernel for one fleet
// without the gate; both read their ranks from cairo_select.cuh):
// - One thread block per claim. Padding claims (claim_mask false) write
//   what _mask_padded_claims makes of them (zeros, no reliable row,
//   invalid) and return at once.
// - The neutral fill comes before any arithmetic: a quarantined row or a
//   non-finite value reads 0. The claim's [N, M] block is staged once in
//   shared memory, column by column, with the admission and reliability
//   flags beside it. The fill is also what makes the select legal: every
//   key it sees is a filled value, +inf, or a risk computed from filled
//   values (finite or +inf, never NaN).
// - Only three steps depend on one another: the first-pass medians, the
//   risk ranking and the second-pass medians. Each reads a few ranks of
//   the Cairo order (ascending key, ties by DESCENDING index), never the
//   whole order, so each is one radix select of all its ranks at once
//   (a composite key of the float's order bits over the inverted index:
//   no two keys tie, and -0.0 ties with +0.0 as `<` makes it): a few
//   barriers a pass and about three passes, where sorting each column
//   would take 13 sorting networks a claim of 55 stages each at N = 1024,
//   every stage ending in a barrier.
// - The counts are read at run time in the block: n_ok from the
//   admission flags, n_rel from the reliability flags. A smooth median
//   reads the KEYS at ranks clip(count/2 - 1, 0, N-1) and
//   clip(count/2, 0, N-1), masked rows keyed +inf, so a rank that lands
//   on a masked row reads the +inf sentinel, as the TPU kernel's
//   _masked_value_at_rank keeps it (an all-quarantined claim has
//   essence1 = +inf and risks +inf before the essences are zeroed).
// - The reliable rows are the admitted rows whose composite risk key
//   (quarantined rows keyed +inf) lies below the key at rank
//   cut = n_ok - n_failing: none when cut <= 0, every admitted row when
//   cut >= N.
// - The quadratic risk of each row is summed in column order with
//   __fsub_rn/__fmul_rn/__fadd_rn, so the plain version rounds it the
//   same way and the risk ranking matches it exactly.
// - A mask selects: a masked row adds an exact 0 even where its risk is
//   +inf, as the reference's product with a boolean mask (a select in
//   XLA) does.
// - The counts and sums take few block reductions of up to 16 values
//   each, finished by warp 0 in warp order: n_ok alone; then, per group
//   of up to 8 columns, the reliable column sums (with n_rel and both
//   risk sums in the first group), the squares, and s3 with s4.
// - Built without --use_fast_math: IEEE inf and NaN semantics hold.
//
// Shared memory: gated_layout(n, dim) below, the one place that knows it
// (svoc_gated_claims_smem_bytes returns its size): 4 (M + 3) N bytes
// plus about 35 KB of select and reduction scratch, so N up to 5474 at
// M = 6 fits one block's 227 KB (the first port's layout took N up to
// 4635). The wrapper refuses a fleet whose need exceeds it. Above 48 KB the
// launcher raises the kernel's limit to those 227 KB once per device
// (smem_limit.cuh).

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
    size_t vals, qr, ok, rel, ess1, red, select, bytes;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Byte offsets into dynamic shared memory for one claim's [n, dim] block.
__host__ __device__ inline Layout gated_layout(int n, int dim) {
    Layout l;
    l.vals = 0;                                               // [dim][n] float, neutral-filled
    l.qr = l.vals + sizeof(float) * (size_t)n * dim;          // [n] float
    l.ok = l.qr + sizeof(float) * (size_t)n;                  // [n] int: admitted
    l.rel = l.ok + sizeof(int) * (size_t)n;                   // [n] int: reliable
    l.ess1 = l.rel + sizeof(int) * (size_t)n;                 // [dim] float
    l.red = align16(l.ess1 + sizeof(float) * (size_t)dim);    // [33][kSums] float
    l.select = align16(l.red + sizeof(float) * 33 * kSums);   // cairo::Scratch, read as uint4
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

__device__ __forceinline__ bool interval_ok(float x) { return x >= 0.0f && x <= 1.0f; }

// The ranks of the Cairo smooth median of `count` kept rows
// (math.cairo:113-126), clipped into [0, n).
__device__ __forceinline__ int median_rank(int count, int hi, int n) {
    const int r = count / 2 - (hi ? 0 : 1);
    return min(max(r, 0), n - 1);
}

__global__ void __launch_bounds__(kMaxThreads)
gated_claims_kernel(const float* __restrict__ values, const uint8_t* __restrict__ ok_in,
                    const uint8_t* __restrict__ claim_mask, float* __restrict__ essence,
                    float* __restrict__ essence1, float* __restrict__ rel1_out,
                    float* __restrict__ rel2_out, uint8_t* __restrict__ reliable_out,
                    float* __restrict__ qr_out, float* __restrict__ skew_out,
                    float* __restrict__ kurt_out, uint8_t* __restrict__ valid_out, int n,
                    int dim, int n_failing, int constrained, float max_spread) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Layout L = gated_layout(n, dim);
    float* vals = reinterpret_cast<float*>(smem + L.vals);
    float* qr = reinterpret_cast<float*>(smem + L.qr);
    int* ok = reinterpret_cast<int*>(smem + L.ok);
    int* rel = reinterpret_cast<int*>(smem + L.rel);
    float* ess1 = reinterpret_cast<float*>(smem + L.ess1);
    float* red = reinterpret_cast<float*>(smem + L.red);
    cairo::Scratch& ws = *reinterpret_cast<cairo::Scratch*>(smem + L.select);
    const int tid = threadIdx.x, threads = blockDim.x;
    const int lbits = cairo::index_bits(n);

    const int claim = blockIdx.x;
    const size_t row0 = (size_t)claim * n;  // this claim's first row
    float* essence_c = essence + (size_t)claim * dim;
    float* essence1_c = essence1 + (size_t)claim * dim;
    float* skew_c = skew_out + (size_t)claim * dim;
    float* kurt_c = kurt_out + (size_t)claim * dim;

    if (!claim_mask[claim]) {
        // A padding claim: what _mask_padded_claims makes of any output.
        for (int e = tid; e < dim; e += threads) {
            essence_c[e] = 0.f;
            essence1_c[e] = 0.f;
            skew_c[e] = 0.f;
            kurt_c[e] = 0.f;
        }
        for (int i = tid; i < n; i += threads) {
            reliable_out[row0 + i] = 0;
            qr_out[row0 + i] = 0.f;
        }
        if (tid == 0) {
            rel1_out[claim] = 0.f;
            rel2_out[claim] = 0.f;
            valid_out[claim] = 0;
        }
        return;
    }

    // ---- Neutral fill, before any arithmetic (0 * NaN is NaN) ----
    float x[kSums];
#pragma unroll
    for (int j = 0; j < kSums; ++j) x[j] = 0.f;
    for (int i = tid; i < n; i += threads) {
        const int a = ok_in[row0 + i] != 0;
        ok[i] = a;
        x[0] += (float)a;
    }
    for (int e = tid; e < n * dim; e += threads) {
        const int i = e / dim;
        const float v = values[row0 * dim + e];
        vals[(e - i * dim) * n + i] = (ok_in[row0 + i] && isfinite(v)) ? v : 0.f;
    }
    block_sums(x, 1, red);  // its barriers publish ok[] and vals[]
    const int n_ok = (int)x[0];

    // The key a median reads at a selected rank: the row's value if it is
    // kept, else the +inf sentinel (never kNone: the ranks are clipped).
    auto key_at = [&](uint64_t answer, int c, const int* keep) {
        const int row = cairo::row_of(answer, n, lbits);
        return keep[row] ? vals[c * n + row] : INFINITY;
    };

    // ---- FIRST PASS: both smooth-median ranks of every column over the
    // admitted rows ----
    const int lo_ok = median_rank(n_ok, 0, n), hi_ok = median_rank(n_ok, 1, n);
    for (int c0 = 0; c0 < dim; c0 += kCols) {
        const int kc = min(kCols, dim - c0);
        cairo::select_ranks<2>(
            [&](int q, int i) { return ok[i] ? vals[(c0 + q / 2) * n + i] : INFINITY; },
            [&](int q) { return q & 1 ? hi_ok : lo_ok; }, n, 2 * kc, ws);
        if (tid < kc) {
            const int c = c0 + tid;
            ess1[c] = (key_at(ws.answer[2 * tid], c, ok) + key_at(ws.answer[2 * tid + 1], c, ok)) *
                      0.5f;
        }
    }
    __syncthreads();

    float qr_ok_sum = 0.f;
    for (int i = tid; i < n; i += threads) {
        float acc = 0.f;
        for (int c = 0; c < dim; ++c) {
            const float d = __fsub_rn(vals[c * n + i], ess1[c]);
            acc = __fadd_rn(acc, __fmul_rn(d, d));
        }
        qr[i] = acc;
        qr_out[row0 + i] = acc;
        if (ok[i]) qr_ok_sum += acc;
    }

    // ---- Gated ranking (sort_ops.gated_reliability_mask): quarantined
    // rows key +inf, the cut counts from n_ok; a reliable row is admitted
    // and its composite key lies below the one at rank cut. ----
    const int cut = n_ok - n_failing;
    uint64_t below = cut <= 0 ? 0 : cairo::kNone;
    if (cut > 0 && cut < n) {
        cairo::select_ranks<1>([&](int, int i) { return ok[i] ? qr[i] : INFINITY; },
                               [&](int) { return cut; }, n, 1, ws);
        below = ws.answer[0];
    }
    float rel_qr_sum = 0.f, n_rel_part = 0.f;
    for (int i = tid; i < n; i += threads) {
        const int r = ok[i] && cairo::composite(qr[i], i, n, lbits) < below ? 1 : 0;
        rel[i] = r;
        reliable_out[row0 + i] = (uint8_t)r;
        n_rel_part += (float)r;
        rel_qr_sum += r ? qr[i] : 0.f;  // a reliable row is admitted
    }

    // ---- SECOND PASS over the reliable rows (risk still centred on
    // essence1: contract.cairo:414, :484) ----
    int n_rel = 0;
    float rel1 = 0.f, rel2 = 0.f;
    for (int c0 = 0; c0 < dim; c0 += kCols) {
        const int kc = min(kCols, dim - c0);

        // The reliable column sums (x[0, kc)); with the first columns,
        // n_rel and both risk sums (x[kCols], x[kCols + 1], x[kCols + 2]).
        // Registers are indexed by constants only: loops over j are
        // unrolled to kCols and test j < kc. block_sums' first barrier
        // publishes rel[].
#pragma unroll
        for (int j = 0; j < kSums; ++j) x[j] = 0.f;
        for (int i = tid; i < n; i += threads) {
            const bool r = rel[i] != 0;
#pragma unroll
            for (int j = 0; j < kCols; ++j)
                if (j < kc) x[j] += r ? vals[(c0 + j) * n + i] : 0.f;
        }
        if (c0 == 0) {
            x[kCols] = n_rel_part;
            x[kCols + 1] = qr_ok_sum;
            x[kCols + 2] = rel_qr_sum;
        }
        block_sums(x, c0 == 0 ? kCols + 3 : kc, red);
        if (c0 == 0) {
            n_rel = (int)x[kCols];
            rel1 = reliability(x[kCols + 1] / fmaxf((float)n_ok, 1.f), dim, constrained, max_spread);
            rel2 = reliability(x[kCols + 2] / fmaxf((float)n_rel, 1.f), dim, constrained,
                               max_spread);
        }
        const float nr = (float)n_rel, denom = fmaxf(nr, 1.f);
        float mean[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) mean[j] = x[j] / denom;

        if (constrained) {
            const int lo = median_rank(n_rel, 0, n), hi = median_rank(n_rel, 1, n);
            cairo::select_ranks<2>(
                [&](int q, int i) { return rel[i] ? vals[(c0 + q / 2) * n + i] : INFINITY; },
                [&](int q) { return q & 1 ? hi : lo; }, n, 2 * kc, ws);
            if (tid < kc) {
                const int c = c0 + tid;
                const float ess2 =
                    (key_at(ws.answer[2 * tid], c, rel) + key_at(ws.answer[2 * tid + 1], c, rel)) *
                    0.5f;
                essence_c[c] = isfinite(ess2) ? ess2 : 0.f;
            }
        } else if (tid == 0) {
#pragma unroll
            for (int j = 0; j < kCols; ++j)  // unconstrained: the mean
                if (j < kc) essence_c[c0 + j] = isfinite(mean[j]) ? mean[j] : 0.f;
        }

        // Moments of the reliable rows, count-clamped denominators
        // (stats.masked_* formula for formula).
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
        float sd[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) sd[j] = fmaxf(sqrtf(x[j] / denom), 1e-30f);
#pragma unroll
        for (int j = 0; j < kSums; ++j) x[j] = 0.f;
        for (int i = tid; i < n; i += threads) {
            const bool r = rel[i] != 0;
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                if (j < kc) {
                    const float z = r ? (vals[(c0 + j) * n + i] - mean[j]) / sd[j] : 0.f;
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
                skew_c[c] = x[2 * j] * nr / fmaxf((nr - 1.0f) * (nr - 2.0f), 1.0f);
                const float t1 = x[2 * j + 1] * nr * (nr + 1.0f) / fmaxf(nr - 1.0f, 1.0f);
                kurt_c[c] = (t1 - 3.0f * (nr - 1.0f) * (nr - 1.0f)) /
                            fmaxf((nr - 2.0f) * (nr - 3.0f), 1.0f);
            }
        }
    }

    if (tid == 0) {
        for (int c = 0; c < dim; ++c) essence1_c[c] = isfinite(ess1[c]) ? ess1[c] : 0.f;
        rel1_out[claim] = rel1;
        rel2_out[claim] = rel2;
        valid_out[claim] = (uint8_t)(interval_ok(rel1) && interval_ok(rel2) && n_ok >= 2 &&
                                     n_rel >= 2);
    }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the kernel takes for an [n, dim] fleet.
size_t svoc_gated_claims_smem_bytes(int n, int dim) { return gated_layout(n, dim).bytes; }

// Launches one block per claim on `stream` and returns cudaGetLastError().
// The caller checks shapes, dtypes and the shared-memory need first.
int svoc_gated_claims_consensus(const float* values, const uint8_t* ok,
                                const uint8_t* claim_mask, float* essence, float* essence1,
                                float* rel1, float* rel2, uint8_t* reliable, float* qr,
                                float* skew, float* kurt, uint8_t* valid, int claims, int n,
                                int dim, int n_failing, int constrained, float max_spread,
                                void* stream) {
    const size_t smem = svoc_gated_claims_smem_bytes(n, dim);
    if (smem > svoc::kSmallSmemBytes) {  // once per device, to the most any fleet may take
        static svoc::SmemLimit limit;
        const cudaError_t err = limit.ensure(gated_claims_kernel, svoc::kMaxSmemBytes);
        if (err != cudaSuccess) return (int)err;
    }
    int threads = ((n + 31) / 32) * 32;
    threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
    gated_claims_kernel<<<claims, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        values, ok, claim_mask, essence, essence1, rel1, rel2, reliable, qr, skew, kurt, valid,
        n, dim, n_failing, constrained, max_spread);
    return (int)cudaGetLastError();
}

}  // extern "C"
