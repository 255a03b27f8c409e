// Rank selection in the Cairo order inside one thread block, for Hopper
// (sm_90a): the order statistics of the consensus kernels
// (fused_consensus.cu; written to be shared with gated_claims_consensus.cu).
//
// The Cairo contract sorts ascending by key with ties in DESCENDING index
// (contract/src/sort.cairo; svoc_torch/ops/sort.py::cairo_rank). A kernel
// needs only a few ranks of that order: the two ranks of a smooth median
// per column and the cut of the risk ranking. So instead of sorting it
// selects them: a most-significant-digit radix select over one composite
// key per element,
//
//   composite(key, i) = ord(key) << L | (n - 1 - i),   L = bits of n - 1,
//
// where ord maps a float to a uint32 in the same order (-0.0 folded into
// +0.0 first, so that the two tie as `<` makes them; +inf above every
// finite key). Composite keys are distinct, ascending in the Cairo order,
// and carry the element's index in their low L bits.
//
// One call answers up to kQueries (key column, rank) queries at once.
// Each pass histograms the next 8-bit digit (from the top) of every key
// that shares a query's known top bits (one block-wide pass for all
// queries; queries that read the same keys compute them once), then one
// warp per query finds the digit whose bin holds the rank. A bin counts
// its keys in its low 16 bits and adds their indices above them, so a bin
// that holds one key also names it, and the query closes there. Two
// barriers a pass, at most ceil((32 + L) / 8) passes (6 at n = 1024;
// random data closes in about 3); the cost does not grow with the number
// of queries in a call the way one sort per column does. Plain shared
// atomics: aggregating them per warp with __match_any_sync cost more than
// it saved (measured on an H100).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cairo {

constexpr unsigned FULL = 0xffffffffu;
constexpr int kQueries = 16;         // queries one call answers at most
constexpr int kBins = 256;           // one 8-bit digit
constexpr uint64_t kNone = ~0ull;    // the answer to a rank outside [0, n)

// a < b as floats (neither NaN) iff ord(a) < ord(b); ord(-0.0) == ord(+0.0).
__device__ __forceinline__ uint32_t ord(float f) {
    uint32_t u = __float_as_uint(f);
    if (u == 0x80000000u) u = 0u;
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The bits the index part of a composite key takes for n elements.
__host__ __device__ __forceinline__ int index_bits(int n) {
    int bits = 0;
    while (bits < 31 && (1 << bits) < n) ++bits;
    return bits;
}

__device__ __forceinline__ uint64_t composite(float key, int i, int n, int lbits) {
    return ((uint64_t)ord(key) << lbits) | (uint64_t)(n - 1 - i);
}

// The index that a composite key carries.
__device__ __forceinline__ int row_of(uint64_t c, int n, int lbits) {
    return n - 1 - (int)(c & ((1ull << lbits) - 1));
}

// Shared working space of select_ranks.
struct Scratch {
    unsigned hist[2][kQueries][kBins];  // alternate between passes: count | index sum << 16
    uint64_t pre[kQueries];             // the answer's known top bits
    uint64_t answer[kQueries];
    int rank[kQueries];                 // its rank among the keys that share them
    int low[kQueries];                  // low bits still unknown; -1: rank out of range
    int open[kQueries];                 // 1 while more than one key shares them
};

// For each query q < nq (nq <= kQueries): ws.answer[q] = the composite key
// of rank rank_of(q) (0-based, Cairo order) among the n composite keys
// composite(key(q, i), i), i < n (n < 65536); kNone for a rank outside
// [0, n). Queries come in groups of PerKey (nq a multiple of it) that
// read the same keys: key(q, i) is called for the first query of each
// group only. Every thread of the block calls it with the same arguments
// (blockDim.x a multiple of 32); key reads only what the block wrote
// before the call. It starts and ends with a barrier.
template <int PerKey, typename Key, typename Rank>
__device__ void select_ranks(const Key& key, const Rank& rank_of, int n, int nq, Scratch& ws) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int threads = blockDim.x, warps = threads >> 5;
    const int lbits = index_bits(n);
    __syncthreads();  // the keys are written, the last call's answers read
    for (int e = tid; e < nq * kBins; e += threads) (&ws.hist[0][0][0])[e] = 0u;
    if (tid < nq) {  // buffer 1 is cleared by the first pass's scan
        const int r = rank_of(tid);
        const bool in = r >= 0 && r < n;
        ws.pre[tid] = 0;
        ws.answer[tid] = kNone;
        ws.rank[tid] = in ? r : 0;
        ws.low[tid] = in ? 32 + lbits : -1;
        ws.open[tid] = in;
    }
    __syncthreads();

    for (int pass = 0;; ++pass) {
        unsigned(*hist)[kBins] = ws.hist[pass & 1];
        // The next digit of every key that shares a query's known bits.
        for (int g = 0; g < nq; g += PerKey) {
            bool open[PerKey], any = false;  // the same in every thread
            int top[PerKey], shift[PerKey];
            uint64_t pre[PerKey];
#pragma unroll
            for (int j = 0; j < PerKey; ++j) {
                open[j] = ws.open[g + j] != 0;
                top[j] = ws.low[g + j];
                shift[j] = top[j] > 8 ? top[j] - 8 : 0;
                pre[j] = ws.pre[g + j];
                any |= open[j];
            }
            if (!any) continue;
            for (int i = tid; i < n; i += threads) {
                const uint64_t c = composite(key(g, i), i, n, lbits);
#pragma unroll
                for (int j = 0; j < PerKey; ++j) {
                    if (open[j] && (c >> top[j]) == pre[j]) {
                        const unsigned d =
                            (unsigned)(c >> shift[j]) & ((1u << (top[j] - shift[j])) - 1u);
                        atomicAdd(&hist[g + j][d], 1u | ((unsigned)i << 16));
                    }
                }
            }
        }
        __syncthreads();

        // One warp per query: the bin that holds its rank.
        for (int q = warp; q < nq; q += warps) {
            if (!ws.open[q]) continue;  // the same in every lane
            const int top = ws.low[q], shift = top > 8 ? top - 8 : 0;
            const uint64_t pre = ws.pre[q];
            const unsigned r = (unsigned)ws.rank[q];
            const uint4 a = *reinterpret_cast<const uint4*>(&hist[q][lane * 8]);
            const uint4 b = *reinterpret_cast<const uint4*>(&hist[q][lane * 8 + 4]);
            const unsigned h[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
            unsigned c[8], sum = 0;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                c[j] = h[j] & 0xffffu;
                sum += c[j];
            }
            unsigned incl = sum;  // inclusive scan over the lanes
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const unsigned y = __shfl_up_sync(FULL, incl, off);
                if (lane >= off) incl += y;
            }
            const unsigned below_lane = incl - sum;
            __syncwarp();  // every lane has read the query's state
            if (below_lane <= r && r < incl) {  // exactly one lane
                unsigned below = below_lane, count = 0, owner = 0;
                int bin = 0;
                bool found = false;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    if (!found) {
                        if (r < below + c[j]) {
                            found = true;
                            bin = lane * 8 + j;
                            count = c[j];
                            owner = h[j] >> 16;  // the index of its one key when count is 1
                        } else {
                            below += c[j];
                        }
                    }
                }
                ws.pre[q] = (pre << (top - shift)) | (uint64_t)bin;
                ws.rank[q] = (int)(r - below);
                ws.low[q] = shift;
                ws.open[q] = count > 1;
                if (count == 1) {
                    const int i = (int)owner, first = q - q % PerKey;
                    ws.answer[q] = composite(key(first, i), i, n, lbits);
                }
            }
            // The other buffer is the next pass's: clear this query's bins.
            *reinterpret_cast<uint4*>(&ws.hist[(pass & 1) ^ 1][q][lane * 8]) = make_uint4(0, 0, 0, 0);
            *reinterpret_cast<uint4*>(&ws.hist[(pass & 1) ^ 1][q][lane * 8 + 4]) = make_uint4(0, 0, 0, 0);
        }
        __syncthreads();
        bool more = false;
        for (int q = 0; q < nq; ++q) more |= ws.open[q] != 0;
        if (!more) break;
    }
}

}  // namespace cairo
