// Backward flash attention (FlashAttention-2) with integer tag masks, for
// Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces svoc_tpu/ops/pallas_attention.py::_flash_dq_kernel (line 157)
// and ::_flash_dkv_kernel (line 201), the Pallas TPU kernels that
// _flash_grads (line 311) launches under the custom VJP _flash_diff (line
// 378). Their plain PyTorch version is
// svoc_torch/ops/flash_attention.py::flash_attention_bwd_plain.
//
// Semantics (pallas_attention.py:142-249):
// - p is recomputed from the forward's per-row lse: p = exp(scale q.k -
//   lse) on a live pair (tags equal and the key's tag > 0), exactly 0 on
//   a masked pair and on a row whose lse is -inf (a dead row, which the
//   forward wrote as 0). The guard is on the lse, never on the score, so
//   exp(s - (-inf)) = inf is never used.
// - ds = p (dP - delta), with dP = dO.v and delta = rowsum(dO.O), which
//   the caller computes in fp32.
// - dq = scale sum_k ds k, dk = scale sum_q ds q, dv = sum_q p dO. The
//   backward scales the dot product (s = scale q.k, as _p_block does).
// - The outputs are written in the input type.
//
// What bounds them: at the flagship shape (B = 256 rows, T = 128, 12
// heads of 64, bf16) dq reads q, k, v, dO, lse, delta and the tags and
// writes dq, about 255 MB, 76 us at 3.35 TB/s; dk/dv writes two outputs,
// about 305 MB, 91 us; their 6 and 8 flops per head element per live
// pair take a few us on the bf16 tensor cores, so both are bound by
// bytes there. At (B, T) = (2, 8192) with every key live, dk/dv moves
// about 152 MB (45 us) and does 0.82 TFLOP (0.83 ms at 989 TFLOP/s), dq
// 0.62 TFLOP (0.63 ms): bound by the products.
//
// Each output row has one owner, so there are no atomics and the results
// are deterministic, as with the TPU's split into two kernels.
//
// The bf16 bodies run on the tensor cores (FlashAttention-2's two passes),
// mma.sync.m16n8k16 with bf16 operands and fp32 accumulators
// (tensor_core.cuh), 4 warps a block, each warp owning 16 output rows:
//
// dq, bf16: one block per (64 query rows, head, batch row). The warp's Q
// and dO fragments are read from shared memory once and held in
// registers below D = 128 (at D = 128 they stay in shared memory beside
// the accumulator and are read again for each key tile); its rows' lse
// (log2 units), delta and tags are registers. The block walks the key
// tiles (64 keys; 32 at D = 128): K, V and the key tags come in by
// cp.async, two stages in dynamic shared memory, so the next tile loads
// while this one computes. Per tile: S = Q K^T and dP = dO V^T; P =
// exp2(scale log2(e) S - log2(e) lse), chosen by a select on the tag rule
// and on a finite lse (a dead row's exp2 is inf), never a product; dS =
// P (dP - delta) in registers, rounded to bf16 as the A operand of dQ +=
// dS K (K through ldmatrix.trans).
//
// dk/dv, bf16: one block per (64 keys, head, batch row). The warp's K and
// V fragments are held in registers below D = 128 the same way. The
// block walks the query tiles (64 rows; 32 at D = 128): Q, dO, the query
// tags, lse and delta come in by cp.async in two stages. Per tile: S^T =
// K Q^T; P^T = exp2(scale log2(e) S^T - log2(e) lse), masked, 0 on rows
// whose lse is -inf; dV += P^T dO (P^T rounded to bf16 in registers, dO
// through ldmatrix.trans); dP^T = V dO^T; dS^T = P^T (dP^T - delta); dK
// += dS^T Q (dS^T rounded to bf16, Q through ldmatrix.trans).
//
// dq and dk are scaled once at the end; every output is staged through
// the warp's own rows of its Q (dq) or K and V (dk/dv) tile and stored
// with 16-byte writes. Every tile is visited and masked by tag, as in the
// forward (flash_attention.cu says why no tile is skipped). A dead row
// gets dq exactly 0, and a dead key dk and dv exactly 0: every p of its
// row is 0.
//
// float32 keeps the CUDA-core arithmetic of the first port, all fp32, as
// the float32 contract (1e-4 against the plain backward, with TF32 off)
// needs, which tensor-core products cannot meet. The input type alone
// chooses the body inside the C entry points; neither is a fallback for
// the other. Design of the CUDA-core kernels:
// - dq: one block per (tile of 64 query rows, head, batch row). A query
//   row belongs to TPR = D/16 threads, each holding 16 contiguous
//   elements of q, dO and the dq accumulator in registers; the row's lse
//   and delta are registers too. Key and value tiles go through shared
//   memory and are walked key by key.
// - dk/dv: one block per (tile of 64 key rows, head, batch row), with a
//   key row split the same way over threads holding k, v and the dk and
//   dv accumulators; query tiles (q, dO, tags, lse, delta) go through
//   shared memory and are walked query by query.
// A score and a dP are per-thread partial dots summed over the TPR lanes
// with shuffles. Each thread's slice of a row in shared memory is padded
// by 4 floats, so that the TPR lanes read 16-byte vectors from distinct
// banks. A pair that is masked for every row of a warp is skipped by the
// whole warp (__any_sync); that changes no result, since its p is 0.
// Rows and keys past T get tag 0 and never store, so T need not divide
// any tile. The public [B, T, H, D] layout is read and written in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int ROWS = 64;  // output rows (queries for dq, keys for dk/dv) per block
constexpr unsigned FULL = 0xffffffffu;

template <int D>
struct Split {
    static constexpr int DP = 16;                 // elements per thread
    static constexpr int TPR = D / DP;            // threads per output row
    static constexpr int PAD = TPR > 1 ? 4 : 0;   // floats between slices
    static constexpr int SLICE = DP + PAD;
    static constexpr int ROW = TPR * SLICE;       // floats per shared row
    static constexpr int TILE = D >= 128 ? 32 : 64;  // streamed rows per shared tile
    static constexpr int THREADS = ROWS * TPR;
    static_assert(D % DP == 0 && 32 % TPR == 0, "a row's lanes share one warp");
};

// This thread's partial dot of its DP register elements with a shared slice.
template <int DP>
__device__ __forceinline__ float dot(const float (&x)[DP], const float* s) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < DP; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(s + i);
        acc += x[i] * v.x;
        acc += x[i + 1] * v.y;
        acc += x[i + 2] * v.z;
        acc += x[i + 3] * v.w;
    }
    return acc;
}

// The sum of a partial value over the TPR lanes of one row.
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
    return x;
}

// acc += w * s, for a shared slice s.
template <int DP>
__device__ __forceinline__ void axpy(float (&acc)[DP], float w, const float* s) {
#pragma unroll
    for (int i = 0; i < DP; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(s + i);
        acc[i] += w * v.x;
        acc[i + 1] += w * v.y;
        acc[i + 2] += w * v.z;
        acc[i + 3] += w * v.w;
    }
}

// Copies rows [r0, r0 + n) of two [B, T, H, D] tensors (at `base`, the
// offset of this batch row and head) into shared memory in the padded
// slice layout; rows past n are zero.
template <int D>
__device__ __forceinline__ void load_tile(const float* __restrict__ a,
                                          const float* __restrict__ b, float* as, float* bs,
                                          size_t base, size_t tok_stride, int r0, int n) {
    using L = Split<D>;
    for (int e = threadIdx.x; e < L::TILE * D; e += L::THREADS) {
        const int r = e / D, c = e % D;
        float ax = 0.f, bx = 0.f;
        if (r < n) {
            const size_t off = base + (size_t)(r0 + r) * tok_stride + c;
            ax = a[off];
            bx = b[off];
        }
        const int s = r * L::ROW + (c / L::DP) * L::SLICE + c % L::DP;
        as[s] = ax;
        bs[s] = bx;
    }
}

template <int D>
__global__ void __launch_bounds__(Split<D>::THREADS)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ qtag,
                const int* __restrict__ ktag, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int seq, int heads, float scale) {
    using L = Split<D>;
    __shared__ __align__(16) float ks[L::TILE * L::ROW];
    __shared__ __align__(16) float vs[L::TILE * L::ROW];
    __shared__ int kts[L::TILE];

    const int b = blockIdx.z, h = blockIdx.y;
    const int row = threadIdx.x / L::TPR, part = threadIdx.x % L::TPR;
    const int tq = blockIdx.x * ROWS + row;
    const bool active = tq < seq;
    const size_t tok_stride = (size_t)heads * D;  // [B, T, H, D]: between tokens
    const size_t base = (size_t)b * seq * tok_stride + (size_t)h * D;
    const size_t mine = base + (size_t)tq * tok_stride + part * L::DP;
    const size_t stat = ((size_t)b * seq + tq) * heads + h;  // [B, T, H]
    const int my_tag = active ? qtag[(size_t)b * seq + tq] : 0;
    const float my_lse = active ? lse[stat] : -INFINITY;
    const float my_delta = active ? delta[stat] : 0.f;
    const bool alive = my_lse > -INFINITY;  // a dead row has lse -inf

    float qv[L::DP], dov[L::DP], acc[L::DP];
#pragma unroll
    for (int i = 0; i < L::DP; ++i) {
        qv[i] = active ? q[mine + i] : 0.f;
        dov[i] = active ? dout[mine + i] : 0.f;
        acc[i] = 0.f;
    }

    for (int k0 = 0; k0 < seq; k0 += L::TILE) {
        const int kn = min(L::TILE, seq - k0);
        __syncthreads();  // the previous tile is consumed
        load_tile<D>(k, v, ks, vs, base, tok_stride, k0, kn);
        for (int r = threadIdx.x; r < L::TILE; r += L::THREADS)
            kts[r] = r < kn ? ktag[(size_t)b * seq + k0 + r] : 0;  // tag 0: dead key
        __syncthreads();

        for (int j = 0; j < kn; ++j) {
            const int kt = kts[j];
            const bool live = alive && kt == my_tag && kt > 0;
            if (!__any_sync(FULL, live)) continue;  // warp-uniform: p = 0 for every row
            const float* kr = ks + j * L::ROW + part * L::SLICE;
            const float* vr = vs + j * L::ROW + part * L::SLICE;
            const float s = row_sum<L::TPR>(dot<L::DP>(qv, kr));
            const float dp = row_sum<L::TPR>(dot<L::DP>(dov, vr));
            const float p = live ? expf(scale * s - my_lse) : 0.f;
            axpy<L::DP>(acc, p * (dp - my_delta), kr);
        }
    }

    if (!active) return;
#pragma unroll
    for (int i = 0; i < L::DP; ++i) dq[mine + i] = acc[i] * scale;
}

template <int D>
__global__ void __launch_bounds__(Split<D>::THREADS)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ qtag,
                 const int* __restrict__ ktag, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int seq, int heads,
                 float scale) {
    using L = Split<D>;
    __shared__ __align__(16) float qs[L::TILE * L::ROW];
    __shared__ __align__(16) float dos[L::TILE * L::ROW];
    __shared__ int qts[L::TILE];
    __shared__ float lses[L::TILE];
    __shared__ float deltas[L::TILE];

    const int b = blockIdx.z, h = blockIdx.y;
    const int row = threadIdx.x / L::TPR, part = threadIdx.x % L::TPR;
    const int tk = blockIdx.x * ROWS + row;
    const bool active = tk < seq;
    const size_t tok_stride = (size_t)heads * D;
    const size_t base = (size_t)b * seq * tok_stride + (size_t)h * D;
    const size_t mine = base + (size_t)tk * tok_stride + part * L::DP;
    const int my_tag = active ? ktag[(size_t)b * seq + tk] : 0;  // 0: no query sees it

    float kv[L::DP], vv[L::DP], dka[L::DP], dva[L::DP];
#pragma unroll
    for (int i = 0; i < L::DP; ++i) {
        kv[i] = active ? k[mine + i] : 0.f;
        vv[i] = active ? v[mine + i] : 0.f;
        dka[i] = 0.f;
        dva[i] = 0.f;
    }

    for (int q0 = 0; q0 < seq; q0 += L::TILE) {
        const int qn = min(L::TILE, seq - q0);
        __syncthreads();
        load_tile<D>(q, dout, qs, dos, base, tok_stride, q0, qn);
        for (int r = threadIdx.x; r < L::TILE; r += L::THREADS) {
            const size_t tok = (size_t)b * seq + q0 + r;
            qts[r] = r < qn ? qtag[tok] : 0;
            lses[r] = r < qn ? lse[tok * heads + h] : -INFINITY;
            deltas[r] = r < qn ? delta[tok * heads + h] : 0.f;
        }
        __syncthreads();

        for (int i = 0; i < qn; ++i) {
            const int qt = qts[i];
            const float l = lses[i];
            const bool live = my_tag > 0 && qt == my_tag && l > -INFINITY;
            if (!__any_sync(FULL, live)) continue;
            const float* qr = qs + i * L::ROW + part * L::SLICE;
            const float* dr = dos + i * L::ROW + part * L::SLICE;
            const float s = row_sum<L::TPR>(dot<L::DP>(kv, qr));
            const float dp = row_sum<L::TPR>(dot<L::DP>(vv, dr));
            const float p = live ? expf(scale * s - l) : 0.f;
            axpy<L::DP>(dva, p, dr);
            axpy<L::DP>(dka, p * (dp - deltas[i]), qr);
        }
    }

    if (!active) return;
#pragma unroll
    for (int i = 0; i < L::DP; ++i) {
        dk[mine + i] = dka[i] * scale;
        dv[mine + i] = dva[i];
    }
}

// ---- The bf16 tensor-core dk/dv body -------------------------------------

namespace bf16_dkv {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BKEY = 16 * WARPS;  // own key rows per block, 16 per warp
constexpr int STAGES = 2;

// Dynamic shared memory, in bytes: the block's K and V (later the dk
// and dv staging), STAGES tiles each of Q and dO, and the streamed query
// tags, lse and delta.
template <int D>
struct Smem {
    static constexpr int BQ = D >= 128 ? 32 : 64;  // queries per streamed tile
    static constexpr int LD = D + 8;                // bf16 per shared row: 16 bytes of padding
    static constexpr int K = 0;
    static constexpr int V = K + BKEY * LD * 2;
    static constexpr int Q = V + BKEY * LD * 2;
    static constexpr int DO = Q + STAGES * BQ * LD * 2;
    static constexpr int TAGS = DO + STAGES * BQ * LD * 2;
    static constexpr int LSE = TAGS + STAGES * BQ * 4;
    static constexpr int DELTA = LSE + STAGES * BQ * 4;
    static constexpr int BYTES = DELTA + STAGES * BQ * 4;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const int* __restrict__ qtag,
               const int* __restrict__ ktag, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int seq, int heads, float scale,
               float scale_log2) {
    using S = Smem<D>;
    constexpr int LD = S::LD, BQ = S::BQ;
    // The warp's K and V fragments (the A operands of S^T and dP^T) are
    // read from shared memory once and held in registers below D = 128
    // (faster than reading them for every query tile at D = 64, at every
    // shape measured; PERF.md has the times); at D = 128 they would not
    // fit beside the two accumulators and are read for each tile.
    constexpr bool KV_REGS = D < 128;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* ks = reinterpret_cast<bf16*>(smem + S::K);
    bf16* vs = reinterpret_cast<bf16*>(smem + S::V);
    bf16* qs = reinterpret_cast<bf16*>(smem + S::Q);
    bf16* dos = reinterpret_cast<bf16*>(smem + S::DO);
    int* qts = reinterpret_cast<int*>(smem + S::TAGS);
    float* lses = reinterpret_cast<float*>(smem + S::LSE);
    float* deltas = reinterpret_cast<float*>(smem + S::DELTA);

    const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BKEY;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;  // the mma fragments' row group and column pair
    const size_t tok = (size_t)heads * D;    // [B, T, H, D]: between tokens
    const size_t base = (size_t)b * seq * tok + (size_t)h * D;
    const int* kt_row = ktag + (size_t)b * seq;
    const int n_tiles = (seq + BQ - 1) / BQ;

    auto load_q = [&](int tile, int stage) {
        const int q0 = tile * BQ;
        tc::load_rows<D, LD, BQ, THREADS>(qs + stage * BQ * LD, q + base, tok, q0, seq);
        tc::load_rows<D, LD, BQ, THREADS>(dos + stage * BQ * LD, dout + base, tok, q0, seq);
        if (tid < BQ) {
            const bool ok = q0 + tid < seq;  // tag 0 past T: no key sees it
            const size_t t = (size_t)b * seq + (ok ? q0 + tid : 0);
            tc::cp_async4(qts + stage * BQ + tid, qtag + t, ok);
            tc::cp_async4(lses + stage * BQ + tid, lse + t * heads + h, ok);
            tc::cp_async4(deltas + stage * BQ + tid, delta + t * heads + h, ok);
        }
    };
    tc::load_rows<D, LD, BKEY, THREADS>(ks, k + base, tok, k0, seq);
    tc::load_rows<D, LD, BKEY, THREADS>(vs, v + base, tok, k0, seq);
    load_q(0, 0);
    tc::cp_async_commit();

    const int r0 = k0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two key rows
    const int kt0 = r0 < seq ? kt_row[r0] : 0, kt1 = r1 < seq ? kt_row[r1] : 0;
    const bf16* kw = ks + warp * 16 * LD;  // the warp's own rows: the A operands
    const bf16* vw = vs + warp * 16 * LD;

    float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
        dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
        dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
    }
    uint32_t kf[KV_REGS ? D / 16 : 1][4], vf[KV_REGS ? D / 16 : 1][4];

    for (int j = 0, stage = 0; j < n_tiles; ++j, stage ^= 1) {
        if (j + 1 < n_tiles) {
            load_q(j + 1, stage ^ 1);
            tc::cp_async_commit();
            tc::cp_async_wait<1>();
        } else {
            tc::cp_async_wait<0>();
        }
        __syncthreads();  // query tile j (and, first, K and V) has landed for every thread
        if constexpr (KV_REGS) {
            if (j == 0) {
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk) {
                    tc::ldsm_x4(kf[kk], kw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
                    tc::ldsm_x4(vf[kk], vw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
                }
            }
        }
        const bf16* qst = qs + stage * BQ * LD;
        const bf16* dost = dos + stage * BQ * LD;
        const int* qt = qts + stage * BQ;
        const float* ls = lses + stage * BQ;
        const float* dl = deltas + stage * BQ;

        // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries for this warp.
        float p[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
            p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
            dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t ka[4], va[4];
            if constexpr (KV_REGS) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    ka[i] = kf[kk][i];
                    va[i] = vf[kk][i];
                }
            } else {
                tc::ldsm_x4(ka, kw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
                tc::ldsm_x4(va, vw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
            }
#pragma unroll
            for (int np = 0; np < BQ / 16; ++np) {
                const int off = (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                                ((lane >> 3) & 1) * 8;
                uint32_t qb[4], db[4];
                tc::ldsm_x4(qb, qst + off);
                tc::ldsm_x4(db, dost + off);
                tc::mma16816(p[2 * np], ka, qb[0], qb[1]);
                tc::mma16816(p[2 * np + 1], ka, qb[2], qb[3]);
                tc::mma16816(dp[2 * np], va, db[0], db[1]);
                tc::mma16816(dp[2 * np + 1], va, db[2], db[3]);
            }
        }

        // P^T from the saved lse (0 on a masked pair and on a dead row),
        // then dS^T = P^T (dP^T - delta); both rounded to bf16 as the A
        // operands of the two accumulating products.
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
            const int col = n * 8 + 2 * t4;  // this thread's two queries of the tile
            const float2 l = *reinterpret_cast<const float2*>(ls + col);
            const float2 dlt = *reinterpret_cast<const float2*>(dl + col);
            const int2 tg = *reinterpret_cast<const int2*>(qt + col);
            const float la = l.x * tc::LOG2E, lb = l.y * tc::LOG2E;
            // A select, never a product: a dead row's exp2 is inf.
            const bool ua = l.x > -INFINITY, ub = l.y > -INFINITY;
            float pv[4];
            pv[0] = (ua && kt0 > 0 && tg.x == kt0) ? tc::ex2(fmaf(p[n][0], scale_log2, -la)) : 0.f;
            pv[1] = (ub && kt0 > 0 && tg.y == kt0) ? tc::ex2(fmaf(p[n][1], scale_log2, -lb)) : 0.f;
            pv[2] = (ua && kt1 > 0 && tg.x == kt1) ? tc::ex2(fmaf(p[n][2], scale_log2, -la)) : 0.f;
            pv[3] = (ub && kt1 > 0 && tg.y == kt1) ? tc::ex2(fmaf(p[n][3], scale_log2, -lb)) : 0.f;
            pa[n / 2][(n & 1) * 2] = tc::pack_bf16(pv[0], pv[1]);
            pa[n / 2][(n & 1) * 2 + 1] = tc::pack_bf16(pv[2], pv[3]);
            da[n / 2][(n & 1) * 2] =
                tc::pack_bf16(pv[0] * (dp[n][0] - dlt.x), pv[1] * (dp[n][1] - dlt.y));
            da[n / 2][(n & 1) * 2 + 1] =
                tc::pack_bf16(pv[2] * (dp[n][2] - dlt.x), pv[3] * (dp[n][3] - dlt.y));
        }

        // dV += P^T dO and dK += dS^T Q: dO and Q [query][d] are the k x n
        // operands, read transposed.
#pragma unroll
        for (int kc = 0; kc < BQ / 16; ++kc) {
#pragma unroll
            for (int dd = 0; dd < D / 16; ++dd) {
                const int off = (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dd * 16 +
                                (lane >> 4) * 8;
                uint32_t ob[4], qb[4];
                tc::ldsm_x4_trans(ob, dost + off);
                tc::ldsm_x4_trans(qb, qst + off);
                tc::mma16816(dva[2 * dd], pa[kc], ob[0], ob[1]);
                tc::mma16816(dva[2 * dd + 1], pa[kc], ob[2], ob[3]);
                tc::mma16816(dka[2 * dd], da[kc], qb[0], qb[1]);
                tc::mma16816(dka[2 * dd + 1], da[kc], qb[2], qb[3]);
            }
        }
        __syncthreads();  // every warp is done with this stage before it is refilled
    }

    // Stage dk (scaled once) and dv in the warp's own rows of the K and V
    // tiles (which only this warp read), then 16-byte stores.
    bf16* kst = ks + warp * 16 * LD;
    bf16* vst = vs + warp * 16 * LD;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
        const int c = i * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(kst + g * LD + c) =
            tc::pack_bf16(dka[i][0] * scale, dka[i][1] * scale);
        *reinterpret_cast<uint32_t*>(kst + (g + 8) * LD + c) =
            tc::pack_bf16(dka[i][2] * scale, dka[i][3] * scale);
        *reinterpret_cast<uint32_t*>(vst + g * LD + c) = tc::pack_bf16(dva[i][0], dva[i][1]);
        *reinterpret_cast<uint32_t*>(vst + (g + 8) * LD + c) =
            tc::pack_bf16(dva[i][2], dva[i][3]);
    }
    __syncwarp();
    tc::store_rows16<D, LD>(dk + base, kst, tok, k0 + warp * 16, seq, lane);
    tc::store_rows16<D, LD>(dv + base, vst, tok, k0 + warp * 16, seq, lane);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* qtag,
                   const int* ktag, const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int batch, int seq, int heads, float scale,
                   cudaStream_t stream) {
    static tc::SmemLimit limit;  // above 48 KB, once per device
    const cudaError_t attr = limit.ensure(flash_dkv_bf16<D>, Smem<D>::BYTES);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((seq + BKEY - 1) / BKEY, heads, batch);
    flash_dkv_bf16<D><<<grid, THREADS, Smem<D>::BYTES, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        qtag, ktag, static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), seq, heads, scale, scale * tc::LOG2E);
    return cudaGetLastError();
}

}  // namespace bf16_dkv

// ---- The bf16 tensor-core dq body ----------------------------------------

namespace bf16_dq {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // own query rows per block, 16 per warp
constexpr int STAGES = 2;

// Dynamic shared memory, in bytes: the block's Q and dO (later the dq
// staging), STAGES tiles each of K and V, and the streamed key tags.
template <int D>
struct Smem {
    static constexpr int BK = D >= 128 ? 32 : 64;  // keys per streamed tile
    static constexpr int LD = D + 8;                // bf16 per shared row: 16 bytes of padding
    static constexpr int Q = 0;
    static constexpr int DO = Q + BQ * LD * 2;
    static constexpr int K = DO + BQ * LD * 2;
    static constexpr int V = K + STAGES * BK * LD * 2;
    static constexpr int TAGS = V + STAGES * BK * LD * 2;
    static constexpr int BYTES = TAGS + STAGES * BK * 4;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const int* __restrict__ qtag,
              const int* __restrict__ ktag, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int seq, int heads, float scale, float scale_log2) {
    using S = Smem<D>;
    constexpr int LD = S::LD, BK = S::BK;
    // The warp's Q and dO fragments (the A operands of S and dP) stay in
    // registers below D = 128, as B5's K and V do; at D = 128 they would
    // not fit beside the accumulator and are read for each tile.
    constexpr bool QD_REGS = D < 128;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* qs = reinterpret_cast<bf16*>(smem + S::Q);
    bf16* dos = reinterpret_cast<bf16*>(smem + S::DO);
    bf16* ks = reinterpret_cast<bf16*>(smem + S::K);
    bf16* vs = reinterpret_cast<bf16*>(smem + S::V);
    int* kts = reinterpret_cast<int*>(smem + S::TAGS);

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;  // the mma fragments' row group and column pair
    const size_t tok = (size_t)heads * D;    // [B, T, H, D]: between tokens
    const size_t base = (size_t)b * seq * tok + (size_t)h * D;
    const int* kt_row = ktag + (size_t)b * seq;
    const int n_tiles = (seq + BK - 1) / BK;

    auto load_kv = [&](int tile, int stage) {
        const int k0 = tile * BK;
        tc::load_rows<D, LD, BK, THREADS>(ks + stage * BK * LD, k + base, tok, k0, seq);
        tc::load_rows<D, LD, BK, THREADS>(vs + stage * BK * LD, v + base, tok, k0, seq);
        if (tid < BK) {
            const bool ok = k0 + tid < seq;  // tag 0 past T: no query sees it
            tc::cp_async4(kts + stage * BK + tid, kt_row + (ok ? k0 + tid : 0), ok);
        }
    };
    tc::load_rows<D, LD, BQ, THREADS>(qs, q + base, tok, q0, seq);
    tc::load_rows<D, LD, BQ, THREADS>(dos, dout + base, tok, q0, seq);
    load_kv(0, 0);
    tc::cp_async_commit();

    // This thread's two query rows: their tags, lse in log2 units and
    // delta. A row past T or with lse -inf (dead) is never live.
    const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
    const size_t s0 = ((size_t)b * seq + r0) * heads + h, s1 = s0 + (size_t)8 * heads;
    const int qt0 = r0 < seq ? qtag[(size_t)b * seq + r0] : 0;
    const int qt1 = r1 < seq ? qtag[(size_t)b * seq + r1] : 0;
    const float l0 = r0 < seq ? lse[s0] : -INFINITY, l1 = r1 < seq ? lse[s1] : -INFINITY;
    const float dl0 = r0 < seq ? delta[s0] : 0.f, dl1 = r1 < seq ? delta[s1] : 0.f;
    const bool live0 = l0 > -INFINITY, live1 = l1 > -INFINITY;
    const float la0 = live0 ? l0 * tc::LOG2E : 0.f, la1 = live1 ? l1 * tc::LOG2E : 0.f;
    const bf16* qw = qs + warp * 16 * LD;  // the warp's own rows: the A operands
    const bf16* dw = dos + warp * 16 * LD;

    float acc[D / 8][4];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    uint32_t qf[QD_REGS ? D / 16 : 1][4], df[QD_REGS ? D / 16 : 1][4];

    for (int j = 0, stage = 0; j < n_tiles; ++j, stage ^= 1) {
        if (j + 1 < n_tiles) {
            load_kv(j + 1, stage ^ 1);
            tc::cp_async_commit();
            tc::cp_async_wait<1>();
        } else {
            tc::cp_async_wait<0>();
        }
        __syncthreads();  // key tile j (and, first, Q and dO) has landed for every thread
        if constexpr (QD_REGS) {
            if (j == 0) {
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk) {
                    tc::ldsm_x4(qf[kk], qw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
                    tc::ldsm_x4(df[kk], dw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
                }
            }
        }
        const bf16* kst = ks + stage * BK * LD;
        const bf16* vst = vs + stage * BK * LD;
        const int* kt = kts + stage * BK;

        // S = Q K^T and dP = dO V^T: 16 queries x BK keys for this warp.
        float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
            s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
            dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t qa[4], da[4];
            if constexpr (QD_REGS) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    qa[i] = qf[kk][i];
                    da[i] = df[kk][i];
                }
            } else {
                tc::ldsm_x4(qa, qw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
                tc::ldsm_x4(da, dw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
            }
#pragma unroll
            for (int np = 0; np < BK / 16; ++np) {
                const int off = (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                                ((lane >> 3) & 1) * 8;
                uint32_t kb[4], vb[4];
                tc::ldsm_x4(kb, kst + off);
                tc::ldsm_x4(vb, vst + off);
                tc::mma16816(s[2 * np], qa, kb[0], kb[1]);
                tc::mma16816(s[2 * np + 1], qa, kb[2], kb[3]);
                tc::mma16816(dp[2 * np], da, vb[0], vb[1]);
                tc::mma16816(dp[2 * np + 1], da, vb[2], vb[3]);
            }
        }

        // P from the saved lse (0 on a masked pair and on a dead row),
        // then dS = P (dP - delta), rounded to bf16 as the A operand.
        uint32_t dsa[BK / 16][4];
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
            const int2 tg = *reinterpret_cast<const int2*>(kt + n * 8 + 2 * t4);  // two keys
            // A select, never a product: a masked pair and a dead row give
            // exactly 0.
            const bool u0 = live0 && tg.x > 0 && tg.x == qt0, u1 = live0 && tg.y > 0 && tg.y == qt0;
            const bool u2 = live1 && tg.x > 0 && tg.x == qt1, u3 = live1 && tg.y > 0 && tg.y == qt1;
            const float p0 = u0 ? tc::ex2(fmaf(s[n][0], scale_log2, -la0)) : 0.f;
            const float p1 = u1 ? tc::ex2(fmaf(s[n][1], scale_log2, -la0)) : 0.f;
            const float p2 = u2 ? tc::ex2(fmaf(s[n][2], scale_log2, -la1)) : 0.f;
            const float p3 = u3 ? tc::ex2(fmaf(s[n][3], scale_log2, -la1)) : 0.f;
            dsa[n / 2][(n & 1) * 2] = tc::pack_bf16(p0 * (dp[n][0] - dl0), p1 * (dp[n][1] - dl0));
            dsa[n / 2][(n & 1) * 2 + 1] =
                tc::pack_bf16(p2 * (dp[n][2] - dl1), p3 * (dp[n][3] - dl1));
        }

        // dQ += dS K: K [key][d] is the k x n operand, read transposed.
#pragma unroll
        for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
            for (int dd = 0; dd < D / 16; ++dd) {
                const int off = (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dd * 16 +
                                (lane >> 4) * 8;
                uint32_t kb[4];
                tc::ldsm_x4_trans(kb, kst + off);
                tc::mma16816(acc[2 * dd], dsa[kc], kb[0], kb[1]);
                tc::mma16816(acc[2 * dd + 1], dsa[kc], kb[2], kb[3]);
            }
        }
        __syncthreads();  // every warp is done with this stage before it is refilled
    }

    // Stage dq (scaled once) in the warp's own rows of the Q tile (which
    // only this warp read), then 16-byte stores.
    bf16* st = qs + warp * 16 * LD;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
        const int c = i * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(st + g * LD + c) =
            tc::pack_bf16(acc[i][0] * scale, acc[i][1] * scale);
        *reinterpret_cast<uint32_t*>(st + (g + 8) * LD + c) =
            tc::pack_bf16(acc[i][2] * scale, acc[i][3] * scale);
    }
    __syncwarp();
    tc::store_rows16<D, LD>(dq + base, st, tok, q0 + warp * 16, seq, lane);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* qtag,
                   const int* ktag, const void* dout, const float* lse, const float* delta,
                   void* dq, int batch, int seq, int heads, float scale, cudaStream_t stream) {
    static tc::SmemLimit limit;  // above 48 KB, once per device
    const cudaError_t attr = limit.ensure(flash_dq_bf16<D>, Smem<D>::BYTES);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((seq + BQ - 1) / BQ, heads, batch);
    flash_dq_bf16<D><<<grid, THREADS, Smem<D>::BYTES, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        qtag, ktag, static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), seq,
        heads, scale, scale * tc::LOG2E);
    return cudaGetLastError();
}

}  // namespace bf16_dq

struct Args {
    const void *q, *k, *v;
    const int *qtag, *ktag;
    const void* dout;
    const float *lse, *delta;
    void *out0, *out1;  // dq, or dk and dv
    int batch, seq, heads;
    float scale;
    cudaStream_t stream;
};

// The input type alone chooses the body: bf16 the tensor cores, float32
// the CUDA cores.
template <bool DKV, typename T, int D>
cudaError_t launch(const Args& a) {
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        if constexpr (DKV)
            return bf16_dkv::launch<D>(a.q, a.k, a.v, a.qtag, a.ktag, a.dout, a.lse, a.delta,
                                       a.out0, a.out1, a.batch, a.seq, a.heads, a.scale,
                                       a.stream);
        else
            return bf16_dq::launch<D>(a.q, a.k, a.v, a.qtag, a.ktag, a.dout, a.lse, a.delta,
                                      a.out0, a.batch, a.seq, a.heads, a.scale, a.stream);
    } else {
        const dim3 grid((a.seq + ROWS - 1) / ROWS, a.heads, a.batch);
        const float *q = static_cast<const float*>(a.q), *k = static_cast<const float*>(a.k),
                    *v = static_cast<const float*>(a.v), *dout = static_cast<const float*>(a.dout);
        if constexpr (DKV) {
            flash_dkv_kernel<D><<<grid, Split<D>::THREADS, 0, a.stream>>>(
                q, k, v, a.qtag, a.ktag, dout, a.lse, a.delta, static_cast<float*>(a.out0),
                static_cast<float*>(a.out1), a.seq, a.heads, a.scale);
        } else {
            flash_dq_kernel<D><<<grid, Split<D>::THREADS, 0, a.stream>>>(
                q, k, v, a.qtag, a.ktag, dout, a.lse, a.delta, static_cast<float*>(a.out0),
                a.seq, a.heads, a.scale);
        }
        return cudaGetLastError();
    }
}

template <bool DKV, typename T>
cudaError_t dispatch(int head_dim, const Args& a) {
    switch (head_dim) {
        case 16: return launch<DKV, T, 16>(a);
        case 32: return launch<DKV, T, 32>(a);
        case 64: return launch<DKV, T, 64>(a);
        case 128: return launch<DKV, T, 128>(a);
        default: return cudaErrorInvalidValue;
    }
}

template <bool DKV>
int run(int is_bf16, int head_dim, const Args& a) {
    return (int)(is_bf16 ? dispatch<DKV, __nv_bfloat16>(head_dim, a)
                         : dispatch<DKV, float>(head_dim, a));
}

}  // namespace

extern "C" {

// q, k, v, dout and the outputs: [batch, seq, heads, head_dim] contiguous,
// bf16 (is_bf16 = 1, 16-byte aligned) or fp32; qtag, ktag: int32 [batch,
// seq]; lse and delta: fp32 [batch, seq, heads]. Launch on `stream` and
// return the CUDA error of the launch (0 on success).
int svoc_flash_attention_dq(const void* q, const void* k, const void* v, const int* qtag,
                            const int* ktag, const void* dout, const float* lse,
                            const float* delta, void* dq, int is_bf16, int batch, int seq,
                            int heads, int head_dim, float scale, void* stream) {
    const Args a{q, k, v, qtag, ktag, dout, lse, delta, dq, nullptr,
                 batch, seq, heads, scale, static_cast<cudaStream_t>(stream)};
    return run<false>(is_bf16, head_dim, a);
}

int svoc_flash_attention_dkv(const void* q, const void* k, const void* v, const int* qtag,
                             const int* ktag, const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv, int is_bf16, int batch,
                             int seq, int heads, int head_dim, float scale, void* stream) {
    const Args a{q, k, v, qtag, ktag, dout, lse, delta, dk, dv,
                 batch, seq, heads, scale, static_cast<cudaStream_t>(stream)};
    return run<true>(is_bf16, head_dim, a);
}

}  // extern "C"
