// Forward flash attention with integer tag masks, for Hopper (sm_90a),
// with a plain C interface for ctypes.
//
// Replaces svoc_tpu/ops/pallas_attention.py::_flash_kernel (line 71), the
// Pallas TPU kernel behind flash_attention (line 421). Its plain PyTorch
// version is svoc_torch/ops/flash_attention.py::flash_attention_plain.
//
// Semantics (pallas_attention.py:60-131):
// - query i sees key j iff tag_q[i] == tag_k[j] and tag_k[j] > 0. Packed
//   rows pass segment ids as both tags; per-key padding passes q tags of
//   1 and the key mask as k tags. A padding query sees nothing.
// - The softmax is the online recurrence with a running max, denominator
//   and accumulator in fp32.
// - NEG_INF is the finite -1e30 sentinel of the TPU kernel, never -inf,
//   so that no inf - inf can make a NaN.
// - A row that sees no key writes exactly 0 and, when asked, lse = -inf.
//
// Two bodies; the input type alone chooses, inside the C entry point:
// bf16 always runs the tensor-core body, float32 always the CUDA-core
// body. Neither is a fallback for the other: nothing retries, and a
// failed launch is returned to the caller.
//
// What bounds it: at the flagship shape (B = 256 rows, T = 128, 12 heads
// of 64, bf16) one launch reads q, k, v and writes o, 4 x 32768 x 768 x 2
// bytes = 201 MB, 60 us at 3.35 TB/s; its products, even over all T^2
// pairs, take 13 us on the bf16 tensor cores. At (B, T) = (2, 8192)
// with every key live it moves 101 MB (30 us) and does 0.41 TFLOP
// (0.42 ms at 989 TFLOP/s). So the short shape is bound by bytes (and,
// with two key tiles a block, by load latency), the long one by the
// products.
//
// The bf16 body (FlashAttention-2 with P in registers): one block of 4
// warps per (128 query rows, head, batch row), each warp owning two
// tiles of 16 rows, so that each K and V fragment read from shared
// memory feeds two products (at D = 128, where that would not fit in the
// registers, 64 rows and one tile a warp).
// - Products on the tensor cores: S = Q K^T and O += P V with
//   mma.sync.m16n8k16 (bf16 operands, fp32 accumulators). Q's fragments
//   are read once by ldmatrix; K is the column-major B operand through
//   ldmatrix, V through ldmatrix.trans; P is the S accumulators rounded
//   to bf16 in registers (tensor_core.cuh).
// - Loads overlap the products: K, V and the key tags come in 64-key
//   tiles by 16-byte cp.async.cg, two stages in dynamic shared memory
//   (the next tile loads while this one computes); rows past T are
//   zero-filled and get tag 0. Each shared row is padded by 16 bytes so
//   that ldmatrix's eight row reads fall on distinct banks.
// - The scale goes on S in fp32, with log2 e folded in, one FFMA before
//   ex2.approx (a scaled q in bf16 would round at D = 32 and 128); the
//   running max and denominator are per row across the 4 lanes of a
//   quad, and l sums P before it is rounded.
// - Every key tile is visited and masked by tag. A test that skipped the
//   tiles none of a block's queries can see would save nothing on the
//   rows served: at T = 128 a block has two key tiles, and on a real
//   packed batch a skip by tag range would save 0.8 % of the 64 x 64
//   tile pairs (chip_smoke.py, phase 2).
// - The output is normalised, rounded to bf16, staged through the
//   warp's own rows of the Q tile and stored with 16-byte writes.
//
// The float32 body keeps the CUDA-core arithmetic of the first port (q
// scaled by 1/sqrt(D) before an fp32 dot product, one online-softmax
// update per 16 keys): the float32 contract is 2e-5 with TF32 off, which
// bf16 or TF32 tensor-core products cannot meet. One block per (64 query
// rows, head, batch row); each query row belongs to TPR threads (1 for
// D <= 32, D/32 above) holding D/TPR contiguous elements of q and of the
// accumulator; K and V tiles go through shared memory as fp32, each
// thread's slice padded by 4 floats. Rows and keys past T are masked, so
// T need not divide any tile, and the public layout [B, T, H, D] is read
// and written in place by both bodies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "smem_limit.cuh"
#include "tensor_core.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;  // query rows per block
constexpr int CH = 16;  // keys per online-softmax update

// ---- The float32 CUDA-core body (instantiated for T = float only) -------

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <int D>
struct Tile {
    static constexpr int TPR = D >= 64 ? D / 32 : 1;  // threads per query row
    static constexpr int DP = D / TPR;                // elements per thread
    static constexpr int PAD = TPR > 1 ? 4 : 0;       // floats between slices
    static constexpr int SLICE = DP + PAD;
    static constexpr int ROW = TPR * SLICE;           // floats per smem key row
    static constexpr int BK = D >= 128 ? 32 : 64;     // key rows per smem tile
    static constexpr int THREADS = BQ * TPR;
    static_assert(BK % CH == 0, "key tile must hold whole chunks");
    static_assert(DP % 4 == 0, "slices are read as float4");
};

template <typename T, int D>
__global__ void __launch_bounds__(Tile<D>::THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ qtag, const int* __restrict__ ktag,
                 T* __restrict__ o, float* __restrict__ lse, int seq, int heads,
                 float scale) {
    using L = Tile<D>;
    __shared__ __align__(16) float ks[L::BK * L::ROW];
    __shared__ __align__(16) float vs[L::BK * L::ROW];
    __shared__ int kts[L::BK];

    const int b = blockIdx.z, h = blockIdx.y;
    const int row = threadIdx.x / L::TPR, part = threadIdx.x % L::TPR;
    const int tq = blockIdx.x * BQ + row;
    const bool active = tq < seq;
    const size_t tok_stride = (size_t)heads * D;  // [B, T, H, D]: between tokens
    const size_t base = (size_t)b * seq * tok_stride + (size_t)h * D;
    const int my_tag = active ? qtag[(size_t)b * seq + tq] : 0;

    float qv[L::DP], acc[L::DP];
#pragma unroll
    for (int i = 0; i < L::DP; ++i) {
        qv[i] = active ? to_f32(q[base + tq * tok_stride + part * L::DP + i]) * scale : 0.f;
        acc[i] = 0.f;
    }
    float m = NEG_INF, l = 0.f;

    for (int k0 = 0; k0 < seq; k0 += L::BK) {
        const int kn = min(L::BK, seq - k0);
        __syncthreads();  // the previous tile is consumed
        for (int e = threadIdx.x; e < L::BK * D; e += L::THREADS) {
            const int r = e / D, c = e % D;
            float kx = 0.f, vx = 0.f;
            if (r < kn) {
                const size_t off = base + (size_t)(k0 + r) * tok_stride + c;
                kx = to_f32(k[off]);
                vx = to_f32(v[off]);
            }
            const int s = r * L::ROW + (c / L::DP) * L::SLICE + c % L::DP;
            ks[s] = kx;
            vs[s] = vx;
        }
        for (int r = threadIdx.x; r < L::BK; r += L::THREADS)
            kts[r] = r < kn ? ktag[(size_t)b * seq + k0 + r] : 0;  // tag 0: dead key
        __syncthreads();

        for (int j0 = 0; j0 < kn; j0 += CH) {
            float s[CH];
            float m_blk = NEG_INF;
#pragma unroll
            for (int jj = 0; jj < CH; ++jj) {
                const float* kr = ks + (j0 + jj) * L::ROW + part * L::SLICE;
                float dot = 0.f;
#pragma unroll
                for (int i = 0; i < L::DP; i += 4) {
                    const float4 k4 = *reinterpret_cast<const float4*>(kr + i);
                    dot += qv[i] * k4.x;
                    dot += qv[i + 1] * k4.y;
                    dot += qv[i + 2] * k4.z;
                    dot += qv[i + 3] * k4.w;
                }
#pragma unroll
                for (int off = L::TPR / 2; off > 0; off >>= 1)
                    dot += __shfl_xor_sync(0xffffffffu, dot, off);
                const int kt = kts[j0 + jj];
                s[jj] = (kt == my_tag && kt > 0) ? dot : NEG_INF;
                m_blk = fmaxf(m_blk, s[jj]);
            }
            const float m_new = fmaxf(m, m_blk);
            const float corr = expf(m - m_new);
            l *= corr;
#pragma unroll
            for (int i = 0; i < L::DP; ++i) acc[i] *= corr;
#pragma unroll
            for (int jj = 0; jj < CH; ++jj) {
                const float p = s[jj] > NEG_INF ? expf(s[jj] - m_new) : 0.f;
                l += p;
                const float* vr = vs + (j0 + jj) * L::ROW + part * L::SLICE;
#pragma unroll
                for (int i = 0; i < L::DP; i += 4) {
                    const float4 v4 = *reinterpret_cast<const float4*>(vr + i);
                    acc[i] += p * v4.x;
                    acc[i + 1] += p * v4.y;
                    acc[i + 2] += p * v4.z;
                    acc[i + 3] += p * v4.w;
                }
            }
            m = m_new;
        }
    }

    if (!active) return;
    const bool dead = m <= NEG_INF * 0.5f;
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o + base + tq * tok_stride + part * L::DP;
#pragma unroll
    for (int i = 0; i < L::DP; ++i) orow[i] = from_f32<T>(dead ? 0.f : acc[i] / denom);
    if (lse != nullptr && part == 0)
        lse[((size_t)b * seq + tq) * heads + h] = dead ? -INFINITY : m + logf(l);
}

// ---- The bf16 tensor-core body -------------------------------------------

namespace bf16_body {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;  // keys per streamed tile
constexpr int STAGES = 2;

// A block of 4 warps, each owning MT tiles of 16 query rows: with MT = 2
// (up to D = 64) every K and V fragment read from shared memory feeds
// two products; at D = 128 two row tiles' accumulators and Q fragments
// would not fit in the registers. (At D = 64, 4 warps of 32 rows beat 8
// warps of 16 at every shape measured, and 4 of 16 at all but one, where
// they tied; PERF.md has the times.)
// Dynamic shared memory, in bytes: the Q tile (later the output
// staging), STAGES tiles each of K and V, and their key tags.
template <int D>
struct Cfg {
    static constexpr int WARPS = 4;
    static constexpr int MT = D <= 64 ? 2 : 1;
    static constexpr int THREADS = 32 * WARPS;
    static constexpr int RW = 16 * MT;         // query rows per warp
    static constexpr int BQ = WARPS * RW;      // query rows per block
    static constexpr int LD = D + 8;           // bf16 per shared row: 16 bytes of padding
    static constexpr int Q = 0;
    static constexpr int K = Q + BQ * LD * 2;
    static constexpr int V = K + STAGES * BK * LD * 2;
    static constexpr int TAGS = V + STAGES * BK * LD * 2;
    static constexpr int BYTES = TAGS + STAGES * BK * 4;
    static_assert(THREADS >= BK, "one thread per key tag of a tile");
};

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const int* __restrict__ qtag,
               const int* __restrict__ ktag, bf16* __restrict__ o, float* __restrict__ lse,
               int seq, int heads, float scale_log2) {
    using C = Cfg<D>;
    constexpr int LD = C::LD, BQ = C::BQ, RW = C::RW, MT = C::MT, THREADS = C::THREADS;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* qs = reinterpret_cast<bf16*>(smem + C::Q);
    bf16* ks = reinterpret_cast<bf16*>(smem + C::K);
    bf16* vs = reinterpret_cast<bf16*>(smem + C::V);
    int* kts = reinterpret_cast<int*>(smem + C::TAGS);

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;  // the mma fragments' row group and column pair
    const size_t tok = (size_t)heads * D;    // [B, T, H, D]: between tokens
    const size_t base = (size_t)b * seq * tok + (size_t)h * D;
    const int* qt_row = qtag + (size_t)b * seq;
    const int* kt_row = ktag + (size_t)b * seq;
    const int n_tiles = (seq + BK - 1) / BK;

    auto load_kv = [&](int tile, int stage) {
        const int k0 = tile * BK;
        tc::load_rows<D, LD, BK, THREADS>(ks + stage * BK * LD, k + base, tok, k0, seq);
        tc::load_rows<D, LD, BK, THREADS>(vs + stage * BK * LD, v + base, tok, k0, seq);
        if (tid < BK) {
            const bool ok = k0 + tid < seq;  // tag 0 past T: a dead key
            tc::cp_async4(kts + stage * BK + tid, kt_row + (ok ? k0 + tid : 0), ok);
        }
    };
    tc::load_rows<D, LD, BQ, THREADS>(qs, q + base, tok, q0, seq);
    load_kv(0, 0);
    tc::cp_async_commit();

    // This thread's query rows: g and g + 8 of each of the warp's MT tiles.
    const int w0 = q0 + warp * RW;
    int qt[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int r = w0 + mt * 16 + g + 8 * i;
            qt[mt][i] = r < seq ? qt_row[r] : 0;
        }
    }

    uint32_t qf[MT][D / 16][4];
    float acc[MT][D / 8][4];
    float m[MT][2], l[MT][2];  // m: the raw (unscaled) row max
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i = 0; i < D / 8; ++i) acc[mt][i][0] = acc[mt][i][1] = acc[mt][i][2] = acc[mt][i][3] = 0.f;
        m[mt][0] = m[mt][1] = NEG_INF;
        l[mt][0] = l[mt][1] = 0.f;
    }

    for (int j = 0, stage = 0; j < n_tiles; ++j, stage ^= 1) {
        if (j + 1 < n_tiles) {
            load_kv(j + 1, stage ^ 1);
            tc::cp_async_commit();
            tc::cp_async_wait<1>();
        } else {
            tc::cp_async_wait<0>();
        }
        __syncthreads();  // tile j (and, first, the Q tile) has landed for every thread
        if (j == 0) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk)
                    tc::ldsm_x4(qf[mt][kk], qs + (warp * RW + mt * 16 + (lane & 15)) * LD +
                                                kk * 16 + (lane >> 4) * 8);
        }
        const bf16* kst = ks + stage * BK * LD;
        const bf16* vst = vs + stage * BK * LD;
        const int* kt = kts + stage * BK;

        // S = Q K^T: RW rows x 64 keys for this warp, tiles of 16 x 8.
        float s[MT][BK / 8][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int n = 0; n < BK / 8; ++n) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
            for (int np = 0; np < BK / 16; ++np) {
                uint32_t kb[4];
                tc::ldsm_x4(kb, kst + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                                    ((lane >> 3) & 1) * 8);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    tc::mma16816(s[mt][2 * np], qf[mt][kk], kb[0], kb[1]);
                    tc::mma16816(s[mt][2 * np + 1], qf[mt][kk], kb[2], kb[3]);
                }
            }
        }

        // The mask, then each row's new max, the rescale of what it holds,
        // and P = exp2(scale log2(e) S - offset): exactly 0 on a masked
        // pair, summed into l in fp32, then rounded to bf16 as the A
        // operand of P V.
        uint32_t pa[MT][BK / 16][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int n = 0; n < BK / 8; ++n) {
                const int2 tg = *reinterpret_cast<const int2*>(kt + n * 8 + 2 * t4);
                s[mt][n][0] = (tg.x > 0 && tg.x == qt[mt][0]) ? s[mt][n][0] : NEG_INF;
                s[mt][n][1] = (tg.y > 0 && tg.y == qt[mt][0]) ? s[mt][n][1] : NEG_INF;
                s[mt][n][2] = (tg.x > 0 && tg.x == qt[mt][1]) ? s[mt][n][2] : NEG_INF;
                s[mt][n][3] = (tg.y > 0 && tg.y == qt[mt][1]) ? s[mt][n][3] : NEG_INF;
            }
            float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
            for (int n = 0; n < BK / 8; ++n) {
                mx[0] = fmaxf(mx[0], fmaxf(s[mt][n][0], s[mt][n][1]));
                mx[1] = fmaxf(mx[1], fmaxf(s[mt][n][2], s[mt][n][3]));
            }
            float off[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(tc::FULL, mx[i], 1));
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(tc::FULL, mx[i], 2));
                const float mn = fmaxf(m[mt][i], mx[i]);
                // exp2 of the scaled change: 0 when a row first comes
                // alive, 1 while it is still dead (it holds only zeros).
                const float c = tc::ex2((m[mt][i] - mn) * scale_log2);
                // A dead row's offset is 0, so its masked scores (-1e30)
                // still give exactly 0.
                off[i] = mn > NEG_INF ? mn * scale_log2 : 0.f;
                m[mt][i] = mn;
                l[mt][i] *= c;
#pragma unroll
                for (int d = 0; d < D / 8; ++d) {
                    acc[mt][d][2 * i] *= c;
                    acc[mt][d][2 * i + 1] *= c;
                }
            }
#pragma unroll
            for (int n = 0; n < BK / 8; ++n) {
                const float p0 = tc::ex2(fmaf(s[mt][n][0], scale_log2, -off[0]));
                const float p1 = tc::ex2(fmaf(s[mt][n][1], scale_log2, -off[0]));
                const float p2 = tc::ex2(fmaf(s[mt][n][2], scale_log2, -off[1]));
                const float p3 = tc::ex2(fmaf(s[mt][n][3], scale_log2, -off[1]));
                l[mt][0] += p0 + p1;
                l[mt][1] += p2 + p3;
                pa[mt][n / 2][(n & 1) * 2] = tc::pack_bf16(p0, p1);
                pa[mt][n / 2][(n & 1) * 2 + 1] = tc::pack_bf16(p2, p3);
            }
        }

        // O += P V: V [key][d] is the k x n operand, read transposed.
#pragma unroll
        for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
            for (int dp = 0; dp < D / 16; ++dp) {
                uint32_t vb[4];
                tc::ldsm_x4_trans(vb, vst + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                          dp * 16 + (lane >> 4) * 8);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    tc::mma16816(acc[mt][2 * dp], pa[mt][kc], vb[0], vb[1]);
                    tc::mma16816(acc[mt][2 * dp + 1], pa[mt][kc], vb[2], vb[3]);
                }
            }
        }
        __syncthreads();  // every warp is done with this stage before it is refilled
    }

    // Normalise, stage the warp's rows in its own rows of the Q tile
    // (which only this warp read), then 16-byte stores; the lse per row.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        float inv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            l[mt][i] += __shfl_xor_sync(tc::FULL, l[mt][i], 1);
            l[mt][i] += __shfl_xor_sync(tc::FULL, l[mt][i], 2);
            const bool dead = m[mt][i] <= NEG_INF * 0.5f;
            inv[i] = dead ? 0.f : 1.f / fmaxf(l[mt][i], 1e-30f);
            const int r = w0 + mt * 16 + g + 8 * i;
            if (lse != nullptr && t4 == 0 && r < seq)
                lse[((size_t)b * seq + r) * heads + h] =
                    dead ? -INFINITY : (m[mt][i] * scale_log2 + log2f(l[mt][i])) * tc::LN2;
        }
        bf16* rows = qs + (warp * RW + mt * 16) * LD;
#pragma unroll
        for (int d = 0; d < D / 8; ++d) {
            *reinterpret_cast<uint32_t*>(rows + g * LD + d * 8 + 2 * t4) =
                tc::pack_bf16(acc[mt][d][0] * inv[0], acc[mt][d][1] * inv[0]);
            *reinterpret_cast<uint32_t*>(rows + (g + 8) * LD + d * 8 + 2 * t4) =
                tc::pack_bf16(acc[mt][d][2] * inv[1], acc[mt][d][3] * inv[1]);
        }
        __syncwarp();
        tc::store_rows16<D, LD>(o + base, rows, tok, w0 + mt * 16, seq, lane);
    }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* qtag,
                   const int* ktag, void* o, float* lse, int batch, int seq, int heads,
                   float scale, cudaStream_t stream) {
    using C = Cfg<D>;
    static svoc::SmemLimit limit;  // above 48 KB, once per device
    const cudaError_t attr = limit.ensure(flash_fwd_bf16<D>, C::BYTES);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((seq + C::BQ - 1) / C::BQ, heads, batch);
    flash_fwd_bf16<D><<<grid, C::THREADS, C::BYTES, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        qtag, ktag, static_cast<bf16*>(o), lse, seq, heads, scale * tc::LOG2E);
    return cudaGetLastError();
}

}  // namespace bf16_body

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const int* qtag,
                       const int* ktag, void* o, float* lse, int batch, int seq, int heads,
                       float scale, cudaStream_t stream) {
    const dim3 grid((seq + BQ - 1) / BQ, heads, batch);
    flash_fwd_kernel<float, D><<<grid, Tile<D>::THREADS, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), qtag, ktag, static_cast<float*>(o), lse, seq, heads,
        scale);
    return cudaGetLastError();
}

// The body for this input type at this head width.
template <int D>
cudaError_t launch(int is_bf16, const void* q, const void* k, const void* v, const int* qtag,
                   const int* ktag, void* o, float* lse, int batch, int seq, int heads,
                   float scale, cudaStream_t stream) {
    return is_bf16 ? bf16_body::launch<D>(q, k, v, qtag, ktag, o, lse, batch, seq, heads,
                                          scale, stream)
                   : launch_f32<D>(q, k, v, qtag, ktag, o, lse, batch, seq, heads, scale,
                                   stream);
}

}  // namespace

extern "C" {

// q, k, v, o: [batch, seq, heads, head_dim] contiguous, bf16 (is_bf16 = 1,
// 16-byte aligned) or fp32; qtag, ktag: int32 [batch, seq]; lse: fp32
// [batch, seq, heads] or null. Launches on `stream` and returns the CUDA
// error of the launch (0 on success).
int svoc_flash_attention_fwd(const void* q, const void* k, const void* v, const int* qtag,
                             const int* ktag, void* o, float* lse, int is_bf16, int batch,
                             int seq, int heads, int head_dim, float scale, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (head_dim) {
        case 16: err = launch<16>(is_bf16, q, k, v, qtag, ktag, o, lse, batch, seq, heads, scale, s); break;
        case 32: err = launch<32>(is_bf16, q, k, v, qtag, ktag, o, lse, batch, seq, heads, scale, s); break;
        case 64: err = launch<64>(is_bf16, q, k, v, qtag, ktag, o, lse, batch, seq, heads, scale, s); break;
        case 128: err = launch<128>(is_bf16, q, k, v, qtag, ktag, o, lse, batch, seq, heads, scale, s); break;
        default: err = cudaErrorInvalidValue;
    }
    return (int)err;
}

}  // extern "C"
