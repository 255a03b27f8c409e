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
//   backward scales the dot product (s = scale q.k, as _p_block does);
//   the forward kernel scales q before it. Both are within the bars.
// - All arithmetic is fp32 (bf16 inputs are upcast); the outputs are
//   written in the input type.
//
// What bounds them: at the flagship shape (B = 256 rows, T = 128, 12
// heads of 64, bf16) dq reads q, k, v, dO, lse, delta and the tags and
// writes dq, about 255 MB, 76 us at 3.35 TB/s; dk/dv writes two outputs,
// about 305 MB, 91 us. Their 6 and 8 flops per head element per live
// (q, k) pair take a few us on the bf16 tensor cores. So both are bound
// by memory on paper. These first kernels do their arithmetic on the
// fp32 CUDA cores, as the forward does, and are bound by those in
// practice; mma/wgmma and TMA come later.
//
// Design. Each output row has one owner, so there are no atomics and the
// results are deterministic, as with the TPU's split into two kernels:
// - dq: one block per (tile of 64 query rows, head, batch row). A query
//   row belongs to TPR = D/16 threads, each holding 16 contiguous
//   elements of q, dO and the dq accumulator in registers; the row's lse
//   and delta are registers too. Key and value tiles go through shared
//   memory as fp32 and are walked key by key.
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

namespace {

constexpr int ROWS = 64;  // output rows (queries for dq, keys for dk/dv) per block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

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
// offset of this batch row and head) into shared memory as fp32 in the
// padded slice layout; rows past n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ a, const T* __restrict__ b,
                                          float* as, float* bs, size_t base,
                                          size_t tok_stride, int r0, int n) {
    using L = Split<D>;
    for (int e = threadIdx.x; e < L::TILE * D; e += L::THREADS) {
        const int r = e / D, c = e % D;
        float ax = 0.f, bx = 0.f;
        if (r < n) {
            const size_t off = base + (size_t)(r0 + r) * tok_stride + c;
            ax = to_f32(a[off]);
            bx = to_f32(b[off]);
        }
        const int s = r * L::ROW + (c / L::DP) * L::SLICE + c % L::DP;
        as[s] = ax;
        bs[s] = bx;
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(Split<D>::THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const int* __restrict__ qtag, const int* __restrict__ ktag,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int seq, int heads,
                float scale) {
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
        qv[i] = active ? to_f32(q[mine + i]) : 0.f;
        dov[i] = active ? to_f32(dout[mine + i]) : 0.f;
        acc[i] = 0.f;
    }

    for (int k0 = 0; k0 < seq; k0 += L::TILE) {
        const int kn = min(L::TILE, seq - k0);
        __syncthreads();  // the previous tile is consumed
        load_tile<T, D>(k, v, ks, vs, base, tok_stride, k0, kn);
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
    for (int i = 0; i < L::DP; ++i) dq[mine + i] = from_f32<T>(acc[i] * scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(Split<D>::THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ qtag, const int* __restrict__ ktag,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                 int seq, int heads, float scale) {
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
        kv[i] = active ? to_f32(k[mine + i]) : 0.f;
        vv[i] = active ? to_f32(v[mine + i]) : 0.f;
        dka[i] = 0.f;
        dva[i] = 0.f;
    }

    for (int q0 = 0; q0 < seq; q0 += L::TILE) {
        const int qn = min(L::TILE, seq - q0);
        __syncthreads();
        load_tile<T, D>(q, dout, qs, dos, base, tok_stride, q0, qn);
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
        dk[mine + i] = from_f32<T>(dka[i] * scale);
        dv[mine + i] = from_f32<T>(dva[i]);
    }
}

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

template <bool DKV, typename T, int D>
cudaError_t launch(const Args& a) {
    const dim3 grid((a.seq + ROWS - 1) / ROWS, a.heads, a.batch);
    const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
            *v = static_cast<const T*>(a.v), *dout = static_cast<const T*>(a.dout);
    if constexpr (DKV) {
        flash_dkv_kernel<T, D><<<grid, Split<D>::THREADS, 0, a.stream>>>(
            q, k, v, a.qtag, a.ktag, dout, a.lse, a.delta, static_cast<T*>(a.out0),
            static_cast<T*>(a.out1), a.seq, a.heads, a.scale);
    } else {
        flash_dq_kernel<T, D><<<grid, Split<D>::THREADS, 0, a.stream>>>(
            q, k, v, a.qtag, a.ktag, dout, a.lse, a.delta, static_cast<T*>(a.out0), a.seq,
            a.heads, a.scale);
    }
    return cudaGetLastError();
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
// bf16 (is_bf16 = 1) or fp32; qtag, ktag: int32 [batch, seq]; lse and
// delta: fp32 [batch, seq, heads]. Launch on `stream` and return
// cudaGetLastError().
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
