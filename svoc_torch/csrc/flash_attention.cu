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
// - q, k and v are read as fp32 (bf16 inputs are upcast), q is scaled by
//   1/sqrt(D) before the product, and the softmax is the online
//   recurrence with a running max, denominator and accumulator in fp32.
// - NEG_INF is the finite -1e30 sentinel of the TPU kernel, never -inf,
//   so that no inf - inf can make a NaN.
// - A row that sees no key writes exactly 0 and, when asked, lse = -inf.
//
// What bounds it: at the flagship shape (B = 256 rows, T = 128, 12 heads
// of 64, bf16) one launch reads q, k, v and writes o, 4 x 32768 x 768 x 2
// bytes = 201 MB, about 60 us at 3.35 TB/s; its 12.9 GFLOP take about
// 13 us on the bf16 tensor cores. So it is bound by memory on paper. This
// first kernel does its arithmetic on the fp32 CUDA cores (the TPU
// kernel's own numerics) and is bound by those in practice; wgmma and TMA
// come later.
//
// Design: one block per (query tile of 64 rows, head, batch row). Each
// query row belongs to TPR threads (1 for D <= 32, D/32 above), each
// holding D/TPR contiguous elements of the scaled q row and of the
// accumulator in registers; a score is a per-thread partial dot product
// summed over the TPR lanes with shuffles. K and V tiles of BK rows go
// through shared memory as fp32, each thread's slice padded by 4 floats
// so that the TPR lanes of a row read 16-byte vectors from distinct
// banks. The online softmax is updated once per 16 keys. The tag mask is
// rebuilt from the two int32 tag vectors per key; rows and keys past T
// are masked here, so T need not divide any tile. The public layout
// [B, T, H, D] is read and written in place, with no transposes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;  // query rows per block
constexpr int CH = 16;  // keys per online-softmax update

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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* qtag,
                   const int* ktag, void* o, float* lse, int batch, int seq, int heads,
                   float scale, cudaStream_t stream) {
    const dim3 grid((seq + BQ - 1) / BQ, heads, batch);
    flash_fwd_kernel<T, D><<<grid, Tile<D>::THREADS, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), qtag,
        ktag, static_cast<T*>(o), lse, seq, heads, scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int head_dim, const void* q, const void* k, const void* v,
                     const int* qtag, const int* ktag, void* o, float* lse, int batch,
                     int seq, int heads, float scale, cudaStream_t stream) {
    switch (head_dim) {
        case 16: return launch<T, 16>(q, k, v, qtag, ktag, o, lse, batch, seq, heads, scale, stream);
        case 32: return launch<T, 32>(q, k, v, qtag, ktag, o, lse, batch, seq, heads, scale, stream);
        case 64: return launch<T, 64>(q, k, v, qtag, ktag, o, lse, batch, seq, heads, scale, stream);
        case 128: return launch<T, 128>(q, k, v, qtag, ktag, o, lse, batch, seq, heads, scale, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// q, k, v, o: [batch, seq, heads, head_dim] contiguous, bf16 (is_bf16 = 1)
// or fp32; qtag, ktag: int32 [batch, seq]; lse: fp32 [batch, seq, heads]
// or null. Launches on `stream` and returns cudaGetLastError().
int svoc_flash_attention_fwd(const void* q, const void* k, const void* v, const int* qtag,
                             const int* ktag, void* o, float* lse, int is_bf16, int batch,
                             int seq, int heads, int head_dim, float scale, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        is_bf16 ? dispatch<__nv_bfloat16>(head_dim, q, k, v, qtag, ktag, o, lse, batch, seq,
                                          heads, scale, s)
                : dispatch<float>(head_dim, q, k, v, qtag, ktag, o, lse, batch, seq, heads,
                                  scale, s);
    return (int)err;
}

}  // extern "C"
