// A fleet's random numbers in one launch, for Hopper (sm_90a), with a plain
// C interface for ctypes: for each of C claim keys, the draws of
// svoc_torch/sim/oracle.py::draw_fleet, bit for bit as jax.random under
// jax 0.9.0 draws them (svoc_torch/sim/prng.py):
//
//   k_fail, k_boot, k_perm = split(key, 3)           threefry(key, (0, i))
//   failing[j]  = (bits(k_fail, j) >> 9) * 2**-23     uniform, j < n_failing * M
//   boot[h, :S] = choice(split(k_boot, H)[h], W, S)   the first S of a
//                 one-round shuffle: key_h = threefry(k_boot, (0, h)),
//                 sub = threefry(key_h, (0, 1)), the stable order of
//                 bits(sub, i), i < W
//   perm        = permutation(k_perm, N)              shuffle_rounds(N) rounds,
//                 each sub = threefry(k, (0, 1)), k = threefry(k, (0, 0)),
//                 the stable order of bits(sub, i), composed as x[order]
//
// where bits(k, i) = y0 ^ y1 of threefry(k, (0, i)). A stable order is
// the order of the (word, index) pairs, kept here as one 64-bit number
// word << 32 | index, so a sort of distinct numbers gives it.
//
// Replaces no Pallas kernel: on the TPU, XLA fuses each draw of
// svoc_tpu/sim/oracle.py::gen_oracle_predictions with its hash. Its plain
// PyTorch version is svoc_torch/ops/fleet_draws.py::fleet_draws_plain, the
// composition draw_fleet ran before this kernel: 7 threefry launches a
// batch of fleets, two torch.sort calls and the slicing between them.
//
// What bounds it: the integer pipe. The hashes (3 + n_failing * M +
// H * (W + 2) + rounds * (N + 2) a claim) are each the hash's instructions
// on 64 INT32 lanes an SM, and the sorts' compare-exchanges run on the same
// pipe; the outputs are 4 bytes a failing value and 8 an index. One claim
// waits on its shuffle block, whose sort is a chain of 55 dependent passes
// at N = 1024; many claims' subsets fill the card. On the main path the
// launches it replaces, not its own time, were the cost.
//
// Design: one launch, blockIdx.x the claim and blockIdx.y the job, so the
// key schedule never leaves registers and nothing is allocated between
// draws. Job 0 is the claim's shuffle: one block holds the N numbers in
// shared memory and sorts them with a block bitonic sort (N padded to a
// power of two with ~0), once a round. Jobs 1 .. boot_blocks are the
// subsets: one warp an honest oracle, 8 a block, whose key schedule warp 0
// hashes once for the block (k_boot, then a lane an oracle's key and sub);
// each warp then puts its W numbers in its own slice of shared memory,
// sorts them with a warp bitonic sort (lanes synchronised by __syncwarp)
// and writes the first S indices. The remaining jobs are the failing values,
// 4 a thread, each thread hashing k_fail once. The shared memory a block
// takes is the larger of the two sorts' needs; above 48 KB the launcher
// raises the kernel's limit once per device (smem_limit.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFailPerThread = 4;

struct Shape {
    uint32_t w, m, n, n_failing, s, h;
    uint32_t w_pow2, n_pow2;  // the sorts' padded sizes
    uint32_t w_rounds, n_rounds;  // shuffle rounds: W's 0 or 1, N's 0, 1 or 2
    uint32_t boot_blocks;  // jobs 1 .. boot_blocks: kWarps oracles each
};

__device__ __forceinline__ void child(uint32_t k0, uint32_t k1, uint32_t i, uint32_t& o0, uint32_t& o1) {
    o0 = 0u;
    o1 = i;
    svoc::threefry2x32(k0, k1, o0, o1);
}

__device__ __forceinline__ uint32_t bits(uint32_t k0, uint32_t k1, uint32_t i) {
    uint32_t x0 = 0u, x1 = i;
    svoc::threefry2x32(k0, k1, x0, x1);
    return x0 ^ x1;
}

// Ascending bitonic sort of s[0, n), n a power of two, by `count` threads
// of ranks 0 .. count - 1; `sync` joins them after each pass.
template <typename Sync>
__device__ __forceinline__ void bitonic(unsigned long long* s, uint32_t n, uint32_t rank, uint32_t count, Sync sync) {
    for (uint32_t k = 2; k <= n; k <<= 1) {
        for (uint32_t j = k >> 1; j > 0; j >>= 1) {
            for (uint32_t t = rank; t < n / 2; t += count) {
                const uint32_t i = 2 * t - (t & (j - 1));  // bit j of i clear; its partner is i + j
                const unsigned long long a = s[i], b = s[i + j];
                if ((a > b) == ((i & k) == 0)) {
                    s[i] = b;
                    s[i + j] = a;
                }
            }
            sync();
        }
    }
}

// The numbers word << 32 | index of bits(sub, i), i < len, padded to `pow2`.
__device__ __forceinline__ void fill(unsigned long long* s, uint32_t k0, uint32_t k1, uint32_t len, uint32_t pow2,
                                     uint32_t rank, uint32_t count) {
    for (uint32_t i = rank; i < pow2; i += count)
        s[i] = i < len ? (static_cast<unsigned long long>(bits(k0, k1, i)) << 32) | i : ~0ull;
}

__global__ void __launch_bounds__(kThreads)
fleet_draws_kernel(const int64_t* __restrict__ keys, Shape sh, float* __restrict__ failing,
                   int64_t* __restrict__ boot, int64_t* __restrict__ perm) {
    extern __shared__ unsigned long long smem[];
    const uint32_t c = blockIdx.x, job = blockIdx.y, tid = threadIdx.x;
    const uint32_t key0 = static_cast<uint32_t>(keys[2 * c]);
    const uint32_t key1 = static_cast<uint32_t>(keys[2 * c + 1]);

    if (job == 0) {  // the shuffle: permutation(k_perm, N)
        int64_t* out = perm + static_cast<uint64_t>(c) * sh.n;
        uint32_t k0, k1;
        child(key0, key1, 2u, k0, k1);
        if (sh.n_rounds == 0) {
            for (uint32_t i = tid; i < sh.n; i += kThreads) out[i] = i;
            return;
        }
        uint32_t* x = reinterpret_cast<uint32_t*>(smem + sh.n_pow2);  // round 0's order, when a round follows
        auto sync = [] { __syncthreads(); };
        for (uint32_t r = 0; r < sh.n_rounds; ++r) {
            uint32_t s0, s1;
            child(k0, k1, 1u, s0, s1);
            if (r + 1 < sh.n_rounds) child(k0, k1, 0u, k0, k1);
            if (r > 0) __syncthreads();  // the last round's reads of smem are done
            fill(smem, s0, s1, sh.n, sh.n_pow2, tid, kThreads);
            __syncthreads();
            bitonic(smem, sh.n_pow2, tid, kThreads, sync);
            const bool last = r + 1 == sh.n_rounds;
            for (uint32_t i = tid; i < sh.n; i += kThreads) {
                const uint32_t order = static_cast<uint32_t>(smem[i]);
                const uint32_t value = r == 0 ? order : x[order];
                if (last)
                    out[i] = value;
                else
                    x[i] = value;
            }
        }
        return;
    }

    if (job <= sh.boot_blocks) {  // the subsets: choice(split(k_boot, H)[h], W, S)
        // The key schedule once a block: warp 0 hashes k_boot, and its
        // first kWarps lanes each an oracle's key_h and sub, into the first
        // kWarps words of shared memory; every warp then reads its own.
        unsigned long long* subs = smem;
        const uint32_t warp = tid / 32, lane = tid % 32;
        const uint32_t h0 = (job - 1) * kWarps;
        if (warp == 0) {
            uint32_t b0, b1;
            child(key0, key1, 1u, b0, b1);
            if (lane < kWarps && h0 + lane < sh.h) {
                uint32_t k0, k1;
                child(b0, b1, h0 + lane, k0, k1);
                if (sh.w_rounds) child(k0, k1, 1u, k0, k1);
                subs[lane] = static_cast<unsigned long long>(k1) << 32 | k0;
            }
        }
        __syncthreads();
        const uint32_t h = h0 + warp;
        if (h >= sh.h) return;
        int64_t* out = boot + (static_cast<uint64_t>(c) * sh.h + h) * sh.s;
        if (sh.w_rounds == 0) {  // W == 1: no round, the identity
            for (uint32_t i = lane; i < sh.s; i += 32) out[i] = i;
            return;
        }
        unsigned long long* s = smem + kWarps + warp * sh.w_pow2;
        fill(s, static_cast<uint32_t>(subs[warp]), static_cast<uint32_t>(subs[warp] >> 32), sh.w, sh.w_pow2, lane, 32);
        __syncwarp();
        bitonic(s, sh.w_pow2, lane, 32, [] { __syncwarp(); });
        for (uint32_t i = lane; i < sh.s; i += 32) out[i] = static_cast<uint32_t>(s[i]);
        return;
    }

    // The failing values: uniform(k_fail, (n_failing, M)).
    const uint32_t total = sh.n_failing * sh.m;
    const uint32_t first = (job - 1 - sh.boot_blocks) * (kThreads * kFailPerThread) + tid;
    if (first >= total) return;
    uint32_t f0, f1;
    child(key0, key1, 0u, f0, f1);
    float* out = failing + static_cast<uint64_t>(c) * total;
#pragma unroll
    for (int e = 0; e < kFailPerThread; ++e) {
        const uint32_t j = first + e * kThreads;
        if (j < total) out[j] = static_cast<float>(bits(f0, f1, j) >> 9) * 1.1920928955078125e-07f;  // 2**-23
    }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` for n_claims keys and returns a CUDA
// error code. keys: [n_claims, 2] int64 words; failing [n_claims, n_failing,
// m] float32, boot [n_claims, n - n_failing, s] int64, perm [n_claims, n]
// int64. w_rounds and n_rounds are shuffle_rounds(w) and shuffle_rounds(n).
// The caller checks that the shapes fit: w_rounds <= 1, n_rounds <= 2, the
// shared memory within 227 KB, the grid's y within 65535.
int svoc_fleet_draws(const int64_t* keys, int64_t n_claims, int64_t w, int64_t m, int64_t n, int64_t n_failing,
                     int64_t s, int64_t w_rounds, int64_t n_rounds, float* failing, int64_t* boot, int64_t* perm,
                     void* stream) {
    Shape sh;
    sh.w = static_cast<uint32_t>(w);
    sh.m = static_cast<uint32_t>(m);
    sh.n = static_cast<uint32_t>(n);
    sh.n_failing = static_cast<uint32_t>(n_failing);
    sh.s = static_cast<uint32_t>(s);
    sh.h = static_cast<uint32_t>(n - n_failing);
    sh.w_pow2 = 1;
    while (sh.w_pow2 < sh.w) sh.w_pow2 <<= 1;
    sh.n_pow2 = 1;
    while (sh.n_pow2 < sh.n) sh.n_pow2 <<= 1;
    sh.w_rounds = static_cast<uint32_t>(w_rounds);
    sh.n_rounds = static_cast<uint32_t>(n_rounds);
    sh.boot_blocks = (sh.h + kWarps - 1) / kWarps;
    const uint32_t fail_blocks = (sh.n_failing * sh.m + kThreads * kFailPerThread - 1) / (kThreads * kFailPerThread);
    const size_t boot_bytes = size_t(kWarps) * (1 + (sh.w_rounds ? sh.w_pow2 : 0)) * 8;
    const size_t perm_bytes = sh.n_rounds ? size_t(sh.n_pow2) * 8 + (sh.n_rounds > 1 ? size_t(sh.n) * 4 : 0) : 0;
    const int bytes = static_cast<int>(boot_bytes > perm_bytes ? boot_bytes : perm_bytes);
    if (bytes > svoc::kSmallSmemBytes) {
        static svoc::SmemLimit limit;  // above 48 KB, once per device
        const cudaError_t err = limit.ensure(fleet_draws_kernel, svoc::kMaxSmemBytes);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid(static_cast<uint32_t>(n_claims), 1 + sh.boot_blocks + fail_blocks);
    fleet_draws_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(keys, sh, failing, boot, perm);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
