// threefry2x32, JAX's default PRNG hash, for Hopper (sm_90a), with a plain
// C interface for ctypes: out[b, i] = threefry2x32(key[b], counter(b, i)),
// the counter being the 64-bit number base[b] + i split into its high and
// low 32-bit words, as jax/_src/prng.py's iota_2x32_shape splits a flat
// index.
//
// Replaces no Pallas kernel: on the TPU, XLA fuses the hash
// (jax/_src/prng.py threefry2x32, the unrolled lowering
// _threefry2x32_lowering, :883-938) into one loop of whatever draw uses
// it. Written in PyTorch ops with uint32 arithmetic emulated in int64,
// one hash is about 160 elementwise launches. Its plain PyTorch version is
// svoc_torch/ops/threefry.py::threefry2x32_plain; the rounds themselves
// are svoc::threefry2x32 in threefry.cuh, shared with fleet_draws.cu.
//
// What bounds it: a hash's 20 rotates (SHF) and 20 xors (LOP3), plus the
// xor of its two words for bits, on Hopper's 64 INT32 lanes an SM (its
// adds issue to the FMA pipe as IMAD), against 8 bytes written a counter
// (16 a pair) and 16 a key read once. At 1980 MHz and 3.35 TB/s the two
// take about the same time (chip_smoke.py's THREEFRY_INT_OPS and bound).
// The four counters a thread, not the lost division, make this body
// faster than one counter a thread: a one-counter body on a 2-D grid with
// no division took as long as the 64-bit-division one (20.6-21.8 and
// 22.0-22.2 us against 14.1 at [57344, 64]; 6.4-6.8 and 6.9 against 5.7
// at one key's 2**20 bits; an H100 at 700 W, chip_smoke.py's
// threefry_times); at a fold_in or a split of 64 keys all three take
// 1.2-1.4 us, the launch.
//
// Design: a thread takes 4 consecutive counters of one key, so that the
// key pair and the base stay in registers across 4 independent hashes and
// a thread's words leave in 16-byte stores (longlong2: two xor words, or
// one pair). A thread finds its key by a multiply-high with a magic number
// computed on the host (t / groups for t < 2**31), so no thread divides.
// The counter's carry into the high word is taken per counter, exactly:
// base + i < 2**33. Words are held as int64 in [0, 2^32) in device memory
// (PyTorch has no uint32 sort), converted once on load and store.
// `xor_words` = 1 writes bits1 ^ bits2 (jax's 32-bit random bits); 0
// writes the pair (a key of split or fold_in).

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;  // counters a thread

__global__ void __launch_bounds__(kThreads)
threefry_kernel(const int64_t* __restrict__ keys, const int64_t* __restrict__ base,
                uint32_t base0, uint32_t n, uint32_t groups, uint32_t total, uint32_t magic,
                uint32_t shift, int xor_words, int64_t* __restrict__ out) {
    const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
    if (t >= total) return;
    // b = t / groups, by the host's magic number (shift 32: groups == 1).
    const uint32_t b = shift == 32u ? t : __umulhi(t, magic) >> shift;
    const uint32_t i0 = (t - b * groups) * kPerThread;
    const uint32_t k0 = static_cast<uint32_t>(keys[2 * b]);
    const uint32_t k1 = static_cast<uint32_t>(keys[2 * b + 1]);
    const uint32_t c0 = base != nullptr ? static_cast<uint32_t>(base[b]) : base0;
    const uint32_t lo0 = c0 + i0;
    const uint32_t hi0 = lo0 < c0 ? 1u : 0u;
    uint32_t y0[kPerThread], y1[kPerThread];
#pragma unroll
    for (int v = 0; v < kPerThread; ++v) {
        const uint32_t lo = lo0 + static_cast<uint32_t>(v);
        uint32_t x0 = hi0 + (lo < lo0 ? 1u : 0u);
        uint32_t x1 = lo;
        svoc::threefry2x32(k0, k1, x0, x1);
        y0[v] = x0;
        y1[v] = x1;
    }
    const uint64_t at = static_cast<uint64_t>(b) * n + i0;  // the first counter's element
    const bool whole = i0 + kPerThread <= n;
    if (xor_words) {
        int64_t* o = out + at;
        if (whole && (n & 1u) == 0u) {  // at is even: 16-byte aligned
            longlong2* o2 = reinterpret_cast<longlong2*>(o);
            o2[0] = make_longlong2(static_cast<long long>(y0[0] ^ y1[0]), static_cast<long long>(y0[1] ^ y1[1]));
            o2[1] = make_longlong2(static_cast<long long>(y0[2] ^ y1[2]), static_cast<long long>(y0[3] ^ y1[3]));
        } else {
#pragma unroll
            for (int v = 0; v < kPerThread; ++v)
                if (i0 + v < n) o[v] = static_cast<int64_t>(y0[v] ^ y1[v]);
        }
    } else {
        longlong2* o2 = reinterpret_cast<longlong2*>(out + 2 * at);
#pragma unroll
        for (int v = 0; v < kPerThread; ++v)
            if (whole || i0 + v < n) o2[v] = make_longlong2(static_cast<long long>(y0[v]), static_cast<long long>(y1[v]));
    }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` over n_keys x n counters and returns
// cudaGetLastError(). keys: [n_keys, 2] int64 words; base: [n_keys] int64
// or null (then base0 for every key), each a uint32. The caller checks
// shapes, dtypes and that n_keys * ceil(n / 4) < 2**31 - 256 and
// n < 2**32, so that every index below fits 32 bits; out is 16-byte
// aligned (a fresh allocation).
int svoc_threefry2x32(const int64_t* keys, const int64_t* base, int64_t base0, int64_t n_keys,
                      int64_t n, int xor_words, int64_t* out, void* stream) {
    const uint32_t groups = static_cast<uint32_t>((n + kPerThread - 1) / kPerThread);
    const uint32_t total = static_cast<uint32_t>(n_keys) * groups;
    // Division by the invariant `groups` for dividends below 2**31
    // (Granlund and Montgomery): p = 31 + ceil(log2 groups),
    // magic = ceil(2**p / groups), q = umulhi(t, magic) >> (p - 32).
    uint32_t magic = 0, shift = 32;
    if (groups > 1) {
        uint32_t log2 = 0;
        while ((1ull << log2) < groups) ++log2;
        const uint32_t p = 31 + log2;
        magic = static_cast<uint32_t>(((1ull << p) + groups - 1) / groups);
        shift = p - 32;
    }
    const uint32_t blocks = (total + kThreads - 1) / kThreads;
    threefry_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        keys, base, static_cast<uint32_t>(base0), static_cast<uint32_t>(n), groups, total, magic, shift,
        xor_words, out);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
