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
// one hash is about 160 elementwise launches; a fleet draws through six
// or seven dependent hashes. Its plain PyTorch version is
// svoc_torch/ops/threefry.py::threefry2x32_plain.
//
// What bounds it: bytes. Each counter costs 20 rounds of an add, a
// rotate and a xor and five key injections, about 115 integer operations
// in registers, against 8 or 16 bytes written (and 16 bytes a key read
// once); at 3.35 TB/s the writes take longer than the operations at the
// CUDA cores' rate.
//
// Design: one thread per counter. The key pair and the counter live in
// registers; the key (and the optional per-key base) broadcast along the
// counter axis, so a batch of B keys times n counters is one launch and
// reads no counter array. Words are held as int64 in [0, 2^32) in
// device memory (PyTorch has no uint32 sort), converted once on load and
// store. `xor_words` = 1 writes bits1 ^ bits2 (jax's 32-bit random bits);
// 0 writes the pair (a key of split or fold_in).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// Four rounds with rotations r0..r3 (jax's apply_round).
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1, int r0, int r1, int r2, int r3) {
    x0 += x1; x1 = rotl(x1, r0); x1 ^= x0;
    x0 += x1; x1 = rotl(x1, r1); x1 ^= x0;
    x0 += x1; x1 = rotl(x1, r2); x1 ^= x0;
    x0 += x1; x1 = rotl(x1, r3); x1 ^= x0;
}

__global__ void __launch_bounds__(kThreads)
threefry_kernel(const int64_t* __restrict__ keys, const int64_t* __restrict__ base,
                uint64_t base0, int64_t n, int64_t total, int xor_words,
                int64_t* __restrict__ out) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (t >= total) return;
    const int64_t b = t / n;
    const int64_t i = t - b * n;
    const uint32_t k0 = static_cast<uint32_t>(keys[2 * b]);
    const uint32_t k1 = static_cast<uint32_t>(keys[2 * b + 1]);
    const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
    const uint64_t c = (base != nullptr ? static_cast<uint64_t>(base[b]) : base0) + static_cast<uint64_t>(i);
    uint32_t x0 = static_cast<uint32_t>(c >> 32) + k0;
    uint32_t x1 = static_cast<uint32_t>(c) + k1;
    rounds(x0, x1, 13, 15, 26, 6);
    x0 += k1; x1 += k2 + 1u;
    rounds(x0, x1, 17, 29, 16, 24);
    x0 += k2; x1 += k0 + 2u;
    rounds(x0, x1, 13, 15, 26, 6);
    x0 += k0; x1 += k1 + 3u;
    rounds(x0, x1, 17, 29, 16, 24);
    x0 += k1; x1 += k2 + 4u;
    rounds(x0, x1, 13, 15, 26, 6);
    x0 += k2; x1 += k0 + 5u;
    if (xor_words) {
        out[t] = static_cast<int64_t>(x0 ^ x1);
    } else {
        out[2 * t] = static_cast<int64_t>(x0);
        out[2 * t + 1] = static_cast<int64_t>(x1);
    }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` over n_keys x n counters and returns
// cudaGetLastError(). keys: [n_keys, 2] int64 words; base: [n_keys] int64
// or null (then base0 for every key). The caller checks shapes, dtypes
// and that the grid fits.
int svoc_threefry2x32(const int64_t* keys, const int64_t* base, int64_t base0, int64_t n_keys,
                      int64_t n, int xor_words, int64_t* out, void* stream) {
    const int64_t total = n_keys * n;
    const int64_t blocks = (total + kThreads - 1) / kThreads;
    threefry_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        keys, base, static_cast<uint64_t>(base0), n, total, xor_words, out);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
