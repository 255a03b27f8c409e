// threefry2x32, JAX's default PRNG hash, as one device function: shared by
// the hash kernel (threefry.cu) and the fleet's draws (fleet_draws.cu), so
// that both compute the same bits from one copy of the rounds.
//
// Mirrors jax/_src/prng.py's unrolled lowering _threefry2x32_lowering
// (:883-938) under jax 0.9.0: 20 rounds of an add, a rotate and a xor, a key
// injection after every four. The rotate is one funnel shift (SHF); the
// compiler folds each injection into the next round's add (IADD3).

#pragma once

#include <stdint.h>

namespace svoc {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// Four rounds with rotations r0..r3 (jax's apply_round).
__device__ __forceinline__ void threefry_rounds(uint32_t& x0, uint32_t& x1, int r0, int r1, int r2, int r3) {
    x0 += x1; x1 = rotl32(x1, r0); x1 ^= x0;
    x0 += x1; x1 = rotl32(x1, r1); x1 ^= x0;
    x0 += x1; x1 = rotl32(x1, r2); x1 ^= x0;
    x0 += x1; x1 = rotl32(x1, r3); x1 ^= x0;
}

// (x0, x1) = threefry2x32((k0, k1), (x0, x1)), in place.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
    const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
    x0 += k0; x1 += k1;
    threefry_rounds(x0, x1, 13, 15, 26, 6);
    x0 += k1; x1 += k2 + 1u;
    threefry_rounds(x0, x1, 17, 29, 16, 24);
    x0 += k2; x1 += k0 + 2u;
    threefry_rounds(x0, x1, 13, 15, 26, 6);
    x0 += k0; x1 += k1 + 3u;
    threefry_rounds(x0, x1, 17, 29, 16, 24);
    x0 += k1; x1 += k2 + 4u;
    threefry_rounds(x0, x1, 13, 15, 26, 6);
    x0 += k2; x1 += k0 + 5u;
}

}  // namespace svoc
