// Counter-based random draws on the device: the hash of
// pyisingmontecarlo_tpu_torch/ops/lanerng.py (and of the JAX package's
// ops/lanerng.py), on uint32_t, where multiplies wrap mod 2^32 and shifts are
// logical by the type.
#pragma once

#include <cstdint>

// 31-bit uniform draw for (seed, pos, ctr); pos is the replica-local position.
__device__ __forceinline__ uint32_t lane_draw31(uint32_t seed, uint32_t pos, uint32_t ctr) {
    uint32_t x = seed + pos * 0x9E3779B1u + ctr * 0xC2B2AE3Du;
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    x ^= pos * 0x85EBCA77u + ctr * 0x27D4EB2Eu;
    x ^= x >> 16;
    x *= 0x7FEB352Du;
    x ^= x >> 15;
    return x >> 1;
}
