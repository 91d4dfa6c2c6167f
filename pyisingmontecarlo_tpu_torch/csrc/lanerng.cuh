// Counter-based random draws on the device: the hash of
// pyisingmontecarlo_tpu_torch/ops/lanerng.py (and of the JAX package's
// ops/lanerng.py), on uint32_t, where multiplies wrap mod 2^32 and shifts are
// logical by the type.
#pragma once

#include <cstdint>

// lane_draw31(seed, xw + kg, ctr) with the row's part of the position folded in
// once: ha = seed + xw * 0x9E3779B1 + ctr * 0xC2B2AE3D and
// hb = xw * 0x85EBCA77 + ctr * 0x27D4EB2E (every product mod 2^32, so the
// draw is the same).
__device__ __forceinline__ uint32_t lane_draw31_split(uint32_t ha, uint32_t hb, uint32_t kg) {
    uint32_t x = ha + kg * 0x9E3779B1u;
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    x ^= hb + kg * 0x85EBCA77u;
    x ^= x >> 16;
    x *= 0x7FEB352Du;
    x ^= x >> 15;
    return x >> 1;
}

// 31-bit uniform draw for (seed, pos, ctr); pos is the replica-local position.
__device__ __forceinline__ uint32_t lane_draw31(uint32_t seed, uint32_t pos, uint32_t ctr) {
    return lane_draw31_split(seed + ctr * 0xC2B2AE3Du, ctr * 0x27D4EB2Eu, pos);
}
