// The counter-based generator every kernel of the port shares.
//
// u(id, level, k) = fmix32(fmix32(id + GOLDEN * (level + 1)) ^ (k * KMULT))
// with fmix32 the MurmurHash3 32-bit finalizer; all arithmetic is u32 and
// wraps mod 2**32, exactly as core/rng.py and the plain-torch twins do.
// Included by asura_place.cu and baselines.cu; kernels/build.py hashes
// this header with every source that includes it.

#pragma once

#include <cstdint>

namespace port_hash {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kKmult = 0x85EBCA77u;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The level-``level`` generator's seed for ``id``: a function of (id,
// level) alone, so a lane that consults a level again may keep it.
__device__ __forceinline__ uint32_t level_seed(uint32_t id, uint32_t level) {
  return fmix32(id + kGolden * (level + 1u));
}

// The ``counter``-th draw of the generator whose seed is ``seed``.
__device__ __forceinline__ uint32_t draw_seeded(uint32_t seed, uint32_t counter) {
  return fmix32(seed ^ (counter * kKmult));
}

__device__ __forceinline__ uint32_t draw_u32(uint32_t id, uint32_t level,
                                             uint32_t counter) {
  return draw_seeded(level_seed(id, level), counter);
}

}  // namespace port_hash
