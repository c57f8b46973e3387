// The threefry2x32 draws of jax.random, in a kernel's registers.
//
// Device twin of repro_torch/prng.py (itself the twin of jax.random in its
// partitionable threefry mode), formula for formula, in uint32 arithmetic
// that wraps where the torch twin masks with & 0xffffffff:
//
//   threefry2x32(key, (x0, x1))   the 20-round block cipher
//   fold_in(key, d)             = threefry(key, (0, d))
//   split(key)[i]               = threefry(key, (0, i))
//   random_bits(key, i)         = y0 ^ y1 of threefry(key, (i >> 32, i))
//   randint(key, i, lo, span)   = JAX's two-word method at flat index i:
//       (hk, lk) = split(key); hi = random_bits(hk, i); lo_ = random_bits(lk, i)
//       off = ((hi % span) * mult + lo_ % span) % span,  mult = (2^16 % span)^2 % span
//     (the multiplier is computed on the host, as prng.randint does)
//
// A draw costs two cipher calls (about 200 integer operations) and reads
// nothing from device memory.  Header only: each kernel source that draws
// includes it.
#pragma once

#include <cstdint>

struct XpkKey {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t xpk_rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds (jax._src.prng.threefry2x32_p).
__device__ __forceinline__ XpkKey xpk_threefry2x32(XpkKey key, uint32_t x0,
                                                   uint32_t x1) {
  const uint32_t ks[3] = {key.k0, key.k1, key.k0 ^ key.k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = xpk_rotl(x1, rot[i % 2][r]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return XpkKey{x0, x1};
}

__device__ __forceinline__ XpkKey xpk_fold_in(XpkKey key, uint32_t data) {
  return xpk_threefry2x32(key, 0u, data);
}

// split(key, n)[i] for any n: the i-th subkey does not depend on n.
__device__ __forceinline__ XpkKey xpk_split(XpkKey key, uint32_t i) {
  return xpk_threefry2x32(key, 0u, i);
}

__device__ __forceinline__ uint32_t xpk_random_bits(XpkKey key, uint64_t i) {
  const XpkKey y = xpk_threefry2x32(key, static_cast<uint32_t>(i >> 32),
                                    static_cast<uint32_t>(i));
  return y.k0 ^ y.k1;
}

// The two subkeys randint draws its higher and lower words from.
struct XpkRandint {
  XpkKey hi, lo;
  uint32_t span, mult;
  int lo_val;  // minval

  __device__ static XpkRandint make(XpkKey key, int minval, uint32_t span,
                                    uint32_t mult) {
    return XpkRandint{xpk_split(key, 0), xpk_split(key, 1), span, mult,
                      minval};
  }

  // jax.random.randint(key, shape, minval, minval + span) at flat index i
  __device__ int at(uint64_t i) const {
    const uint32_t h = xpk_random_bits(hi, i), l = xpk_random_bits(lo, i);
    const uint32_t off = ((h % span) * mult + l % span) % span;
    return static_cast<int>(off + static_cast<uint32_t>(lo_val));
  }
};
