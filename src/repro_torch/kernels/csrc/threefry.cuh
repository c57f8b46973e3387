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

// ---------------------------------------------------------------------------
// Draws for kernels whose pace the draws set (K8's keyed tile)
// ---------------------------------------------------------------------------

// x % span for every uint32 x and every span >= 1, without a division
// (Lemire, Kaser and Kurz, "Faster remainder by direct computation"): with
// M = floor((2^64 - 1) / span) + 1 computed on the host (it wraps to 0 at
// span 1, where the remainder is 0), x % span = (M * x mod 2^64) * span >> 64.
__device__ __forceinline__ uint32_t xpk_fastmod(uint32_t x, uint64_t M,
                                                uint32_t span) {
  return static_cast<uint32_t>(
      __umul64hi(M * static_cast<uint64_t>(x), static_cast<uint64_t>(span)));
}

// n threefry2x32 calls in lockstep, round by round: n independent chains
// whose instructions the scheduler interleaves.
template <int n>
__device__ __forceinline__ void xpk_threefry2x32_n(const XpkKey (&key)[n],
                                                   uint32_t (&x0)[n],
                                                   uint32_t (&x1)[n]) {
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t ks[n][3];
#pragma unroll
  for (int a = 0; a < n; ++a) {
    ks[a][0] = key[a].k0;
    ks[a][1] = key[a].k1;
    ks[a][2] = key[a].k0 ^ key[a].k1 ^ 0x1BD11BDAu;
    x0[a] += ks[a][0];
    x1[a] += ks[a][1];
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int a = 0; a < n; ++a) {
        x0[a] += x1[a];
        x1[a] = xpk_rotl(x1[a], rot[i % 2][r]) ^ x0[a];
      }
    }
#pragma unroll
    for (int a = 0; a < n; ++a) {
      x0[a] += ks[a][(i + 1) % 3];
      x1[a] += ks[a][(i + 2) % 3] + static_cast<uint32_t>(i + 1);
    }
  }
}

// jax.random.randint(key, shape, 0, span) at flat indices, n draws at once:
// the 2n cipher calls (each index's higher and lower word) run in
// lockstep, and the three remainders are xpk_fastmod's.  hi and lo are
// randint's own split of its key; mult and M come from the host.
struct XpkRandintFast {
  XpkKey hi, lo;
  uint64_t M;
  uint32_t span, mult;

  template <int n>
  __device__ __forceinline__ void at(const uint64_t (&i)[n],
                                     uint32_t (&out)[n]) const {
    XpkKey key[2 * n];
    uint32_t x0[2 * n], x1[2 * n];
#pragma unroll
    for (int a = 0; a < n; ++a) {
      key[2 * a] = hi;
      key[2 * a + 1] = lo;
      x0[2 * a] = x0[2 * a + 1] = static_cast<uint32_t>(i[a] >> 32);
      x1[2 * a] = x1[2 * a + 1] = static_cast<uint32_t>(i[a]);
    }
    xpk_threefry2x32_n<2 * n>(key, x0, x1);
#pragma unroll
    for (int a = 0; a < n; ++a) {
      const uint32_t h = xpk_fastmod(x0[2 * a] ^ x1[2 * a], M, span);
      const uint32_t l = xpk_fastmod(x0[2 * a + 1] ^ x1[2 * a + 1], M, span);
      out[a] = xpk_fastmod(h * mult + l, M, span);
    }
  }
};

// randint's subkeys of both halves of split(key), a warp at a time: lane l
// (l < 4) derives split(split(key)[l & 1])[l >> 1], two cipher calls where
// one thread alone would make six, and the warp shares them by shuffles.
// Every lane of the warp must call it.
__device__ __forceinline__ void xpk_split_randint_keys(XpkKey key, XpkKey& hi0,
                                                       XpkKey& lo0,
                                                       XpkKey& hi1,
                                                       XpkKey& lo1) {
  const unsigned lane = threadIdx.x & 31u;
  const XpkKey sub = xpk_split(xpk_split(key, lane & 1u), (lane >> 1) & 1u);
  const auto from = [&](int src) {
    return XpkKey{__shfl_sync(0xffffffffu, sub.k0, src),
                  __shfl_sync(0xffffffffu, sub.k1, src)};
  };
  hi0 = from(0);
  hi1 = from(1);
  lo0 = from(2);
  lo1 = from(3);
}
