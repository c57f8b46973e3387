// Shared device helpers of the Hopper spiking kernels.
//
// Bit-exactness: every spike count is an exact integer (int32 here), and the
// float epilogue follows the reference's rounding discipline
// (repro/kernels/ref.py, "Float-rounding discipline"): counts * scale and
// + bias are two separate round-to-nearest f32 operations, and the LIF
// membrane beta * v + pre commits one rounding per step.  The _rn
// intrinsics are never contracted into an FMA; the library is also built
// with -fmad=false.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Spike timesteps a thread keeps in registers at once: longer trains are
// taken in chunks of this many steps, the membrane carried from one chunk to
// the next, so T is bounded only by the shared memory a kernel stages.
#define XPK_MAX_T 8

// Pack the lowest bit of n <= 32 consecutive spike bytes into one word (bit i
// is byte i); bytes past n read as zero, which is the 32-lane padding.
__device__ __forceinline__ uint32_t xpk_nibble(uint32_t u) {
  // bytes b0..b3 in {0,1} at bits 0,8,16,24 -> b0 | b1<<1 | b2<<2 | b3<<3
  return ((u & 0x01010101u) * 0x10204080u) >> 28;
}

__device__ __forceinline__ uint32_t xpk_pack32(const uint8_t* p, int n) {
  if (n >= 32 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4 a = reinterpret_cast<const uint4*>(p)[0];
    const uint4 c = reinterpret_cast<const uint4*>(p)[1];
    return xpk_nibble(a.x) | xpk_nibble(a.y) << 4 | xpk_nibble(a.z) << 8 |
           xpk_nibble(a.w) << 12 | xpk_nibble(c.x) << 16 |
           xpk_nibble(c.y) << 20 | xpk_nibble(c.z) << 24 |
           xpk_nibble(c.w) << 28;
  }
  uint32_t w = 0;
  const int m = n < 32 ? n : 32;
  for (int i = 0; i < m; ++i) w |= static_cast<uint32_t>(p[i] & 1u) << i;
  return w;
}

// One LIF step: v = round(round(beta * v) + cur); spike = v >= v_thresh;
// v = v * (1 - spike) (reset to zero).  Returns the spike.
__device__ __forceinline__ uint8_t xpk_lif_step(float& v, float cur,
                                                float beta, float vth) {
  v = __fadd_rn(__fmul_rn(beta, v), cur);
  const float s = v >= vth ? 1.f : 0.f;
  v = __fmul_rn(v, 1.f - s);
  return static_cast<uint8_t>(s);
}

// One chunk of n <= XPK_MAX_T timesteps of the LIF over exact integer
// counts (acc[t * acc_stride], in registers or shared memory), with the
// current
//   pre = round(round(count * scale) + bias),
// continuing the membrane v of the chunk before (0 before the first).
__device__ __forceinline__ void xpk_lif_epilogue(
    const int* acc, int acc_stride, int n, float scale, float bias,
    float beta, float vth, float& v, uint8_t* out, size_t stride) {
#pragma unroll
  for (int t = 0; t < XPK_MAX_T; ++t) {
    if (t < n) {
      const float pre = __fadd_rn(
          __fmul_rn(static_cast<float>(acc[t * acc_stride]), scale), bias);
      out[t * stride] = xpk_lif_step(v, pre, beta, vth);
    }
  }
}

// ---------------------------------------------------------------------------
// One SSA query row over L cached rows (K2, K7; K3/K9 take the Rows policies)
// ---------------------------------------------------------------------------
//
// A Rows policy addresses the cache: k(j) / v(j) return the first of the hd
// spike bytes of cached row j, or nullptr for a row that is zero by contract
// (a null page).  A zero row never beats a comparator draw, so skipping it is
// exact.  The dense policy strides over one (slot, t, KV head) of a slot
// cache; the paged one goes through the slot's page table.

#define XPK_NULL_PAGE 0  // the permanently zero page of a paged pool

struct XpkDenseRows {
  const uint8_t* kb;  // row 0 of this (slot, t, KV head)
  const uint8_t* vb;
  size_t stride;      // bytes from one row to the next
  __device__ const uint8_t* k(int j) const { return kb + j * stride; }
  __device__ const uint8_t* v(int j) const { return vb + j * stride; }
};

struct XpkPagedRows {
  const uint8_t* kb;  // in-page row 0 of page 0 at this (t, KV head)
  const uint8_t* vb;
  const int* table;   // the slot's page-table row: logical block -> page
  size_t page_stride; // bytes from one physical page to the next
  int page_len, hd;
  __device__ const uint8_t* at(const uint8_t* base, int j) const {
    const int page = __ldg(table + j / page_len);
    if (page == XPK_NULL_PAGE) return nullptr;
    return base + page * page_stride + static_cast<size_t>(j % page_len) * hd;
  }
  __device__ const uint8_t* k(int j) const { return at(kb, j); }
  __device__ const uint8_t* v(int j) const { return at(vb, j); }
};

// Score stage, all threads of the block: bit j % 32 of sbits[j / 32] is
// popcount(q & k_j) > draws.score(j), for rows j < L.  A warp takes 32
// consecutive rows (one per lane, 16-byte loads when a row is aligned) and a
// ballot packs the spikes along the cache axis.  qw holds the query packed
// into ceil(hd/32) words.  Draws is a policy: score(j) gives row j's
// comparator integer (read from a tensor, or drawn where it is used).
template <class Rows, class Draws>
__device__ void xpk_ssa_scores(const Rows& rows, const uint32_t* qw, int hd,
                               int L, const Draws& draws, uint32_t* sbits) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5, wd = (hd + 31) / 32, wl = (L + 31) / 32;
  for (int jb = warp * 32; jb < wl * 32; jb += nwarps * 32) {
    const int j = jb + lane;
    const uint8_t* row = j < L ? rows.k(j) : nullptr;
    bool spike = false;
    if (row) {
      int cnt = 0;
      for (int w = 0; w < wd; ++w)
        cnt += __popc(qw[w] & xpk_pack32(row + 32 * w, hd - 32 * w));
      spike = cnt > draws.score(j);
    }
    const uint32_t word = __ballot_sync(0xffffffffu, spike);
    if (lane == 0) sbits[jb / 32] = word;
  }
}

// Output stage, all threads of the block: cnt[d] += popcount(s & v[:, d])
// for every value lane d < hd, reading only the rows whose score spiked.
// A thread owns four value lanes (a column quad; one 4-byte load a row
// where hd % 4 == 0 and the row is aligned, else byte loads) and one of
// `streams` = blockDim / quads row streams: stream r takes the score words
// r, r + streams, ..., and pulls four spiked rows' quads before it counts
// them.  At hd = 64 a warp reads two whole rows an instruction, and each of
// the block's 8 streams has four rows' loads (and a paged row's table
// lookups) in flight.  Partial counts are exact integers and meet in cnt
// (shared, zero before the call) by atomics.
template <class Rows>
__device__ void xpk_ssa_counts(const Rows& rows, const uint32_t* sbits, int L,
                               int hd, int* cnt) {
  const int nt = blockDim.x, quads = (hd + 3) / 4;
  const int streams = quads < nt ? nt / quads : 1;
  const int r = threadIdx.x / quads;
  if (r >= streams) return;
  const int wl = (L + 31) / 32;
  const bool word = hd % 4 == 0;
  for (int c4 = 4 * (threadIdx.x - r * quads); c4 < hd; c4 += 4 * nt) {
    int c[4] = {0, 0, 0, 0};
    for (int w = r; w < wl; w += streams) {
      uint32_t m = sbits[w];
      while (m) {
        const uint8_t* p[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          p[u] = nullptr;
          if (m) {
            p[u] = rows.v(32 * w + __ffs(static_cast<int>(m)) - 1);
            m &= m - 1;
          }
        }
        uint32_t x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          x[u] = 0;
          if (!p[u]) continue;
          const uint8_t* q = p[u] + c4;
          if (word && (reinterpret_cast<uintptr_t>(q) & 3) == 0) {
            x[u] = *reinterpret_cast<const uint32_t*>(q);
          } else {
            for (int e = 0; e < 4 && c4 + e < hd; ++e)
              x[u] |= static_cast<uint32_t>(q[e]) << (8 * e);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[e] += (x[u] >> (8 * e)) & 1;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c[e]) atomicAdd(cnt + c4 + e, c[e]);
  }
}

// Round a byte offset up to 16 so every shared segment takes vector loads.
__host__ __device__ __forceinline__ size_t xpk_align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

static inline int xpk_set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}
