// K2: one stochastic-spiking-attention query row against a cached KV train.
//
// Replaces the TPU kernel repro/kernels/ssa_attention.py:ssa_decode_kernel
// (pallas_call at :120, body _ssa_decode_body at :80).
//
// q uint8 [G, D], k and v uint8 [G, L, D] (binary; one byte per spike, as the
// cache stores them), rs int32 [G, L], ra int32 [G, D] -> out uint8 [G, D],
// one row per g = (slot, timestep, head):
//   s_j  = popcount(q & k_j) > rs[j]          (score comparators)
//   a_d  = popcount(s & v[:, d]) > ra[d]      (output comparators)
//
// Bound on the card: bytes -- K and V are read once (2 G L D bytes) for
// G (L + 1) D AND/popcount operations.  Design: one block per g.  The query
// row is packed into uint32 lanes in shared memory; each thread packs one
// cached key row (16-byte loads when the row is aligned) and popcounts it
// against the query; a warp ballot over 32 consecutive rows packs the score
// spikes along the cache axis without a second pass.  The output stage gives
// each thread one value column: it packs 32 rows of that column at a time
// (coalesced across the warp) and popcounts them against the score word,
// skipping words with no score spike.  Lanes past D and rows past L read as
// zero: the reference pads both to 32 with zeros, and a zero spike never
// beats a comparator draw.  All counts are exact integers.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void ssa_decode_kernel(const uint8_t* __restrict__ q,
                                  const uint8_t* __restrict__ k,
                                  const uint8_t* __restrict__ v,
                                  const int* __restrict__ rs,
                                  const int* __restrict__ ra,
                                  uint8_t* __restrict__ out, int L, int D) {
  extern __shared__ uint32_t sbits[];  // [ceil(L/32)] packed score spikes
  __shared__ uint32_t qw[XPK_MAX_WD];
  const size_t g = blockIdx.x;
  const int wd = (D + 31) / 32, wl = (L + 31) / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < wd)
    qw[threadIdx.x] = xpk_pack32(q + g * D + 32 * threadIdx.x, D - 32 * threadIdx.x);
  __syncthreads();

  for (int jb = warp * 32; jb < wl * 32; jb += (kThreads / 32) * 32) {
    const int j = jb + lane;
    bool spike = false;
    if (j < L) {
      const uint8_t* row = k + (g * L + j) * D;
      int cnt = 0;
      for (int w = 0; w < wd; ++w)
        cnt += __popc(qw[w] & xpk_pack32(row + 32 * w, D - 32 * w));
      spike = cnt > rs[g * L + j];
    }
    const uint32_t word = __ballot_sync(0xffffffffu, spike);
    if (lane == 0) sbits[jb / 32] = word;
  }
  __syncthreads();

  for (int d = threadIdx.x; d < D; d += kThreads) {
    int cnt = 0;
    for (int w = 0; w < wl; ++w) {
      const uint32_t sw = sbits[w];
      if (!sw) continue;
      uint32_t vw = 0;
      const int rows = min(32, L - 32 * w);
      for (int i = 0; i < rows; ++i)
        vw |= static_cast<uint32_t>(v[(g * L + 32 * w + i) * D + d] & 1u) << i;
      cnt += __popc(sw & vw);
    }
    out[g * D + d] = cnt > ra[g * D + d] ? 1 : 0;
  }
}

}  // namespace

extern "C" int launch_ssa_decode(const uint8_t* q, const uint8_t* k,
                                 const uint8_t* v, const int* rs,
                                 const int* ra, uint8_t* out, int G, int L,
                                 int D, void* stream) {
  const size_t smem = static_cast<size_t>((L + 31) / 32) * sizeof(uint32_t);
  int err = xpk_set_smem(reinterpret_cast<const void*>(ssa_decode_kernel), smem);
  if (err) return err;
  ssa_decode_kernel<<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, rs, ra, out, L, D);
  return static_cast<int>(cudaGetLastError());
}
