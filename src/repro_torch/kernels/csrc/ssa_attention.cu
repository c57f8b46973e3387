// K2 and K7: one stochastic-spiking-attention query row against a cached KV
// train, dense (K2) or block-paged (K7).
//
// K2 replaces the TPU kernel repro/kernels/ssa_attention.py:ssa_decode_kernel
// (pallas_call at :120, body _ssa_decode_body at :80); K7 replaces
// ssa_decode_paged_kernel (pallas_call at :214, body _ssa_decode_paged_body).
//
// Per query row g = (slot, timestep, head), with binary q, k, v (one byte per
// spike, as the cache stores them) and int32 comparator draws rs [L], ra [D]:
//   s_j  = popcount(q & k_j) > rs[j]          (score comparators)
//   a_d  = popcount(s & v[:, d]) > ra[d]      (output comparators)
//
// K2: q uint8 [G, D], k/v uint8 [G, L, D], rs [G, L], ra [G, D] -> [G, D].
// K7: q uint8 [B, T, H, D], kpool/vpool uint8 [P, T, KV, page_len, D],
// table int32 [B, MP], rs [B*T*H, L] and ra [B*T*H, D] with L = MP*page_len
// -> out uint8 [B, T, H, D].  Logical row j of slot b is in-page row
// j % page_len of page table[b, j / page_len]; query head h reads KV head
// h / (H / KV).  The kernel reads each page through the table, never a
// gathered copy, and skips the null page (page 0, zero by contract).
//
// Bound on the card: bytes -- the cached rows are read once for a few
// AND/popcount operations per byte.  Design: one block per query row.  The
// query is packed into uint32 lanes in shared memory; the score stage gives
// each lane of a warp one cached row (packed with 16-byte loads when aligned)
// and a warp ballot packs 32 score spikes into a word; the output stage gives
// each thread one value lane and reads only the rows whose score spiked.
// Lanes past D and rows past L read as zero (the reference pads both to 32
// with zeros, and a zero spike never beats a draw).  Counts are exact
// integers, so the page order cannot change a result.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

// One query row: pack q, score stage, output stage.
template <class Rows>
__device__ void ssa_row(const Rows& rows, const uint8_t* q, const int* rs,
                        const int* ra, uint8_t* out, int L, int D,
                        uint32_t* qw, uint32_t* sbits) {
  if (threadIdx.x < (D + 31) / 32)
    qw[threadIdx.x] = xpk_pack32(q + 32 * threadIdx.x, D - 32 * threadIdx.x);
  __syncthreads();
  xpk_ssa_scores(rows, qw, D, L, rs, sbits);
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads)
    out[d] = xpk_ssa_count(rows, sbits, L, d) > ra[d] ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
ssa_decode_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ k,
                  const uint8_t* __restrict__ v, const int* __restrict__ rs,
                  const int* __restrict__ ra, uint8_t* __restrict__ out, int L,
                  int D) {
  extern __shared__ uint32_t sbits[];  // [ceil(L/32)] packed score spikes
  __shared__ uint32_t qw[XPK_MAX_WD];
  const size_t g = blockIdx.x;
  const XpkDenseRows rows{k + g * L * D, v + g * L * D, static_cast<size_t>(D)};
  ssa_row(rows, q + g * D, rs + g * L, ra + g * D, out + g * D, L, D, qw, sbits);
}

__global__ void __launch_bounds__(kThreads)
ssa_decode_paged_kernel(const uint8_t* __restrict__ q,
                        const uint8_t* __restrict__ kpool,
                        const uint8_t* __restrict__ vpool,
                        const int* __restrict__ table,
                        const int* __restrict__ rs, const int* __restrict__ ra,
                        uint8_t* __restrict__ out, int T, int H, int KV,
                        int page_len, int MP, int D) {
  extern __shared__ uint32_t sbits[];
  __shared__ uint32_t qw[XPK_MAX_WD];
  const size_t g = blockIdx.x;  // (b, t, h), row-major
  const int h = static_cast<int>(g % H), t = static_cast<int>(g / H % T);
  const int b = static_cast<int>(g / (static_cast<size_t>(H) * T));
  const int kvh = h / (H / KV), L = MP * page_len;
  const size_t base = (static_cast<size_t>(t) * KV + kvh) * page_len * D;
  const XpkPagedRows rows{kpool + base, vpool + base,
                          table + static_cast<size_t>(b) * MP,
                          static_cast<size_t>(T) * KV * page_len * D,
                          page_len, D};
  ssa_row(rows, q + g * D, rs + g * L, ra + g * D, out + g * D, L, D, qw, sbits);
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

extern "C" int launch_ssa_decode_paged(const uint8_t* q, const uint8_t* kpool,
                                       const uint8_t* vpool, const int* table,
                                       const int* rs, const int* ra,
                                       uint8_t* out, int B, int T, int H,
                                       int KV, int page_len, int MP, int D,
                                       void* stream) {
  const int L = MP * page_len;
  const size_t smem = static_cast<size_t>((L + 31) / 32) * sizeof(uint32_t);
  int err = xpk_set_smem(
      reinterpret_cast<const void*>(ssa_decode_paged_kernel), smem);
  if (err) return err;
  ssa_decode_paged_kernel<<<B * T * H, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      q, kpool, vpool, table, rs, ra, out, T, H, KV, page_len, MP, D);
  return static_cast<int>(cudaGetLastError());
}
