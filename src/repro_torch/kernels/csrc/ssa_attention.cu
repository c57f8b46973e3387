// K2 and K7: one stochastic-spiking-attention query row against a cached KV
// train, dense (K2) or block-paged (K7).  K8 (at the end of this file): the
// full N x N tile of a whole sequence.
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
// K2 has two entries over one body (ssa_row), which is templated on where
// the draws come from:
//  * given draws: q uint8 [G, D], k/v uint8 [G, L, D], rs [G, L], ra [G, D]
//    -> [G, D];
//  * keyed: the row draws its own comparators from the slot's key, the chain
//    of kernels/ops.py:draw_slot_decode_prns in registers (threefry.cuh):
//      kh = fold_in(slot_key[b], h0 + h),  (ks, ka) = split(kh),
//      rs[j] = randint(ks, (T,1,L), 0, D)      at flat index t*L + j,
//      ra[d] = randint(ka, (T,1,D), 0, i_max)  at flat index t*D + d;
//    the lane that scores row j draws rs[j], the thread that owns output
//    column d draws ra[d], and no draw reaches device memory.  q is
//    [T, B, H, D] and out [T, B, H, D] (contiguous), k/v the dense cache as
//    the caller holds it, any strides over (t, b, h, row) with contiguous
//    rows (the serving path's cache.permute(1, 0, 3, 2, 4): no copy), and
//    the scores stop at each slot's live length pos[b] (rows at and past
//    it are zero by the serving invariant, and a zero row never beats a
//    draw); without pos every row is read.
// K7 has the same two entries over kpool/vpool uint8 [P, T, KV, page_len,
// D] and table int32 [B, MP], L = MP*page_len.  Logical row j of slot b is
// in-page row j % page_len of page table[b, j / page_len]; query head h
// reads KV head h / (H / KV).  The kernel reads each page through the
// table, never a gathered copy, and skips the null page (page 0, zero by
// contract).
//  * given draws: q uint8 [B, T, H, D], rs [B*T*H, L], ra [B*T*H, D] ->
//    out [B, T, H, D], every row read;
//  * keyed (the unfused paged serving path's): the draws of the dense keyed
//    entry above at the logical length L, q and out [T, B, H, D] as the
//    caller holds them, and the scores stop at each slot's live length
//    pos[b] + 1 (pos is the step's write position, after the scatter),
//    clamped to [0, L]: a slot at pos >= L reads every row, as its plain
//    version does, and an idle slot (a null table row) reads none.  Rows
//    past the live length are zero by the serving invariant (freed pages
//    are zeroed, copy-on-write zeroes the tail it copies); without pos
//    every row is read.
//
// Bound on the card: bytes -- the live cached rows are read once for a few
// AND/popcount operations per byte; the keyed entries read no draws (their
// 2 (live + D) threefry pairs a row are about 200 integer operations each,
// far below the card's rate), and the paged ones read the slot's table row
// once.  Design: one block per query row.  The query is packed
// into uint32 lanes in shared memory; the score stage gives each lane of a
// warp one cached row (packed with 16-byte loads when aligned) and a warp
// ballot packs 32 score spikes into a word; the output stage reads only the
// rows whose score spiked: a thread owns a quad of value lanes and one of
// the block's row streams (eight at D = 64), each stream a share of the
// score words with four spiked rows' loads in flight, and the streams'
// counts meet in shared memory (common.cuh:xpk_ssa_counts): a thread that
// walked every spiked row of its lane with one dependent load (paged: two)
// at a time left the row latency-bound.  K7 stages the slot's table row in
// shared memory (SmemPagedRows), so a spiked row's page lookup is a shared
// load.  Lanes past D and rows past L read as zero (the reference pads both
// to 32 with zeros, and a zero spike never beats a draw).  Counts are exact
// integers, so the page order and the streams' split cannot change a
// result.  Any D: the dynamic shared memory holds the score bits, the
// packed query, the D counts and the table row (row_smem_words).
#include "common.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 128;

// Draws read from tensors: this row's rs [L] and ra [D].
struct GivenDraws {
  const int* rs;
  const int* ra;
  __device__ int score(int j) const { return rs[j]; }
  __device__ int out(int d) const { return ra[d]; }
};

// Draws made where they are used, from the (slot, global head) key.
struct KeyedDraws {
  XpkRandint s, a;  // randint(ks, ., 0, D) and randint(ka, ., 0, i_max)
  uint64_t s0, a0;  // flat index of this timestep's first draw: t*L, t*D
  __device__ int score(int j) const { return s.at(s0 + j); }
  __device__ int out(int d) const { return a.at(a0 + d); }
};

// K7's rows: the paged policy with the slot's table row staged in shared
// memory (a spiked row's lookup in the output stage is then a shared load).
struct SmemPagedRows {
  const uint8_t* kb;  // in-page row 0 of page 0 at this (t, KV head)
  const uint8_t* vb;
  const int* table;   // shared: the slot's page-table row
  size_t page_stride;
  int page_len, hd;
  __device__ const uint8_t* at(const uint8_t* base, int j) const {
    const int page = table[j / page_len];
    if (page == XPK_NULL_PAGE) return nullptr;
    return base + page * page_stride + static_cast<size_t>(j % page_len) * hd;
  }
  __device__ const uint8_t* k(int j) const { return at(kb, j); }
  __device__ const uint8_t* v(int j) const { return at(vb, j); }
};

// The decode entries' dynamic shared memory: the score bits, the packed
// query, the output counts, then (paged) the slot's table row.
__host__ __device__ inline size_t row_smem_words(long long L, int D, int MP) {
  return static_cast<size_t>((L + 31) / 32 + (D + 31) / 32 + D + MP);
}

// One query row over its first live <= L cached rows: pack q (and zero the
// counts), score stage, output stage.  smem is row_smem_words(L, D, .)'s
// layout.
template <class Rows, class Draws>
__device__ void ssa_row(const Rows& rows, const uint8_t* q, const Draws& draws,
                        uint8_t* out, int live, int L, int D, uint32_t* smem) {
  uint32_t* sbits = smem;
  uint32_t* qw = sbits + (L + 31) / 32;
  int* cnt = reinterpret_cast<int*>(qw + (D + 31) / 32);
  for (int w = threadIdx.x; w < (D + 31) / 32; w += kThreads)
    qw[w] = xpk_pack32(q + 32 * w, D - 32 * w);
  for (int d = threadIdx.x; d < D; d += kThreads) cnt[d] = 0;
  __syncthreads();
  xpk_ssa_scores(rows, qw, D, live, draws, sbits);
  __syncthreads();
  xpk_ssa_counts(rows, sbits, live, D, cnt);
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads)
    out[d] = cnt[d] > draws.out(d) ? 1 : 0;
}

// Stage the slot's table row (global) in shared memory after the counts;
// the first barrier of ssa_row publishes it.
__device__ int* stage_table(uint32_t* smem, int L, int D, const int* table,
                            int MP) {
  int* stab = reinterpret_cast<int*>(smem) + (L + 31) / 32 + (D + 31) / 32 + D;
  for (int i = threadIdx.x; i < MP; i += kThreads) stab[i] = __ldg(table + i);
  return stab;
}

__global__ void __launch_bounds__(kThreads)
ssa_decode_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ k,
                  const uint8_t* __restrict__ v, const int* __restrict__ rs,
                  const int* __restrict__ ra, uint8_t* __restrict__ out, int L,
                  int D) {
  extern __shared__ uint32_t smem[];  // row_smem_words(L, D, 0)
  const size_t g = blockIdx.x;
  const XpkDenseRows rows{k + g * L * D, v + g * L * D, static_cast<size_t>(D)};
  ssa_row(rows, q + g * D, GivenDraws{rs + g * L, ra + g * D}, out + g * D, L,
          L, D, smem);
}

// The keyed entry's geometry: k and v share their strides (elements).
struct KeyedDims {
  int B, T, H, L, D;
  uint32_t h0, span_s, mult_s, span_a, mult_a;
  long long st, sb, sh, sl;  // cache strides over (t, b, h, row)
};

__global__ void __launch_bounds__(kThreads)
ssa_decode_keyed_kernel(const uint8_t* __restrict__ q,
                        const uint8_t* __restrict__ k,
                        const uint8_t* __restrict__ v,
                        const long long* __restrict__ slot_keys,
                        const int* __restrict__ pos, uint8_t* __restrict__ out,
                        KeyedDims a) {
  extern __shared__ uint32_t smem[];  // row_smem_words(L, D, 0)
  const int g = blockIdx.x;  // (b, t, h), row-major
  const int h = g % a.H, t = g / a.H % a.T, b = g / (a.H * a.T);
  const int live = pos ? min(max(__ldg(pos + b), 0), a.L) : a.L;
  const XpkKey slot{static_cast<uint32_t>(__ldg(slot_keys + 2 * b)),
                    static_cast<uint32_t>(__ldg(slot_keys + 2 * b + 1))};
  const XpkKey kh = xpk_fold_in(slot, a.h0 + static_cast<uint32_t>(h));
  const KeyedDraws draws{
      XpkRandint::make(xpk_split(kh, 0), 0, a.span_s, a.mult_s),
      XpkRandint::make(xpk_split(kh, 1), 0, a.span_a, a.mult_a),
      static_cast<uint64_t>(t) * a.L, static_cast<uint64_t>(t) * a.D};
  const long long base = t * a.st + b * a.sb + h * a.sh;
  const XpkDenseRows rows{k + base, v + base, static_cast<size_t>(a.sl)};
  const size_t row = (static_cast<size_t>(t) * a.B + b) * a.H + h;
  ssa_row(rows, q + row * a.D, draws, out + row * a.D, live, a.L, a.D, smem);
}

__global__ void __launch_bounds__(kThreads)
ssa_decode_paged_kernel(const uint8_t* __restrict__ q,
                        const uint8_t* __restrict__ kpool,
                        const uint8_t* __restrict__ vpool,
                        const int* __restrict__ table,
                        const int* __restrict__ rs, const int* __restrict__ ra,
                        uint8_t* __restrict__ out, int T, int H, int KV,
                        int page_len, int MP, int D) {
  extern __shared__ uint32_t smem[];  // row_smem_words(L, D, MP)
  const size_t g = blockIdx.x;  // (b, t, h), row-major
  const int h = static_cast<int>(g % H), t = static_cast<int>(g / H % T);
  const int b = static_cast<int>(g / (static_cast<size_t>(H) * T));
  const int kvh = h / (H / KV), L = MP * page_len;
  const size_t base = (static_cast<size_t>(t) * KV + kvh) * page_len * D;
  const SmemPagedRows rows{
      kpool + base, vpool + base,
      stage_table(smem, L, D, table + static_cast<size_t>(b) * MP, MP),
      static_cast<size_t>(T) * KV * page_len * D, page_len, D};
  ssa_row(rows, q + g * D, GivenDraws{rs + g * L, ra + g * D}, out + g * D, L,
          L, D, smem);
}

// The paged keyed entry's geometry.
struct PagedKeyedDims {
  int B, T, H, KV, page_len, MP, D;
  uint32_t h0, span_s, mult_s, span_a, mult_a;
};

__global__ void __launch_bounds__(kThreads)
ssa_decode_paged_keyed_kernel(const uint8_t* __restrict__ q,
                              const uint8_t* __restrict__ kpool,
                              const uint8_t* __restrict__ vpool,
                              const int* __restrict__ table,
                              const long long* __restrict__ slot_keys,
                              const int* __restrict__ pos,
                              uint8_t* __restrict__ out, PagedKeyedDims a) {
  const int L = a.MP * a.page_len;
  extern __shared__ uint32_t smem[];  // row_smem_words(L, D, MP)
  const int g = blockIdx.x;  // (t, b, h), row-major: q's and out's rows
  const int h = g % a.H, b = g / a.H % a.B, t = g / (a.H * a.B);
  int live = L;
  if (pos) {
    const int p = __ldg(pos + b);
    live = p >= L ? L : max(p + 1, 0);
  }
  const XpkKey slot{static_cast<uint32_t>(__ldg(slot_keys + 2 * b)),
                    static_cast<uint32_t>(__ldg(slot_keys + 2 * b + 1))};
  const XpkKey kh = xpk_fold_in(slot, a.h0 + static_cast<uint32_t>(h));
  const KeyedDraws draws{
      XpkRandint::make(xpk_split(kh, 0), 0, a.span_s, a.mult_s),
      XpkRandint::make(xpk_split(kh, 1), 0, a.span_a, a.mult_a),
      static_cast<uint64_t>(t) * L, static_cast<uint64_t>(t) * a.D};
  const int kvh = h / (a.H / a.KV);
  const size_t base =
      (static_cast<size_t>(t) * a.KV + kvh) * a.page_len * a.D;
  const SmemPagedRows rows{
      kpool + base, vpool + base,
      stage_table(smem, L, a.D, table + static_cast<size_t>(b) * a.MP, a.MP),
      static_cast<size_t>(a.T) * a.KV * a.page_len * a.D, a.page_len, a.D};
  ssa_row(rows, q + static_cast<size_t>(g) * a.D, draws,
          out + static_cast<size_t>(g) * a.D, live, L, a.D, smem);
}

// ---------------------------------------------------------------------------
// K8: the full SSA tile of a sequence
// ---------------------------------------------------------------------------
//
// Replaces the TPU kernel repro/kernels/ssa_attention.py:ssa_attention_kernel
// (pallas_call at :237, body _ssa_kernel at :51).
//
// Per tile g = (t, b, h), row-major over [T, B, H], with binary q, k, v
// [N, D] (one byte per spike) and int32 comparators rs [N, N] in [0, D),
// ra [N, D] in [0, N):
//   s_ij = popcount(q_i & k_j) > rs[i, j]   (causal: s_ij = 0 for j > i)
//   a_id = popcount(s_i & v[:, d]) > ra[i, d]
// any N and D.  Two entries over one body (ssa_tile, ssa_tile_stream),
// templated on where the comparators come from:
//  * given draws: q, k, v, out [G, N, D] contiguous, rs [G, N, N], ra
//    [G, N, D] read from device memory;
//  * keyed (the paper forwards' and the LM stack's): the tile draws its own
//    comparators from one key, the chain of
//    kernels/ops.py:draw_comparator_prns in registers (threefry.cuh):
//    (k1, k2) = split(key),
//      rs = randint(k1, (G, N, N), 0, D)  at flat index (g N + i) N + j,
//      ra = randint(k2, (G, N, D), 0, N)  at flat index (g N + i) D + d,
//    g the tile's index in the grid that was drawn: a launch may hold a
//    block of it, a mesh rank's batch rows and heads (TileIO::draw_tile);
//    q, k, v are read where the caller holds them (any strides over (t, b,
//    h, row) with contiguous rows: the heads view of a [T, B, N, H*hd]
//    train, no copy) and out is written through strides too (the caller's
//    [T, B, N, H, hd] buffer, so its heads merge back without a copy).
//
// Bound on the card: keyed, operations.  A draw is two threefry2x32 calls
// and three remainders (171 SASS instructions); the ViT's tile (G = 1,536,
// N = D = 64) holds 12.6M comparators, against 25 MB of spikes in and out.
// So the design serves the ALU: each block derives randint's four subkeys
// once a warp (xpk_split_randint_keys), every draw's two cipher calls run
// in lockstep and a lane keeps two draws in flight where it has two
// (XpkRandintFast::at<2>), the remainders are multiplications
// (xpk_fastmod), and a comparator is drawn only where its count can beat
// it: a zero count never beats a draw of 0 or more, and a causal score
// past the diagonal counts zero.  A lane that skips alone saves nothing
// (its warp draws for the others), so the warp packs the comparators its
// 64 elements need onto its lanes (KeyedTileDraws).  Given draws are bound
// by bytes (the int32 comparators are two thirds of the ViT tile's
// traffic) and are read only where a lane counts more than zero.
//
// Design: one block of 8 warps per tile (the ViT's G is 1,536 at B = 64).
// The block packs its tile into shared memory once: Q and K along D (a
// thread packs 32 consecutive bytes of a row, 16-byte loads when aligned)
// and V along the sequence (a thread packs one column over 32 rows;
// neighbouring threads read neighbouring bytes).  Then each warp takes
// query rows in turn: its lanes score 64 keys at once (two words; one
// popcount per word of D), a ballot packs each word's 32 score spikes, and
// the lanes then take the output columns 64 at a time: one popcount per
// word of the sequence against the packed V column.  Lanes past N or D
// count zero, which is the reference's 32-lane zero padding (a zero count
// never beats a draw), so the comparators are those of the logical shapes.
// Counts are exact integers.
//
// A tile that does not fit the 227 KB of a block (about N * D > 2**20, e.g.
// N = 2,048 at D = 512) takes the streaming body instead: a block per
// (tile, block of RQ query rows), whose packed queries and score bits stay
// in shared memory while K streams through it along the sequence in chunks
// of NC keys (each packed once a block) and the score bits of a row
// accumulate over the chunks; then V streams in chunks of 64 columns by NC
// sequence rows, the output counts accumulating in registers over the
// sequence chunks.  The wrapper (kernels/ssa_attention.py:attention_plan)
// picks the design and the chunk sizes from N and D, for both entries.

constexpr int kTileThreads = 256;
constexpr int kStreamCols = 64;  // V columns a stream chunk: 2 a lane

// Where a tile's spikes live: element strides over (t, b, h, row) of q, k,
// v and out, rows of D contiguous bytes; tile g = (t * B + b) * H + h.
// The launch's tiles may be a block of a larger [T, Bg, Hg] grid, from
// batch row b0 and head h0 (a mesh rank's share): the comparators are the
// whole grid's, so tile g draws at its grid index (t * Bg + b0 + b) * Hg +
// h0 + h.  The whole grid is b0 = h0 = 0, Bg = B, Hg = H.
struct TileIO {
  int B, H;
  long long q[4], k[4], v[4], o[4];
  int b0, h0, Bg, Hg;
  __device__ long long base(const long long (&s)[4], size_t g) const {
    const long long h = static_cast<long long>(g % H);
    const long long b = static_cast<long long>(g / H % B);
    const long long t = static_cast<long long>(g / H / B);
    return t * s[0] + b * s[1] + h * s[2];
  }
  __device__ uint64_t draw_tile(size_t g) const {
    const uint64_t h = g % H, b = g / H % B, t = g / H / B;
    return (t * Bg + b0 + b) * Hg + h0 + h;
  }
};

// Comparators read from tensors, only where the lane's count is not zero
// (elsewhere no draw can matter, and the index may lie past the tensor).
struct GivenTileDraws {
  const int* rs;
  const int* ra;
  __device__ __forceinline__ static void read(const int* p,
                                              const uint64_t (&i)[2],
                                              const int (&cnt)[2],
                                              int (&r)[2]) {
#pragma unroll
    for (int a = 0; a < 2; ++a) r[a] = cnt[a] > 0 ? __ldg(p + i[a]) : 0;
  }
  __device__ __forceinline__ void score(const uint64_t (&i)[2],
                                        const int (&cnt)[2],
                                        int (&r)[2]) const {
    read(rs, i, cnt, r);
  }
  __device__ __forceinline__ void out(const uint64_t (&i)[2],
                                      const int (&cnt)[2], int (&r)[2]) const {
    read(ra, i, cnt, r);
  }
};

// The bit position of the p-th (from 0) set bit of m, for p < popc(m):
// a binary search over halves by their popcounts.
__device__ __forceinline__ int nth_set_bit(uint32_t m, int p) {
  int pos = 0;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    const int low = __popc(m & ((1u << half) - 1u));
    if (p >= low) {
      p -= low;
      m >>= half;
      pos += half;
    }
  }
  return pos;
}

// Comparators drawn where they are used.  Every lane of the warp calls
// score/out together with two words of 32 elements, lane l's element of
// word c at flat index i[c] (i[c] - l the same on every lane).  Only the
// elements whose count is not zero are drawn (no other can fire): where
// more than 32 of the 64 are, each lane draws its own two in lockstep;
// where at most 32 are, the warp packs them onto its lanes -- the e-th
// such element (word 0's in lane order, then word 1's) is drawn by lane
// e -- and each lane takes its own back by a shuffle: one draw a lane
// where a lane-by-lane skip would leave the warp drawing two.  A lane whose
// count is zero gets some draw (0 or more): it cannot fire.
struct KeyedTileDraws {
  XpkRandintFast s, a;  // randint(k1, ., 0, D) and randint(k2, ., 0, N)
  __device__ __forceinline__ static void draw(const XpkRandintFast& rnd,
                                              const uint64_t (&i)[2],
                                              const int (&cnt)[2],
                                              int (&r)[2]) {
    const unsigned lane = threadIdx.x & 31u;
    const uint32_t m0 = __ballot_sync(0xffffffffu, cnt[0] > 0);
    const uint32_t m1 = __ballot_sync(0xffffffffu, cnt[1] > 0);
    const int n0 = __popc(m0), n = n0 + __popc(m1);
    r[0] = r[1] = 0;
    if (n > 32) {
      uint32_t u[2];
      rnd.at<2>(i, u);
      r[0] = static_cast<int>(u[0]);
      r[1] = static_cast<int>(u[1]);
    } else if (n > 0) {
      const bool w1 = static_cast<int>(lane) >= n0;  // lane e's element
      const int rank = w1 ? static_cast<int>(lane) - n0 : static_cast<int>(lane);
      const uint64_t one[1] = {(w1 ? i[1] : i[0]) - lane +
                               nth_set_bit(w1 ? m1 : m0, rank)};
      uint32_t u[1];
      rnd.at<1>(one, u);
      const uint32_t below = (1u << lane) - 1u;  // lanes before this one
      r[0] = static_cast<int>(
          __shfl_sync(0xffffffffu, u[0], __popc(m0 & below)));
      r[1] = static_cast<int>(
          __shfl_sync(0xffffffffu, u[0], (n0 + __popc(m1 & below)) & 31));
    }
  }
  __device__ __forceinline__ void score(const uint64_t (&i)[2],
                                        const int (&cnt)[2],
                                        int (&r)[2]) const {
    draw(s, i, cnt, r);
  }
  __device__ __forceinline__ void out(const uint64_t (&i)[2],
                                      const int (&cnt)[2], int (&r)[2]) const {
    draw(a, i, cnt, r);
  }
};

// The keyed comparators of one launch: randint's subkeys of both halves of
// split(key) (key int64 [2] holding uint32 words, on the card), with the
// spans' multipliers and xpk_fastmod constants from the host.
struct TileSpans {
  uint32_t mult_s, mult_a;  // randint's multipliers of spans D and N
  unsigned long long M_s, M_a;  // xpk_fastmod's M of spans D and N
};

__device__ KeyedTileDraws keyed_tile_draws(const long long* key, int N, int D,
                                           const TileSpans& sp) {
  const XpkKey k{static_cast<uint32_t>(__ldg(key)),
                 static_cast<uint32_t>(__ldg(key + 1))};
  XpkKey s_hi, s_lo, a_hi, a_lo;
  xpk_split_randint_keys(k, s_hi, s_lo, a_hi, a_lo);
  return KeyedTileDraws{
      XpkRandintFast{s_hi, s_lo, sp.M_s, static_cast<uint32_t>(D), sp.mult_s},
      XpkRandintFast{a_hi, a_lo, sp.M_a, static_cast<uint32_t>(N),
                     sp.mult_a}};
}

// The resident tile: block g, the whole packed tile in shared memory.
template <class Draws>
__device__ void ssa_tile(const uint8_t* q, const uint8_t* k, const uint8_t* v,
                         uint8_t* out, const TileIO& io, const Draws& draws,
                         int N, int D, int causal, uint32_t* tile) {
  const int wd = (D + 31) / 32, wn = (N + 31) / 32;
  uint32_t* qw = tile;          // [N][wd]: row i's words are a broadcast
  uint32_t* kw = qw + N * wd;   // [wd][N]: lanes read consecutive keys j
  uint32_t* vw = kw + wd * N;   // [wn][D]: lanes read consecutive columns d
  uint32_t* sw = vw + wn * D;   // [warps][wn]: one row's score spikes a warp
  const size_t g = blockIdx.x;
  const uint8_t* qg = q + io.base(io.q, g);
  const uint8_t* kg = k + io.base(io.k, g);
  const uint8_t* vg = v + io.base(io.v, g);
  uint8_t* og = out + io.base(io.o, g);
  const long long sq = io.q[3], sk = io.k[3], sv = io.v[3], so = io.o[3];

  for (int idx = threadIdx.x; idx < N * wd; idx += blockDim.x) {
    const int r = idx / wd, w = idx - r * wd;
    qw[idx] = xpk_pack32(qg + r * sq + 32 * w, D - 32 * w);
    kw[w * N + r] = xpk_pack32(kg + r * sk + 32 * w, D - 32 * w);
  }
  for (int idx = threadIdx.x; idx < wn * D; idx += blockDim.x) {
    const int w = idx / D, d = idx - w * D;
    const int rows = min(32, N - 32 * w);
    const uint8_t* col = vg + (32 * w) * sv + d;
    uint32_t word = 0;
    for (int jj = 0; jj < rows; ++jj)
      word |= static_cast<uint32_t>(col[jj * sv] & 1u) << jj;
    vw[idx] = word;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint64_t gd = io.draw_tile(g);  // the tile's index in the draws
  uint32_t* srow = sw + warp * wn;
  for (int i = warp; i < N; i += kTileThreads / 32) {
    const int jend = causal ? i + 1 : N;
    const uint32_t* qi = qw + i * wd;
    const uint64_t row_s = (gd * N + i) * N;
    for (int w = 0; w < wn; w += 2) {  // two words of keys a pass
      int cnt[2], r[2];
      uint64_t at[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = 32 * (w + c) + lane;
        cnt[c] = 0;
        if (j < jend)
          for (int x = 0; x < wd; ++x) cnt[c] += __popc(qi[x] & kw[x * N + j]);
        at[c] = row_s + j;
      }
      draws.score(at, cnt, r);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t word = __ballot_sync(0xffffffffu, cnt[c] > r[c]);
        if (lane == 0 && w + c < wn) srow[w + c] = word;
      }
    }
    __syncwarp();
    const uint64_t row_a = (gd * N + i) * D;
    uint8_t* oi = og + i * so;
    for (int d0 = 0; d0 < D; d0 += 64) {  // two columns a lane a pass
      int cnt[2], r[2];
      uint64_t at[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = d0 + 32 * c + lane;
        cnt[c] = 0;
        if (d < D)
          for (int w = 0; w < wn; ++w) cnt[c] += __popc(srow[w] & vw[w * D + d]);
        at[c] = row_a + d;
      }
      draws.out(at, cnt, r);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = d0 + 32 * c + lane;
        if (d < D) oi[d] = cnt[c] > r[c] ? 1 : 0;
      }
    }
    __syncwarp();  // srow is rewritten by this warp's next row
  }
}

// The streaming tile (see the note above).  Block b takes tile g = b / nrb
// and query rows [i0, i0 + RQ); RQ <= 64 (at most 8 rows a warp), NC a
// multiple of 32.
template <class Draws>
__device__ void ssa_tile_stream(const uint8_t* q, const uint8_t* k,
                                const uint8_t* v, uint8_t* out,
                                const TileIO& io, const Draws& draws, int N,
                                int D, int causal, int RQ, int NC,
                                uint32_t* smem) {
  const int wd = (D + 31) / 32, wn = (N + 31) / 32;
  const int nrb = (N + RQ - 1) / RQ;
  const size_t g = blockIdx.x / nrb;
  const int i0 = static_cast<int>(blockIdx.x % nrb) * RQ;
  const int rows = min(RQ, N - i0);
  uint32_t* qw = smem;          // [RQ][wd]  the block's packed queries
  uint32_t* sw = qw + RQ * wd;  // [RQ][wn]  their score spikes
  uint32_t* cw = sw + RQ * wn;  // a K chunk [wd][NC] or a V chunk [NC/32][64]
  const uint8_t* qg = q + io.base(io.q, g);
  const uint8_t* kg = k + io.base(io.k, g);
  const uint8_t* vg = v + io.base(io.v, g);
  uint8_t* og = out + io.base(io.o, g);
  const long long sq = io.q[3], sk = io.k[3], sv = io.v[3], so = io.o[3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint64_t gd = io.draw_tile(g);  // the tile's index in the draws

  for (int idx = threadIdx.x; idx < rows * wd; idx += blockDim.x) {
    const int r = idx / wd, x = idx - r * wd;
    qw[idx] = xpk_pack32(qg + (i0 + r) * sq + 32 * x, D - 32 * x);
  }
  for (int idx = threadIdx.x; idx < rows * wn; idx += blockDim.x) sw[idx] = 0;

  // score stage: keys the block's rows can see, NC at a time
  const int jmax = causal ? i0 + rows : N;
  for (int j0 = 0; j0 < jmax; j0 += NC) {
    const int nc = min(NC, jmax - j0), ncw = (nc + 31) / 32;
    __syncthreads();  // the packed queries are in; the last chunk is read
    for (int idx = threadIdx.x; idx < nc * wd; idx += blockDim.x) {
      const int jj = idx / wd, x = idx - jj * wd;
      cw[x * NC + jj] = xpk_pack32(kg + (j0 + jj) * sk + 32 * x, D - 32 * x);
    }
    __syncthreads();
    for (int r = warp; r < rows; r += kTileThreads / 32) {
      const int i = i0 + r, jend = causal ? i + 1 : N;
      const uint32_t* qi = qw + r * wd;
      const uint64_t row_s = (gd * N + i) * N;
      for (int w = 0; w < ncw; w += 2) {
        int cnt[2], rr[2];
        uint64_t at[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int jj = 32 * (w + c) + lane, j = j0 + jj;
          cnt[c] = 0;
          if (jj < nc && j < jend)
            for (int x = 0; x < wd; ++x)
              cnt[c] += __popc(qi[x] & cw[x * NC + jj]);
          at[c] = row_s + j;
        }
        draws.score(at, cnt, rr);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const uint32_t word = __ballot_sync(0xffffffffu, cnt[c] > rr[c]);
          if (lane == 0 && w + c < ncw) sw[r * wn + j0 / 32 + w + c] = word;
        }
      }
    }
  }

  // output stage: 64 columns at a time, V's sequence NC rows at a time
  const int wmax = (jmax + 31) / 32;  // score words that can be nonzero
  const int wc = NC / 32;
  for (int d0 = 0; d0 < D; d0 += kStreamCols) {
    int cnt[8][2];
#pragma unroll
    for (int a = 0; a < 8; ++a) cnt[a][0] = cnt[a][1] = 0;
    for (int w0 = 0; w0 < wmax; w0 += wc) {
      const int nw = min(wc, wmax - w0);
      __syncthreads();  // the scores are in; the last chunk is read
      for (int idx = threadIdx.x; idx < nw * kStreamCols; idx += blockDim.x) {
        const int w = idx / kStreamCols, d = d0 + idx - w * kStreamCols;
        const int j0 = 32 * (w0 + w), n = min(32, N - j0);
        uint32_t word = 0;
        if (d < D) {
          const uint8_t* col = vg + j0 * sv + d;
          for (int jj = 0; jj < n; ++jj)
            word |= static_cast<uint32_t>(col[jj * sv] & 1u) << jj;
        }
        cw[idx] = word;
      }
      __syncthreads();
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int r = warp + a * (kTileThreads / 32);
        if (r < rows) {
          const uint32_t* sr = sw + r * wn + w0;
#pragma unroll
          for (int c = 0; c < 2; ++c)
            for (int w = 0; w < nw; ++w)
              cnt[a][c] += __popc(sr[w] & cw[w * kStreamCols + lane + 32 * c]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int r = warp + a * (kTileThreads / 32);
      if (r < rows) {  // the same for the whole warp
        const uint64_t row_a = (gd * N + i0 + r) * D;
        const uint64_t at[2] = {row_a + d0 + lane, row_a + d0 + 32 + lane};
        int rr[2];
        draws.out(at, cnt[a], rr);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int d = d0 + lane + 32 * c;
          if (d < D) og[(i0 + r) * so + d] = cnt[a][c] > rr[c] ? 1 : 0;
        }
      }
    }
  }
}

// A launch's shape: the design is the streaming one where RQ > 0.
struct TileDims {
  int N, D, causal, RQ, NC;
};

__global__ void __launch_bounds__(kTileThreads)
ssa_attention_kernel(const uint8_t* __restrict__ q,
                     const uint8_t* __restrict__ k,
                     const uint8_t* __restrict__ v, const int* __restrict__ rs,
                     const int* __restrict__ ra, uint8_t* __restrict__ out,
                     TileIO io, TileDims dm) {
  extern __shared__ uint32_t tile[];
  ssa_tile(q, k, v, out, io, GivenTileDraws{rs, ra}, dm.N, dm.D, dm.causal,
           tile);
}

__global__ void __launch_bounds__(kTileThreads)
ssa_attention_stream_kernel(const uint8_t* __restrict__ q,
                            const uint8_t* __restrict__ k,
                            const uint8_t* __restrict__ v,
                            const int* __restrict__ rs,
                            const int* __restrict__ ra,
                            uint8_t* __restrict__ out, TileIO io,
                            TileDims dm) {
  extern __shared__ uint32_t smem[];
  ssa_tile_stream(q, k, v, out, io, GivenTileDraws{rs, ra}, dm.N, dm.D,
                  dm.causal, dm.RQ, dm.NC, smem);
}

// The keyed entries: the resident one at most 64 registers a thread, so
// four blocks of 8 warps share an SM and hide the cipher chains' latency;
// the streaming one keeps 16 output counts a thread besides, in at most 128
// registers (two blocks an SM) so that nothing spills.
__global__ void __launch_bounds__(kTileThreads, 4)
ssa_attention_keyed_kernel(const uint8_t* __restrict__ q,
                           const uint8_t* __restrict__ k,
                           const uint8_t* __restrict__ v,
                           const long long* __restrict__ key,
                           uint8_t* __restrict__ out, TileSpans sp,
                           TileIO io, TileDims dm) {
  extern __shared__ uint32_t tile[];
  ssa_tile(q, k, v, out, io, keyed_tile_draws(key, dm.N, dm.D, sp), dm.N,
           dm.D, dm.causal, tile);
}

__global__ void __launch_bounds__(kTileThreads, 2)
ssa_attention_keyed_stream_kernel(const uint8_t* __restrict__ q,
                                  const uint8_t* __restrict__ k,
                                  const uint8_t* __restrict__ v,
                                  const long long* __restrict__ key,
                                  uint8_t* __restrict__ out, TileSpans sp,
                                  TileIO io, TileDims dm) {
  extern __shared__ uint32_t smem[];
  ssa_tile_stream(q, k, v, out, io, keyed_tile_draws(key, dm.N, dm.D, sp),
                  dm.N, dm.D, dm.causal, dm.RQ, dm.NC, smem);
}

// K8's launch geometry from the wrapper's plan
// (kernels/ssa_attention.py:attention_plan): the shared memory of each
// design's buffers, which a launcher requires the plan to match.
size_t resident_smem(int N, int D) {
  const size_t wd = (D + 31) / 32, wn = (N + 31) / 32;
  return sizeof(uint32_t) * (2 * static_cast<size_t>(N) * wd +
                             wn * static_cast<size_t>(D) +
                             (kTileThreads / 32) * wn);
}

// 0 where RQ (8..64, a multiple of 8) or NC (a multiple of 32) is not a
// streaming plan's
size_t stream_smem(int N, int D, int RQ, int NC) {
  if (RQ < 8 || RQ > 64 || RQ % 8 || NC < 32 || NC % 32) return 0;
  const size_t wd = (D + 31) / 32, wn = (N + 31) / 32;
  const size_t chunk = wd * NC > static_cast<size_t>(NC / 32) * kStreamCols
                           ? wd * NC : static_cast<size_t>(NC / 32) * kStreamCols;
  return sizeof(uint32_t) * (RQ * wd + RQ * wn + chunk);
}

// The grid of a plan over G tiles (G, or G * ceil(N / RQ) blocks), or -1
// where its shared memory differs from the design's buffers or the grid
// is past the card's.
long long tile_grid(long long G, const TileDims& dm, long long smem) {
  if (G <= 0 || dm.N <= 0 || dm.D <= 0 || smem < 0) return -1;
  const size_t need = dm.RQ ? stream_smem(dm.N, dm.D, dm.RQ, dm.NC)
                            : resident_smem(dm.N, dm.D);
  const long long blocks = dm.RQ ? G * ((dm.N + dm.RQ - 1) / dm.RQ) : G;
  if (need == 0 || static_cast<size_t>(smem) != need || blocks > 0x7fffffffLL)
    return -1;
  return blocks;
}

}  // namespace

extern "C" int launch_ssa_decode(const uint8_t* q, const uint8_t* k,
                                 const uint8_t* v, const int* rs,
                                 const int* ra, uint8_t* out, int G, int L,
                                 int D, void* stream) {
  const size_t smem = row_smem_words(L, D, 0) * sizeof(uint32_t);
  int err = xpk_set_smem(reinterpret_cast<const void*>(ssa_decode_kernel), smem);
  if (err) return err;
  ssa_decode_kernel<<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, rs, ra, out, L, D);
  return static_cast<int>(cudaGetLastError());
}

// The keyed entry: slot_keys int64 [B, 2] (uint32 values), pos int32 [B] or
// null, the spans' randint multipliers as prng.randint computes them.
extern "C" int launch_ssa_decode_keyed(const uint8_t* q, const uint8_t* k,
                                       const uint8_t* v,
                                       const long long* slot_keys,
                                       const int* pos, uint8_t* out, int B,
                                       int T, int H, int L, int D, int h0,
                                       long long st, long long sb,
                                       long long sh, long long sl, int span_s,
                                       int mult_s, int span_a, int mult_a,
                                       void* stream) {
  const long long blocks = static_cast<long long>(B) * T * H;
  if (blocks <= 0 || blocks > 0x7fffffffLL || L <= 0 || D <= 0 || h0 < 0 ||
      span_s <= 0 || span_a <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = row_smem_words(L, D, 0) * sizeof(uint32_t);
  int err = xpk_set_smem(
      reinterpret_cast<const void*>(ssa_decode_keyed_kernel), smem);
  if (err) return err;
  const KeyedDims a{B, T, H, L, D, static_cast<uint32_t>(h0),
                    static_cast<uint32_t>(span_s), static_cast<uint32_t>(mult_s),
                    static_cast<uint32_t>(span_a), static_cast<uint32_t>(mult_a),
                    st, sb, sh, sl};
  ssa_decode_keyed_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      q, k, v, slot_keys, pos, out, a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int launch_ssa_decode_paged(const uint8_t* q, const uint8_t* kpool,
                                       const uint8_t* vpool, const int* table,
                                       const int* rs, const int* ra,
                                       uint8_t* out, int B, int T, int H,
                                       int KV, int page_len, int MP, int D,
                                       void* stream) {
  const int L = MP * page_len;
  const size_t smem = row_smem_words(L, D, MP) * sizeof(uint32_t);
  int err = xpk_set_smem(
      reinterpret_cast<const void*>(ssa_decode_paged_kernel), smem);
  if (err) return err;
  ssa_decode_paged_kernel<<<B * T * H, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      q, kpool, vpool, table, rs, ra, out, T, H, KV, page_len, MP, D);
  return static_cast<int>(cudaGetLastError());
}

// The paged keyed entry: slot_keys int64 [B, 2] (uint32 values), pos int32
// [B] (each slot's write position) or null, the spans' randint multipliers
// as prng.randint computes them.
extern "C" int launch_ssa_decode_paged_keyed(
    const uint8_t* q, const uint8_t* kpool, const uint8_t* vpool,
    const int* table, const long long* slot_keys, const int* pos,
    uint8_t* out, int B, int T, int H, int KV, int page_len, int MP, int D,
    int h0, int span_s, int mult_s, int span_a, int mult_a, void* stream) {
  const long long blocks = static_cast<long long>(B) * T * H;
  const long long L = static_cast<long long>(MP) * page_len;
  if (blocks <= 0 || blocks > 0x7fffffffLL || KV <= 0 || H % KV ||
      page_len <= 0 || MP <= 0 || L > 0x7fffffffLL || D <= 0 || h0 < 0 ||
      span_s <= 0 || span_a <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = row_smem_words(L, D, MP) * sizeof(uint32_t);
  int err = xpk_set_smem(
      reinterpret_cast<const void*>(ssa_decode_paged_keyed_kernel), smem);
  if (err) return err;
  const PagedKeyedDims a{B, T, H, KV, page_len, MP, D,
                         static_cast<uint32_t>(h0),
                         static_cast<uint32_t>(span_s),
                         static_cast<uint32_t>(mult_s),
                         static_cast<uint32_t>(span_a),
                         static_cast<uint32_t>(mult_a)};
  ssa_decode_paged_keyed_kernel<<<static_cast<unsigned>(blocks), kThreads,
                                  smem, static_cast<cudaStream_t>(stream)>>>(
      q, kpool, vpool, table, slot_keys, pos, out, a);
  return static_cast<int>(cudaGetLastError());
}

// K8's launchers take the design and its shared memory from the wrapper's
// plan (kernels/ssa_attention.py:attention_plan) and refuse shared memory
// that differs from their buffers' layout.

// The given-draws entry's tiles: q, k, v and out [G, N, D] contiguous.
static TileIO contiguous_io(int G, int N, int D) {
  const long long nd = static_cast<long long>(N) * D;
  return TileIO{1, G, {0, 0, nd, D}, {0, 0, nd, D}, {0, 0, nd, D},
                {0, 0, nd, D}, 0, 0, 1, G};
}

extern "C" int launch_ssa_attention(const uint8_t* q, const uint8_t* k,
                                    const uint8_t* v, const int* rs,
                                    const int* ra, uint8_t* out, int G, int N,
                                    int D, int causal, long long smem,
                                    void* stream) {
  const TileDims dm{N, D, causal, 0, 0};
  const long long blocks = tile_grid(G, dm, smem);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  int err = xpk_set_smem(reinterpret_cast<const void*>(ssa_attention_kernel),
                         smem);
  if (err) return err;
  ssa_attention_kernel<<<static_cast<unsigned>(blocks), kTileThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      q, k, v, rs, ra, out, contiguous_io(G, N, D), dm);
  return static_cast<int>(cudaGetLastError());
}

// K8 past the resident budget: RQ query rows a block (8..64, a multiple of
// 8), NC keys a chunk (a multiple of 32), as the wrapper's plan chose them.
extern "C" int launch_ssa_attention_stream(const uint8_t* q, const uint8_t* k,
                                           const uint8_t* v, const int* rs,
                                           const int* ra, uint8_t* out, int G,
                                           int N, int D, int causal, int RQ,
                                           int NC, long long smem,
                                           void* stream) {
  const TileDims dm{N, D, causal, RQ, NC};
  const long long blocks = RQ > 0 ? tile_grid(G, dm, smem) : -1;
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  int err = xpk_set_smem(
      reinterpret_cast<const void*>(ssa_attention_stream_kernel), smem);
  if (err) return err;
  ssa_attention_stream_kernel<<<static_cast<unsigned>(blocks), kTileThreads,
                                smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, rs, ra, out, contiguous_io(G, N, D), dm);
  return static_cast<int>(cudaGetLastError());
}

// The keyed entry, both designs (RQ == 0: resident; else streaming, RQ and
// NC as above): q, k, v [T, B, H, N, D] uint8 and out the same through
// strides (host int64 [16]: q's, k's, v's and out's element strides over
// (t, b, h, row), rows contiguous), key int64 [2] (uint32 words) on the
// card, the tiles' place (b0, h0) in the [T, Bg, Hg] grid whose
// comparators they draw, the spans' randint multipliers as prng.randint
// computes them and their xpk_fastmod constants
// (kernels/ssa_attention.py:fastmod_m).
extern "C" int launch_ssa_attention_keyed(
    const uint8_t* q, const uint8_t* k, const uint8_t* v,
    const long long* key, uint8_t* out, const long long* strides, int T,
    int B, int H, int N, int D, int causal, int b0, int h0, int Bg, int Hg,
    int mult_s, unsigned long long M_s, int mult_a, unsigned long long M_a,
    int RQ, int NC, long long smem, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || RQ < 0 || b0 < 0 || h0 < 0 ||
      b0 + B > Bg || h0 + H > Hg)
    return static_cast<int>(cudaErrorInvalidValue);
  TileIO io{B, H, {}, {}, {}, {}, b0, h0, Bg, Hg};
  for (int i = 0; i < 4; ++i) {
    io.q[i] = strides[i];
    io.k[i] = strides[4 + i];
    io.v[i] = strides[8 + i];
    io.o[i] = strides[12 + i];
  }
  const TileSpans sp{static_cast<uint32_t>(mult_s),
                     static_cast<uint32_t>(mult_a), M_s, M_a};
  const TileDims dm{N, D, causal, RQ, NC};
  const long long blocks =
      tile_grid(static_cast<long long>(T) * B * H, dm, smem);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  int err;
  if (RQ) {
    err = xpk_set_smem(
        reinterpret_cast<const void*>(ssa_attention_keyed_stream_kernel), smem);
    if (err) return err;
    ssa_attention_keyed_stream_kernel<<<grid, kTileThreads, smem, s>>>(
        q, k, v, key, out, sp, io, dm);
  } else {
    err = xpk_set_smem(
        reinterpret_cast<const void*>(ssa_attention_keyed_kernel), smem);
    if (err) return err;
    ssa_attention_keyed_kernel<<<grid, kTileThreads, smem, s>>>(
        q, k, v, key, out, sp, io, dm);
  }
  return static_cast<int>(cudaGetLastError());
}

// The keyed K8's resources on this card, for a launch with `smem` bytes of
// dynamic shared memory of the resident (streaming == 0) or streaming
// design: out[0] registers a thread, out[1] local memory bytes a thread
// (spills), out[2] the blocks of kTileThreads an SM holds at once.
extern "C" int ssa_attention_keyed_resources(int streaming, long long smem,
                                             int* out) {
  const void* fn =
      streaming ? reinterpret_cast<const void*>(ssa_attention_keyed_stream_kernel)
                : reinterpret_cast<const void*>(ssa_attention_keyed_kernel);
  cudaFuncAttributes attr;
  int err = static_cast<int>(cudaFuncGetAttributes(&attr, fn));
  if (err) return err;
  err = xpk_set_smem(fn, smem);
  if (err) return err;
  int blocks = 0;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, kTileThreads, static_cast<size_t>(smem)));
  if (err) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  return 0;
}
