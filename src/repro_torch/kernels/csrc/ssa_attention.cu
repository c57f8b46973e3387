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
// [N, D] (one byte per spike) and int32 draws rs [N, N] in [0, D), ra [N, D]
// in [0, N):
//   s_ij = popcount(q_i & k_j) > rs[i, j]   (causal: s_ij = 0 for j > i)
//   a_id = popcount(s_i & v[:, d]) > ra[i, d]
// q, k, v, rs, ra [G, ...] -> out uint8 [G, N, D], any N and D.
//
// Bound on the card: bytes.  The int32 draws are 4 (N*N + N*D) bytes of a
// tile against 4 N*D bytes of spikes in and out (at the ViT's N = D = 64,
// two thirds of the traffic), and a tile does 2 N*N*ceil(D/32) + 2 N*D*
// ceil(N/32) AND-popcounts of 32 lanes on them: a few operations a byte.
// Design: one block per tile (the ViT's G = T*B*H is 1,536 at B = 64).  The
// block packs its tile into shared memory once: Q and K along D (a thread
// packs 32 consecutive bytes of a row, 16-byte loads when aligned) and V
// along the sequence (a thread packs one column over 32 rows; neighbouring
// threads read neighbouring bytes).  Then each warp takes query rows in turn:
// its lanes score 32 keys at once (one popcount per word of D, the draw read
// coalesced along j), a ballot packs the 32 score spikes into a word, and the
// lanes then take the output columns: one popcount per word of the sequence
// against the packed V column, the draw and the spike coalesced along d.
// Lanes past N or D read nothing and count zero, which is the reference's
// 32-lane zero padding (a zero count never beats a draw), so the draws are
// read at their logical shapes.  Counts are exact integers.
//
// A tile that does not fit the 227 KB of a block (about N * D > 2**20, e.g.
// N = 2,048 at D = 512) takes ssa_attention_stream_kernel instead: a block
// per (tile, block of RQ query rows), whose packed queries and score bits
// stay in shared memory while K streams through it along the sequence in
// chunks of NC keys (each packed once a block) and the score bits of a row
// accumulate over the chunks; then V streams in chunks of 64 columns by NC
// sequence rows, the output counts accumulating in registers over the
// sequence chunks.  The wrapper (kernels/ssa_attention.py:attention_plan)
// picks the design and the chunk sizes from N and D.

constexpr int kTileThreads = 256;
constexpr int kStreamCols = 64;  // V columns a stream chunk: 2 a lane

__global__ void __launch_bounds__(kTileThreads)
ssa_attention_kernel(const uint8_t* __restrict__ q,
                     const uint8_t* __restrict__ k,
                     const uint8_t* __restrict__ v, const int* __restrict__ rs,
                     const int* __restrict__ ra, uint8_t* __restrict__ out,
                     int N, int D, int causal) {
  extern __shared__ uint32_t tile[];
  const int wd = (D + 31) / 32, wn = (N + 31) / 32;
  uint32_t* qw = tile;          // [N][wd]: row i's words are a broadcast
  uint32_t* kw = qw + N * wd;   // [wd][N]: lanes read consecutive keys j
  uint32_t* vw = kw + wd * N;   // [wn][D]: lanes read consecutive columns d
  uint32_t* sw = vw + wn * D;   // [warps][wn]: one row's score spikes a warp
  const size_t g = blockIdx.x, nd = static_cast<size_t>(N) * D;
  const uint8_t* qg = q + g * nd;
  const uint8_t* kg = k + g * nd;
  const uint8_t* vg = v + g * nd;

  for (int idx = threadIdx.x; idx < N * wd; idx += blockDim.x) {
    const int r = idx / wd, w = idx - r * wd;
    const size_t off = static_cast<size_t>(r) * D + 32 * w;
    qw[idx] = xpk_pack32(qg + off, D - 32 * w);
    kw[w * N + r] = xpk_pack32(kg + off, D - 32 * w);
  }
  for (int idx = threadIdx.x; idx < wn * D; idx += blockDim.x) {
    const int w = idx / D, d = idx - w * D;
    const int rows = min(32, N - 32 * w);
    const uint8_t* col = vg + static_cast<size_t>(32 * w) * D + d;
    uint32_t word = 0;
    for (int jj = 0; jj < rows; ++jj)
      word |= static_cast<uint32_t>(col[static_cast<size_t>(jj) * D] & 1u) << jj;
    vw[idx] = word;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* srow = sw + warp * wn;
  for (int i = warp; i < N; i += kTileThreads / 32) {
    const int jend = causal ? i + 1 : N;
    const uint32_t* qi = qw + i * wd;
    const int* rsi = rs + (g * N + i) * N;
    for (int w = 0; w < wn; ++w) {
      const int j = 32 * w + lane;
      bool spike = false;
      if (j < jend) {
        int cnt = 0;
        for (int x = 0; x < wd; ++x) cnt += __popc(qi[x] & kw[x * N + j]);
        spike = cnt > __ldg(rsi + j);
      }
      const uint32_t word = __ballot_sync(0xffffffffu, spike);
      if (lane == 0) srow[w] = word;
    }
    __syncwarp();
    const int* rai = ra + (g * N + i) * D;
    uint8_t* oi = out + (g * N + i) * D;
    for (int d = lane; d < D; d += 32) {
      int cnt = 0;
      for (int w = 0; w < wn; ++w) cnt += __popc(srow[w] & vw[w * D + d]);
      oi[d] = cnt > __ldg(rai + d) ? 1 : 0;
    }
    __syncwarp();  // srow is rewritten by this warp's next row
  }
}


// K8 past the resident budget (see the note above).  Block b takes tile
// g = b / nrb and query rows [i0, i0 + RQ); RQ <= 64 (at most 8 rows a
// warp), NC a multiple of 32.
__global__ void __launch_bounds__(kTileThreads)
ssa_attention_stream_kernel(const uint8_t* __restrict__ q,
                            const uint8_t* __restrict__ k,
                            const uint8_t* __restrict__ v,
                            const int* __restrict__ rs,
                            const int* __restrict__ ra,
                            uint8_t* __restrict__ out, int N, int D,
                            int causal, int RQ, int NC) {
  extern __shared__ uint32_t smem[];
  const int wd = (D + 31) / 32, wn = (N + 31) / 32;
  const int nrb = (N + RQ - 1) / RQ;
  const size_t g = blockIdx.x / nrb;
  const int i0 = static_cast<int>(blockIdx.x % nrb) * RQ;
  const int rows = min(RQ, N - i0);
  uint32_t* qw = smem;          // [RQ][wd]  the block's packed queries
  uint32_t* sw = qw + RQ * wd;  // [RQ][wn]  their score spikes
  uint32_t* cw = sw + RQ * wn;  // a K chunk [wd][NC] or a V chunk [NC/32][64]
  const size_t nd = static_cast<size_t>(N) * D;
  const uint8_t* qg = q + g * nd;
  const uint8_t* kg = k + g * nd;
  const uint8_t* vg = v + g * nd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int idx = threadIdx.x; idx < rows * wd; idx += blockDim.x) {
    const int r = idx / wd, x = idx - r * wd;
    qw[idx] = xpk_pack32(qg + static_cast<size_t>(i0 + r) * D + 32 * x,
                         D - 32 * x);
  }
  for (int idx = threadIdx.x; idx < rows * wn; idx += blockDim.x) sw[idx] = 0;

  // score stage: keys the block's rows can see, NC at a time
  const int jmax = causal ? i0 + rows : N;
  for (int j0 = 0; j0 < jmax; j0 += NC) {
    const int nc = min(NC, jmax - j0);
    __syncthreads();  // the packed queries are in; the last chunk is read
    for (int idx = threadIdx.x; idx < nc * wd; idx += blockDim.x) {
      const int jj = idx / wd, x = idx - jj * wd;
      cw[x * NC + jj] = xpk_pack32(kg + static_cast<size_t>(j0 + jj) * D + 32 * x,
                                   D - 32 * x);
    }
    __syncthreads();
    for (int r = warp; r < rows; r += kTileThreads / 32) {
      const int i = i0 + r, jend = causal ? i + 1 : N;
      const uint32_t* qi = qw + r * wd;
      const int* rsi = rs + (g * N + i) * N;
      for (int w = 0; w < (nc + 31) / 32; ++w) {
        const int jj = 32 * w + lane, j = j0 + jj;
        bool spike = false;
        if (jj < nc && j < jend) {
          int cnt = 0;
          for (int x = 0; x < wd; ++x) cnt += __popc(qi[x] & cw[x * NC + jj]);
          spike = cnt > __ldg(rsi + j);
        }
        const uint32_t word = __ballot_sync(0xffffffffu, spike);
        if (lane == 0) sw[r * wn + j0 / 32 + w] = word;
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
          const uint8_t* col = vg + static_cast<size_t>(j0) * D + d;
          for (int jj = 0; jj < n; ++jj)
            word |= static_cast<uint32_t>(col[static_cast<size_t>(jj) * D] & 1u) << jj;
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
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = d0 + lane + 32 * c;
        if (r < rows && d < D) {
          const size_t at = (g * N + i0 + r) * D + d;
          out[at] = cnt[a][c] > __ldg(ra + at) ? 1 : 0;
        }
      }
    }
  }
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

// K8's two launchers take the design and its shared memory from the
// wrapper's plan (kernels/ssa_attention.py:attention_plan) and refuse
// shared memory that differs from their buffers' layout.
extern "C" int launch_ssa_attention(const uint8_t* q, const uint8_t* k,
                                    const uint8_t* v, const int* rs,
                                    const int* ra, uint8_t* out, int G, int N,
                                    int D, int causal, long long smem,
                                    void* stream) {
  const int wd = (D + 31) / 32, wn = (N + 31) / 32;
  const size_t need = sizeof(uint32_t) *
      (2 * static_cast<size_t>(N) * wd + static_cast<size_t>(wn) * D +
       (kTileThreads / 32) * static_cast<size_t>(wn));
  if (smem < 0 || static_cast<size_t>(smem) != need)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = xpk_set_smem(reinterpret_cast<const void*>(ssa_attention_kernel),
                         smem);
  if (err) return err;
  ssa_attention_kernel<<<G, kTileThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      q, k, v, rs, ra, out, N, D, causal);
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
  const size_t wd = (D + 31) / 32, wn = (N + 31) / 32;
  const size_t chunk = wd * NC > static_cast<size_t>(NC / 32) * kStreamCols
                           ? wd * NC : static_cast<size_t>(NC / 32) * kStreamCols;
  if (RQ < 8 || RQ > 64 || RQ % 8 || NC < 32 || NC % 32 || smem < 0 ||
      static_cast<size_t>(smem) != sizeof(uint32_t) * (RQ * wd + RQ * wn + chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = xpk_set_smem(
      reinterpret_cast<const void*>(ssa_attention_stream_kernel), smem);
  if (err) return err;
  const size_t blocks = static_cast<size_t>(G) * ((N + RQ - 1) / RQ);
  ssa_attention_stream_kernel<<<static_cast<unsigned>(blocks), kTileThreads,
                                smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, rs, ra, out, N, D, causal, RQ, NC);
  return static_cast<int>(cudaGetLastError());
}
