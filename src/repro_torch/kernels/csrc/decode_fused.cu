// K3 and K9: one whole spiking decoder layer step per launch, over a dense
// slot cache (K3) or a block-paged pool (K9).
//
// K3 replaces the TPU kernel repro/kernels/decode_fused.py:fused_decode_layer
// (pallas_call at :283, body _fused_dense_body at :162); K9 replaces
// fused_decode_layer_paged (pallas_call at :491, body _fused_paged_body at
// :300).  One kernel body serves both: it is a template over the cache
// layout, which only changes where cached row j of a (slot, t, KV head) lives
// and when the new token's write counts.
//
// Per slot b: Q/K/V crossbar + LIF on the residual spike stream, one SSA
// query row per (t, head) over the slot's *pre-scatter* cache plus the new
// token added on top, attention-out + residual, then the FFN tail (crossbar +
// LIF twice) + residual.  The caller scatters k_new / v_new afterwards.
//
// s f32 [T, B, d] (integer-valued), pos int32 [B], rs int32 [B, T, H, L], ra
// int32 [B, T, H, hd], six (int8 levels [din, dout], f32 scale, f32 bias or
// null) triples -> s_out f32 [T, B, d] (or the attention train [T, B, H*hd]
// when !with_tail), k_new/v_new uint8 [T, B, KV, hd].  Dense (K3): sk/sv
// uint8 [B, T, L, KV, hd].  Paged (K9): kpool/vpool uint8 [P, T, KV,
// page_len, hd], table int32 [B, MP] and write_pids int64 [B], L = MP *
// page_len: logical row j of slot b is in-page row j % page_len of page
// table[b, j / page_len], read straight from the pool (the null page, 0, is
// skipped: it is zero by contract).  The new token's score draw is rs[b, t,
// h, pos[b]], read here; it is 2**30 (never beaten) where the write does not
// land: pos >= L, or, paged, the table does not show the slot's write page
// at pos (an idle slot writing the trash page).
//
// Bound on the card: bytes.  A layer step must read the int8 weights once
// (786,432 B at d = 256, d_ff = 1,024) and each slot's cached key rows below
// pos plus the value rows whose score spiked (rows at and after pos are zero
// by contract, and a zero row never spikes); the integer work is small
// beside that.  What held the one-block-a-slot design back, and what this
// one does about it:
//   1. The grid: one block a slot filled 8 of 132 SMs at B = 8.  Here one
//      thread-block cluster of kCluster blocks runs a slot (a grid of B x
//      kCluster blocks, launched with the cluster-dimension attribute;
//      clusters need no co-residency, so any B launches), each block a
//      rank of the slot; the ranks trade the q / k_new / v_new of their
//      query rows, the attention train, the residual's update and the FFN
//      hidden train through distributed shared memory between cluster
//      barriers, and nothing but the outputs touches device memory.
//   2. The linears: a thread walked d_in serially with a byte load a row.
//      Here a rank owns 1/kCluster of each linear's output columns (a
//      cluster reads each weight once; Q, K and V are one pass), d_in is
//      split over thread groups that take rows four at a time: four aligned
//      words of four columns, issued kQuadBatch quads ahead, transposed in
//      registers so that __dp4a counts four rows of a column against the
//      four int8 inputs of a step (the residual too, through an int8 copy
//      wherever every value fits; else int32 multiply-adds).  The groups'
//      int32 partials are summed in shared memory (exact under any split)
//      before the column's owner runs the LIF over T in order (XPK_MAX_T
//      steps at a time, the membrane carried).  lin_lif is not inlined, so
//      the linears after the first run warm code.
//   3. The attention: T*H rows ran one after another.  Here they are
//      shared out over the ranks (2 a rank at T = H = 4); the score stage
//      covers only rows j < min(pos, L) (paged: non-null pages), a warp a
//      32-row word of score spikes; the count stage gives every warp score
//      words and its lanes four value bytes each, four rows' loads in
//      flight (the per-byte sums of 0/1 spikes over at most 32 rows cannot
//      carry), summed with shared-memory atomics (integers: exact).
//   4. The host: the wrapper drew the new token's score draw with torch ops
//      and zero-filled a bias for every null one.  Here the kernel reads
//      rs[b, t, h, pos] and the write-page check itself, and a null bias is
//      a null pointer.
// Any T, any hd (every per-row buffer is dynamic shared memory), GQA (query
// head h reads KV head h / (H / KV)).  The limit is the shared memory of
// smem_layout, which the wrapper (kernels/decode_fused.py:layer_plan) checks
// against the card's 227 KB; the launcher refuses any plan but its own.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;              // blocks a slot: the portable maximum
constexpr int kTileCols = 4 * kThreads;  // output columns a linear's pass takes
constexpr int kInvalidRs = 1 << 30;      // a draw no AND-count beats

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// A rank's share of n output columns: a multiple of 4, so that a lane's word
// of four int8 levels never straddles two ranks.  Rank r owns columns
// [r * share, min(n, (r + 1) * share)).
__host__ __device__ inline int share(int n) {
  return (cdiv(n, kCluster) + 3) & ~3;
}

__device__ inline int owned(int n, int sh, int rank) {
  return max(0, min(n, (rank + 1) * sh) - rank * sh);
}

// The shared-memory segments of one block, each 16-aligned.  The wrapper
// (kernels/decode_fused.py:layer_smem_bytes) mirrors this list.
enum Seg {
  kXs,     // int32 [T][d]          the residual stream, every column
  kX8,     // int8 [T][d]           its int8 copy (used where every value fits)
  kQo,     // u8 [T][share(H*hd)]   this rank's query spike columns
  kKo,     // u8 [T][share(KV*hd)]  its new key columns
  kVo,     // u8 [T][share(KV*hd)]  its new value columns
  kQrow,   // u8 [R][hd]            the query of each of this rank's rows
  kKrow,   // u8 [R][hd]            the row's new key
  kVrow,   // u8 [R][hd]            the row's new value
  kQw,     // u32 [R][wd]           the packed query
  kKw,     // u32 [R][wd]           the packed new key
  kSbits,  // u32 [R][wl]           packed score spikes
  kAcnt,   // int32 [R][hd]         value counts of the cached rows
  kSnew,   // int32 [R]             the new token's score spike
  kAo,     // u8 [R][hd]            this rank's attention rows
  kTrain,  // u8 [T][max(H*hd, dff)] the attention train, then the FFN
           //                       hidden train, every column
  kOo,     // u8 [T][share(d)]      attention-out, then FFN-out, spikes
  kHo,     // u8 [T][share(dff)]    this rank's FFN hidden spikes
  kPart,   // int32 [kTileCols * min(T, XPK_MAX_T)]  a linear's partial counts
  kSegments
};

// R = ceil(T*H / kCluster) query rows a rank, wd = ceil(hd/32), wl =
// ceil(L/32).  Returns the total; off[] gets each segment's byte offset.
__host__ __device__ inline size_t smem_layout(int T, int d, int H, int KV,
                                              int hd, int L, int dff,
                                              size_t off[kSegments]) {
  const size_t t = T, r = cdiv(T * H, kCluster), h = hd;
  const size_t wd = cdiv(hd, 32), wl = cdiv(L, 32);
  const size_t n = T < XPK_MAX_T ? T : XPK_MAX_T;
  const size_t sizes[kSegments] = {
      4 * t * d,  t * d,          t * share(H * hd), t * share(KV * hd),
      t * share(KV * hd),         r * h,             r * h,
      r * h,      4 * r * wd,     4 * r * wd,        4 * r * wl,
      4 * r * h,  4 * r,          r * h,
      t * (H * h > static_cast<size_t>(dff) ? H * h : dff),
      t * share(d),               t * share(dff),    4 * kTileCols * n};
  size_t total = 0;
#pragma unroll
  for (int i = 0; i < kSegments; ++i) {
    off[i] = total;
    total = xpk_align16(total + sizes[i]);
  }
  return total;
}

struct Weights {
  const int8_t* lv;
  const float* sc;
  const float* bi;  // null: no bias
};

struct Args {
  const float* s;
  const int* pos;
  const int* rs;
  const int* ra;
  Weights wq, wk, wv, wo, wi, wo2;
  float* s_out;
  uint8_t* k_new;
  uint8_t* v_new;
  int* placement;  // null, or [grid][3]: where each block ran (a probe)
  int T, B, d, H, KV, hd, L, dff, with_tail, with_mlp;
  float beta, vth;
};

// The dense slot cache [B, T, L, KV, hd] (K3).
struct DenseCache {
  const uint8_t* k;
  const uint8_t* v;
  int T, L, KV, hd;
  __device__ XpkDenseRows rows(int b, int t, int kvh) const {
    const size_t base = ((static_cast<size_t>(b) * T + t) * L * KV + kvh) * hd;
    return {k + base, v + base, static_cast<size_t>(KV) * hd};
  }
  // the new token's row lands wherever pos is inside the cache
  __device__ bool writes_at(int, int pos) const { return pos < L; }
};

// The page pool [P, T, KV, page_len, hd] behind table [B, MP] (K9).
struct PagedCache {
  const uint8_t* k;
  const uint8_t* v;
  const int* table;
  const long long* write;  // [B] the page each slot's new row goes to
  int T, KV, hd, page_len, MP;
  __device__ XpkPagedRows rows(int b, int t, int kvh) const {
    const size_t base = (static_cast<size_t>(t) * KV + kvh) * page_len * hd;
    return {k + base, v + base, table + static_cast<size_t>(b) * MP,
            static_cast<size_t>(T) * KV * page_len * hd, page_len, hd};
  }
  // ... and, paged, only where the table shows the slot's write page at pos
  __device__ bool writes_at(int b, int pos) const {
    if (pos >= MP * page_len) return false;
    const int col = min(max(pos / page_len, 0), MP - 1);
    return static_cast<long long>(table[static_cast<size_t>(b) * MP + col]) ==
           write[b];
  }
};

// Spike (t, c) of a [T][n] train whose columns are shared out over the
// cluster in shares of sh: rank c / sh holds it at own[t * sh + c % sh].
__device__ inline uint8_t* peer(uint8_t* own, int sh, int t, int c) {
  const int r = c / sh;
  return cg::this_cluster().map_shared_rank(own, r) + t * sh + (c - r * sh);
}

// f(t, c, spikes, count) over every column of such a train, four spikes a
// word (bit 8k + 0 is column c + k) where the widths allow, else one.
template <class F>
__device__ void for_train(uint8_t* own, int T, int n, int sh, F f) {
  if ((n & 3) == 0) {
    const int nw = n / 4;
    for (int i = threadIdx.x; i < T * nw; i += kThreads) {
      const int t = i / nw, c = 4 * (i - t * nw);
      f(t, c, *reinterpret_cast<const uint32_t*>(peer(own, sh, t, c)), 4);
    }
  } else {
    for (int i = threadIdx.x; i < T * n; i += kThreads) {
      const int t = i / n, c = i - t * n;
      f(t, c, static_cast<uint32_t>(*peer(own, sh, t, c)), 1);
    }
  }
}

// The whole [T][n] train into dst, from the ranks' shares.
__device__ void gather_train(uint8_t* dst, uint8_t* own, int T, int n,
                             int sh) {
  for_train(own, T, n, sh, [&](int t, int c, uint32_t w, int k) {
    if (k == 4)
      *reinterpret_cast<uint32_t*>(dst + t * n + c) = w;
    else
      dst[t * n + c] = static_cast<uint8_t>(w);
  });
}

// Four adjacent int8 levels of one weight row, as one word (columns past
// ncol read 0): one aligned load, or (kVec false) four byte loads.
template <bool kVec>
__device__ inline uint32_t level_word(const int8_t* p, int ncol) {
  if (kVec) return __ldg(reinterpret_cast<const unsigned int*>(p));
  uint32_t u = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t b = static_cast<uint8_t>(__ldg(p + min(k, ncol - 1)));
    u |= (k < ncol ? b : 0u) << (8 * k);
  }
  return u;
}

// One thread group's int32 counts of its word of four columns over rows
// g, g + groups, ... of d_in, one multiply-add a step and column (any
// integer x): kRowBatch rows' weight loads issued before any is used
// (indices clamped, not branched on, so that they issue together).
constexpr int kRowBatch = 8;
template <bool kVec, typename X>
__device__ inline void group_counts(const X* xc, int din, const int8_t* lv,
                                    int dout, int ncol, int g, int groups,
                                    int n, int (&acc)[XPK_MAX_T][4]) {
  for (int i0 = g; i0 < din; i0 += kRowBatch * groups) {
    uint32_t lvw[kRowBatch];
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u)
      lvw[u] = level_word<kVec>(
          lv + static_cast<size_t>(min(i0 + u * groups, din - 1)) * dout, ncol);
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u) {
      const int i = i0 + u * groups;
      const uint32_t wv = i < din ? lvw[u] : 0u;
      const int ii = min(i, din - 1);
      const int l0 = static_cast<signed char>(wv);
      const int l1 = static_cast<signed char>(wv >> 8);
      const int l2 = static_cast<signed char>(wv >> 16);
      const int l3 = static_cast<signed char>(wv >> 24);
#pragma unroll
      for (int t = 0; t < XPK_MAX_T; ++t) {
        if (t < n) {
          const int xv = static_cast<int>(xc[t * din + ii]);
          acc[t][0] += xv * l0;
          acc[t][1] += xv * l1;
          acc[t][2] += xv * l2;
          acc[t][3] += xv * l3;
        }
      }
    }
  }
}

// Rows r0..r3 of four columns (a word each) -> columns c0..c3 of four rows.
__device__ inline void transpose4x4(const uint32_t (&in)[4], uint32_t (&out)[4]) {
  const uint32_t a = __byte_perm(in[0], in[1], 0x5140);  // r0c0 r1c0 r0c1 r1c1
  const uint32_t b = __byte_perm(in[2], in[3], 0x5140);  // r2c0 r3c0 r2c1 r3c1
  const uint32_t c = __byte_perm(in[0], in[1], 0x7362);  // r0c2 r1c2 r0c3 r1c3
  const uint32_t d = __byte_perm(in[2], in[3], 0x7362);  // r2c2 r3c2 r2c3 r3c3
  out[0] = __byte_perm(a, b, 0x5410);
  out[1] = __byte_perm(a, b, 0x7632);
  out[2] = __byte_perm(c, d, 0x5410);
  out[3] = __byte_perm(c, d, 0x7632);
}

// group_counts over int8 x (d_in a multiple of 4): rows in quads q = g,
// g + groups, ...; a quad's four weight words are transposed in registers
// so that one __dp4a takes four rows of one column against the four x bytes
// of one step (exact: int8 x int8 summed in int32).  kQuadBatch quads'
// loads are issued before any is used.  kN > 0: exactly kN steps, unrolled
// without a branch; kN = 0: n <= XPK_MAX_T steps.
constexpr int kQuadBatch = 4;
template <bool kVec, int kN>
__device__ inline void group_counts4(const int8_t* xc, int din,
                                     const int8_t* lv, int dout, int ncol,
                                     int g, int groups, int n,
                                     int (&acc)[XPK_MAX_T][4]) {
  const int nq = din / 4;
  for (int q0 = g; q0 < nq; q0 += kQuadBatch * groups) {
    uint32_t wq[kQuadBatch][4];
#pragma unroll
    for (int u = 0; u < kQuadBatch; ++u) {
      const int q = min(q0 + u * groups, nq - 1);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        wq[u][r] = level_word<kVec>(lv + static_cast<size_t>(4 * q + r) * dout, ncol);
    }
#pragma unroll
    for (int u = 0; u < kQuadBatch; ++u) {
      const int q = q0 + u * groups, qc = min(q, nq - 1);
      uint32_t cw[4];
      transpose4x4(wq[u], cw);
#pragma unroll
      for (int k = 0; k < 4; ++k) cw[k] = q < nq ? cw[k] : 0u;
#pragma unroll
      for (int t = 0; t < (kN ? kN : XPK_MAX_T); ++t) {
        if (kN || t < n) {
          const int xw = *reinterpret_cast<const int*>(xc + t * din + 4 * qc);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[t][k] = __dp4a(xw, static_cast<int>(cw[k]), acc[t][k]);
        }
      }
    }
  }
}

// One output of a linear pass: this rank's columns [c0, c0 + nc) of a
// crossbar with levels [din][dout], its spikes to out[t * sh + c - c0].
struct LinPart {
  Weights w;
  int dout, c0, nc;
  uint8_t* out;
  int sh;
};

// ps[p], chosen by selects (a runtime index would put ps in local memory).
template <int kParts>
__device__ inline LinPart pick(const LinPart (&ps)[kParts], int p) {
  LinPart r = ps[0];
#pragma unroll
  for (int i = 1; i < kParts; ++i)
    if (p == i) r = ps[i];
  return r;
}

// Crossbar counts + LIF of every part's columns over one input x [T][din]
// (shared memory): Q, K and V are three parts of one pass, the other
// linears one each.  x8 is x as int8 (a spike train, or the residual's
// copy when x8_ok); x32, if not null, is the residual as int32, counted
// where the int8 copy cannot be (a residual value past int8, or d_in not a
// multiple of 4).  The parts' columns are laid end to end in words of four
// (a part's last word padded), and a pass takes up to kThreads words and
// XPK_MAX_T steps: kThreads / nw thread groups each sum a strided part of
// d_in for one word in int32 registers (group_counts4, else group_counts),
// the groups' partials are summed in `part` one (t, column) a thread, then
// thread e runs column e's membrane over the steps (carried to the next
// pass) with the scale and bias it loaded before the counts.
template <int kParts>
__device__ __noinline__ void lin_lif(const int8_t* x8, const int* x32, bool x8_ok, int din,
                        const LinPart (&ps)[kParts], int T, float beta,
                        float vth, int* part) {
  constexpr int kOwn = kTileCols / kThreads;  // columns a thread's LIF runs
  const int tid = threadIdx.x;
  const bool quads = (din & 3) == 0 && (x32 == nullptr || x8_ok);
  int w_end[kParts];  // words before the end of each part
  int total = 0;
#pragma unroll
  for (int p = 0; p < kParts; ++p) w_end[p] = total += cdiv(ps[p].nc, 4);
  // the part and its column of word-column e (c < 0: padding)
  auto locate = [&](int e, int& p, int& c) {
    const int wd = e >> 2;
    int start = 0;  // the part's first word
    p = 0;
#pragma unroll
    for (int i = 0; i < kParts - 1; ++i)
      if (wd >= w_end[i]) p = i + 1, start = w_end[i];
    const LinPart q = pick(ps, p);
    c = e - 4 * start < q.nc ? q.c0 + e - 4 * start : -1;
  };
  for (int w0 = 0; w0 < total; w0 += kThreads) {
    const int nw = min(kThreads, total - w0), tc = 4 * nw;
    const int groups = kThreads / nw;
    const int g = tid / nw, lw = tid - g * nw;
    int wp, col;
    locate(4 * (w0 + lw), wp, col);
    const LinPart pw = pick(ps, wp);
    const int ncol = min(4, pw.c0 + pw.nc - col);  // columns in this word
    const bool vec = (pw.dout & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(pw.w.lv) & 3) == 0;
    float v[kOwn], sc[kOwn], bi[kOwn];
#pragma unroll
    for (int k = 0; k < kOwn; ++k) {
      int p, c;
      locate(4 * w0 + min(tid + k * kThreads, tc - 1), p, c);
      const LinPart pk = pick(ps, p);
      c = max(c, 0);
      v[k] = 0.f;
      sc[k] = pk.w.sc[c];
      bi[k] = pk.w.bi ? pk.w.bi[c] : 0.f;
    }
    for (int t0 = 0; t0 < T; t0 += XPK_MAX_T) {
      const int n = min(XPK_MAX_T, T - t0);
      if (g < groups) {
        const size_t xo = static_cast<size_t>(t0) * din;
        const int8_t* lc = pw.w.lv + col;
        int acc[XPK_MAX_T][4];
#pragma unroll
        for (int t = 0; t < XPK_MAX_T; ++t)
          acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0;
        if (quads) {
          if (vec && n == 4)
            group_counts4<true, 4>(x8 + xo, din, lc, pw.dout, ncol, g, groups, n, acc);
          else if (vec)
            group_counts4<true, 0>(x8 + xo, din, lc, pw.dout, ncol, g, groups, n, acc);
          else
            group_counts4<false, 0>(x8 + xo, din, lc, pw.dout, ncol, g, groups, n, acc);
        } else if (x32) {
          if (vec)
            group_counts<true>(x32 + xo, din, lc, pw.dout, ncol, g, groups, n, acc);
          else
            group_counts<false>(x32 + xo, din, lc, pw.dout, ncol, g, groups, n, acc);
        } else {
          group_counts<false>(x8 + xo, din, lc, pw.dout, ncol, g, groups, n, acc);
        }
#pragma unroll
        for (int t = 0; t < XPK_MAX_T; ++t) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (t < n) part[(g * n + t) * tc + 4 * lw + k] = k < ncol ? acc[t][k] : 0;
        }
      }
      __syncthreads();
      // (t, e)'s sum over the groups, into group 0's slot
      for (int q = tid; q < n * tc; q += kThreads) {
        int sum = 0;
#pragma unroll 8
        for (int gg = 0; gg < groups; ++gg) sum += part[gg * n * tc + q];
        part[q] = sum;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kOwn; ++k) {
        const int e = tid + k * kThreads;
        int p, c;
        locate(4 * w0 + e, p, c);
        if (e < tc && c >= 0) {
          const LinPart pk = pick(ps, p);
          xpk_lif_epilogue(part + e, tc, n, sc[k], bi[k], beta, vth, v[k],
                           pk.out + static_cast<size_t>(t0) * pk.sh + c - pk.c0,
                           pk.sh);
        }
      }
      __syncthreads();
    }
  }
}

// Count stage of one 32-row word of score spikes m (rows j0 + bit), a warp:
// cnt[dd] += the number of spiked rows j with v_j[dd] set.  Four value lanes
// a lane as one word when rows are word-aligned (the per-byte sums of 0/1
// over at most 32 rows never carry), so a warp takes 32 / lanes-a-row rows
// at once; else one byte a lane.
template <class Rows>
__device__ void count_word(const Rows& rows, uint32_t m, int j0, int hd,
                           bool words, int* cnt) {
  const int lane = threadIdx.x & 31;
  if (words) {
    const int wpr = hd / 4;  // words a value row
    int lpr = 1;             // lanes a row: a power of two, up to 32
    while (lpr < wpr && lpr < 32) lpr *= 2;
    const int rpp = 32 / lpr, sub = lane / lpr;
    for (int w0 = 0; w0 < wpr; w0 += lpr) {
      const int wi = w0 + (lane - sub * lpr);
      uint32_t mm = m, acc = 0;
      for (int s = 0; s < sub && mm; ++s) mm &= mm - 1;
      // past the last set bit a slot reloads the first spiked row (never a
      // null page's) and adds nothing
      const int wc = min(wi, wpr - 1), jf = __ffs(static_cast<int>(m)) - 1;
      while (mm) {  // four rows' loads in flight at once
        int js[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {  // the next four set bits
          js[u] = mm ? __ffs(static_cast<int>(mm)) - 1 : -1;
          for (int s = 0; s < rpp && mm; ++s) mm &= mm - 1;
        }
        uint32_t vw[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          vw[u] = reinterpret_cast<const uint32_t*>(
              rows.v(j0 + (js[u] >= 0 ? js[u] : jf)))[wc];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc += js[u] >= 0 && wi < wpr ? vw[u] & 0x01010101u : 0u;
      }
      if (wi < wpr && acc) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = (acc >> (8 * k)) & 0xff;
          if (c) atomicAdd(cnt + 4 * wi + k, c);
        }
      }
    }
    return;
  }
  for (int d0 = 0; d0 < hd; d0 += 32) {
    const int dd = d0 + lane;
    int acc = 0;
    for (uint32_t mm = m; mm; mm &= mm - 1)
      if (dd < hd) acc += rows.v(j0 + __ffs(static_cast<int>(mm)) - 1)[dd] & 1;
    if (acc) atomicAdd(cnt + dd, acc);
  }
}

template <class Cache>
__global__ void __launch_bounds__(kThreads)
fused_decode_layer_kernel(const Args a, const Cache cache) {
  extern __shared__ __align__(16) char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int T = a.T, d = a.d, H = a.H, KV = a.KV, hd = a.hd, L = a.L;
  size_t off[kSegments];
  smem_layout(T, d, H, KV, hd, L, a.dff, off);
  auto seg = [&](Seg s) { return smem_raw + off[s]; };
  int* xs = reinterpret_cast<int*>(seg(kXs));
  int8_t* x8 = reinterpret_cast<int8_t*>(seg(kX8));
  uint8_t *qo = reinterpret_cast<uint8_t*>(seg(kQo)),
          *ko = reinterpret_cast<uint8_t*>(seg(kKo)),
          *vo = reinterpret_cast<uint8_t*>(seg(kVo)),
          *qrow = reinterpret_cast<uint8_t*>(seg(kQrow)),
          *krow = reinterpret_cast<uint8_t*>(seg(kKrow)),
          *vrow = reinterpret_cast<uint8_t*>(seg(kVrow)),
          *ao = reinterpret_cast<uint8_t*>(seg(kAo)),
          *afull = reinterpret_cast<uint8_t*>(seg(kTrain)),
          *oo = reinterpret_cast<uint8_t*>(seg(kOo)),
          *ho = reinterpret_cast<uint8_t*>(seg(kHo)),
          *hfull = afull;  // the attention train is dead once FFN-in runs
  uint32_t *qw = reinterpret_cast<uint32_t*>(seg(kQw)),
           *kw = reinterpret_cast<uint32_t*>(seg(kKw)),
           *sbits = reinterpret_cast<uint32_t*>(seg(kSbits));
  int *acnt = reinterpret_cast<int*>(seg(kAcnt)),
      *snew = reinterpret_cast<int*>(seg(kSnew)),
      *part = reinterpret_cast<int*>(seg(kPart));

  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rep = H / KV, wd = cdiv(hd, 32), wlm = cdiv(L, 32);
  const int shq = share(H * hd), shk = share(KV * hd), shd = share(d);
  if (a.placement != nullptr && tid == 0) {
    // the hardware's own account of this block: its SM, its cluster's size
    // and the cluster's index in the grid
    unsigned sm, nrank, cid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(nrank));
    asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(cid));
    int* p = a.placement + 3 * static_cast<size_t>(blockIdx.x);
    p[0] = static_cast<int>(sm);
    p[1] = static_cast<int>(nrank);
    p[2] = static_cast<int>(cid);
  }

  // 1. the residual stream in, as int32 and as int8 where every value fits
  bool fits = true;
  for (int i = tid; i < T * d; i += kThreads) {
    const int t = i / d, c = i - t * d;
    const int x = __float2int_rn(a.s[(static_cast<size_t>(t) * a.B + b) * d + c]);
    xs[i] = x;
    x8[i] = static_cast<int8_t>(x);
    fits = fits && x >= -128 && x <= 127;
  }
  bool x8_ok = __syncthreads_and(fits);

  // 2. this rank's Q/K/V columns; its k_new / v_new columns out
  {
    const LinPart qkv[3] = {
        {a.wq, H * hd, rank * shq, owned(H * hd, shq, rank), qo, shq},
        {a.wk, KV * hd, rank * shk, owned(KV * hd, shk, rank), ko, shk},
        {a.wv, KV * hd, rank * shk, owned(KV * hd, shk, rank), vo, shk}};
    lin_lif(x8, xs, x8_ok, d, qkv, T, a.beta, a.vth, part);
  }
  {
    const int nk = owned(KV * hd, shk, rank);
    for (int i = tid; i < T * nk; i += kThreads) {
      const int t = i / nk, c = i - t * nk;
      const size_t o = (static_cast<size_t>(t) * a.B + b) * KV * hd + rank * shk + c;
      a.k_new[o] = ko[t * shk + c];
      a.v_new[o] = vo[t * shk + c];
    }
  }
  cluster.sync();

  // 3. the exchange: q, k_new, v_new of this rank's query rows (t, h)
  const int R = cdiv(T * H, kCluster), r0 = rank * R;
  const int nr = max(0, min(T * H, r0 + R) - r0);
  if ((hd & 3) == 0) {
    const int nw = hd / 4;
    for (int i = tid; i < nr * nw; i += kThreads) {
      const int lr = i / nw, dd = 4 * (i - lr * nw);
      const int th = r0 + lr, t = th / H, h = th - t * H, kvh = h / rep;
      reinterpret_cast<uint32_t*>(qrow)[i] =
          *reinterpret_cast<const uint32_t*>(peer(qo, shq, t, h * hd + dd));
      reinterpret_cast<uint32_t*>(krow)[i] =
          *reinterpret_cast<const uint32_t*>(peer(ko, shk, t, kvh * hd + dd));
      reinterpret_cast<uint32_t*>(vrow)[i] =
          *reinterpret_cast<const uint32_t*>(peer(vo, shk, t, kvh * hd + dd));
    }
  } else {
    for (int i = tid; i < nr * hd; i += kThreads) {
      const int lr = i / hd, dd = i - lr * hd;
      const int th = r0 + lr, t = th / H, h = th - t * H, kvh = h / rep;
      qrow[i] = *peer(qo, shq, t, h * hd + dd);
      krow[i] = *peer(ko, shk, t, kvh * hd + dd);
      vrow[i] = *peer(vo, shk, t, kvh * hd + dd);
    }
  }
  __syncthreads();

  // 4. attention over this rank's rows
  const int pos = a.pos[b];
  const int jmax = max(0, min(pos, L));  // rows >= pos are zero: skipped
  const int wl = cdiv(jmax, 32);
  for (int i = tid; i < nr * wd; i += kThreads) {
    const int lr = i / wd, w = i - lr * wd;
    qw[i] = xpk_pack32(qrow + lr * hd + 32 * w, hd - 32 * w);
    kw[i] = xpk_pack32(krow + lr * hd + 32 * w, hd - 32 * w);
  }
  for (int i = tid; i < nr * hd; i += kThreads) acnt[i] = 0;
  __syncthreads();
  // the new token's score spike against its draw rs[b, t, h, pos]
  for (int lr = tid; lr < nr; lr += kThreads) {
    const int th = r0 + lr, t = th / H, h = th - t * H;
    int cnt = 0;
    for (int w = 0; w < wd; ++w) cnt += __popc(qw[lr * wd + w] & kw[lr * wd + w]);
    const int* rs = a.rs + ((static_cast<size_t>(b) * T + t) * H + h) * L;
    const int rsp = cache.writes_at(b, pos) ? rs[min(max(pos, 0), L - 1)]
                                            : kInvalidRs;
    snew[lr] = cnt > rsp ? 1 : 0;
  }
  // score stage: a warp a 32-row word, a lane a cached row
  for (int job = warp; job < nr * wl; job += kWarps) {
    const int lr = job / wl, w = job - lr * wl;
    const int th = r0 + lr, t = th / H, h = th - t * H;
    const auto rows = cache.rows(b, t, h / rep);
    const int j = 32 * w + lane;
    const uint8_t* row = j < jmax ? rows.k(j) : nullptr;
    bool spike = false;
    if (row) {
      int cnt = 0;
      for (int ww = 0; ww < wd; ++ww)
        cnt += __popc(qw[lr * wd + ww] & xpk_pack32(row + 32 * ww, hd - 32 * ww));
      spike = cnt > a.rs[((static_cast<size_t>(b) * T + t) * H + h) * L + j];
    }
    const uint32_t word = __ballot_sync(0xffffffffu, spike);
    if (lane == 0) sbits[lr * wlm + w] = word;
  }
  __syncthreads();
  // count stage: every warp takes score words
  const bool words =
      (hd & 3) == 0 && (reinterpret_cast<uintptr_t>(cache.v) & 3) == 0;
  for (int job = warp; job < nr * wl; job += kWarps) {
    const int lr = job / wl, w = job - lr * wl;
    const uint32_t m = sbits[lr * wlm + w];
    if (!m) continue;
    const int th = r0 + lr, t = th / H, h = th - t * H;
    count_word(cache.rows(b, t, h / rep), m, 32 * w, hd, words, acnt + lr * hd);
  }
  __syncthreads();
  for (int i = tid; i < nr * hd; i += kThreads) {
    const int lr = i / hd, dd = i - lr * hd;
    const int th = r0 + lr, t = th / H, h = th - t * H;
    const int cnt = acnt[i] + snew[lr] * vrow[i];
    ao[i] = cnt > a.ra[((static_cast<size_t>(b) * T + t) * H + h) * hd + dd] ? 1 : 0;
  }

  if (!a.with_tail) {
    for (int i = tid; i < nr * hd; i += kThreads) {
      const int lr = i / hd, dd = i - lr * hd;
      const int th = r0 + lr, t = th / H, h = th - t * H;
      a.s_out[(static_cast<size_t>(t) * a.B + b) * H * hd + h * hd + dd] = ao[i];
    }
    cluster.sync();  // peers may still read this block's q/k/v columns
    return;
  }
  cluster.sync();

  // 5. the tail.  The attention train in; this rank's attention-out columns
  if ((hd & 3) == 0) {  // row th = t * H + h is rank th / R's row th % R
    const int nw = hd / 4;
    for (int i = tid; i < T * H * nw; i += kThreads) {
      const int th = i / nw, r = th / R;
      reinterpret_cast<uint32_t*>(afull)[i] = *reinterpret_cast<const uint32_t*>(
          cluster.map_shared_rank(ao, r) + (th - r * R) * hd + 4 * (i - th * nw));
    }
  } else {
    for (int i = tid; i < T * H * hd; i += kThreads) {
      const int th = i / hd, r = th / R;
      afull[i] = *(cluster.map_shared_rank(ao, r) + (th - r * R) * hd + i - th * hd);
    }
  }
  __syncthreads();
  const int c0d = rank * shd, ncd = owned(d, shd, rank);
  const LinPart attn_out[1] = {{a.wo, d, c0d, ncd, oo, shd}};
  lin_lif(reinterpret_cast<int8_t*>(afull), nullptr, true, H * hd, attn_out,
          T, a.beta, a.vth, part);
  cluster.sync();
  // every rank adds every rank's attention-out spikes to its residual
  fits = true;
  for_train(oo, T, d, shd, [&](int t, int c, uint32_t w, int k) {
    for (int i = 0; i < k; ++i) {
      const int x = xs[t * d + c + i] + static_cast<int>((w >> (8 * i)) & 0xff);
      xs[t * d + c + i] = x;
      x8[t * d + c + i] = static_cast<int8_t>(x);
      fits = fits && x >= -128 && x <= 127;
    }
  });
  x8_ok = __syncthreads_and(fits);
  if (a.with_mlp) {
    const int dff = a.dff, shf = share(dff);
    const LinPart ffn_in[1] = {{a.wi, dff, rank * shf, owned(dff, shf, rank),
                                ho, shf}};
    lin_lif(x8, xs, x8_ok, d, ffn_in, T, a.beta, a.vth, part);
    cluster.sync();  // also: every peer has read oo, which FFN-out reuses
    gather_train(hfull, ho, T, dff, shf);
    __syncthreads();
    const LinPart ffn_out[1] = {{a.wo2, d, c0d, ncd, oo, shd}};
    lin_lif(reinterpret_cast<int8_t*>(hfull), nullptr, true, dff, ffn_out, T,
            a.beta, a.vth, part);
  }
  for (int i = tid; i < T * ncd; i += kThreads) {
    const int t = i / ncd, c = i - t * ncd;
    const int x = xs[t * d + c0d + c] + (a.with_mlp ? oo[t * shd + c] : 0);
    a.s_out[(static_cast<size_t>(t) * a.B + b) * d + c0d + c] =
        static_cast<float>(x);
  }
  cluster.sync();  // keep this block's shared memory alive for its peers
}

template <class Cache>
int launch(const Args& a, const Cache& cache, int cluster, int threads,
           long long planned, void* stream) {
  size_t off[kSegments];
  const size_t smem = smem_layout(a.T, a.d, a.H, a.KV, a.hd, a.L, a.dff, off);
  if (cluster != kCluster || threads != kThreads || planned < 0 ||
      static_cast<size_t>(planned) != smem)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = reinterpret_cast<const void*>(fused_decode_layer_kernel<Cache>);
  int err = xpk_set_smem(fn, smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.B) * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = static_cast<int>(
      cudaLaunchKernelEx(&cfg, fused_decode_layer_kernel<Cache>, a, cache));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Weight pointers come as six (levels, scale, bias) triples; a null bias is
// no bias, and a triple the step does not use (no tail, no MLP) is three
// nulls.  The plan (cluster, threads, smem) is the wrapper's
// (kernels/decode_fused.py:layer_plan); any other is refused.  placement is
// null, or int32 [B * cluster][3] that each block fills with its %smid,
// %cluster_nctarank and %clusterid.x.
#define XPK_WEIGHT_PARAMS                                                     \
  const int8_t *lq, const float *sq, const float *bq, const int8_t *lk,       \
      const float *sk_, const float *bk, const int8_t *lv, const float *sv_,  \
      const float *bv, const int8_t *lo, const float *so, const float *bo,    \
      const int8_t *li, const float *si, const float *bi, const int8_t *lo2,  \
      const float *so2, const float *bo2
#define XPK_WEIGHTS \
  {lq, sq, bq}, {lk, sk_, bk}, {lv, sv_, bv}, {lo, so, bo}, {li, si, bi}, \
      {lo2, so2, bo2}

extern "C" int launch_fused_decode_layer(
    const float* s, const uint8_t* sk, const uint8_t* sv, const int* pos,
    const int* rs, const int* ra, XPK_WEIGHT_PARAMS, float* s_out,
    uint8_t* k_new, uint8_t* v_new, int* placement, int T, int B, int d, int H,
    int KV, int hd, int L, int dff, int with_tail, int with_mlp, int cluster,
    int threads, float beta, float vth, long long smem, void* stream) {
  const Args a{s, pos, rs, ra, XPK_WEIGHTS, s_out, k_new, v_new, placement, T,
               B, d, H, KV, hd, L, dff, with_tail, with_mlp, beta, vth};
  return launch(a, DenseCache{sk, sv, T, L, KV, hd}, cluster, threads, smem,
                stream);
}

extern "C" int launch_fused_decode_layer_paged(
    const float* s, const uint8_t* kpool, const uint8_t* vpool,
    const int* table, const long long* write_pids, const int* pos,
    const int* rs, const int* ra, XPK_WEIGHT_PARAMS, float* s_out,
    uint8_t* k_new, uint8_t* v_new, int* placement, int T, int B, int d, int H,
    int KV, int hd, int page_len, int MP, int dff, int with_tail, int with_mlp,
    int cluster, int threads, float beta, float vth, long long smem,
    void* stream) {
  const Args a{s, pos, rs, ra, XPK_WEIGHTS, s_out, k_new, v_new, placement, T,
               B, d, H, KV, hd, MP * page_len, dff, with_tail, with_mlp, beta,
               vth};
  return launch(a,
                PagedCache{kpool, vpool, table, write_pids, T, KV, hd,
                           page_len, MP},
                cluster, threads, smem, stream);
}
