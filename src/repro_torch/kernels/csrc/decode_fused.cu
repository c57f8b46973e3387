// K3 and K9: one whole spiking decoder layer step per launch, over a dense
// slot cache (K3) or a block-paged pool (K9).
//
// K3 replaces the TPU kernel repro/kernels/decode_fused.py:fused_decode_layer
// (pallas_call at :283, body _fused_dense_body at :162); K9 replaces
// fused_decode_layer_paged (pallas_call at :491, body _fused_paged_body at
// :300).  One kernel body serves both: it is a template over the cache
// layout, which only changes where cached row j of a (slot, t, KV head) lives.
//
// Per slot b: Q/K/V crossbar + LIF on the residual spike stream, one SSA
// query row per (t, head) over the slot's *pre-scatter* cache plus the new
// token added on top (its score draw rsp; 2**30 where the write is masked),
// attention-out + residual, then the FFN tail (crossbar + LIF twice) +
// residual.  The caller scatters k_new / v_new into the cache afterwards.
//
// s f32 [T, B, d] (integer-valued), rs int32 [B, T, H, L], ra int32
// [B, T, H, hd], rsp int32 [B, T, H], six (int8 levels [din, dout], f32
// scale, f32 bias) triples -> s_out f32 [T, B, d] (or the attention train
// [T, B, H*hd] when !with_tail), k_new/v_new uint8 [T, B, KV, hd].
// Dense (K3): sk/sv uint8 [B, T, L, KV, hd].  Paged (K9): kpool/vpool uint8
// [P, T, KV, page_len, hd] and table int32 [B, MP], L = MP * page_len:
// logical row j of slot b is in-page row j % page_len of page
// table[b, j / page_len], read straight from the pool (the null page, 0, is
// skipped: it is zero by contract).  The wrapper masks the new token's draw
// wherever its write page is not the page the table shows at pos.
//
// Bound on the card: bytes.  A layer step must read the int8 weights once
// (about 0.8 MB at d = 256) and the cached rows (2 B T L KV hd bytes at most,
// 4.2 MB at B = 8, L = 256); the integer work is small beside that.  Design:
// the TPU kernel is one gridless program over the whole batch (the paged one
// a (slot, page) grid); here one thread block runs one slot, so nothing is
// shared between blocks and no reduction crosses them.  The block keeps the
// residual stream as int32 and every spike train (q, k_new, v_new,
// attention, FFN hidden) as bytes in shared memory; spike counts live in
// registers, and nothing non-binary reaches device memory except the
// residual output.  The attention row (common.cuh) packs q into uint32 lanes,
// popcounts each cached row against it (one row per lane), a warp ballot
// packs the score spikes along the cache axis, and the output stage reads the
// value rows whose score spiked.  GQA reads KV head h / (H / KV).  Any T
// (the linears count XPK_MAX_T steps at a time and carry the membrane) and
// any hd (the packed query and new key sit in dynamic shared memory): the
// limit is the shared memory of smem_layout, which grows with T and the
// widths and which the wrapper checks against the card's 227 KB.  At B = 8
// this occupies 8 of the 132 SMs: a later design splits a slot's heads and
// cache across blocks.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Smem {
  int* xs;        // [T][d]      residual stream, integer-valued
  uint8_t* qs;    // [T][H*hd]   query spikes
  uint8_t* ks;    // [T][KV*hd]  new key spikes
  uint8_t* vs;    // [T][KV*hd]  new value spikes
  uint8_t* as;    // [T][H*hd]   attention spikes
  uint8_t* hs;    // [T][dff]    FFN hidden spikes
  uint8_t* os;    // [T][d]      linear output spikes added to the residual
  uint32_t* sbits;  // [ceil(L/32)] packed score spikes of one (t, head)
  uint32_t* qw;     // [ceil(hd/32)] the packed query of one (t, head)
  uint32_t* knw;    // [ceil(hd/32)] the packed new key of its KV head
};

// Byte offsets of the segments (each 16-aligned); returns the total size.
// The wrapper (kernels/decode_fused.py:layer_smem_bytes) computes it too,
// refuses past the card's per-block budget and passes its number, which the
// launcher refuses unless it is this total.
constexpr int kSegments = 10;
__host__ __device__ inline size_t smem_layout(int T, int d, int H, int KV,
                                              int hd, int L, int dff,
                                              size_t off[kSegments]) {
  const size_t wd = (static_cast<size_t>(hd) + 31) / 32;
  const size_t sizes[kSegments] = {
      sizeof(int) * T * d,
      static_cast<size_t>(T) * H * hd,
      static_cast<size_t>(T) * KV * hd,
      static_cast<size_t>(T) * KV * hd,
      static_cast<size_t>(T) * H * hd,
      static_cast<size_t>(T) * (dff > 0 ? dff : 1),
      static_cast<size_t>(T) * d,
      sizeof(uint32_t) * ((L + 31) / 32),
      sizeof(uint32_t) * wd,
      sizeof(uint32_t) * wd};
  size_t total = 0;
  for (int i = 0; i < kSegments; ++i) {
    off[i] = total;
    total = xpk_align16(total + sizes[i]);
  }
  return total;
}

struct Weights {
  const int8_t* lv;
  const float* sc;
  const float* bi;
};

struct Args {
  const float* s;
  const int* rs;
  const int* ra;
  const int* rsp;
  Weights wq, wk, wv, wo, wi, wo2;
  float* s_out;
  uint8_t* k_new;
  uint8_t* v_new;
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
};

// The page pool [P, T, KV, page_len, hd] behind table [B, MP] (K9).
struct PagedCache {
  const uint8_t* k;
  const uint8_t* v;
  const int* table;
  int T, KV, hd, page_len, MP;
  __device__ XpkPagedRows rows(int b, int t, int kvh) const {
    const size_t base = (static_cast<size_t>(t) * KV + kvh) * page_len * hd;
    return {k + base, v + base, table + static_cast<size_t>(b) * MP,
            static_cast<size_t>(T) * KV * page_len * hd, page_len, hd};
  }
};

template <class Cache>
__global__ void __launch_bounds__(kThreads)
fused_decode_layer_kernel(const Args a, const Cache cache) {
  extern __shared__ __align__(16) char smem_raw[];
  __shared__ int s_new;
  size_t off[kSegments];
  smem_layout(a.T, a.d, a.H, a.KV, a.hd, a.L, a.dff, off);
  const Smem sm{reinterpret_cast<int*>(smem_raw + off[0]),
                reinterpret_cast<uint8_t*>(smem_raw + off[1]),
                reinterpret_cast<uint8_t*>(smem_raw + off[2]),
                reinterpret_cast<uint8_t*>(smem_raw + off[3]),
                reinterpret_cast<uint8_t*>(smem_raw + off[4]),
                reinterpret_cast<uint8_t*>(smem_raw + off[5]),
                reinterpret_cast<uint8_t*>(smem_raw + off[6]),
                reinterpret_cast<uint32_t*>(smem_raw + off[7]),
                reinterpret_cast<uint32_t*>(smem_raw + off[8]),
                reinterpret_cast<uint32_t*>(smem_raw + off[9])};
  uint32_t* qw = sm.qw;
  uint32_t* knw = sm.knw;
  const int b = blockIdx.x;
  const int T = a.T, d = a.d, H = a.H, KV = a.KV, hd = a.hd, L = a.L;
  const int tid = threadIdx.x;
  const int rep = H / KV, wd = (hd + 31) / 32;

  // residual stream in
  for (int idx = tid; idx < T * d; idx += kThreads) {
    const int t = idx / d, i = idx - t * d;
    sm.xs[idx] = __float2int_rn(a.s[(static_cast<size_t>(t) * a.B + b) * d + i]);
  }
  __syncthreads();

  // Q/K/V projections
  xpk_lin_lif(sm.xs, d, a.wq.lv, a.wq.sc, a.wq.bi, H * hd, T, a.beta, a.vth, sm.qs, H * hd);
  xpk_lin_lif(sm.xs, d, a.wk.lv, a.wk.sc, a.wk.bi, KV * hd, T, a.beta, a.vth, sm.ks, KV * hd);
  xpk_lin_lif(sm.xs, d, a.wv.lv, a.wv.sc, a.wv.bi, KV * hd, T, a.beta, a.vth, sm.vs, KV * hd);
  __syncthreads();
  for (int idx = tid; idx < T * KV * hd; idx += kThreads) {
    const int t = idx / (KV * hd), c = idx - t * KV * hd;
    const size_t o = (static_cast<size_t>(t) * a.B + b) * KV * hd + c;
    a.k_new[o] = sm.ks[idx];
    a.v_new[o] = sm.vs[idx];
  }

  // one SSA query row per (t, head)
  for (int th = 0; th < T * H; ++th) {
    const int t = th / H, h = th - t * H, kvh = h / rep;
    const size_t bth = (static_cast<size_t>(b) * T + t) * H + h;
    for (int w = tid; w < wd; w += kThreads) {
      qw[w] = xpk_pack32(sm.qs + (t * H + h) * hd + 32 * w, hd - 32 * w);
      knw[w] = xpk_pack32(sm.ks + (t * KV + kvh) * hd + 32 * w, hd - 32 * w);
    }
    __syncthreads();
    const auto rows = cache.rows(b, t, kvh);
    xpk_ssa_scores(rows, qw, hd, L, a.rs + bth * L, sm.sbits);
    if (tid == 0) {
      int cnt = 0;
      for (int w = 0; w < wd; ++w) cnt += __popc(qw[w] & knw[w]);
      s_new = cnt > a.rsp[bth] ? 1 : 0;
    }
    __syncthreads();
    for (int dd = tid; dd < hd; dd += kThreads) {
      const int cnt = xpk_ssa_count(rows, sm.sbits, L, dd) +
                      s_new * sm.vs[(t * KV + kvh) * hd + dd];
      sm.as[(t * H + h) * hd + dd] = cnt > a.ra[bth * hd + dd] ? 1 : 0;
    }
    __syncthreads();
  }

  if (!a.with_tail) {
    for (int idx = tid; idx < T * H * hd; idx += kThreads) {
      const int t = idx / (H * hd), c = idx - t * H * hd;
      a.s_out[(static_cast<size_t>(t) * a.B + b) * H * hd + c] = sm.as[idx];
    }
    return;
  }

  // attention-out + residual
  xpk_lin_lif(sm.as, H * hd, a.wo.lv, a.wo.sc, a.wo.bi, d, T, a.beta, a.vth, sm.os, d);
  __syncthreads();
  for (int idx = tid; idx < T * d; idx += kThreads) sm.xs[idx] += sm.os[idx];
  __syncthreads();
  if (a.with_mlp) {
    xpk_lin_lif(sm.xs, d, a.wi.lv, a.wi.sc, a.wi.bi, a.dff, T, a.beta, a.vth, sm.hs, a.dff);
    __syncthreads();
    xpk_lin_lif(sm.hs, a.dff, a.wo2.lv, a.wo2.sc, a.wo2.bi, d, T, a.beta, a.vth, sm.os, d);
    __syncthreads();
    for (int idx = tid; idx < T * d; idx += kThreads) sm.xs[idx] += sm.os[idx];
    __syncthreads();
  }
  for (int idx = tid; idx < T * d; idx += kThreads) {
    const int t = idx / d, i = idx - t * d;
    a.s_out[(static_cast<size_t>(t) * a.B + b) * d + i] = static_cast<float>(sm.xs[idx]);
  }
}

template <class Cache>
int launch(const Args& a, const Cache& cache, long long planned,
           void* stream) {
  size_t off[kSegments];
  const size_t smem = smem_layout(a.T, a.d, a.H, a.KV, a.hd, a.L, a.dff, off);
  if (planned < 0 || static_cast<size_t>(planned) != smem)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = xpk_set_smem(
      reinterpret_cast<const void*>(fused_decode_layer_kernel<Cache>), smem);
  if (err) return err;
  fused_decode_layer_kernel<Cache><<<a.B, kThreads, smem,
                                     static_cast<cudaStream_t>(stream)>>>(a, cache);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Weight pointers come as six (levels, scale, bias) triples; a triple the
// step does not use (no tail, no MLP) is three nulls.
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
    const float* s, const uint8_t* sk, const uint8_t* sv, const int* rs,
    const int* ra, const int* rsp, XPK_WEIGHT_PARAMS, float* s_out,
    uint8_t* k_new, uint8_t* v_new, int T, int B, int d, int H, int KV, int hd,
    int L, int dff, int with_tail, int with_mlp, float beta, float vth,
    long long smem, void* stream) {
  const Args a{s, rs, ra, rsp, XPK_WEIGHTS, s_out, k_new, v_new, T, B, d, H,
               KV, hd, L, dff, with_tail, with_mlp, beta, vth};
  return launch(a, DenseCache{sk, sv, T, L, KV, hd}, smem, stream);
}

extern "C" int launch_fused_decode_layer_paged(
    const float* s, const uint8_t* kpool, const uint8_t* vpool,
    const int* table, const int* rs, const int* ra, const int* rsp,
    XPK_WEIGHT_PARAMS, float* s_out, uint8_t* k_new, uint8_t* v_new, int T,
    int B, int d, int H, int KV, int hd, int page_len, int MP, int dff,
    int with_tail, int with_mlp, float beta, float vth, long long smem,
    void* stream) {
  const Args a{s, rs, ra, rsp, XPK_WEIGHTS, s_out, k_new, v_new, T, B, d, H,
               KV, hd, MP * page_len, dff, with_tail, with_mlp, beta, vth};
  return launch(a, PagedCache{kpool, vpool, table, T, KV, hd, page_len, MP},
                smem, stream);
}
