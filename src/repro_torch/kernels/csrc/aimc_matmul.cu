// K1: the AIMC spiking linear -- crossbar MVM per timestep, then LIF over T.
// K5: the crossbar counts alone -- the same MVM, written out as f32 counts.
//
// K1 replaces the TPU kernel repro/kernels/aimc_matmul.py:aimc_spiking_linear_kernel
// (pallas_call at :205, body _kernel at :36); K5 replaces
// aimc_matmul_counts_kernel (pallas_call at :123, body _counts_kernel), the
// shard-local half of a row-parallel spiking linear on the (data, model)
// mesh: each rank counts over its input rows, the counts are summed over the
// model group, then scale, bias and LIF fire once on the sum.
//
// spikes f32 [T, M, din] (integer-valued), levels int8 [din, dout]; K1 also
// takes scale and bias f32 [dout] -> out uint8 [T, M, dout]; K5 -> out f32
// [T, M, dout].  Any T, M, din and dout.
//
// The spike operand is int8.  Spikes arrive as integer-valued f32: 0/1
// trains, or the residual stream, whose values are at most 1 + 2 * depth
// (17 at depth 8).  Every load converts with __float2int_rn and packs four
// values a word with __byte_perm; a value outside [-128, 127] is never
// clamped: the kernel traps (__trap), which poisons the CUDA context, so a
// caller that breaks the bound fails loudly.  A count is then a sum of
// int8 x int8 products in int32, exact in any order; |count| <= din * 127 *
// 17 < 2**24 for din <= 7,770 at the residual's bound, so K5's f32 store
// and any order of the cross-rank sum are exact too.
//
// Two regimes; the wrapper picks one from the shape
// (kernels/aimc_matmul.py:launch_plan) and passes its plan.
//
// Many rows (T * M >= 64: the paper forwards, M = 2,368 and 4,096).  Bound:
// bytes -- the f32 spikes (25.2 of 31.6 MB at M = 4,096, 384 -> 384).  An
// int8 GEMM on the tensor cores (mma.sync m16n8k32 s8 x s8 -> s32).  A CTA
// tile is 64 GEMM rows x 128 columns; its rows are (m, t) pairs -- Mt = 64 /
// T rows of M with all T steps each (T > 64: 64 steps at a time, Mt = 1,
// the membrane carried) -- so the counts of one (m, o) over T lie in the
// tile: they are staged through shared memory and one thread runs the
// membrane of each (m, o) over T (K5 stores them).  Both operands land by
// cp.async, 16 bytes a thread, three k-tiles (64 of d_in) in flight: the
// spike rows coalesced (16 threads a 256-byte row segment), the weight
// rows likewise; then the spikes are converted to int8 and, since levels
// [din, dout] are N-contiguous but the MMA needs B K-contiguous, the weight
// tile is transposed in shared memory, 4 x 4 bytes at a time with
// __byte_perm, into words of 4 consecutive k (conflict-free fragment
// loads).  A CTA takes one column tile and reads each weight tile once; the
// ceil(dout / 128) CTAs that read one row tile sit next to each other in the
// grid, so its re-reads (3 at dout = 384, 12 at 1,536) come from L2.
// The k-loop measures latency-bound by each warp's chain of conversion,
// transposition and MMAs between two barriers, not by memory: loading one
// or three k-tiles ahead, or keeping a CTA's rows resident in shared memory
// while it walks every column tile, measured no faster (see PERF.md).
// Rows past gridDim.y (65,535 row tiles) are taken by a grid-stride loop.
//
// Few rows (T * M < 64: a prefill row, a decode step's slots).  Bound:
// bytes -- the weights (32 to 256 KB at the serving shapes); the MACs are
// few.  din is split across the warps of a block and across blocks, so that
// about 64 blocks stream the weights: each thread takes CPT consecutive
// output columns (one vector load of a weight row: 16 bytes at CPT = 16)
// over `chain` rows, keeping T * M x CPT int32 counts in registers.  Lanes
// of a warp that share columns reduce by shuffles, the warps of a block by
// shared-memory atomics, and the blocks along din by int32 atomicAdd on a
// scratch [T * M, dout] (integer sums: exact in any order; never float
// atomics).  The last block of a column range to arrive (a __threadfence
// and an arrival counter) reads the sums, zeroes the scratch and its counter
// again (so the wrapper's scratch stays zero from one launch to the next)
// and runs the epilogue; the kernel allocates nothing.
//
// K1's epilogue is xpk_lif_epilogue (common.cuh): the rounded * scale, the
// rounded + bias, then one membrane rounding a step, built with -fmad=false.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;  // the hardware's limit on gridDim.y

// An integer-valued spike as int8, or a trap.
__device__ __forceinline__ uint32_t xpk_s8(float f) {
  const int v = __float2int_rn(f);
  if (v < -128 || v > 127) __trap();
  return static_cast<uint32_t>(v);
}

__device__ __forceinline__ uint32_t xpk_pack_s8x4(float4 f) {
  const uint32_t lo = __byte_perm(xpk_s8(f.x), xpk_s8(f.y), 0x0040);
  const uint32_t hi = __byte_perm(xpk_s8(f.z), xpk_s8(f.w), 0x0040);
  return __byte_perm(lo, hi, 0x5410);  // bytes x, y, z, w
}

// ---------------------------------------------------------------------------
// Many rows: the int8 tensor-core GEMM
// ---------------------------------------------------------------------------

constexpr int kBM = 64;          // GEMM rows a tile: Mt rows of M x Tc steps
constexpr int kBN = 128;         // output columns a tile
constexpr int kBK = 64;          // input rows (the GEMM's K) a k-tile
constexpr int kMaxTc = kBM;      // timesteps a tile takes at once
constexpr int kStages = 3;       // k-tiles in flight (cp.async groups)
constexpr int kAW = kBK / 4 + 4; // words a row of the int8 A tile (80 B)
constexpr int kBW = kBN + 8;     // words a k-quad row of the int8 B tile
constexpr int kCW = kBN + 8;     // int32 a row of the count tile

// A k-tile as loaded: the spike rows (f32) and the weight rows (int8).
struct MmaStage {
  float a[kBM * kBK];              // [row][k]
  int8_t b[kBK * kBN];             // [k][n]
};
// Dynamic shared memory of the GEMM (87,552 B: two CTAs an SM).
struct MmaSmem {
  union {
    MmaStage stage[kStages];
    int c[kBM * kCW];              // after the k-loop: the counts [row][n]
  } u;
  uint32_t a[kBM * kAW];           // spikes [row][k/4]: 4 int8 a word
  uint32_t b[(kBK / 4) * kBW];     // weights [k/4][n]: 4 consecutive k a word
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// k-tile [k0, k0 + 64) of this thread's 4 spike rows (tid / 16 + 16 i; null:
// a padding row) into st.a, zero past din: cp.async 16 bytes a thread (16
// threads a 256-byte row segment) when rows are 16-byte aligned, else plain
// loads.
__device__ __forceinline__ void load_a(MmaStage& st, const float* spikes,
                                       const float* const (&arow)[4], int din,
                                       int k0, bool vec) {
  const int kq = threadIdx.x & 15, k = k0 + 4 * kq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (threadIdx.x >> 4) + 16 * i;
    const float* p = arow[i];
    float* dst = st.a + r * kBK + 4 * kq;
    if (vec) {
      const bool ok = p && k < din;
      cp_async16(dst, ok ? p + k : spikes, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[j] = (p && k + j < din) ? p[k + j] : 0.f;
    }
  }
}

// Weight tile [k0, k0 + 64) x [n0, n0 + 128) into st.b, zero past the
// edges: cp.async 16 bytes a thread when rows are 16-byte aligned (a chunk
// is then all in or all out), else plain byte loads.
__device__ __forceinline__ void load_b(MmaStage& st, const int8_t* levels,
                                       int din, int dout, int k0, int n0,
                                       bool vec) {
  if (vec) {
    for (int idx = threadIdx.x; idx < kBK * kBN / 16; idx += kThreads) {
      const int kk = idx / (kBN / 16), nc = idx - kk * (kBN / 16);
      const int k = k0 + kk, n = n0 + 16 * nc;
      const bool ok = k < din && n < dout;
      cp_async16(st.b + kk * kBN + 16 * nc,
                 ok ? levels + static_cast<size_t>(k) * dout + n : levels, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < kBK * kBN; idx += kThreads) {
      const int kk = idx / kBN, k = k0 + kk, n = n0 + idx - kk * kBN;
      st.b[idx] = (k < din && n < dout)
                      ? levels[static_cast<size_t>(k) * dout + n] : int8_t(0);
    }
  }
}

// A k-tile as loaded -> the MMA's operands: the spikes to int8 (4 a word,
// a trap past [-128, 127]) and the weights transposed, raw [k][n] -> b
// [k/4][n]: a thread takes 4 x 4 bytes (4 rows of one 4-column word),
// transposes them with __byte_perm and stores the 4 column words with one
// 16-byte store.
__device__ __forceinline__ void stage_operands(MmaSmem& sm,
                                               const MmaStage& st) {
  const int kq = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (threadIdx.x >> 4) + 16 * i;
    sm.a[r * kAW + kq] = xpk_pack_s8x4(
        *reinterpret_cast<const float4*>(st.a + r * kBK + 4 * kq));
  }
  const uint32_t* rw = reinterpret_cast<const uint32_t*>(st.b);
  for (int idx = threadIdx.x; idx < (kBK / 4) * (kBN / 4); idx += kThreads) {
    const int q = idx / (kBN / 4), nq = idx - q * (kBN / 4);
    const uint32_t* r = rw + 4 * q * (kBN / 4) + nq;
    const uint32_t w0 = r[0], w1 = r[kBN / 4], w2 = r[2 * (kBN / 4)],
                   w3 = r[3 * (kBN / 4)];
    const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);
    const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);
    const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
    const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
    uint4 o;
    o.x = __byte_perm(lo01, lo23, 0x5410);
    o.y = __byte_perm(lo01, lo23, 0x7632);
    o.z = __byte_perm(hi01, hi23, 0x5410);
    o.w = __byte_perm(hi01, hi23, 0x7632);
    *reinterpret_cast<uint4*>(sm.b + q * kBW + 4 * nq) = o;
  }
}

// Rows (mi, t) of a tile -> spike rows (t0 + t) * M + m0 + mi; null for a
// padding row.
__device__ __forceinline__ const float* mma_row(const float* spikes, int r,
                                                int Tc, int Mt, int tn,
                                                int m0, int M, int t0,
                                                int din) {
  const int mi = r / Tc, t = r - mi * Tc;
  return (mi < Mt && m0 + mi < M && t < tn)
             ? spikes + (static_cast<size_t>(t0 + t) * M + m0 + mi) * din
             : nullptr;
}

template <bool kCounts>
__global__ void __launch_bounds__(kThreads, 2)
crossbar_mma_kernel(const float* __restrict__ spikes,
                    const int8_t* __restrict__ levels,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, uint8_t* __restrict__ out8,
                    float* __restrict__ outf, int T, int M, int din, int dout,
                    float beta, float vth) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  MmaSmem& sm = *reinterpret_cast<MmaSmem*>(mma_smem);
  __shared__ float vcarry[kBN];  // membranes between T chunks (Mt = 1)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 32 x 32
  const int Tc = T <= kMaxTc ? T : kMaxTc;
  const int Mt = T <= kMaxTc ? kBM / T : 1;
  const int n_rt = (M + Mt - 1) / Mt;
  const int n0 = blockIdx.x * kBN;
  const int nk = (din + kBK - 1) / kBK;
  const bool avec = din % 4 == 0 && (reinterpret_cast<uintptr_t>(spikes) & 15) == 0;
  const bool bvec = dout % 16 == 0 && (reinterpret_cast<uintptr_t>(levels) & 15) == 0;

  for (int rt = blockIdx.y; rt < n_rt; rt += gridDim.y) {
    const int m0 = rt * Mt;
    for (int t0 = 0; t0 < T; t0 += Tc) {
      const int tn = min(Tc, T - t0);
      const float* arow[4];  // this thread's rows of the A tile
#pragma unroll
      for (int i = 0; i < 4; ++i)
        arow[i] = mma_row(spikes, (tid >> 4) + 16 * i, Tc, Mt, tn, m0, M, t0,
                          din);
      int acc[2][4][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][b][c] = 0;

      // kStages - 1 k-tiles in flight ahead of the one in use; one cp.async
      // group a k-tile, empty past d_in
      for (int st = 0; st < kStages - 1; ++st) {
        if (st < nk) {
          load_a(sm.u.stage[st], spikes, arow, din, st * kBK, avec);
          load_b(sm.u.stage[st], levels, din, dout, st * kBK, n0, bvec);
        }
        cp_async_commit();
      }
      for (int kt = 0; kt < nk; ++kt) {
        const int next = kt + kStages - 1;
        if (next < nk) {
          MmaStage& st = sm.u.stage[next % kStages];
          load_a(st, spikes, arow, din, next * kBK, avec);
          load_b(st, levels, din, dout, next * kBK, n0, bvec);
        }
        cp_async_commit();
        cp_async_wait<kStages - 1>();
        __syncthreads();  // k-tile kt landed; MMA(kt-1) is done
        stage_operands(sm, sm.u.stage[kt % kStages]);
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < kBK / 32; ++ks) {
          uint32_t fa[2][4], fb[4][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const uint32_t* ar = sm.a + (wm * 32 + mt * 16 + g) * kAW + ks * 8 + tig;
            fa[mt][0] = ar[0];
            fa[mt][1] = ar[8 * kAW];
            fa[mt][2] = ar[4];
            fa[mt][3] = ar[8 * kAW + 4];
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const uint32_t* br = sm.b + (ks * 8 + tig) * kBW + wn * 32 + nt * 8 + g;
            fb[nt][0] = br[0];
            fb[nt][1] = br[4 * kBW];
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], fa[mt], fb[nt]);
        }
      }
      cp_async_wait<0>();  // the empty trailing groups
      __syncthreads();     // the stages are read (the counts alias them)

      // the tile's counts through shared memory
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          int* c = sm.u.c + (wm * 32 + mt * 16 + g) * kCW + wn * 32 + nt * 8 + 2 * tig;
          *reinterpret_cast<int2*>(c) = make_int2(acc[mt][nt][0], acc[mt][nt][1]);
          *reinterpret_cast<int2*>(c + 8 * kCW) =
              make_int2(acc[mt][nt][2], acc[mt][nt][3]);
        }
      __syncthreads();
      // one thread per (m, o): its counts over the chunk's steps
      for (int p = tid; p < Mt * kBN; p += kThreads) {
        const int mi = p / kBN, o = p - mi * kBN, m = m0 + mi, n = n0 + o;
        if (m >= M || n >= dout) continue;
        const int* cs = sm.u.c + mi * Tc * kCW + o;
        const size_t stride = static_cast<size_t>(M) * dout;
        const size_t at8 = (static_cast<size_t>(t0) * M + m) * dout + n;
        if constexpr (kCounts) {
          for (int t = 0; t < tn; ++t)
            outf[at8 + t * stride] = static_cast<float>(cs[t * kCW]);
        } else {
          float v = t0 == 0 ? 0.f : vcarry[o];
          const float sc = scale[n], bi = bias[n];
          for (int tt = 0; tt < tn; tt += XPK_MAX_T)
            xpk_lif_epilogue(cs + tt * kCW, kCW, min(XPK_MAX_T, tn - tt), sc,
                             bi, beta, vth, v, out8 + at8 + tt * stride,
                             stride);
          if (T > Tc) vcarry[o] = v;
        }
      }
      __syncthreads();  // the counts are read before the next tile's loads
    }
  }
}

// ---------------------------------------------------------------------------
// Few rows: din split across warps and blocks, int32 reductions
// ---------------------------------------------------------------------------

constexpr int kSplitAcc = 64;    // int32 counts a thread keeps: T*M x CPT
constexpr int kSplitXs = 8192;   // int32 spikes a block stages (32 KB)
constexpr int kSplitRed = 2048;  // int32 sums of a block's columns (8 KB)

// CPT consecutive int8 weights with one load (a CPT-byte vector).
template <int CPT>
__device__ __forceinline__ void load_w(const int8_t* p, int (&w)[CPT]) {
  uint32_t word[(CPT + 3) / 4];
  if constexpr (CPT == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    word[0] = v.x; word[1] = v.y; word[2] = v.z; word[3] = v.w;
  } else if constexpr (CPT == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    word[0] = v.x; word[1] = v.y;
  } else if constexpr (CPT == 4) {
    word[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (CPT == 2) {
    word[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    word[0] = static_cast<uint8_t>(__ldg(p));
  }
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    w[c] = static_cast<int8_t>(word[c / 4] >> (8 * (c % 4)));
}

template <bool kCounts, int CPT>
__global__ void __launch_bounds__(kThreads)
crossbar_split_kernel(const float* __restrict__ spikes,
                      const int8_t* __restrict__ levels,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      uint8_t* __restrict__ out8, float* __restrict__ outf,
                      int* __restrict__ scratch, int T, int M, int din,
                      int dout, float beta, float vth, int ncgb, int chain,
                      int ksplit) {
  __shared__ int xs[kSplitXs];   // the block's spike rows [row][T*M]
  __shared__ int red[kSplitRed];  // sums [T*M][columns of the block]
  __shared__ int last;
  constexpr int kTmMax = kSplitAcc / CPT;
  const int TM = T * M, tid = threadIdx.x;
  const int cols = ncgb * CPT, ncb = (dout + cols - 1) / cols;
  const int cb = blockIdx.x % ncb, ks = blockIdx.x / ncb;
  const int rs = kThreads / ncgb;  // row slots a block
  const int r0 = ks * rs * chain;
  const int nr = max(0, min(rs * chain, din - r0));
  const int cg = tid % ncgb, slot = tid / ncgb;
  const int nb = cb * cols, n = nb + cg * CPT;

  for (int idx = tid; idx < TM * nr; idx += kThreads) {
    const int tm = idx / nr, i = idx - tm * nr;
    xs[i * TM + tm] = static_cast<int>(static_cast<int8_t>(
        xpk_s8(spikes[static_cast<size_t>(tm) * din + r0 + i])));
  }
  for (int idx = tid; idx < TM * cols; idx += kThreads) red[idx] = 0;
  __syncthreads();

  int acc[kTmMax][CPT];
#pragma unroll
  for (int a = 0; a < kTmMax; ++a)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[a][c] = 0;
  if (n < dout) {
    for (int i = slot; i < nr; i += rs) {
      int w[CPT];
      load_w<CPT>(levels + static_cast<size_t>(r0 + i) * dout + n, w);
      const int* x = xs + i * TM;
#pragma unroll
      for (int a = 0; a < kTmMax; ++a)
        if (a < TM) {
          const int xv = x[a];
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[a][c] += xv * w[c];
        }
    }
  }
  // lanes that share columns (ncgb < 32) by shuffles, warps by shared atomics
#pragma unroll
  for (int a = 0; a < kTmMax; ++a)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      int s = acc[a][c];
      for (int off = 16; off >= ncgb; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      if ((tid & 31) < ncgb && a < TM && n < dout && s)
        atomicAdd(&red[a * cols + cg * CPT + c], s);
    }
  __syncthreads();

  if (ksplit > 1) {
    int* sums = scratch;                                  // [T*M][dout]
    int* arrived = scratch + static_cast<size_t>(TM) * dout;  // [ncb]
    for (int idx = tid; idx < TM * cols; idx += kThreads) {
      const int a = idx / cols, col = nb + idx - a * cols;
      if (col < dout && red[idx])
        atomicAdd(sums + static_cast<size_t>(a) * dout + col, red[idx]);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(arrived + cb, 1) == ksplit - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int idx = tid; idx < TM * cols; idx += kThreads) {
      const int a = idx / cols, col = nb + idx - a * cols;
      if (col < dout) {
        int* s = sums + static_cast<size_t>(a) * dout + col;
        red[idx] = __ldcg(s);
        *s = 0;
      }
    }
    if (tid == 0) arrived[cb] = 0;
    __syncthreads();
  }

  if constexpr (kCounts) {
    for (int idx = tid; idx < TM * cols; idx += kThreads) {
      const int a = idx / cols, col = nb + idx - a * cols;
      if (col < dout)
        outf[static_cast<size_t>(a) * dout + col] = static_cast<float>(red[idx]);
    }
  } else {
    const size_t stride = static_cast<size_t>(M) * dout;
    for (int idx = tid; idx < M * cols; idx += kThreads) {
      const int m = idx / cols, o = idx - m * cols, col = nb + o;
      if (col >= dout) continue;
      const int* cs = red + m * cols + o;  // row t * M + m of red
      const float sc = scale[col], bi = bias[col];
      float v = 0.f;
      for (int t0 = 0; t0 < T; t0 += XPK_MAX_T)
        xpk_lif_epilogue(cs + static_cast<size_t>(t0) * M * cols, M * cols,
                         min(XPK_MAX_T, T - t0), sc, bi, beta, vth, v,
                         out8 + (static_cast<size_t>(t0) * M + m) * dout + col,
                         stride);
    }
  }
}

// regime 0: the tensor-core GEMM (the grid follows from the shape; the plan
// is unused); regime 1: the din split, plan = (cpt, ncgb, chain, ksplit).
template <bool kCounts>
int launch_crossbar(const float* spikes, const int8_t* levels,
                    const float* scale, const float* bias, uint8_t* out8,
                    float* outf, int T, int M, int din, int dout, float beta,
                    float vth, int regime, int p0, int p1, int p2, int p3,
                    int* scratch, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (regime == 0) {
    const int Mt = T <= kMaxTc ? kBM / T : 1;
    const int n_rt = (M + Mt - 1) / Mt;
    const void* fn = reinterpret_cast<const void*>(crossbar_mma_kernel<kCounts>);
    int err = xpk_set_smem(fn, sizeof(MmaSmem));
    if (err) return err;
    const dim3 grid((dout + kBN - 1) / kBN, n_rt < kMaxGridY ? n_rt : kMaxGridY);
    crossbar_mma_kernel<kCounts><<<grid, kThreads, sizeof(MmaSmem), st>>>(
        spikes, levels, scale, bias, out8, outf, T, M, din, dout, beta, vth);
    return static_cast<int>(cudaGetLastError());
  }
  const int cpt = p0, ncgb = p1, chain = p2, ksplit = p3;
  // the split plan must respect the kernel's static buffers
  const int TM = T * M;
  const bool ok = (ncgb == 8 || ncgb == 16 || ncgb == 32) && chain >= 1 &&
                  ksplit >= 1 && TM * cpt <= kSplitAcc &&
                  TM * (kThreads / ncgb) * chain <= kSplitXs &&
                  static_cast<long long>(ksplit) * (kThreads / ncgb) * chain >= din &&
                  dout % cpt == 0 && (ksplit == 1 || scratch != nullptr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((dout + ncgb * cpt - 1) / (ncgb * cpt)) * ksplit;
#define XPK_SPLIT(C)                                                         \
  crossbar_split_kernel<kCounts, C><<<blocks, kThreads, 0, st>>>(            \
      spikes, levels, scale, bias, out8, outf, scratch, T, M, din, dout, beta, \
      vth, ncgb, chain, ksplit)
  switch (cpt) {
    case 16: XPK_SPLIT(16); break;
    case 8: XPK_SPLIT(8); break;
    case 4: XPK_SPLIT(4); break;
    case 2: XPK_SPLIT(2); break;
    case 1: XPK_SPLIT(1); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef XPK_SPLIT
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch plan of kernels/aimc_matmul.py:launch_plan: regime 0, the
// tensor-core GEMM (p0..p3 unused); regime 1, the din split with (cpt columns a thread, ncgb column groups a block, chain
// rows a thread, ksplit blocks along din), summed in scratch (int32, all
// zero on entry and on exit; unused when ksplit is 1).
extern "C" int launch_aimc_spiking_linear(
    const float* spikes, const int8_t* levels, const float* scale,
    const float* bias, uint8_t* out, int T, int M, int din, int dout,
    float beta, float vth, int regime, int p0, int p1, int p2, int p3,
    int* scratch, void* stream) {
  return launch_crossbar<false>(spikes, levels, scale, bias, out, nullptr, T,
                                M, din, dout, beta, vth, regime, p0, p1, p2,
                                p3, scratch, stream);
}

extern "C" int launch_aimc_matmul_counts(const float* spikes,
                                         const int8_t* levels, float* out,
                                         int T, int M, int din, int dout,
                                         int regime, int p0, int p1, int p2,
                                         int p3, int* scratch, void* stream) {
  return launch_crossbar<true>(spikes, levels, nullptr, nullptr, nullptr, out,
                               T, M, din, dout, 0.f, 0.f, regime, p0, p1, p2,
                               p3, scratch, stream);
}
