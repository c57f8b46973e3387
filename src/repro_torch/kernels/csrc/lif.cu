// K4: the LIF neuron over the spike-time axis, optionally behind the
// row-parallel linear's epilogue.
//
// Replaces the TPU kernel repro/kernels/lif.py:lif_kernel (pallas_call at :54,
// body _lif_kernel at :24).
//
// One body, two entries, each out uint8 [T, C] over C columns a timestep:
//  * currents: f32 [T, C] are the LIF's input as given;
//  * counts: integer-valued f32 counts [T, M, N] (C = M * N, the model
//    group's summed crossbar counts of a row-parallel linear), with scale
//    [N] and bias [N] or null, give the input
//      pre = round(round(count * scale[n]) + bias[n]),
//    the two separate roundings of the reference's counts * scale then + b
//    (repro/distributed/backend.py), so the epilogue after the all_reduce
//    is one launch where it was three.
// Per column, over t = 0 .. T-1:
//   v = round(round(beta * v) + i_t); spike = v >= v_thresh; v = v * (1 - spike),
// one f32 rounding per operation as the reference's scan commits them (the
// library is built with -fmad=false and the step uses the _rn intrinsics, so
// nothing contracts into an FMA).
//
// Bound on the card: bytes.  Each input is read once and each spike written
// once (5 bytes per element) for three to five float operations, far below
// the card's rate of operations per byte.  Design: a thread owns 4
// consecutive columns (one 16-byte load and one 4-byte store a timestep)
// where C, N and the pointers allow it, else one; the membranes stay in
// registers over T, so the membrane sequence never reaches device memory
// (the TPU kernel kept it in VMEM for the same reason), and a column's scale
// and bias are read once, into registers.  A warp reads 512 consecutive
// bytes of one timestep and writes 128: every access is coalesced.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Columns [c, c + W) of one thread; kCounts: the epilogue's prologue.
template <bool kCounts, int W>
__global__ void __launch_bounds__(kThreads)
lif_kernel(const float* __restrict__ in, const float* __restrict__ scale,
           const float* __restrict__ bias, uint8_t* __restrict__ out, int T,
           long long C, int N, float beta, float vth) {
  const long long c =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * W;
  if (c >= C) return;
  float sc[W], bi[W], v[W];  // scale and bias unused without kCounts
#pragma unroll
  for (int i = 0; i < W; ++i) {
    v[i] = 0.f;
    if constexpr (kCounts) {
      const int n = static_cast<int>((c + i) % N);
      sc[i] = __ldg(scale + n);
      bi[i] = bias ? __ldg(bias + n) : 0.f;
    }
  }
  for (int t = 0; t < T; ++t) {
    const size_t at = static_cast<size_t>(t) * C + c;
    float x[W];
    if constexpr (W == 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(in + at));
      x[0] = f.x;
      x[1] = f.y;
      x[2] = f.z;
      x[3] = f.w;
    } else {
      x[0] = __ldg(in + at);
    }
    uint8_t s[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      float pre = x[i];
      if constexpr (kCounts) {
        pre = __fmul_rn(pre, sc[i]);
        if (bias) pre = __fadd_rn(pre, bi[i]);
      }
      s[i] = xpk_lif_step(v[i], pre, beta, vth);
    }
    if constexpr (W == 4) {
      *reinterpret_cast<uchar4*>(out + at) = make_uchar4(s[0], s[1], s[2], s[3]);
    } else {
      out[at] = s[0];
    }
  }
}

template <bool kCounts>
int launch(const float* in, const float* scale, const float* bias,
           uint8_t* out, int T, long long C, int N, float beta, float vth,
           void* stream) {
  const bool vec = C % 4 == 0 && (!kCounts || N % 4 == 0) &&
                   reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const int w = vec ? 4 : 1;
  const long long blocks = (C / w + kThreads - 1) / kThreads;
  if (T < 0 || C <= 0 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec)
    lif_kernel<kCounts, 4><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        in, scale, bias, out, T, C, N, beta, vth);
  else
    lif_kernel<kCounts, 1><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        in, scale, bias, out, T, C, N, beta, vth);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// currents f32 [T, M] -> spikes uint8 [T, M]
extern "C" int launch_lif(const float* cur, uint8_t* out, int T, long long M,
                          float beta, float vth, void* stream) {
  return launch<false>(cur, nullptr, nullptr, out, T, M, 1, beta, vth, stream);
}

// counts f32 [T, M, N] (C = M * N columns a step), scale f32 [N], bias f32
// [N] or null -> uint8 [T, M, N]
extern "C" int launch_lif_counts(const float* counts, const float* scale,
                                 const float* bias, uint8_t* out, int T,
                                 long long C, int N, float beta, float vth,
                                 void* stream) {
  if (N <= 0 || C % N) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(counts, scale, bias, out, T, C, N, beta, vth, stream);
}
