// K4: the LIF neuron over the spike-time axis.
//
// Replaces the TPU kernel repro/kernels/lif.py:lif_kernel (pallas_call at :54,
// body _lif_kernel at :24).
//
// currents f32 [T, M] -> out uint8 [T, M]: per column m, over t = 0 .. T-1,
//   v = round(round(beta * v) + i_t); spike = v >= v_thresh; v = v * (1 - spike),
// one f32 rounding per operation as the reference's scan commits them (the
// library is built with -fmad=false and the step uses the _rn intrinsics, so
// nothing contracts into an FMA).
//
// Bound on the card: bytes.  Each current is read once and each spike written
// once (5 bytes per element) for three float operations, far below the card's
// rate of operations per byte.  Design: one thread per column m; the membrane
// stays in a register over T, so the membrane sequence never reaches device
// memory (the TPU kernel kept it in VMEM for the same reason).  A warp reads
// 32 consecutive columns of one timestep (128 bytes) and writes 32
// consecutive spikes: every access is coalesced.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lif_kernel(const float* __restrict__ cur, uint8_t* __restrict__ out, int T,
           long long M, float beta, float vth) {
  const long long m = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (m >= M) return;
  float v = 0.f;
  for (int t = 0; t < T; ++t) {
    const size_t i = static_cast<size_t>(t) * M + m;
    out[i] = xpk_lif_step(v, __ldg(cur + i), beta, vth);
  }
}

}  // namespace

extern "C" int launch_lif(const float* cur, uint8_t* out, int T, long long M,
                          float beta, float vth, void* stream) {
  const long long blocks = (M + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  lif_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(cur, out, T, M, beta, vth);
  return static_cast<int>(cudaGetLastError());
}
