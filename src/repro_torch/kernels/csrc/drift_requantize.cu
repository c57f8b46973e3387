// K6: the drift fold of programmed PCM state onto the int8 execution image.
//
// Replaces the TPU kernel repro/kernels/aimc_matmul.py:drift_requantize_kernel
// (pallas_call at :172, body _requant_kernel at :137), which
// repro/aimc_device.py:_requantize evaluates on the JAX hot path.
//
// levels, eps, nu f32 [L, n] (L leading matrices of n = d_in * d_out
// elements each), t f32 [L] device times, gain f32 [L] image gains
// -> out int8 [L, n]:
//   t' = max(t, t0); r = t' / t0; df = expf(-nu * logf(r));
//   g = ((levels + eps) * df) * gain; out = clamp(rint(g), -127, 127),
// one correctly rounded f32 operation at a time, in the reference's order
// (the library is built with -fmad=false and the _rn intrinsics are never
// contracted).  expf and logf are the CUDA math library's, the functions
// PyTorch's torch.exp and torch.log call on the card, so the kernel equals
// its plain version (kernels/ref.py:drift_requantize_ref) bit for bit.
//
// Bound on the card: bytes.  Three f32 reads and one int8 write an element
// (13 bytes) for about 30 float operations (expf and logf included), far
// below the card's rate of operations per byte.  Design: one launch per
// programmed leaf; a stacked leaf of the LM stack is L matrices, whose time
// and gain the kernel reads per element from two small device tensors, so
// folding every layer of a stack needs no host synchronisation.  Threads
// stride over the flat elements, neighbouring threads on neighbouring
// 4-byte words, so every load is coalesced.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;  // 16 blocks per SM

__global__ void __launch_bounds__(kThreads)
drift_requantize_kernel(const float* __restrict__ levels,
                        const float* __restrict__ eps,
                        const float* __restrict__ nu,
                        const float* __restrict__ t_sec,
                        const float* __restrict__ gain,
                        int8_t* __restrict__ out, long long n, long long total,
                        float t0) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += stride) {
    const long long m = i / n;
    const float t = fmaxf(__ldg(t_sec + m), t0);
    const float r = __fdiv_rn(t, t0);
    const float df = expf(__fmul_rn(-__ldg(nu + i), logf(r)));
    const float g = __fmul_rn(__fmul_rn(__fadd_rn(__ldg(levels + i),
                                                  __ldg(eps + i)), df),
                              __ldg(gain + m));
    const float q = fminf(fmaxf(rintf(g), -127.f), 127.f);
    out[i] = static_cast<int8_t>(q);
  }
}

}  // namespace

extern "C" int launch_drift_requantize(const float* levels, const float* eps,
                                       const float* nu, const float* t_sec,
                                       const float* gain, int8_t* out,
                                       long long n, long long n_mat, float t0,
                                       void* stream) {
  const long long total = n * n_mat;
  if (total <= 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  drift_requantize_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      levels, eps, nu, t_sec, gain, out, n, total, t0);
  return static_cast<int>(cudaGetLastError());
}
