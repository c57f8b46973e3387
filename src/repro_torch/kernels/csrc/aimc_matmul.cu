// K1: the AIMC spiking linear -- crossbar MVM per timestep, then LIF over T.
//
// Replaces the TPU kernel repro/kernels/aimc_matmul.py:aimc_spiking_linear_kernel
// (pallas_call at :205, body _kernel at :36).
//
// spikes f32 [T, M, din] (integer-valued), levels int8 [din, dout], scale and
// bias f32 [dout] -> out uint8 [T, M, dout].
//
// Bound on the card: bytes.  The weights (din * dout int8) are the only large
// operand; at the serving shapes (M = 1 prefill row, din, dout <= 1024) the
// work is a few hundred thousand integer MACs, far below what one SM does in
// the time it takes to stream the weights, and a launch moves well under a
// megabyte.  Design: one block per (row m, 128 output columns); the row's T
// spike vectors sit in shared memory as int32 (every thread reads the same
// element: a broadcast), each thread owns one column, streams its weight
// column with coalesced loads across the warp, keeps T int32 counts in
// registers, and runs the T-step membrane in registers -- the pre-activations
// never reach device memory, as on the crossbar.  Counts are exact, so the
// order of accumulation is free; the epilogue is the rounded scale, bias and
// membrane of common.cuh.
#include "common.cuh"

namespace {

constexpr int kCols = 128;

__global__ void aimc_spiking_linear_kernel(const float* __restrict__ spikes,
                                           const int8_t* __restrict__ levels,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias,
                                           uint8_t* __restrict__ out, int T,
                                           int M, int din, int dout,
                                           float beta, float vth) {
  extern __shared__ int xs[];  // [T][din]
  const int m = blockIdx.y;
  for (int idx = threadIdx.x; idx < T * din; idx += blockDim.x) {
    const int t = idx / din, i = idx - t * din;
    xs[idx] = __float2int_rn(spikes[(static_cast<size_t>(t) * M + m) * din + i]);
  }
  __syncthreads();
  const int o = blockIdx.x * kCols + threadIdx.x;
  if (o >= dout) return;
  int acc[XPK_MAX_T];
#pragma unroll
  for (int t = 0; t < XPK_MAX_T; ++t) acc[t] = 0;
  for (int i = 0; i < din; ++i) {
    const int w = levels[static_cast<size_t>(i) * dout + o];
#pragma unroll
    for (int t = 0; t < XPK_MAX_T; ++t)
      if (t < T) acc[t] += xs[t * din + i] * w;
  }
  xpk_lif_epilogue(acc, T, scale[o], bias[o], beta, vth,
                   out + static_cast<size_t>(m) * dout + o, M * dout);
}

}  // namespace

extern "C" int launch_aimc_spiking_linear(const float* spikes,
                                          const int8_t* levels,
                                          const float* scale,
                                          const float* bias, uint8_t* out,
                                          int T, int M, int din, int dout,
                                          float beta, float vth,
                                          void* stream) {
  const size_t smem = static_cast<size_t>(T) * din * sizeof(int);
  int err = xpk_set_smem(reinterpret_cast<const void*>(aimc_spiking_linear_kernel), smem);
  if (err) return err;
  dim3 grid((dout + kCols - 1) / kCols, M);
  aimc_spiking_linear_kernel<<<grid, kCols, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      spikes, levels, scale, bias, out, T, M, din, dout, beta, vth);
  return static_cast<int>(cudaGetLastError());
}
