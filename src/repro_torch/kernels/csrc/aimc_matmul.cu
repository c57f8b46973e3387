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
// [T, M, dout], each count exact (|count| <= din * 127 * max spike < 2**24 at
// the port's widths, so the f32 store and any order of the cross-rank sum
// are exact).
//
// Bound on the card: bytes.  The weights (din * dout int8) are the only large
// operand; at the serving shapes (M = 1 prefill row, din, dout <= 1024) the
// work is a few hundred thousand integer MACs, far below what one SM does in
// the time it takes to stream the weights, and a launch moves well under a
// megabyte.  Design: one block per (row m, 128 output columns); the row's T
// spike vectors sit in shared memory as int32 (every thread reads the same
// element: a broadcast), each thread owns one column, streams its weight
// column with coalesced loads across the warp, keeps T int32 counts in
// registers; K1 runs the T-step membrane in registers -- the pre-activations
// never reach device memory, as on the crossbar -- and K5 stores the counts.
// Counts are exact, so the order of accumulation is free; K1's epilogue is
// the rounded scale, bias and membrane of common.cuh.  Rows beyond gridDim.y
// (at most 65,535) are taken by a grid-stride loop, so any M launches (a ViT
// batch of 1,024 images x 64 patches is M = 65,536); a block then re-reads
// its weight columns, from L2, for every row it takes.
#include "common.cuh"

namespace {

constexpr int kCols = 128;
constexpr int kMaxGridY = 65535;  // the hardware's limit on gridDim.y

// kCounts = false: K1 (LIF epilogue into out8); true: K5 (counts into outf).
template <bool kCounts>
__global__ void crossbar_kernel(const float* __restrict__ spikes,
                                const int8_t* __restrict__ levels,
                                const float* __restrict__ scale,
                                const float* __restrict__ bias,
                                uint8_t* __restrict__ out8,
                                float* __restrict__ outf, int T, int M,
                                int din, int dout, float beta, float vth) {
  extern __shared__ int xs[];  // [T][din]
  const int o = blockIdx.x * kCols + threadIdx.x;
  for (int m = blockIdx.y; m < M; m += gridDim.y) {
    __syncthreads();  // the previous row's reads of xs are done
    for (int idx = threadIdx.x; idx < T * din; idx += blockDim.x) {
      const int t = idx / din, i = idx - t * din;
      xs[idx] = __float2int_rn(spikes[(static_cast<size_t>(t) * M + m) * din + i]);
    }
    __syncthreads();
    if (o >= dout) continue;
    int acc[XPK_MAX_T];
#pragma unroll
    for (int t = 0; t < XPK_MAX_T; ++t) acc[t] = 0;
    for (int i = 0; i < din; ++i) {
      const int w = levels[static_cast<size_t>(i) * dout + o];
#pragma unroll
      for (int t = 0; t < XPK_MAX_T; ++t)
        if (t < T) acc[t] += xs[t * din + i] * w;
    }
    const size_t at = static_cast<size_t>(m) * dout + o;
    const size_t stride = static_cast<size_t>(M) * dout;
    if constexpr (kCounts) {
#pragma unroll
      for (int t = 0; t < XPK_MAX_T; ++t)
        if (t < T) outf[at + t * stride] = static_cast<float>(acc[t]);
    } else {
      xpk_lif_epilogue(acc, T, scale[o], bias[o], beta, vth, out8 + at,
                       stride);
    }
  }
}

template <bool kCounts>
int launch_crossbar(const float* spikes, const int8_t* levels,
                    const float* scale, const float* bias, uint8_t* out8,
                    float* outf, int T, int M, int din, int dout, float beta,
                    float vth, void* stream) {
  const size_t smem = static_cast<size_t>(T) * din * sizeof(int);
  int err = xpk_set_smem(reinterpret_cast<const void*>(crossbar_kernel<kCounts>), smem);
  if (err) return err;
  dim3 grid((dout + kCols - 1) / kCols, M < kMaxGridY ? M : kMaxGridY);
  crossbar_kernel<kCounts><<<grid, kCols, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      spikes, levels, scale, bias, out8, outf, T, M, din, dout, beta, vth);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int launch_aimc_spiking_linear(const float* spikes,
                                          const int8_t* levels,
                                          const float* scale,
                                          const float* bias, uint8_t* out,
                                          int T, int M, int din, int dout,
                                          float beta, float vth,
                                          void* stream) {
  return launch_crossbar<false>(spikes, levels, scale, bias, out, nullptr, T,
                                M, din, dout, beta, vth, stream);
}

extern "C" int launch_aimc_matmul_counts(const float* spikes,
                                         const int8_t* levels, float* out,
                                         int T, int M, int din, int dout,
                                         void* stream) {
  return launch_crossbar<true>(spikes, levels, nullptr, nullptr, nullptr, out,
                               T, M, din, dout, 0.f, 0.f, stream);
}
