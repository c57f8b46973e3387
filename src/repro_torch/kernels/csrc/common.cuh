// Shared device helpers of the Hopper spiking kernels.
//
// Bit-exactness: every spike count is an exact integer (int32 here), and the
// float epilogue follows the reference's rounding discipline
// (repro/kernels/ref.py, "Float-rounding discipline"): counts * scale and
// + bias are two separate round-to-nearest f32 operations, and the LIF
// membrane beta * v + pre commits one rounding per step.  The _rn
// intrinsics are never contracted into an FMA; the library is also built
// with -fmad=false.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define XPK_MAX_T 8     // spike timesteps a thread keeps in registers
#define XPK_MAX_WD 16   // uint32 lanes of one packed head row (hd <= 512)

// Pack the lowest bit of n <= 32 consecutive spike bytes into one word (bit i
// is byte i); bytes past n read as zero, which is the 32-lane padding.
__device__ __forceinline__ uint32_t xpk_nibble(uint32_t u) {
  // bytes b0..b3 in {0,1} at bits 0,8,16,24 -> b0 | b1<<1 | b2<<2 | b3<<3
  return ((u & 0x01010101u) * 0x10204080u) >> 28;
}

__device__ __forceinline__ uint32_t xpk_pack32(const uint8_t* p, int n) {
  if (n >= 32 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4 a = reinterpret_cast<const uint4*>(p)[0];
    const uint4 c = reinterpret_cast<const uint4*>(p)[1];
    return xpk_nibble(a.x) | xpk_nibble(a.y) << 4 | xpk_nibble(a.z) << 8 |
           xpk_nibble(a.w) << 12 | xpk_nibble(c.x) << 16 |
           xpk_nibble(c.y) << 20 | xpk_nibble(c.z) << 24 |
           xpk_nibble(c.w) << 28;
  }
  uint32_t w = 0;
  const int m = n < 32 ? n : 32;
  for (int i = 0; i < m; ++i) w |= static_cast<uint32_t>(p[i] & 1u) << i;
  return w;
}

// One LIF step per timestep over exact integer counts:
//   pre = round(round(count * scale) + bias); v = round(beta * v + pre);
//   spike = v >= v_thresh; v = v * (1 - spike).
__device__ __forceinline__ void xpk_lif_epilogue(
    const int* acc, int T, float scale, float bias, float beta, float vth,
    uint8_t* out, int stride) {
  float v = 0.f;
#pragma unroll
  for (int t = 0; t < XPK_MAX_T; ++t) {
    if (t < T) {
      const float pre = __fadd_rn(__fmul_rn(static_cast<float>(acc[t]), scale), bias);
      v = __fadd_rn(__fmul_rn(beta, v), pre);
      const float s = v >= vth ? 1.f : 0.f;
      out[t * stride] = static_cast<uint8_t>(s);
      v = __fmul_rn(v, 1.f - s);
    }
  }
}

// Crossbar + LIF for every output column of one row block, thread-strided
// over columns: x [T][din] (integer-valued, any integer type, usually in
// shared memory), levels int8 [din][dout] row-major, scale/bias f32 [dout]
// (bias may be null) -> out [T][dout] spikes (out[t*out_stride + o]).
template <typename X>
__device__ void xpk_lin_lif(const X* x, int din, const int8_t* levels,
                            const float* scale, const float* bias, int dout,
                            int T, float beta, float vth, uint8_t* out,
                            int out_stride) {
  for (int o = threadIdx.x; o < dout; o += blockDim.x) {
    int acc[XPK_MAX_T];
#pragma unroll
    for (int t = 0; t < XPK_MAX_T; ++t) acc[t] = 0;
    for (int i = 0; i < din; ++i) {
      const int w = levels[static_cast<size_t>(i) * dout + o];
#pragma unroll
      for (int t = 0; t < XPK_MAX_T; ++t)
        if (t < T) acc[t] += static_cast<int>(x[t * din + i]) * w;
    }
    xpk_lif_epilogue(acc, T, scale[o], bias ? bias[o] : 0.f, beta, vth,
                     out + o, out_stride);
  }
}

// Round a byte offset up to 16 so every shared segment takes vector loads.
__host__ __device__ __forceinline__ size_t xpk_align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

static inline int xpk_set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}
