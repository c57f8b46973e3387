// K6: the drift fold of programmed PCM state onto the int8 execution image,
// for every leaf of a parameter tree in one launch.
//
// Replaces the TPU kernel repro/kernels/aimc_matmul.py:drift_requantize_kernel
// (pallas_call at :172, body _requant_kernel at :137), which
// repro/aimc_device.py:_requantize evaluates on the JAX hot path.
//
// A leaf is levels, eps, nu f32 [M, n] (M leading matrices of n = d_in *
// d_out elements each), t f32 [M] device times (or none: t = 0) and img_inv
// f32 [M] (1 / the image gain, frozen at program time).  Per matrix m:
//   t' = max(t, t0); logr = logf(t' / t0); gain = rint(1 / img_inv);
// per element:
//   g = ((levels + eps) * expf(-nu * logr)) * gain;
//   image = clamp(rint(g), -127, 127)  -> out int8 [M, n],
// one correctly rounded f32 operation at a time, in the reference's order
// (the library is built with -fmad=false and the _rn intrinsics are never
// contracted).  expf and logf are the CUDA math library's, the functions
// PyTorch's torch.exp and torch.log call on the card, and the gain is
// PyTorch's round(1.0 / img_inv) (a correctly rounded reciprocal, then
// rint), so the kernel equals its plain version (kernels/ref.py) bit for
// bit.  A leaf may instead ask for the calibration read of GDC: no image is
// written, and each matrix's sum of |image| is added into sums[m] (int64,
// exact).
//
// Bound on the card: bytes.  Three f32 reads and one int8 write an element
// (13 bytes) for about ten float operations (expf counted as one), far
// below the card's rate of operations per byte.  What the one-launch-a-leaf
// design paid, and what this one does about it:
//   1. Host cost a leaf: a launch, two broadcasts of the time and gain and
//      the gain's two small ops, about 130 us of host time a leaf against a
//      device bound of 2.3 us at the widest.  Here up to kMaxLeaves leaves
//      go in one launch: their descriptors travel by value in the kernel's
//      parameters (72 bytes a leaf, under the 4 KB limit), so nothing is
//      copied to the card first; the wrapper chunks longer trees.
//   2. The inner loop: each element divided a 64-bit index by n and paid
//      the divide and logf of its matrix.  Here the grid is (chunk of a
//      matrix, matrix, leaf): no element divides, and one thread of each
//      block computes the matrix's logr and gain once, in the same order.
//   3. Scalar 4-byte loads and 1-byte stores: here a thread takes four
//      elements at a time with three 16-byte loads and one 4-byte store,
//      kQuads quads' loads in flight before any arithmetic; a matrix whose
//      rows are not 16-byte aligned (an odd width times an odd index) takes
//      the scalar path, and the last n % 4 elements a scalar tail.
#include <cstdint>
#include <cuda_runtime.h>

// One leaf's descriptor, as the launcher takes it from the host (outside
// the anonymous namespace: the extern "C" launcher's signature names it).
struct XpkDriftLeaf {
  const float* levels;
  const float* eps;
  const float* nu;
  const float* t_sec;       // [n_mat] device times, or null: t = 0
  const float* img_inv;     // [n_mat]
  int8_t* out;              // [n_mat, n] image, or null: none written
  unsigned long long* sums; // [n_mat] |image| sums added, or null
  long long n;              // elements a matrix
  int n_mat;
  int pad;
};

namespace {

constexpr int kThreads = 256;
constexpr int kQuads = 2;  // four-element groups a thread, loads in flight
constexpr long long kChunk = 4LL * kQuads * kThreads;  // elements a block
constexpr int kMaxLeaves = 32;

struct DriftGroup {
  XpkDriftLeaf leaf[kMaxLeaves];
};

__device__ __forceinline__ int fold1(float lv, float e, float nu, float logr,
                                     float gain) {
  const float df = expf(__fmul_rn(-nu, logr));
  const float g = __fmul_rn(__fmul_rn(__fadd_rn(lv, e), df), gain);
  return static_cast<int>(fminf(fmaxf(rintf(g), -127.f), 127.f));
}

__device__ __forceinline__ bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

__global__ void __launch_bounds__(kThreads)
drift_fold_kernel(const __grid_constant__ DriftGroup g, float t0) {
  const XpkDriftLeaf& d = g.leaf[blockIdx.z];
  const int m = blockIdx.y;
  const long long lo = blockIdx.x * kChunk;
  if (m >= d.n_mat || lo >= d.n) return;  // block-uniform
  const long long hi = min(lo + kChunk, d.n);
  __shared__ float mat[2];  // logr, gain
  __shared__ long long part[kThreads / 32];
  if (threadIdx.x == 0) {
    const float t = fmaxf(d.t_sec ? __ldg(d.t_sec + m) : 0.f, t0);
    mat[0] = logf(__fdiv_rn(t, t0));
    mat[1] = rintf(__fdiv_rn(1.f, __ldg(d.img_inv + m)));
  }
  const size_t base = static_cast<size_t>(m) * d.n;
  const float* lv = d.levels + base;
  const float* ep = d.eps + base;
  const float* nu = d.nu + base;
  int8_t* out = d.out ? d.out + base : nullptr;
  const bool vec = aligned(lv, 16) && aligned(ep, 16) && aligned(nu, 16) &&
                   (!out || aligned(out, 4));
  long long acc = 0;
  if (vec) {
    const long long q1 = hi >> 2;  // whole quads of this chunk
    float4 a[kQuads], e[kQuads], u[kQuads];
#pragma unroll
    for (int k = 0; k < kQuads; ++k) {
      const long long qi = (lo >> 2) + k * kThreads + threadIdx.x;
      if (qi < q1) {
        a[k] = __ldg(reinterpret_cast<const float4*>(lv) + qi);
        e[k] = __ldg(reinterpret_cast<const float4*>(ep) + qi);
        u[k] = __ldg(reinterpret_cast<const float4*>(nu) + qi);
      }
    }
    __syncthreads();  // mat[] is written
    const float logr = mat[0], gain = mat[1];
#pragma unroll
    for (int k = 0; k < kQuads; ++k) {
      const long long qi = (lo >> 2) + k * kThreads + threadIdx.x;
      if (qi < q1) {
        const int x = fold1(a[k].x, e[k].x, u[k].x, logr, gain);
        const int y = fold1(a[k].y, e[k].y, u[k].y, logr, gain);
        const int z = fold1(a[k].z, e[k].z, u[k].z, logr, gain);
        const int w = fold1(a[k].w, e[k].w, u[k].w, logr, gain);
        if (out)
          reinterpret_cast<char4*>(out)[qi] =
              make_char4(static_cast<signed char>(x), static_cast<signed char>(y),
                         static_cast<signed char>(z), static_cast<signed char>(w));
        acc += abs(x) + abs(y) + abs(z) + abs(w);
      }
    }
    for (long long i = (q1 << 2) + threadIdx.x; i < hi; i += kThreads) {
      const int x = fold1(__ldg(lv + i), __ldg(ep + i), __ldg(nu + i), logr,
                          gain);
      if (out) out[i] = static_cast<int8_t>(x);
      acc += abs(x);
    }
  } else {
    __syncthreads();
    const float logr = mat[0], gain = mat[1];
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
      const int x = fold1(__ldg(lv + i), __ldg(ep + i), __ldg(nu + i), logr,
                          gain);
      if (out) out[i] = static_cast<int8_t>(x);
      acc += abs(x);
    }
  }
  if (!d.sums) return;  // block-uniform
  for (int s = 16; s; s >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, s);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += part[w];
    atomicAdd(d.sums + m, static_cast<unsigned long long>(total));
  }
}

}  // namespace

// One launch over count <= kMaxLeaves leaves (host descriptors, copied into
// the kernel's parameters).  Refuses a count, width or matrix count the
// grid cannot hold.
extern "C" int launch_drift_fold(const XpkDriftLeaf* leaves, int count,
                                 float t0, void* stream) {
  if (count <= 0 || count > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  DriftGroup g{};
  long long chunks = 0, mats = 0;
  for (int i = 0; i < count; ++i) {
    const XpkDriftLeaf& d = leaves[i];
    if (d.n < 0 || d.n_mat < 0 || !d.levels || !d.eps || !d.nu ||
        !d.img_inv || (!d.out && !d.sums))
      return static_cast<int>(cudaErrorInvalidValue);
    g.leaf[i] = d;
    chunks = chunks > (d.n + kChunk - 1) / kChunk
                 ? chunks : (d.n + kChunk - 1) / kChunk;
    mats = mats > d.n_mat ? mats : d.n_mat;
  }
  if (chunks == 0 || mats == 0) return 0;
  if (chunks > 0x7fffffffLL || mats > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(mats),
                  static_cast<unsigned>(count));
  drift_fold_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, t0);
  return static_cast<int>(cudaGetLastError());
}
