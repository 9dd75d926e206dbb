// Gaussian Rejection Sampler (paper Alg 3) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/grs/kernel.py::_grs_kernel
// (called through grs_pallas, wrapped by kernels/grs/ops.py::grs).
//
// Per row r of (R, D) float32 operands xi, m_hat, m, with u[r] and sigma[r]:
//   v = m_hat - m;  vv = ||v||^2;  vx = <v, xi>
//   accept = log max(u, 1e-20) <= min(-(vx/s + vv/(2 s^2)), 0)   (s = sigma > 0)
//   accept = (vv == 0)                                            (sigma == 0)
//   z = accept ? m_hat + sigma xi : m + sigma (vv > 0 ? xi - 2 vx/vv v : xi)
//
// Bound: memory. The function reads xi, m_hat, m once and writes z once,
// 16 bytes per element, with a few flops each; no matrix unit is involved.
// On the main path R = 32 rows of D = 196,608, so one block per row would
// fill 32 of 132 SMs. Design: each row is cut into chunks of `chunk`
// elements and every (chunk, row) pair is one block of 256 threads, which
// fills the card. Pass 1 writes each block's two partial sums to a scratch
// table (no atomics, so the result is deterministic); pass 2 has every
// block of a row sum that row's partials in one fixed order, decide the
// same accept bit, and write its chunk of z. Pass 2 re-reads the three
// inputs, so this design moves 28 bytes per element where 16 would do:
// fusing the two passes (a grid-wide barrier or one block per row with
// the row held on chip) is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(kThreads)
grs_partial(const float* __restrict__ xi, const float* __restrict__ mh,
            const float* __restrict__ m, float* __restrict__ part,
            int64_t D, int64_t chunk, int nchunks) {
  const int c = blockIdx.x;
  const int64_t r = blockIdx.y;
  const int64_t start = c * chunk;
  const int64_t end = min(start + chunk, D);
  const float* xr = xi + r * D;
  const float* hr = mh + r * D;
  const float* mr = m + r * D;
  float vv = 0.f, vx = 0.f;
  for (int64_t i = start + threadIdx.x; i < end; i += kThreads) {
    const float v = hr[i] - mr[i];
    vv = fmaf(v, v, vv);
    vx = fmaf(v, xr[i], vx);
  }
  __shared__ float s_vv[kThreads / 32], s_vx[kThreads / 32];
  vv = warp_sum(vv);
  vx = warp_sum(vx);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) { s_vv[warp] = vv; s_vx[warp] = vx; }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) { a += s_vv[w]; b += s_vx[w]; }
    part[(r * nchunks + c) * 2 + 0] = a;
    part[(r * nchunks + c) * 2 + 1] = b;
  }
}

__global__ void __launch_bounds__(kThreads)
grs_apply(const float* __restrict__ u, const float* __restrict__ sigma,
          const float* __restrict__ xi, const float* __restrict__ mh,
          const float* __restrict__ m, const float* __restrict__ part,
          float* __restrict__ z, int32_t* __restrict__ acc,
          int64_t D, int64_t chunk, int nchunks) {
  const int c = blockIdx.x;
  const int64_t r = blockIdx.y;
  __shared__ float s_coef, s_sig;
  __shared__ int s_acc, s_reflect;
  if (threadIdx.x == 0) {
    float vv = 0.f, vx = 0.f;
    for (int k = 0; k < nchunks; ++k) {
      vv += part[(r * nchunks + k) * 2 + 0];
      vx += part[(r * nchunks + k) * 2 + 1];
    }
    const float sg = sigma[r];
    const float safe_sig = sg > 0.f ? sg : 1.f;
    const float log_ratio = -(vx / safe_sig + vv / (2.f * safe_sig * safe_sig));
    bool accept = logf(fmaxf(u[r], 1e-20f)) <= fminf(log_ratio, 0.f);
    if (!(sg > 0.f)) accept = vv <= 0.f;
    const float safe_vn = vv > 0.f ? vv : 1.f;
    s_coef = 2.f * vx / safe_vn;
    s_sig = sg;
    s_acc = accept ? 1 : 0;
    s_reflect = vv > 0.f ? 1 : 0;
    if (c == 0) acc[r] = s_acc;
  }
  __syncthreads();
  const float coef = s_coef, sg = s_sig;
  const bool accept = s_acc != 0, reflect = s_reflect != 0;
  const int64_t start = c * chunk;
  const int64_t end = min(start + chunk, D);
  const float* xr = xi + r * D;
  const float* hr = mh + r * D;
  const float* mr = m + r * D;
  float* zr = z + r * D;
  for (int64_t i = start + threadIdx.x; i < end; i += kThreads) {
    const float x = xr[i];
    if (accept) {
      zr[i] = hr[i] + sg * x;
    } else {
      const float v = hr[i] - mr[i];
      const float xref = reflect ? x - coef * v : x;
      zr[i] = mr[i] + sg * xref;
    }
  }
}

}  // namespace

// u, sigma: (R,) f32; xi, m_hat, m, z: (R, D) f32 row-major; accept: (R,)
// int32; part: (R, ceil(D / chunk), 2) f32 scratch. Returns cudaGetLastError().
extern "C" int repro_grs(const void* u, const void* sigma, const void* xi,
                         const void* m_hat, const void* m, void* z, void* accept,
                         void* part, int64_t R, int64_t D, int64_t chunk,
                         void* stream) {
  if (R <= 0 || D <= 0 || chunk <= 0 || R > 65535) return cudaErrorInvalidValue;
  const int64_t nchunks = (D + chunk - 1) / chunk;
  if (nchunks > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(nchunks), static_cast<unsigned>(R));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  grs_partial<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(xi), static_cast<const float*>(m_hat),
      static_cast<const float*>(m), static_cast<float*>(part), D, chunk,
      static_cast<int>(nchunks));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  grs_apply<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(u), static_cast<const float*>(sigma),
      static_cast<const float*>(xi), static_cast<const float*>(m_hat),
      static_cast<const float*>(m), static_cast<const float*>(part),
      static_cast<float*>(z), static_cast<int32_t*>(accept), D, chunk,
      static_cast<int>(nchunks));
  return cudaGetLastError();
}
