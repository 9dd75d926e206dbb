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
// the row held on chip) is later work. The row math is in rows.cuh, shared
// with the fused verify-commit kernel (superstep.cu, B6) so that the packed
// and the fused round give the same bits; it moves 16 bytes per access
// where D and the pointers allow.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

using repro_rows::kThreads;

template <int V>
__global__ void __launch_bounds__(kThreads)
grs_partial(const float* __restrict__ xi, const float* __restrict__ mh,
            const float* __restrict__ m, float* __restrict__ part,
            int64_t D, int64_t chunk, int nchunks) {
  const int c = blockIdx.x;
  const int64_t r = blockIdx.y;
  const int64_t start = c * chunk;
  repro_rows::grs_partial_sums<V>(repro_rows::MeanLoaded{m + r * D}, xi + r * D, mh + r * D,
                                  start, min(start + chunk, D),
                                  part + (r * nchunks + c) * 2);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
grs_apply(const float* __restrict__ u, const float* __restrict__ sigma,
          const float* __restrict__ xi, const float* __restrict__ mh,
          const float* __restrict__ m, const float* __restrict__ part,
          float* __restrict__ z, int32_t* __restrict__ acc,
          int64_t D, int64_t chunk, int nchunks) {
  const int c = blockIdx.x;
  const int64_t r = blockIdx.y;
  __shared__ repro_rows::GrsRow s_row;
  if (threadIdx.x == 0) {
    s_row = repro_rows::grs_decide(part + r * nchunks * 2, nchunks, u[r], sigma[r]);
    if (c == 0) acc[r] = s_row.accept;
  }
  __syncthreads();
  const int64_t start = c * chunk;
  repro_rows::grs_write<V>(repro_rows::MeanLoaded{m + r * D}, xi + r * D, mh + r * D,
                           z + r * D, start, min(start + chunk, D), s_row);
}

}  // namespace

// u, sigma: (R,) f32; xi, m_hat, m, z: (R, D) f32 row-major; accept: (R,)
// int32; part: (R, ceil(D / chunk), 2) f32 scratch; chunk a multiple of 4.
// Returns cudaGetLastError().
extern "C" int repro_grs(const void* u, const void* sigma, const void* xi,
                         const void* m_hat, const void* m, void* z, void* accept,
                         void* part, int64_t R, int64_t D, int64_t chunk,
                         void* stream) {
  if (R <= 0 || D <= 0 || chunk <= 0 || chunk % 4 != 0 || R > 65535)
    return cudaErrorInvalidValue;
  const int64_t nchunks = (D + chunk - 1) / chunk;
  if (nchunks > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(nchunks), static_cast<unsigned>(R));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fu = static_cast<const float*>(u);
  const float* fs = static_cast<const float*>(sigma);
  const float* fx = static_cast<const float*>(xi);
  const float* fh = static_cast<const float*>(m_hat);
  const float* fm = static_cast<const float*>(m);
  float* fp = static_cast<float*>(part);
  float* fz = static_cast<float*>(z);
  int32_t* fa = static_cast<int32_t*>(accept);
  const int nc = static_cast<int>(nchunks);
  const bool vec = D % 4 == 0 && repro_rows::aligned16(xi) && repro_rows::aligned16(m_hat) &&
                   repro_rows::aligned16(m) && repro_rows::aligned16(z);
  if (vec) {
    grs_partial<4><<<grid, kThreads, 0, s>>>(fx, fh, fm, fp, D, chunk, nc);
  } else {
    grs_partial<1><<<grid, kThreads, 0, s>>>(fx, fh, fm, fp, D, chunk, nc);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (vec) {
    grs_apply<4><<<grid, kThreads, 0, s>>>(fu, fs, fx, fh, fm, fp, fz, fa, D, chunk, nc);
  } else {
    grs_apply<1><<<grid, kThreads, 0, s>>>(fu, fs, fx, fh, fm, fp, fz, fa, D, chunk, nc);
  }
  return cudaGetLastError();
}
