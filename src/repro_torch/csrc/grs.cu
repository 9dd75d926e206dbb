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
// On the main path R = 32 rows of D = 196,608 floats (768 KB an array).
// Design: the TPU kernel holds each row whole in VMEM; here a thread block
// cluster holds it. One launch: one cluster of C blocks per row (C = 8 at
// the main path's D), each block holding its slice of xi and m_hat in
// shared memory (TMA bulk copies) and of m in registers; the blocks sum
// their partial (vv, vx), add the cluster's pairs over DSMEM in rank order
// so every block takes the same decision with no scratch table and no
// atomics, and write z from what they hold: 16 bytes an element, the
// bound's. The row code is rows.cuh::grs_row, shared with the fused
// verify-commit kernel (superstep.cu, B6) so that the packed and the fused
// round give the same bits; its note there says what each step does and
// how a row longer than the cluster holds is streamed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

using repro_rows::kRowThreads;

template <int V>
__global__ void __launch_bounds__(kRowThreads, 1)
grs_kernel(const float* __restrict__ u, const float* __restrict__ sigma,
           const float* __restrict__ xi, const float* __restrict__ mh,
           const float* __restrict__ m, float* __restrict__ z, int32_t* __restrict__ acc,
           int64_t D, int64_t per_block, bool held) {
  extern __shared__ __align__(16) float grs_buf[];
  const int64_t r = blockIdx.y;
  repro_rows::grs_row<V>(repro_rows::MeanLoaded{m + r * D}, xi + r * D, mh + r * D,
                         z + r * D, D, per_block, held, u[r], sigma[r], acc + r, grs_buf);
}

}  // namespace

// u, sigma: (R,) f32; xi, m_hat, m, z: (R, D) f32 row-major; accept: (R,)
// int32. cluster, per_block, smem_bytes: the row geometry
// (kernels/grs/ops.py::row_geometry; smem_bytes > 0 holds the slices).
// Returns cudaErrorInvalidValue for a shape or geometry the kernel does not
// take, else the launch's error.
extern "C" int repro_grs(const void* u, const void* sigma, const void* xi,
                         const void* m_hat, const void* m, void* z, void* accept, int64_t R,
                         int64_t D, int64_t cluster, int64_t per_block, int64_t smem_bytes,
                         void* stream) {
  if (R <= 0 || R > 65535 || !repro_rows::row_geometry_ok(D, cluster, per_block, smem_bytes))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fu = static_cast<const float*>(u);
  const float* fs = static_cast<const float*>(sigma);
  const float* fx = static_cast<const float*>(xi);
  const float* fh = static_cast<const float*>(m_hat);
  const float* fm = static_cast<const float*>(m);
  float* fz = static_cast<float*>(z);
  int32_t* fa = static_cast<int32_t*>(accept);
  const bool vec = D % 4 == 0 && repro_rows::aligned16(xi) && repro_rows::aligned16(m_hat) &&
                   repro_rows::aligned16(m) && repro_rows::aligned16(z);
  const bool held = smem_bytes > 0;
  if (vec)
    return repro_rows::launch_rows(grs_kernel<4>, R, cluster, smem_bytes, s, fu, fs, fx, fh,
                                   fm, fz, fa, D, per_block, held);
  return repro_rows::launch_rows(grs_kernel<1>, R, cluster, smem_bytes, s, fu, fs, fx, fh, fm,
                                 fz, fa, D, per_block, held);
}

// How many clusters of this geometry the card keeps resident at once (the
// 16-byte instance), into *out. Returns the query's error.
extern "C" int repro_grs_max_active_clusters(int64_t cluster, int64_t smem_bytes, int* out) {
  if (cluster < 1 || cluster > repro_rows::kMaxCluster || smem_bytes < 0 ||
      smem_bytes > repro_rows::kMaxSmem)
    return cudaErrorInvalidValue;
  return repro_rows::row_max_active_clusters(grs_kernel<4>, cluster, smem_bytes, out);
}
