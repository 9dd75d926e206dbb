// The fused packed-round pair for Hopper (sm_90a): the pack side of a
// round in one launch, and the verify-and-commit side in one call.
//
// Replaces the Pallas TPU kernels src/repro/kernels/superstep/kernel.py::
// _fused_gather_kernel (through fused_gather_pallas) and
// ::_fused_commit_kernel (through fused_verify_commit_pallas), wrapped by
// kernels/superstep/ops.py.
//
// fused_gather: for packed positions p < M, row idx[p] of the y_prev, xi and
//   m_hat tables (N, D) and of the scalar table (N, C) (t, u, A, B, sigma).
//
// fused_verify_commit: for packed rows p < M with scalars u, sigma, A, B and
//   rows y, g, xi, m_hat (M, D): the target mean m = A y + B g, then GRS
//   of (u, sigma, xi, m_hat, m) as in grs.cu (B1), then z and accept go to
//   row idx[p] of the (N, D) and (N,) tables; idx[p] outside [0, N) drops
//   row p, rows no index names are zero. The row math is B1's own code
//   (rows.cuh), with m rounded as torch rounds A * y + B * g, so the fused
//   round gives the same bits as the packed round (torch mean, then B1).
//
// Bound: memory. On the main path (M = 16, N = 32, D = 196,608, C = 5) the
// gather moves 3 (M + M) D 4 + 2 M C 4 bytes = 75.5 MB (22.5 us at
// 3.35 TB/s), verify-and-commit reads 4 M D 4 and writes N D 4 bytes =
// 75.5 MB (22.5 us); the few flops per element do not matter.
//
// Design. The gather's tables are far past shared memory (the Pallas
// kernels keep them whole in VMEM), so its rows stream from device memory
// in 16-byte accesses, one chunk of one row per block (rows.cuh).
// Verify-and-commit is one launch of B1's cluster row code
// (rows.cuh::grs_row, the geometry B1 takes): one cluster per DESTINATION
// row r < N. Its blocks find the packed row p that targets r (a scan of the
// M indices; every block of the cluster finds the same p). Where there is
// one, the cluster runs GRS on row p with m = A y + B g formed in
// registers from y and g as they load, holds the row on chip, reduces its
// partial sums over DSMEM and writes z to row r; where there is none, the
// whole cluster writes zeros and accept 0 and skips the cluster barriers
// together. The TPU kernel zeroes its outputs on grid step 0 and then
// scatters, relying on its sequential grid; owning destination rows needs
// no zeroing pass and has no race, and every input byte is read once and
// every output byte written once, the bound's bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

using repro_rows::kRowThreads;
using repro_rows::kThreads;

template <int V>
__global__ void __launch_bounds__(kThreads)
fused_gather_kernel(const float* __restrict__ y, const float* __restrict__ xi,
                    const float* __restrict__ mh, const float* __restrict__ sc,
                    const int64_t* __restrict__ idx, float* __restrict__ oy,
                    float* __restrict__ oxi, float* __restrict__ omh,
                    float* __restrict__ osc, int64_t N, int64_t D, int64_t C,
                    int64_t chunk) {
  const int64_t p = blockIdx.y;
  const int64_t start = blockIdx.x * chunk;
  const int64_t end = min(start + chunk, D);
  const int64_t row = idx[p];
  // an index outside the tables (the pack maps never make one) reads zeros
  const bool ok = row >= 0 && row < N;
  repro_rows::copy_chunk<V>(ok ? y + row * D : nullptr, oy + p * D, start, end);
  repro_rows::copy_chunk<V>(ok ? xi + row * D : nullptr, oxi + p * D, start, end);
  repro_rows::copy_chunk<V>(ok ? mh + row * D : nullptr, omh + p * D, start, end);
  if (blockIdx.x == 0) {
    for (int64_t c = threadIdx.x; c < C; c += kThreads) {
      osc[p * C + c] = ok ? sc[row * C + c] : 0.f;
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kRowThreads, 1)
fvc_kernel(const float* __restrict__ u, const float* __restrict__ sigma,
           const float* __restrict__ A, const float* __restrict__ B,
           const float* __restrict__ y, const float* __restrict__ g,
           const float* __restrict__ xi, const float* __restrict__ mh,
           const int64_t* __restrict__ idx, float* __restrict__ z, int32_t* __restrict__ acc,
           int64_t M, int64_t D, int64_t per_block, bool held) {
  extern __shared__ __align__(16) float fvc_buf[];
  const int64_t r = blockIdx.y;
  const int64_t p = repro_rows::source_of<kRowThreads>(idx, M, r);
  if (p < 0) {  // no packed row targets this one: it stays zero
    repro_rows::zero_slice<V>(z + r * D, D, per_block);
    if (blockIdx.x == 0 && threadIdx.x == 0) acc[r] = 0;
    return;
  }
  const repro_rows::MeanAffine mean{A[p], B[p], y + p * D, g + p * D};
  repro_rows::grs_row<V>(mean, xi + p * D, mh + p * D, z + r * D, D, per_block, held, u[p],
                         sigma[p], acc + r, fvc_buf);
}

bool rows_ok(int64_t rows) { return rows > 0 && rows <= 65535; }

}  // namespace

// y, xi, mh: (N, D) f32; sc: (N, C) f32; idx: (M,) int64; oy, oxi, omh:
// (M, D) f32; osc: (M, C) f32. Returns cudaGetLastError().
extern "C" int repro_fused_gather(const void* y, const void* xi, const void* mh,
                                  const void* sc, const void* idx, void* oy,
                                  void* oxi, void* omh, void* osc, int64_t N,
                                  int64_t M, int64_t D, int64_t C, int64_t chunk,
                                  void* stream) {
  if (!rows_ok(N) || !rows_ok(M) || D <= 0 || C < 0 || chunk <= 0 || chunk % 4 != 0 ||
      (D + chunk - 1) / chunk > 0x7fffffff)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((D + chunk - 1) / chunk), static_cast<unsigned>(M));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = D % 4 == 0 && repro_rows::aligned16(y) && repro_rows::aligned16(xi) &&
                   repro_rows::aligned16(mh) && repro_rows::aligned16(oy) &&
                   repro_rows::aligned16(oxi) && repro_rows::aligned16(omh);
  const float* fy = static_cast<const float*>(y);
  const float* fx = static_cast<const float*>(xi);
  const float* fh = static_cast<const float*>(mh);
  const float* fs = static_cast<const float*>(sc);
  const int64_t* ip = static_cast<const int64_t*>(idx);
  float* gy = static_cast<float*>(oy);
  float* gx = static_cast<float*>(oxi);
  float* gh = static_cast<float*>(omh);
  float* gs = static_cast<float*>(osc);
  if (vec) {
    fused_gather_kernel<4><<<grid, kThreads, 0, s>>>(fy, fx, fh, fs, ip, gy, gx, gh, gs,
                                                     N, D, C, chunk);
  } else {
    fused_gather_kernel<1><<<grid, kThreads, 0, s>>>(fy, fx, fh, fs, ip, gy, gx, gh, gs,
                                                     N, D, C, chunk);
  }
  return cudaGetLastError();
}

// u, sigma, A, B: (M,) f32; y, g, xi, mh: (M, D) f32; idx: (M,) int64;
// z: (N, D) f32 and acc: (N,) int32, every element written once.
// cluster, per_block, smem_bytes: B1's row geometry
// (kernels/grs/ops.py::row_geometry; smem_bytes > 0 holds the slices).
// Returns cudaErrorInvalidValue for a shape or geometry the kernel does not
// take, else the launch's error.
extern "C" int repro_fused_verify_commit(const void* u, const void* sigma, const void* A,
                                         const void* B, const void* y, const void* g,
                                         const void* xi, const void* mh, const void* idx,
                                         void* z, void* acc, int64_t M, int64_t N, int64_t D,
                                         int64_t cluster, int64_t per_block,
                                         int64_t smem_bytes, void* stream) {
  if (!rows_ok(M) || !rows_ok(N) ||
      !repro_rows::row_geometry_ok(D, cluster, per_block, smem_bytes))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = D % 4 == 0 && repro_rows::aligned16(y) && repro_rows::aligned16(g) &&
                   repro_rows::aligned16(xi) && repro_rows::aligned16(mh) &&
                   repro_rows::aligned16(z);
  const float* fu = static_cast<const float*>(u);
  const float* fs = static_cast<const float*>(sigma);
  const float* fa = static_cast<const float*>(A);
  const float* fb = static_cast<const float*>(B);
  const float* fy = static_cast<const float*>(y);
  const float* fg = static_cast<const float*>(g);
  const float* fx = static_cast<const float*>(xi);
  const float* fh = static_cast<const float*>(mh);
  const int64_t* ip = static_cast<const int64_t*>(idx);
  float* fz = static_cast<float*>(z);
  int32_t* fc = static_cast<int32_t*>(acc);
  const bool held = smem_bytes > 0;
  if (vec)
    return repro_rows::launch_rows(fvc_kernel<4>, N, cluster, smem_bytes, s, fu, fs, fa, fb,
                                   fy, fg, fx, fh, ip, fz, fc, M, D, per_block, held);
  return repro_rows::launch_rows(fvc_kernel<1>, N, cluster, smem_bytes, s, fu, fs, fa, fb, fy,
                                 fg, fx, fh, ip, fz, fc, M, D, per_block, held);
}
