// Ragged row gather and scatter of the packed verification round, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/pack/kernel.py::
// _gather_kernel (through gather_rows_pallas) and ::_scatter_kernel
// (through scatter_rows_pallas), wrapped by kernels/pack/ops.py.
//
//   gather   out[p, :] = src[idx[p], :]              p < M
//   scatter  out[r, :] = vals[p, :] if idx[p] == r   r < N
//            rows no index names stay zero; idx[p] outside [0, N) drops
//            row p (the pack's padding lanes); in-range indices are unique.
//
// Indices are int64, the dtype torch indexes with and the pack maps carry.
// M, N and D are whatever the caller has: the kernels mask the ragged ends
// themselves, with no padding of rows to 8 or of D to 128 lanes.
//
// Bound: memory. Gather moves 2 M D 4 bytes, scatter M D 4 + N D 4; on the
// main path (M = 16 packed rows, N = 32 window rows, D = 196,608) that is
// 25 MB and 38 MB, 7.5 us and 11.3 us at 3.35 TB/s, and no arithmetic.
// Design: a table is 32 rows of 786 KB, far past shared memory, so nothing
// is held on chip. Each block copies one chunk of one row with 16-byte
// accesses (rows.cuh), and the grid of (chunks, rows) blocks fills the card.
// The TPU scatter zeroes its whole output on grid step 0 and then writes
// rows, which relies on the TPU running its grid in order. Blocks here run
// in any order, so each scatter block owns a chunk of one DESTINATION row:
// it finds the packed row that targets it (a scan of the M indices) and
// writes that row's chunk, or zeros. One pass, no memset, no race, and the
// output bytes are written exactly once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

using repro_rows::kThreads;

template <int V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ src, const int64_t* __restrict__ idx,
                   float* __restrict__ out, int64_t N, int64_t D, int64_t chunk) {
  const int64_t p = blockIdx.y;
  const int64_t start = blockIdx.x * chunk;
  const int64_t end = min(start + chunk, D);
  const int64_t row = idx[p];
  // an index outside the table (the pack maps never make one) reads zeros
  // instead of faulting
  const float* s = (row >= 0 && row < N) ? src + row * D : nullptr;
  repro_rows::copy_chunk<V>(s, out + p * D, start, end);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const float* __restrict__ vals, const int64_t* __restrict__ idx,
                    float* __restrict__ out, int64_t M, int64_t D, int64_t chunk) {
  const int64_t r = blockIdx.y;
  const int64_t start = blockIdx.x * chunk;
  const int64_t end = min(start + chunk, D);
  const int64_t p = repro_rows::source_of(idx, M, r);
  repro_rows::copy_chunk<V>(p >= 0 ? vals + p * D : nullptr, out + r * D, start, end);
}

bool dims_ok(int64_t rows_a, int64_t rows_b, int64_t D, int64_t chunk) {
  return rows_a > 0 && rows_b > 0 && D > 0 && chunk > 0 && chunk % 4 == 0 &&
         rows_a <= 65535 && rows_b <= 65535 && (D + chunk - 1) / chunk <= 0x7fffffff;
}

}  // namespace

// src: (N, D) f32; idx: (M,) int64; out: (M, D) f32. chunk: floats of a
// row per block, a multiple of 4. Returns cudaGetLastError().
extern "C" int repro_gather_rows(const void* src, const void* idx, void* out,
                                 int64_t N, int64_t M, int64_t D, int64_t chunk,
                                 void* stream) {
  if (!dims_ok(N, M, D, chunk)) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((D + chunk - 1) / chunk), static_cast<unsigned>(M));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(src);
  const int64_t* ip = static_cast<const int64_t*>(idx);
  float* op = static_cast<float*>(out);
  if (D % 4 == 0 && repro_rows::aligned16(src) && repro_rows::aligned16(out)) {
    gather_rows_kernel<4><<<grid, kThreads, 0, s>>>(sp, ip, op, N, D, chunk);
  } else {
    gather_rows_kernel<1><<<grid, kThreads, 0, s>>>(sp, ip, op, N, D, chunk);
  }
  return cudaGetLastError();
}

// vals: (M, D) f32; idx: (M,) int64; out: (N, D) f32, every element written.
// Returns cudaGetLastError().
extern "C" int repro_scatter_rows(const void* vals, const void* idx, void* out,
                                  int64_t M, int64_t N, int64_t D, int64_t chunk,
                                  void* stream) {
  if (!dims_ok(M, N, D, chunk)) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((D + chunk - 1) / chunk), static_cast<unsigned>(N));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* vp = static_cast<const float*>(vals);
  const int64_t* ip = static_cast<const int64_t*>(idx);
  float* op = static_cast<float*>(out);
  if (D % 4 == 0 && repro_rows::aligned16(vals) && repro_rows::aligned16(out)) {
    scatter_rows_kernel<4><<<grid, kThreads, 0, s>>>(vp, ip, op, M, D, chunk);
  } else {
    scatter_rows_kernel<1><<<grid, kThreads, 0, s>>>(vp, ip, op, M, D, chunk);
  }
  return cudaGetLastError();
}
