// Row-chunk helpers shared by the GRS, pack and fused-round kernels.
//
// Every kernel of grs.cu, pack.cu and superstep.cu walks (rows, D) float32 tables
// one chunk of one row per block. A thread moves V floats per access:
// V = 4 (one 16-byte access) when D is a multiple of 4 and every base
// pointer is 16-byte aligned, else V = 1. Indices i below count V-wide
// elements.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_rows {

constexpr int kThreads = 256;

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p, int64_t i,
                                     float (&r)[V]) {
  if constexpr (V == 4) {
    const float4 t = reinterpret_cast<const float4*>(p)[i];
    r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
  } else {
    r[0] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ p, int64_t i,
                                      const float (&r)[V]) {
  if constexpr (V == 4) {
    reinterpret_cast<float4*>(p)[i] = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    p[i] = r[0];
  }
}

// dst[start:end] = src[start:end] (src == nullptr writes zeros); start and
// end are float offsets, multiples of V. Each thread issues kUnroll loads
// before its stores, so several accesses are in flight per thread.
constexpr int kUnroll = 4;

template <int V>
__device__ __forceinline__ void copy_chunk(const float* __restrict__ src,
                                           float* __restrict__ dst,
                                           int64_t start, int64_t end) {
  const int64_t n = end / V;
  for (int64_t base = start / V + threadIdx.x; base < n; base += kThreads * kUnroll) {
    float r[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kThreads;
      if (i < n) {
        if (src != nullptr) {
          load<V>(src, i, r[u]);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) r[u][k] = 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kThreads;
      if (i < n) store<V>(dst, i, r[u]);
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The p < M with idx[p] == row, or -1: the block scans the (small) index
// map itself, so a block that owns a destination row needs no inverse map
// and no earlier pass. In-range indices are unique, so at most one thread
// writes. Call from every thread of the block.
__device__ __forceinline__ int64_t source_of(const int64_t* __restrict__ idx,
                                             int64_t M, int64_t row) {
  __shared__ int64_t s_src;
  if (threadIdx.x == 0) s_src = -1;
  __syncthreads();
  for (int64_t p = threadIdx.x; p < M; p += kThreads) {
    if (idx[p] == row) s_src = p;
  }
  __syncthreads();
  const int64_t src = s_src;
  __syncthreads();  // s_src may be reused by a later call
  return src;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// ---- GRS of one row (paper Alg 3), shared by grs.cu (B1) and the fused
// verify-commit of superstep.cu (B6). Both kernels run this same code with
// the same chunking, so the packed round (the target mean m = A y + B g in
// torch, then B1) and the fused round (m in B6) give the same bits.
//
//   v = m_hat - m;  vv = ||v||^2;  vx = <v, xi>
//   accept = log max(u, 1e-20) <= min(-(vx/s + vv/(2 s^2)), 0)   (s = sigma > 0)
//   accept = (vv == 0)                                            (sigma == 0)
//   z = accept ? m_hat + sigma xi : m + sigma (vv > 0 ? xi - 2 vx/vv v : xi)

// the target mean m of a row, read from memory (B1)
struct MeanLoaded {
  const float* m;
  template <int V>
  __device__ __forceinline__ void get(int64_t i, float (&r)[V]) const { load<V>(m, i, r); }
};

// the target mean m = A y + B g of a row, rounded as torch rounds it (two
// products, then their sum; no FMA), so it equals the m torch stores (B6)
struct MeanAffine {
  float a, b;
  const float* y;
  const float* g;
  template <int V>
  __device__ __forceinline__ void get(int64_t i, float (&r)[V]) const {
    float ry[V], rg[V];
    load<V>(y, i, ry);
    load<V>(g, i, rg);
#pragma unroll
    for (int k = 0; k < V; ++k) r[k] = __fadd_rn(__fmul_rn(a, ry[k]), __fmul_rn(b, rg[k]));
  }
};

// Pass 1: the block's partial sums (vv, vx) over floats [start, end) of
// one row, written by thread 0 to out[0], out[1]. Call from every thread.
template <int V, class Mean>
__device__ __forceinline__ void grs_partial_sums(const Mean& mean, const float* __restrict__ xr,
                                                 const float* __restrict__ hr, int64_t start,
                                                 int64_t end, float* __restrict__ out) {
  float vv = 0.f, vx = 0.f;
  float rm[V], rx[V], rh[V];
  for (int64_t i = start / V + threadIdx.x; i < end / V; i += kThreads) {
    mean.template get<V>(i, rm);
    load<V>(xr, i, rx);
    load<V>(hr, i, rh);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float v = rh[k] - rm[k];
      vv = fmaf(v, v, vv);
      vx = fmaf(v, rx[k], vx);
    }
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
    out[0] = a;
    out[1] = b;
  }
}

struct GrsRow {
  float coef, sg;
  int accept, reflect;
};

// Pass 2, one thread: the row's (vv, vx) summed over its nchunks partials
// in a fixed order (every block of the row decides the same), and the
// accept / reflect decision.
__device__ __forceinline__ GrsRow grs_decide(const float* __restrict__ part, int nchunks,
                                             float u, float sg) {
  float vv = 0.f, vx = 0.f;
  for (int k = 0; k < nchunks; ++k) {
    vv += part[2 * k + 0];
    vx += part[2 * k + 1];
  }
  const float safe_sig = sg > 0.f ? sg : 1.f;
  const float log_ratio = -(vx / safe_sig + vv / (2.f * safe_sig * safe_sig));
  bool accept = logf(fmaxf(u, 1e-20f)) <= fminf(log_ratio, 0.f);
  if (!(sg > 0.f)) accept = vv <= 0.f;
  const float safe_vn = vv > 0.f ? vv : 1.f;
  return GrsRow{2.f * vx / safe_vn, sg, accept ? 1 : 0, vv > 0.f ? 1 : 0};
}

// Pass 2: z over floats [start, end) of one row. Call from every thread.
template <int V, class Mean>
__device__ __forceinline__ void grs_write(const Mean& mean, const float* __restrict__ xr,
                                          const float* __restrict__ hr, float* __restrict__ zr,
                                          int64_t start, int64_t end, const GrsRow row) {
  float rm[V], rx[V], rh[V], rz[V];
  for (int64_t i = start / V + threadIdx.x; i < end / V; i += kThreads) {
    load<V>(xr, i, rx);
    load<V>(hr, i, rh);
    if (row.accept) {
#pragma unroll
      for (int k = 0; k < V; ++k) rz[k] = fmaf(row.sg, rx[k], rh[k]);
    } else {
      mean.template get<V>(i, rm);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float v = rh[k] - rm[k];
        const float xref = row.reflect ? fmaf(-row.coef, v, rx[k]) : rx[k];
        rz[k] = fmaf(row.sg, xref, rm[k]);
      }
    }
    store<V>(zr, i, rz);
  }
}

}  // namespace repro_rows
