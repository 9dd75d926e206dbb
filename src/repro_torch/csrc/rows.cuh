// Row helpers shared by the GRS, pack and fused-round kernels.
//
// The pack kernels (pack.cu) and the fused gather (superstep.cu) walk
// (rows, D) float32 tables one chunk of one row per block of kThreads. A
// thread moves V floats per access: V = 4 (one 16-byte access) when D is a
// multiple of 4 and every base pointer is 16-byte aligned, else V = 1.
// Indices i below count V-wide elements.
//
// GRS (grs.cu, B1) and the fused verify-commit (superstep.cu, B6) run one
// row per thread block cluster through grs_row() below.
#pragma once

#include <cooperative_groups.h>
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
// writes. Call from every thread of a block of NT threads.
template <int NT = kThreads>
__device__ __forceinline__ int64_t source_of(const int64_t* __restrict__ idx,
                                             int64_t M, int64_t row) {
  __shared__ int64_t s_src;
  if (threadIdx.x == 0) s_src = -1;
  __syncthreads();
  for (int64_t p = threadIdx.x; p < M; p += NT) {
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

// ---- GRS of one row (paper Alg 3) by one thread block cluster, shared by
// grs.cu (B1) and the fused verify-commit of superstep.cu (B6). Both
// kernels run this same code with the same geometry (the wrappers take it
// from kernels/grs/ops.py::row_geometry), so the packed round (the target
// mean m = A y + B g in torch, then B1) and the fused round (m in B6) give
// the same bits.
//
//   v = m_hat - m;  vv = ||v||^2;  vx = <v, xi>
//   accept = log max(u, 1e-20) <= min(-(vx/s + vv/(2 s^2)), 0)   (s = sigma > 0)
//   accept = (vv == 0)                                            (sigma == 0)
//   z = accept ? m_hat + sigma xi : m + sigma (vv > 0 ? xi - 2 vx/vv v : xi)
//
// The row is held on chip. A cluster of C blocks (grid x, one cluster a
// row) owns the row; block k owns floats [k P, min((k + 1) P, D)) of it
// (P = per_block, a multiple of 4, so every slice starts 16-byte aligned
// where the row does). Each block
//   (a) loads its slice of xi and m_hat into shared memory: one thread
//       issues 1-D TMA bulk copies in kStages parts, each completing on
//       its own mbarrier (V = 4), or
//       all threads copy 4 bytes at a time (V = 1: D not a multiple of 4 or
//       a pointer not 16-byte aligned, e.g. a view one float into its
//       storage); meanwhile every thread loads its kHeld floats of m into
//       registers (B6 forms m = A y + B g there from y and g);
//   (b) sums its (vv, vx) in a fixed order, each part as soon as it has
//       landed: each thread over its elements in slice order (V-wide
//       element k kRowThreads + t of the slice for thread t, the V lanes
//       in order), warp_sum, then warps in order;
//   (c) writes its pair to its own shared memory, then a cluster barrier;
//   (d) reads the C pairs over DSMEM in rank order 0 .. C - 1 and takes the
//       accept / reflect decision: every block of the row takes the same;
//   (e) arrives on a second cluster barrier once its DSMEM reads are done
//       and waits on it only before it exits, so no block's shared memory
//       goes away while a neighbour may still read its pair;
//   (f) writes its slice of z from what it holds.
// Every input byte is read once and z written once: 16 bytes an element
// for B1. Where a slice is longer than a block holds (P > kHeldPerBlock:
// D above C * kHeldPerBlock), the block streams its slice from device
// memory in (b) and reads it again in (f), in the same element order, so
// any D runs. Whether a slice is held is decided once, by row_geometry:
// the launch holds it exactly when it gives the block shared memory.

constexpr int kRowThreads = 512;
constexpr int kHeld = 48;  // floats of m a thread holds in registers
constexpr int64_t kHeldPerBlock = int64_t(kRowThreads) * kHeld;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int64_t kMaxSmem = 232448;  // a block's shared memory on sm_90
constexpr int64_t kBulkBytes = 32768;  // bytes of one TMA bulk copy
// A held slice arrives in kStages parts, each on its own mbarrier, so a
// block sums one part while the next ones load.
constexpr int kStages = 4;

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

struct GrsRow {
  float coef, sg;
  int accept, reflect;
};

// The row's accept / reflect decision from its summed (vv, vx).
__device__ __forceinline__ GrsRow grs_decide(float vv, float vx, float u, float sg) {
  const float safe_sig = sg > 0.f ? sg : 1.f;
  const float log_ratio = -(vx / safe_sig + vv / (2.f * safe_sig * safe_sig));
  bool accept = logf(fmaxf(u, 1e-20f)) <= fminf(log_ratio, 0.f);
  if (!(sg > 0.f)) accept = vv <= 0.f;
  const float safe_vn = vv > 0.f ? vv : 1.f;
  return GrsRow{2.f * vx / safe_vn, sg, accept ? 1 : 0, vv > 0.f ? 1 : 0};
}

template <int V>
__device__ __forceinline__ void grs_sum(const float (&rm)[V], const float (&rx)[V],
                                        const float (&rh)[V], float& vv, float& vx) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float v = rh[k] - rm[k];
    vv = fmaf(v, v, vv);
    vx = fmaf(v, rx[k], vx);
  }
}

template <int V>
__device__ __forceinline__ void grs_z(const GrsRow& row, const float (&rm)[V],
                                      const float (&rx)[V], const float (&rh)[V],
                                      float (&rz)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (row.accept) {
      rz[k] = fmaf(row.sg, rx[k], rh[k]);
    } else {
      const float v = rh[k] - rm[k];
      const float xref = row.reflect ? fmaf(-row.coef, v, rx[k]) : rx[k];
      rz[k] = fmaf(row.sg, xref, rm[k]);
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Spins until the mbarrier's phase 0 has completed. A wait that never ends
// traps after ~2^26 polls, so a fault shows as a launch error and not as a
// hung card.
__device__ __forceinline__ void mbar_wait0(uint32_t bar) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  }
}

// bytes (a multiple of 16) of src into dst, both 16-byte aligned, in TMA
// bulk copies completing on the mbarrier bar. One thread.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, int64_t bytes,
                                          uint32_t bar) {
  for (int64_t off = 0; off < bytes; off += kBulkBytes) {
    const uint32_t n = static_cast<uint32_t>(min(kBulkBytes, bytes - off));
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst) + static_cast<uint32_t>(off)),
        "l"(reinterpret_cast<const char*>(src) + off), "r"(n), "r"(bar)
        : "memory");
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// This block's slice of one row: [start, start + len) of D floats.
struct Slice {
  int64_t start, len;
};

__device__ __forceinline__ Slice row_slice(int64_t D, int64_t per_block) {
  const int64_t start = static_cast<int64_t>(cooperative_groups::this_cluster().block_rank()) *
                        per_block;
  return Slice{start, D > start ? min(D - start, per_block) : 0};
}

// zeros over this block's slice of a row (a row no packed row targets)
template <int V>
__device__ __forceinline__ void zero_slice(float* __restrict__ zr, int64_t D,
                                           int64_t per_block) {
  const Slice sl = row_slice(D, per_block);
  float r0[V];
#pragma unroll
  for (int k = 0; k < V; ++k) r0[k] = 0.f;
  for (int64_t q = threadIdx.x; q < sl.len / V; q += kRowThreads) store<V>(zr + sl.start, q, r0);
}

// GRS of one row, steps (a)-(f) above. mean, xr, hr and zr point at the
// row's first float; buf is the block's dynamic shared memory, 2 P floats
// where the slice is held (held: the launch gave it shared memory; then P
// <= kHeldPerBlock). Call from every thread of every block of the row's
// cluster; rank 0 writes *acc.
template <int V, class Mean>
__device__ __forceinline__ void grs_row(const Mean& mean, const float* __restrict__ xr,
                                        const float* __restrict__ hr, float* __restrict__ zr,
                                        int64_t D, int64_t per_block, bool held, float u,
                                        float sg, int32_t* __restrict__ acc,
                                        float* __restrict__ buf) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const Slice sl = row_slice(D, per_block);
  const int64_t nvec = sl.len / V;  // V = 4: D and P are multiples of 4
  const int64_t m0 = sl.start / V;  // the slice's first V-wide element in the row
  const float* x = xr + sl.start;
  const float* h = hr + sl.start;
  float* z = zr + sl.start;
  float* sx = buf;
  float* sh = buf + per_block;
  constexpr int KV = kHeld / V;
  constexpr int kPerStage = KV / kStages;  // k steps of a part (V = 4)
  constexpr int64_t kStageFloats = int64_t(kPerStage) * kRowThreads * V;
  static_assert(KV % kStages == 0, "a part is a whole number of k steps");
  float rm[KV][V];
  __shared__ uint64_t s_bar[kStages];
  __shared__ float s_warp[2][kRowThreads / 32];
  __shared__ float s_pair[2];
  __shared__ GrsRow s_row;

  // (a), (b)
  float vv = 0.f, vx = 0.f;
  if (held) {
    const uint32_t bar = smem_u32(s_bar);  // part c completes on bar + 8 c
    if constexpr (V == 4) {
      if (threadIdx.x == 0) {
        for (int c = 0; c < kStages; ++c)
          asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar + 8 * c) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int c = 0; c < kStages; ++c) {
          const int64_t lo = min(c * kStageFloats, sl.len);
          const int64_t n = min((c + 1) * kStageFloats, sl.len) - lo;
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                           bar + 8 * c),
                       "r"(static_cast<uint32_t>(2 * n * 4))
                       : "memory");
          bulk_load(sx + lo, x + lo, n * 4, bar + 8 * c);
          bulk_load(sh + lo, h + lo, n * 4, bar + 8 * c);
        }
      }
    } else {
      for (int64_t e = threadIdx.x; e < sl.len; e += kRowThreads) {
        sx[e] = x[e];
        sh[e] = h[e];
      }
    }
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int64_t q = static_cast<int64_t>(k) * kRowThreads + threadIdx.x;
      if (q < nvec) mean.template get<V>(m0 + q, rm[k]);
    }
    if constexpr (V == 1) __syncthreads();
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      if constexpr (V == 4) {
        if (k % kPerStage == 0) mbar_wait0(bar + 8 * (k / kPerStage));
      }
      const int64_t q = static_cast<int64_t>(k) * kRowThreads + threadIdx.x;
      if (q < nvec) {
        float rx[V], rh[V];
        load<V>(sx, q, rx);
        load<V>(sh, q, rh);
        grs_sum<V>(rm[k], rx, rh, vv, vx);
      }
    }
  } else {
    for (int64_t q = threadIdx.x; q < nvec; q += kRowThreads) {
      float rmq[V], rx[V], rh[V];
      mean.template get<V>(m0 + q, rmq);
      load<V>(x, q, rx);
      load<V>(h, q, rh);
      grs_sum<V>(rmq, rx, rh, vv, vx);
    }
  }
  vv = warp_sum(vv);
  vx = warp_sum(vx);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_warp[0][warp] = vv;
    s_warp[1][warp] = vx;
  }
  __syncthreads();
  // (c)
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < kRowThreads / 32; ++w) {
      a += s_warp[0][w];
      b += s_warp[1][w];
    }
    s_pair[0] = a;
    s_pair[1] = b;
  }
  cluster.sync();
  // (d)
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
    for (unsigned k = 0; k < cluster.num_blocks(); ++k) {
      const float* pair = cluster.map_shared_rank(s_pair, k);
      a += pair[0];
      b += pair[1];
    }
    s_row = grs_decide(a, b, u, sg);
    if (cluster.block_rank() == 0) *acc = s_row.accept;
  }
  // (e)
  cluster_arrive();
  __syncthreads();
  const GrsRow row = s_row;
  // (f)
  if (held) {
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int64_t q = static_cast<int64_t>(k) * kRowThreads + threadIdx.x;
      if (q < nvec) {
        float rx[V], rh[V], rz[V];
        load<V>(sx, q, rx);
        load<V>(sh, q, rh);
        grs_z<V>(row, rm[k], rx, rh, rz);
        store<V>(z, q, rz);
      }
    }
  } else {
    for (int64_t q = threadIdx.x; q < nvec; q += kRowThreads) {
      float rmq[V], rx[V], rh[V], rz[V];
      load<V>(x, q, rx);
      load<V>(h, q, rh);
      mean.template get<V>(m0 + q, rmq);
      grs_z<V>(row, rmq, rx, rh, rz);
      store<V>(z, q, rz);
    }
  }
  cluster_wait();
}

// ---- host side

// The geometry of a row launch (kernels/grs/ops.py::row_geometry) is one the
// kernels take: C blocks of P floats covering D, and either no shared memory
// (the slice streams) or exactly a held slice's two arrays, which its
// registers must hold too.
inline bool row_geometry_ok(int64_t D, int64_t cluster, int64_t per_block,
                            int64_t smem_bytes) {
  return D > 0 && cluster >= 1 && cluster <= kMaxCluster && per_block > 0 &&
         per_block % 4 == 0 && per_block <= (int64_t(1) << 40) && cluster * per_block >= D &&
         (smem_bytes == 0 || (smem_bytes == 2 * per_block * 4 && per_block <= kHeldPerBlock &&
                              smem_bytes <= kMaxSmem));
}

inline cudaLaunchConfig_t row_launch_config(dim3 grid, int64_t cluster, int64_t smem_bytes,
                                            cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kRowThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <class... P>
cudaError_t row_attributes(void (*kernel)(P...), int64_t smem_bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes));
}

// One cluster launch of a row kernel: grid (C, rows), clusters of (C, 1, 1).
// Returns the launch's error, then cudaGetLastError().
template <class... P, class... A>
cudaError_t launch_rows(void (*kernel)(P...), int64_t rows, int64_t cluster,
                        int64_t smem_bytes, cudaStream_t stream, A... args) {
  cudaError_t err = row_attributes(kernel, smem_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      row_launch_config(dim3(static_cast<unsigned>(cluster), static_cast<unsigned>(rows)),
                        cluster, smem_bytes, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of this geometry the card runs at once.
template <class... P>
cudaError_t row_max_active_clusters(void (*kernel)(P...), int64_t cluster,
                                    int64_t smem_bytes, int* out) {
  cudaError_t err = row_attributes(kernel, smem_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      row_launch_config(dim3(static_cast<unsigned>(cluster)), cluster, smem_bytes, nullptr,
                        &attr);
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

}  // namespace repro_rows
