// Flash attention (online softmax over KV tiles) in float32 with FMAs, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::_flash_kernel (called through
// flash_attention, wrapped by kernels/flash_attention/ops.py::flash_mha) for
// float32 inputs; bf16 inputs go to flash_attention_wgmma.cu.
//
// o[b, l, h] = softmax_s(mask(softcap(<q[b,l,h], k[b,s,h]> / sqrt(dh)))) . v[b,s,h]
// in float32, with the TPU kernel's constants: a masked logit is -1e30 (not
// -inf), the running max starts at -inf, and the row sum is clamped at
// 1e-30 before the division. Options: causal, sliding window
// (q - k < window), logit softcap, and a key count seq_k <= Sk that masks a
// padded tail. Tiles wholly outside the causal or window band are skipped,
// as on the TPU.
//
// Layout: q, o are (B, Lq, H, dh) and k, v are (B, Sk, H, dh), each given by
// its batch, row and head strides with dh contiguous, so the projections'
// (B, L, H, dh) output is read in place without a transpose. dh <= 128.
//
// Its callers are the float32 paths (the LM in float32, the on-card float32
// references), whose arithmetic is the TPU kernel's float32: TF32 tensor
// cores would keep about three decimal digits, so this kernel stays on
// FMAs. One block of 256 threads owns a 64-row query tile; K and V tiles of
// 64 rows are staged in shared memory (rows padded by one word so the
// column reads hit distinct banks); each thread holds a 4 x 4 block of the
// score tile and a 4-row slice of the output accumulator in registers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr float kMasked = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, Lq, Sk, dh, seq_k, causal, window;
  float softcap;
  int64_t q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, o_sb, o_sl, o_sh;
};

__device__ __forceinline__ float half_warp_max(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ void load_tile(float* dst, const float* src, int64_t row_stride,
                                          int row0, int nrows_valid, int rows, int dh,
                                          int ld) {
  for (int e = threadIdx.x; e < rows * dh; e += kThreads) {
    const int r = e / dh, c = e - r * dh;
    const int gr = row0 + r;
    dst[r * ld + c] = gr < nrows_valid ? src[static_cast<int64_t>(gr) * row_stride + c] : 0.f;
  }
}

// NC = columns of the dh axis each thread owns in the output: ceil(dh / 16).
template <int NC>
__global__ void __launch_bounds__(kThreads) flash_fwd(Args a) {
  extern __shared__ float smem[];
  const int dh = a.dh;
  const int ld = dh + 1;
  float* Qs = smem;              // kBQ x ld
  float* Ks = Qs + kBQ * ld;     // kBK x ld
  float* Vs = Ks + kBK * ld;     // kBK x ld
  float* Ps = Vs + kBK * ld;     // kBQ x (kBK + 1)
  constexpr int ldp = kBK + 1;

  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // rows rg*4 .. rg*4+3 of the tile
  const int cg = tid & 15;  // key columns cg + 16 j; output columns cg + 16 c
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh - (bh / a.H) * a.H;
  const int q0 = blockIdx.x * kBQ;

  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  float* ob = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;

  load_tile(Qs, qb, a.q_sl, q0, a.Lq, kBQ, dh, ld);

  float m_i[4], l_i[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  const float sqrt_dh = sqrtf(static_cast<float>(dh));
  const int n_kv = (a.Sk + kBK - 1) / kBK;

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kBK;
    bool relevant = true;
    if (a.causal) relevant = k0 <= q0 + kBQ - 1;
    if (a.window) relevant = relevant && (q0 - (k0 + kBK - 1) < a.window);
    if (!relevant) continue;  // uniform across the block

    __syncthreads();  // the previous tile's readers are done
    load_tile(Ks, kb, a.k_sl, k0, a.Sk, kBK, dh, ld);
    load_tile(Vs, vb, a.v_sl, k0, a.Sk, kBK, dh, ld);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(cg + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg * 4 + i;
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = k0 + cg + 16 * j;
        float x = s[i][j] / sqrt_dh;
        if (a.softcap != 0.f) x = a.softcap * tanhf(x / a.softcap);
        bool ok = ki < a.seq_k;
        if (a.causal) ok = ok && ki <= qi;
        if (a.window) ok = ok && (qi - ki) < a.window;
        s[i][j] = ok ? x : kMasked;
        row_max = fmaxf(row_max, s[i][j]);
      }
      row_max = half_warp_max(row_max);
      const float m_new = fmaxf(m_i[i], row_max);
      const float alpha = expf(m_i[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        Ps[(rg * 4 + i) * ldp + cg + 16 * j] = p;
      }
      row_sum = half_warp_sum(row_sum);
      l_i[i] = l_i[i] * alpha + row_sum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < kBK; ++j) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(rg * 4 + i) * ldp + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = cg + 16 * c;
        vv[c] = col < dh ? Vs[j * ld + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    if (qi >= a.Lq) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = cg + 16 * c;
      if (col < dh) ob[static_cast<int64_t>(qi) * a.o_sl + col] = acc[i][c] / l;
    }
  }
}

template <int NC>
cudaError_t launch(const Args& a, int BH, cudaStream_t stream) {
  const int ld = a.dh + 1;
  const size_t smem = sizeof(float) * (static_cast<size_t>(kBQ) * ld + 2 * kBK * ld +
                                       kBQ * (kBK + 1));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + kBQ - 1) / kBQ, BH);
  flash_fwd<NC><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(const Args& a, int BH, cudaStream_t s) {
  switch ((a.dh + 15) / 16) {
    case 1: return launch<1>(a, BH, s);
    case 2: return launch<2>(a, BH, s);
    case 3: return launch<3>(a, BH, s);
    case 4: return launch<4>(a, BH, s);
    case 5: return launch<5>(a, BH, s);
    case 6: return launch<6>(a, BH, s);
    case 7: return launch<7>(a, BH, s);
    case 8: return launch<8>(a, BH, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// float32 only. Strides are in elements. Returns cudaGetLastError() after
// the launch (or the first error met).
extern "C" int repro_flash_attention_fma(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Lq, int Sk, int dh, int64_t q_sb, int64_t q_sl, int64_t q_sh, int64_t k_sb,
    int64_t k_sl, int64_t k_sh, int64_t v_sb, int64_t v_sl, int64_t v_sh,
    int64_t o_sb, int64_t o_sl, int64_t o_sh, int causal, int window, float softcap,
    int seq_k, void* stream) {
  const int64_t BH = static_cast<int64_t>(B) * H;
  if (B <= 0 || H <= 0 || Lq <= 0 || Sk <= 0 || dh <= 0 || dh > 128 || BH > 65535 ||
      seq_k > Sk)
    return cudaErrorInvalidValue;
  Args a{q, k, v, o, H, Lq, Sk, dh, seq_k, causal, window, softcap,
         q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, o_sb, o_sl, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(a, static_cast<int>(BH), s);
}
