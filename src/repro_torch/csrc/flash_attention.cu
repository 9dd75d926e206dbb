// Flash attention in float32 for Hopper (sm_90a): two designs, picked by
// shape in kernels/flash_attention/ops.py (f32_design).
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
// padded tail. The logit is the reference's float32 division by
// sqrt(dh), rounded as it rounds (see logit). Layout: q, o are
// (B, Lq, H, dh) and k, v are (B, Sk, H, dh), each given by its batch, row
// and head strides with dh contiguous, so the projections' (B, L, H, dh)
// output is read in place. dh <= 128.
//
// Loads: 16-byte copies where every row the kernel reads starts on a
// 16-byte boundary (base addresses, strides and dh multiples of 4 floats:
// the wrapper's `vec`), else 4-byte copies in the same kernel.
//
// 1. Tensor cores (flash_fwd_f32_tc), for every shape the packed design
//    does not take. Bound by operations: at hymba-1.5b's prefill shape
//    (2, 4096, 25, 64), window 1024, 47 GFLOP, 0.285 ms at 495 TFLOP/s for
//    the three TF32 products against 0.70 ms for float32 FMAs at 67.
//    - 3xTF32. One TF32 pass (cvt.rna: 10 mantissa bits) moves a product by
//      up to 2^-11 of its size, far past the float32 gate of 2e-5 +
//      2e-5 |o| (the emulation below reads 13x to 36x it). Split every operand:
//      hi = tf32(x), lo = tf32(x - hi), so x - hi - lo is below 2^-22 |x|,
//      and take a b = a_lo b_hi + a_hi b_lo + a_hi b_hi: three
//      mma.sync.m16n8k8 TF32 products with float32 accumulators, for Q K^T
//      and for P V (P split after the exponent). The dropped a_lo b_lo and
//      the split's remainders are ~2^-21 of a product (the emulation in
//      tests/test_torch_flash_f32_design.py uses a few percent of the gate).
//    - Tiling. A block of 4 warps owns 64 query rows (16 a warp); it walks
//      64-key tiles of the band (tiles wholly outside it are skipped, the
//      TPU kernel's rule). K and V tiles arrive by cp.async in a staging
//      pair while the block computes on the previous tile; the block then
//      splits the staged tile once into hi and lo planes, which all four
//      warps share. Rows are padded to HDP + 4 floats (4 x an odd number),
//      so every fragment load of a warp hits 32 distinct banks. The online
//      softmax runs on the accumulator fragments; a row's max and sum take
//      two quad shuffles.
//    - P between the products. The m16n8k8 accumulator holds, per lane,
//      columns 2t and 2t + 1 of an 8-key slice (t = lane % 4); the TF32 A
//      fragment wants columns t and t + 4. A contraction does not care in
//      which order it meets its keys, so P V takes the slice's keys in the
//      order (0, 2, 4, 6, 1, 3, 5, 7): A column t is key 2t and column t + 4
//      is key 2t + 1, which is what the lane already holds, and the lane
//      loads V's B fragment from rows 2t and 2t + 1 to match. P never goes
//      through a shuffle or shared memory.
//    - What bounds it on this card: not one unit but latency. Each warp
//      reads the whole K and V tile (hi and lo) from shared memory for its
//      16 rows, 64 KB a tile at dh 64; the block splits every tile between
//      two barriers; at dh 64 its registers and 104 KB of shared memory
//      leave 2 blocks (8 warps) on an SM to hide the waits. Two 16-row
//      m-tiles a warp would halve the shared-memory traffic, but run out of
//      registers at dh 64 and spill (tried, slower); wgmma's 64-row tiles
//      are the way on (ROADMAP).
// 2. Packed (flash_fwd_f32_packed), for Lq <= 64 and Sk <= 64: a (b, h)
//    pair's whole problem is one tile (the stand-ins' verify calls, L 16 and
//    64, dh 32 and 24). Bound by bytes: q, k, v and o once each. A warp owns
//    16 query rows of one pair, and a block of 4 warps holds 4 / ceil(Lq/16)
//    pairs, so no row is padded past a multiple of 16 and the 768 pairs of
//    the policy shape fill the card in one wave of 192 blocks. Every load of
//    the block is in flight at once (cp.async), then each lane holds a 4-row
//    x (Sk/8)-key block of the scores, runs the softmax in registers (rows
//    reduced over 8 lanes by shuffles), writes P^T to its warp's slice of
//    shared memory and holds a 4-row x 4-column slice of o per 32 columns.
//    float32 FMAs: the work is too small to gain from tensor cores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;
constexpr int kThreads = 128;  // both designs: 4 warps

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int B, H, Lq, Sk, dh, seq_k, causal, window, vec;
  float softcap, sqrt_dh, inv_sqrt_dh;  // sqrtf(dh) and 1.0f / sqrtf(dh)
  int64_t q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, o_sb, o_sl, o_sh;
};

__device__ __forceinline__ bool keep(const Args& a, int qi, int ki) {
  bool ok = ki < a.seq_k;
  if (a.causal) ok = ok && ki <= qi;
  if (a.window) ok = ok && (qi - ki) < a.window;
  return ok;
}

// softcap(dot / sqrt(dh)). The quotient is the correctly rounded one the
// reference's float32 division gives, in three operations: q = dot r with
// r the rounded reciprocal, then one step on the remainder dot - q sqrt(dh),
// which the FMA computes exactly (Markstein). A logit one ulp off moves p by
// |s| ulps, which a sampler run over 100 steps grows past the card-against-
// CPU gate of chip_smoke.py's standin_reference.
__device__ __forceinline__ float logit(const Args& a, float dot) {
  const float q = dot * a.inv_sqrt_dh;
  const float x = fmaf(fmaf(-q, a.sqrt_dh, dot), a.inv_sqrt_dh, q);
  return a.softcap != 0.f ? a.softcap * tanhf(x / a.softcap) : x;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// src_bytes 0 fills the destination with zeros (rows past the end)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Copies rows [row0, row0 + rows) of one (b, h) slice (row stride sl) into
// dst (pitch ld floats), columns [0, dh) of cols4 * 4; rows at or past
// n_valid and columns past dh (4-byte path) are zero-filled.
__device__ __forceinline__ void copy_rows(float* dst, int ld, const float* src, int64_t sl,
                                          int row0, int rows, int n_valid, int dh, int cols4,
                                          bool vec, int t0, int nt) {
  if (vec) {  // dh == 4 * cols4
    for (int e = t0; e < rows * cols4; e += nt) {
      const int r = e / cols4, c = e - r * cols4;
      const bool ok = row0 + r < n_valid;
      cp_async16(dst + r * ld + 4 * c, ok ? src + (row0 + r) * sl + 4 * c : src, ok);
    }
  } else {
    const int cols = 4 * cols4;
    for (int e = t0; e < rows * cols; e += nt) {
      const int r = e / cols, c = e - r * cols;
      const bool ok = row0 + r < n_valid && c < dh;
      cp_async4(dst + r * ld + c, ok ? src + (row0 + r) * sl + c : src, ok);
    }
  }
}

// ------------------------------------------------------------ tensor cores

namespace tc {

constexpr int kRows = 64;  // query rows a block, 16 a warp
constexpr int kKeys = 64;  // keys a tile

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x ~ hi + lo: hi = tf32(x), lo = tf32(x - hi) (x - hi is exact in float32)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a b over one m16n8k8 TF32 tile (not volatile: the compiler may
// interleave the independent products of a k-step)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[n] += a b[n] in 3xTF32 for N accumulator tiles, the B fragment of tile n
// at hi + off(n), hi + off(n) + step (and the same in lo): a_lo b_hi and
// a_hi b_lo on every tile first, then a_hi b_hi, so that consecutive
// products never wait on each other
template <int N, typename Off>
__device__ __forceinline__ void mma3(float (&d)[N][4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const float* hi,
                                     const float* lo, int step, Off off) {
  uint32_t bh[N][2];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    bh[n][0] = __float_as_uint(hi[off(n)]);
    bh[n][1] = __float_as_uint(hi[off(n) + step]);
    mma(d[n], al, bh[n][0], bh[n][1]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
    mma(d[n], ah, __float_as_uint(lo[off(n)]), __float_as_uint(lo[off(n) + step]));
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], ah, bh[n][0], bh[n][1]);
}

// hi and lo planes of a staged tile, split once for the block's four warps
template <int HDP>
__device__ __forceinline__ void split_tile(const float* raw, float* hi, float* lo) {
  constexpr int LD = HDP + 4, C4 = HDP / 4;
  for (int e = threadIdx.x; e < kKeys * C4; e += kThreads) {
    const int r = e / C4, off = r * LD + 4 * (e - r * C4);
    const float4 x = *reinterpret_cast<const float4*>(raw + off);
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// HDP: dh padded to 16, 32, 64, 96 or 128 (zero columns past dh).
template <int HDP>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_tc(Args a) {
  constexpr int LD = HDP + 4;  // 4 x odd: conflict-free fragment loads
  constexpr int KS = HDP / 8;  // k-steps of Q K^T; n-tiles of P V
  constexpr int PLANE = kKeys * LD;
  extern __shared__ __align__(16) float smem[];
  float* rawK = smem;  // the cp.async staging pair
  float* rawV = rawK + PLANE;
  float* Khi = rawV + PLANE;  // holds the raw Q tile until the first split
  float* Klo = Khi + PLANE;
  float* Vhi = Klo + PLANE;
  float* Vlo = Vhi + PLANE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh - b * a.H;
  const int n_q = (a.Lq + kRows - 1) / kRows;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.y)) * kRows;  // heaviest first
  const int qw0 = q0 + warp * 16;
  const bool rows_here = qw0 < a.Lq;
  const float* qb = a.q + b * a.q_sb + h * a.q_sh;
  const float* kb = a.k + b * a.k_sb + h * a.k_sh;
  const float* vb = a.v + b * a.v_sb + h * a.v_sh;
  const int cols4 = a.vec ? a.dh / 4 : (a.dh + 3) / 4;

  // the tiles [lo, hi) the TPU kernel's band rule keeps for rows q0..q0+63
  int hi_t = (a.Sk + kKeys - 1) / kKeys;
  if (a.causal) hi_t = min(hi_t, (q0 + kRows - 1) / kKeys + 1);
  int lo_t = 0;
  if (a.window) {
    const int first_key = q0 - a.window - kKeys + 2;
    if (first_key > 0) lo_t = (first_key + kKeys - 1) / kKeys;
  }

  // columns [4 cols4, HDP) of the staging pair and of the Q tile stay zero
  for (int c0 = 4 * cols4, e = tid; c0 < HDP && e < 3 * kKeys * (HDP - c0); e += kThreads) {
    const int p = e / (kKeys * (HDP - c0)), rem = e - p * kKeys * (HDP - c0);
    const int r = rem / (HDP - c0);
    smem[p * PLANE + r * LD + c0 + rem - r * (HDP - c0)] = 0.f;
  }
  copy_rows(Khi, LD, qb, a.q_sl, q0, kRows, a.Lq, a.dh, cols4, a.vec, tid, kThreads);
  if (lo_t < hi_t) {
    copy_rows(rawK, LD, kb, a.k_sl, lo_t * kKeys, kKeys, a.Sk, a.dh, cols4, a.vec, tid,
              kThreads);
    copy_rows(rawV, LD, vb, a.v_sl, lo_t * kKeys, kKeys, a.Sk, a.dh, cols4, a.vec, tid,
              kThreads);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this warp's Q rows as raw A fragments: rows gid, gid + 8; columns tig, tig + 4
  float qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const float* r0 = Khi + (warp * 16 + gid) * LD + ks * 8 + tig;
    qf[ks][0] = r0[0];
    qf[ks][1] = r0[8 * LD];
    qf[ks][2] = r0[4];
    qf[ks][3] = r0[8 * LD + 4];
  }
  __syncthreads();  // every warp has its Q before the split overwrites it
  if (lo_t < hi_t) {
    split_tile<HDP>(rawK, Khi, Klo);
    split_tile<HDP>(rawV, Vhi, Vlo);
  }
  __syncthreads();

  float o[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows gid, gid + 8

  for (int t = lo_t; t < hi_t; ++t) {
    const bool more = t + 1 < hi_t;
    if (more) {  // the staging pair is free: the last split is behind a barrier
      copy_rows(rawK, LD, kb, a.k_sl, (t + 1) * kKeys, kKeys, a.Sk, a.dh, cols4, a.vec, tid,
                kThreads);
      copy_rows(rawV, LD, vb, a.v_sl, (t + 1) * kKeys, kKeys, a.Sk, a.dh, cols4, a.vec, tid,
                kThreads);
      cp_async_commit();
    }
    if (rows_here) {
      const int k0 = t * kKeys;
      // s[n]: rows gid, gid + 8 x keys k0 + 8n + 2 tig + {0, 1}
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qh[4], ql[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split(qf[ks][i], qh[i], ql[i]);
        // B = K^T: K[key 8n + gid][d 8ks + tig (+ 4)]
        mma3<8>(s, qh, ql, Khi, Klo, 4,
                [&](int n) { return (n * 8 + gid) * LD + ks * 8 + tig; });
      }
      // the element mask only on tiles that cut the band, seq_k or Sk
      const bool edge = k0 + kKeys > a.seq_k || (a.causal && k0 + kKeys - 1 > qw0) ||
                        (a.window && qw0 + 15 - k0 >= a.window);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = logit(a, s[n][i]);
          if (edge && !keep(a, qw0 + gid + 8 * (i >> 1), k0 + n * 8 + 2 * tig + (i & 1)))
            x = kMasked;
          s[n][i] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        s[n][0] = expf(s[n][0] - mn0);
        s[n][1] = expf(s[n][1] - mn0);
        s[n][2] = expf(s[n][2] - mn1);
        s[n][3] = expf(s[n][3] - mn1);
        sum0 += s[n][0] + s[n][1];
        sum1 += s[n][2] + s[n][3];
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
      }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        o[n][0] *= al0;
        o[n][1] *= al0;
        o[n][2] *= al1;
        o[n][3] *= al1;
      }
      // P V over the 8-key slices j, keys in the order (0, 2, 4, 6, 1, 3, 5, 7):
      // A column tig is key 2 tig (s[j][0], s[j][2]), column tig + 4 is key
      // 2 tig + 1 (s[j][1], s[j][3]); V's B fragment takes the same rows
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t ph[4], pl[4];
        split(s[j][0], ph[0], pl[0]);
        split(s[j][2], ph[1], pl[1]);
        split(s[j][1], ph[2], pl[2]);
        split(s[j][3], ph[3], pl[3]);
        // B = V[key 8j + 2 tig (+ 1)][column 8n + gid]
        mma3<KS>(o, ph, pl, Vhi, Vlo, LD,
                 [&](int n) { return (j * 8 + 2 * tig) * LD + n * 8 + gid; });
      }
    }
    if (more) {
      cp_async_wait_all();
      __syncthreads();  // tile t+1 staged; every warp is done with tile t's planes
      split_tile<HDP>(rawK, Khi, Klo);
      split_tile<HDP>(rawV, Vhi, Vlo);
      __syncthreads();
    }
  }

  if (!rows_here) return;
  const float L0 = fmaxf(l0, 1e-30f), L1 = fmaxf(l1, 1e-30f);
  float* ob = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = qw0 + gid + 8 * half;
    if (qi >= a.Lq) continue;
    const float L = half ? L1 : L0;
    float* orow = ob + qi * a.o_sl;
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      const int col = n * 8 + 2 * tig;
      const float x0 = o[n][2 * half] / L, x1 = o[n][2 * half + 1] / L;
      if (a.vec) {
        if (col < a.dh) *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
      } else {
        if (col < a.dh) orow[col] = x0;
        if (col + 1 < a.dh) orow[col + 1] = x1;
      }
    }
  }
}

template <int HDP>
size_t smem_bytes() {
  return sizeof(float) * 6 * kKeys * (HDP + 4);
}

template <int HDP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static size_t configured = 0;  // opt-in above 48 KB, set once a size
  const size_t smem = smem_bytes<HDP>();
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_tc<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  const dim3 grid(static_cast<unsigned>(a.B) * a.H, (a.Lq + kRows - 1) / kRows);
  flash_fwd_f32_tc<HDP><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(const Args& a, cudaStream_t s) {
  if (static_cast<int64_t>(a.B) * a.H > 0x7fffffff || (a.Lq + kRows - 1) / kRows > 65535)
    return cudaErrorInvalidValue;
  if (a.dh <= 16) return launch<16>(a, s);
  if (a.dh <= 32) return launch<32>(a, s);
  if (a.dh <= 64) return launch<64>(a, s);
  if (a.dh <= 96) return launch<96>(a, s);
  return launch<128>(a, s);
}

}  // namespace tc

// ------------------------------------------------------------------ packed

namespace packed {

constexpr int kRows = 16;    // query rows a warp
constexpr int kMaxSeq = 64;  // Lq and Sk the design takes
constexpr int kPLD = 20;     // pitch of a warp's P^T rows (4 x odd)

// KJ: key columns a lane holds (8 KJ >= Sk); NC4: float4 columns of o a
// lane holds (32 NC4 >= dh). qc: warps a pair (ceil(Lq / 16)); pb: pairs a
// block; ld: pitch of the q, k, v rows in shared memory (4 x odd).
template <int KJ, int NC4>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_packed(Args a, int qc, int pb,
                                                                 int ld) {
  constexpr int SP = 8 * KJ;  // key rows held, zero past Sk
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                // pb x SP x ld
  float* Vs = Ks + pb * SP * ld;   // pb x SP x ld
  float* Qs = Vs + pb * SP * ld;   // 4 warps x 16 x ld
  float* Ps = Qs + 4 * kRows * ld; // 4 warps x SP x kPLD (P^T)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int BH = a.B * a.H;
  const int pair0 = blockIdx.x * pb;
  const int cols4 = a.vec ? a.dh / 4 : (a.dh + 3) / 4;

  // every copy of the block in flight at once: k and v of its pairs, then
  // each warp's 16 query rows
  for (int lp = 0; lp < pb; ++lp) {
    const int pair = pair0 + lp;
    const int n_valid = pair < BH ? a.Sk : 0;
    const int b = pair / a.H, h = pair - (pair / a.H) * a.H;
    const float* kb = a.k + (pair < BH ? b * a.k_sb + h * a.k_sh : 0);
    const float* vb = a.v + (pair < BH ? b * a.v_sb + h * a.v_sh : 0);
    copy_rows(Ks + lp * SP * ld, ld, kb, a.k_sl, 0, SP, n_valid, a.dh, cols4, a.vec, tid,
              kThreads);
    copy_rows(Vs + lp * SP * ld, ld, vb, a.v_sl, 0, SP, n_valid, a.dh, cols4, a.vec, tid,
              kThreads);
  }
  const int lp = warp / qc, chunk = warp - lp * qc;
  const int pair = pair0 + lp;
  const bool active = lp < pb && pair < BH && chunk * kRows < a.Lq;
  const int b = pair / a.H, h = pair - (pair / a.H) * a.H;
  const float* qb = a.q + (active ? b * a.q_sb + h * a.q_sh : 0);
  copy_rows(Qs + warp * kRows * ld, ld, qb, a.q_sl, chunk * kRows, kRows,
            active ? a.Lq : 0, a.dh, cols4, a.vec, lane, 32);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (!active) return;

  // lane (rg, cg): query rows 4 rg + i of the chunk, keys cg + 8 j
  const int rg = lane >> 3, cg = lane & 7;
  const float* Qw = Qs + (warp * kRows + rg * 4) * ld;
  const float* Kp = Ks + lp * SP * ld;
  float s[4][KJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
  for (int c = 0; c < cols4; ++c) {
    float4 qv[4], kv[KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(Qw + i * ld + 4 * c);
#pragma unroll
    for (int j = 0; j < KJ; ++j)
      kv[j] = *reinterpret_cast<const float4*>(Kp + (cg + 8 * j) * ld + 4 * c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
        s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
        s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
      }
  }

  // softmax of each row over its Sk keys (columns past Sk take no part)
  const int qrow0 = chunk * kRows + rg * 4;
  float l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int ki = cg + 8 * j;
      float x = keep(a, qrow0 + i, ki) ? logit(a, s[i][j]) : kMasked;
      s[i][j] = ki < a.Sk ? x : -INFINITY;
      mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      s[i][j] = expf(s[i][j] - mx);
      sum += s[i][j];
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l[i] = fmaxf(sum, 1e-30f);
  }
  float* Pw = Ps + warp * SP * kPLD;
#pragma unroll
  for (int j = 0; j < KJ; ++j)
    *reinterpret_cast<float4*>(Pw + (cg + 8 * j) * kPLD + rg * 4) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
  __syncwarp();

  // o rows 4 rg + i, float4 columns cg + 8 c
  const float* Vp = Vs + lp * SP * ld;
  float acc[4][NC4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC4; ++c) acc[i][c][0] = acc[i][c][1] = acc[i][c][2] = acc[i][c][3] = 0.f;
  for (int j = 0; j < a.Sk; ++j) {
    const float4 p = *reinterpret_cast<const float4*>(Pw + j * kPLD + rg * 4);
    const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int c = 0; c < NC4; ++c) {
      if (cg + 8 * c >= cols4) continue;
      const float4 vv = *reinterpret_cast<const float4*>(Vp + j * ld + 4 * (cg + 8 * c));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][c][0] = fmaf(pv[i], vv.x, acc[i][c][0]);
        acc[i][c][1] = fmaf(pv[i], vv.y, acc[i][c][1]);
        acc[i][c][2] = fmaf(pv[i], vv.z, acc[i][c][2]);
        acc[i][c][3] = fmaf(pv[i], vv.w, acc[i][c][3]);
      }
    }
  }

  float* ob = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = qrow0 + i;
    if (qi >= a.Lq) continue;
    float* orow = ob + qi * a.o_sl;
#pragma unroll
    for (int c = 0; c < NC4; ++c) {
      const int c4 = cg + 8 * c;
      if (c4 >= cols4) continue;
      const float4 x = make_float4(acc[i][c][0] / l[i], acc[i][c][1] / l[i],
                                   acc[i][c][2] / l[i], acc[i][c][3] / l[i]);
      if (a.vec) {
        *reinterpret_cast<float4*>(orow + 4 * c4) = x;
      } else {
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * c4 + e < a.dh) orow[4 * c4 + e] = xs[e];
      }
    }
  }
}

template <int KJ, int NC4>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static size_t configured = 0;
  const int cols4 = (a.dh + 3) / 4;
  const int ld = 4 * (cols4 | 1);
  const int qc = (a.Lq + kRows - 1) / kRows;
  const int pb = 4 / qc;
  const size_t smem =
      sizeof(float) * ((2 * pb * 8 * KJ + 4 * kRows) * ld + 4 * 8 * KJ * kPLD);
  if (smem > 48 * 1024 && smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_packed<KJ, NC4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  const int64_t blocks = (static_cast<int64_t>(a.B) * a.H + pb - 1) / pb;
  flash_fwd_f32_packed<KJ, NC4><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      a, qc, pb, ld);
  return cudaGetLastError();
}

template <int KJ>
cudaError_t by_width(const Args& a, cudaStream_t s) {
  switch ((a.dh + 31) / 32) {
    case 1: return launch<KJ, 1>(a, s);
    case 2: return launch<KJ, 2>(a, s);
    case 3: return launch<KJ, 3>(a, s);
    default: return launch<KJ, 4>(a, s);
  }
}

cudaError_t dispatch(const Args& a, cudaStream_t s) {
  if (a.Lq > kMaxSeq || a.Sk > kMaxSeq || static_cast<int64_t>(a.B) * a.H > 0x7fffffff)
    return cudaErrorInvalidValue;
  if (a.Sk <= 16) return by_width<2>(a, s);
  if (a.Sk <= 32) return by_width<4>(a, s);
  return by_width<8>(a, s);
}

}  // namespace packed

}  // namespace

// float32 only. Strides are in elements. design: 0 tensor cores, 1 packed
// (Lq and Sk at most 64). vec: 1 where q, k, v and o rows start on 16-byte
// boundaries (16-byte copies), 0 for 4-byte copies. Returns
// cudaGetLastError() after the launch (or the first error met).
extern "C" int repro_flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, int B, int H, int Lq, int Sk,
    int dh, int64_t q_sb, int64_t q_sl, int64_t q_sh, int64_t k_sb, int64_t k_sl,
    int64_t k_sh, int64_t v_sb, int64_t v_sl, int64_t v_sh, int64_t o_sb, int64_t o_sl,
    int64_t o_sh, int causal, int window, float softcap, int seq_k, int design, int vec,
    void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Sk <= 0 || dh <= 0 || dh > 128 || seq_k > Sk ||
      (vec && dh % 4))
    return cudaErrorInvalidValue;
  const float sqrt_dh = sqrtf(static_cast<float>(dh));
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<float*>(o), B, H, Lq, Sk, dh, seq_k,
         causal, window, vec, softcap, sqrt_dh, 1.0f / sqrt_dh,
         q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, o_sb, o_sl, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (design) {
    case 0: return tc::dispatch(a, s);
    case 1: return packed::dispatch(a, s);
    default: return cudaErrorInvalidValue;
  }
}
