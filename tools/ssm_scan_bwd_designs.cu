// The other design for B7's backward (the port's is
// src/repro_torch/csrc/ssm_scan_bwd.cu, whose note gives the function, its
// roundings and its bound): the forward's register pipeline
// (csrc/ssm_scan.cu) run backward. Built and timed beside the port's kernel
// by tools/ssm_scan_bwd_designs.py; not part of the port's library.
//
// One thread owns one (b, d) channel and carries g in a register;
// neighbouring threads own neighbouring d. Each thread loads the next
// kUnroll steps of a_{t+1}, G_t and h_{t-1} into registers while its chain
// runs the current kUnroll (3 x 8 loads of 4 bytes in flight a thread);
// the top L % kUnroll steps run one at a time first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 8;

// The steps [t0, t0 + kUnroll) of a_{t+1}, G_t and h_{t-1}, the ends masked.
__device__ __forceinline__ void load_group(const float* __restrict__ ap,
                                           const float* __restrict__ gp,
                                           const float* __restrict__ hp, int t0, int L,
                                           int64_t D, float* ra, float* rg, float* rh) {
#pragma unroll
  for (int i = 0; i < kUnroll; ++i) {
    const int t = t0 + i;
    ra[i] = t + 1 < L ? __ldg(ap + static_cast<int64_t>(t + 1) * D) : 0.f;
    rg[i] = __ldg(gp + static_cast<int64_t>(t) * D);
    rh[i] = t > 0 ? __ldg(hp + static_cast<int64_t>(t - 1) * D) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
    ssm_scan_bwd_regs_kernel(const float* __restrict__ a, const float* __restrict__ h,
                             const float* __restrict__ G, float* __restrict__ da,
                             float* __restrict__ db, int L, int64_t D) {
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (d >= D) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * L * D + d;
  const float* ap = a + base;
  const float* hp = h + base;
  const float* gp = G + base;
  float* dap = da + base;
  float* dbp = db + base;

  float carry = 0.f;  // g_{t+1}
  const int full = L - L % kUnroll;
  for (int t = L - 1; t >= full; --t) {
    const int64_t off = static_cast<int64_t>(t) * D;
    const float an = t + 1 < L ? ap[off + D] : 0.f;
    const float hprev = t > 0 ? hp[off - D] : 0.f;
    carry = __fadd_rn(__fmul_rn(an, carry), gp[off]);
    __stcs(dbp + off, carry);
    __stcs(dap + off, __fmul_rn(carry, hprev));
  }
  float ra[kUnroll], rg[kUnroll], rh[kUnroll];
  if (full > 0) load_group(ap, gp, hp, full - kUnroll, L, D, ra, rg, rh);
  for (int t0 = full - kUnroll; t0 >= 0; t0 -= kUnroll) {
    float na[kUnroll], ng[kUnroll], nh[kUnroll];
    if (t0 > 0)  // the next (earlier) group's loads go out before this group's chain
      load_group(ap, gp, hp, t0 - kUnroll, L, D, na, ng, nh);
#pragma unroll
    for (int i = kUnroll - 1; i >= 0; --i) {
      const int64_t off = static_cast<int64_t>(t0 + i) * D;
      carry = __fadd_rn(__fmul_rn(ra[i], carry), rg[i]);
      __stcs(dbp + off, carry);
      __stcs(dap + off, __fmul_rn(carry, rh[i]));
    }
    if (t0 > 0) {
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        ra[i] = na[i];
        rg[i] = ng[i];
        rh[i] = nh[i];
      }
    }
  }
}

}  // namespace

// The port's repro_ssm_scan_bwd contract: a, h, G, da, db (B, L, D) float32,
// contiguous. Returns cudaGetLastError() after the launch.
extern "C" int repro_ssm_scan_bwd_regs(const void* a, const void* h, const void* G, void* da,
                                       void* db, int B, int L, int64_t D, void* stream) {
  const int64_t blocks = (D + kThreads - 1) / kThreads;
  if (B <= 0 || B > 65535 || L <= 0 || D <= 0 || blocks > 0x7fffffff)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(B));
  ssm_scan_bwd_regs_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h), static_cast<const float*>(G),
      static_cast<float*>(da), static_cast<float*>(db), L, D);
  return cudaGetLastError();
}
