// Backward of the diagonal linear recurrence h_t = a_t * h_{t-1} + b_t for
// Hopper (sm_90a): one reverse-time pass over a, h and the upstream gradient.
//
// Replaces no Pallas kernel. The JAX package differentiates its oracle's
// associative scan by autodiff (src/repro/kernels/ssm_scan/ref.py:17, and
// the chunk scan of src/repro/nn/ssm.py:118 in mamba_fwd); the port's
// forward is csrc/ssm_scan.cu, and this kernel is the backward of its
// autograd Function (kernels/ssm_scan/ops.py::_LinearScan), written because
// composing the backward from the forward kernel over flipped, shifted
// copies moved 72 bytes an element where the function needs 20.
//
// For one (b, d) channel, t from L-1 down to 0, with a_L = 0, g_L = 0 and
// h_{-1} = 0:
//   g_t  = G_t + a_{t+1} * g_{t+1}   (__fmul_rn, then __fadd_rn)
//   db_t = g_t
//   da_t = g_t * h_{t-1}             (__fmul_rn)
// the roundings of the plain reverse loop (and of autograd through the
// plain forward loop), so da and db are its bits. a, h, G, da, db are
// (B, L, D) float32, contiguous. The shift is in the addressing: a_{t+1}
// and h_{t-1} are read at their own offsets, the two ends zero-filled, so
// nothing is flipped, shifted or padded in device memory. Any L and D: the
// ragged edge of D is masked, and the last (earliest) stage of L is
// clipped at t = 0.
//
// Bound: bytes. a, h and G are read once and da, db written once (20 bytes
// an element) for 3 flops. At hymba-1.5b's training shape (8, 128, 25,600)
// that is 524 MB, 0.1565 ms at 3.35 TB/s.
//
// Design: a ring in shared memory filled by cp.async. One thread owns one
// channel and carries g in a register; neighbouring threads own
// neighbouring d, so each copy and store of a warp is one coalesced
// 128-byte line. The ring holds kStages stages of kSteps time steps of
// a_{t+1}, G_t and h_{t-1}, laid out [stage][input][step][thread] so a
// warp's shared accesses are 32 consecutive words. Each thread fills its own
// column with 4-byte cp.async copies (the masked ends zero-filled by a
// source size of 0), one commit group a stage, and runs its chain out of the
// stage that cp.async.wait_group says has landed, while kStages - 1 later
// stages are in flight. A thread reads only what it copied, so the commit
// groups guard the stages and no barrier across threads (no mbarrier, no
// __syncthreads) is needed. The bytes in flight (288 a thread, ~150 KB an
// SM at 4 blocks of 48 KiB) cost no registers: ptxas gives 40. da and db go
// out with streaming stores, since nothing reads them again before the
// optimizer.
//
// Why this design: the other one, the forward's register pipeline run
// backward (3 x 8 loads a thread in registers, 72 registers), is
// tools/ssm_scan_bwd_designs.cu. tools/ssm_scan_bwd_designs.py times both
// at the training shape in turns in one call: on an NVIDIA H100 80GB HBM3
// at 700 W this ring took 0.1851 and 0.1861 device ms (0.84 of the bound),
// the register pipeline 0.1899 and 0.1904 (0.82).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSteps = 8;   // time steps a stage holds
constexpr int kStages = 4;  // stages in the ring: kStages - 1 in flight
constexpr int kRingBytes = kStages * 3 * kSteps * kThreads * 4;  // 48 KiB

__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__global__ void __launch_bounds__(kThreads)
    ssm_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                        const float* __restrict__ G, float* __restrict__ da,
                        float* __restrict__ db, int L, int64_t D) {
  extern __shared__ float ring[];
  const int tid = threadIdx.x;
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
  if (d >= D) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * L * D + d;
  const float* ap = a + base;
  const float* hp = h + base;
  const float* gp = G + base;
  float* dap = da + base;
  float* dbp = db + base;
  // stage k holds the steps [L - (k + 1) * kSteps, L - k * kSteps), clipped at 0
  const int stages = (L + kSteps - 1) / kSteps;

  auto issue = [&](int k) {
    float* slot = ring + (k % kStages) * 3 * kSteps * kThreads + tid;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int t = L - (k + 1) * kSteps + i;
      const int64_t off = static_cast<int64_t>(t) * D;
      const bool live = t >= 0;
      copy4(slot + (0 * kSteps + i) * kThreads, live && t + 1 < L ? ap + off + D : ap,
            live && t + 1 < L);
      copy4(slot + (1 * kSteps + i) * kThreads, live ? gp + off : gp, live);
      copy4(slot + (2 * kSteps + i) * kThreads, live && t > 0 ? hp + off - D : hp,
            live && t > 0);
    }
    commit();
  };

  for (int k = 0; k < kStages - 1; ++k) {
    if (k < stages)
      issue(k);
    else
      commit();  // empty groups keep the count of pending groups fixed
  }
  float carry = 0.f;  // g_{t+1}
  for (int k = 0; k < stages; ++k) {
    // the slot refilled here was read by this thread in the last iteration
    if (k + kStages - 1 < stages)
      issue(k + kStages - 1);
    else
      commit();
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    const float* slot = ring + (k % kStages) * 3 * kSteps * kThreads + tid;
#pragma unroll
    for (int i = kSteps - 1; i >= 0; --i) {
      const int t = L - (k + 1) * kSteps + i;
      if (t < 0) break;
      const int64_t off = static_cast<int64_t>(t) * D;
      carry = __fadd_rn(__fmul_rn(slot[(0 * kSteps + i) * kThreads], carry),
                        slot[(1 * kSteps + i) * kThreads]);
      __stcs(dbp + off, carry);
      __stcs(dap + off, __fmul_rn(carry, slot[(2 * kSteps + i) * kThreads]));
    }
  }
}

}  // namespace

// a, h, G, da, db: (B, L, D) float32, contiguous; da and db are written
// whole. Allocates nothing (the ring is the launch's dynamic shared memory).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a shape the grid cannot hold.
extern "C" int repro_ssm_scan_bwd(const void* a, const void* h, const void* G, void* da,
                                  void* db, int B, int L, int64_t D, void* stream) {
  const int64_t blocks = (D + kThreads - 1) / kThreads;
  if (B <= 0 || B > 65535 || L <= 0 || D <= 0 || blocks > 0x7fffffff)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(B));
  ssm_scan_bwd_kernel<<<grid, kThreads, kRingBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h), static_cast<const float*>(G),
      static_cast<float*>(da), static_cast<float*>(db), L, D);
  return cudaGetLastError();
}
