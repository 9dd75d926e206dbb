// Diagonal linear recurrence h_t = a_t * h_{t-1} + b_t for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan/kernel.py::
// _scan_kernel (called through ssm_scan, wrapped by ops.py::linear_scan;
// here wrapped by kernels/ssm_scan/ops.py::linear_scan). It is the selective
// scan of the mamba mixer: a = exp(dt * A) and b = (dt * x) * B over the
// (B, L, din * N) channels of one layer.
//
// a, b, h are (B, L, D) float32, contiguous. The carry is float32 with
// h_{-1} = 0, and each step rounds twice, a * h then + b (no FMA
// contraction: __fmul_rn and __fadd_rn), as the plain PyTorch loop does, so
// the kernel gives the plain version's bits. Any L and D: the ragged edge of
// D is masked, the tail of L runs one step at a time; nothing is padded.
//
// Bound: bytes. Every element of a and b is read once and of h written once
// (12 bytes) for 2 flops. At the hymba-1.5b prefill shape (2, 4096, 25,600)
// that is 2.52 GB, 0.75 ms at 3.35 TB/s. The TPU kernel carries the state
// across a sequential grid axis in VMEM; here one thread owns one (b, d)
// channel and loops over t, so the carry stays in a register and nothing
// crosses blocks. Neighbouring threads own neighbouring d, so every load and
// store of a warp is one coalesced 128-byte line. The recurrence is a
// dependent chain, so bytes in flight come from software pipelining: each
// thread loads the next kUnroll steps of a and b while it runs the chain of
// the current kUnroll (2 * 16 loads of 4 bytes a thread in flight), which
// at 51,200 channels keeps about 6.5 MB in flight on the card. A chunked
// two-pass scan (per-chunk scans, then carries across chunks) would fill
// the card at fewer channels; that is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;  // 800 blocks at the prefill shape: ~6 per SM
constexpr int kUnroll = 16;   // time steps whose loads a thread keeps in flight

__global__ void __launch_bounds__(kThreads)
    ssm_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ h, int L, int64_t D) {
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (d >= D) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * L * D + d;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;

  float carry = 0.f;
  const int full = L - L % kUnroll;
  float ra[kUnroll], rb[kUnroll];
  if (full > 0) {
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      ra[i] = ap[i * D];
      rb[i] = bp[i * D];
    }
  }
  for (int t0 = 0; t0 < full; t0 += kUnroll) {
    const int t1 = t0 + kUnroll;
    float na[kUnroll], nb[kUnroll];
    if (t1 < full) {  // the next group's loads go out before this group's chain
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        na[i] = ap[static_cast<int64_t>(t1 + i) * D];
        nb[i] = bp[static_cast<int64_t>(t1 + i) * D];
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      carry = __fadd_rn(__fmul_rn(ra[i], carry), rb[i]);
      hp[static_cast<int64_t>(t0 + i) * D] = carry;
    }
    if (t1 < full) {
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        ra[i] = na[i];
        rb[i] = nb[i];
      }
    }
  }
  for (int t = full; t < L; ++t) {
    const int64_t off = static_cast<int64_t>(t) * D;
    carry = __fadd_rn(__fmul_rn(ap[off], carry), bp[off]);
    hp[off] = carry;
  }
}

}  // namespace

// a, b, h: (B, L, D) float32, contiguous. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a shape the grid cannot hold.
extern "C" int repro_ssm_scan(const void* a, const void* b, void* h, int B, int L,
                              int64_t D, void* stream) {
  const int64_t blocks = (D + kThreads - 1) / kThreads;
  if (B <= 0 || B > 65535 || L <= 0 || D <= 0 || blocks > 0x7fffffff)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(B));
  ssm_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(h), L,
      D);
  return cudaGetLastError();
}
