// Flash attention in bfloat16 on Hopper's tensor cores (sm_90a): TMA feeds
// the tiles, wgmma computes both products, warps are specialised.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::_flash_kernel (called through
// flash_attention, wrapped by kernels/flash_attention/ops.py::flash_mha) for
// bf16 inputs; float32 inputs go to flash_attention.cu.
//
// o[b, l, h] = softmax_s(mask(softcap(<q[b,l,h], k[b,s,h]> / sqrt(dh)))) . v[b,s,h]
// with the TPU kernel's constants: a masked logit is -1e30 (not -inf), the
// running max starts at -inf, the row sum is clamped at 1e-30, and KV tiles
// wholly outside the causal or window band are skipped (the TPU kernel's
// tile rule, with 128-row query tiles and BK-key tiles).
//
// Bound: operations. At the DiT verify shape (B*H = 512, L = S = 1024,
// dh = 64) the function does 4 * BH * L * S * dh = 137 GFLOP and moves
// 268 MB, far above the card's balance point, so the limit is the bf16
// tensor-core rate. The design:
//
// - One block of 384 threads per (b*h, 128-row query tile), launched with
//   the heaviest causal tiles first. Warpgroups 0 and 1 each own 64 query
//   rows and take 240 registers a thread (setmaxnreg.inc); warpgroup 2
//   gives its registers up (setmaxnreg.dec) and one of its threads starts
//   every TMA load.
// - TMA reads q, k, v in place through 4-D tensor maps over (dh, H, L, B)
//   built from the tensors' strides, so nothing is transposed or padded in
//   device memory. A tile is NCH chunks of 64 columns (128 bytes, the
//   128-byte swizzle); TMA zero-fills columns past dh and rows past L or S.
//   Q loads once; K and V go through a ring of kStages stages with full and
//   empty mbarriers. Producer and consumers walk one tile range
//   (kv_tile_range).
// - S = Q K^T: wgmma m64nBKk16, both operands K-major in shared memory,
//   float32 accumulators (bf16 products are exact in float32, so only the
//   order of the sum differs from the plain version).
// - The online softmax runs on the accumulator fragment in registers, in
//   the base-2 domain (logits times log2 e; ex2.approx), with quad shuffles
//   for the row max. Only tiles that cut the band edge, seq_k or the ragged
//   end are masked element by element; on the others the 1 / sqrt(dh) scale
//   folds into the exponent's FMA.
// - O += P V: wgmma m64n64k16 with A = P from registers (the S accumulator
//   fragment maps onto the A fragment without shuffles) and B = the V tile,
//   MN-major (dh is contiguous in v), read with the transpose bit. A single
//   bf16 rounding of P would move outputs by several bf16 ulps, so P is
//   split as P_hi = p truncated to bf16 (a byte permute) and
//   P_lo = bf16(p - P_hi) (exact remainder, rounded once), and two wgmmas
//   on the same V descriptor accumulate both: 6 * BH * L * S * dh
//   tensor-core operations in all, against the function's 4 * BH * L * S * dh.
// - The epilogue divides by max(l, 1e-30), rounds to bf16 and stores pairs
//   of columns straight from registers, masked at L and dh.
//
// Not done here (later work): ping-pong between the consumer warpgroups,
// softmax overlapped with the next Q K^T, persistent blocks.
//
// Head dims up to 256 (gemma2-9b's) take NCH = ceil(dh / 64) chunks, each
// its own instance; at NCH 4 the two consumer warpgroups split O's columns
// (kSplitO below). repro_flash_attention_wgmma_info reports each instance's
// local (spill) bytes, which chip_smoke.py requires to be 0. Shared memory
// at NCH 4: Q 32 KiB, K and V 2 x 2 x 32 KiB: 161 KiB of the 227 KiB a
// block may use.
//
// Requires: q, k, v bf16 with dh contiguous, base addresses and the batch,
// row and head strides multiples of 16 bytes, dh a multiple of 8 and at
// most 256. The wrapper checks these and raises; this entry refuses them.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;       // query rows per block (two consumer warpgroups; 64 at
                               // four chunks)
constexpr int kStages = 2;     // K/V ring depth
constexpr int kThreads = 384;  // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int kRowBytes = 128; // one 64-column chunk of a bf16 row
constexpr int kMaxDh = 256;    // four chunks
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskedLog2 = -1e30f * kLog2e;  // the TPU kernel's -1e30, in base 2

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spins until the phase of ``parity`` has completed. A wait that never ends
// (a producer and consumers out of step) traps after ~2^26 polls, so a
// fault shows as a launch error and not as a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 4-D tensor map (dh, H, L, B) into shared memory, completing
// on ``bar``
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units. The tile's base must be
// 1024-byte aligned (base offset 0).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// The descriptor of a tile ``off`` bytes past another's: the start address
// field is the low 14 bits (address / 16), and no shared address carries
// out of them.
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, uint32_t off) {
  return desc + (off >> 4);
}

// d itself, where kOn through a volatile move the compiler cannot hoist out
// of a loop. At three and four chunks each KV tile takes its descriptors
// from one such base: left to itself the compiler computes every (chunk,
// step) descriptor of both ring stages once, before the loop, and keeps them
// all in registers, which spilled there. At one and two chunks that hoisting
// fits and is faster (hymba's shape ran 5 % slower without it).
template <bool kOn>
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  if constexpr (kOn) asm volatile("mov.b64 %0, %0;\n" : "+l"(d));
  return d;
}

// The descriptor of the tile at addr + off: from the opaque base where
// kBase (three and four chunks), else computed whole (one and two).
template <bool kBase>
__device__ __forceinline__ uint64_t tile_desc(uint64_t base, uint32_t addr, uint32_t off,
                                              uint32_t lbo) {
  if constexpr (kBase) return desc_at(base, off);
  return sw128_desc(addr + off, lbo, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}


// d (64 x 128, float32) (+)= A (64 x 16, K-major in shared memory) . B (16 x 128,
// K-major in shared memory); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, float32) (+)= A (64 x 16, K-major in shared memory) . B (16 x 64,
// K-major in shared memory); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, float32) += A (64 x 16, bf16 fragments in registers) . B (16 x 64,
// MN-major in shared memory: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Keeps the compiler from moving reads or writes of a wgmma accumulator
// across the asynchronous instructions that own it.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x (ex2.approx: about 2 ulp; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);  // .x = the lower column
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- the kernel

struct Args {
  int H, Lq, Sk, dh, seq_k, causal, window;
  float softcap;
  int n_q_tiles;
  __nv_bfloat16* o;
  int64_t o_sb, o_sl, o_sh;
};

// Four chunks (dh > 192): a block takes 64 query rows, and its two consumer
// warpgroups split O's columns (two chunks each), each computing the same S
// and P for itself. With one warpgroup holding O's 128 floats a thread for
// all 256 columns beside S and P, ptxas spilled 392 bytes a thread (compiled
// at 168 registers, the count __launch_bounds__(384, 1) allows, although
// setmaxnreg grants the consumers 240 at run time; 32-key tiles spilled
// more). This way a consumer holds what it holds at two chunks, for twice
// the Q K^T products (the tensor cores' work is 8 * BH * L * S * dh, against
// 6 at fewer chunks).
template <int NCH>
constexpr bool kSplitO = NCH == 4;
template <int NCH>
constexpr int kRows = kSplitO<NCH> ? 64 : kBQ;      // query rows a block
template <int NCH>
constexpr int kOChunks = kSplitO<NCH> ? 2 : NCH;    // O chunks a warpgroup

// The KV tiles [lo, hi) a query tile of ``rows`` rows starting at q0
// visits: the TPU kernel's rule (skip a tile when k0 > q0 + rows - 1 under
// causal, or when q0 - (k0 + BK - 1) >= window). The producer and the
// consumers both call this, so their mbarrier phases walk the same tiles.
template <int BK, int rows>
__device__ __forceinline__ int2 kv_tile_range(int q0, const Args& a) {
  int hi = (a.Sk + BK - 1) / BK;
  if (a.causal) hi = min(hi, (q0 + rows - 1) / BK + 1);
  int lo = 0;
  if (a.window) {
    const int first_key = q0 - a.window - BK + 2;  // relevant iff k0 >= first_key
    if (first_key > 0) lo = (first_key + BK - 1) / BK;
  }
  return make_int2(lo, hi);
}

// Shared memory, from a 1024-byte aligned base: Q (NCH chunks of the
// block's rows), then kStages stages of K and of V (NCH chunks of BK rows
// each), then the mbarriers. Chunk c of a tile holds columns 64c .. 64c + 63,
// 128-byte swizzled by TMA.
template <int NCH, int BK>
struct Smem {
  static constexpr int kQ = NCH * kRows<NCH> * kRowBytes;
  static constexpr int kTile = NCH * BK * kRowBytes;  // one K or one V tile
  static constexpr int kK = kQ;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

// NCH: 64-column chunks of dh (1 for dh <= 64, 2 up to 128, 3 up to 192, 4 up
// to 256). BK: keys per tile.
template <int NCH, int BK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, const Args a) {
  using Lay = Smem<NCH, BK>;
  constexpr bool kBase = NCH >= 3;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + Lay::kK, sV = base + Lay::kV;
  const uint32_t full_bar = base + Lay::kBars;           // kStages barriers
  const uint32_t empty_bar = full_bar + 8 * kStages;   // kStages barriers
  const uint32_t q_bar = empty_bar + 8 * kStages;

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh - b * a.H;
  // heaviest causal tiles first: the last query tile visits the most keys
  const int qt = a.causal ? a.n_q_tiles - 1 - static_cast<int>(blockIdx.y)
                          : static_cast<int>(blockIdx.y);
  constexpr int kQRows = kRows<NCH>;
  const int q0 = qt * kQRows;
  const int2 range = kv_tile_range<BK, kQRows>(q0, a);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------------------------ producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_bar, Lay::kQ);
      for (int c = 0; c < NCH; ++c)
        tma_load_4d(sQ + c * kQRows * kRowBytes, &q_map, 64 * c, h, q0, b, q_bar);
      for (int t = range.x; t < range.y; ++t) {
        const int i = t - range.x, stage = i % kStages;
        const uint32_t parity = (i / kStages) & 1;
        mbar_wait(empty_bar + 8 * stage, parity ^ 1);
        const uint32_t fb = full_bar + 8 * stage;
        mbar_expect_tx(fb, 2 * Lay::kTile);
        for (int c = 0; c < NCH; ++c) {
          const uint32_t off = stage * Lay::kTile + c * BK * kRowBytes;
          tma_load_4d(sK + off, &k_map, 64 * c, h, t * BK, b, fb);
          tma_load_4d(sV + off, &v_map, 64 * c, h, t * BK, b, fb);
        }
      }
    }
  } else {
    // ------------------------------------------------ consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    // this warpgroup's first row, and its first O chunk
    const int qw0 = kSplitO<NCH> ? q0 : q0 + 64 * wg;
    const int oc0 = kSplitO<NCH> ? 2 * wg : 0;
    const int row0 = qw0 + 16 * warp + lane / 4;   // rows row0 and row0 + 8
    const int col_in = 2 * (lane % 4);             // + 8 j (+ 1): fragment columns

    // scores to the base-2 domain: x * (log2 e / sqrt(dh)) in one product
    // where sqrt(dh) is a power of two (dh = 16, 64, 256: exact, equal to
    // the plain version's division), else the division first. (Each
    // instance tests only its own head dims: a third runtime test cost the
    // one- and two-chunk instances 2-8 %.)
    const float sqrt_dh = sqrtf(static_cast<float>(a.dh));
    const bool pow2 = NCH == 4 ? a.dh == 256 : (a.dh == 16 || a.dh == 64);
    const float scale_log2 = kLog2e / sqrt_dh;

    constexpr int kOC = kOChunks<NCH>;
    float o[kOC][32];
#pragma unroll
    for (int c = 0; c < kOC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // running max (base 2) of rows row0, row0 + 8
    float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums

    mbar_wait(q_bar, 0);
    const uint32_t q_rows = kSplitO<NCH> ? sQ : sQ + 64 * wg * kRowBytes;

    for (int t = range.x; t < range.y; ++t) {
      const int i = t - range.x, stage = i % kStages;
      mbar_wait(full_bar + 8 * stage, (i / kStages) & 1);
      const int k0 = t * BK;
      const uint32_t k_tile = sK + stage * Lay::kTile, v_tile = sV + stage * Lay::kTile;

      // ---- S = Q K^T over dh in steps of 16 (4 per 64-column chunk)
      float s[BK / 2];
      const uint64_t q_desc = opaque<kBase>(sw128_desc(q_rows, 16, 1024));
      const uint64_t k_desc = opaque<kBase>(sw128_desc(k_tile, 16, 1024));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NCH; ++kk) {
        const uint32_t koff = (kk % 4) * 32;  // 16 bf16 columns
        const uint64_t da =
            tile_desc<kBase>(q_desc, q_rows, (kk / 4) * kQRows * kRowBytes + koff, 16);
        const uint64_t db =
            tile_desc<kBase>(k_desc, k_tile, (kk / 4) * BK * kRowBytes + koff, 16);
        if constexpr (BK == 128) wgmma_ss_n128(s, da, db, kk > 0);
        else wgmma_ss_n64(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(s);

      // ---- scores to the base-2 domain. Interior tiles without softcap
      // where sqrt(dh) is a power of two (the main paths) keep S raw and fold
      // the scale into the exponent's FMA (c = log2 e / sqrt(dh)); the rest
      // transform S in place (c = 1): the scale, the softcap, and the mask
      // on tiles that cut the band edge, seq_k or the ragged end.
      const bool edge = (k0 + BK > a.seq_k) || (a.causal && k0 + BK - 1 > qw0) ||
                        (a.window && (qw0 + 63) - k0 >= a.window);
      const bool folded = !edge && a.softcap == 0.f && pow2;
      const float c = folded ? scale_log2 : 1.f;
      if (!folded) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * j + e];
            if (a.softcap != 0.f) {
              x = pow2 ? x * (1.f / sqrt_dh) : x / sqrt_dh;
              x = a.softcap * tanhf(x / a.softcap) * kLog2e;
            } else {
              x = pow2 ? x * scale_log2 : (x / sqrt_dh) * kLog2e;
            }
            if (edge) {
              const int col = k0 + 8 * j + col_in + (e & 1);
              const int row = row0 + 8 * (e >> 1);
              bool ok = col < a.seq_k;
              if (a.causal) ok = ok && col <= row;
              if (a.window) ok = ok && (row - col) < a.window;
              x = ok ? x : kMaskedLog2;
            }
            s[4 * j + e] = x;
          }
        }
      }

      // ---- online softmax: each row lives on the 4 lanes of a quad
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[r], mx * c);
        // 0 from the initial -inf, and when a real key follows only masked ones
        alpha[r] = ex2(m_run[r] - m_new);
        m_run[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const float p0 = ex2(fmaf(s[4 * j + 2 * r], c, -m_new));
          const float p1 = ex2(fmaf(s[4 * j + 2 * r + 1], c, -m_new));
          s[4 * j + 2 * r] = p0;
          s[4 * j + 2 * r + 1] = p1;
          sum += p0 + p1;
        }
        l_run[r] = l_run[r] * alpha[r] + sum;
      }
#pragma unroll
      for (int cc = 0; cc < kOC; ++cc)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[cc][4 * j + 0] *= alpha[0];
          o[cc][4 * j + 1] *= alpha[0];
          o[cc][4 * j + 2] *= alpha[1];
          o[cc][4 * j + 3] *= alpha[1];
        }

      // ---- P = P_hi + P_lo as A fragments: keys 16 kk .. 16 kk + 15 are
      // accumulator blocks j = 2 kk and 2 kk + 1. P_hi is p truncated to
      // bf16 (its top 16 bits), P_lo the exact remainder rounded to bf16, so
      // P_hi + P_lo is p within 2^-16 of it.
      auto split_p = [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          // f: (row0, keys +0/1), (row0 + 8, +0/1), (row0, +8/9), (row0 + 8, +8/9)
          const int idx = 8 * kk + 4 * (f >> 1) + 2 * (f & 1);
          const uint32_t b0 = __float_as_uint(s[idx]), b1 = __float_as_uint(s[idx + 1]);
          hi[f] = __byte_perm(b0, b1, 0x7632);
          lo[f] = pack_bf16(s[idx] - __uint_as_float(b0 & 0xffff0000u),
                            s[idx + 1] - __uint_as_float(b1 & 0xffff0000u));
        }
      };

      // ---- O += P_hi V + P_lo V, V MN-major: 16 keys = 2048 bytes; this
      // warpgroup's chunks oc0 .. oc0 + kOC - 1 of V
      uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) split_p(kk, p_hi[kk], p_lo[kk]);
#pragma unroll
      for (int cc = 0; cc < kOC; ++cc) fence_operands(o[cc]);
      const uint64_t v_desc = opaque<kBase>(sw128_desc(v_tile, BK * kRowBytes, 1024));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int cc = 0; cc < kOC; ++cc) {
          const uint64_t dv = tile_desc<kBase>(
              v_desc, v_tile, (oc0 + cc) * BK * kRowBytes + kk * 16 * kRowBytes,
              BK * kRowBytes);
          wgmma_rs_n64(o[cc], p_hi[kk], dv);
          wgmma_rs_n64(o[cc], p_lo[kk], dv);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int cc = 0; cc < kOC; ++cc) fence_operands(o[cc]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * stage);
    }

    // ---- epilogue: o / max(l, 1e-30) to bf16, masked at Lq and dh
    float l_row[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l_row[r] = fmaxf(l, 1e-30f);
    }
    const int64_t ob = static_cast<int64_t>(b) * a.o_sb + static_cast<int64_t>(h) * a.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= a.Lq) continue;
      __nv_bfloat16* orow = a.o + ob + static_cast<int64_t>(row) * a.o_sl;
#pragma unroll
      for (int c = 0; c < kOC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * (oc0 + c) + 8 * j + col_in;
          if (col < a.dh)
            *reinterpret_cast<uint32_t*>(orow + col) =
                pack_bf16(o[c][4 * j + 2 * r] / l_row[r], o[c][4 * j + 2 * r + 1] / l_row[r]);
        }
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime so the
// library needs no link against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D map over (dh, H, L, B) of a bf16 tensor given by its element
// strides; boxes of 64 columns x 1 head x ``rows`` rows x 1 batch, 128-byte
// swizzle, zeros outside the tensor.
bool make_map(CUtensorMap* map, const void* ptr, int B, int H, int L, int dh, int64_t sb,
              int64_t sl, int64_t sh, int rows) {
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p, int64_t sb, int64_t sl, int64_t sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 && sl % 8 == 0 &&
         sh % 8 == 0 && sb > 0 && sl > 0 && sh > 0;
}

template <int NCH, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, int B, const Args& a,
                   int64_t q_sb, int64_t q_sl, int64_t q_sh, int64_t k_sb, int64_t k_sl,
                   int64_t k_sh, int64_t v_sb, int64_t v_sl, int64_t v_sh,
                   cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, B, a.H, a.Lq, a.dh, q_sb, q_sl, q_sh, kRows<NCH>) ||
      !make_map(&km, k, B, a.H, a.Sk, a.dh, k_sb, k_sl, k_sh, BK) ||
      !make_map(&vm, v, B, a.H, a.Sk, a.dh, v_sb, v_sl, v_sh, BK))
    return cudaErrorInvalidValue;
  const int smem = Smem<NCH, BK>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<NCH, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * a.H, a.n_q_tiles);
  flash_fwd_wgmma<NCH, BK><<<grid, kThreads, smem, stream>>>(qm, km, vm, a);
  return cudaGetLastError();
}

}  // namespace

// bf16 q (B, Lq, H, dh), k, v (B, Sk, H, dh) given by element strides with
// dh contiguous; o is written through its strides. Returns
// cudaErrorInvalidValue for what the kernel does not take (see the note at
// the top), else cudaGetLastError() after the launch.
extern "C" int repro_flash_attention_wgmma(
    const void* q, const void* k, const void* v, void* o, int B, int H, int Lq, int Sk,
    int dh, int64_t q_sb, int64_t q_sl, int64_t q_sh, int64_t k_sb, int64_t k_sl,
    int64_t k_sh, int64_t v_sb, int64_t v_sl, int64_t v_sh, int64_t o_sb, int64_t o_sl,
    int64_t o_sh, int causal, int window, float softcap, int seq_k, void* stream) {
  const int64_t BH = static_cast<int64_t>(B) * H;
  const int rows = dh > 192 ? kRows<4> : kBQ;
  const int64_t n_q_tiles = (static_cast<int64_t>(Lq) + rows - 1) / rows;
  if (B <= 0 || H <= 0 || Lq <= 0 || Sk <= 0 || dh <= 0 || dh > kMaxDh || dh % 8 != 0 ||
      BH > 2147483647 || n_q_tiles > 65535 || seq_k <= 0 || seq_k > Sk ||
      !aligned16(q, q_sb, q_sl, q_sh) || !aligned16(k, k_sb, k_sl, k_sh) ||
      !aligned16(v, v_sb, v_sl, v_sh) || reinterpret_cast<uintptr_t>(o) % 4 != 0)
    return cudaErrorInvalidValue;
  Args a{H, Lq, Sk, dh, seq_k, causal, window, softcap, static_cast<int>(n_q_tiles),
         static_cast<__nv_bfloat16*>(o), o_sb, o_sl, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(NCH, BK)                                                             \
  return launch<NCH, BK>(q, k, v, B, a, q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, \
                         v_sh, s)
  if (dh <= 64) REPRO_LAUNCH(1, 128);
  if (dh <= 128) REPRO_LAUNCH(2, 64);
  if (dh <= 192) REPRO_LAUNCH(3, 64);
  REPRO_LAUNCH(4, 64);
#undef REPRO_LAUNCH
}

// The launch configuration the kernel takes for head dim ``dh``: query rows
// and keys per tile, threads per block, dynamic shared memory bytes, the
// registers a thread is compiled to (setmaxnreg then moves 240 to each
// consumer thread and leaves 24 to each producer thread), and the local
// memory bytes a thread spills to (0 unless the instance spills).
template <int NCH, int BK>
cudaError_t info(int* rows, int* bk, int* smem_bytes, int* registers, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, flash_fwd_wgmma<NCH, BK>);
  *rows = kRows<NCH>;
  *bk = BK;
  *smem_bytes = Smem<NCH, BK>::kAlloc;
  *registers = err == cudaSuccess ? attr.numRegs : 0;
  *local_bytes = err == cudaSuccess ? static_cast<int>(attr.localSizeBytes) : 0;
  return err;
}

extern "C" int repro_flash_attention_wgmma_info(int dh, int* rows, int* bk, int* threads,
                                                int* smem_bytes, int* registers,
                                                int* local_bytes) {
  *threads = kThreads;
  if (dh <= 0 || dh > kMaxDh) return cudaErrorInvalidValue;
  if (dh <= 64) return info<1, 128>(rows, bk, smem_bytes, registers, local_bytes);
  if (dh <= 128) return info<2, 64>(rows, bk, smem_bytes, registers, local_bytes);
  if (dh <= 192) return info<3, 64>(rows, bk, smem_bytes, registers, local_bytes);
  return info<4, 64>(rows, bk, smem_bytes, registers, local_bytes);
}
