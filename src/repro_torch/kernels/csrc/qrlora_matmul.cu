// One-λ QR-LoRA matmul for Hopper (sm_90a): the forward of the trainable
// adapted projection, and its twin on a quantized base.
//
//   y[m, n] = Σ_k x[m,k]·W[k,n] + Σ_j P'[m,j]·A[j,n]
//   P'[m, j] = scale · λ[j] · Σ_k x[m,k]·B[k,j]
//
// Replaces repro/kernels/qrlora_matmul.py::qrlora_matmul_kernel (_kernel)
// and ::qrlora_matmul_quant_kernel (_kernel_q).  Those TPU kernels keep x·B
// in a (bm, r) scratch across the in-order n-steps of a row block; blocks of
// a CUDA grid run in no order, so the low-rank projection is a launch of its
// own (the P pass) and the main pass reads its result.
//
// Bound on the card: at the training shapes (M = 2048 rows, K = 576,
// N = 576 for wq, r = 128) the work is 2·M·K·(N + r) + 2·M·r·N ≈ 1.96 GFLOP
// against ≈ 5.7 MB moved: ≈ 2.0 µs of bf16 tensor-core operations at
// 989 TFLOP/s; wv (N = 192) is bound by its ≈ 3.6 MB (≈ 1.1 µs at
// 3.35 TB/s).  A 64-row scoring forward is bound by nothing but latency
// (0.23 µs of bytes): its time is the chain of dependent loads and launches.
//
// What the design does about it (bf16 x):
//  * Everything runs on the tensor cores.  The P pass writes P' with scale
//    folded in, split into two bf16 halves, P_hi = bf16(P') and P_lo =
//    bf16(P' − P_hi): A is bf16, so P_hi·A and P_lo·A are exact products,
//    and the pair keeps ≈ 16 bits of P' (a single bf16 P' would move y by
//    up to 2⁻⁹ of the adapter term).  The main pass is one K loop of depth
//    K + 2r over [x | P_hi | P_lo] against [W ; A ; A] into one fp32
//    accumulator; no CUDA-core epilogue is left.  P_hi and P_lo together
//    are the bytes of an fp32 P, so the wrapper's (M, r) fp32 scratch holds
//    them.
//  * wgmma (m64nBNk16, bf16 × bf16 → fp32) reads both operands from shared
//    memory, where TMA (cp.async.bulk.tensor) lays the tiles in the 128-byte
//    swizzle: x and P tiles K-major, W and A tiles N-major (a row-major
//    (K, N) matrix is read as it lies).  A ring of STAGES tiles is tracked
//    by mbarriers: one producer thread keeps the loads in flight, the
//    consumer warpgroup multiplies with one step's products in flight, and
//    the accumulator stays in registers through the epilogue, which writes
//    y in x's dtype.  Rows past M, and
//    columns past N, K or r, arrive as zeros (TMA fills outside the
//    tensor) and are never written: a ragged M needs no padded copy of x.
//  * The two launches overlap (programmatic dependent launch): the P pass
//    lets the main pass start at once, and the main pass runs its x·W steps
//    first and waits for the P pass (griddepcontrol.wait) only before its
//    first P step, so its x·W work fills the SMs the P pass leaves idle.
//  * Few output tiles (a 64-row forward: 9 tiles at wq, 3 at wv, 2 in its
//    P pass) split K over a thread-block cluster of 8 CTAs: some ranks take
//    x·W steps, the others P steps, and the partial tiles are summed in
//    rank order through distributed shared memory, so y is bitwise the
//    same from call to call.  Only a full split of every tile within one
//    wave is taken: on the card, splits over 2 or 4 ranks lost to both.
//  * Tiles are 64 × 64 (one consumer warpgroup).  Timed on the card
//    against 128 × 64 (two warpgroups sharing each W tile), 64 × 192 and
//    128 × 192: 64 × 192 took the bf16 wq projection at 2048 rows by 6%
//    and lost bf16 wv by 21% and the int8/fp8 shapes by 14-33%; the two
//    128-row tiles lost or tied at every shape (PERF.md has the times).
//    At 2048 rows the main pass reads ≈ 56 MB from L2 at wq (each x tile
//    once per column tile, each W tile once per row tile), ≈ 5.6 TB/s over
//    its profiled ≈ 10 µs; a 64-row forward is the chain of two launches
//    and their dependent loads.
//
// Quantized base: q (K, N) is int8 or fp8-e4m3 with a per-column w_scale,
//   y[m, n] = (Σ_k x[m,k]·q[k,n]) · w_scale[n] + Σ_j P'[m,j]·A[j,n],
// the full x·q sum multiplied by w_scale and rounded in fp32 before any
// adapter product is added (the reference's order).  wgmma takes no
// bf16 × 1-byte product, so q arrives raw by TMA and a widening warpgroup
// converts each tile to bf16 (exact for int8 and e4m3) in the swizzled
// layout the consumer reads, one stage ahead of it in the ring; nothing
// waits behind a block-wide barrier.  The consumer scales its accumulator
// by w_scale once the x·q steps are done and then runs the P steps into
// it; split over a cluster, the x·q ranks' and the P ranks' partials are
// summed separately and joined in the same order.
//
// float32 x keeps the CUDA-core path: a P pass writing fp32 P = (x·B) ⊙ λ,
// then a tiled main pass adding scale · P·A in an fp32 epilogue, so the
// float32 checks stay tight.  Forward only, as in the reference.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached at run time
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "cluster.cuh"
#include "widen.cuh"

namespace {

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

using bf16 = __nv_bfloat16;
using fp8 = __nv_fp8_e4m3;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f(fp8 v) { return static_cast<float>(v); }

// ---------------------------------------------------------------------------
// The tensor-core route (bf16 x): TMA, mbarriers, wgmma, clusters.
// ---------------------------------------------------------------------------

constexpr int TK = 64;       // depth of a K step: one 128-byte swizzled row of bf16
constexpr int STAGES = 4;    // the ring's depth
constexpr int TM = 64;       // rows of an output tile: one wgmma M, one consumer warpgroup
constexpr int BN = 64;       // columns of an output tile (both passes): one 64 × 64 TMA box
constexpr int CONSUMERS = 128;   // the consumer warpgroup
constexpr int MAX_CLUSTER = 8;   // the portable cluster size: the most CTAs a K loop takes
constexpr int BOX_BYTES = TK * BN * 2;  // one 64 × 64 bf16 TMA box (8 KB)

// The shared memory of a CTA whose W is of type TW (bf16, or 1-byte q).
template <typename TW>
struct Plan {
  static constexpr bool kQuant = sizeof(TW) == 1;
  static constexpr int kWideners = kQuant ? 128 : 0;  // the widening warpgroup
  static constexpr int kThreads = CONSUMERS + kWideners + 32;  // + the producer warp
  static constexpr int kXBytes = TM * TK * 2;          // x or P tile
  static constexpr int kWBytes = TK * BN * 2;          // W or A tile (bf16)
  static constexpr int kQBytes = kQuant ? TK * BN : 0; // raw q tile
  static constexpr int kStage = kXBytes + kWBytes + kQBytes;
  static constexpr int kPart = BN / 2 * CONSUMERS * 4;  // a split-K partial tile, fp32
  static constexpr int kBars = cmax(STAGES * kStage, kPart);
  static constexpr int kSmem = kBars + 3 * STAGES * 8 + 1024;  // + alignment slack
  static_assert(kStage % 1024 == 0, "stages keep the 1024-byte swizzle alignment");
};

// The K steps a CTA runs: g = first, first + stride, … < end.  Step g is
// x·W over K-columns [g·TK, g·TK + TK) for g < nkx, else P step j = g − nkx.
// A lone CTA (cs = 1) walks all nkx + 2·nkr; in a cluster, ranks < ranks_x
// stride over the x steps and the others over the P steps.
struct Steps {
  int first, stride, end;
};
__host__ __device__ __forceinline__ Steps rank_steps(int rank, int cs, int ranks_x, int nkx, int nkr) {
  if (cs == 1) return {0, 1, nkx + 2 * nkr};
  if (rank < ranks_x) return {rank, ranks_x, nkx};
  return {nkx + rank - ranks_x, cs - ranks_x, nkx + 2 * nkr};
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One 2-D TMA load of the box at (c0 inner, c1 outer) into shared memory,
// completing on the mbarrier `bar`.
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, "
      "%4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptors, 128-byte swizzle (layout type 1):
// start address, leading and stride byte offsets, each in 16-byte units.
// K-major (x, P): 8-row groups 1024 bytes apart (SBO); a k16 slice starts
// 32 bytes further along the swizzled row.  N-major (W, A): one TMA box
// holds the tile's 64 columns × 64 K-rows, 8-row groups 1024 bytes apart
// (SBO; the LBO, a box apart, would step to a next 64 columns); a k16
// slice is 16 rows, 2048 bytes, further.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all_but_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// d += a·b for a 64 × 16 K-major a and a 16 × 64 N-major b (imm-trans-b = 1),
// both from shared memory.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

struct Args {
  const float* lam;      // P pass: λ (r,)
  const float* w_scale;  // quantized main pass: (N,)
  bf16* out;             // main pass: y (M, N); P pass: P_hi (M, r)
  bf16* out_lo;          // P pass: P_lo (M, r)
  int M, N;              // output rows and columns (N is r in the P pass)
  int nkx, nkr;          // K steps over x (⌈K/TK⌉) and over each P half (⌈r/TK⌉)
  int ranks_x;           // cluster ranks on x steps (the rest take P steps)
  float scale;
};

// Two adjacent outputs (row, col), (row, col + 1) of a finished fp32 tile:
// y in bf16 (main pass), or P' = acc · (scale·λ) split into its bf16
// halves (P pass).
template <bool kPPass>
__device__ __forceinline__ void store_pair(const Args& a, int row, int col, float v0, float v1) {
  if (row >= a.M || col >= a.N) return;
  const size_t at = static_cast<size_t>(row) * a.N + col;
  if constexpr (kPPass) {
    const float p0 = __fmul_rn(v0, __fmul_rn(a.scale, a.lam[col]));
    const float p1 = __fmul_rn(v1, __fmul_rn(a.scale, a.lam[col + 1]));
    const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
    *reinterpret_cast<__nv_bfloat162*>(a.out + at) = hi;
    *reinterpret_cast<__nv_bfloat162*>(a.out_lo + at) = __floats2bfloat162_rn(
        __fsub_rn(p0, __low2float(hi)), __fsub_rn(p1, __high2float(hi)));
  } else {
    *reinterpret_cast<__nv_bfloat162*>(a.out + at) = __floats2bfloat162_rn(v0, v1);
  }
}

// The wgmma accumulator of thread t of a warpgroup (0 ≤ t < 128): warp
// w = t/32 holds rows 16w + lane/4 (h = 0) and + 8 (h = 1); for each
// 8-column chunk i it holds the columns 8i + 2·(lane % 4) + {0, 1} as
// d[4i + 2h + {0, 1}].
__device__ __forceinline__ int frag_row(int t, int h) { return 16 * (t / 32) + (t % 32) / 4 + 8 * h; }
__device__ __forceinline__ int frag_col(int t, int i) { return 8 * i + 2 * (t % 4); }

// The full x·q sum of a lone CTA's tile times w_scale, rounded in fp32,
// before any adapter product is added to it.  The thread's 16 scales are
// loaded before the wait, so the loads are in flight together and under
// the last x·q products (issued one after another, they cost ≈ 6% of the
// 2048-row quantized projection on the card).
__device__ __forceinline__ bool dequant(float (&acc)[BN / 2], const Args& a, int n0, int t) {
  float w[BN / 4];
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + frag_col(t, i) + e;
      w[2 * i + e] = n < a.N ? __ldg(a.w_scale + n) : 0.f;
    }
  wgmma_wait_all();  // the last x·q products have landed
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      acc[4 * i + e] = __fmul_rn(acc[4 * i + e], w[2 * i + e]);
      acc[4 * i + 2 + e] = __fmul_rn(acc[4 * i + 2 + e], w[2 * i + e]);
    }
  return true;
}

// One (TM × BN) output tile, or a cluster rank's share of it (blockIdx.x =
// tile column · cluster size + rank, blockIdx.y = tile row), over the steps
// of rank_steps.  The P step j is P_hi (j < nkr) or P_lo over ranks
// [(j mod nkr)·TK, +TK) against the same rows of A.
// kPPass: W is B, there are no P steps, and the epilogue writes P_hi/P_lo.
template <typename TW, bool kPPass>
__global__ void __launch_bounds__(Plan<TW>::kThreads)
tc_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
          const __grid_constant__ CUtensorMap tm_phi, const __grid_constant__ CUtensorMap tm_plo,
          const __grid_constant__ CUtensorMap tm_a, const Args args) {
  using L = Plan<TW>;
  constexpr bool kQuant = L::kQuant;
  static_assert(!(kQuant && kPPass), "the P pass multiplies by B, never by q");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t full0 = smem_u32(smem + L::kBars), wide0 = full0 + 8 * STAGES,
                 empty0 = wide0 + 8 * STAGES;
  if constexpr (kPPass)  // the main pass may launch now; it waits for P where it reads it
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);               // the producer's expect_tx, then the bytes
      mbar_init(wide0 + 8 * s, cmax(L::kWideners, 1));  // every widening thread
      mbar_init(empty0 + 8 * s, CONSUMERS);      // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const uint32_t cs = cluster_size(), rank = cluster_rank();
  const int m0 = blockIdx.y * TM, n0 = (blockIdx.x / cs) * BN;
  const Steps steps = rank_steps(rank, cs, args.ranks_x, args.nkx, args.nkr);
  const int first = steps.first, stride = steps.stride, end = steps.end;

  if (tid >= CONSUMERS + L::kWideners) {
    // ---- producer: one thread keeps the ring's loads in flight ----
    if (tid == CONSUMERS + L::kWideners) {
      const CUtensorMap* maps[5] = {&tm_x, &tm_w, &tm_phi, &tm_plo, &tm_a};
#pragma unroll
      for (int i = 0; i < 5; ++i)  // fetch the descriptors ahead of their first use
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(maps[i])) : "memory");
      bool waited = false;
      for (int g = first, it = 0; g < end; g += stride, ++it) {
        const int s = it % STAGES;
        mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);  // the first round passes
        unsigned char* st = smem + s * L::kStage;
        const uint32_t bar = full0 + 8 * s, xs = smem_u32(st), ws = xs + L::kXBytes;
        if (g < args.nkx) {
          const int k0 = g * TK;
          mbar_expect_tx(bar, L::kXBytes + (kQuant ? L::kQBytes : L::kWBytes));
          tma_2d(xs, &tm_x, bar, k0, m0);
          tma_2d(kQuant ? ws + L::kWBytes : ws, &tm_w, bar, n0, k0);
        } else {
          if (!waited) {  // P is the P pass's output: wait for that grid here, and only here
            asm volatile("griddepcontrol.wait;\n" ::: "memory");
            waited = true;
          }
          const int j = g - args.nkx, c0 = (j % args.nkr) * TK;
          mbar_expect_tx(bar, L::kXBytes + L::kWBytes);
          tma_2d(xs, j < args.nkr ? &tm_phi : &tm_plo, bar, c0, m0);
          tma_2d(ws, &tm_a, bar, n0, c0);
        }
      }
    }
  } else if (tid >= CONSUMERS) {
    // ---- widening warpgroup: raw q tile → bf16 W tile, swizzled as TMA
    // would lay it (row k: 16-byte chunk c at c ^ (k % 8))
    if constexpr (kQuant) {
      const int wt = tid - CONSUMERS;
      for (int g = first, it = 0; g < end && g < args.nkx; g += stride, ++it) {
        const int s = it % STAGES;
        mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
        unsigned char* st = smem + s * L::kStage;
        const unsigned char* q = st + L::kXBytes + L::kWBytes;
        unsigned char* w = st + L::kXBytes;
#pragma unroll
        for (int u = wt; u < TK * BN / 16; u += L::kWideners) {
          const int k = u / (BN / 16), cg = u % (BN / 16), c = 2 * cg;
          uint4 lo, hi;
          widen16<TW>(*reinterpret_cast<const uint4*>(q + k * BN + 16 * cg), lo, hi);
          unsigned char* row = w + k * 128;
          *reinterpret_cast<uint4*>(row + ((c ^ (k & 7)) << 4)) = lo;
          *reinterpret_cast<uint4*>(row + (((c + 1) ^ (k & 7)) << 4)) = hi;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
        mbar_arrive(wide0 + 8 * s);
      }
    }
  } else {
    // ---- consumer warpgroup: wgmma over the ring, accumulator in registers ----
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    bool scaled = !kQuant || cs > 1;  // a split tile is scaled where the ranks' sums meet
    int held = -1;  // the stage whose products may still be in flight
    for (int g = first, it = 0; g < end; g += stride, ++it) {
      const int s = it % STAGES;
      const uint32_t ph = (it / STAGES) & 1;
      mbar_wait(full0 + 8 * s, ph);
      if constexpr (kQuant) {
        if (g < args.nkx)
          mbar_wait(wide0 + 8 * s, ph);
        else if (!scaled)
          scaled = dequant(acc, args, n0, tid);
      }
      __syncwarp();
      const uint32_t xs = smem_u32(smem + s * L::kStage), ws = xs + L::kXBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        wgmma_n64(acc, sw128_desc(xs + 32 * kk, 16), sw128_desc(ws + 2048 * kk, BOX_BYTES));
      wgmma_commit();
      wgmma_wait_all_but_one();  // the previous step's products have landed: free its stage
      if (held >= 0) mbar_arrive(empty0 + 8 * held);
      held = s;
    }
    wgmma_wait_all();
    if (held >= 0) mbar_arrive(empty0 + 8 * held);
    if (!scaled) scaled = dequant(acc, args, n0, tid);
    if (cs == 1) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store_pair<kPPass>(args, m0 + frag_row(tid, h), n0 + frag_col(tid, i), acc[4 * i + 2 * h],
                             acc[4 * i + 2 * h + 1]);
    } else {  // this rank's partial tile, register-major, for the cluster's sum
      float* part = reinterpret_cast<float*>(smem);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) part[i * CONSUMERS + tid] = acc[i];
    }
  }

  if (cs > 1) {
    __syncwarp();
    cluster_sync();  // every rank's partial is in its shared memory
    if (tid < CONSUMERS) {
      // rank c finishes the register pairs p ≡ c (mod cs), summing the ranks'
      // partials in rank order: the x steps' ranks, then the P steps' ranks
      const float* part = reinterpret_cast<const float*>(smem);
      for (int p = rank; p < BN / 4; p += cs) {
        const int i = p / 2, h = p % 2, reg = 4 * i + 2 * h;
        float x0 = 0.f, x1 = 0.f, p0 = 0.f, p1 = 0.f;
        for (int c = 0; c < static_cast<int>(cs); ++c) {
          const float v0 = ld_cluster(part + reg * CONSUMERS + tid, c);
          const float v1 = ld_cluster(part + (reg + 1) * CONSUMERS + tid, c);
          if (c < args.ranks_x) {
            x0 = __fadd_rn(x0, v0), x1 = __fadd_rn(x1, v1);
          } else {
            p0 = __fadd_rn(p0, v0), p1 = __fadd_rn(p1, v1);
          }
        }
        const int row = m0 + frag_row(tid, h), col = n0 + frag_col(tid, i);
        if constexpr (kQuant) {
          if (col < args.N) {  // dequant rounded first, then the adapter term
            x0 = __fmul_rn(x0, args.w_scale[col]);
            x1 = __fmul_rn(x1, args.w_scale[col + 1]);
          }
        }
        store_pair<kPPass>(args, row, col, __fadd_rn(x0, p0), __fadd_rn(x1, p1));
      }
    }
    cluster_sync();  // no rank leaves while another still reads its shared memory
  }
}

// ---- host side of the tensor-core route ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point: no link
// against libcuda.  Looked up once.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                       : nullptr;
  }();
  return fn;
}

// A row-major (rows × cols) matrix, rows `ld` elements apart (ld ≥ cols: a
// column slice of a wider matrix), read in (box_rows × box_cols) boxes;
// bf16 boxes of 64 columns in the 128-byte swizzle, 1-byte boxes as they lie.
bool tensor_map(CUtensorMap* map, const void* base, bool bf16_elems, int rows, int cols,
                int box_rows, int box_cols, int ld = 0) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const int bytes = bf16_elems ? 2 : 1;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld > 0 ? ld : cols) * bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return enc(map, bf16_elems ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
             const_cast<void*>(base), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             bf16_elems ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Split {
  int ranks, ranks_x;  // cluster size; ranks on x steps
};

// Split K over a cluster only where every tile can take the full cluster
// (up to MAX_CLUSTER ranks, no more than there are steps) within one wave
// of the SMs, the P steps' share of the ranks in proportion to their count.
// Timed on the card: at 64 rows the full split gains ≈ 1.5% over none,
// splits over 2 or 4 ranks lose to both, and a split P pass at 2048 rows
// (64 tiles over 2 ranks) loses to the unsplit one.
Split plan_split(int tiles, int nkx, int nkr, int sms) {
  const int steps = nkx + 2 * nkr, cs = std::min(MAX_CLUSTER, steps);
  if (cs < 2 || tiles * cs > sms) return {1, 1};
  if (nkr == 0) return {cs, cs};
  const int rp = std::max(1, std::min((cs * 2 * nkr + steps / 2) / steps, std::min(2 * nkr, cs - 1)));
  const int rx = std::min(cs - rp, nkx);
  return {rx + rp, rx};
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms;
}

template <typename TW, bool kPPass>
cudaError_t launch_tile_kernel(const CUtensorMap& tx, const CUtensorMap& tw, const CUtensorMap& tph,
                               const CUtensorMap& tpl, const CUtensorMap& ta, const Args& args,
                               Split split, int tiles_m, int tiles_n, bool after_p_pass,
                               cudaStream_t stream) {
  using L = Plan<TW>;
  auto* kernel = tc_kernel<TW, kPPass>;
  // on every launch: the attribute holds for the current device only
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = split.ranks;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  // programmatic dependent launch: may start while the P pass still runs
  at[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split.ranks * tiles_n, tiles_m, 1);
  cfg.blockDim = dim3(L::kThreads, 1, 1);
  cfg.dynamicSmemBytes = L::kSmem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = after_p_pass ? 2 : 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, tx, tw, tph, tpl, ta, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// bf16 x: the P pass into P (as P_hi then P_lo, bf16 (M, r) each), then
// the main pass over W (bf16) or q (int8/fp8, with w_scale).
template <typename TW>
int launch_tc(const void* x, const void* W, const float* w_scale, const void* B, const void* A,
              const float* lam, void* P, void* y, int M, int K, int N, int r, int ldw, int lda,
              float scale, cudaStream_t stream) {
  if (M == 0 || N == 0) return 0;
  if (K == 0) return static_cast<int>(cudaErrorInvalidValue);
  bf16* p_hi = static_cast<bf16*>(P);
  bf16* p_lo = p_hi + static_cast<size_t>(M) * r;
  CUtensorMap tx, tw, tb, tph, tpl, ta;
  bool ok = tensor_map(&tx, x, true, M, K, TM, 64) &&
            (sizeof(TW) == 1 ? tensor_map(&tw, W, false, K, N, TK, BN, ldw)
                             : tensor_map(&tw, W, true, K, N, TK, 64, ldw));
  if (r > 0)
    ok = ok && tensor_map(&tb, B, true, K, r, TK, 64) && tensor_map(&tph, p_hi, true, M, r, TM, 64) &&
         tensor_map(&tpl, p_lo, true, M, r, TM, 64) && tensor_map(&ta, A, true, r, N, TK, 64, lda);
  else
    tb = tph = tpl = ta = tx;  // never read
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count(), nkx = ceil_div(K, TK), nkr = ceil_div(r, TK), tiles_m = ceil_div(M, TM);
  if (r > 0) {
    const int tiles_n = ceil_div(r, BN);
    const Split split = plan_split(tiles_m * tiles_n, nkx, 0, sms);
    const Args pa = {lam, nullptr, p_hi, p_lo, M, r, nkx, 0, split.ranks_x, scale};
    const cudaError_t err = launch_tile_kernel<bf16, true>(tx, tb, tb, tb, tb, pa, split, tiles_m, tiles_n,
                                                       false, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles_n = ceil_div(N, BN);
  const Split split = plan_split(tiles_m * tiles_n, nkx, nkr, sms);
  const Args ma = {nullptr, w_scale, static_cast<bf16*>(y), nullptr, M, N, nkx, nkr, split.ranks_x, scale};
  return static_cast<int>(
      launch_tile_kernel<TW, false>(tx, tw, tph, tpl, ta, ma, split, tiles_m, tiles_n, r > 0, stream));
}

// ---------------------------------------------------------------------------
// The CUDA-core route (float32 x): fp32 tiles, fp32 P, fp32 epilogue.
// ---------------------------------------------------------------------------

// 64×64 output tile, 32-deep K steps, 128 threads.  Thread t owns the 8
// contiguous rows 8·(t/16) … and the 4 contiguous columns 4·(t%16) … of the
// tile, so the loops read their operands as 16-byte shared loads.
constexpr int BM = 64, BN32 = 64, BK = 32, RC = 32, THREADS = 128;
constexpr int ROWS_PER_T = BM / (THREADS / 16), COLS_PER_T = BN32 / 16;
constexpr int XLD32 = BK + 1, PTLD = BM + 4;

static_assert(ROWS_PER_T == 8 && COLS_PER_T == 4, "the fp32 loops read 8 rows and 4 columns");
static_assert(BM * BK % THREADS == 0 && BK * BN32 % THREADS == 0 && BM * RC % THREADS == 0 &&
                  RC * BN32 % THREADS == 0,
              "tiles split evenly over the block's threads");

// One shared buffer, reused phase by phase: the main loop's x and W tiles,
// then the epilogue's P and A chunks.
constexpr int SMEM_BYTES = cmax((BM * XLD32 + BK * BN32) * 4, (RC * PTLD + RC * BN32) * 4);

// Stage a (ROWS × COLS) tile of a row-major (rows × cols) matrix whose
// rows lie `ld` elements apart, starting at (r0, c0), into dst (leading
// dimension LD) as float, zero-filled past the edges.  The trip count is a
// constant, so a thread's loads are all in flight at once.
template <int ROWS, int COLS, int LD, typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int r0, int c0, int rows,
                                      int cols, int ld) {
#pragma unroll
  for (int t = 0; t < ROWS * COLS / THREADS; ++t) {
    const int i = t * THREADS + threadIdx.x;
    const int rr = i / COLS, cc = i % COLS, gr = r0 + rr, gc = c0 + cc;
    dst[rr * LD + cc] = (gr < rows && gc < cols) ? to_f(src[(size_t)gr * ld + gc]) : 0.f;
  }
}

// Stage the (ROWS × COLS) tile of a row-major fp32 matrix at (r0, c0)
// transposed: dst[c · LD + r] (global reads stay coalesced along a row).
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void stage_transposed(float* dst, const float* __restrict__ src, int r0,
                                                 int c0, int rows, int cols) {
#pragma unroll
  for (int t = 0; t < ROWS * COLS / THREADS; ++t) {
    const int i = t * THREADS + threadIdx.x;
    const int rr = i / COLS, cc = i % COLS, gr = r0 + rr, gc = c0 + cc;
    dst[cc * LD + rr] = (gr < rows && gc < cols) ? src[(size_t)gr * cols + gc] : 0.f;
  }
}

__device__ __forceinline__ float4 lds4(const float* p) { return *reinterpret_cast<const float4*>(p); }

enum Epilogue {
  kScaleColumns = 0,  // out[m,n] = (x·W)[m,n] · v[n]                      (pass 1: P)
  kAddLowRank = 1,    // out[m,n] = (x·W)[m,n] + scale · Σ_j P[m,j]·A[j,n]  (pass 2: y)
};

// C = x·W for one (BM × BN32) tile of the (M × N) output, x (M × K) fp32,
// W (K × N, rows ldw apart) of TW widened to fp32, then the epilogue EPI
// (A's rows lda apart).  `aux` is v (N,)
// for kScaleColumns and P (M × r) for kAddLowRank.  A 1-byte W is
// quantized: its kAddLowRank epilogue multiplies the x·q sum by w_scale[n]
// before adding the adapter term.
template <typename TW, int EPI>
__global__ void __launch_bounds__(THREADS)
fp32_tile_kernel(const float* __restrict__ x, const TW* __restrict__ W, const float* __restrict__ aux,
                 const bf16* __restrict__ A, const float* __restrict__ w_scale, float* __restrict__ out,
                 int M, int K, int N, int r, int ldw, int lda, float scale) {
  constexpr bool kQuant = sizeof(TW) == 1;
  static_assert(!kQuant || EPI == kAddLowRank, "q only streams through the main pass");
  __shared__ __align__(16) float smem[SMEM_BYTES / 4];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN32;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[ROWS_PER_T][COLS_PER_T] = {};
  {
    float* xs = smem;
    float* ws = xs + BM * XLD32;
    for (int k0 = 0; k0 < K; k0 += BK) {
      stage<BM, BK, XLD32>(xs, x, m0, k0, M, K, K);
      stage<BK, BN32, BN32>(ws, W, k0, n0, K, N, ldw);
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[ROWS_PER_T];
#pragma unroll
        for (int i = 0; i < ROWS_PER_T; ++i) a[i] = xs[(8 * ty + i) * XLD32 + kk];
        const float4 b4 = lds4(ws + kk * BN32 + 4 * tx);
        const float b[COLS_PER_T] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < ROWS_PER_T; ++i)
#pragma unroll
          for (int c = 0; c < COLS_PER_T; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
      }
      __syncthreads();
    }
  }

  if constexpr (EPI == kScaleColumns) {
#pragma unroll
    for (int c = 0; c < COLS_PER_T; ++c) {
      const int n = n0 + 4 * tx + c;
      if (n >= N) continue;
      const float v = aux[n];
#pragma unroll
      for (int i = 0; i < ROWS_PER_T; ++i) {
        const int m = m0 + 8 * ty + i;
        if (m < M) out[(size_t)m * N + n] = acc[i][c] * v;
      }
    }
  } else {
    float* pt = smem;  // P chunk, transposed: pt[j · PTLD + row]
    float* as = pt + RC * PTLD;
    float low[ROWS_PER_T][COLS_PER_T] = {};
    for (int j0 = 0; j0 < r; j0 += RC) {
      stage_transposed<BM, RC, PTLD>(pt, aux, m0, j0, M, r);
      stage<RC, BN32, BN32>(as, A, j0, n0, r, N, lda);
      __syncthreads();
#pragma unroll 8
      for (int jj = 0; jj < RC; ++jj) {
        const float4 p0 = lds4(pt + jj * PTLD + 8 * ty), p1 = lds4(pt + jj * PTLD + 8 * ty + 4);
        const float4 a4 = lds4(as + jj * BN32 + 4 * tx);
        const float p[ROWS_PER_T] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
        const float a[COLS_PER_T] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int i = 0; i < ROWS_PER_T; ++i)
#pragma unroll
          for (int c = 0; c < COLS_PER_T; ++c) low[i][c] = fmaf(p[i], a[c], low[i][c]);
      }
      __syncthreads();
    }
    float dq[COLS_PER_T];  // the columns' dequant scales
#pragma unroll
    for (int c = 0; c < COLS_PER_T; ++c) {
      const int n = n0 + 4 * tx + c;
      dq[c] = kQuant && n < N ? w_scale[n] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < ROWS_PER_T; ++i) {
      const int m = m0 + 8 * ty + i;
      if (m >= M) continue;
#pragma unroll
      for (int c = 0; c < COLS_PER_T; ++c) {
        const int n = n0 + 4 * tx + c;
        if (n >= N) continue;
        if constexpr (kQuant)  // dequant rounded first, then the adapter term
          out[(size_t)m * N + n] = __fadd_rn(__fmul_rn(acc[i][c], dq[c]), __fmul_rn(low[i][c], scale));
        else
          out[(size_t)m * N + n] = acc[i][c] + low[i][c] * scale;
      }
    }
  }
}

// float32 x: W is float (K, N), or int8/fp8 q with its per-column w_scale.
template <typename TW>
int launch_fp32(const void* x, const void* W, const float* w_scale, const void* B, const void* A,
                const float* lam, float* P, void* y, int M, int K, int N, int r, int ldw, int lda,
                float scale, cudaStream_t stream) {
  if (M == 0 || N == 0) return 0;
  const int row_tiles = (M + BM - 1) / BM;
  if (r > 0) {
    fp32_tile_kernel<bf16, kScaleColumns><<<dim3((r + BN32 - 1) / BN32, row_tiles), THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const bf16*>(B), lam, nullptr, nullptr, P, M, K, r, r,
        r, r, 1.f);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fp32_tile_kernel<TW, kAddLowRank><<<dim3((N + BN32 - 1) / BN32, row_tiles), THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const TW*>(W), P, static_cast<const bf16*>(A), w_scale,
      static_cast<float*>(y), M, K, N, r, ldw, lda, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, W, y share one dtype (x_bf16 = 1 selects bfloat16, 0 float32); the QR
// factors B, A are bfloat16 under either, λ float32.  W (K, N) and A (r, N)
// are row-major with row strides ldw and lda ≥ N (a column slice of a wider
// matrix; for bfloat16 x multiples of 8, TMA's 16-byte strides).  P is
// (M, r) float32 scratch: fp32 P for float32 x, P_hi then P_lo ((M, r) bf16
// each) for bfloat16 x.  Returns the CUDA error code of the launches (0 on
// success).
extern "C" int qrlora_matmul_launch(const void* x, const void* W, const void* B, const void* A,
                                    const float* lam, float* P, void* y, int M, int K, int N, int r,
                                    int ldw, int lda, float scale, int x_bf16, cudaStream_t stream) {
  if (ldw < N || lda < N) return static_cast<int>(cudaErrorInvalidValue);
  if (x_bf16)
    return launch_tc<bf16>(x, W, nullptr, B, A, lam, P, y, M, K, N, r, ldw, lda, scale, stream);
  return launch_fp32<float>(x, W, nullptr, B, A, lam, P, y, M, K, N, r, ldw, lda, scale, stream);
}

// The quantized base: q (K, N) int8 (q_fp8 = 0) or fp8-e4m3 (q_fp8 = 1)
// with w_scale (N,) float32; x and y bfloat16 (x_bf16 = 1) or float32, the
// rest as qrlora_matmul_launch.  Returns the CUDA error code (0 on success).
extern "C" int qrlora_matmul_quant_launch(const void* x, const void* q, const float* w_scale,
                                          const void* B, const void* A, const float* lam, float* P,
                                          void* y, int M, int K, int N, int r, float scale, int x_bf16,
                                          int q_fp8, cudaStream_t stream) {
  if (x_bf16 && q_fp8)
    return launch_tc<fp8>(x, q, w_scale, B, A, lam, P, y, M, K, N, r, N, N, scale, stream);
  if (x_bf16) return launch_tc<int8_t>(x, q, w_scale, B, A, lam, P, y, M, K, N, r, N, N, scale, stream);
  if (q_fp8) return launch_fp32<fp8>(x, q, w_scale, B, A, lam, P, y, M, K, N, r, N, N, scale, stream);
  return launch_fp32<int8_t>(x, q, w_scale, B, A, lam, P, y, M, K, N, r, N, N, scale, stream);
}

// How the bf16 route splits K for an (M, K) × (K, N) product of rank r on
// this device, in the numbers the kernels use: plan[0] the main pass's
// cluster size (1: no split), plan[1] the ranks of that cluster on x
// steps, plan[2] the P pass's cluster size (0 for r = 0); then for each rank
// c < plan[0] of the main pass, the K steps it runs, plan[3 + 3c …] =
// first, stride, end (rank_steps).  plan holds 3 + 3·8 ints.
extern "C" void qrlora_matmul_plan(int M, int K, int N, int r, int* plan) {
  const int sms = sm_count(), nkx = ceil_div(K, TK), nkr = ceil_div(r, TK), tiles_m = ceil_div(M, TM);
  const Split main = plan_split(tiles_m * ceil_div(N, BN), nkx, nkr, sms);
  plan[0] = main.ranks;
  plan[1] = main.ranks_x;
  plan[2] = r > 0 ? plan_split(tiles_m * ceil_div(r, BN), nkx, 0, sms).ranks : 0;
  for (int c = 0; c < main.ranks; ++c) {
    const Steps st = rank_steps(c, main.ranks, main.ranks_x, nkx, nkr);
    plan[3 + 3 * c] = st.first;
    plan[4 + 3 * c] = st.stride;
    plan[5 + 3 * c] = st.end;
  }
}

extern "C" const char* qrlora_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
