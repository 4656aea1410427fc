// Flash attention for Hopper (sm_90a): causal or full GQA attention over a
// sequence, in the model layout.
//
//   out[b, i, h] = Σ_j softmax_j(q[b,i,h]·k[b,j,g] / √dh) · v[b,j,g],
//   g = h / (H/KV);  causal: only j ≤ i (top-left, also when Sq ≠ Sk)
//
// Replaces repro/kernels/flash_attention.py::flash_attention_kernel
// (_kernel).  The TPU kernel walks a (B·H, Sq/bq, Sk/bk) grid in order and
// carries the running max, sum and accumulator in VMEM scratch from one KV
// step to the next.  Blocks of a CUDA grid run in no order, so here one
// block owns one (64-row query tile, head, batch) and walks its KV tiles in
// a loop of its own.  Query head h reads kv head h/(H/KV) straight from the
// (B, Sk, KV, dh) tensors, so K/V are never repeated in memory, and the
// tensors are read through their strides in the model layout (no
// transposes around the call).  KV tiles wholly above the diagonal are
// never loaded, and under the causal mask the blocks with the longest walks
// (the last query tiles) come first in the grid.
//
// Bound on the card (the H100 SXM data sheet's 3.35 TB/s and 989 bf16
// TFLOP/s): at smollm-135m's heads (9 over 3, dh 64, causal, bf16) B = 8 ×
// S = 256 is ≈ 0.6 GFLOP against ≈ 6.3 MB of q, k, v and out, bound by
// bytes (≈ 1.9 µs); B = 1 × S = 2048 is ≈ 4.8 GFLOP, bound by the tensor
// cores (≈ 4.9 µs).  At both shapes
// there are few query rows for 132 SMs (288 blocks of 64 rows), so what
// sets the time is how long the longest block's walk takes: a step has to
// keep its products on the tensor cores with nothing but registers between
// them, hide the next tile's load under them, and the longest walks have to
// be cut.
//
// bf16 (FlashAttention-2's shape; a group of 4 warps, warp w owning query
// rows 16w … 16w+15 of the tile):
//  * K/V tiles (64 rows) go through a 2-stage ring in shared memory, filled
//    by 16-byte cp.async.cg copies: tile t+1's copy is in flight while tile
//    t's products run, with one barrier a tile.  Q is staged once through
//    the ring and held in registers as mma A fragments (ldmatrix).  Rows
//    are padded by 16 bytes, so ldmatrix reads no bank twice.  Where a base
//    or stride is not a multiple of 16 bytes the same ring is filled
//    element by element (synchronously: that handles an input layout, it is
//    not a device fallback).
//  * S = Q·Kᵀ with mma.sync m16n8k16 (bf16 in, fp32 accumulators), K's B
//    fragments by ldmatrix, so S stays in the accumulator registers.
//  * Scale, causal mask and online softmax run on the fragments: a thread
//    holds two rows; row max and sum reduce over the 4-thread quad; the
//    exponentials are ex2.approx with the scale folded in.  Row sums take
//    the fp32 probabilities unrounded; P is then rounded to bf16 into the A
//    fragments of P·V (an m16n8k16 C fragment is laid out as the A
//    fragment), as the TPU kernel rounds it; V's B fragments come by
//    ldmatrix.trans.  The O accumulator is rescaled by α in registers and
//    written once, from registers, through the output's strides.
//  * Where the longest walk is 8 KV tiles or more (and dh ≤ 64), a block
//    holds two groups, each walking every other KV tile through a ring of
//    its own (36 KB each at dh 64) behind a named barrier; the second hands
//    its (max, sum, accumulator) to the first through shared memory at the
//    end, and the first merges the two and writes.  That halves the walk
//    that sets the time at long sequences.
//  The steps beyond: wgmma and TMA (FlashAttention-3's shape), and cutting
//  the longest walks over several blocks.
//
// float32 keeps the first design: K and V staged per tile, S = Q·Kᵀ and P·V
// as fp32 FMAs on the CUDA cores through shared memory, the online softmax
// two threads a row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64, BK = 64, THREADS = 128;

struct Strides {
  long long b, s, h;  // elements; the head dimension has unit stride
};

// ---------------------------------------------------------------------------
// PTX: cp.async, ldmatrix, mma.sync
// ---------------------------------------------------------------------------

// 16 bytes global → shared, asynchronous; zeros when !fill (nothing read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(fill ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a · b, one 16×8×16 tile: a row-major (4 regs), b column-major (2 regs)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (2 ulp; −∞ gives +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage rows r0 … r0+63 of one head (row stride rs) into dst (row stride
// LD), zeros past row n.  vec: base and strides allow 16-byte copies, which
// go asynchronously (cp.async; the caller waits); else one element at a time.
// Threads t, t + nt, … of the caller's group do the copies.
template <typename T, int DH, int LD>
__device__ __forceinline__ void stage(T* dst, const T* src, long long rs, int r0, int n,
                                      bool vec, int t = threadIdx.x, int nt = THREADS) {
  if (vec) {
    constexpr int E = 16 / sizeof(T), C = DH / E;  // elements a copy, copies a row
    for (int i = t; i < BK * C; i += nt) {
      const int r = i / C, c = (i % C) * E;
      const bool in = r0 + r < n;
      cp_async16(dst + r * LD + c, src + (in ? (r0 + r) * rs : 0) + c, in);
    }
  } else {
    for (int i = t; i < BK * DH; i += nt) {
      const int r = i / DH, c = i % DH;
      dst[r * LD + c] = r0 + r < n ? src[(r0 + r) * rs + c] : T(0.f);
    }
  }
}

// The block's work item: query tile, head, batch row, heaviest first: under
// the causal mask the last query tiles walk the most KV tiles, so they start
// first and the short walks fill in behind them.
struct Item {
  int q0, h, b;
};

__device__ __forceinline__ Item work_item(int Sq, int H) {
  const int n_q = (Sq + BQ - 1) / BQ, per_tile = gridDim.x / n_q;  // H · B items a query tile
  const int rem = blockIdx.x % per_tile;
  return {(n_q - 1 - blockIdx.x / per_tile) * BQ, rem % H, rem / H};
}

__device__ __forceinline__ int kv_tiles(int q0, int Sk, int causal) {
  const int n = (Sk + BK - 1) / BK;
  return causal ? min(n, (q0 + BQ - 1) / BK + 1) : n;  // tiles above the diagonal: skipped
}

// ---------------------------------------------------------------------------
// bf16: tensor cores from registers behind a cp.async ring
// ---------------------------------------------------------------------------

template <int DH>
__host__ __device__ constexpr int bf16_ld() {
  return DH + 8;  // 16 bytes of padding a row: ldmatrix's 8 rows land on distinct banks
}

// NG groups of 4 warps a block: each group walks every NG-th KV tile of the
// block's query tile through a ring of its own, and the groups' softmax
// states merge at the end.  Two groups halve the walk of the longest blocks
// where walks are long (launch() picks them from 8 KV tiles on, up to dh
// 64; at dh 128 the registers allow no second group).
template <int DH, int NG>
__host__ __device__ constexpr size_t bf16_smem_bytes() {
  return NG * 4 * BK * bf16_ld<DH>() * sizeof(bf16);  // K, V × 2 stages a group
}

__device__ __forceinline__ void group_barrier(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(THREADS) : "memory");
}

template <int DH, int NG>
__global__ void __launch_bounds__(THREADS * NG, 2)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out, int Sq, int Sk, int H,
                  int KV, Strides qs_, Strides ks_, Strides vs_, Strides os_, float scale_log2,
                  int causal, int vec) {
  constexpr int LD = bf16_ld<DH>(), KS = DH / 16, NB = BK / 8, OB = DH / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31, grp = tid / THREADS;
  // this group's ring: stage s holds K at 2s and V at 2s+1 (BK × LD each)
  bf16* ring = reinterpret_cast<bf16*>(smem_raw) + grp * 4 * BK * LD;
  auto k_stage = [&](int s) { return ring + (2 * s) * BK * LD; };
  auto v_stage = [&](int s) { return ring + (2 * s + 1) * BK * LD; };
  bf16* q_tile = reinterpret_cast<bf16*>(smem_raw) + 2 * BK * LD;  // group 0's second stage

  const Item it = work_item(Sq, H);
  const int q0 = it.q0, h = it.h, b = it.b;
  const int g = h / (H / KV);
  const bf16* qb = q + b * qs_.b + h * qs_.h;
  const bf16* kb = k + b * ks_.b + g * ks_.h;
  const bf16* vb = v + b * vs_.b + g * vs_.h;
  const int n_kt = kv_tiles(q0, Sk, causal);
  const int t = tid % THREADS;  // thread within the group

  // Q through group 0's second stage (free until its second tile), each
  // group's first tile into its first stage
  if (grp == 0) stage<bf16, DH, LD>(q_tile, qb, qs_.s, q0, Sq, vec, t);
  if (grp < n_kt) {
    stage<bf16, DH, LD>(k_stage(0), kb, ks_.s, grp * BK, Sk, vec, t);
    stage<bf16, DH, LD>(v_stage(0), vb, vs_.s, grp * BK, Sk, vec, t);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  // warp w of each group owns query rows 16w … 16w+15 of the tile; this
  // thread rows r0 and r0 + 8
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(qf[kk], q_tile + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
  const int r0 = q0 + warp * 16 + (lane >> 2);
  float o[OB][4];
#pragma unroll
  for (int j = 0; j < OB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  if (NG > 1) __syncthreads();  // every warp has its Q fragments: group 0's stage 1 is free

  // this group's KV tiles grp, grp + NG, …; the i-th in stage i mod 2
  for (int i = 0, kt = grp; kt < n_kt; ++i, kt += NG) {
    cp_async_wait_all();
    group_barrier(1 + grp);  // tile kt has landed; the group is done with its last tile
    if (kt + NG < n_kt) {
      stage<bf16, DH, LD>(k_stage((i + 1) & 1), kb, ks_.s, (kt + NG) * BK, Sk, vec, t);
      stage<bf16, DH, LD>(v_stage((i + 1) & 1), vb, vs_.s, (kt + NG) * BK, Sk, vec, t);
      cp_async_commit();
    }
    const bf16* sk = k_stage(i & 1);
    const bf16* sv = v_stage(i & 1);
    const int k0 = kt * BK;

    // S = Q·Kᵀ: n-blocks of 8 keys, two a ldmatrix.x4
    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j2 = 0; j2 < NB / 2; ++j2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, sk + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * j2], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * j2 + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // mask: keys past Sk, and above the diagonal where the tile crosses it
    if (k0 + BK > Sk || (causal && k0 + BK - 1 > q0)) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + j * 8 + (lane & 3) * 2 + (e & 1), qpos = r0 + (e >> 1) * 8;
          if (kpos >= Sk || (causal && kpos > qpos)) s[j][e] = -INFINITY;
        }
    }

    // online softmax on the fragments (base-2 exponent with the scale folded in)
    float ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int j = 0; j < NB; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      ms[r] = mx == -INFINITY ? 0.f : mx * scale_log2;  // a row with no key yet stays at 0
      const float alpha = ex2(m_run[r] * scale_log2 - ms[r]);
      m_run[r] = mx;
      l_run[r] *= alpha;
#pragma unroll
      for (int j = 0; j < OB; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[j][e], scale_log2, -ms[e >> 1]));
        s[j][e] = p;
        l_run[e >> 1] += p;  // unrounded
      }

    // O += P·V: P's A fragments straight from S's accumulators, rounded to bf16
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      const uint32_t pa[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                              pack_bf16(s[2 * c][2], s[2 * c][3]),
                              pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                              pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int d2 = 0; d2 < OB / 2; ++d2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sv + (c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + d2 * 16 +
                                  (lane >> 4) * 8);
        mma_bf16(o[2 * d2], pa, vf[0], vf[1]);
        mma_bf16(o[2 * d2 + 1], pa, vf[2], vf[3]);
      }
    }
  }

  if (NG > 1) {
    // merge: groups 1 … NG−1 hand their state over through shared memory,
    // component-major (thread t of every group holds the same rows and
    // columns), and group 0 rescales all of them to the joint max
    constexpr int NC = OB * 4 + 4;  // o, m, l of a thread
    static_assert((NG - 1) * NC * THREADS * sizeof(float) <= bf16_smem_bytes<DH, NG>(),
                  "merge buffer");
    float* xch = reinterpret_cast<float*>(smem_raw);
    __syncthreads();  // every ring is done with
    if (grp > 0) {
      float* mine = xch + (grp - 1) * NC * THREADS + t;
#pragma unroll
      for (int j = 0; j < OB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(j * 4 + e) * THREADS] = o[j][e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mine[(OB * 4 + r) * THREADS] = m_run[r];
        mine[(OB * 4 + 2 + r) * THREADS] = l_run[r];
      }
    }
    __syncthreads();
    if (grp > 0) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int x = 0; x < NG - 1; ++x) mx = fmaxf(mx, xch[(x * NC + OB * 4 + r) * THREADS + t]);
      const float ms = mx == -INFINITY ? 0.f : mx * scale_log2;
      const float a0 = ex2(m_run[r] * scale_log2 - ms);
      l_run[r] *= a0;
#pragma unroll
      for (int j = 0; j < OB; ++j) {
        o[j][2 * r] *= a0;
        o[j][2 * r + 1] *= a0;
      }
#pragma unroll
      for (int x = 0; x < NG - 1; ++x) {
        const float* theirs = xch + x * NC * THREADS + t;
        const float a = ex2(theirs[(OB * 4 + r) * THREADS] * scale_log2 - ms);
        l_run[r] = fmaf(theirs[(OB * 4 + 2 + r) * THREADS], a, l_run[r]);
#pragma unroll
        for (int j = 0; j < OB; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e)
            o[j][e] = fmaf(theirs[(j * 4 + e) * THREADS], a, o[j][e]);
      }
    }
  }

  bf16* ob = out + b * os_.b + h * os_.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qpos = r0 + r * 8;
    if (qpos < Sq) {
#pragma unroll
      for (int j = 0; j < OB; ++j) {
        const int d = j * 8 + (lane & 3) * 2;
        const float x = l > 0.f ? o[j][2 * r] / l : 0.f, y = l > 0.f ? o[j][2 * r + 1] / l : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(ob + qpos * os_.s + d) = __floats2bfloat162_rn(x, y);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores through shared memory
// ---------------------------------------------------------------------------

constexpr int SLD = BK + 4;  // fp32 score rows

template <int DH>
__host__ __device__ constexpr int f32_ld() {
  return DH + 4;  // staggers the banks; rows stay 16-byte aligned
}

template <int DH>
constexpr size_t f32_smem_bytes() {
  return (3 * BQ * f32_ld<DH>() + BQ * SLD + 2 * BQ) * sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int Sq, int Sk, int H,
                 int KV, Strides qs_, Strides ks_, Strides vs_, Strides os_, float scale,
                 int causal, int vec) {
  constexpr int LD = f32_ld<DH>(), OC = DH / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // BQ × LD
  float* ks = qs + BQ * LD;                        // BK × LD
  float* vs = ks + BK * LD;                        // BK × LD
  float* ss = vs + BK * LD;                        // BQ × SLD scores, then p
  float* alpha_s = ss + BQ * SLD;                  // BQ rescale of this step
  float* l_s = alpha_s + BQ;                       // BQ final row sums

  const Item it = work_item(Sq, H);
  const int q0 = it.q0, h = it.h, b = it.b;
  const int g = h / (H / KV), tid = threadIdx.x;
  const float* qb = q + b * qs_.b + h * qs_.h;
  const float* kb = k + b * ks_.b + g * ks_.h;
  const float* vb = v + b * vs_.b + g * vs_.h;
  stage<float, DH, LD>(qs, qb, qs_.s, q0, Sq, vec);
  cp_async_commit();
  cp_async_wait_all();  // visible to the block at the first tile's barrier
  const int n_kt = kv_tiles(q0, Sk, causal);

  // online softmax state: the thread pair (2r, 2r+1) owns query row r
  const int srow = tid >> 1, shalf = tid & 1;
  float m_run = -INFINITY, l_run = 0.f;
  // accumulator: thread (ty, tx) owns rows 4·ty + i and columns tx + 8·j
  const int ty = tid >> 3, tx = tid & 7;
  float acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OC; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    stage<float, DH, LD>(ks, kb, ks_.s, k0, Sk, vec);
    stage<float, DH, LD>(vs, vb, vs_.s, k0, Sk, vec);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float a[4], kk[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(4 * ty + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kk[j] = ks[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) ss[(4 * ty + i) * SLD + tx + 8 * j] = s[i][j];
    __syncwarp();  // a warp's rows are its own from here to the end of the tile

    // scale, mask and online softmax of row srow, two threads a row
    {
      float* row = ss + srow * SLD;
      const int qpos = q0 + srow;
      float mx = -INFINITY;
      for (int c = shalf; c < BK; c += 2) {
        const int kpos = k0 + c;
        const bool ok = kpos < Sk && (!causal || kpos <= qpos);
        const float sc = ok ? row[c] * scale : -INFINITY;
        row[c] = sc;
        mx = fmaxf(mx, sc);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_run, mx);
      const float alpha = m_new == -INFINITY ? 1.f : expf(m_run - m_new);
      float sum = 0.f;
      for (int c = shalf; c < BK; c += 2) {
        const float p = row[c] == -INFINITY ? 0.f : expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (!shalf) alpha_s[srow] = alpha;
    }
    __syncwarp();

    // acc = acc·α + P·V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = alpha_s[4 * ty + i];
#pragma unroll
      for (int j = 0; j < OC; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4], vv[OC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(4 * ty + i) * SLD + c];
#pragma unroll
      for (int j = 0; j < OC; ++j) vv[j] = vs[c * LD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < OC; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  if (!shalf) l_s[srow] = l_run;
  __syncwarp();
  float* ob = out + b * os_.b + h * os_.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (q0 + r < Sq) {
      const float l = l_s[r];
#pragma unroll
      for (int j = 0; j < OC; ++j)
        ob[(q0 + r) * os_.s + tx + 8 * j] = l > 0.f ? acc[i][j] / l : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int configure(Kernel kernel, size_t smem, bool& done) {
  if (done) return 0;  // above 48 KB, dynamic shared memory must be asked for
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  done = err == cudaSuccess;
  return static_cast<int>(err);
}

template <int DH, int NG>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int grid, int Sq, int Sk,
                int H, int KV, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                int causal, int vec, cudaStream_t stream) {
  static bool done = false;
  constexpr size_t smem = bf16_smem_bytes<DH, NG>();
  if (const int err = configure(flash_bf16_kernel<DH, NG>, smem, done)) return err;
  flash_bf16_kernel<DH, NG><<<grid, THREADS * NG, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), Sq, Sk, H, KV, qs, ks, vs, os, scale * 1.4426950408889634f,
      causal, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch(bool bf16_, const void* q, const void* k, const void* v, void* out, int B, int Sq,
           int Sk, int H, int KV, Strides qs, Strides ks, Strides vs, Strides os, float scale,
           int causal, int vec, cudaStream_t stream) {
  const int n_q = (Sq + BQ - 1) / BQ, grid = n_q * H * B;
  if (bf16_) {
    const int n_kt = (Sk + BK - 1) / BK, longest = causal ? std::min(n_kt, n_q) : n_kt;
    if constexpr (DH <= 64)
      if (longest >= 8)
        return launch_bf16<DH, 2>(q, k, v, out, grid, Sq, Sk, H, KV, qs, ks, vs, os, scale,
                                  causal, vec, stream);
    return launch_bf16<DH, 1>(q, k, v, out, grid, Sq, Sk, H, KV, qs, ks, vs, os, scale, causal,
                              vec, stream);
  }
  static bool done = false;
  constexpr size_t smem = f32_smem_bytes<DH>();
  if (const int err = configure(flash_f32_kernel<DH>, smem, done)) return err;
  flash_f32_kernel<DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Sq, Sk, H, KV, qs, ks, vs, os, scale, causal, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Sq, H, dh), k and v (B, Sk, KV, dh), out (B, Sq, H, dh), each
// addressed by its batch, sequence and head strides in elements (unit
// stride over dh).  dh ∈ {16, 32, 64, 128}; vec = 1 when every base is
// 16-byte aligned and every stride a multiple of 16 bytes; bf16 = 1 selects
// bfloat16 tensors, 0 float32.  Returns the CUDA error code.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int Sq, int Sk, int H, int KV, int dh,
                                      long long qsb, long long qss, long long qsh,
                                      long long ksb, long long kss, long long ksh,
                                      long long vsb, long long vss, long long vsh,
                                      long long osb, long long oss, long long osh, float scale,
                                      int causal, int vec, int bf16, cudaStream_t stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  switch (dh) {
    case 16:
      return launch<16>(bf16, q, k, v, out, B, Sq, Sk, H, KV, qs, ks, vs, os, scale, causal, vec,
                        stream);
    case 32:
      return launch<32>(bf16, q, k, v, out, B, Sq, Sk, H, KV, qs, ks, vs, os, scale, causal, vec,
                        stream);
    case 64:
      return launch<64>(bf16, q, k, v, out, B, Sq, Sk, H, KV, qs, ks, vs, os, scale, causal, vec,
                        stream);
    case 128:
      return launch<128>(bf16, q, k, v, out, B, Sq, Sk, H, KV, qs, ks, vs, os, scale, causal,
                         vec, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
