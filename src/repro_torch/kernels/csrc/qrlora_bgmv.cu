// Batched multi-λ QR-LoRA matmul (BGMV) for Hopper (sm_90a), on a frozen
// base W in x's dtype or quantized to int8 / fp8-e4m3 q with a per-column
// w_scale:
//
//   y[m, n] = Σ_k x[m,k]·W[k,n] + scale · Σ_j P[m,j]·A[j,n]
//   y[m, n] = (Σ_k x[m,k]·q[k,n]) · w_scale[n] + scale · Σ_j P[m,j]·A[j,n]
//   P[m, j] = (Σ_k x[m,k]·B[k,j]) · Λ[seg[m], j]
//
// Replaces repro/kernels/qrlora_bgmv.py::qrlora_bgmv_kernel (_kernel),
// ::qrlora_bgmv_quant_kernel (_kernel_q) and, with λ rows gathered before
// the call, ::qrlora_bgmv_rows_kernel (_kernel_rows, both its routes).
// Those TPU kernels carry the (bm, r) x·B accumulator across their in-order
// N grid axis and gather λ rows with a one-hot × table matmul; here λ rows
// are loaded by index.
//
// Bound on the card: at decode (M = lanes = 4, K = 576, N = 576 for wq or
// 192 for wv, r = 128) the work is reading W (or q), B and A once: bf16 W
// ≈ 0.97 MB at wq, ≈ 0.29 µs at 3.35 TB/s; an int8/fp8 q ≈ 0.64 MB, ≈ 0.19
// µs.  The flops are negligible, and prefill buckets (M ≤ 64) stay far below
// the 295 flop/byte ridge too.  So a call is bound by its chain of
// latencies: launch, dependent loads, barriers.
//
// What the design does about it: one launch of clusters of CS = 8 CTAs.  A
// cluster owns a 32-column tile of y and a row tile of up to 32 rows; its
// CTAs split K into eight slices of ⌈K/8⌉ rows (rounded up to 8).  Each CTA
//  1. stages its slice of x, of W's column tile (a q raw, one byte an
//     element) and of all of B, then its eighth of A's rows for the tile,
//     of the λ rows and, on a q, its 4 columns' w_scale — every load issued
//     at once, as 16-byte cp.async copies (where the shapes align; element
//     by element otherwise): one dependent round at K ≤ 8·128;
//  2. takes its partial sums of x·W (rows × 32) and x·B (rows × r): bf16 on
//     the tensor cores (mma.sync m16n8k16 from ldmatrix fragments; exact
//     products, fp32 sums), a q first widened in shared memory to the bf16
//     tile the same loop reads (exact: widen.cuh); float32 on the CUDA
//     cores (an fp32 FMA chain in K order), a q widened to fp32 as it is
//     read; and sends each to the CTA that sums it, x·B column j to rank
//     j / ⌈r/8⌉, x·W column n to rank n / 4 (distributed shared memory
//     stores; no atomics);
//  3. after a cluster barrier, sums its P columns over the ranks in rank
//     order, multiplies by λ, and sends its share of P·A (its eighth of the
//     rank columns, all 32 columns of the tile) on the same way;
//  4. after a second barrier, sums the x·W and the P·A partials of its 4
//     columns in rank order and writes y = Σx·W + Σ(P·A)·scale, or on a q
//     y = Σx·q·w_scale + Σ(P·A)·scale with the dequant product rounded in
//     fp32 before the adapter term is added (the reference's order; the
//     scale never touches the adapter term or a partial), each product
//     rounded before the sum, once, in x's dtype.
// A decode launch puts 8·⌈N/32⌉ CTAs on the card (144 at wq, 48 at wv).  P
// never leaves the cluster: no second launch and no scratch.  Every sum has
// a fixed order, so y is bitwise the same from call to call and under graph
// replay, and a row's result depends on that row alone, not on M or its
// neighbours (an mma row is computed from its own row of x).  Rows past M
// are neither read nor written.
//
// Timed on the card (PERF.md): bf16's partial sums on the CUDA cores lost
// several-fold at a 64-row bucket (each cluster recomputes x·B for its
// rows); an mma loop that re-loaded x's fragment for every 16 × 8 tile
// took 0.0103 / 0.0187 ms at wq decode / a 64-row bucket, the loop here,
// with x's fragments loaded once a k16 step, 0.0081 / 0.0122.
// At decode the time is the chain of one launch, one load round, the
// partial sums and two barriers; the bf16 registers are capped so that a
// 64-row bucket at wq (288 CTAs) fits the card in one wave.  On an int8 or
// fp8 q (bf16 x) the launch reads 0.0085 / 0.0077 ms at wq / wv decode and
// 0.0136 at a 64-row bucket, ≈ 0.0004 ms over a bf16 W at decode, which
// has no widening pass and one barrier fewer a round; the two launches it
// replaced (a low-rank pass writing P, then a main pass walking K in five
// serial rounds over 18 CTAs at wq) read 0.0218 at wq and at wv alike.
//
// The rows kernel is this kernel reading rows[m] where it reads Λ[seg[m]]
// (a slot outside [0, n_slots) gives a zero row), so with rows = Λ[seg] its
// y is bitwise the BGMV kernel's, on a W in x's dtype or on a q.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "cluster.cuh"
#include "widen.cuh"

namespace {

using bf16 = __nv_bfloat16;
using fp8 = __nv_fp8_e4m3;

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
int round_up(int a, int b) { return ceil_div(a, b) * b; }

constexpr int CS = 8;         // CTAs of a cluster: the K slices (the portable cluster size)
constexpr int TN = 32;        // columns of a cluster's output tile
constexpr int OUT = TN / CS;  // columns of the tile each rank sums and writes (4)
constexpr int TM = 32;        // rows of a cluster's row tile at most
constexpr int KC = 128;       // K rows a CTA stages in one round at most
constexpr int THREADS = 256;
constexpr int R_MAX = 256;    // largest rank r served
// float32 x: a task is one row × 4 columns of [x·W tile | x·B]; a thread's
// tasks at most.  bf16 x: 16 × 8 mma tiles of the same.
constexpr int TASKS = ceil_div(TM * (TN + R_MAX) / 4, THREADS);
constexpr int MT_MAX = TM / 16;                                   // 16-row tiles of a row tile
constexpr int NT_WARP = ceil_div((TN + R_MAX) / 8, THREADS / 32);  // 8-column tiles a warp takes
static_assert(OUT == 4, "a rank's output columns are one 4-column task");

// The split of one launch, the same in every CTA (host and device).
struct Geo {
  int ks;   // K rows of a rank's slice (a multiple of 8)
  int kc;   // K rows staged per round: min(ks, KC)
  int js;   // rank columns of P a rank sums (a multiple of 4): ⌈r/8⌉ rounded up
  int rp;   // B's columns in shared memory: r rounded up to 8
  int tm;   // rows of the largest row tile: min(M, TM)
  int kx;   // K rows a staged round holds (bf16: kc rounded up to whole k16 steps)
  int rows; // rows of x a round holds (bf16: tm rounded up to whole m16 tiles)
  // bytes of a row in shared memory: x, the W tile the partial sums read (a
  // q under float32 x raw, one byte an element), B (bf16 rows padded by 16
  // bytes, so the 8 row addresses of an ldmatrix fall in distinct banks), a
  // q under bf16 x as staged (raw)
  int xs, ws, bs, qs;
  // shared-memory offsets, bytes, each 16-byte aligned: o_ws a q's w_scale
  // for the rank's 4 columns, o_q a q's raw tile under bf16 x (widened from
  // there into the bf16 tile at o_w)
  int o_w, o_b, o_a, o_lam, o_p, o_rb, o_rw, o_rpa, o_ws, o_q, bytes;
};

// quant: W is a 1-byte q (int8 or fp8), else in x's dtype.
Geo make_geo(int M, int K, int r, bool x_bf16, bool quant) {
  Geo g;
  const int sz = x_bf16 ? 2 : 4, pad = x_bf16 ? 16 : 0;
  g.ks = std::max(8, round_up(ceil_div(K, CS), 8));
  g.kc = std::min(g.ks, KC);
  g.js = std::max(4, round_up(ceil_div(r, CS), 4));
  g.rp = round_up(std::max(r, 1), 8);
  g.tm = std::min(M, TM);
  g.kx = x_bf16 ? round_up(g.kc, 16) : g.kc;
  g.rows = x_bf16 ? round_up(g.tm, 16) : g.tm;
  g.xs = g.kx * sz + 16;
  g.ws = quant && !x_bf16 ? TN : TN * sz + pad;  // float32 x reads a q as it lies
  g.bs = g.rp * 2 + pad;
  g.o_w = g.rows * g.xs;
  g.o_b = g.o_w + g.kx * g.ws;
  g.o_a = g.o_b + g.kx * g.bs;
  g.o_lam = g.o_a + g.js * TN * 2;
  g.o_p = g.o_lam + g.tm * g.js * 4;
  g.o_rb = g.o_p + g.tm * g.js * 4;
  g.o_rw = g.o_rb + CS * g.tm * g.js * 4;
  g.o_rpa = g.o_rw + CS * g.tm * OUT * 4;
  g.bytes = g.o_rpa + CS * g.tm * OUT * 4;
  g.o_ws = g.o_q = g.o_w;
  g.qs = g.ws;
  if (quant) {
    g.o_ws = g.bytes;
    g.bytes += 16;
    if (x_bf16) {  // q lands raw beside the bf16 tile it is widened into
      g.o_q = g.bytes;
      g.qs = TN;
      g.bytes += g.kx * TN;
    }
  }
  return g;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage a (rows × cols) block of a row-major matrix of SZ-byte elements
// (row stride ld elements, first element src) into shared memory (row stride
// dst_row bytes), zero past `rows_in` rows and `cols_in` columns.  vec: the
// source rows and `src` are 16-byte aligned, so whole rows go as 16-byte
// copies (a ragged last vector reads only its valid bytes); otherwise one
// element at a time.  Neither waits: the caller waits once for all.
template <int SZ>
__device__ __forceinline__ void stage(unsigned char* dst, int dst_row, const void* src, size_t ld,
                                      int rows, int cols, int rows_in, int cols_in, bool vec) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  if (vec) {
    constexpr int V = 16 / SZ;  // elements a vector
    const int per_row = ceil_div(cols, V);
    for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
      const int rr = i / per_row, c = (i % per_row) * V;
      const int n = rr < rows_in ? min(V, max(0, cols_in - c)) : 0;
      cp_async16(dst + rr * dst_row + c * SZ, n ? s + (rr * ld + c) * SZ : s, n * SZ);
    }
  } else {
    using U = typename std::conditional<
        SZ == 1, uint8_t, typename std::conditional<SZ == 2, uint16_t, uint32_t>::type>::type;
    const U* g = static_cast<const U*>(src);
    for (int i = threadIdx.x; i < rows * cols; i += THREADS) {
      const int rr = i / cols, c = i % cols;
      reinterpret_cast<U*>(dst + rr * dst_row)[c] =
          rr < rows_in && c < cols_in ? g[rr * ld + c] : U(0);
    }
  }
}

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
// A q's four values widened to fp32 (exact).
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(c.x, c.y, c.z, c.w);
}
__device__ __forceinline__ float4 load4(const fp8* p) {
  uint32_t w01, w23;
  widen4(fp8{}, *reinterpret_cast<const uint32_t*>(p), w01, w23);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w01));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w23));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
// d += a · b on the tensor cores: a 16 × 16 bf16 (row), b 16 × 8 bf16 (col),
// d 16 × 8 fp32; each product exact, summed in fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += x[k] · w4[k] over k < kn, in K order.
template <typename TW>
__device__ __forceinline__ void fma_chain(float (&acc)[4], const float* xr, const TW* w, int ld, int kn) {
#pragma unroll 4
  for (int k = 0; k < kn; ++k) {
    const float a = xr[k];
    const float4 b = load4(w + k * ld);
    acc[0] = fmaf(a, b.x, acc[0]);
    acc[1] = fmaf(a, b.y, acc[1]);
    acc[2] = fmaf(a, b.z, acc[2]);
    acc[3] = fmaf(a, b.w, acc[3]);
  }
}

// One cluster per (32-column tile, row tile): blockIdx.x = tile · CS + rank,
// blockIdx.y = row tile.  TW: W's type, x's (w_scale unused) or a 1-byte q
// (int8_t, fp8) dequantized by w_scale.  kRows: λ is rows (M, r) at row m;
// else the table row Λ[seg[m]].  vec: every staged matrix takes 16-byte
// copies.  bf16 x takes its partial sums on the tensor cores (mma.sync
// m16n8k16: exact products, fp32 sums, each output row from its own row of
// x), float32 x on the CUDA cores.
// bf16 asks for 3 CTAs an SM (≤ 85 registers a thread): a 64-row bucket at
// wq (288 CTAs) then fits the card in one wave.
template <typename TX, typename TW, bool kRows>
__global__ void __cluster_dims__(CS, 1, 1)
__launch_bounds__(THREADS, std::is_same<TX, bf16>::value ? 3 : 1)
bgmv_cluster_kernel(const TX* __restrict__ x, const TW* __restrict__ W,
                    const float* __restrict__ w_scale, const bf16* __restrict__ B,
                    const bf16* __restrict__ A, const float* __restrict__ lam,
                    const int* __restrict__ seg, TX* __restrict__ y, int M, int K, int N, int r,
                    int n_slots, float scale, Geo g, bool vec) {
  constexpr bool kMma = std::is_same<TX, bf16>::value;
  constexpr bool kQuant = sizeof(TW) == 1;
  static_assert(kQuant || std::is_same<TW, TX>::value, "W is in x's dtype or a 1-byte q");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem + g.o_a);
  float* lam_s = reinterpret_cast<float*>(smem + g.o_lam);
  float* p_s = reinterpret_cast<float*>(smem + g.o_p);
  float* recv_b = reinterpret_cast<float*>(smem + g.o_rb);   // [rank][row][js]: x·B partials
  float* recv_w = reinterpret_cast<float*>(smem + g.o_rw);   // [rank][row][OUT]: x·W partials
  float* recv_pa = reinterpret_cast<float*>(smem + g.o_rpa); // [rank][row][OUT]: P·A partials
  float* ws_s = reinterpret_cast<float*>(smem + g.o_ws);     // a q's w_scale, the rank's columns

  const uint32_t rank = cluster_rank();
  const int n0 = blockIdx.x / CS * TN, m0 = blockIdx.y * TM;
  const int tm = min(TM, M - m0);
  const int k0 = rank * g.ks, k1 = min(K, k0 + g.ks);
  const int j0 = rank * g.js, jn = max(0, min(g.js, r - j0));  // this rank's P columns

  cluster_arrive_relaxed();  // peers write into this CTA only after every CTA has started

  // this rank's eighth of A's rows for the tile, and of the λ rows (and a
  // q's w_scale for the rank's columns): issued after the first round's
  // copies, so their loads (seg, then Λ) overlap it
  auto stage_a_and_lam = [&] {
    stage<2>(smem + g.o_a, TN * 2, A + (size_t)j0 * N + n0, N, g.js, TN, jn, N - n0, vec);
    if constexpr (kQuant) {
      const int n = n0 + rank * OUT + threadIdx.x;
      if (threadIdx.x < OUT) ws_s[threadIdx.x] = n < N ? w_scale[n] : 0.f;
    }
    for (int i = threadIdx.x; i < tm * g.js; i += THREADS) {
      const int m = i / g.js, jj = i % g.js;
      float v = 0.f;
      if (jj < jn) {
        if constexpr (kRows) {
          v = lam[(size_t)(m0 + m) * r + j0 + jj];
        } else {
          const int sg = seg[m0 + m];
          v = sg >= 0 && sg < n_slots ? lam[(size_t)sg * r + j0 + jj] : 0.f;
        }
      }
      lam_s[i] = v;
    }
  };
  if (k0 >= k1) stage_a_and_lam();  // an empty K slice stages no round

  if constexpr (kMma) {
    // bf16: 16 × 8 tiles of [x·W tile | x·B] on the tensor cores.  Warp w
    // takes the 8-column tiles w, w + 8, … for every 16-row tile: at each
    // k16 step it loads x's fragments once and each column tile's once.
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int n_tiles = TN / 8 + g.rp / 8, m_tiles = ceil_div(tm, 16);
    // shared-memory offset of lane's row of each column tile at k = 0, and its row stride
    int b_off[NT_WARP], b_ld[NT_WARP];
#pragma unroll
    for (int t = 0; t < NT_WARP; ++t) {
      const int nt = warp + t * (THREADS / 32);
      b_ld[t] = nt < TN / 8 ? g.ws : g.bs;
      b_off[t] = (nt < TN / 8 ? g.o_w + nt * 16 : g.o_b + (nt - TN / 8) * 16) + lane % 16 * b_ld[t];
    }
    float acc[NT_WARP][MT_MAX][4] = {};
    for (int kc0 = k0; kc0 < k1; kc0 += g.kc) {
      const int kn = min(g.kc, k1 - kc0);
      stage<2>(smem, g.xs, x + (size_t)m0 * K + kc0, K, m_tiles * 16, g.kx, tm, kn, vec);
      if constexpr (kQuant)
        stage<1>(smem + g.o_q, g.qs, W + (size_t)kc0 * N + n0, N, g.kx, TN, kn, N - n0, vec);
      else
        stage<2>(smem + g.o_w, g.ws, W + (size_t)kc0 * N + n0, N, g.kx, TN, kn, N - n0, vec);
      stage<2>(smem + g.o_b, g.bs, B + (size_t)kc0 * r, r, g.kx, g.rp, kn, r, vec);
      if (kc0 == k0) stage_a_and_lam();
      cp_async_wait_all();
      __syncthreads();
      if constexpr (kQuant) {  // q's raw tile widened into the bf16 tile the loop reads (exact)
        for (int i = threadIdx.x; i < g.kx * (TN / 16); i += THREADS) {
          const int k = i / (TN / 16), c = i % (TN / 16) * 16;
          uint4 lo, hi;
          widen16<TW>(*reinterpret_cast<const uint4*>(smem + g.o_q + k * TN + c), lo, hi);
          uint4* dst = reinterpret_cast<uint4*>(smem + g.o_w + k * g.ws + c * 2);
          dst[0] = lo;
          dst[1] = hi;
        }
        __syncthreads();
      }
      for (int k = 0; k < kn; k += 16) {  // rows past kn are zeros
        uint32_t a[MT_MAX][4];
#pragma unroll
        for (int mt = 0; mt < MT_MAX; ++mt)
          if (mt < m_tiles)
            ldsm_x4(a[mt], smem + (mt * 16 + lane % 16) * g.xs + (k + lane / 16 * 8) * 2);
#pragma unroll
        for (int t = 0; t < NT_WARP; ++t) {
          if (warp + t * (THREADS / 32) < n_tiles) {
            uint32_t b[2];
            ldsm_x2_trans(b, smem + b_off[t] + k * b_ld[t]);
#pragma unroll
            for (int mt = 0; mt < MT_MAX; ++mt)
              if (mt < m_tiles) mma_bf16(acc[t][mt], a[mt], b);
          }
        }
      }
      __syncthreads();  // before the next round overwrites the tiles
    }
    cp_async_wait_all();  // A's rows, also where this rank's K slice is empty

    // send each partial to the rank that sums it: a thread holds columns
    // 2·(lane % 4) + {0, 1} of rows lane / 4 and lane / 4 + 8 of its tiles
    cluster_wait();
    const int c = lane % 4 * 2;
#pragma unroll
    for (int t = 0; t < NT_WARP; ++t) {
      const int nt = warp + t * (THREADS / 32);
      if (nt >= n_tiles) continue;
#pragma unroll
      for (int mt = 0; mt < MT_MAX; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + lane / 4 + 8 * h;
          const float2 v = make_float2(acc[t][mt][2 * h], acc[t][mt][2 * h + 1]);
          if (m >= tm) continue;
          if (nt < TN / 8) {
            const int n = nt * 8 + c;
            st_cluster(recv_w + (rank * g.tm + m) * OUT + n % OUT, n / OUT, v);
          } else {
            const int j = (nt - TN / 8) * 8 + c;  // a pair lies within one owner: js % 4 == 0
            if (j < r) st_cluster(recv_b + (rank * g.tm + m) * g.js + j % g.js, j / g.js, v);
          }
        }
      }
    }
  } else {
    // float32: one row × 4 columns a task on the CUDA cores, an FMA chain in K order
    const int groups = TN / 4 + g.rp / 4, tasks = tm * groups;
    float acc[TASKS][4] = {};
    for (int kc0 = k0; kc0 < k1; kc0 += g.kc) {
      const int kn = min(g.kc, k1 - kc0);
      stage<4>(smem, g.xs, x + (size_t)m0 * K + kc0, K, tm, g.kx, tm, kn, vec);
      stage<sizeof(TW)>(smem + g.o_w, g.ws, W + (size_t)kc0 * N + n0, N, kn, TN, kn, N - n0, vec);
      stage<2>(smem + g.o_b, g.bs, B + (size_t)kc0 * r, r, kn, g.rp, kn, r, vec);
      if (kc0 == k0) stage_a_and_lam();
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int t = 0; t < TASKS; ++t) {
        const int task = threadIdx.x + t * THREADS;
        if (task < tasks) {
          const int m = task / groups, grp = task % groups;
          const float* xr = reinterpret_cast<const float*>(smem + m * g.xs);
          if (grp < TN / 4)
            fma_chain(acc[t], xr, reinterpret_cast<const TW*>(smem + g.o_w) + grp * 4, TN, kn);
          else
            fma_chain(acc[t], xr, reinterpret_cast<const bf16*>(smem + g.o_b) + (grp - TN / 4) * 4,
                      g.rp, kn);
        }
      }
      __syncthreads();  // before the next round overwrites the tiles
    }
    cp_async_wait_all();  // A's rows, also where this rank's K slice is empty

    cluster_wait();
#pragma unroll
    for (int t = 0; t < TASKS; ++t) {
      const int task = threadIdx.x + t * THREADS;
      if (task < tasks) {
        const int m = task / groups, grp = task % groups;
        const float4 v = make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
        if (grp < TN / 4) {
          st_cluster(recv_w + (rank * g.tm + m) * OUT, grp, v);
        } else {
          const int j = (grp - TN / 4) * 4;  // a group lies within one owner: js % 4 == 0
          if (j < r) st_cluster(recv_b + (rank * g.tm + m) * g.js + j % g.js, j / g.js, v);
        }
      }
    }
  }
  cluster_sync();

  // P over this rank's columns: the x·B partials summed in rank order, then λ
  for (int i = threadIdx.x; i < tm * g.js; i += THREADS) {
    const int m = i / g.js, jj = i % g.js;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < CS; ++c) s += recv_b[(c * g.tm + m) * g.js + jj];
    p_s[i] = s * lam_s[i];
  }
  __syncthreads();
  // this rank's share of P·A for the whole tile, sent to each column's owner
  for (int i = threadIdx.x; i < tm * CS; i += THREADS) {
    const int m = i / CS, owner = i % CS;
    float pa[4] = {};
    const float* pr = p_s + m * g.js;
    for (int jj = 0; jj < jn; ++jj) {
      const float p = pr[jj];
      const float4 a = load4(as + jj * TN + owner * OUT);
      pa[0] = fmaf(p, a.x, pa[0]);
      pa[1] = fmaf(p, a.y, pa[1]);
      pa[2] = fmaf(p, a.z, pa[2]);
      pa[3] = fmaf(p, a.w, pa[3]);
    }
    st_cluster(recv_pa + (rank * g.tm + m) * OUT, owner, make_float4(pa[0], pa[1], pa[2], pa[3]));
  }
  cluster_sync();  // no shared memory of another CTA is touched after this

  // this rank's 4 columns: both sums in rank order, the adapter term added
  // once (on a q after the x·q sum is dequantized and rounded)
  for (int i = threadIdx.x; i < tm * OUT; i += THREADS) {
    const int m = i / OUT, c = i % OUT, n = n0 + rank * OUT + c;
    float xw = 0.f, pa = 0.f;
#pragma unroll
    for (int q = 0; q < CS; ++q) {
      xw += recv_w[(q * g.tm + m) * OUT + c];
      pa += recv_pa[(q * g.tm + m) * OUT + c];
    }
    if constexpr (kQuant) xw = __fmul_rn(xw, ws_s[c]);
    if (n < N) y[(size_t)(m0 + m) * N + n] = from_f<TX>(__fadd_rn(xw, __fmul_rn(pa, scale)));
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename TX, typename TW, bool kRows>
int launch_cluster(const void* x, const void* W, const float* w_scale, const void* B,
                   const void* A, const float* lam, const int* seg, void* y, int M, int K, int N,
                   int r, int n_slots, float scale, cudaStream_t stream) {
  if (M == 0 || N == 0) return 0;
  if (r > R_MAX) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int SZ = sizeof(TX), V = 16 / SZ, VW = std::max<int>(8, 16 / sizeof(TW));
  const Geo g = make_geo(M, K, r, SZ == 2, sizeof(TW) == 1);
  const bool vec = K % V == 0 && N % VW == 0 && r % 8 == 0 && aligned16(x) && aligned16(W) &&
                   aligned16(B) && aligned16(A);
  auto* kernel = bgmv_cluster_kernel<TX, TW, kRows>;
  if (g.bytes > 48 * 1024) {  // on every such launch: the attribute holds for the current device only
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  const dim3 grid(ceil_div(N, TN) * CS, ceil_div(M, TM));
  kernel<<<grid, THREADS, g.bytes, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(W), w_scale, static_cast<const bf16*>(B),
      static_cast<const bf16*>(A), lam, seg, static_cast<TX*>(y), M, K, N, r, n_slots, scale, g,
      vec);
  return static_cast<int>(cudaGetLastError());
}

// w_kind: W in x's dtype (0), or an int8 (1) or fp8-e4m3 (2) q.
template <typename TX, bool kRows>
int launch_kind(int w_kind, const void* x, const void* W, const float* w_scale, const void* B,
                const void* A, const float* lam, const int* seg, void* y, int M, int K, int N,
                int r, int n_slots, float scale, cudaStream_t stream) {
  if (w_kind == 1)
    return launch_cluster<TX, int8_t, kRows>(x, W, w_scale, B, A, lam, seg, y, M, K, N, r,
                                             n_slots, scale, stream);
  if (w_kind == 2)
    return launch_cluster<TX, fp8, kRows>(x, W, w_scale, B, A, lam, seg, y, M, K, N, r, n_slots,
                                          scale, stream);
  return launch_cluster<TX, TX, kRows>(x, W, w_scale, B, A, lam, seg, y, M, K, N, r, n_slots,
                                       scale, stream);
}

template <bool kRows>
int launch(int x_bf16, int w_kind, const void* x, const void* W, const float* w_scale,
           const void* B, const void* A, const float* lam, const int* seg, void* y, int M, int K,
           int N, int r, int n_slots, float scale, cudaStream_t stream) {
  if (x_bf16)
    return launch_kind<bf16, kRows>(w_kind, x, W, w_scale, B, A, lam, seg, y, M, K, N, r,
                                    n_slots, scale, stream);
  return launch_kind<float, kRows>(w_kind, x, W, w_scale, B, A, lam, seg, y, M, K, N, r, n_slots,
                                   scale, stream);
}

}  // namespace

// x, W, y share one dtype (x_bf16 = 1 selects bfloat16, 0 float32); the
// QR factors B, A are bfloat16 under either, as the reference keeps them;
// r ≤ 256.  Returns the CUDA error code of the launch (0 on success).
extern "C" int qrlora_bgmv_launch(const void* x, const void* W, const void* B, const void* A,
                                  const float* lam, const int* seg, void* y, int M, int K, int N,
                                  int r, int n_slots, float scale, int x_bf16,
                                  cudaStream_t stream) {
  return launch<false>(x_bf16, 0, x, W, nullptr, B, A, lam, seg, y, M, K, N, r, n_slots, scale,
                       stream);
}

// The quantized base: q (K, N) int8 (q_fp8 = 0) or fp8-e4m3 (q_fp8 = 1)
// with w_scale (N,) float32; x and y bfloat16 (x_bf16 = 1) or float32;
// r ≤ 256.  Returns the CUDA error code (0 on success).
extern "C" int qrlora_bgmv_quant_launch(const void* x, const void* q, const float* w_scale,
                                        const void* B, const void* A, const float* lam,
                                        const int* seg, void* y, int M, int K, int N, int r,
                                        int n_slots, float scale, int x_bf16, int q_fp8,
                                        cudaStream_t stream) {
  return launch<false>(x_bf16, q_fp8 ? 2 : 1, x, q, w_scale, B, A, lam, seg, y, M, K, N, r,
                       n_slots, scale, stream);
}

// Pre-gathered λ: rows (M, r) float32 in place of Λ and seg; W (K, N) in
// x's dtype (w_kind = 0; w_scale unused, may be null) or int8 (1) or
// fp8-e4m3 (2) q with its w_scale (N,) float32; x and y bfloat16
// (x_bf16 = 1) or float32, B and A bfloat16; r ≤ 256.  Returns the CUDA
// error code (0 on success).
extern "C" int qrlora_bgmv_rows_launch(const void* x, const void* W, const float* w_scale,
                                       const void* B, const void* A, const float* rows, void* y,
                                       int M, int K, int N, int r, float scale, int x_bf16,
                                       int w_kind, cudaStream_t stream) {
  return launch<true>(x_bf16, w_kind, x, W, w_scale, B, A, rows, nullptr, y, M, K, N, r, M, scale,
                      stream);
}

// How a launch (x_bf16 and w_kind as above) splits its work, in the numbers
// the kernel uses: plan[0] the cluster size, plan[1] and plan[2] the grid
// (x: column tiles × cluster size, y: row tiles), plan[3] the CTAs,
// plan[4] the K rows of a rank's slice, plan[5] the rank columns of P a
// rank sums, plan[6] the dynamic shared memory of a CTA in bytes.
extern "C" void qrlora_bgmv_plan(int M, int K, int N, int r, int x_bf16, int w_kind, int* plan) {
  const Geo g = make_geo(M, K, r, x_bf16 != 0, w_kind != 0);
  plan[0] = CS;
  plan[1] = ceil_div(N, TN) * CS;
  plan[2] = ceil_div(M, TM);
  plan[3] = plan[1] * plan[2];
  plan[4] = g.ks;
  plan[5] = g.js;
  plan[6] = g.bytes;
}

extern "C" const char* qrlora_bgmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
