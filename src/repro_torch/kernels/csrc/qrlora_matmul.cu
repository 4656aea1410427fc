// One-λ QR-LoRA matmul for Hopper (sm_90a): the forward of the trainable
// adapted projection.
//
//   y[m, n] = Σ_k x[m,k]·W[k,n] + scale · Σ_j P[m,j]·A[j,n]
//   P[m, j] = λ[j] · Σ_k x[m,k]·B[k,j]
//
// Replaces repro/kernels/qrlora_matmul.py::qrlora_matmul_kernel (_kernel).
// That TPU kernel accumulates x·B in a (bm, r) scratch during the first
// n-step of each row block and reuses it for the later n-steps, which only
// works because a TPU grid runs in order.  Blocks of a CUDA grid run in no
// order, so the low-rank projection is a first pass writing P (M, r) in
// fp32, and the main pass adds P·A_tile to its x·W tile in an fp32
// epilogue.  Both passes are one tiled kernel with two epilogues.
//
// Bound on the card: at the training shapes (M = 2048 rows, K = 576,
// N = 576 for wq, r = 128) the work is 2·M·K·(N + r) + 2·M·r·N ≈ 1.96 GFLOP
// against ≈ 5.7 MB moved, so wq is bound by operations (≈ 2.0 µs at
// 989 TFLOP/s bf16) and wv (N = 192, ≈ 3.6 MB) by bytes (≈ 1.1 µs at
// 3.35 TB/s).  This version runs the bf16 x·W and x·B products on the
// tensor cores through wmma (16×16×16 bf16 fragments, fp32 accumulators),
// 64×64 output tiles over 32-deep K steps; bf16 tiles reach shared memory
// by cp.async in 16-byte copies through a two-stage pipeline, so the next
// K step's loads are in flight while the current one multiplies.  The
// float32 instantiation stages and multiplies the same tiles on the CUDA
// cores, and the P·A epilogue is fp32 on the CUDA cores in both, so the
// float32 check stays tight.  No TMA, wgmma or split-K yet.
//
// Each output row is computed from that row alone, in a fixed order.  Rows
// past M in the last row tile, and columns past N or r, read as zeros and
// are never written: a ragged M needs no padded copy of x.  The bf16 path
// needs K, N and r to be multiples of 8 and 16-byte aligned operands (one
// copy is 8 elements); the wrapper checks both.
//
// Quantized base (replaces repro/kernels/qrlora_matmul.py::
// qrlora_matmul_quant_kernel, _kernel_q): the main pass streams q (K, N)
// int8 or fp8-e4m3 instead of W and computes
//   y[m, n] = (Σ_k x[m,k]·q[k,n]) · w_scale[n] + scale · Σ_j P[m,j]·A[j,n],
// the dequant multiply rounded in fp32 before the adapter term is added
// (__fmul_rn / __fadd_rn: no FMA contraction, the reference's order); the
// scale never touches the adapter term.  Widening int8 or fp8-e4m3 to bf16
// is exact, and a bf16 × bf16 product is exact in fp32, so the tensor cores
// form the reference's products: a q tile arrives by cp.async in 16-byte
// copies of 16 elements (K and N multiples of 16, q 16-byte aligned; the
// wrapper checks), is widened to bf16 in shared memory, and goes through the
// same wmma loop.  float32 x widens q to fp32 on the CUDA cores.  At M =
// 2048 rows of K = N = 576 the q bytes halve W's; the work stays bound by
// operations (≈ 2.0 µs at 989 TFLOP/s).  Forward only, as in the reference.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using fp8 = __nv_fp8_e4m3;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f(fp8 v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// 64×64 output tile, 32-deep K steps, 4 warps.  Thread t owns the 8
// contiguous rows 8·(t/16) … and the 4 contiguous columns 4·(t%16) … of the
// tile, so the fp32 loops read their operands as 16-byte shared loads.
constexpr int BM = 64, BN = 64, BK = 32, RC = 32, THREADS = 128;
constexpr int ROWS_PER_T = BM / (THREADS / 16), COLS_PER_T = BN / 16;
// Leading dimensions in shared memory.  wmma wants 32-byte aligned fragment
// rows and a leading dimension that is a multiple of 8 (bf16) or 4 (float);
// the padding also staggers the banks.
constexpr int XLD16 = BK + 8, WLD16 = BN + 8, XLD32 = BK + 1, CLD = BN + 4, PTLD = BM + 4;

static_assert(ROWS_PER_T == 8 && COLS_PER_T == 4, "the fp32 loops read 8 rows and 4 columns");
static_assert(BM * BK % THREADS == 0 && BK * BN % THREADS == 0 && BM * RC % THREADS == 0 &&
                  RC * BN % THREADS == 0 && BM * BK / 8 % THREADS == 0 &&
                  BK * BN / 8 % THREADS == 0,
              "tiles split evenly over the block's threads");

constexpr int cmax(int a, int b) { return a > b ? a : b; }
// One shared buffer, reused phase by phase: the bf16 main loop's two
// stages of x and W tiles (quantized W: two stages of x and raw q tiles
// and one widened bf16 W tile; or the fp32 loop's one stage), then the
// accumulator tile, then the epilogue's P and A chunks.
constexpr int SMEM_BF16 = 2 * (BM * XLD16 + BK * WLD16) * 2;
constexpr int SMEM_WIDEN = (2 * BM * XLD16 + BK * WLD16) * 2 + 2 * BK * BN;
constexpr int SMEM_BYTES = cmax(cmax(cmax(SMEM_BF16, SMEM_WIDEN), (BM * XLD32 + BK * BN) * 4),
                                cmax(BM * CLD * 4, (RC * PTLD + RC * BN) * 4));

// Stage a (ROWS × COLS) tile of a row-major (rows × cols) matrix starting
// at (r0, c0) into dst (leading dimension LD) as TS, zero-filled past the
// edges.  The trip count is a constant, so a thread's loads are all in
// flight at once.
template <int ROWS, int COLS, int LD, typename TS, typename T>
__device__ __forceinline__ void stage(TS* dst, const T* __restrict__ src, int r0, int c0,
                                      int rows, int cols) {
#pragma unroll
  for (int t = 0; t < ROWS * COLS / THREADS; ++t) {
    const int i = t * THREADS + threadIdx.x;
    const int rr = i / COLS, cc = i % COLS, gr = r0 + rr, gc = c0 + cc;
    dst[rr * LD + cc] =
        from_f<TS>((gr < rows && gc < cols) ? to_f(src[(size_t)gr * cols + gc]) : 0.f);
  }
}

// Stage the (ROWS × COLS) tile of a row-major fp32 matrix at (r0, c0)
// transposed: dst[c · LD + r] (global reads stay coalesced along a row).
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void stage_transposed(float* dst, const float* __restrict__ src,
                                                 int r0, int c0, int rows, int cols) {
#pragma unroll
  for (int t = 0; t < ROWS * COLS / THREADS; ++t) {
    const int i = t * THREADS + threadIdx.x;
    const int rr = i / COLS, cc = i % COLS, gr = r0 + rr, gc = c0 + cc;
    dst[cc * LD + rr] = (gr < rows && gc < cols) ? src[(size_t)gr * cols + gc] : 0.f;
  }
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The same without conversion, by cp.async: 16-byte copies of E = 16 /
// sizeof(T) elements (8 bf16, 16 int8 or fp8; cols is a multiple of E, so
// a copy lies wholly inside or outside the matrix; outside ones
// zero-fill).  Completes at cp_async_wait.
template <int ROWS, int COLS, int LD, typename T>
__device__ __forceinline__ void stage_async(T* dst, const T* __restrict__ src, int r0, int c0,
                                            int rows, int cols) {
  constexpr int E = 16 / sizeof(T);
  static_assert(ROWS * COLS / E % THREADS == 0, "copies split evenly over the block's threads");
#pragma unroll
  for (int t = 0; t < ROWS * COLS / E / THREADS; ++t) {
    const int i = t * THREADS + threadIdx.x;
    const int rr = i / (COLS / E), cc = i % (COLS / E) * E, gr = r0 + rr, gc = c0 + cc;
    const bool inside = gr < rows && gc < cols;
    const T* g = inside ? src + (size_t)gr * cols + gc : src;
    const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(dst + rr * LD + cc));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa), "l"(g),
                 "r"(inside ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Widen a (BK × BN) tile of 1-byte q from shared memory (row stride BN) to
// bf16 (row stride WLD16): each thread converts 16 consecutive elements.
template <typename TW>
__device__ __forceinline__ void widen_tile(bf16* dst, const TW* src) {
  static_assert(BK * BN == 16 * THREADS, "one 16-element run per thread");
  const int rr = threadIdx.x / (BN / 16), cc = threadIdx.x % (BN / 16) * 16;
  const uint4 raw = *reinterpret_cast<const uint4*>(src + rr * BN + cc);
  const TW* v = reinterpret_cast<const TW*>(&raw);
  __align__(16) bf16 w[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) w[e] = __float2bfloat16(to_f(v[e]));  // exact
  uint4* d = reinterpret_cast<uint4*>(dst + rr * WLD16 + cc);
  d[0] = reinterpret_cast<const uint4*>(w)[0];
  d[1] = reinterpret_cast<const uint4*>(w)[1];
}

enum Epilogue {
  kScaleColumns = 0,  // out[m,n] = (x·W)[m,n] · v[n]                      (pass 1: P)
  kAddLowRank = 1,    // out[m,n] = (x·W)[m,n] + scale · Σ_j P[m,j]·A[j,n]  (pass 2: y)
};

// C = x·W for one (BM × BN) tile of the (M × N) output, x (M × K), W (K × N),
// then the epilogue EPI.  `aux` is v (N,) for kScaleColumns and P (M × r)
// for kAddLowRank.  When x is bf16 and W bf16 (or 1-byte q, widened to
// bf16 in shared memory) the products run on the tensor cores; otherwise
// the tiles are widened to fp32 in shared memory and multiplied on the CUDA
// cores.  A 1-byte W is quantized: its kAddLowRank epilogue multiplies the
// x·q sum by w_scale[n] before adding the adapter term.
template <typename TX, typename TW, typename TO, int EPI>
__global__ void __launch_bounds__(THREADS)
tile_kernel(const TX* __restrict__ x, const TW* __restrict__ W, const float* __restrict__ aux,
            const bf16* __restrict__ A, const float* __restrict__ w_scale, TO* __restrict__ out,
            int M, int K, int N, int r, float scale) {
  constexpr bool kQuant = sizeof(TW) == 1;
  constexpr bool kWiden = std::is_same<TX, bf16>::value && kQuant;
  constexpr bool kTensor =
      std::is_same<TX, bf16>::value && (std::is_same<TW, bf16>::value || kWiden);
  static_assert(!kQuant || EPI == kAddLowRank, "q only streams through the main pass");
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[ROWS_PER_T][COLS_PER_T] = {};

  if constexpr (kTensor) {
    namespace wmma = nvcuda::wmma;
    // bf16 W: two stages of (x, W) tiles.  Quantized W: two stages of x
    // tiles, one widened W tile, two stages of raw q tiles; the W tile that
    // wmma reads is then the widened one at either stage.
    bf16* xs[2];
    bf16* ws[2];
    TW* qs[2] = {nullptr, nullptr};
    if constexpr (kWiden) {
      xs[0] = reinterpret_cast<bf16*>(smem);
      xs[1] = xs[0] + BM * XLD16;
      ws[0] = ws[1] = xs[1] + BM * XLD16;
      qs[0] = reinterpret_cast<TW*>(ws[0] + BK * WLD16);
      qs[1] = qs[0] + BK * BN;
    } else {
      xs[0] = reinterpret_cast<bf16*>(smem);
      ws[0] = xs[0] + BM * XLD16;
      xs[1] = ws[0] + BK * WLD16;
      ws[1] = xs[1] + BM * XLD16;
    }
    const int warp = threadIdx.x / 32, wm = (warp / 2) * 32, wn = (warp % 2) * 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(f[i][j], 0.f);
    const int nk = (K + BK - 1) / BK;
    if (nk > 0) {
      stage_async<BM, BK, XLD16>(xs[0], x, m0, 0, M, K);
      if constexpr (kWiden)
        stage_async<BK, BN, BN>(qs[0], W, 0, n0, K, N);
      else
        stage_async<BK, BN, WLD16>(ws[0], W, 0, n0, K, N);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      const int cur = kt & 1;
      if (kt + 1 < nk) {  // the next step's tiles load while this one multiplies
        stage_async<BM, BK, XLD16>(xs[cur ^ 1], x, m0, (kt + 1) * BK, M, K);
        if constexpr (kWiden)
          stage_async<BK, BN, BN>(qs[cur ^ 1], W, (kt + 1) * BK, n0, K, N);
        else
          stage_async<BK, BN, WLD16>(ws[cur ^ 1], W, (kt + 1) * BK, n0, K, N);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if constexpr (kWiden) {
        widen_tile(ws[cur], qs[cur]);
        __syncthreads();
      }
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], xs[cur] + (wm + 16 * i) * XLD16 + kk, XLD16);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], ws[cur] + kk * WLD16 + wn + 16 * j, WLD16);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(f[i][j], a[i], b[j], f[i][j]);
      }
      __syncthreads();  // every warp is done with this stage before it is refilled
    }
    float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(cs + (wm + 16 * i) * CLD + wn + 16 * j, f[i][j], CLD,
                                wmma::mem_row_major);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ROWS_PER_T; ++i)
#pragma unroll
      for (int c = 0; c < COLS_PER_T; ++c) acc[i][c] = cs[(8 * ty + i) * CLD + 4 * tx + c];
    __syncthreads();  // the buffer is reused by the epilogue
  } else {
    float* xs = reinterpret_cast<float*>(smem);
    float* ws = xs + BM * XLD32;
    for (int k0 = 0; k0 < K; k0 += BK) {
      stage<BM, BK, XLD32>(xs, x, m0, k0, M, K);
      stage<BK, BN, BN>(ws, W, k0, n0, K, N);
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[ROWS_PER_T];
#pragma unroll
        for (int i = 0; i < ROWS_PER_T; ++i) a[i] = xs[(8 * ty + i) * XLD32 + kk];
        const float4 b4 = lds4(ws + kk * BN + 4 * tx);
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
        if (m < M) out[(size_t)m * N + n] = from_f<TO>(acc[i][c] * v);
      }
    }
  } else {
    float* pt = reinterpret_cast<float*>(smem);  // P chunk, transposed: pt[j · PTLD + row]
    float* as = pt + RC * PTLD;
    float low[ROWS_PER_T][COLS_PER_T] = {};
    for (int j0 = 0; j0 < r; j0 += RC) {
      stage_transposed<BM, RC, PTLD>(pt, aux, m0, j0, M, r);
      stage<RC, BN, BN>(as, A, j0, n0, r, N);
      __syncthreads();
#pragma unroll 8
      for (int jj = 0; jj < RC; ++jj) {
        const float4 p0 = lds4(pt + jj * PTLD + 8 * ty), p1 = lds4(pt + jj * PTLD + 8 * ty + 4);
        const float4 a4 = lds4(as + jj * BN + 4 * tx);
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
          out[(size_t)m * N + n] = from_f<TO>(
              __fadd_rn(__fmul_rn(acc[i][c], dq[c]), __fmul_rn(low[i][c], scale)));
        else
          out[(size_t)m * N + n] = from_f<TO>(acc[i][c] + low[i][c] * scale);
      }
    }
  }
}

// W is TW (K, N): TX for the bf16/float32 base, int8 or fp8 for a
// quantized one, whose per-column w_scale (N,) the main pass applies.
template <typename TX, typename TW>
int launch(const void* x, const void* W, const float* w_scale, const void* B, const void* A,
           const float* lam, float* P, void* y, int M, int K, int N, int r, float scale,
           cudaStream_t stream) {
  if (M == 0 || N == 0) return 0;
  const int row_tiles = (M + BM - 1) / BM;
  if (r > 0) {
    tile_kernel<TX, bf16, float, kScaleColumns>
        <<<dim3((r + BN - 1) / BN, row_tiles), THREADS, 0, stream>>>(
            static_cast<const TX*>(x), static_cast<const bf16*>(B), lam, nullptr, nullptr, P,
            M, K, r, r, 1.f);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tile_kernel<TX, TW, TX, kAddLowRank><<<dim3((N + BN - 1) / BN, row_tiles), THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(W), P, static_cast<const bf16*>(A),
      w_scale, static_cast<TX*>(y), M, K, N, r, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, W, y share one dtype (x_bf16 = 1 selects bfloat16, 0 float32); the QR
// factors B, A are bfloat16 under either, λ float32.  P is (M, r) float32
// scratch.  Returns the CUDA error code of the launches (0 on success).
extern "C" int qrlora_matmul_launch(const void* x, const void* W, const void* B, const void* A,
                                    const float* lam, float* P, void* y, int M, int K, int N,
                                    int r, float scale, int x_bf16, cudaStream_t stream) {
  if (x_bf16) return launch<bf16, bf16>(x, W, nullptr, B, A, lam, P, y, M, K, N, r, scale, stream);
  return launch<float, float>(x, W, nullptr, B, A, lam, P, y, M, K, N, r, scale, stream);
}

// The quantized base: q (K, N) int8 (q_fp8 = 0) or fp8-e4m3 (q_fp8 = 1)
// with w_scale (N,) float32; x and y bfloat16 (x_bf16 = 1) or float32, the
// rest as qrlora_matmul_launch.  Returns the CUDA error code (0 on success).
extern "C" int qrlora_matmul_quant_launch(const void* x, const void* q, const float* w_scale,
                                          const void* B, const void* A, const float* lam,
                                          float* P, void* y, int M, int K, int N, int r,
                                          float scale, int x_bf16, int q_fp8,
                                          cudaStream_t stream) {
  if (x_bf16 && q_fp8)
    return launch<bf16, fp8>(x, q, w_scale, B, A, lam, P, y, M, K, N, r, scale, stream);
  if (x_bf16)
    return launch<bf16, int8_t>(x, q, w_scale, B, A, lam, P, y, M, K, N, r, scale, stream);
  if (q_fp8)
    return launch<float, fp8>(x, q, w_scale, B, A, lam, P, y, M, K, N, r, scale, stream);
  return launch<float, int8_t>(x, q, w_scale, B, A, lam, P, y, M, K, N, r, scale, stream);
}

extern "C" const char* qrlora_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
