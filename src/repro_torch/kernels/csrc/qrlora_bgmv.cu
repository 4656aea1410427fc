// Batched multi-λ QR-LoRA matmul (BGMV) for Hopper (sm_90a).
//
//   y[m, n] = Σ_k x[m,k]·W[k,n] + scale · Σ_j P[m,j]·A[j,n]
//   P[m, j] = (Σ_k x[m,k]·B[k,j]) · Λ[seg[m], j]
//
// Replaces repro/kernels/qrlora_bgmv.py::qrlora_bgmv_kernel (_kernel).  That
// TPU kernel carries the (bm, r) x·B accumulator across its N grid axis,
// which only works because a TPU grid runs in order, and gathers λ rows with
// a one-hot × table matmul.  Blocks of a CUDA grid run in no order, so the
// low-rank projection is a first small pass writing P (M, r) in fp32, and
// the main pass adds P·A_tile in its epilogue; λ rows are loaded by index.
//
// Bound on the card: at decode (M = lanes = 4, K = 576, N = 576, bf16) the
// work is reading W once — 576·576·2 B ≈ 0.66 MB, ≈ 0.2 µs at 3.35 TB/s; the
// flops (2·M·K·N ≈ 2.7 MFLOP) are negligible.  Prefill rows (M = bucket)
// stay far below the 295 flop/byte ridge too.  This version is a plain
// shared-memory tiled kernel on the CUDA cores with fp32 accumulation.  At
// decode it is latency-bound, not bandwidth-bound: few blocks (ceil(N/32)
// for the main pass), each walking K in a handful of deep tiles so many
// loads are in flight per thread; the low-rank pass splits K over 8 warps
// per block.  wgmma, TMA, double buffering and split-K come later.
//
// Both passes compute each output row from that row alone, in a fixed
// order, so a row's result does not depend on M or on its neighbours.
// Rows past M in the last row tile read as zeros with slot 0 (λ ≡ 0): the
// reference's padded rows, handled in the kernel instead of by padding x.
//
// Quantized base (replaces repro/kernels/qrlora_bgmv.py::
// qrlora_bgmv_quant_kernel, _kernel_q): the main pass streams q (K, N) int8
// or fp8-e4m3, one byte an element, instead of W, widens it to fp32 as it
// stages a tile (exact, and an fp32 product of a bf16 or fp32 x with it is
// exact too), and computes
//   y[m, n] = (Σ_k x[m,k]·q[k,n]) · w_scale[n] + scale · Σ_j P[m,j]·A[j,n],
// the dequant multiply rounded in fp32 before the adapter term is added
// (__fmul_rn / __fadd_rn: no FMA contraction, the reference's order); the
// scale never touches the adapter term.  The low-rank pass is the same.  At
// decode (M = 4, K = N = 576) the bound is reading q, the factors and the
// scales once — ≈ 0.64 MB, ≈ 0.19 µs at 3.35 TB/s, against ≈ 0.29 µs for
// the bf16 W.
//
// Pre-gathered λ rows (replaces repro/kernels/qrlora_bgmv.py::
// qrlora_bgmv_rows_kernel, _kernel_rows): the sharded-λ serve all-reduces
// each row's λ (M, r) fp32 before the kernel, so pass 1 reads rows[m]
// where the BGMV kernel reads Λ[seg[m]], and computes
//   y[m, n] = (Σ_k x[m,k]·W[k,n]) · w_scale[n] + scale · Σ_j P[m,j]·A[j,n]
// for W in x's dtype (w_scale all ones: ×1.0 is exact, so with
// rows = Λ[seg] the result is bitwise the BGMV kernel's) or int8/fp8 q (the
// quantized main pass, bitwise the quantized BGMV kernel's).  Both passes
// are the BGMV kernel's own instantiations, so the summation order is
// shared.  Bound at decode: reading x, W, B, A, rows and w_scale once and
// writing y, ≈ 0.97 MB (bf16 W) or ≈ 0.64 MB (int8/fp8 q) at K = N = 576,
// r = 128: ≈ 0.29 / 0.19 µs at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int LR_COLS = 32, LR_SLICES = 8;  // 256 threads: 8 K-slices × 32 rank columns

// Pass 1: block (m, y) computes P[m, 32y … 32y+31].  The row of x is staged
// in shared memory; warp s walks its slice of K over 32 consecutive columns
// of B (coalesced), and the 8 partial sums are added in a fixed order.  λ
// comes from the table row Λ[seg[m]] or, with kRows, from lam = rows (M, r)
// at row m (seg unused).  A slot id outside [0, n_slots) gives a zero row
// rather than an out-of-bounds read.
template <typename TX, bool kRows>
__global__ void __launch_bounds__(LR_COLS * LR_SLICES)
lowrank_kernel(const TX* __restrict__ x, const __nv_bfloat16* __restrict__ B,
               const float* __restrict__ lam, const int* __restrict__ seg,
               float* __restrict__ P, int K, int r, int n_slots) {
  extern __shared__ float xs[];  // K floats
  __shared__ float part[LR_SLICES][LR_COLS];
  const int m = blockIdx.x;
  const int lane = threadIdx.x % LR_COLS, slice = threadIdx.x / LR_COLS;
  const int j = blockIdx.y * LR_COLS + lane;
  for (int k = threadIdx.x; k < K; k += blockDim.x) xs[k] = to_f(x[(size_t)m * K + k]);
  __syncthreads();
  float acc = 0.f;
  if (j < r) {
    const int per = (K + LR_SLICES - 1) / LR_SLICES;
    const int k1 = min(K, (slice + 1) * per);
#pragma unroll 8
    for (int k = slice * per; k < k1; ++k) acc = fmaf(xs[k], to_f(B[(size_t)k * r + j]), acc);
  }
  part[slice][lane] = acc;
  __syncthreads();
  if (slice == 0 && j < r) {
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < LR_SLICES; ++s) sum += part[s][lane];
    if constexpr (kRows) {
      P[(size_t)m * r + j] = sum * lam[(size_t)m * r + j];
    } else {
      const int sg = seg[m];
      P[(size_t)m * r + j] = (sg >= 0 && sg < n_slots) ? sum * lam[(size_t)sg * r + j] : 0.f;
    }
  }
}

constexpr int BM = 16, BN = 32, BK = 128, MAIN_THREADS = 256;
constexpr int CPT = BN / 16;  // output columns per thread

static_assert(BM * BK % MAIN_THREADS == 0 && BK * BN % MAIN_THREADS == 0,
              "tiles split evenly over the block's threads");

// Stage a (BM × BK) tile of a row-major (rows × cols) matrix starting at
// (r0, c0), as fp32, zero-filled past the edges.  The trip count is a
// constant, so the loop unrolls and a thread's loads are all in flight at
// once.
template <typename T>
__device__ __forceinline__ void stage_rows(float (*dst)[BK + 1], const T* __restrict__ src,
                                           int r0, int c0, int rows, int cols) {
#pragma unroll
  for (int t = 0; t < BM * BK / MAIN_THREADS; ++t) {
    const int i = t * MAIN_THREADS + threadIdx.x;
    const int rr = i / BK, cc = i % BK, gr = r0 + rr, gc = c0 + cc;
    dst[rr][cc] = (gr < rows && gc < cols) ? to_f(src[(size_t)gr * cols + gc]) : 0.f;
  }
}

// Stage a (BK × BN) tile of a row-major (rows × cols) matrix at (r0, c0).
template <typename T>
__device__ __forceinline__ void stage_cols(float (*dst)[BN], const T* __restrict__ src,
                                           int r0, int c0, int rows, int cols) {
#pragma unroll
  for (int t = 0; t < BK * BN / MAIN_THREADS; ++t) {
    const int i = t * MAIN_THREADS + threadIdx.x;
    const int rr = i / BN, cc = i % BN, gr = r0 + rr, gc = c0 + cc;
    dst[rr][cc] = (gr < rows && gc < cols) ? to_f(src[(size_t)gr * cols + gc]) : 0.f;
  }
}

// Pass 2: one block per (BM × BN) output tile; thread t owns row t / 16 and
// the CPT columns CPT·(t % 16) … of the tile.  W is TX, or 1-byte q whose
// columns w_scale dequantizes in the epilogue.  kWs multiplies a TX W's sum
// by w_scale too (the rows kernel's epilogue), rounded before the FMA that
// adds the adapter term.
template <typename TX, typename TW, bool kWs>
__global__ void __launch_bounds__(MAIN_THREADS)
bgmv_main_kernel(const TX* __restrict__ x, const TW* __restrict__ W,
                 const float* __restrict__ w_scale, const float* __restrict__ P,
                 const __nv_bfloat16* __restrict__ A, TX* __restrict__ y, int M, int K, int N,
                 int r, float scale) {
  constexpr bool kQuant = sizeof(TW) == 1;
  __shared__ float rs[BM][BK + 1];
  __shared__ float cs[BK][BN];
  const int row = threadIdx.x / 16, c0 = (threadIdx.x % 16) * CPT;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[CPT] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    stage_rows(rs, x, m0, k0, M, K);
    stage_cols(cs, W, k0, n0, K, N);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float a = rs[row][kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] = fmaf(a, cs[kk][c0 + c], acc[c]);
    }
    __syncthreads();
  }

  float low[CPT] = {};
  for (int j0 = 0; j0 < r; j0 += BK) {
    stage_rows(rs, P, m0, j0, M, r);
    stage_cols(cs, A, j0, n0, r, N);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      const float p = rs[row][jj];
#pragma unroll
      for (int c = 0; c < CPT; ++c) low[c] = fmaf(p, cs[jj][c0 + c], low[c]);
    }
    __syncthreads();
  }

  const int m = m0 + row;
  if (m >= M) return;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int n = n0 + c0 + c;
    if (n >= N) continue;
    if constexpr (kQuant)  // dequant rounded first, then the adapter term
      y[(size_t)m * N + n] =
          from_f<TX>(__fadd_rn(__fmul_rn(acc[c], w_scale[n]), __fmul_rn(low[c], scale)));
    else
      y[(size_t)m * N + n] =
          from_f<TX>(fmaf(low[c], scale, kWs ? __fmul_rn(acc[c], w_scale[n]) : acc[c]));
  }
}

// kRows: λ comes as pre-gathered rows (M, r) in lam, and a TX W's sum is
// scaled by w_scale; a 1-byte q takes the quantized main pass either way.
template <typename TX, typename TW, bool kRows = false>
int launch(const void* x, const void* W, const float* w_scale, const void* B, const void* A,
           const float* lam, const int* seg, float* P, void* y, int M, int K, int N, int r,
           int n_slots, float scale, cudaStream_t stream) {
  if (M == 0) return 0;
  constexpr bool kWs = kRows && sizeof(TW) != 1;
  const dim3 lr_grid(M, (r + LR_COLS - 1) / LR_COLS);
  lowrank_kernel<TX, kRows><<<lr_grid, LR_COLS * LR_SLICES, K * sizeof(float), stream>>>(
      static_cast<const TX*>(x), static_cast<const __nv_bfloat16*>(B), lam, seg, P, K, r,
      n_slots);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  bgmv_main_kernel<TX, TW, kWs><<<grid, MAIN_THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(W), w_scale, P,
      static_cast<const __nv_bfloat16*>(A), static_cast<TX*>(y), M, K, N, r, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, W, y share one dtype (x_bf16 = 1 selects bfloat16, 0 float32); the
// QR factors B, A are bfloat16 under either, as the reference keeps them.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int qrlora_bgmv_launch(const void* x, const void* W, const void* B, const void* A,
                                  const float* lam, const int* seg, float* P, void* y, int M,
                                  int K, int N, int r, int n_slots, float scale, int x_bf16,
                                  cudaStream_t stream) {
  if (x_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, W, nullptr, B, A, lam, seg, P, y, M, K, N, r,
                                                n_slots, scale, stream);
  return launch<float, float>(x, W, nullptr, B, A, lam, seg, P, y, M, K, N, r, n_slots, scale,
                              stream);
}

// The quantized base: q (K, N) int8 (q_fp8 = 0) or fp8-e4m3 (q_fp8 = 1)
// with w_scale (N,) float32; x and y bfloat16 (x_bf16 = 1) or float32, the
// rest as qrlora_bgmv_launch.  Returns the CUDA error code (0 on success).
extern "C" int qrlora_bgmv_quant_launch(const void* x, const void* q, const float* w_scale,
                                        const void* B, const void* A, const float* lam,
                                        const int* seg, float* P, void* y, int M, int K, int N,
                                        int r, int n_slots, float scale, int x_bf16, int q_fp8,
                                        cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  using fp8 = __nv_fp8_e4m3;
  if (x_bf16 && q_fp8)
    return launch<bf16, fp8>(x, q, w_scale, B, A, lam, seg, P, y, M, K, N, r, n_slots, scale,
                             stream);
  if (x_bf16)
    return launch<bf16, int8_t>(x, q, w_scale, B, A, lam, seg, P, y, M, K, N, r, n_slots, scale,
                                stream);
  if (q_fp8)
    return launch<float, fp8>(x, q, w_scale, B, A, lam, seg, P, y, M, K, N, r, n_slots, scale,
                              stream);
  return launch<float, int8_t>(x, q, w_scale, B, A, lam, seg, P, y, M, K, N, r, n_slots, scale,
                               stream);
}

// Pre-gathered λ: rows (M, r) float32 in place of Λ and seg; W (K, N) in
// x's dtype (w_kind = 0, w_scale all ones) or int8 (1) or fp8-e4m3 (2) q with
// its w_scale (N,) float32; x and y bfloat16 (x_bf16 = 1) or float32, B and A
// bfloat16.  Returns the CUDA error code (0 on success).
extern "C" int qrlora_bgmv_rows_launch(const void* x, const void* W, const float* w_scale,
                                       const void* B, const void* A, const float* rows, float* P,
                                       void* y, int M, int K, int N, int r, float scale,
                                       int x_bf16, int w_kind, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  using fp8 = __nv_fp8_e4m3;
  if (x_bf16) {
    if (w_kind == 1)
      return launch<bf16, int8_t, true>(x, W, w_scale, B, A, rows, nullptr, P, y, M, K, N, r, M,
                                        scale, stream);
    if (w_kind == 2)
      return launch<bf16, fp8, true>(x, W, w_scale, B, A, rows, nullptr, P, y, M, K, N, r, M,
                                     scale, stream);
    return launch<bf16, bf16, true>(x, W, w_scale, B, A, rows, nullptr, P, y, M, K, N, r, M,
                                    scale, stream);
  }
  if (w_kind == 1)
    return launch<float, int8_t, true>(x, W, w_scale, B, A, rows, nullptr, P, y, M, K, N, r, M,
                                       scale, stream);
  if (w_kind == 2)
    return launch<float, fp8, true>(x, W, w_scale, B, A, rows, nullptr, P, y, M, K, N, r, M,
                                    scale, stream);
  return launch<float, float, true>(x, W, w_scale, B, A, rows, nullptr, P, y, M, K, N, r, M,
                                    scale, stream);
}

extern "C" const char* qrlora_bgmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
