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
// a loop of its own, keeping the online softmax state (fp32 running max and
// sum, fp32 accumulator) in registers.  Query head h reads kv head h/(H/KV)
// straight from the (B, Sk, KV, dh) tensors, so K/V are never repeated in
// memory, and the tensors are read through their strides in the model
// layout (no transposes around the call).  KV tiles wholly above the
// diagonal are never loaded; the diagonal tiles mask kpos > qpos.
//
// Per KV tile: K and V (64 rows) are staged in shared memory (16-byte copies
// where the strides and the base allow, else one element at a time), then
// each warp works on its own 16 query rows only: S = Q·Kᵀ (bf16: wmma
// 16×16×16 fragments on the tensor cores with fp32 accumulators; float32:
// fp32 FMAs on the CUDA cores), scale, mask and online softmax in fp32 (two
// threads per row), then acc = acc·α + P·V.  In bf16 the probabilities are
// rounded to bf16 before P·V, as the TPU kernel does; the row sum uses them
// unrounded.
//
// Bound on the card: at smollm-135m's training shape (B = 8, S = 256, 9
// heads over 3 kv heads, dh 64, causal, bf16) the work is ≈ 0.6 GFLOP
// against ≈ 6.3 MB of q, k, v and out, so it is bound by bytes (≈ 1.9 µs at
// 3.35 TB/s; ≈ 0.6 µs of tensor-core time).  This first version stages
// tiles synchronously (no cp.async pipeline, TMA or wgmma) and goes through
// shared memory between the two products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// 64 query rows × 64 keys a step, 4 warps; warp w owns query rows 16w … 16w+15
// in every phase after the K/V tile is staged.
constexpr int BQ = 64, BK = 64, THREADS = 128;
constexpr int SLD = BK + 4;  // fp32 score rows (wmma: ldm a multiple of 4)
constexpr int PLD = BK + 8;  // bf16 probability rows (wmma: ldm a multiple of 8)

struct Strides {
  long long b, s, h;  // elements; the head dimension has unit stride
};

// Leading dimension of the q/k/v tiles in shared memory: padded to stagger
// the banks, and rows 16-byte aligned for the 16-byte copies.
template <typename T, int DH>
__host__ __device__ constexpr int tile_ld() {
  return std::is_same<T, bf16>::value ? DH + 8 : DH + 4;
}

template <typename T, int DH>
constexpr size_t smem_bytes() {
  constexpr bool tc = std::is_same<T, bf16>::value;
  return 3 * BQ * tile_ld<T, DH>() * sizeof(T) + BQ * SLD * sizeof(float) +
         (tc ? BQ * PLD * sizeof(bf16) + BQ * (DH + 4) * sizeof(float) : 0) +
         2 * BQ * sizeof(float);
}

// Stage rows r0 … r0+63 of one head (row stride rs) into dst, zeros past
// row n.  vec: base and strides allow 16-byte copies.
template <typename T, int DH, int LD>
__device__ __forceinline__ void stage(T* dst, const T* src, long long rs, int r0, int n,
                                      bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T), C = DH / E;  // elements a copy, copies a row
    for (int i = threadIdx.x; i < BQ * C; i += THREADS) {
      const int r = i / C, c = (i % C) * E;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < n) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * rs + c);
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < BQ * DH; i += THREADS) {
      const int r = i / DH, c = i % DH;
      dst[r * LD + c] = r0 + r < n ? src[(r0 + r) * rs + c] : from_f<T>(0.f);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int Sq, int Sk, int H, int KV, Strides qs_, Strides ks_,
             Strides vs_, Strides os_, float scale, int causal, int vec) {
  namespace wmma = nvcuda::wmma;
  constexpr bool TC = std::is_same<T, bf16>::value;
  constexpr int LD = tile_ld<T, DH>(), OLD = DH + 4, OC = DH / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);                        // BQ × LD
  T* ks = qs + BQ * LD;                                          // BK × LD
  T* vs = ks + BK * LD;                                          // BK × LD
  float* ss = reinterpret_cast<float*>(vs + BK * LD);            // BQ × SLD scores, then p
  bf16* ps = reinterpret_cast<bf16*>(ss + BQ * SLD);             // BQ × PLD bf16 p (TC)
  float* os = reinterpret_cast<float*>(ps + (TC ? BQ * PLD : 0));  // BQ × OLD P·V (TC)
  float* alpha_s = os + (TC ? BQ * OLD : 0);                     // BQ rescale of this step
  float* l_s = alpha_s + BQ;                                     // BQ final row sums

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV), tid = threadIdx.x, warp = tid / 32;
  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* kb = k + b * ks_.b + g * ks_.h;
  const T* vb = v + b * vs_.b + g * vs_.h;
  stage<T, DH, LD>(qs, qb, qs_.s, q0, Sq, vec);

  int n_kt = (Sk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);  // tiles above the diagonal: skipped

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
    stage<T, DH, LD>(ks, kb, ks_.s, k0, Sk, vec);
    stage<T, DH, LD>(vs, vb, vs_.s, k0, Sk, vec);
    __syncthreads();

    // S = Q·Kᵀ for this warp's 16 rows
    if constexpr (TC) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[BK / 16];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(sf[j], 0.f);
#pragma unroll
      for (int d = 0; d < DH; d += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, qs + warp * 16 * LD + d, LD);
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;  // Kᵀ
          wmma::load_matrix_sync(kf, ks + j * 16 * LD + d, LD);
          wmma::mma_sync(sf[j], a, kf, sf[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wmma::store_matrix_sync(ss + warp * 16 * SLD + j * 16, sf[j], SLD, wmma::mem_row_major);
    } else {
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
    }
    __syncwarp();

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
        if constexpr (TC) ps[srow * PLD + c] = __float2bfloat16(p);
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (!shalf) alpha_s[srow] = alpha;
    }
    __syncwarp();

    // acc = acc·α + P·V
    if constexpr (TC) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[DH / 16];
#pragma unroll
      for (int n = 0; n < DH / 16; ++n) wmma::fill_fragment(of[n], 0.f);
#pragma unroll
      for (int c = 0; c < BK; c += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::load_matrix_sync(pf, ps + warp * 16 * PLD + c, PLD);
#pragma unroll
        for (int n = 0; n < DH / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
          wmma::load_matrix_sync(vf, vs + c * LD + n * 16, LD);
          wmma::mma_sync(of[n], pf, vf, of[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < DH / 16; ++n)
        wmma::store_matrix_sync(os + warp * 16 * OLD + n * 16, of[n], OLD, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float al = alpha_s[4 * ty + i];
#pragma unroll
        for (int j = 0; j < OC; ++j)
          acc[i][j] = fmaf(acc[i][j], al, os[(4 * ty + i) * OLD + tx + 8 * j]);
      }
    } else {
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
  }

  if (!shalf) l_s[srow] = l_run;
  __syncwarp();
  T* ob = out + b * os_.b + h * os_.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (q0 + r < Sq) {
      const float l = l_s[r];
#pragma unroll
      for (int j = 0; j < OC; ++j)
        ob[(q0 + r) * os_.s + tx + 8 * j] = from_f<T>(l > 0.f ? acc[i][j] / l : 0.f);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk, int H,
           int KV, Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal,
           int vec, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DH>();
  static bool configured = false;  // above 48 KB, dynamic shared memory must be asked for
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_kernel<T, DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, H, KV, qs, ks, vs, os, scale, causal, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v, void* out, int B, int Sq,
              int Sk, int H, int KV, Strides qs, Strides ks, Strides vs, Strides os, float scale,
              int causal, int vec, cudaStream_t stream) {
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, out, B, Sq, Sk, H, KV, qs, ks, vs, os, scale, causal, vec,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, out, B, Sq, Sk, H, KV, qs, ks, vs, os, scale, causal, vec,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, KV, qs, ks, vs, os, scale, causal, vec,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, KV, qs, ks, vs, os, scale, causal, vec,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
  if (bf16)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, out, B, Sq, Sk, H, KV, qs, ks, vs, os, scale,
                                    causal, vec, stream);
  return launch_dh<float>(dh, q, k, v, out, B, Sq, Sk, H, KV, qs, ks, vs, os, scale, causal, vec,
                          stream);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
