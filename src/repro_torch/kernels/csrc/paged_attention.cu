// Paged decode attention for Hopper (sm_90a): one query per lane, GQA, over
// the KV pool blocks named by the lane's block-table row.
//
//   out[b, h] = softmax_t(q[b,h]·k[b,t] / √dh) · v[b,t],  t < lengths[b]
//   k[b, t]   = k_pool[block_tbl[b, t / bs], t % bs, h / (H/KV)]
//
// Replaces repro/kernels/paged_attention.py::paged_decode_attention_kernel
// (_kernel).  The TPU kernel gathers a lane's whole (max_blocks·bs, KV, dh)
// view into VMEM and takes one full-width softmax; at long lengths that does
// not fit in an SM's shared memory.  Here one block serves one (lane, kv
// head) pair and its GQA group of H/KV query heads, reads its own table row
// and length, and streams the lane's valid blocks one at a time through
// shared memory with an online softmax (fp32 running max, sum and
// accumulator).  Table entries past the length are never read, so stale
// entries and trash block 0 cannot contribute; a lane of length 0 writes
// zeros, as the TPU kernel does.
//
// Bound on the card: reading the valid K/V rows once — at 4 lanes × 3 kv
// heads × 64 dims × 2 B × 2 (K, V) = 3 KB per token of context, ~0.3 MB per
// layer at 100 tokens, well under a microsecond at 3.35 TB/s.  This first
// version launches B·KV blocks (12 at the serving shapes) and does the dot
// products on the CUDA cores; splitting long lanes over several blocks comes
// later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int THREADS = 128;
constexpr int MAX_OUT = 4;  // outputs per thread: (H/KV)·dh ≤ THREADS·MAX_OUT

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ tbl,
                    const int* __restrict__ lengths, T* __restrict__ out, int H, int KV,
                    int dh, int bs, int n_blocks, int max_blocks, int tbl_stride, float scale) {
  const int b = blockIdx.x, g = blockIdx.y, rep = H / KV, tid = threadIdx.x;
  extern __shared__ float smem[];
  float* qs = smem;             // (rep, dh)  the group's queries
  float* ks = qs + rep * dh;    // (bs, dh)   one pool block of kv head g
  float* vs = ks + bs * dh;     // (bs, dh)
  float* ps = vs + bs * dh;     // (rep, bs)  scores, then probabilities
  float* mrow = ps + rep * bs;  // (rep,)     running max
  float* lrow = mrow + rep;     // (rep,)     running sum
  float* corr = lrow + rep;     // (rep,)     rescale of this block's step

  const T* qg = q + ((size_t)b * H + (size_t)g * rep) * dh;
  for (int i = tid; i < rep * dh; i += THREADS) qs[i] = to_f(qg[i]);
  if (tid < rep) {
    mrow[tid] = -INFINITY;
    lrow[tid] = 0.f;
  }
  float acc[MAX_OUT];
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) acc[j] = 0.f;

  const int len = min(max(lengths[b], 0), max_blocks * bs);
  const int nblk = (len + bs - 1) / bs;
  __syncthreads();

  for (int i = 0; i < nblk; ++i) {
    const int blk = tbl[(size_t)b * tbl_stride + i];
    const bool ok = blk >= 0 && blk < n_blocks;  // a corrupt entry reads nothing
    for (int e = tid; e < bs * dh; e += THREADS) {
      const int t = e / dh, d = e % dh;
      const size_t off = (((size_t)blk * bs + t) * KV + g) * dh + d;
      ks[e] = ok ? to_f(k_pool[off]) : 0.f;
      vs[e] = ok ? to_f(v_pool[off]) : 0.f;
    }
    __syncthreads();

    for (int e = tid; e < rep * bs; e += THREADS) {
      const int h = e / bs, t = e % bs;
      float s = -INFINITY;
      if (ok && i * bs + t < len) {
        float dot = 0.f;
        for (int d = 0; d < dh; ++d) dot = fmaf(qs[h * dh + d], ks[t * dh + d], dot);
        s = dot * scale;
      }
      ps[e] = s;
    }
    __syncthreads();

    if (tid < rep) {
      float* row = ps + tid * bs;
      float mx = mrow[tid];
      for (int t = 0; t < bs; ++t) mx = fmaxf(mx, row[t]);
      if (mx == -INFINITY) {  // nothing valid yet: leave the state as it is
        corr[tid] = 1.f;
        for (int t = 0; t < bs; ++t) row[t] = 0.f;
      } else {
        const float c = expf(mrow[tid] - mx);
        float sum = 0.f;
        for (int t = 0; t < bs; ++t) {
          const float p = expf(row[t] - mx);
          row[t] = p;
          sum += p;
        }
        lrow[tid] = lrow[tid] * c + sum;
        mrow[tid] = mx;
        corr[tid] = c;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < MAX_OUT; ++j) {
      const int o = tid + j * THREADS;
      if (o < rep * dh) {
        const int h = o / dh, d = o % dh;
        float a = acc[j] * corr[h];
        for (int t = 0; t < bs; ++t) a = fmaf(ps[h * bs + t], vs[t * dh + d], a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }

  T* og = out + ((size_t)b * H + (size_t)g * rep) * dh;
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) {
    const int o = tid + j * THREADS;
    if (o < rep * dh) {
      const float l = lrow[o / dh];
      og[o] = from_f<T>(l > 0.f ? acc[j] / l : 0.f);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const int* tbl,
           const int* lengths, void* out, int B, int H, int KV, int dh, int bs, int n_blocks,
           int max_blocks, int tbl_stride, float scale, cudaStream_t stream) {
  if (B == 0) return 0;
  const int rep = H / KV;
  const size_t smem = sizeof(float) * (rep * dh + 2 * bs * dh + rep * bs + 3 * rep);
  const dim3 grid(B, KV);
  paged_decode_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      tbl, lengths, static_cast<T*>(out), H, KV, dh, bs, n_blocks, max_blocks, tbl_stride,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, dh); pools (n_blocks, bs, KV, dh); tbl rows of max_blocks int32
// entries, tbl_stride apart; lengths (B,) int32; out (B, H, dh).  bf16 = 1
// selects bfloat16 tensors, 0 float32.  Returns the CUDA error code.
extern "C" int paged_decode_launch(const void* q, const void* k_pool, const void* v_pool,
                                   const int* tbl, const int* lengths, void* out, int B, int H,
                                   int KV, int dh, int bs, int n_blocks, int max_blocks,
                                   int tbl_stride, float scale, int bf16,
                                   cudaStream_t stream) {
  if (bf16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tbl, lengths, out, B, H, KV, dh, bs,
                                 n_blocks, max_blocks, tbl_stride, scale, stream);
  return launch<float>(q, k_pool, v_pool, tbl, lengths, out, B, H, KV, dh, bs, n_blocks,
                       max_blocks, tbl_stride, scale, stream);
}

extern "C" const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
