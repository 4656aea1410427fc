// Dense decode attention for Hopper (sm_90a): one query per batch row, GQA,
// over a (B, S, KV, dh) cache whose first `length` positions are valid.
//
//   out[b, h] = Σ_{t < length} softmax_t(q[b,h]·k[b,t,g] / √dh) · v[b,t,g],
//   g = h / (H/KV)
//
// Replaces repro/kernels/decode_attention.py::decode_attention_kernel
// (_kernel).  The TPU kernel walks a (B, S/bk) grid in order, carrying the
// online softmax state across KV blocks in VMEM and skipping blocks at or
// past the length.  Here one block serves one (batch row, kv head) pair and
// its GQA group of H/KV query heads, so each K/V row is read once for the
// whole group, and walks the valid prefix in steps of 32 positions through
// shared memory with an online softmax (fp32 running max, sum and
// accumulator).  Positions past the length are never read.  The length is
// one value for the whole batch, taken either from device memory (a 0-d
// int32 tensor: no host synchronisation, so the call can sit in a CUDA
// graph) or as a plain argument; a length of 0 writes zeros, as the TPU
// kernel does.  The probabilities stay in fp32 for P·V, as in the TPU kernel.
//
// Bound on the card: reading the valid K/V rows once — at 4 batch rows,
// length 1000, 3 kv heads, dh 64 in bf16, ≈ 3.1 MB, ≈ 0.9 µs at 3.35 TB/s.
// This first version launches B·KV blocks (12 at that shape, on 132 SMs)
// and does the dot products on the CUDA cores; splitting the length over
// several blocks (flash-decoding) comes later.
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

constexpr int THREADS = 128, WARPS = THREADS / 32;
constexpr int BT = 32;      // cache positions a step: one per lane in the softmax
constexpr int MAX_OUT = 4;  // outputs per thread: (H/KV)·dh ≤ THREADS·MAX_OUT

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
              const T* __restrict__ v_cache, const int* __restrict__ len_ptr, int len_value,
              T* __restrict__ out, int S, int H, int KV, int dh, float scale) {
  const int b = blockIdx.x, g = blockIdx.y, rep = H / KV, tid = threadIdx.x;
  const int kld = dh + 1;  // odd stride: the score loop's lanes read distinct banks
  extern __shared__ float smem[];
  float* qs = smem;             // (rep, dh)  the group's queries
  float* ks = qs + rep * dh;    // (BT, kld)
  float* vs = ks + BT * kld;    // (BT, dh)
  float* ps = vs + BT * dh;     // (rep, BT)  scores, then probabilities
  float* mrow = ps + rep * BT;  // (rep,)     running max
  float* lrow = mrow + rep;     // (rep,)     running sum
  float* corr = lrow + rep;     // (rep,)     rescale of this step

  const T* qg = q + ((size_t)b * H + (size_t)g * rep) * dh;
  for (int i = tid; i < rep * dh; i += THREADS) qs[i] = to_f(qg[i]);
  if (tid < rep) {
    mrow[tid] = -INFINITY;
    lrow[tid] = 0.f;
  }
  float acc[MAX_OUT];
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) acc[j] = 0.f;
  const int len = min(max(len_ptr ? *len_ptr : len_value, 0), S);
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += BT) {
    const int nt = min(BT, len - t0);
    for (int e = tid; e < nt * dh; e += THREADS) {
      const int t = e / dh, d = e % dh;
      const size_t off = (((size_t)b * S + t0 + t) * KV + g) * dh + d;
      ks[t * kld + d] = to_f(k_cache[off]);
      vs[t * dh + d] = to_f(v_cache[off]);
    }
    __syncthreads();

    for (int e = tid; e < rep * BT; e += THREADS) {
      const int h = e / BT, t = e % BT;
      float s = -INFINITY;
      if (t < nt) {
        float dot = 0.f;
        for (int d = 0; d < dh; ++d) dot = fmaf(qs[h * dh + d], ks[t * kld + d], dot);
        s = dot * scale;
      }
      ps[e] = s;
    }
    __syncthreads();

    // one warp a query head: lane t holds position t0 + t
    for (int h = tid / 32; h < rep; h += WARPS) {
      const int lane = tid % 32;
      const float s = ps[h * BT + lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(mrow[h], mx);  // finite: position t0 is valid
      const float p = s == -INFINITY ? 0.f : expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[h * BT + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float c = expf(mrow[h] - m_new);
        lrow[h] = lrow[h] * c + sum;
        mrow[h] = m_new;
        corr[h] = c;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < MAX_OUT; ++j) {
      const int o = tid + j * THREADS;
      if (o < rep * dh) {
        const int h = o / dh, d = o % dh;
        float a = acc[j] * corr[h];
        for (int t = 0; t < nt; ++t) a = fmaf(ps[h * BT + t], vs[t * dh + d], a);
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
int launch(const void* q, const void* k_cache, const void* v_cache, const int* len_ptr,
           int len_value, void* out, int B, int S, int H, int KV, int dh, float scale,
           cudaStream_t stream) {
  if (B == 0) return 0;
  const int rep = H / KV;
  const size_t smem = sizeof(float) * (rep * dh + BT * (dh + 1) + BT * dh + rep * BT + 3 * rep);
  const dim3 grid(B, KV);
  decode_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache), static_cast<const T*>(v_cache),
      len_ptr, len_value, static_cast<T*>(out), S, H, KV, dh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, dh); caches (B, S, KV, dh); out (B, H, dh); all contiguous.  The
// valid length is *len_ptr (one int32 in device memory) when len_ptr is not
// null, else len_value; it is clamped to [0, S].  bf16 = 1 selects bfloat16
// tensors, 0 float32.  Returns the CUDA error code.
extern "C" int decode_attention_launch(const void* q, const void* k_cache, const void* v_cache,
                                       const int* len_ptr, int len_value, void* out, int B,
                                       int S, int H, int KV, int dh, float scale, int bf16,
                                       cudaStream_t stream) {
  if (bf16)
    return launch<__nv_bfloat16>(q, k_cache, v_cache, len_ptr, len_value, out, B, S, H, KV, dh,
                                 scale, stream);
  return launch<float>(q, k_cache, v_cache, len_ptr, len_value, out, B, S, H, KV, dh, scale,
                       stream);
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
