// Dense decode attention for Hopper (sm_90a): one query per batch row, GQA,
// over a (B, S, KV, dh) cache whose first `length` positions are valid.
//
//   out[b, h] = Σ_{t < length} softmax_t(q[b,h]·k[b,t,g] / √dh) · v[b,t,g],
//   g = h / (H/KV)
//
// Replaces repro/kernels/decode_attention.py::decode_attention_kernel
// (_kernel).  The TPU kernel walks a (B, S/bk) grid in order, carrying the
// online softmax state across KV blocks in VMEM and skipping blocks at or
// past the length.  Blocks of a CUDA grid run in parallel and in no order,
// so here the length is split over the card (flash-decoding) in two
// launches on one stream:
//
//  1. split: grid (n_split, KV·⌈rep/HG⌉, B), n_split = ⌈S/TCH⌉ chunks of TCH
//     positions (64 in bf16 at dh 64; a chunk is 16 KB of K and V whatever
//     dh and the dtype).  n_split comes from S, which the host knows, never
//     from the length: each block reads the length from device memory
//     itself and returns at once, before any load, when its chunk starts at
//     or past it.  So the call never synchronises the host and can sit in a
//     CUDA graph whose length tensor changes between replays.  A block
//     reads its chunk of K and V for kv head g once for up to HG = 4 query
//     heads of the GQA group, in 16-byte loads straight into registers
//     (neighbouring lanes read neighbouring 16-byte pieces of a row; every
//     load of the chunk is issued before the first product).  The lanes
//     that share a row split dh, so a score is a short dot per lane and a
//     shuffle reduction over the row's lanes.  The chunk's softmax state —
//     max m, sum l and the unnormalised accumulator Σ e^{s−m}·v over its
//     positions, all fp32 — goes to an fp32 workspace.
//  2. combine: grid (H, B), one thread per output element, reads the length
//     again, merges the ⌈length/TCH⌉ valid partials (global max M,
//     l = Σ lᵢ·e^{mᵢ−M}, o = Σ accᵢ·e^{mᵢ−M} / l) and writes out in q's
//     dtype; a length of 0 writes zeros, as the TPU kernel does.
//
// Positions past the length are never read.  The probabilities stay fp32
// through P·V, as in the TPU kernel.
//
// Bound on the card: reading the valid K/V rows once — at 4 batch rows,
// length 1000, 3 kv heads, dh 64 in bf16, ≈ 3.1 MB, ≈ 0.9 µs at the H100
// SXM data sheet's 3.35 TB/s.  The workspace adds ≈ 0.3 MB of fp32 writes
// and reads at that shape (≈ 0.1 µs).  With 192 chunk blocks (16 chunks ×
// 12 (row, kv head) pairs) the whole read is issued at once over the SMs;
// what is left is the load latency of one chunk, the second launch and the
// combine's read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128, WARPS = THREADS / 32;
constexpr int HG = 4;   // query heads a split block serves (GQA groups of more take several)
constexpr int RPL = 4;  // cache rows a lane loads per chunk, for K and for V

// The chunk of one split block: 16-byte pieces of E elements, C lanes a
// row, GPW rows a warp at a time, RPL rows a lane.
template <typename T, int DH>
struct Tile {
  static constexpr int E = 16 / sizeof(T);
  static constexpr int C = DH / E;
  static constexpr int GPW = 32 / C;
  static constexpr int G = WARPS * GPW;  // rows in flight a step
  static constexpr int TCH = G * RPL;    // positions a chunk
  static_assert(DH % E == 0 && C >= 1 && C <= 32 && 32 % C == 0, "unsupported head dim");
};

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);  // bf16 → fp32: the high half of the word
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ int valid_length(const int* len_ptr, int len_value, int S) {
  return min(max(len_ptr ? *len_ptr : len_value, 0), S);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache, const int* __restrict__ len_ptr,
                    int len_value, float* __restrict__ ws_acc, float* __restrict__ ws_ml, int S,
                    int H, int KV, float scale) {
  using TL = Tile<T, DH>;
  constexpr int E = TL::E, C = TL::C, GPW = TL::GPW, G = TL::G, TCH = TL::TCH;
  const int split = blockIdx.x, b = blockIdx.z, n_split = gridDim.x;
  const int len = valid_length(len_ptr, len_value, S);
  const int t0 = split * TCH;
  if (t0 >= len) return;  // the whole chunk lies past the length: nothing is read
  const int nt = min(TCH, len - t0);

  const int rep = H / KV, n_hg = (rep + HG - 1) / HG;
  const int g = blockIdx.y / n_hg, hg = blockIdx.y % n_hg;
  const int h0 = g * rep + hg * HG, nh = min(HG, rep - hg * HG);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int piece = lane % C, grp = warp * GPW + lane / C;  // this lane's 16 bytes and row group

  // every load of the chunk first: K and V rows grp, grp + G, … as 16-byte pieces
  uint4 kr[RPL], vr[RPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int t = grp + G * i;
    kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
    if (t < nt) {
      const size_t off = (((size_t)b * S + t0 + t) * KV + g) * DH + piece * E;
      kr[i] = __ldg(reinterpret_cast<const uint4*>(k_cache + off));
      vr[i] = __ldg(reinterpret_cast<const uint4*>(v_cache + off));
    }
  }
  float qf[HG][E];
#pragma unroll
  for (int j = 0; j < HG; ++j) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (j < nh)
      u = __ldg(reinterpret_cast<const uint4*>(q + ((size_t)b * H + h0 + j) * DH) + piece);
    unpack(u, qf[j]);
  }

  // scores: each lane a partial dot over its piece, summed over the row's C lanes
  float s[HG][RPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    float kf[E];
    unpack(kr[i], kf);
    const bool ok = grp + G * i < nt;
#pragma unroll
    for (int j = 0; j < HG; ++j) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) d = fmaf(qf[j][e], kf[e], d);
#pragma unroll
      for (int o = C / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      s[j][i] = ok ? d * scale : -INFINITY;
    }
  }

  // the chunk's max and sum per head: over this lane's rows, the warp's row
  // groups (lanes C, 2C, … apart), then the warps
  __shared__ float red[WARPS][HG];
  __shared__ float mx_s[HG];
  __shared__ float acc_s[WARPS][HG][DH];
  float m[HG];
#pragma unroll
  for (int j = 0; j < HG; ++j) {
    float v = s[j][0];
#pragma unroll
    for (int i = 1; i < RPL; ++i) v = fmaxf(v, s[j][i]);
#pragma unroll
    for (int o = C; o < 32; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    m[j] = v;
  }
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < HG; ++j) red[warp][j] = m[j];
  __syncthreads();
  if (tid < HG) {
    float v = red[0][tid];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v = fmaxf(v, red[w][tid]);
    mx_s[tid] = v;  // finite: position t0 is valid
  }
  __syncthreads();
  float l[HG];
#pragma unroll
  for (int j = 0; j < HG; ++j) {
    const float mj = mx_s[j];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      s[j][i] = s[j][i] == -INFINITY ? 0.f : expf(s[j][i] - mj);  // now p, fp32
      sum += s[j][i];
    }
#pragma unroll
    for (int o = C; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    l[j] = sum;
  }

  // P·V in fp32: each lane its rows' share of its piece, summed over the
  // warp's row groups by shuffles and over the warps in shared memory
  float acc[HG][E];
#pragma unroll
  for (int j = 0; j < HG; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    float vf[E];
    unpack(vr[i], vf);  // zeros past the length, where p is 0
#pragma unroll
    for (int j = 0; j < HG; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[j][e] = fmaf(s[j][i], vf[e], acc[j][e]);
  }
#pragma unroll
  for (int j = 0; j < HG; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int o = C; o < 32; o <<= 1) acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], o);
  if (lane < C) {  // red[] is free again: its reads came before the last barrier
#pragma unroll
    for (int j = 0; j < HG; ++j) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc_s[warp][j][piece * E + e] = acc[j][e];
      if (lane == 0) red[warp][j] = l[j];
    }
  }
  __syncthreads();
  for (int i = tid; i < nh * DH; i += THREADS) {
    const int j = i / DH, d = i % DH;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += acc_s[w][j][d];
    ws_acc[(((size_t)b * H + h0 + j) * n_split + split) * DH + d] = a;
  }
  if (tid < nh) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[w][tid];
    float* ml = ws_ml + (((size_t)b * H + h0 + tid) * n_split + split) * 2;
    ml[0] = mx_s[tid];
    ml[1] = sum;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(DH)
decode_combine_kernel(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
                      const int* __restrict__ len_ptr, int len_value, T* __restrict__ out, int S,
                      int H, int n_split) {
  constexpr int TCH = Tile<T, DH>::TCH;
  extern __shared__ float wl[];  // (n_valid, 2): each chunk's weight e^{m−M} and l
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = valid_length(len_ptr, len_value, S);
  const int n_valid = (len + TCH - 1) / TCH;
  const size_t row = (size_t)b * H + h;
  const float* ml = ws_ml + row * n_split * 2;
  const float* acc = ws_acc + row * n_split * DH + d;
  // the chunks' (m, l) side by side in shared memory, then the weights
  for (int i = d; i < n_valid; i += DH) {
    wl[2 * i] = ml[2 * i];
    wl[2 * i + 1] = ml[2 * i + 1];
  }
  __syncthreads();
  float M = -INFINITY;
  for (int i = 0; i < n_valid; ++i) M = fmaxf(M, wl[2 * i]);
  __syncthreads();
  for (int i = d; i < n_valid; i += DH) wl[2 * i] = expf(wl[2 * i] - M);
  __syncthreads();
  float l = 0.f, o = 0.f;
#pragma unroll 8
  for (int i = 0; i < n_valid; ++i) {
    l = fmaf(wl[2 * i + 1], wl[2 * i], l);
    o = fmaf(acc[(size_t)i * DH], wl[2 * i], o);
  }
  out[row * DH + d] = from_f<T>(n_valid ? o / l : 0.f);
}

template <typename T, int DH>
int launch(const void* q, const void* k_cache, const void* v_cache, const int* len_ptr,
           int len_value, void* out, float* ws_acc, float* ws_ml, int B, int S, int H, int KV,
           float scale, cudaStream_t stream) {
  constexpr int TCH = Tile<T, DH>::TCH;
  if (B == 0 || H == 0) return 0;
  const int n_split = (S + TCH - 1) / TCH, rep = H / KV;
  if (n_split > 0) {
    const dim3 grid(n_split, KV * ((rep + HG - 1) / HG), B);
    decode_split_kernel<T, DH><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_cache),
        static_cast<const T*>(v_cache), len_ptr, len_value, ws_acc, ws_ml, S, H, KV, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_combine_kernel<T, DH><<<dim3(H, B), DH, 2 * sizeof(float) * n_split, stream>>>(
      ws_acc, ws_ml, len_ptr, len_value, static_cast<T*>(out), S, H, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k_cache, const void* v_cache, const int* len_ptr,
              int len_value, void* out, float* ws_acc, float* ws_ml, int B, int S, int H, int KV,
              float scale, cudaStream_t stream) {
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k_cache, v_cache, len_ptr, len_value, out, ws_acc, ws_ml, B, S, H,
                           KV, scale, stream);
    case 32:
      return launch<T, 32>(q, k_cache, v_cache, len_ptr, len_value, out, ws_acc, ws_ml, B, S, H,
                           KV, scale, stream);
    case 64:
      return launch<T, 64>(q, k_cache, v_cache, len_ptr, len_value, out, ws_acc, ws_ml, B, S, H,
                           KV, scale, stream);
    case 128:
      return launch<T, 128>(q, k_cache, v_cache, len_ptr, len_value, out, ws_acc, ws_ml, B, S, H,
                            KV, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Positions a split block covers (its chunk) for head dim dh and the dtype;
// the wrapper sizes the workspace from it.  0 for an unsupported dh.
extern "C" int decode_attention_chunk(int dh, int bf16) {
  switch (dh) {
    case 16: return bf16 ? Tile<__nv_bfloat16, 16>::TCH : Tile<float, 16>::TCH;
    case 32: return bf16 ? Tile<__nv_bfloat16, 32>::TCH : Tile<float, 32>::TCH;
    case 64: return bf16 ? Tile<__nv_bfloat16, 64>::TCH : Tile<float, 64>::TCH;
    case 128: return bf16 ? Tile<__nv_bfloat16, 128>::TCH : Tile<float, 128>::TCH;
    default: return 0;
  }
}

// q (B, H, dh); caches (B, S, KV, dh); out (B, H, dh); all contiguous and
// 16-byte aligned; dh ∈ {16, 32, 64, 128}.  ws_acc (B, H, n_split, dh) and
// ws_ml (B, H, n_split, 2) are fp32 scratch, n_split = ⌈S / chunk⌉.  The
// valid length is *len_ptr (one int32 in device memory) when len_ptr is not
// null, else len_value; it is clamped to [0, S].  bf16 = 1 selects bfloat16
// tensors, 0 float32.  Two launches on `stream`; returns the CUDA error code.
extern "C" int decode_attention_launch(const void* q, const void* k_cache, const void* v_cache,
                                       const int* len_ptr, int len_value, void* out,
                                       float* ws_acc, float* ws_ml, int B, int S, int H, int KV,
                                       int dh, float scale, int bf16, cudaStream_t stream) {
  if (bf16)
    return launch_dh<__nv_bfloat16>(dh, q, k_cache, v_cache, len_ptr, len_value, out, ws_acc,
                                    ws_ml, B, S, H, KV, scale, stream);
  return launch_dh<float>(dh, q, k_cache, v_cache, len_ptr, len_value, out, ws_acc, ws_ml, B, S,
                          H, KV, scale, stream);
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
