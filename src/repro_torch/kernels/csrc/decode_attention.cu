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
//     positions, all fp32 — goes to an fp32 workspace.  The chunk's loads
//     and arithmetic live in decode_chunk.cuh, shared with the paged
//     decode kernel.
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
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_chunk.cuh"

namespace {

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
  size_t off[RPL];
  bool valid[RPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int t = grp + G * i;
    valid[i] = t < nt;
    off[i] = (((size_t)b * S + t0 + t) * KV + g) * DH + piece * E;
  }
  uint4 kr[RPL], vr[RPL];
  load_rows(k_cache, v_cache, off, valid, kr, vr);
  float qf[HG][E];
  load_q<T, DH>(q, (size_t)b * H + h0, nh, piece, qf);

  // the chunk's softmax state per head: its max m (finite: position t0 is
  // valid), this lane's share of the sum l and of the accumulator Σ e^{s−m}·v
  __shared__ float red[WARPS][HG];
  __shared__ float mx_s[HG];
  __shared__ float acc_s[WARPS][HG][DH];
  float s[HG][RPL], m[HG], l[HG] = {}, acc[HG][E] = {};
  chunk_scores<T, DH>(kr, qf, valid, scale, s);
  chunk_max<C>(s, red, mx_s, tid, lane, warp, m);
  chunk_pv<T, DH>(s, vr, m, l, acc);
  warp_sums<T, DH>(l, acc, red, acc_s, lane, warp, piece);
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
