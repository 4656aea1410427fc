// One chunk of one-query decode attention (sm_90), shared by the dense
// (decode_attention.cu) and paged (paged_attention.cu) decode kernels.
//
// A CTA of THREADS threads holds a chunk of TCH cache positions of one kv
// head for up to HG query heads of its GQA group.  Each K and V row is read
// as 16-byte pieces of E elements: the C lanes of a row group split dh,
// neighbouring lanes read neighbouring pieces, and a lane holds RPL rows
// (grp, grp + G, …), so every load of a chunk is issued before the first
// product.  A score is a short dot per lane and a shuffle reduction over
// the row's lanes; the chunk's max per head is taken over the CTA (two
// barriers); the probabilities e^{s−M} stay fp32 through P·V.  The caller
// computes each row's address (dense: position t of batch row b; paged:
// through the block table) and what it does with the softmax state.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128, WARPS = THREADS / 32;
constexpr int HG = 4;   // query heads a CTA serves (GQA groups of more take several)
constexpr int RPL = 4;  // cache rows a lane loads per chunk, for K and for V

// The chunk of one CTA: 16-byte pieces of E elements, C lanes a row, GPW
// rows a warp at a time, RPL rows a lane.
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

// This lane's piece of the nh (≤ HG) query rows row0, row0 + 1, … of q
// (rows of DH elements, 16-byte aligned); zeros for the heads past nh.
template <typename T, int DH>
__device__ __forceinline__ void load_q(const T* __restrict__ q, size_t row0, int nh, int piece,
                                       float (&qf)[HG][Tile<T, DH>::E]) {
#pragma unroll
  for (int j = 0; j < HG; ++j) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (j < nh) u = __ldg(reinterpret_cast<const uint4*>(q + (row0 + j) * DH) + piece);
    unpack(u, qf[j]);
  }
}

// This lane's piece of its RPL rows of K and V, at element offsets off[i]
// where valid[i], zeros elsewhere: all the loads first, none waited on.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ k, const T* __restrict__ v,
                                          const size_t (&off)[RPL], const bool (&valid)[RPL],
                                          uint4 (&kr)[RPL], uint4 (&vr)[RPL]) {
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
    if (valid[i]) {
      kr[i] = __ldg(reinterpret_cast<const uint4*>(k + off[i]));
      vr[i] = __ldg(reinterpret_cast<const uint4*>(v + off[i]));
    }
  }
}

// Scores of this lane's rows: a partial dot over its piece, summed over the
// row's C lanes (every lane takes part in the shuffles), scaled; −∞ where
// the row is not valid.
template <typename T, int DH>
__device__ __forceinline__ void chunk_scores(const uint4 (&kr)[RPL],
                                             const float (&qf)[HG][Tile<T, DH>::E],
                                             const bool (&valid)[RPL], float scale,
                                             float (&s)[HG][RPL]) {
  constexpr int E = Tile<T, DH>::E, C = Tile<T, DH>::C;
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    float kf[E];
    unpack(kr[i], kf);
#pragma unroll
    for (int j = 0; j < HG; ++j) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) d = fmaf(qf[j][e], kf[e], d);
#pragma unroll
      for (int o = C / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      s[j][i] = valid[i] ? d * scale : -INFINITY;
    }
  }
}

// The chunk's max of each head over the CTA: over this lane's rows, the
// warp's row groups (lanes C, 2C, … apart), then the warps, through red and
// mx_s in shared memory (two barriers; −∞ where no row is valid).
template <int C>
__device__ __forceinline__ void chunk_max(const float (&s)[HG][RPL], float (*red)[HG], float* mx_s,
                                          int tid, int lane, int warp, float (&m)[HG]) {
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
    mx_s[tid] = v;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < HG; ++j) m[j] = mx_s[j];
}

// The probabilities p = e^{s−M} in fp32 (0 where s is −∞), in place of the
// scores, added into this lane's partial sums l and Σ p·v (acc).
template <typename T, int DH>
__device__ __forceinline__ void chunk_pv(float (&s)[HG][RPL], const uint4 (&vr)[RPL],
                                         const float (&M)[HG], float (&l)[HG],
                                         float (&acc)[HG][Tile<T, DH>::E]) {
  constexpr int E = Tile<T, DH>::E;
#pragma unroll
  for (int j = 0; j < HG; ++j)
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      s[j][i] = s[j][i] == -INFINITY ? 0.f : expf(s[j][i] - M[j]);
      l[j] += s[j][i];
    }
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    float vf[E];
    unpack(vr[i], vf);  // zeros where the row is not valid, and p is 0 there
#pragma unroll
    for (int j = 0; j < HG; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[j][e] = fmaf(s[j][i], vf[e], acc[j][e]);
  }
}

// This lane's l and acc summed over the warp's row groups (shuffles), each
// warp's sums into shared memory: red[warp][j] = l, acc_s[warp][j][d].  The
// caller's barrier follows; red's reads in chunk_max came before its last
// barrier.
template <typename T, int DH>
__device__ __forceinline__ void warp_sums(float (&l)[HG], float (&acc)[HG][Tile<T, DH>::E],
                                          float (*red)[HG], float (*acc_s)[HG][DH], int lane,
                                          int warp, int piece) {
  constexpr int E = Tile<T, DH>::E, C = Tile<T, DH>::C;
#pragma unroll
  for (int j = 0; j < HG; ++j) {
#pragma unroll
    for (int o = C; o < 32; o <<= 1) l[j] += __shfl_xor_sync(0xffffffffu, l[j], o);
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int o = C; o < 32; o <<= 1) acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], o);
  }
  if (lane < C) {
#pragma unroll
    for (int j = 0; j < HG; ++j) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc_s[warp][j][piece * E + e] = acc[j][e];
      if (lane == 0) red[warp][j] = l[j];
    }
  }
}

}  // namespace
