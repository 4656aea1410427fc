// Paged decode attention for Hopper (sm_90a): one query per lane, GQA, over
// the KV pool blocks named by the lane's block-table row.
//
//   out[b, h] = softmax_t(q[b,h]·k[b,t] / √dh) · v[b,t],  t < lengths[b]
//   k[b, t]   = k_pool[block_tbl[b, t / bs], t % bs, h / (H/KV)]
//
// Replaces repro/kernels/paged_attention.py::paged_decode_attention_kernel
// (_kernel).  The TPU kernel gathers a lane's whole (max_blocks·bs, KV, dh)
// view into VMEM and takes one full-width softmax.  Here the table's
// positions are cut into chunks of the dense decode kernel's size (TCH: 64
// in bf16 at dh 64, 16 KB of K and V), read as that kernel reads them
// (decode_chunk.cuh: 16-byte loads, every load of a chunk issued before the
// first product, the GQA group read once for up to HG = 4 query heads, the
// lanes of a row splitting dh, an fp32 softmax state), with each position's
// row address going through the table: pool row = tbl[b, t/bs]·bs + t%bs.
//
// One launch, grid (CS, KV·⌈rep/HG⌉, B), CS = min(⌈max_blocks·bs / TCH⌉, 8)
// CTAs a cluster along x.  CS follows the table's column count, which the
// host knows, never the length: each CTA reads lengths[b] from device
// memory, so a call never synchronises the host and replays in a CUDA
// graph after the lengths change.  Cluster rank r takes chunks r, r + CS,
// r + 2·CS, … below the length in order, folding each into its running
// state (max m, sum l, Σ e^{s−m}·v, fp32; a later chunk with a larger max
// rescales the state by e^{m_old − m_new}), with the next chunk's table
// entries loaded while the current chunk is reduced.  With CS > 1 the
// ranks' states are merged in the same launch: each rank pushes its (m, l)
// and its slice-by-slice accumulator into the rank that owns each slice of
// the output (distributed shared memory, cluster.cuh), and after one
// cluster barrier each rank merges its slice in rank order under the
// global max (l = Σ lᵣ·e^{mᵣ−M}, o = Σ accᵣ·e^{mᵣ−M} / l).  No atomics and
// no workspace: the result is the same bits on every call.  At the serving
// shape (a 4-column slice of 16-position blocks: 64 positions) CS = 1, one
// chunk covers the lane, and the CTA writes the output itself.
//
// Positions past the length and their table entries are never read, so
// stale entries and trash block 0 cannot contribute; a table entry outside
// [0, n_blocks) reads nothing and its positions contribute nothing; a lane
// of length 0 writes zeros (a rank with no chunk publishes m = −∞, l = 0
// and still arrives at the cluster barrier).
//
// Bound on the card: reading the valid K/V rows once — at 4 lanes × 3 kv
// heads × 64 dims × 2 B × 2 (K, V) = 3 KB per token of context: ≈ 0.04 µs
// at the serving shape, ≈ 0.9 µs at 4 lanes of length 1000, at 3.35 TB/s.
// At the serving shape what is left is the launch, the length and table
// loads and one dependent pool load; at length 1000 (16 chunks, 2 a rank)
// two chunks in turn a CTA and the cluster merge.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "cluster.cuh"
#include "decode_chunk.cuh"

namespace {

constexpr int MAX_CS = 8;  // CTAs of a cluster at most (the portable cluster size)

struct Plan {
  int chunk, cs, grid_y, chunks;
};

template <typename T, int DH>
Plan make_plan(int H, int KV, int bs, int max_blocks) {
  constexpr int TCH = Tile<T, DH>::TCH;
  const int chunks = (max_blocks * bs + TCH - 1) / TCH, rep = H / KV;
  return {TCH, std::max(1, std::min(chunks, MAX_CS)), KV * ((rep + HG - 1) / HG), chunks};
}

// The table entries of this lane's rows of the chunk at t0 (positions
// t0 + grp + G·i of the lane whose table row is trow); −1 past the length.
template <int G>
__device__ __forceinline__ void load_entries(const int* __restrict__ trow, int t0, int grp, int len,
                                             int bs, int (&blk)[RPL]) {
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int t = t0 + grp + G * i;
    blk[i] = t < len ? __ldg(trow + t / bs) : -1;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ tbl,
                    const int* __restrict__ lengths, T* __restrict__ out, int H, int KV, int bs,
                    int n_blocks, int max_blocks, int tbl_stride, float scale) {
  using TL = Tile<T, DH>;
  constexpr int E = TL::E, C = TL::C, GPW = TL::GPW, G = TL::G, TCH = TL::TCH;
  const int rank = blockIdx.x, cs = gridDim.x, b = blockIdx.z;
  const int rep = H / KV, n_hg = (rep + HG - 1) / HG;
  const int g = blockIdx.y / n_hg, hg = blockIdx.y % n_hg;
  const int h0 = g * rep + hg * HG, nh = min(HG, rep - hg * HG);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int piece = lane % C, grp = warp * GPW + lane / C;  // this lane's 16 bytes and row group

  __shared__ float red[WARPS][HG];
  __shared__ float mx_s[HG];
  __shared__ float acc_s[WARPS][HG][DH];
  __shared__ __align__(16) float recv_acc[HG * DH + 4 * MAX_CS];  // [rank][slice]
  __shared__ __align__(16) float recv_ml[MAX_CS][HG][2];          // [rank][head]: (m, l)

  if (cs > 1) cluster_arrive_relaxed();  // peers push into this CTA only after all have started

  const int len = min(max(lengths[b], 0), max_blocks * bs);
  const int* trow = tbl + (size_t)b * tbl_stride;

  float qf[HG][E];
  load_q<T, DH>(q, (size_t)b * H + h0, nh, piece, qf);
  float m[HG], l[HG] = {}, acc[HG][E] = {};
#pragma unroll
  for (int j = 0; j < HG; ++j) m[j] = -INFINITY;
  int t0 = rank * TCH, blk[RPL];
  load_entries<G>(trow, t0, grp, len, bs, blk);
  for (; t0 < len; t0 += cs * TCH) {  // uniform over the CTA: the barriers inside are safe
    size_t off[RPL];
    bool valid[RPL];
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      valid[i] = blk[i] >= 0 && blk[i] < n_blocks;  // past the length, or a corrupt entry
      const int t = t0 + grp + G * i;
      off[i] = valid[i] ? (((size_t)blk[i] * bs + t % bs) * KV + g) * DH + piece * E : 0;
    }
    uint4 kr[RPL], vr[RPL];
    load_rows(k_pool, v_pool, off, valid, kr, vr);
    // the next chunk's table entries, in flight while this one reduces
    load_entries<G>(trow, t0 + cs * TCH, grp, len, bs, blk);

    float s[HG][RPL], mc[HG];
    chunk_scores<T, DH>(kr, qf, valid, scale, s);
    chunk_max<C>(s, red, mx_s, tid, lane, warp, mc);
#pragma unroll
    for (int j = 0; j < HG; ++j) {  // rescale the running state to the new max
      const float M = fmaxf(m[j], mc[j]);
      const float c = m[j] == M ? 1.f : expf(m[j] - M);
      l[j] *= c;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[j][e] *= c;
      m[j] = M;
    }
    chunk_pv<T, DH>(s, vr, m, l, acc);
  }
  warp_sums<T, DH>(l, acc, red, acc_s, lane, warp, piece);
  __syncthreads();

  // this CTA's state summed over the warps, 4 consecutive elements a thread
  const int n_el = nh * DH;
  T* og = out + ((size_t)b * H + h0) * DH;
  if (cs == 1) {
    for (int i = 4 * tid; i < n_el; i += 4 * THREADS) {
      const int j = i / DH, d = i % DH;
      float lj = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) lj += red[w][j];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) a += acc_s[w][j][d + k];
        og[i + k] = from_f<T>(lj > 0.f ? a / lj : 0.f);
      }
    }
    return;
  }

  // rank p merges elements [p·per, p·per + per) of the group's output
  const int per = (n_el + 4 * cs - 1) / (4 * cs) * 4;
  cluster_wait();
  for (int i = 4 * tid; i < n_el; i += 4 * THREADS) {
    const int j = i / DH, d = i % DH, p = i / per;
    float a[4] = {};
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k] += acc_s[w][j][d + k];
    st_cluster(recv_acc + rank * per + (i - p * per), p, make_float4(a[0], a[1], a[2], a[3]));
  }
  if (tid < cs * HG) {
    const int p = tid / HG, j = tid % HG;
    float mj = m[0], lj = 0.f;
#pragma unroll
    for (int jj = 1; jj < HG; ++jj)
      if (jj == j) mj = m[jj];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) lj += red[w][j];
    st_cluster(&recv_ml[rank][j][0], p, make_float2(mj, lj));
  }
  cluster_sync();  // every push has landed; no shared memory of another CTA is touched after this

  for (int i = tid; i < per; i += THREADS) {
    const int e = rank * per + i;
    if (e >= n_el) break;
    const int j = e / DH;
    float M = -INFINITY;
    for (int r = 0; r < cs; ++r) M = fmaxf(M, recv_ml[r][j][0]);
    float lsum = 0.f, o = 0.f;
    if (M != -INFINITY)
      for (int r = 0; r < cs; ++r) {
        const float w = expf(recv_ml[r][j][0] - M);  // 0 for a rank with no chunk
        lsum = fmaf(recv_ml[r][j][1], w, lsum);
        o = fmaf(recv_acc[r * per + i], w, o);
      }
    og[e] = from_f<T>(lsum > 0.f ? o / lsum : 0.f);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k_pool, const void* v_pool, const int* tbl,
           const int* lengths, void* out, int B, int H, int KV, int bs, int n_blocks,
           int max_blocks, int tbl_stride, float scale, cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  const Plan plan = make_plan<T, DH>(H, KV, bs, max_blocks);
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = plan.cs;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.cs, plan.grid_y, B);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = plan.cs > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, paged_decode_kernel<T, DH>, static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tbl, lengths, static_cast<T*>(out), H, KV, bs, n_blocks,
      max_blocks, tbl_stride, scale);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// dispatch on the head dim: fn<DH>() for dh ∈ {16, 32, 64, 128}
template <typename F>
int with_dh(int dh, F&& fn) {
  switch (dh) {
    case 16: return fn(std::integral_constant<int, 16>());
    case 32: return fn(std::integral_constant<int, 32>());
    case 64: return fn(std::integral_constant<int, 64>());
    case 128: return fn(std::integral_constant<int, 128>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k_pool, const void* v_pool, const int* tbl,
              const int* lengths, void* out, int B, int H, int KV, int bs, int n_blocks,
              int max_blocks, int tbl_stride, float scale, cudaStream_t stream) {
  return with_dh(dh, [&](auto d) {
    return launch<T, decltype(d)::value>(q, k_pool, v_pool, tbl, lengths, out, B, H, KV, bs,
                                         n_blocks, max_blocks, tbl_stride, scale, stream);
  });
}

}  // namespace

// q (B, H, dh); pools (n_blocks, bs, KV, dh); q and the pools contiguous
// and 16-byte aligned, dh ∈ {16, 32, 64, 128}; tbl rows of max_blocks int32
// entries, tbl_stride apart; lengths (B,) int32; out (B, H, dh).  bf16 = 1
// selects bfloat16 tensors, 0 float32.  One launch on `stream`; returns the
// CUDA error code.
extern "C" int paged_decode_launch(const void* q, const void* k_pool, const void* v_pool,
                                   const int* tbl, const int* lengths, void* out, int B, int H,
                                   int KV, int dh, int bs, int n_blocks, int max_blocks,
                                   int tbl_stride, float scale, int bf16,
                                   cudaStream_t stream) {
  if (bf16)
    return launch_dh<__nv_bfloat16>(dh, q, k_pool, v_pool, tbl, lengths, out, B, H, KV, bs,
                                    n_blocks, max_blocks, tbl_stride, scale, stream);
  return launch_dh<float>(dh, q, k_pool, v_pool, tbl, lengths, out, B, H, KV, bs, n_blocks,
                          max_blocks, tbl_stride, scale, stream);
}

// How a launch splits its work, in the numbers the kernel uses: plan[0]
// the positions of a chunk, plan[1] the cluster size (CTAs along x),
// plan[2] the grid's y (kv heads × head groups), plan[3] the chunks of the
// table (⌈max_blocks·bs / chunk⌉).  No length enters.  Returns the CUDA
// error code (an unsupported dh: cudaErrorInvalidValue).
extern "C" int paged_decode_plan(int H, int KV, int dh, int bs, int max_blocks, int bf16,
                                 int* plan) {
  return with_dh(dh, [&](auto d) {
    constexpr int DH = decltype(d)::value;
    const Plan p = bf16 ? make_plan<__nv_bfloat16, DH>(H, KV, bs, max_blocks)
                        : make_plan<float, DH>(H, KV, bs, max_blocks);
    plan[0] = p.chunk;
    plan[1] = p.cs;
    plan[2] = p.grid_y;
    plan[3] = p.chunks;
    return 0;
  });
}

extern "C" const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
