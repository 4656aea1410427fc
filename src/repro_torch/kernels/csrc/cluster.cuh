// Thread-block-cluster helpers of the port's kernels (sm_90): a CTA's rank
// in its cluster and the cluster's size, the cluster barrier (whole, or as
// an arrive and a wait apart), and fp32 loads and stores into the shared
// memory of another CTA of the cluster (distributed shared memory).
#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(v));
  return v;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(v));
  return v;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}
// The barrier in two halves: arrive (ordering nothing) early, wait later.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The address in the shared memory of CTA `rank` of the cluster at the
// offset `p` has in this CTA's.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  return remote;
}
// fp32 load from the shared memory of CTA `rank` of the cluster.
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(cluster_addr(p, rank)) : "memory");
  return v;
}
// 8-byte store of two fp32 into the shared memory of CTA `rank` (p 8-byte
// aligned).
__device__ __forceinline__ void st_cluster(float* p, uint32_t rank, float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(cluster_addr(p, rank)), "f"(v.x),
               "f"(v.y)
               : "memory");
}
// 16-byte store of four fp32 into the shared memory of CTA `rank` (p
// 16-byte aligned).
__device__ __forceinline__ void st_cluster(float* p, uint32_t rank, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(cluster_addr(p, rank)),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

}  // namespace
