// Widening of a quantized base's 1-byte weights (int8, fp8-e4m3) to bf16,
// shared by the kernels that read a q: every int8 value (|v| ≤ 128) and
// every e4m3 value, subnormals included, is a bf16 value, so the widening
// is exact and a bf16 product with it is exact on the tensor cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

// Four 1-byte q values (one word) → four bf16 (two words), exactly, with
// integer and bf16x2 operations only.
//  * int8: u = v + 128 as a byte; the float with bits 0x4B0000uu is 2²³ + u,
//    and minus 2²³ + 128 it is v, whose bf16 bits are the float's upper half
//    (|v| ≤ 128 has at most 8 significant bits).
//  * e4m3: s.eeee.mmm moved to bf16's s.0000eeee.mmm0000 reads as
//    2^(e−127)·1.mmm (subnormal e = 0: m·2⁻¹³³), and × 2¹²⁰ (exact) gives
//    the e4m3 value 2^(e−7)·1.mmm (m·2⁻⁹).  The NaN pattern, which a
//    quantized weight never holds, would read as 480.
__device__ __forceinline__ void widen4(int8_t, uint32_t v, uint32_t& w01, uint32_t& w23) {
  const uint32_t u = v ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + e)) - 8388736.f;
  w01 = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  w23 = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}
__device__ __forceinline__ void widen4(__nv_fp8_e4m3, uint32_t v, uint32_t& w01, uint32_t& w23) {
  const __nv_bfloat162 two120 = __floats2bfloat162_rn(0x1p120f, 0x1p120f);
  uint32_t w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t t = __byte_perm(v, 0u, h ? 0x4342 : 0x4140);  // bytes 2h, 2h+1 → 16-bit lanes
    const uint32_t bits = ((t & 0x00800080u) << 8) | ((t & 0x007F007Fu) << 4);
    const __nv_bfloat162 b = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&bits), two120);
    w[h] = *reinterpret_cast<const uint32_t*>(&b);
  }
  w01 = w[0], w23 = w[1];
}

// Sixteen 1-byte q values → sixteen bf16.
template <typename TW>
__device__ __forceinline__ void widen16(const uint4& raw, uint4& lo, uint4& hi) {
  widen4(TW{}, raw.x, lo.x, lo.y);
  widen4(TW{}, raw.y, lo.z, lo.w);
  widen4(TW{}, raw.z, hi.x, hi.y);
  widen4(TW{}, raw.w, hi.z, hi.w);
}

}  // namespace
