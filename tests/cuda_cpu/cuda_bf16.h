// A CPU stand-in for the part of cuda_bf16.h that the port's kernels use
// (see cuda_runtime.h beside it): the storage type and its conversions,
// float -> bfloat16 rounding to nearest even as __float2bfloat16 does.
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t bits;
};

inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = (uint32_t)v.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return {(uint16_t)0x7FFF};  // NaN
  u += 0x7FFFu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}

inline __nv_bfloat16 __float2bfloat16_rn(float f) { return __float2bfloat16(f); }

inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.bits; }
