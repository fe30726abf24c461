// Loads and stores shared by the 2-D and 3-D warp kernels (warp2d.cu, warp3d.cu):
// scalar f32 / bf16 access with f32 arithmetic, read-only-path loads, and the
// vector access of a row of V consecutive elements that a forward thread owns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Read-only-path loads.  A bf16 value is the upper half of its float32, so
// the conversions below are exact.
__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* p) {
  return bf16_lo(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
// four consecutive elements from a 16 B (f32) or 8 B (bf16) aligned address
__device__ __forceinline__ void ldg4(const float* p, float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void ldg4(const __nv_bfloat16* p, float* v) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = bf16_lo(q.x); v[1] = bf16_hi(q.x); v[2] = bf16_lo(q.y); v[3] = bf16_hi(q.y);
}
// two consecutive elements from an 8 B (f32) or 4 B (bf16) aligned address
__device__ __forceinline__ void ldg2(const float* p, float* a, float* b) {
  const float2 q = __ldg(reinterpret_cast<const float2*>(p));
  *a = q.x; *b = q.y;
}
__device__ __forceinline__ void ldg2(const __nv_bfloat16* p, float* a, float* b) {
  const unsigned q = __ldg(reinterpret_cast<const unsigned*>(p));
  *a = bf16_lo(q); *b = bf16_hi(q);
}
// four values to a 16 B (f32) or 8 B (bf16) aligned address, each rounded as `store` rounds
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16(b)) << 16);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}
// two values to an 8 B (f32) or 4 B (bf16) aligned address
__device__ __forceinline__ void store2(float* p, const float* v) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16(v[0], v[1]);
}

template <int BYTES>
__device__ __forceinline__ bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & (BYTES - 1)) == 0;
}

// V values of one flow channel at p, p + s, ..., for the n <= V elements of
// a row that a thread owns; 0 for the rest.  Vector loads where the channel
// is contiguous in x and aligned.
template <int V, typename F>
__device__ __forceinline__ void load_row(const F* p, int64_t s, int n, float* v) {
  static_assert(V == 2 || V == 4, "a thread owns 2 or 4 elements of a row");
  if (n == V && s == 1 && aligned<V * sizeof(F)>(p)) {
    if constexpr (V == 4) ldg4(p, v);
    else ldg2(p, &v[0], &v[1]);
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = j < n ? ldg(p + j * s) : 0.f;
}

// the first n <= V values of v to p .. p+n-1, vector stores where aligned
template <int V, typename T>
__device__ __forceinline__ void store_row(T* p, const float* v, int n) {
  static_assert(V == 2 || V == 4, "a thread owns 2 or 4 elements of a row");
  if (n == V && aligned<V * sizeof(T)>(p)) {
    if constexpr (V == 4) store4(p, v);
    else store2(p, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (j < n) store(p + j, v[j]);
}

}  // namespace
