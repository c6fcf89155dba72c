// Shared device helpers for the port's attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace unimp {

constexpr float kNegInf = -1e30f;  // finite sentinel: no NaN from (-inf)-(-inf)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round to T and back: the TPU kernels cast the softmax weights to the
// V dtype before the PV product; the kernels here do the same.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// dot(q[0:D], row[0:D]) with q in shared memory (f32) and row in global
// memory (float, bf16 or int8), read 16 bytes at a time (D * sizeof(T) is
// a multiple of 16).
template <typename T, int D>
__device__ __forceinline__ float dot_row(const float* __restrict__ q, const T* __restrict__ row) {
  constexpr int kVec = 16 / sizeof(T);
  const uint4* r4 = reinterpret_cast<const uint4*>(row);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D / kVec; ++c) {
    uint4 raw = __ldg(r4 + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc += q[c * kVec + i] * to_f32(e[i]);
  }
  return acc;
}

}  // namespace unimp

#define UNIMP_DISPATCH_D(d, ...)                     \
  switch (d) {                                        \
    case 64: { constexpr int D = 64; __VA_ARGS__; break; }   \
    case 80: { constexpr int D = 80; __VA_ARGS__; break; }   \
    case 128: { constexpr int D = 128; __VA_ARGS__; break; } \
    default: return -1;                               \
  }
