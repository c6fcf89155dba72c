// Shared device helpers for the port's kernels.
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

// ---------------------------------------------------------------- tensor cores
//
// mma.sync m16n8k16 fragments, for lane = 4 * g + t4 (g = lane / 4, t4 =
// lane % 4): A (16 x 16, row-major) a0 = A[g][2t4, 2t4+1], a1 = A[g+8][..],
// a2 = A[g][2t4+8, +9], a3 = A[g+8][2t4+8, +9]; B (16 x 8) b0 = B[2t4, 2t4+1][g],
// b1 = B[2t4+8, +9][g]; C (16 x 8, f32) c0, c1 = C[g][2t4, 2t4+1], c2, c3 =
// C[g+8][2t4, 2t4+1]. Pairs are packed low element first.

// c += a (bf16) * b (bf16), f32 accumulate
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 matrices of 16-bit elements; lanes 8i..8i+7 give the row
// addresses (16 bytes each) of matrix i, and r[i] receives its fragment:
// row g, elements 2t4 and 2t4 + 1 (``_trans``: elements [2t4][g] and
// [2t4 + 1][g]).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// Two f32 -> one bf16x2 register (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// 2^x by the special-function unit (ex2.approx: relative error ~2^-22;
// -1e30 gives 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- cp.async
//
// Asynchronous global -> shared copies (Ampere's LDGSTS, kept on Hopper).
// ``src_bytes`` < size fills the rest with zeros; 0 reads nothing (the
// address must still be a valid one).

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace unimp

#define UNIMP_DISPATCH_D(d, ...)                     \
  switch (d) {                                        \
    case 64: { constexpr int D = 64; __VA_ARGS__; break; }   \
    case 80: { constexpr int D = 80; __VA_ARGS__; break; }   \
    case 128: { constexpr int D = 128; __VA_ARGS__; break; } \
    default: return -1;                               \
  }
