// Weight-streaming int8 matmul (K6) for Hopper (sm_90a), plain C interface.
//
// quant_matmul replaces unimp_tpu/ops/quant_matmul.py:_kernel: out[M, N] =
// (x[M, K] @ q[K, N]) * scale[N], with q int8 (rows N-contiguous, row
// stride ldq), the sum in f32 and the per-output-channel scale applied
// once after it, the result rounded to x's dtype. It runs every int8
// projection of a decode step (M = B*K beam rows) and the prefill's head.
//
// What bounds it on the H100: at the 4b eval's decode rows (M = 240) it
// does 2*M flops per weight byte, past the 295 flops a byte where the
// bf16 tensor cores (989 TFLOP/s), not the memory (3.35 TB/s), are the
// limit: 2*240*3.7e9 weights is 1.78 TFLOP a step, 1.8 ms at the peak.
// At small M (a greedy step, the prefill head) the int8 bytes bound it.
//
// The design, bf16 x: one block of 4 warps per 64 x 64 output tile, a loop
// over K in 32-deep tiles. Each tile of x and of q is staged in shared
// memory (16-byte loads where K, N and the row stride allow, masked tails
// otherwise); the int8 tile is widened to bf16 on the way in, stored
// n-major so that a warp reads its B fragments as k pairs, and each warp
// runs mma.sync m16n8k16 (bf16 in, f32 accumulate) over its 32 x 32
// quarter of the tile. int8 -> bf16 is exact (|q| <= 127 needs 7 bits)
// and a bf16 * int8 product is exact in f32, so the tensor cores give the
// plain version's numbers up to the order of the sum. float32 x runs on
// the CUDA cores: 256 threads per 64 x 64 tile, 4 x 4 outputs each, x and
// the widened q tile in shared memory. No pipelining, no TMA, no wgmma:
// those are later work.

#include "common.cuh"

namespace {

using namespace unimp;

constexpr int BM = 64, BN = 64;

// ---------------------------------------------------------------- bf16 x

constexpr int kMmaBK = 32;
constexpr int kMmaThreads = 128;
constexpr int kStride = kMmaBK + 8;  // bf16 row stride of both shared tiles

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kMmaThreads)
qmm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M,
                int K, int N, int ldq, bool q_vec) {
  __shared__ __align__(16) __nv_bfloat16 xs[BM * kStride];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 ws[BN * kStride];  // [n][k]
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;  // the warp's quarter
  const int g = lane / 4, t4 = lane % 4;                 // mma fragment coordinates
  const bool x_vec = K % 8 == 0;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kMmaBK) {
    // x tile: 64 rows x 32 k, in chunks of 8 bf16
    for (int c = tid; c < BM * kMmaBK / 8; c += kMmaThreads) {
      const int r = c / (kMmaBK / 8), kc = (c % (kMmaBK / 8)) * 8;
      const int m = m0 + r, k = k0 + kc;
      union { uint4 u; __nv_bfloat16 h[8]; } v;
      v.u = make_uint4(0, 0, 0, 0);
      if (m < M) {
        const __nv_bfloat16* src = x + (size_t)m * K + k;
        if (x_vec && k + 8 <= K) {
          v.u = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) v.h[i] = k + i < K ? src[i] : __float2bfloat16(0.f);
        }
      }
      *reinterpret_cast<uint4*>(&xs[r * kStride + kc]) = v.u;
    }
    // q tile: 32 k x 64 n int8, 16 bytes per thread, widened to bf16 and
    // stored transposed
    for (int c = tid; c < kMmaBK * BN / 16; c += kMmaThreads) {
      const int kr = c / (BN / 16), nc = (c % (BN / 16)) * 16;
      const int k = k0 + kr, n = n0 + nc;
      union { uint4 u; int8_t b[16]; } w;
      w.u = make_uint4(0, 0, 0, 0);
      if (k < K) {
        const int8_t* src = q + (size_t)k * ldq + n;
        if (q_vec && n + 16 <= N) {
          w.u = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) w.b[i] = n + i < N ? src[i] : int8_t(0);
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) ws[(nc + i) * kStride + kr] = __float2bfloat16((float)w.b[i]);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kMmaBK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* p = &xs[(wm + i * 16 + g) * kStride + kk + 2 * t4];
        a[i][0] = ld_pair(p);                     // row g,     k 2t, 2t+1
        a[i][1] = ld_pair(p + 8 * kStride);       // row g + 8, k 2t, 2t+1
        a[i][2] = ld_pair(p + 8);                 // row g,     k 2t+8, 2t+9
        a[i][3] = ld_pair(p + 8 * kStride + 8);   // row g + 8, k 2t+8, 2t+9
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* p = &ws[(wn + j * 8 + g) * kStride + kk + 2 * t4];
        b[j][0] = ld_pair(p);      // col g, k 2t, 2t+1
        b[j][1] = ld_pair(p + 8);  // col g, k 2t+8, 2t+9
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // c0, c1: row g, cols 2t, 2t+1; c2, c3: row g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn + j * 8 + 2 * t4;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = m0 + wm + i * 16 + g + 8 * hh;
        if (m >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (n + e < N)
            out[(size_t)m * N + n + e] = __float2bfloat16(acc[i][j][2 * hh + e] * scale[n + e]);
      }
    }
}

// ---------------------------------------------------------------- float32 x

constexpr int kFmaBK = 16;
constexpr int kFmaThreads = 256;

__global__ void __launch_bounds__(kFmaThreads)
qmm_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ scale, float* __restrict__ out, int M, int K, int N,
               int ldq) {
  __shared__ float xs[BM][kFmaBK + 1];  // padded: conflict-free row stores
  __shared__ float ws[kFmaBK][BN];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFmaBK) {
    for (int c = tid; c < BM * kFmaBK; c += kFmaThreads) {
      const int r = c / kFmaBK, kk = c % kFmaBK;
      const int m = m0 + r, k = k0 + kk;
      xs[r][kk] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
    }
    for (int c = tid; c < kFmaBK * BN; c += kFmaThreads) {
      const int kk = c / BN, nn = c % BN;
      const int k = k0 + kk, n = n0 + nn;
      ws[kk][nn] = (k < K && n < N) ? (float)q[(size_t)k * ldq + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFmaBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty * 4 + i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j] * scale[n];
    }
  }
}

}  // namespace

// dtype (of x and out): 0 = float32, 1 = bfloat16. x [M, K] and out
// [M, N] row-major; q [K, N] int8 with row stride ldq (elements); scale [N]
// f32. Returns cudaGetLastError() after the launch, or -1 for an
// unsupported dtype.
extern "C" int quant_matmul(int dtype, const void* x, const void* q, const float* scale,
                            void* out, int M, int K, int N, int ldq, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const int8_t* qi = static_cast<const int8_t*>(q);
  if (dtype == 0) {
    qmm_f32_kernel<<<grid, kFmaThreads, 0, s>>>(static_cast<const float*>(x), qi, scale,
                                                static_cast<float*>(out), M, K, N, ldq);
  } else if (dtype == 1) {
    const bool q_vec = ldq % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
    qmm_bf16_kernel<<<grid, kMmaThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x), qi,
                                                 scale, static_cast<__nv_bfloat16*>(out), M, K,
                                                 N, ldq, q_vec);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
