// Weight-streaming int8 matmul (K6) for Hopper (sm_90a), plain C interface.
//
// quant_matmul replaces unimp_tpu/ops/quant_matmul.py:_kernel: out[M, N] =
// (x[M, K] @ q[K, N]) * scale[N], with q int8 (rows N-contiguous, row
// stride ldq), the sum in f32 and the per-output-channel scale applied
// once after it, the result rounded to x's dtype. It runs every int8
// projection of a decode step (M = B*K = 240 beam rows), the LM head, and
// the prefill's head (M = 24); ops/quant_matmul.py:quant_dot sends it up
// to 512 rows.
//
// What bounds it on the H100. At M = 240 it does 2 * 240 flops per weight
// byte, past the ~295 flops a byte where the bf16 tensor cores (989
// TFLOP/s), not the memory (3.35 TB/s), are the limit: every decode shape
// (fused QKV 2560x7680, o 2560x2560, MLP up 2560x10240, down 10240x2560,
// head 2560x54656) is bound by operations, 1.8 ms a step at the peak
// against 1.39 ms for the bytes. At M <= 64 (the prefill head, a greedy
// step) the int8 weight bytes bound it.
//
// The design, bf16 x. One block owns a BM x 128 output tile and walks its
// K range in 64-deep tiles through a 4-stage cp.async ring (x and the raw
// int8 q tile), so the loads of tile t + 3 run under the products of tile
// t and one barrier guards each tile. BM = 256 for M > 64, 8 warps of 128
// x 32: the 240 decode rows fit one M block, so each weight byte crosses
// HBM and is widened once per call (rows 257-512 take two blocks). BM = 64
// for the bytes-bound small M, 4 warps of 64 x 32, so that several blocks
// share an SM and keep more weight bytes in flight. Both tiles are
// XOR-swizzled by 16-byte chunk, so ldmatrix reads them without bank
// conflicts. The int8 tile is
// read with ldmatrix.trans as if it held 16-bit pairs: a thread receives
// q[2t4, 2t4+1][2g, 2g+1], which splits by byte permutes into the B
// fragments of two n8 tiles, the even and the odd columns of 16; the warp's
// outputs come back as 4 adjacent columns per thread. Bytes widen to bf16
// in registers by the 2^23 float trick (one xor, six byte permutes and
// four adds per 4 bytes); int8 -> bf16 is exact and a bf16 * int8 product is
// exact in f32, so mma.sync m16n8k16 (bf16 in, f32 accumulate) gives the
// plain version's numbers up to the order of the sum. Each warp widens
// only its own 32 columns.
//
// Split-K: shapes whose tiles would leave SMs idle (o and down: 20 N tiles
// on 132 SMs) split K over grid.z by the plan of ops/quant_matmul.py:
// split_k_plan. Each split writes f32 partials to a scratch buffer the
// wrapper allocates; a second kernel adds them in split order, applies the
// scale once and rounds to bf16 (no atomics: the same output every run).
// Where x, q, K, N and ldq are 16-byte aligned (every main-path call) the
// loads are cp.async only, ragged rows and k tails zero-filled by a 0-byte
// source; otherwise a second instantiation takes masked synchronous loads
// into the same ring (a branch per chunk slowed the aligned calls).
//
// float32 x runs on the CUDA cores: 256 threads per 64 x 64 tile, 4 x 4
// outputs each, x and the widened q tile in shared memory.

#include "common.cuh"

namespace {

using namespace unimp;

// ---------------------------------------------------------------- bf16 x

constexpr int kBN = 128, kWN = 32;     // block and warp tile widths
constexpr int kBK = 64;                // k per ring stage: 128 bytes of x, 64 rows of q
constexpr int kStages = 4;

// warps: kWarpsM (M) x 4 (N); BM = 256: 2 x 4 of 128 x 32, BM = 64: 1 x 4 of 64 x 32
template <int BM>
constexpr int kWarpsM = BM > 64 ? 2 : 1;
template <int BM>
constexpr int kThreads = 32 * 4 * kWarpsM<BM>;

template <int BM>
constexpr int smem_bytes() { return kStages * (BM * kBK * 2 + kBK * kBN); }

// byte offset of 16-byte chunk c of a 128-byte smem row r, XOR-swizzled
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// int8 bytes j0 and j0 + 2 of r (already xor 0x80: u = q + 128) -> bf16x2
// {q[j0], q[j0 + 2]}: 2^23 + u as a float, minus 2^23 + 128, is exact, and
// a small integer's bf16 is its float's upper half
__device__ __forceinline__ uint32_t widen_pair(uint32_t r, int j0) {
  const float lo = __uint_as_float(__byte_perm(r, 0x4B000000u, 0x7540 + j0)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(r, 0x4B000000u, 0x7542 + j0)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Stage one k tile [k0, k0 + 64) of x (BM rows) and q (128 columns) into
// ring slot xs / qs; rows past M, k past k_end and columns past N are zeros.
// kAligned: x, q, K, N and ldq 16-byte aligned, so every chunk is either
// wholly inside or wholly past its edges (K % 8 == 0, N % 16 == 0).
template <int BM, bool kAligned>
__device__ __forceinline__ void load_tile(
    char* xs, char* qs, const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    int M, int K, int N, int ldq, int m0, int n0, int k0, int k_end) {
  constexpr int T = kThreads<BM>;
  const int tid = threadIdx.x;
#pragma unroll
  for (int it = 0; it < BM * 8 / T; ++it) {  // 8 chunks of 8 bf16 a row
    const int i = tid + it * T, r = i >> 3, c = i & 7;
    const int m = m0 + r, k = k0 + 8 * c;
    const uint32_t dst = smem_addr(xs + swz(r, c));
    const __nv_bfloat16* src = x + (size_t)m * K + k;
    if (kAligned) {
      const bool in = m < M && k < k_end;
      cp_async_16(dst, in ? src : x, in ? 16 : 0);
    } else {
      union { uint4 u; __nv_bfloat16 h[8]; } v;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v.h[e] = (m < M && k + e < k_end) ? src[e] : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(xs + swz(r, c)) = v.u;
    }
  }
#pragma unroll
  for (int it = 0; it < kBK * 8 / T; ++it) {  // 8 chunks of 16 int8 a row
    const int i = tid + it * T, kr = i >> 3, c = i & 7;
    const int k = k0 + kr, n = n0 + 16 * c;
    const int8_t* src = q + (size_t)k * ldq + n;
    if (kAligned) {
      const bool in = k < k_end && n < N;
      cp_async_16(smem_addr(qs + swz(kr, c)), in ? src : q, in ? 16 : 0);
    } else if (k >= k_end || n >= N) {
      *reinterpret_cast<uint4*>(qs + swz(kr, c)) = make_uint4(0, 0, 0, 0);
    } else if (n + 16 <= N && ((uintptr_t)src & 15) == 0) {
      cp_async_16(smem_addr(qs + swz(kr, c)), src, 16);
    } else {
      union { uint4 u; int8_t b[16]; } w;
#pragma unroll
      for (int e = 0; e < 16; ++e) w.b[e] = n + e < N ? src[e] : int8_t(0);
      *reinterpret_cast<uint4*>(qs + swz(kr, c)) = w.u;
    }
  }
}

// grid (N tiles, M blocks, splits). Split z sums k in [z * k_chunk,
// min(K, (z + 1) * k_chunk)); with one split it writes out, else its f32
// partials to part[z][M][N].
template <int BM, bool kAligned>
__global__ void __launch_bounds__(kThreads<BM>, 1)
qmm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                float* __restrict__ part, int M, int K, int N, int ldq, int k_chunk) {
  constexpr int MT = BM / (16 * kWarpsM<BM>);  // m16 tiles per warp
  extern __shared__ __align__(128) char smem[];
  char* xs0 = smem;                                // kStages x [BM][64] bf16
  char* qs0 = smem + kStages * BM * kBK * 2;       // kStages x [64][128] int8
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM, z = blockIdx.z;
  const int k_begin = z * k_chunk, k_end = min(K, k_begin + k_chunk);
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * (BM / kWarpsM<BM>), wn = (warp % 4) * kWN;
  const int g = lane / 4, t4 = lane % 4;

  // acc[i][j]: m16 tile i; j = 2c + o, o = 0 the even, 1 the odd columns
  // of 16-column chunk c
  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles)
      load_tile<BM, kAligned>(xs0 + s * BM * kBK * 2, qs0 + s * kBK * kBN, x, q, M, K, N, ldq,
                              m0, n0, k_begin + s * kBK, k_end);
    cp_async_commit();
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed; slot (t - 1) % kStages is free
    const int nt = t + kStages - 1;
    if (nt < n_tiles) {
      const int s = nt % kStages;
      load_tile<BM, kAligned>(xs0 + s * BM * kBK * 2, qs0 + s * kBK * kBN, x, q, M, K, N, ldq,
                              m0, n0, k_begin + nt * kBK, k_end);
    }
    cp_async_commit();

    const char* xs = xs0 + (t % kStages) * BM * kBK * 2;
    const char* qs = qs0 + (t % kStages) * kBK * kBN;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // B: k rows kk*16 + (lane & 15), the warp's chunk wn/16 + (lane >> 4)
      uint32_t r[4], b[4][2];
      ldmatrix_x4_trans(r, smem_addr(qs + swz(kk * 16 + (lane & 15), wn / 16 + (lane >> 4))));
      // every m16 tile's A fragments, then the widening, then the products:
      // the loads overlap the widening, and no branch splits the mma stream
      // (rows past M are zeros in the tile)
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], smem_addr(xs + swz(wm + i * 16 + (lane & 15), kk * 2 + (lane >> 4))));
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t lo = r[2 * c] ^ 0x80808080u, hi = r[2 * c + 1] ^ 0x80808080u;
        b[2 * c][0] = widen_pair(lo, 0);      // even columns, k 2t4, 2t4+1
        b[2 * c][1] = widen_pair(hi, 0);      //               k 2t4+8, 2t4+9
        b[2 * c + 1][0] = widen_pair(lo, 1);  // odd columns
        b[2 * c + 1][1] = widen_pair(hi, 1);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

  // thread holds, per m16 tile and chunk c, rows g and g + 8 at columns
  // n .. n + 3 = even c0, odd c0, even c1, odd c1 (c2, c3 for row g + 8)
  const bool n_vec = N % 4 == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = n0 + wn + 16 * c + 4 * t4;
      if (n >= N) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = m0 + wm + i * 16 + g + 8 * hh;
        if (m >= M) continue;
        float v[4] = {acc[i][2 * c][2 * hh], acc[i][2 * c + 1][2 * hh],
                      acc[i][2 * c][2 * hh + 1], acc[i][2 * c + 1][2 * hh + 1]};
        if (part != nullptr) {
          float* dst = part + ((size_t)z * M + m) * N + n;
          if (n_vec) {
            *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
          } else {
            for (int e = 0; e < 4 && n + e < N; ++e) dst[e] = v[e];
          }
        } else {
          __nv_bfloat16* dst = out + (size_t)m * N + n;
          if (n_vec) {
            const float4 sc = __ldg(reinterpret_cast<const float4*>(scale + n));
            uint2 w;
            w.x = pack_bf16(v[0] * sc.x, v[1] * sc.y);
            w.y = pack_bf16(v[2] * sc.z, v[3] * sc.w);
            *reinterpret_cast<uint2*>(dst) = w;
          } else {
            for (int e = 0; e < 4 && n + e < N; ++e) dst[e] = __float2bfloat16(v[e] * scale[n + e]);
          }
        }
      }
    }
}

// out[m][n] = bf16(scale[n] * sum over z in order of part[z][m][n]), four
// adjacent outputs a thread where N % 4 == 0
__global__ void qmm_splitk_reduce_kernel(const float* __restrict__ part,
                                         const float* __restrict__ scale,
                                         __nv_bfloat16* __restrict__ out, int M, int N,
                                         int splits) {
  const size_t mn = (size_t)M * N, stride = (size_t)gridDim.x * blockDim.x;
  const size_t first = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (N % 4 == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(part);
    for (size_t e = first; e < mn / 4; e += stride) {
      float4 acc = __ldg(p4 + e);
      for (int z = 1; z < splits; ++z) {
        const float4 v = __ldg(p4 + z * (mn / 4) + e);
        acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
      }
      const float4 sc = __ldg(reinterpret_cast<const float4*>(scale + (4 * e) % N));
      uint2 w;
      w.x = pack_bf16(acc.x * sc.x, acc.y * sc.y);
      w.y = pack_bf16(acc.z * sc.z, acc.w * sc.w);
      reinterpret_cast<uint2*>(out)[e] = w;
    }
  } else {
    for (size_t e = first; e < mn; e += stride) {
      float acc = part[e];
      for (int z = 1; z < splits; ++z) acc += part[z * mn + e];
      out[e] = __float2bfloat16(acc * scale[e % N]);
    }
  }
}

template <int BM, bool kAligned>
int launch_bf16(const __nv_bfloat16* x, const int8_t* q, const float* scale,
                __nv_bfloat16* out, float* part, int M, int K, int N, int ldq, int splits,
                int k_chunk, cudaStream_t s) {
  constexpr int bytes = smem_bytes<BM>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmm_bf16_kernel<BM, kAligned>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  qmm_bf16_kernel<BM, kAligned><<<grid, kThreads<BM>, bytes, s>>>(
      x, q, scale, out, splits > 1 ? part : nullptr, M, K, N, ldq, k_chunk);
  if (splits > 1) {
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    const size_t items = N % 4 == 0 ? (size_t)M * N / 4 : (size_t)M * N;
    const int blocks = static_cast<int>(items < 528 * 256 ? (items + 255) / 256 : 528);
    qmm_splitk_reduce_kernel<<<blocks, 256, 0, s>>>(part, scale, out, M, N, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr int BM = 64, BN = 64;  // float32 tile

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
// f32. bfloat16 with splits > 1 sums K in chunks of k_chunk (a multiple of
// 64) over ``splits`` blocks each, through part [splits, M, N] f32 scratch;
// float32 ignores splits, k_chunk and part. Returns cudaGetLastError()
// after the launches, or -1 for an unsupported dtype or split.
extern "C" int quant_matmul(int dtype, const void* x, const void* q, const float* scale,
                            void* out, float* part, int M, int K, int N, int ldq, int splits,
                            int k_chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qi = static_cast<const int8_t*>(q);
  if (dtype == 0) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    qmm_f32_kernel<<<grid, kFmaThreads, 0, s>>>(static_cast<const float*>(x), qi, scale,
                                                static_cast<float*>(out), M, K, N, ldq);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1) return -1;
  if (splits < 1 || k_chunk % kBK || (long long)splits * k_chunk < K ||
      (splits > 1 && ((long long)(splits - 1) * k_chunk >= K || part == nullptr)))
    return -1;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const bool aligned = K % 8 == 0 && N % 16 == 0 && ldq % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % 16 == 0;
  auto fn = M <= 64 ? (aligned ? launch_bf16<64, true> : launch_bf16<64, false>)
                    : (aligned ? launch_bf16<256, true> : launch_bf16<256, false>);
  return fn(xb, qi, scale, ob, part, M, K, N, ldq, splits, k_chunk, s);
}
