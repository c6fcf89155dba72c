// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels unimp_tpu/ops/flash_attention.py:_bwd_dkv_kernel
// (K2) and :_bwd_dq_kernel (K3), driven by _flash_bwd. Same function: from
// q, k, v, dO, the forward's lse and delta = rowsum(dO * O) (both [B, H, Sq]
// f32), recompute p = exp(s - lse) under the forward's masks (causal, the
// per-row KV window [kv_start, kv_len), Flamingo media masks, ALiBi
// slope * (k - q)), then
//   K2: dV = p^T dO, dS = p * (dO V^T - delta) * scale, dK = dS^T Q;
//   K3: dQ = dS K.
// p is rounded to dO's dtype before p^T dO and dS to the input dtype before
// dS^T Q and dS K, where the TPU kernels round. A pair the masks refuse gets
// p = 0 chosen before the exp: a fully masked query row (a text token before
// the first <image> under "immediate") has lse = -1e30, where exp(s - lse)
// would be inf and inf * 0 NaN.
//
// What bounds it on the H100: at the training shapes (LM 3x256x256 causal,
// cross-attention 3x256x384, perceiver 18x64x320; head dims 80 and 64) the
// work per (batch, head) is small, so the bound counted from the inputs is
// the bytes of q, k, v, dO, lse, delta and the gradients over 3.35 TB/s
// (the 4 or 3 matrix products sit below the bf16 tensor-core rate). The
// kernels live on their tensor-core rate and their latency: each block
// recomputes the [Sq, Skv] probabilities tile by tile in registers, so they
// never touch device memory.
//
// Translation from the TPU kernels: the sequential inner grid axis with VMEM
// accumulators becomes a loop inside one block, and nothing crosses blocks
// (no atomics; the results are deterministic):
//   K2: one block per (key tile, batch x KV head). dK, dV accumulate in
//       registers over the query tiles that can see the tile (causal starts
//       at the tile's diagonal, as pl.when(kv_off <= q_off + bq - 1) does)
//       and, for GQA, over the H / Hkv query heads of the group, so the
//       group sum needs no second pass.
//   K3: one block per (query tile, batch x head), looping over the KV
//       tiles of [kv_start, kv_len) up to the causal diagonal.
// No sequence padding: ragged edges are masked at load, so kv_media needs no
// sentinel; int32-max entries, as the TPU wrapper pads with, match no query.
//
// bf16 (mma.sync m16n8k16, bf16 in, f32 accumulate; head dim 64 / 80 / 128
// is 4 / 5 / 8 k steps of 16, no padding), 4 warps of 16 rows a block:
//   K2: a block owns 64 keys, 16 a warp; its K and V tiles are staged once
//       and each warp's K / V A fragments stay in registers (reloaded from
//       shared memory per use at d128, where they would not fit beside the
//       dK / dV accumulators). Q and dO tiles of 64 queries, with their
//       lse, delta and media ids, stream through a double-buffered cp.async
//       ring (rows past Sq zero-filled). Per 16 queries: S^T = K Q^T and
//       dP^T = V dO^T (Q, dO B fragments by ldmatrix), so the accumulator is
//       keys x queries and lse / delta / the masks are read per column; P^T
//       and dS^T are repacked from C fragments straight into A fragments;
//       dV += P^T dO and dK += dS^T Q (B fragments by ldmatrix.trans).
//   K3: K1's shape: a block owns 64 queries, 16 a warp, with their Q and dO
//       A fragments in registers (reloaded at d128); K / V tiles of 64 keys
//       stream through a double-buffered cp.async ring. Per 16 keys: S =
//       Q K^T and dP = dO V^T (ldmatrix), dS repacked C -> A, dQ += dS K
//       (K by ldmatrix.trans).
// Working 16 rows x 16 columns at a time keeps only 16 f32 of S and dP live
// beside the accumulators, so no head dim spills. Masks and ALiBi come from
// each element's (query, key); a (warp, tile) pair where every pair is
// allowed skips the test (no row there can be fully masked), and a warp
// skips a tile that can hold no allowed pair at all (past the causal
// diagonal, or media ids out of the warp's range: under "immediate" a
// 64-latent tile is one image, seen by few query tiles).
//
// float32 stays on the CUDA cores (tensor cores would round its inputs to
// TF32): one query per lane (K2) or one key per lane (K3) for the logits,
// one gradient dim per lane for the products.

#include "common.cuh"

namespace {

using namespace unimp;

constexpr int kWarps = 4;
// K2: each warp owns kKeys keys; one query per lane in a 32-query tile
constexpr int kKeys = 8;
constexpr int kBKV = kWarps * kKeys;
constexpr int kBQ2 = 32;
// K3: each warp owns kRows queries; one key per lane in a 32-key tile
constexpr int kRows = 4;
constexpr int kBQ3 = kWarps * kRows;
constexpr int kBK3 = 32;

__device__ __forceinline__ bool media_ok(int mode, int qm, int km) {
  if (mode == 1) return qm == km;
  if (mode == 2) return km <= qm && km > 0;
  return true;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // q_s, do_s [kBQ2][D + 1]; k_s, v_s [kBKV][D]; p_s, ds_s [kBKV][kBQ2]
  return sizeof(float) * (2 * kBQ2 * (D + 1) + 2 * kBKV * D + 2 * kBKV * kBQ2);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // q_s, do_s [kBQ3][D]; k_s, v_s [kBK3][D + 1]; ds_s [kBQ3][kBK3]
  return sizeof(float) * (2 * kBQ3 * D + 2 * kBK3 * (D + 1) + kBQ3 * kBK3);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv,
                     const int* __restrict__ kv_start, const int* __restrict__ kv_len,
                     const float* __restrict__ alibi, const int* __restrict__ q_media,
                     const int* __restrict__ kv_media, int Sq, int Skv, int H, int Hkv,
                     int causal, int media_mode, float scale) {
  constexpr int DPL = (D + 31) / 32;  // gradient dims per lane
  constexpr int QS = D + 1;           // odd row stride: lane-per-row reads hit distinct banks
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kBQ2 * QS;
  float* k_s = do_s + kBQ2 * QS;
  float* v_s = k_s + kBKV * D;
  float* p_s = v_s + kBKV * D;
  float* ds_s = p_s + kBKV * kBQ2;

  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * kBKV;
  const int group = H / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lo = kv_start ? max(kv_start[b], 0) : 0;
  const int hi = kv_len ? min(kv_len[b], Skv) : Skv;

  for (int i = threadIdx.x; i < kBKV * D; i += blockDim.x) {
    const int pos = k0 + i / D, d = i % D;
    const bool in = pos < Skv;
    const size_t off = (((size_t)b * Skv + pos) * Hkv + hk) * D + d;
    k_s[i] = in ? to_f32(k[off]) : 0.f;
    v_s[i] = in ? to_f32(v[off]) : 0.f;
  }
  int kpos[kKeys], km[kKeys];
  bool kin[kKeys];
  float dk_acc[kKeys][DPL], dv_acc[kKeys][DPL];
#pragma unroll
  for (int r = 0; r < kKeys; ++r) {
    kpos[r] = k0 + warp * kKeys + r;
    kin[r] = kpos[r] >= lo && kpos[r] < hi;
    km[r] = (media_mode && kpos[r] < Skv) ? kv_media[(size_t)b * Skv + kpos[r]] : 0;
#pragma unroll
    for (int i = 0; i < DPL; ++i) dk_acc[r][i] = dv_acc[r][i] = 0.f;
  }

  const int k_first = max(k0, lo), k_last = min(k0 + kBKV, hi) - 1;
  // queries before the tile's first visible key see none of it under causal
  const int q_begin = causal ? (k_first / kBQ2) * kBQ2 : 0;
  for (int h = hk * group; k_first <= k_last && h < (hk + 1) * group; ++h) {
    const float slope = alibi ? alibi[h] : 0.f;
    const size_t row0 = ((size_t)b * H + h) * Sq;
    for (int qb = q_begin; qb < Sq; qb += kBQ2) {
      __syncthreads();  // k_s / v_s written, or the previous q tile consumed
      for (int i = threadIdx.x; i < kBQ2 * D; i += blockDim.x) {
        const int r = i / D, d = i % D, qi = qb + r;
        const size_t off = (((size_t)b * Sq + qi) * H + h) * D + d;
        q_s[r * QS + d] = qi < Sq ? to_f32(q[off]) : 0.f;
        do_s[r * QS + d] = qi < Sq ? to_f32(dout[off]) : 0.f;
      }
      __syncthreads();

      const int qi = qb + lane;
      const bool qin = qi < Sq;
      const float lse_q = qin ? lse[row0 + qi] : 0.f;
      const float delta_q = qin ? delta[row0 + qi] : 0.f;
      const int qm = (media_mode && qin) ? q_media[(size_t)b * Sq + qi] : 0;
      float s[kKeys], dp[kKeys];
#pragma unroll
      for (int r = 0; r < kKeys; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float qd = q_s[lane * QS + d], dd = do_s[lane * QS + d];
#pragma unroll
        for (int r = 0; r < kKeys; ++r) {
          s[r] += qd * k_s[(warp * kKeys + r) * D + d];
          dp[r] += dd * v_s[(warp * kKeys + r) * D + d];
        }
      }
#pragma unroll
      for (int r = 0; r < kKeys; ++r) {
        bool ok = qin && kin[r] && media_ok(media_mode, qm, km[r]);
        if (causal) ok = ok && kpos[r] <= qi;
        float sv = s[r] * scale;
        if (alibi) sv += slope * (float)(kpos[r] - qi);
        const float p = ok ? expf(sv - lse_q) : 0.f;
        p_s[(warp * kKeys + r) * kBQ2 + lane] = round_to<T>(p);
        ds_s[(warp * kKeys + r) * kBQ2 + lane] = round_to<T>(p * (dp[r] - delta_q) * scale);
      }
      __syncwarp();
#pragma unroll 4
      for (int j = 0; j < kBQ2; ++j) {
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) {
            const float dov = do_s[j * QS + d], qv = q_s[j * QS + d];
#pragma unroll
            for (int r = 0; r < kKeys; ++r) {
              dv_acc[r][i] += p_s[(warp * kKeys + r) * kBQ2 + j] * dov;
              dk_acc[r][i] += ds_s[(warp * kKeys + r) * kBQ2 + j] * qv;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kKeys; ++r) {
    if (kpos[r] >= Skv) continue;
    const size_t off = (((size_t)b * Skv + kpos[r]) * Hkv + hk) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) {
        dk[off + d] = from_f32<T>(dk_acc[r][i]);
        dv[off + d] = from_f32<T>(dv_acc[r][i]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, const int* __restrict__ kv_start,
                    const int* __restrict__ kv_len, const float* __restrict__ alibi,
                    const int* __restrict__ q_media, const int* __restrict__ kv_media,
                    int Sq, int Skv, int H, int Hkv, int causal, int media_mode,
                    float scale) {
  constexpr int DPL = (D + 31) / 32;
  constexpr int KS = D + 1;  // odd row stride: lane-per-row reads hit distinct banks
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kBQ3 * D;
  float* k_s = do_s + kBQ3 * D;
  float* v_s = k_s + kBK3 * KS;
  float* ds_s = v_s + kBK3 * KS;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ3;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kBQ3 * D; i += blockDim.x) {
    const int qi = q0 + i / D, d = i % D;
    const size_t off = (((size_t)b * Sq + qi) * H + h) * D + d;
    q_s[i] = qi < Sq ? to_f32(q[off]) : 0.f;
    do_s[i] = qi < Sq ? to_f32(dout[off]) : 0.f;
  }
  const int lo = kv_start ? max(kv_start[b], 0) : 0;
  int hi = kv_len ? min(kv_len[b], Skv) : Skv;
  if (causal) hi = min(hi, q0 + kBQ3);  // tiles above the diagonal add nothing
  const float slope = alibi ? alibi[h] : 0.f;

  float lse_r[kRows], delta_r[kRows], acc[kRows][DPL];
  int qm[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    const size_t row = ((size_t)b * H + h) * Sq + qi;
    lse_r[r] = qi < Sq ? lse[row] : 0.f;
    delta_r[r] = qi < Sq ? delta[row] : 0.f;
    qm[r] = (media_mode && qi < Sq) ? q_media[(size_t)b * Sq + qi] : 0;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int base = lo; base < hi; base += kBK3) {
    __syncthreads();  // q_s written / previous tile consumed
    for (int i = threadIdx.x; i < kBK3 * D; i += blockDim.x) {
      const int j = i / D, d = i % D, pos = base + j;
      const bool in = pos < hi;
      const size_t off = (((size_t)b * Skv + pos) * Hkv + hk) * D + d;
      k_s[j * KS + d] = in ? to_f32(k[off]) : 0.f;
      v_s[j * KS + d] = in ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    const int ki = base + lane;
    const int km = (media_mode && ki < hi) ? kv_media[(size_t)b * Skv + ki] : 0;
    float s[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = k_s[lane * KS + d], vd = v_s[lane * KS + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[r] += q_s[(warp * kRows + r) * D + d] * kd;
        dp[r] += do_s[(warp * kRows + r) * D + d] * vd;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + warp * kRows + r;
      bool ok = ki < hi && qi < Sq && media_ok(media_mode, qm[r], km);
      if (causal) ok = ok && ki <= qi;
      float sv = s[r] * scale;
      if (alibi) sv += slope * (float)(ki - qi);
      const float p = ok ? expf(sv - lse_r[r]) : 0.f;
      ds_s[(warp * kRows + r) * kBK3 + lane] = round_to<T>(p * (dp[r] - delta_r[r]) * scale);
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < kBK3; ++j) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          const float kv = k_s[j * KS + d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][i] += ds_s[(warp * kRows + r) * kBK3 + j] * kv;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    if (qi >= Sq) continue;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) dq[(((size_t)b * Sq + qi) * H + h) * D + d] = from_f32<T>(acc[r][i]);
    }
  }
}

// Both kernels take more than the 48 KB of static shared memory at head
// dim 128, so they ask for it dynamically.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv,
                       const int* kv_start, const int* kv_len, const float* alibi,
                       const int* q_media, const int* kv_media, int B, int Sq, int Skv,
                       int H, int Hkv, int causal, int media_mode, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Skv + kBKV - 1) / kBKV, Hkv, B);
  flash_bwd_dkv_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      kv_start, kv_len, alibi, q_media, kv_media, Sq, Skv, H, Hkv, causal, media_mode,
      scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq,
                      const int* kv_start, const int* kv_len, const float* alibi,
                      const int* q_media, const int* kv_media, int B, int Sq, int Skv,
                      int H, int Hkv, int causal, int media_mode, float scale,
                      cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ3 - 1) / kBQ3, H, B);
  flash_bwd_dq_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), kv_start, kv_len,
      alibi, q_media, kv_media, Sq, Skv, H, Hkv, causal, media_mode, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16: mma.sync

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;  // keys (K2) or queries (K3) a block owns
constexpr int kMmaTile = 64;              // queries (K2) or keys (K3) a streamed tile holds
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kIntMax = 0x7fffffff;

template <int D>
constexpr int kMmaLD = D + 8;  // smem row stride (bf16): 16 bytes of padding

template <int D>
constexpr int mma_smem_bytes() {
  // K2: K, V [64][LD]; Q, dO [2][64][LD]; lse, delta, q_media [2][64]
  // K3: Q, dO [64][LD]; K, V [2][64][LD]; kv_media [2][64]
  return 6 * kMmaTile * kMmaLD<D> * 2 + 3 * 2 * kMmaTile * 4;
}

// The A fragments (16 rows x 16 of the head dim, k step kk) of the warp's
// rows of a [64][LD] tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int warp, int lane,
                                       int kk) {
  ldmatrix_x4(a, smem_addr(tile + (warp * 16 + (lane & 15)) * LD + 16 * kk + 8 * (lane >> 4)));
}

// acc[n] += a * B, B^T = rows 16 c + 8 n .. + 7 of a [64][LD] tile at head
// dims 16 kk .. + 15 (the products with the streamed tile's rows: S, dP)
template <int LD>
__device__ __forceinline__ void mma_rows(float (&acc)[2][4], const uint32_t (&a)[4],
                                         const bf16* tile, int lane, int c, int kk) {
  uint32_t r[4];
  const int row = 16 * c + (lane & 7) + ((lane >> 4) << 3);
  ldmatrix_x4(r, smem_addr(tile + row * LD + 16 * kk + 8 * ((lane >> 3) & 1)));
  const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
  mma_bf16_16816(acc[0], a, b0);
  mma_bf16_16816(acc[1], a, b1);
}

// acc += a * B, B = rows 16 c .. + 15 of a [64][LD] tile over the whole
// head dim (the products along the streamed rows: dV, dK, dQ)
template <int D, int LD>
__device__ __forceinline__ void mma_cols(float (&acc)[D / 8][4], const uint32_t (&a)[4],
                                         const bf16* tile, int lane, int c) {
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    uint32_t r[4];
    const int row = 16 * c + (lane & 7) + (((lane >> 3) & 1) << 3);
    ldmatrix_x4_trans(r, smem_addr(tile + row * LD + 16 * dp + 8 * (lane >> 4)));
    const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
    mma_bf16_16816(acc[2 * dp], a, b0);
    mma_bf16_16816(acc[2 * dp + 1], a, b1);
  }
}

// C fragments of 16 x 16 (two n8 tiles), rounded to bf16, as the A
// fragment of one k step of 16
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

// Stores a warp's 16 rows x D f32 accumulator as bf16; rows [g, g + 8] of
// the thread at dst[0], dst[1] (null: past the sequence).
template <int D>
__device__ __forceinline__ void store_rows(bf16* const (&dst)[2], const float (&acc)[D / 8][4],
                                           int t4) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!dst[hh]) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst[hh] + 8 * j + 2 * t4) =
          pack_bf16(acc[j][2 * hh], acc[j][2 * hh + 1]);
  }
}

// kMasked: media masks or ALiBi touch every tile; otherwise only the tiles
// on the window's ragged ends or the causal diagonal take the masked path.
// d64 without masks (the perceiver) fits 3 blocks an SM in 168 registers
// with no spill; the others need more.
template <int D, bool kMasked>
__global__ void __launch_bounds__(kMmaWarps * 32, D == 64 && !kMasked ? 3 : 1)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         const int* __restrict__ kv_start, const int* __restrict__ kv_len,
                         const float* __restrict__ alibi, const int* __restrict__ q_media,
                         const int* __restrict__ kv_media, int Sq, int Skv, int H, int Hkv,
                         int causal, int media_mode, float scale) {
  constexpr int LD = kMmaLD<D>;
  constexpr int CH = D / 8;   // 16-byte chunks in a row
  constexpr int KD = D / 16;  // k16 steps of S^T and dP^T
  constexpr int ND = D / 8;   // n8 tiles of dK, dV
  constexpr bool kHold = D <= 80;  // K / V A fragments stay in registers
  // extern shared arrays of one name must share a type: the f32 kernels' is float
  extern __shared__ __align__(16) char mma_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(mma_smem);  // [64][LD]
  bf16* v_s = k_s + kMmaRows * LD;             // [64][LD]
  bf16* q_s = v_s + kMmaRows * LD;             // [2][64][LD]
  bf16* do_s = q_s + 2 * kMmaTile * LD;        // [2][64][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kMmaTile * LD);  // [2][64]
  float* dl_s = lse_s + 2 * kMmaTile;                                  // [2][64]
  int* qm_s = reinterpret_cast<int*>(dl_s + 2 * kMmaTile);             // [2][64]

  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * kMmaRows;
  const int group = H / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int lo = kv_start ? max(kv_start[b], 0) : 0;
  const int hi = kv_len ? min(kv_len[b], Skv) : Skv;
  const int k_first = max(k0, lo), k_last = min(k0 + kMmaRows, hi) - 1;
  // query tiles before the one holding the block's first visible key see
  // none of it under causal
  const int qt0 = causal ? k_first / kMmaTile : 0;
  const int n_qt = k_first <= k_last ? max((Sq + kMmaTile - 1) / kMmaTile - qt0, 0) : 0;
  const int n_it = n_qt * group;  // (head of the group, query tile), head-major
  const float scale2 = scale * kLog2e;  // logits in the log2 domain: one FFMA and one ex2 a p

  // the warp's keys [w0, w0 + 16) and its visible ones [wk_first, wk_last]
  const int w0 = k0 + warp * 16;
  const int wk_first = max(w0, lo), wk_last = min(w0 + 16, hi) - 1;
  const bool live = wk_first <= wk_last;
  // the thread's two keys: rows g and g + 8 of the warp's 16
  int kpos[2], km[2];
  bool kin[2];
  int m_lo = kIntMax, m_hi = -kIntMax, m_pos = kIntMax;  // the warp's media ids
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    kpos[hh] = w0 + g + 8 * hh;
    kin[hh] = kpos[hh] >= lo && kpos[hh] < hi;
    km[hh] = (media_mode && kpos[hh] < Skv) ? kv_media[(size_t)b * Skv + kpos[hh]] : 0;
    if (kin[hh]) {
      m_lo = min(m_lo, km[hh]);
      m_hi = max(m_hi, km[hh]);
      if (km[hh] > 0) m_pos = min(m_pos, km[hh]);
    }
  }
  if (media_mode) {
    m_lo = __reduce_min_sync(kFull, m_lo);
    m_hi = __reduce_max_sync(kFull, m_hi);
    m_pos = __reduce_min_sync(kFull, m_pos);
  }

  auto load_q = [&](int it, int slot) {
    const int h = hk * group + it / n_qt, qb = (qt0 + it % n_qt) * kMmaTile;
    for (int i = tid; i < kMmaTile * CH; i += kMmaWarps * 32) {
      const int r = i / CH, c = i % CH, row = qb + r;
      const bool in = row < Sq;
      const size_t off = (((size_t)b * Sq + row) * H + h) * D + 8 * c;
      const int dst = (slot * kMmaTile + r) * LD + 8 * c;
      cp_async_16(smem_addr(q_s + dst), in ? q + off : q, in ? 16 : 0);
      cp_async_16(smem_addr(do_s + dst), in ? dout + off : dout, in ? 16 : 0);
    }
    const int r = tid % kMmaTile, row = qb + r;
    const bool in = row < Sq;
    const size_t off = ((size_t)b * H + h) * Sq + row;
    if (tid < kMmaTile) {
      cp_async_4(smem_addr(lse_s + slot * kMmaTile + r), in ? lse + off : lse, in ? 4 : 0);
      cp_async_4(smem_addr(dl_s + slot * kMmaTile + r), in ? delta + off : delta, in ? 4 : 0);
    } else if (media_mode) {
      cp_async_4(smem_addr(qm_s + slot * kMmaTile + r),
                 in ? q_media + (size_t)b * Sq + row : q_media, in ? 4 : 0);
    }
  };

  if (n_it > 0) {
    for (int i = tid; i < kMmaRows * CH; i += kMmaWarps * 32) {
      const int r = i / CH, c = i % CH, pos = k0 + r;
      const bool in = pos < Skv;
      const size_t off = (((size_t)b * Skv + pos) * Hkv + hk) * D + 8 * c;
      cp_async_16(smem_addr(k_s + r * LD + 8 * c), in ? k + off : k, in ? 16 : 0);
      cp_async_16(smem_addr(v_s + r * LD + 8 * c), in ? v + off : v, in ? 16 : 0);
    }
    load_q(0, 0);
  }
  cp_async_commit();

  uint32_t kf[kHold ? KD : 1][4], vf[kHold ? KD : 1][4];
  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int slot = it & 1;
    if (it + 1 < n_it) load_q(it + 1, slot ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile it (and K, V) landed for every thread
    const int h = hk * group + it / n_qt, qb = (qt0 + it % n_qt) * kMmaTile;
    if (kHold && it == 0 && live) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        load_a<LD>(kf[kk], k_s, warp, lane, kk);
        load_a<LD>(vf[kk], v_s, warp, lane, kk);
      }
    }
    const float* ls = lse_s + slot * kMmaTile;
    const float* dls = dl_s + slot * kMmaTile;
    const int* qms = qm_s + slot * kMmaTile;
    // does the tile hold an allowed pair for the warp's keys?
    bool run = live && (!causal || wk_first <= qb + kMmaTile - 1);
    if (media_mode && run) {
      bool hit = false;
      for (int i = lane; i < kMmaTile; i += 32) {
        const int x = qms[i];
        hit |= qb + i < Sq && (media_mode == 1 ? (x >= m_lo && x <= m_hi) : x >= m_pos);
      }
      run = __any_sync(kFull, hit);
    }
    if (run) {
      const bf16* qs = q_s + slot * kMmaTile * LD;
      const bf16* dos = do_s + slot * kMmaTile * LD;
      const float slope2 = alibi ? alibi[h] * kLog2e : 0.f;
      // every (key, query) pair of the warp and the tile is allowed
      const bool plain = !kMasked && w0 >= lo && w0 + 16 <= hi && qb + kMmaTile <= Sq &&
                         (!causal || w0 + 15 <= qb);
      // 16 queries at a time, not unrolled: fewer live registers, and
      // faster on the H100 than the unrolled loop
#pragma unroll 1
      for (int c = 0; c < kMmaTile / 16; ++c) {
        // st[n] / dpt[n]: keys g, g + 8 x queries 16 c + 8 n + 2 t4 + (0, 1)
        float st[2][4] = {}, dpt[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          uint32_t ak[4], av[4];
          if constexpr (kHold) {
#pragma unroll
            for (int e = 0; e < 4; ++e) ak[e] = kf[kk][e], av[e] = vf[kk][e];
          } else {
            load_a<LD>(ak, k_s, warp, lane, kk);
            load_a<LD>(av, v_s, warp, lane, kk);
          }
          mma_rows<LD>(st, ak, qs, lane, c, kk);
          mma_rows<LD>(dpt, av, dos, lane, c, kk);
        }
        // st becomes p (f32), dpt becomes ds = p (dp - delta) scale
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 16 * c + 8 * n + 2 * t4 + e, qi = qb + col;
            const float l2 = ls[col] * kLog2e, dl = dls[col];
            const int qm = media_mode ? qms[col] : 0;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float x = fmaf(st[n][2 * hh + e], scale2, -l2);
              float p;
              if (plain) {
                p = fast_exp2(x);
              } else {
                // p is 0 where the mask says so, before the exp chooses anything
                bool ok = kin[hh] && qi < Sq && media_ok(media_mode, qm, km[hh]);
                if (causal) ok = ok && kpos[hh] <= qi;
                if (alibi) x += slope2 * (float)(kpos[hh] - qi);
                p = ok ? fast_exp2(x) : 0.f;
              }
              st[n][2 * hh + e] = p;
              dpt[n][2 * hh + e] = p * (dpt[n][2 * hh + e] - dl) * scale;
            }
          }
        // dV += P^T dO, dK += dS^T Q: k step = these 16 queries
        uint32_t ap[4], ads[4];
        c_to_a(ap, st);
        c_to_a(ads, dpt);
        mma_cols<D, LD>(dv_acc, ap, dos, lane, c);
        mma_cols<D, LD>(dk_acc, ads, qs, lane, c);
      }
    }
    __syncthreads();  // slot consumed: the next iteration loads into it
  }
  cp_async_wait<0>();

  bf16 *dk_row[2], *dv_row[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const bool in = kpos[hh] < Skv;
    const size_t off = (((size_t)b * Skv + kpos[hh]) * Hkv + hk) * D;
    dk_row[hh] = in ? dk + off : nullptr;
    dv_row[hh] = in ? dv + off : nullptr;
  }
  store_rows<D>(dk_row, dk_acc, t4);
  store_rows<D>(dv_row, dv_acc, t4);
}

template <int D, bool kMasked>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, const int* __restrict__ kv_start,
                        const int* __restrict__ kv_len, const float* __restrict__ alibi,
                        const int* __restrict__ q_media, const int* __restrict__ kv_media,
                        int Sq, int Skv, int H, int Hkv, int causal, int media_mode,
                        float scale) {
  constexpr int LD = kMmaLD<D>;
  constexpr int CH = D / 8;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  constexpr bool kHold = D <= 80;  // Q / dO A fragments stay in registers
  extern __shared__ __align__(16) char mma_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(mma_smem);  // [64][LD]
  bf16* do_s = q_s + kMmaRows * LD;            // [64][LD]
  bf16* k_s = do_s + kMmaRows * LD;            // [2][64][LD]
  bf16* v_s = k_s + 2 * kMmaTile * LD;         // [2][64][LD]
  int* km_s = reinterpret_cast<int*>(v_s + 2 * kMmaTile * LD);  // [2][64]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kMmaRows;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int lo = kv_start ? max(kv_start[b], 0) : 0;
  int hi = kv_len ? min(kv_len[b], Skv) : Skv;
  if (causal) hi = min(hi, q0 + kMmaRows);  // tiles above the diagonal add nothing
  const int n_tiles = hi > lo ? (hi - lo + kMmaTile - 1) / kMmaTile : 0;
  const float scale2 = scale * kLog2e;
  const float slope2 = alibi ? alibi[h] * kLog2e : 0.f;

  auto load_kv = [&](int t, int slot) {
    const int base = lo + t * kMmaTile;
    for (int i = tid; i < kMmaTile * CH; i += kMmaWarps * 32) {
      const int j = i / CH, c = i % CH, pos = base + j;
      const bool in = pos < hi;
      const size_t off = (((size_t)b * Skv + pos) * Hkv + hk) * D + 8 * c;
      const int dst = (slot * kMmaTile + j) * LD + 8 * c;
      cp_async_16(smem_addr(k_s + dst), in ? k + off : k, in ? 16 : 0);
      cp_async_16(smem_addr(v_s + dst), in ? v + off : v, in ? 16 : 0);
    }
    if (media_mode && tid < kMmaTile) {
      const int pos = base + tid;
      const bool in = pos < hi;
      cp_async_4(smem_addr(km_s + slot * kMmaTile + tid),
                 in ? kv_media + (size_t)b * Skv + pos : kv_media, in ? 4 : 0);
    }
  };

  // the warp's rows [w0, w0 + 16); the thread's two: g and g + 8
  const int w0 = q0 + warp * 16;
  const bool live = w0 < Sq;
  int qi[2], qm[2];
  float lse2[2], dl[2];
  int m_lo = kIntMax, m_hi = -kIntMax;  // the warp's media ids
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    qi[hh] = w0 + g + 8 * hh;
    const bool in = qi[hh] < Sq;
    const size_t row = ((size_t)b * H + h) * Sq + qi[hh];
    lse2[hh] = in ? lse[row] * kLog2e : 0.f;
    dl[hh] = in ? delta[row] : 0.f;
    qm[hh] = (media_mode && in) ? q_media[(size_t)b * Sq + qi[hh]] : 0;
    if (in) {
      m_lo = min(m_lo, qm[hh]);
      m_hi = max(m_hi, qm[hh]);
    }
  }
  if (media_mode) {
    m_lo = __reduce_min_sync(kFull, m_lo);
    m_hi = __reduce_max_sync(kFull, m_hi);
  }

  if (n_tiles > 0) {
    for (int i = tid; i < kMmaRows * CH; i += kMmaWarps * 32) {
      const int r = i / CH, c = i % CH, row = q0 + r;
      const bool in = row < Sq;
      const size_t off = (((size_t)b * Sq + row) * H + h) * D + 8 * c;
      cp_async_16(smem_addr(q_s + r * LD + 8 * c), in ? q + off : q, in ? 16 : 0);
      cp_async_16(smem_addr(do_s + r * LD + 8 * c), in ? dout + off : dout, in ? 16 : 0);
    }
    load_kv(0, 0);
  }
  cp_async_commit();

  uint32_t qf[kHold ? KD : 1][4], df[kHold ? KD : 1][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t & 1;
    if (t + 1 < n_tiles) load_kv(t + 1, slot ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile t (and Q, dO) landed for every thread
    if (kHold && t == 0 && live) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        load_a<LD>(qf[kk], q_s, warp, lane, kk);
        load_a<LD>(df[kk], do_s, warp, lane, kk);
      }
    }
    const int base = lo + t * kMmaTile;
    const int* kms = km_s + slot * kMmaTile;
    // does the tile hold an allowed pair for the warp's rows?
    bool run = live && (!causal || base <= w0 + 15);
    if (media_mode && run) {
      bool hit = false;
      for (int i = lane; i < kMmaTile; i += 32) {
        const int x = kms[i];
        hit |= base + i < hi && (media_mode == 1 ? (x >= m_lo && x <= m_hi) : (x > 0 && x <= m_hi));
      }
      run = __any_sync(kFull, hit);
    }
    if (run) {
      const bf16* ks = k_s + slot * kMmaTile * LD;
      const bf16* vs = v_s + slot * kMmaTile * LD;
      // every (query, key) pair of the warp and the tile is allowed
      const bool plain =
          !kMasked && base + kMmaTile <= hi && (!causal || base + kMmaTile - 1 <= w0);
#pragma unroll
      for (int c = 0; c < kMmaTile / 16; ++c) {  // 16 keys at a time
        // s[n] / dp[n]: rows g, g + 8 x keys 16 c + 8 n + 2 t4 + (0, 1)
        float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          uint32_t aq[4], ad[4];
          if constexpr (kHold) {
#pragma unroll
            for (int e = 0; e < 4; ++e) aq[e] = qf[kk][e], ad[e] = df[kk][e];
          } else {
            load_a<LD>(aq, q_s, warp, lane, kk);
            load_a<LD>(ad, do_s, warp, lane, kk);
          }
          mma_rows<LD>(s, aq, ks, lane, c, kk);
          mma_rows<LD>(dp, ad, vs, lane, c, kk);
        }
        // dp becomes ds = p (dp - delta) scale
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 16 * c + 8 * n + 2 * t4 + e, ki = base + col;
            const int km = media_mode ? kms[col] : 0;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float x = fmaf(s[n][2 * hh + e], scale2, -lse2[hh]);
              float p;
              if (plain) {
                p = fast_exp2(x);
              } else {
                // p is 0 where the mask says so, before the exp chooses anything
                bool ok = ki < hi && media_ok(media_mode, qm[hh], km);
                if (causal) ok = ok && ki <= qi[hh];
                if (alibi) x += slope2 * (float)(ki - qi[hh]);
                p = ok ? fast_exp2(x) : 0.f;
              }
              dp[n][2 * hh + e] = p * (dp[n][2 * hh + e] - dl[hh]) * scale;
            }
          }
        // dQ += dS K: k step = these 16 keys
        uint32_t ads[4];
        c_to_a(ads, dp);
        mma_cols<D, LD>(acc, ads, ks, lane, c);
      }
    }
    __syncthreads();  // slot consumed: the next iteration loads into it
  }
  cp_async_wait<0>();

  bf16* dst[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    dst[hh] = qi[hh] < Sq ? dq + (((size_t)b * Sq + qi[hh]) * H + h) * D : nullptr;
  store_rows<D>(dst, acc, t4);
}

// The dynamic shared-memory size is set once per instantiation.
template <typename Kernel>
cudaError_t allow_smem_once(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = allow_smem(kernel, bytes);
  done = err == cudaSuccess;
  return err;
}

template <int D, bool kMasked>
cudaError_t launch_dkv_mma_as(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, void* dk, void* dv,
                              const int* kv_start, const int* kv_len, const float* alibi,
                              const int* q_media, const int* kv_media, int B, int Sq, int Skv,
                              int H, int Hkv, int causal, int media_mode, float scale,
                              cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<D>();
  static bool attr_set = false;
  const cudaError_t err =
      allow_smem_once(flash_bwd_dkv_mma_kernel<D, kMasked>, bytes, attr_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Skv + kMmaRows - 1) / kMmaRows, Hkv, B);
  flash_bwd_dkv_mma_kernel<D, kMasked><<<grid, kMmaWarps * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), kv_start, kv_len, alibi, q_media, kv_media, Sq, Skv, H, Hkv,
      causal, media_mode, scale);
  return cudaGetLastError();
}

template <int D, bool kMasked>
cudaError_t launch_dq_mma_as(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dq,
                             const int* kv_start, const int* kv_len, const float* alibi,
                             const int* q_media, const int* kv_media, int B, int Sq, int Skv,
                             int H, int Hkv, int causal, int media_mode, float scale,
                             cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<D>();
  static bool attr_set = false;
  const cudaError_t err = allow_smem_once(flash_bwd_dq_mma_kernel<D, kMasked>, bytes, attr_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kMmaRows - 1) / kMmaRows, H, B);
  flash_bwd_dq_mma_kernel<D, kMasked><<<grid, kMmaWarps * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), kv_start, kv_len,
      alibi, q_media, kv_media, Sq, Skv, H, Hkv, causal, media_mode, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; the
// masked instantiation where media masks or ALiBi touch every tile).
// media_mode: 0 none, 1 immediate, 2 all_previous. Null pointers switch
// off kv_start / kv_len / alibi / media. Each returns the CUDA error of
// its launch (0 on success), or -1 for an unsupported dtype or head dim.
extern "C" int flash_bwd_dkv(int dtype, int d, const void* q, const void* k,
                             const void* v, const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv,
                             const int* kv_start, const int* kv_len,
                             const float* alibi, const int* q_media,
                             const int* kv_media, int B, int Sq, int Skv, int H,
                             int Hkv, int causal, int media_mode, float scale,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (dtype == 0) {
    UNIMP_DISPATCH_D(d, err = (launch_dkv<float, D>(q, k, v, dout, lse, delta, dk, dv,
                                                    kv_start, kv_len, alibi, q_media,
                                                    kv_media, B, Sq, Skv, H, Hkv, causal,
                                                    media_mode, scale, s)))
  } else if (dtype == 1) {
    const bool masked = media_mode || alibi;
    UNIMP_DISPATCH_D(d, auto fn = masked ? launch_dkv_mma_as<D, true>
                                         : launch_dkv_mma_as<D, false>;
                     err = fn(q, k, v, dout, lse, delta, dk, dv, kv_start, kv_len, alibi,
                              q_media, kv_media, B, Sq, Skv, H, Hkv, causal, media_mode,
                              scale, s))
  } else {
    return -1;
  }
  return static_cast<int>(err);
}

extern "C" int flash_bwd_dq(int dtype, int d, const void* q, const void* k,
                            const void* v, const void* dout, const float* lse,
                            const float* delta, void* dq, const int* kv_start,
                            const int* kv_len, const float* alibi,
                            const int* q_media, const int* kv_media, int B, int Sq,
                            int Skv, int H, int Hkv, int causal, int media_mode,
                            float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (dtype == 0) {
    UNIMP_DISPATCH_D(d, err = (launch_dq<float, D>(q, k, v, dout, lse, delta, dq, kv_start,
                                                   kv_len, alibi, q_media, kv_media, B, Sq,
                                                   Skv, H, Hkv, causal, media_mode, scale, s)))
  } else if (dtype == 1) {
    const bool masked = media_mode || alibi;
    UNIMP_DISPATCH_D(d, auto fn = masked ? launch_dq_mma_as<D, true>
                                         : launch_dq_mma_as<D, false>;
                     err = fn(q, k, v, dout, lse, delta, dq, kv_start, kv_len, alibi,
                              q_media, kv_media, B, Sq, Skv, H, Hkv, causal, media_mode,
                              scale, s))
  } else {
    return -1;
  }
  return static_cast<int>(err);
}
