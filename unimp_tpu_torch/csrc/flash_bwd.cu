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
// work per (batch, head) is small, so the bound is the bytes of q, k, v,
// dO, lse, delta and the gradients over 3.35 TB/s (the 4 or 3 matrix
// products sit below the bf16 tensor-core rate). The design keeps the
// [Sq, Skv] probabilities out of device memory: each block recomputes them
// tile by tile in registers and shared memory. The products run on the CUDA
// cores in f32 (no tensor cores yet), as in flash_fwd.cu: simple and right
// first; wgmma, TMA and pipelining are later work.
//
// Translation from the TPU kernels: the sequential inner grid axis with VMEM
// accumulators becomes a loop inside one block, and nothing crosses blocks:
//   K2: one block per (32-key tile, batch x KV head). dK, dV accumulate in
//       registers over the query tiles that can see the tile (causal starts
//       at the tile's diagonal, as pl.when(kv_off <= q_off + bq - 1) does)
//       and, for GQA, over the H / Hkv query heads of the group, so the
//       group sum needs no second pass.
//   K3: one block per (16-query tile, batch x head), looping over the KV
//       tiles of [kv_start, kv_len) up to the causal diagonal.
// No sequence padding: ragged edges are masked at load, so kv_media needs no
// sentinel; int32-max entries, as the TPU wrapper pads with, match no query.

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. media_mode: 0 none, 1 immediate,
// 2 all_previous. Null pointers switch off kv_start / kv_len / alibi /
// media. Each returns the CUDA error of its launch (0 on success), or -1
// for an unsupported dtype or head dim.
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
    UNIMP_DISPATCH_D(d, err = (launch_dkv<__nv_bfloat16, D>(q, k, v, dout, lse, delta, dk,
                                                            dv, kv_start, kv_len, alibi,
                                                            q_media, kv_media, B, Sq, Skv,
                                                            H, Hkv, causal, media_mode,
                                                            scale, s)))
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
    UNIMP_DISPATCH_D(d, err = (launch_dq<__nv_bfloat16, D>(q, k, v, dout, lse, delta, dq,
                                                           kv_start, kv_len, alibi, q_media,
                                                           kv_media, B, Sq, Skv, H, Hkv,
                                                           causal, media_mode, scale, s)))
  } else {
    return -1;
  }
  return static_cast<int>(err);
}
