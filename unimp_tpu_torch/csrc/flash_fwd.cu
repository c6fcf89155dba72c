// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel unimp_tpu/ops/flash_attention.py:_fwd_kernel
// (driven by _flash_fwd). Same function: blocked online-softmax attention
// with f32 running max / sum / accumulator; masks built from indices
// (causal, a per-row KV window [kv_start, kv_len), Flamingo media masks
// "immediate" q_media == kv_media and "all_previous" 0 < kv_media <=
// q_media); ALiBi slope * (k - q); GQA by reading kv head h / (H / Hkv).
// Writes out [B, Sq, H, D] and lse [B, H, Sq] (f32). A fully masked row
// gives out 0 and lse -1e30.
//
// What bounds it on the H100: at the 4b main-path shapes (ViT 257x257,
// perceiver 64x320, LM and cross-attention prefill 128x128 / 128x256,
// head dims 64 and 80) the attention is small per (batch, head), so the
// bound is the bytes of Q, K, V and the output over 3.35 TB/s. The design
// reads each K/V tile once per block of 16 query rows into shared memory
// and keeps the [16, 32] score tile and the softmax state in registers and
// shared memory, so the [Sq, Skv] logits never reach device memory. The
// products run on the CUDA cores in f32 (no tensor cores yet): simple and
// right first; wgmma, TMA and pipelining are later work.
//
// Translation from the TPU kernel: the sequential KV grid axis with VMEM
// scratch becomes the loop over KV tiles inside one block; tiles above the
// causal diagonal and outside [kv_start, kv_len) are loop bounds, not
// masked grid steps; no padding of sequences to 128 (ragged edges are
// masked at load), so padded kv_media needs no int32-max sentinel.

#include "common.cuh"

namespace {

using namespace unimp;

constexpr int kWarps = 4;
constexpr int kRows = 4;               // query rows per warp
constexpr int kBQ = kWarps * kRows;    // query rows per block
constexpr int kBK = 32;                // keys per tile: one per lane

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, const int* __restrict__ kv_start,
                 const int* __restrict__ kv_len, const float* __restrict__ alibi,
                 const int* __restrict__ q_media, const int* __restrict__ kv_media,
                 int Sq, int Skv, int H, int Hkv, int causal, int media_mode,
                 float scale) {
  constexpr int DPL = (D + 31) / 32;  // output dims per lane
  __shared__ float q_s[kBQ][D];
  __shared__ float k_s[kBK][D + 1];   // odd row stride: lane-per-row reads hit distinct banks
  __shared__ float v_s[kBK][D];
  __shared__ float p_s[kWarps][kRows][kBK];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kBQ * D; i += blockDim.x) {
    const int r = i / D, d = i % D, qi = q0 + r;
    q_s[r][d] = qi < Sq ? to_f32(q[(((size_t)b * Sq + qi) * H + h) * D + d]) : 0.f;
  }
  const int lo = kv_start ? max(kv_start[b], 0) : 0;
  int hi = kv_len ? min(kv_len[b], Skv) : Skv;
  if (causal) hi = min(hi, q0 + kBQ);  // tiles above the diagonal add nothing
  const float slope = alibi ? alibi[h] : 0.f;

  float m[kRows], l[kRows], acc[kRows][DPL];
  int qm[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    m[r] = kNegInf;
    l[r] = 0.f;
    qm[r] = (media_mode && qi < Sq) ? q_media[(size_t)b * Sq + qi] : 0;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int base = lo; base < hi; base += kBK) {
    __syncthreads();  // q_s written / previous tile consumed
    for (int i = threadIdx.x; i < kBK * D; i += blockDim.x) {
      const int j = i / D, d = i % D, pos = base + j;
      const bool in = pos < hi;
      const size_t off = (((size_t)b * Skv + pos) * Hkv + hk) * D + d;
      k_s[j][d] = in ? to_f32(k[off]) : 0.f;
      v_s[j][d] = in ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    const int ki = base + lane;
    const int km = (media_mode && ki < hi) ? kv_media[(size_t)b * Skv + ki] : 0;
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = k_s[lane][d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] += q_s[warp * kRows + r][d] * kd;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + warp * kRows + r;
      bool ok = ki < hi;
      if (causal) ok = ok && ki <= qi;
      if (media_mode == 1) ok = ok && qm[r] == km;
      if (media_mode == 2) ok = ok && km <= qm[r] && km > 0;
      float sv = s[r] * scale;
      if (alibi) sv += slope * (float)(ki - qi);
      sv = ok ? sv : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float p = ok ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      p_s[warp][r][lane] = round_to<T>(p);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          const float vv = v_s[j][d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][i] += p_s[warp][r][j] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    if (qi >= Sq) continue;
    const float denom = l[r] > 0.f ? l[r] : 1.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) out[(((size_t)b * Sq + qi) * H + h) * D + d] = from_f32<T>(acc[r][i] / denom);
    }
    if (lane == 0) lse[((size_t)b * H + h) * Sq + qi] = l[r] > 0.f ? m[r] + logf(l[r]) : kNegInf;
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* out, float* lse,
            const int* kv_start, const int* kv_len, const float* alibi,
            const int* q_media, const int* kv_media, int B, int Sq, int Skv,
            int H, int Hkv, int causal, int media_mode, float scale,
            cudaStream_t stream) {
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, kv_start, kv_len, alibi, q_media, kv_media,
      Sq, Skv, H, Hkv, causal, media_mode, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. media_mode: 0 none, 1 immediate,
// 2 all_previous. Null pointers switch off kv_start / kv_len / alibi /
// media. Returns cudaGetLastError() after the launch, or -1 for an
// unsupported dtype or head dim.
extern "C" int flash_fwd(int dtype, int d, const void* q, const void* k,
                         const void* v, void* out, float* lse,
                         const int* kv_start, const int* kv_len,
                         const float* alibi, const int* q_media,
                         const int* kv_media, int B, int Sq, int Skv, int H,
                         int Hkv, int causal, int media_mode, float scale,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    UNIMP_DISPATCH_D(d, launch<float, D>(q, k, v, out, lse, kv_start, kv_len, alibi,
                                         q_media, kv_media, B, Sq, Skv, H, Hkv,
                                         causal, media_mode, scale, s))
  } else if (dtype == 1) {
    UNIMP_DISPATCH_D(d, launch<__nv_bfloat16, D>(q, k, v, out, lse, kv_start, kv_len,
                                                 alibi, q_media, kv_media, B, Sq, Skv,
                                                 H, Hkv, causal, media_mode, scale, s))
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
