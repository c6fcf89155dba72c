// Split-cache beam decode attention and the single-query media read, for
// Hopper (sm_90a), plain C interface.
//
// decode_attn replaces unimp_tpu/ops/decode_attention_pallas.py:_kernel
// (pallas_decode_attention): one query per beam against
//   * the prompt KV [B, Hkv, T, D], shared by the K beams of a row, valid
//     in [kv_start, prompt_len);
//   * the generated KV [B*K, Hkv, G, D], never reordered: beam k reads
//     position g of its ancestor row b*K + beam_sel[bk, g], valid g < step;
// with one online softmax over both segments and ALiBi taken at the
// absolute query position T + step - 1.
//
// single_query_attn replaces decode_attention_pallas.py:_prompt_only_kernel
// (pallas_single_query_attention): one query per beam against the
// beam-shared media latents [B, Hkv, S, D] under a [B, S] allowed mask; a
// fully masked row gives 0.
//
// decode_attn_int8 and single_query_attn_int8 are the int8-KV branches of
// the same two TPU kernels: the caches are int8 with one f32 scale per
// (row, head, position) ([B, Hkv, T] prompt, [B*K, Hkv, G] gen, [B, Hkv, S]
// latents). As in the TPU kernels, a K scale multiplies the logit after
// the scaled dot product, and a V scale multiplies the softmax weight p
// before it is rounded to q's dtype for the PV product, while the running
// sum l takes the raw p. A gen position's scales are read from the same
// ancestor row as its K/V.
//
// What bounds them on the H100: one query row per (beam, head) makes both
// pure streams of K/V bytes (a few FLOPs per byte), so the bound is the
// valid cache bytes over 3.35 TB/s; int8 halves those bytes against bf16
// and adds 4 bytes of scales per position and head. The design: one block
// per (batch row, head), one warp per beam, one lane per key position.
// The K beams of a row sit in one block, so the shared prompt / latent
// rows they all read are fetched from device memory once and served to
// the other beams from L1; each lane reads its key row in 16-byte loads;
// the loops run over the valid range only ([kv_start, prompt_len) and
// g < step), which is what the TPU kernel's clamped index maps did; the
// ancestor row is read directly (no one-hot [K, P*CG] logits). The softmax
// state stays in registers and nothing but the [BK, H, D] output is
// written.

#include <type_traits>

#include "common.cuh"

namespace {

using namespace unimp;

constexpr int kMaxWarps = 16;

// One online-softmax step for this lane's key: returns its weight p
// (0 when masked), and rescales the running state by exp(m_old - m_new).
template <int DPL>
__device__ __forceinline__ float online_step(float s, bool ok, float& m, float& l,
                                             float (&acc)[DPL]) {
  s = ok ? s : kNegInf;
  const float m_new = fmaxf(m, warp_max(s));
  const float p = ok ? expf(s - m_new) : 0.f;
  const float alpha = expf(m - m_new);
  l = l * alpha + warp_sum(p);
  m = m_new;
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
  return p;
}

// acc[d] += sum_j w_j * v_j[d] over the warp's 32 keys, where lane j holds
// p_j, its V scale vs_j (1 for float KV) and the element offset of its V
// row; w_j = p_j * vs_j rounded to T, q's dtype.
template <typename T, typename TKV, int D, int DPL>
__device__ __forceinline__ void accumulate_pv(float p, float vs, size_t row_off,
                                              const TKV* __restrict__ v, float (&acc)[DPL],
                                              int lane) {
  const float pr = round_to<T>(p * vs);
#pragma unroll 4
  for (int j = 0; j < 32; ++j) {
    const float pj = __shfl_sync(kFull, pr, j);
    const size_t rj = __shfl_sync(kFull, row_off, j);
    if (pj != 0.f) {  // uniform across the warp
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] += pj * to_f32(v[rj + d]);
      }
    }
  }
}

template <typename T, int D, int DPL>
__device__ __forceinline__ void write_out(T* __restrict__ out, size_t off, float l,
                                          const float (&acc)[DPL], int lane) {
  const float denom = l > 0.f ? l : 1.f;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) out[off + d] = from_f32<T>(acc[i] / denom);
  }
}

// Per-position K/V scales of an int8 cache; float caches carry none.
struct Scales {
  const float* k;
  const float* v;
};

template <typename T, typename TKV, int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
decode_attn_kernel(const T* __restrict__ q, const TKV* __restrict__ pk,
                   const TKV* __restrict__ pv, const TKV* __restrict__ gk,
                   const TKV* __restrict__ gv, Scales ps, Scales gs,
                   const int* __restrict__ beam_sel, const int* __restrict__ kv_start,
                   const int* __restrict__ prompt_len, const float* __restrict__ alibi,
                   T* __restrict__ out, int K, int H, int Hkv, int Tp, int G, int step,
                   float scale) {
  constexpr int DPL = (D + 31) / 32;
  constexpr bool kInt8 = sizeof(TKV) == 1;
  __shared__ float q_s[kMaxWarps][D];
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const int lo = kv_start ? max(kv_start[b], 0) : 0;
  const int hi = prompt_len ? min(prompt_len[b], Tp) : Tp;
  const int g_hi = min(step, G);
  const float slope = alibi ? alibi[h] : 0.f;
  const float q_abs = (float)(Tp + step - 1);
  const size_t prompt_base = ((size_t)b * Hkv + hk) * Tp;

  for (int kb = warp; kb < K; kb += nwarps) {
    const int bk = b * K + kb;
    __syncwarp();
    for (int d = lane; d < D; d += 32) q_s[warp][d] = to_f32(q[((size_t)bk * H + h) * D + d]);
    __syncwarp();
    float m = kNegInf, l = 0.f, acc[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

    for (int base = lo; base < hi; base += 32) {
      const int pos = base + lane;
      const bool ok = pos < hi;
      const size_t pidx = prompt_base + (ok ? pos : lo);
      float s = 0.f, vs = 1.f;
      if (ok) {
        s = dot_row<TKV, D>(q_s[warp], pk + pidx * D) * scale;
        if (kInt8) {
          s *= ps.k[pidx];
          vs = ps.v[pidx];
        }
      }
      if (alibi) s += slope * ((float)pos - q_abs);
      const float p = online_step(s, ok, m, l, acc);
      accumulate_pv<T, TKV, D>(p, vs, pidx * D, pv, acc, lane);
    }
    for (int base = 0; base < g_hi; base += 32) {
      const int g = base + lane;
      const bool ok = g < g_hi;
      int src = kb;
      if (beam_sel && ok) src = min(max(beam_sel[(size_t)bk * G + g], 0), K - 1);
      // the ancestor's row: its K/V and, for int8, its scales
      const size_t gidx = (((size_t)b * K + src) * Hkv + hk) * G + (ok ? g : 0);
      float s = 0.f, vs = 1.f;
      if (ok) {
        s = dot_row<TKV, D>(q_s[warp], gk + gidx * D) * scale;
        if (kInt8) {
          s *= gs.k[gidx];
          vs = gs.v[gidx];
        }
      }
      if (alibi) s += slope * ((float)(Tp + g) - q_abs);
      const float p = online_step(s, ok, m, l, acc);
      accumulate_pv<T, TKV, D>(p, vs, gidx * D, gv, acc, lane);
    }
    write_out<T, D>(out, ((size_t)bk * H + h) * D, l, acc, lane);
  }
}

template <typename T, typename TKV, int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
single_query_kernel(const T* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, Scales sc, const uint8_t* __restrict__ allowed,
                    T* __restrict__ out, int K, int H, int Hkv, int S, float scale) {
  constexpr int DPL = (D + 31) / 32;
  constexpr bool kInt8 = sizeof(TKV) == 1;
  __shared__ float q_s[kMaxWarps][D];
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const size_t kv_base = ((size_t)b * Hkv + hk) * S;

  for (int kb = warp; kb < K; kb += nwarps) {
    const int bk = b * K + kb;
    __syncwarp();
    for (int d = lane; d < D; d += 32) q_s[warp][d] = to_f32(q[((size_t)bk * H + h) * D + d]);
    __syncwarp();
    float m = kNegInf, l = 0.f, acc[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
    for (int base = 0; base < S; base += 32) {
      const int pos = base + lane;
      const bool ok = pos < S && allowed[(size_t)b * S + pos] != 0;
      const size_t idx = kv_base + (pos < S ? pos : 0);
      float s = 0.f, vs = 1.f;
      if (ok) {
        s = dot_row<TKV, D>(q_s[warp], k + idx * D) * scale;
        if (kInt8) {
          s *= sc.k[idx];
          vs = sc.v[idx];
        }
      }
      const float p = online_step(s, ok, m, l, acc);
      accumulate_pv<T, TKV, D>(p, vs, idx * D, v, acc, lane);
    }
    write_out<T, D>(out, ((size_t)bk * H + h) * D, l, acc, lane);
  }
}

inline int warps_for(int K) { return K < kMaxWarps ? K : kMaxWarps; }

template <typename T, typename TKV, int D>
void launch_decode(const void* q, const void* pk, const void* pv, const void* gk,
                   const void* gv, Scales ps, Scales gs, const int* beam_sel,
                   const int* kv_start, const int* prompt_len, const float* alibi, void* out,
                   int B, int K, int H, int Hkv, int Tp, int G, int step, float scale,
                   cudaStream_t s) {
  decode_attn_kernel<T, TKV, D><<<dim3(H, B), 32 * warps_for(K), 0, s>>>(
      static_cast<const T*>(q), static_cast<const TKV*>(pk), static_cast<const TKV*>(pv),
      static_cast<const TKV*>(gk), static_cast<const TKV*>(gv), ps, gs, beam_sel, kv_start,
      prompt_len, alibi, static_cast<T*>(out), K, H, Hkv, Tp, G, step, scale);
}

template <typename T, typename TKV, int D>
void launch_single(const void* q, const void* k, const void* v, Scales sc,
                   const uint8_t* allowed, void* out, int B, int K, int H, int Hkv, int S,
                   float scale, cudaStream_t s) {
  single_query_kernel<T, TKV, D><<<dim3(H, B), 32 * warps_for(K), 0, s>>>(
      static_cast<const T*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), sc,
      allowed, static_cast<T*>(out), K, H, Hkv, S, scale);
}

// TKV is q's dtype (float KV) or int8_t (int8 KV with scales)
template <bool kInt8>
int decode_dispatch(int dtype, int d, const void* q, const void* pk, const void* pv,
                    const void* gk, const void* gv, Scales ps, Scales gs, const int* beam_sel,
                    const int* kv_start, const int* prompt_len, const float* alibi, void* out,
                    int B, int K, int H, int Hkv, int T, int G, int step, float scale,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using KV = std::conditional_t<kInt8, int8_t, float>;
    UNIMP_DISPATCH_D(d, (launch_decode<float, KV, D>(q, pk, pv, gk, gv, ps, gs, beam_sel,
                                                     kv_start, prompt_len, alibi, out, B, K,
                                                     H, Hkv, T, G, step, scale, s)))
  } else if (dtype == 1) {
    using KV = std::conditional_t<kInt8, int8_t, __nv_bfloat16>;
    UNIMP_DISPATCH_D(d, (launch_decode<__nv_bfloat16, KV, D>(q, pk, pv, gk, gv, ps, gs,
                                                             beam_sel, kv_start, prompt_len,
                                                             alibi, out, B, K, H, Hkv, T, G,
                                                             step, scale, s)))
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kInt8>
int single_dispatch(int dtype, int d, const void* q, const void* k, const void* v, Scales sc,
                    const void* allowed, void* out, int B, int K, int H, int Hkv, int S,
                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* mask = static_cast<const uint8_t*>(allowed);
  if (dtype == 0) {
    using KV = std::conditional_t<kInt8, int8_t, float>;
    UNIMP_DISPATCH_D(d, (launch_single<float, KV, D>(q, k, v, sc, mask, out, B, K, H, Hkv, S,
                                                     scale, s)))
  } else if (dtype == 1) {
    using KV = std::conditional_t<kInt8, int8_t, __nv_bfloat16>;
    UNIMP_DISPATCH_D(d, (launch_single<__nv_bfloat16, KV, D>(q, k, v, sc, mask, out, B, K, H,
                                                             Hkv, S, scale, s)))
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (of q and out): 0 = float32, 1 = bfloat16. step counts the
// generated tokens including the current one. Null beam_sel: each beam
// reads its own gen row; null kv_start / prompt_len / alibi switch those
// off. Returns cudaGetLastError() after the launch, or -1 for an
// unsupported dtype or head dim.
extern "C" int decode_attn(int dtype, int d, const void* q, const void* pk,
                           const void* pv, const void* gk, const void* gv,
                           const int* beam_sel, const int* kv_start,
                           const int* prompt_len, const float* alibi, void* out,
                           int B, int K, int H, int Hkv, int T, int G, int step,
                           float scale, void* stream) {
  return decode_dispatch<false>(dtype, d, q, pk, pv, gk, gv, Scales{}, Scales{}, beam_sel,
                                kv_start, prompt_len, alibi, out, B, K, H, Hkv, T, G, step,
                                scale, stream);
}

// The same over int8 caches: pks / pvs [B, Hkv, T] and gks / gvs
// [B*K, Hkv, G] f32 scales, all four required.
extern "C" int decode_attn_int8(int dtype, int d, const void* q, const void* pk,
                                const void* pv, const void* gk, const void* gv,
                                const float* pks, const float* pvs, const float* gks,
                                const float* gvs, const int* beam_sel, const int* kv_start,
                                const int* prompt_len, const float* alibi, void* out,
                                int B, int K, int H, int Hkv, int T, int G, int step,
                                float scale, void* stream) {
  if (!pks || !pvs || !gks || !gvs) return -1;
  return decode_dispatch<true>(dtype, d, q, pk, pv, gk, gv, Scales{pks, pvs},
                               Scales{gks, gvs}, beam_sel, kv_start, prompt_len, alibi, out, B,
                               K, H, Hkv, T, G, step, scale, stream);
}

extern "C" int single_query_attn(int dtype, int d, const void* q, const void* k,
                                 const void* v, const void* allowed, void* out,
                                 int B, int K, int H, int Hkv, int S, float scale,
                                 void* stream) {
  return single_dispatch<false>(dtype, d, q, k, v, Scales{}, allowed, out, B, K, H, Hkv, S,
                                scale, stream);
}

// The same over int8 latents with ks / vs [B, Hkv, S] f32 scales.
extern "C" int single_query_attn_int8(int dtype, int d, const void* q, const void* k,
                                      const void* v, const float* ks, const float* vs,
                                      const void* allowed, void* out, int B, int K, int H,
                                      int Hkv, int S, float scale, void* stream) {
  if (!ks || !vs) return -1;
  return single_dispatch<true>(dtype, d, q, k, v, Scales{ks, vs}, allowed, out, B, K, H, Hkv,
                               S, scale, stream);
}
