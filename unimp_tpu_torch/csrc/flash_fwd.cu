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
// What bounds it on the H100. Per (batch, head) the main-path shapes are
// small (ViT 257 x 257 and perceiver 64 x 320 at d64, cross-attention
// prefill 128 x 256 and LM prefill 128 x 128 at d80): 4 * D flops per
// (query, key) pair against 2 * D * 2 bytes per key of K and V, read once
// per 64 queries, puts every shape past the bf16 ridge (~295 flops a
// byte) once the K/V tiles are reused from shared memory. The bound
// counted from the inputs is the bytes (each of Q, K, V and out once), but
// the kernel lives on its tensor-core rate and on how little of each
// 64-key tile the ragged tails (257, 320 keys) waste.
//
// The design, bf16 (FA2 on mma.sync): one block of 4 warps owns 64 query
// rows, each warp 16. Q is staged once and its A fragments stay in
// registers for the whole KV loop. K/V tiles of 64 keys arrive by cp.async
// in a double-buffered shared ring (rows padded by 16 bytes: ldmatrix reads
// them without bank conflicts; keys past the window zero-filled by a
// 0-byte source), with the media ids of the tile beside them. S = Q K^T
// runs as m16n8k16 (bf16 in, f32 accumulate; head dim 64 / 80 / 128 is
// 4 / 5 / 8 k steps, no padding) with K fragments by ldmatrix. Masks and
// ALiBi apply per accumulator element from its (row, key); P is 0 where
// the mask says so before the exp chooses anything, the row max and sum
// go across the 4 lanes of a row by shuffles, P rounds to bf16 and is
// repacked from the C fragments straight into A fragments for P V (V
// fragments by ldmatrix.trans), so P never touches shared memory; the
// denominator is the unrounded f32 sum. Tiles above the causal diagonal
// and outside [kv_start, kv_len) are loop bounds.
//
// float32 stays on the CUDA cores (tensor cores would round its inputs to
// TF32): 4 warps of 4 query rows, K/V tiles of 32 keys as f32 in shared
// memory, one key per lane for Q K^T and one output dim per lane for P V.
//
// Translation from the TPU kernel: the sequential KV grid axis with VMEM
// scratch becomes the loop over KV tiles inside one block; no padding of
// sequences to 128 (ragged edges are masked at load), so padded kv_media
// needs no int32-max sentinel.

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

// ---------------------------------------------------------------- bf16: mma.sync

constexpr int kMmaWarps = 4;
constexpr int kMmaBQ = 16 * kMmaWarps;  // query rows per block, 16 per warp
constexpr int kMmaBK = 64;              // keys per tile

template <int D>
constexpr int kMmaLD = D + 8;  // smem row stride (bf16): 16 bytes of padding

template <int D>
constexpr int mma_smem_bytes() {
  // Q [64][LD], K and V [2][64][LD] bf16, kv_media [2][64] int
  return 5 * kMmaBQ * kMmaLD<D> * 2 + 2 * kMmaBK * 4;
}

// kMasked: media masks or ALiBi touch every tile; otherwise only the tiles
// on the window's ragged end or the causal diagonal take the masked path
template <int D, bool kMasked>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, const int* __restrict__ kv_start,
                     const int* __restrict__ kv_len, const float* __restrict__ alibi,
                     const int* __restrict__ q_media, const int* __restrict__ kv_media,
                     int Sq, int Skv, int H, int Hkv, int causal, int media_mode,
                     float scale) {
  constexpr int LD = kMmaLD<D>;
  constexpr int CH = D / 8;   // 16-byte chunks in a row
  constexpr int KD = D / 16;  // k16 steps of Q K^T
  constexpr int ND = D / 8;   // n8 tiles of O
  extern __shared__ __align__(16) char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k_s = q_s + kMmaBQ * LD;   // [2][64][LD]
  __nv_bfloat16* v_s = k_s + 2 * kMmaBK * LD;
  int* km_s = reinterpret_cast<int*>(v_s + 2 * kMmaBK * LD);  // [2][64]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kMmaBQ;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int lo = kv_start ? max(kv_start[b], 0) : 0;
  int hi = kv_len ? min(kv_len[b], Skv) : Skv;
  if (causal) hi = min(hi, q0 + kMmaBQ);  // tiles above the diagonal add nothing
  const int n_tiles = hi > lo ? (hi - lo + kMmaBK - 1) / kMmaBK : 0;
  // logits in the log2 domain, s * scale * log2(e) (+ ALiBi * log2(e)):
  // each p is then one FFMA and one ex2
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale2 = scale * kLog2e;
  const float slope2 = alibi ? alibi[h] * kLog2e : 0.f;

  auto load_kv = [&](int t, int slot) {
    const int base = lo + t * kMmaBK;
    for (int i = tid; i < kMmaBK * CH; i += kMmaWarps * 32) {
      const int j = i / CH, c = i % CH, pos = base + j;
      const bool in = pos < hi;
      const size_t off = (((size_t)b * Skv + pos) * Hkv + hk) * D + 8 * c;
      const int dst = (slot * kMmaBK + j) * LD + 8 * c;
      cp_async_16(smem_addr(k_s + dst), in ? k + off : k, in ? 16 : 0);
      cp_async_16(smem_addr(v_s + dst), in ? v + off : v, in ? 16 : 0);
    }
    if (media_mode && tid < kMmaBK) {
      const int pos = base + tid;
      const bool in = pos < hi;
      cp_async_4(smem_addr(km_s + slot * kMmaBK + tid),
                 in ? kv_media + (size_t)b * Skv + pos : kv_media, in ? 4 : 0);
    }
  };

  // the thread's two rows: g and g + 8 of the warp's 16
  int qi[2], qm[2];
  float m[2], l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    qi[hh] = q0 + warp * 16 + g + 8 * hh;
    qm[hh] = (media_mode && qi[hh] < Sq) ? q_media[(size_t)b * Sq + qi[hh]] : 0;
    m[hh] = kNegInf;  // running max, log2 domain
    l[hh] = 0.f;      // this lane's share of the row sum
  }
  const bool live = q0 + warp * 16 < Sq;  // warp-uniform: the warp has rows to compute
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  if (n_tiles > 0) {
    for (int i = tid; i < kMmaBQ * CH; i += kMmaWarps * 32) {
      const int r = i / CH, c = i % CH, row = q0 + r;
      const bool in = row < Sq;
      cp_async_16(smem_addr(q_s + r * LD + 8 * c),
                  in ? q + (((size_t)b * Sq + row) * H + h) * D + 8 * c : q, in ? 16 : 0);
    }
    load_kv(0, 0);
  }
  cp_async_commit();

  uint32_t qf[KD][4];
  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t & 1;
    if (t + 1 < n_tiles) load_kv(t + 1, slot ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile t (and Q) landed for every thread
    if (live) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          ldmatrix_x4(qf[kk], smem_addr(q_s + (warp * 16 + (lane & 15)) * LD + 16 * kk +
                                        8 * (lane >> 4)));
      }
      const __nv_bfloat16* ks = k_s + slot * kMmaBK * LD;
      const __nv_bfloat16* vs = v_s + slot * kMmaBK * LD;

      // S = Q K^T: s[j] is keys 8j .. 8j + 7 of the tile
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          // matrices: keys 16jp + 0..7 at d 16kk and 16kk + 8, then keys + 8
          uint32_t r[4];
          const int key = 16 * jp + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(r, smem_addr(ks + key * LD + 16 * kk + 8 * ((lane >> 3) & 1)));
          const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
          mma_bf16_16816(s[2 * jp], qf[kk], b0);
          mma_bf16_16816(s[2 * jp + 1], qf[kk], b1);
        }

      // the online softmax, per row; s becomes p
      const int base = lo + t * kMmaBK;
      const bool plain = !kMasked && base + kMmaBK <= hi &&
                         (!causal || base + kMmaBK - 1 <= q0 + warp * 16);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = kNegInf, m_new, sum = 0.f;
        if (plain) {  // every key of the tile is allowed for every row of the warp
#pragma unroll
          for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
          m_new = fmaxf(m[hh], mx * scale2);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = fast_exp2(fmaf(s[j][2 * hh + e], scale2, -m_new));
              sum += p;
              s[j][2 * hh + e] = p;
            }
        } else {  // masks and ALiBi per element, from its (row, key)
          const int* km = km_s + slot * kMmaBK;
          uint32_t ok_bits = 0;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * j + 2 * t4 + e, ki = base + col;
              bool ok = ki < hi;
              if (causal) ok = ok && ki <= qi[hh];
              if (media_mode == 1) ok = ok && qm[hh] == km[col];
              if (media_mode == 2) ok = ok && km[col] <= qm[hh] && km[col] > 0;
              float sv = s[j][2 * hh + e] * scale2;
              if (alibi) sv += slope2 * (float)(ki - qi[hh]);
              sv = ok ? sv : kNegInf;
              s[j][2 * hh + e] = sv;
              ok_bits |= (uint32_t)ok << (2 * j + e);
              mx = fmaxf(mx, sv);
            }
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
          m_new = fmaxf(m[hh], mx);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              // p is 0 where the mask says so, before the exp chooses anything
              const float p = (ok_bits >> (2 * j + e)) & 1u
                                  ? fast_exp2(s[j][2 * hh + e] - m_new) : 0.f;
              sum += p;
              s[j][2 * hh + e] = p;
            }
        }
        const float alpha = fast_exp2(m[hh] - m_new);
        l[hh] = l[hh] * alpha + sum;
        m[hh] = m_new;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          o[j][2 * hh] *= alpha;
          o[j][2 * hh + 1] *= alpha;
        }
      }

      // O += P V: P's C fragments (rounded to bf16) are the A fragments of
      // key steps of 16
#pragma unroll
      for (int kk = 0; kk < kMmaBK / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          // matrices: keys 16kk + 0..7 and + 8..15 at d 16dp, then d + 8
          uint32_t r[4];
          const int key = 16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3);
          ldmatrix_x4_trans(r, smem_addr(vs + key * LD + 16 * dp + 8 * (lane >> 4)));
          const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
          mma_bf16_16816(o[2 * dp], a, b0);
          mma_bf16_16816(o[2 * dp + 1], a, b1);
        }
      }
    }
    __syncthreads();  // slot consumed: the next iteration loads into it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = l[hh];
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    if (qi[hh] >= Sq) continue;
    const float denom = sum > 0.f ? sum : 1.f;
    __nv_bfloat16* dst = out + (((size_t)b * Sq + qi[hh]) * H + h) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(o[j][2 * hh] / denom, o[j][2 * hh + 1] / denom);
    if (t4 == 0)
      lse[((size_t)b * H + h) * Sq + qi[hh]] =
          sum > 0.f ? m[hh] * 0.6931471805599453f + logf(sum) : kNegInf;
  }
}

template <int D, bool kMasked>
int launch_mma_as(const void* q, const void* k, const void* v, void* out, float* lse,
                  const int* kv_start, const int* kv_len, const float* alibi,
                  const int* q_media, const int* kv_media, int B, int Sq, int Skv, int H,
                  int Hkv, int causal, int media_mode, float scale, cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<D, kMasked>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  dim3 grid((Sq + kMmaBQ - 1) / kMmaBQ, H, B);
  using bf16 = __nv_bfloat16;
  flash_fwd_mma_kernel<D, kMasked><<<grid, kMmaWarps * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, kv_start, kv_len, alibi, q_media, kv_media, Sq, Skv, H,
      Hkv, causal, media_mode, scale);
  return 0;
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out, float* lse,
               const int* kv_start, const int* kv_len, const float* alibi,
               const int* q_media, const int* kv_media, int B, int Sq, int Skv, int H,
               int Hkv, int causal, int media_mode, float scale, cudaStream_t stream) {
  auto fn = (media_mode || alibi) ? launch_mma_as<D, true> : launch_mma_as<D, false>;
  return fn(q, k, v, out, lse, kv_start, kv_len, alibi, q_media, kv_media, B, Sq, Skv, H, Hkv,
            causal, media_mode, scale, stream);
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
    int err = 0;
    UNIMP_DISPATCH_D(d, err = launch_mma<D>(q, k, v, out, lse, kv_start, kv_len, alibi,
                                            q_media, kv_media, B, Sq, Skv, H, Hkv, causal,
                                            media_mode, scale, s))
    if (err != 0) return err;
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
