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
// absolute query position T + step - 1. step is read from device memory
// (n_gen), so the launch's arguments do not change from step to step.
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
// streams of K/V bytes (a few FLOPs per byte: 4 D flops per key and beam
// against 2 D bytes of K and V per key, shared by the K beams), so the
// bound is the valid cache bytes over 3.35 TB/s; int8 halves those bytes
// against bf16 and adds 4 bytes of scales per position and head.
//
// The design, bf16 and int8 KV (mma.sync). One block of 4 warps per (batch
// row, query head); the row's beams, 16 at a time, are the M rows of
// m16n8k16 tiles (10 of 16 at the main shape, 1 for greedy), their Q A
// fragments loaded once and kept in registers. K/V tiles of 64 keys come
// through a double-buffered cp.async ring (rows padded by 16 bytes so
// ldmatrix reads them without bank conflicts; rows not loaded are
// zero-filled by a 0-byte source, so no 0 * garbage reaches a sum), each
// warp taking 16 keys of a tile with its own online softmax (m, l, O) for
// the 16 rows: S = Q K^T by ldmatrix B fragments of K, the masks per
// element from (beam, key), p rounded to bf16 and repacked from the C
// fragments straight into the A fragments of P V (V by ldmatrix.trans).
// So every beam-shared row crosses HBM once per block and all the beams
// score it at once. At the end the 4 warps merge their states through
// shared memory in a fixed order: no atomics, the same bits every run.
//   * decode_attn: the prompt tiles walk [kv_start, prompt_len). For the
//     gen positions g < step (64 at a time), the block first reads the
//     group's beam_sel and lists each (ancestor, position) row that some
//     beam references once, with the mask of the beams that read it (a
//     __match_any_sync over a position's 16 beam slots, then a prefix sum
//     over the block): the gen tiles walk that list, 64 referenced rows a
//     tile, and beam k scores a row iff its bit is set. So every
//     referenced row is read once and the tiles are full: at step 50 a
//     block walks 2 prompt tiles and about 6 gen tiles (random beam_sel),
//     fewer when the beams share history. (The Pallas kernel scores every
//     ancestor row of a gen chunk under a one-hot mask; VMEM holds them
//     all, and its matrix unit has the flops to spare.)
//   * single_query_attn: 64-latent tiles; each tile's allowed bits are
//     staged first and a tile with no allowed latent is never loaded
//     ("immediate" at the main shape keeps one tile in four).
//   * int8: the ring holds the raw int8 tiles and their f32 scales
//     (4-byte cp.async); each warp widens its own 16 K and V rows to bf16
//     (exact: |q| <= 127) into a private buffer, so the products are the
//     bf16 branch's. The K scale multiplies the logit, the V scale p
//     before its bf16 rounding; l takes the raw p.
//
// float32 stays on the CUDA cores (tensor cores would round its inputs to
// TF32): one block per (batch row, head), one warp per beam, one lane per
// key; the loops run over the valid range only, the ancestor row read
// directly. The softmax state stays in registers and nothing but the
// [BK, H, D] output is written.

#include <type_traits>

#include "common.cuh"

namespace {

using namespace unimp;

// ---------------------------------------------------------------- float32 q: CUDA cores

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
// row; w_j = p_j * vs_j.
template <typename TKV, int D, int DPL>
__device__ __forceinline__ void accumulate_pv(float p, float vs, size_t row_off,
                                              const TKV* __restrict__ v, float (&acc)[DPL],
                                              int lane) {
  const float pr = p * vs;
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

template <int D, int DPL>
__device__ __forceinline__ void write_out(float* __restrict__ out, size_t off, float l,
                                          const float (&acc)[DPL], int lane) {
  const float denom = l > 0.f ? l : 1.f;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) out[off + d] = acc[i] / denom;
  }
}

// Per-position K/V scales of an int8 cache; float caches carry none.
struct Scales {
  const float* k;
  const float* v;
};

// TKV: float, or int8_t with scales
template <typename TKV, int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
decode_attn_kernel(const float* __restrict__ q, const TKV* __restrict__ pk,
                   const TKV* __restrict__ pv, const TKV* __restrict__ gk,
                   const TKV* __restrict__ gv, Scales ps, Scales gs,
                   const int* __restrict__ beam_sel, const int* __restrict__ kv_start,
                   const int* __restrict__ prompt_len, const float* __restrict__ alibi,
                   float* __restrict__ out, int K, int H, int Hkv, int Tp, int G,
                   const int* __restrict__ n_gen, float scale) {
  constexpr int DPL = (D + 31) / 32;
  const int step = *n_gen;
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
      accumulate_pv<TKV, D>(p, vs, pidx * D, pv, acc, lane);
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
      accumulate_pv<TKV, D>(p, vs, gidx * D, gv, acc, lane);
    }
    write_out<D>(out, ((size_t)bk * H + h) * D, l, acc, lane);
  }
}

template <typename TKV, int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
single_query_kernel(const float* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, Scales sc, const uint8_t* __restrict__ allowed,
                    float* __restrict__ out, int K, int H, int Hkv, int S, float scale) {
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
      accumulate_pv<TKV, D>(p, vs, idx * D, v, acc, lane);
    }
    write_out<D>(out, ((size_t)bk * H + h) * D, l, acc, lane);
  }
}

// ---------------------------------------------------------------- bf16 q: mma.sync

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kBM = 16;       // beams a group: the M rows of an m16n8k16 tile
constexpr int kTile = 64;     // keys a ring stage, 16 a warp
constexpr int kSqTiles = 64;  // single_query_attn: tiles whose allowed bits one pass stages
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr int kLD = D + 8;  // bf16 smem row stride: 16 bytes of padding

// Dynamic shared memory, byte offsets: Q [16][LD] bf16 at 0; the ring [2 stages]
// [K, V][64 keys] of bf16 rows (LD) or int8 rows (D); int8 only: the
// widened rows [4 warps][K, V][16][LD] bf16 and the scales [2][K, V][64]
// f32; the warps' (m, l) [4][16] for the merge (their [4][16][D] f32
// outputs go over the ring); then each kernel's own arrays.
template <int D, bool kInt8>
struct Layout {
  static constexpr int ring = kBM * kLD<D> * 2;
  static constexpr int row = kInt8 ? D : kLD<D> * 2;  // bytes of a ring row
  static constexpr int wide = ring + 2 * 2 * kTile * row;
  static constexpr int scales = wide + (kInt8 ? kMmaWarps * 2 * 16 * kLD<D> * 2 : 0);
  static constexpr int ml = scales + (kInt8 ? 2 * 2 * kTile * 4 : 0);
  static constexpr int extra = ml + kMmaWarps * kBM * 8;
  static_assert(2 * 2 * kTile * row >= kMmaWarps * kBM * D * 4, "the merge fits in the ring");
};

template <int D>
struct WarpAcc {
  float o[D / 8][4];  // C fragments of O: rows g and g + 8, dims 8n + 2t4 + {0, 1}
  float m[2];         // running max of rows g and g + 8 (log2 domain)
  float l[2];         // this lane's share of their sums
};

// Copy one tile's K and V rows into ring stage ``slot``: row j (0..63) from
// element offset off(j) of k / v, or zeros where off(j) < 0.
template <int D, bool kInt8, typename TKV, typename Off>
__device__ __forceinline__ void stage_kv(char* smem, int slot, const TKV* k, const TKV* v,
                                         Off off) {
  using L = Layout<D, kInt8>;
  constexpr int CH = D * (int)sizeof(TKV) / 16;  // 16-byte chunks a row
  constexpr int EPC = 16 / (int)sizeof(TKV);     // elements a chunk
  for (int i = threadIdx.x; i < kTile * CH; i += kMmaThreads) {
    const int j = i / CH, c = i % CH;
    const long long o = off(j);
    const bool in = o >= 0;
    char* dk = smem + L::ring + ((slot * 2) * kTile + j) * L::row + 16 * c;
    cp_async_16(smem_addr(dk), in ? k + o + EPC * c : k, in ? 16 : 0);
    cp_async_16(smem_addr(dk + kTile * L::row), in ? v + o + EPC * c : v, in ? 16 : 0);
  }
}

// The f32 K and V scales of one int8 tile: position j's at offset off(j)
// (zeros where off(j) < 0); threads 0-63 the K scales, 64-127 the V scales.
template <int D, typename Off>
__device__ __forceinline__ void stage_scales(char* smem, int slot, Scales sc, Off off) {
  using L = Layout<D, true>;
  const int j = threadIdx.x & (kTile - 1), kv = threadIdx.x / kTile;
  const long long o = off(j);
  const float* src = kv ? sc.v : sc.k;
  cp_async_4(smem_addr(smem + L::scales + ((slot * 2 + kv) * kTile + j) * 4),
             o >= 0 ? src + o : src, o >= 0 ? 4 : 0);
}

// int8 bytes j0 and j0 + 1 of w (already xor 0x80: u = q + 128) -> bf16x2,
// as K6 widens: 2^23 + u as a float, minus 2^23 + 128, is exact, and a
// small integer's bf16 is its float's upper half (byte permutes and adds
// only: no conversion instructions, which run at a sixteenth of the rate)
__device__ __forceinline__ uint32_t widen2(uint32_t u, int j0) {
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j0)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541 + j0)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// int8: warp ``warp``'s 16 K and V rows of ring stage ``slot``, widened to
// bf16 into the warp's own buffer; returns its first K row (V 16 rows on).
template <int D>
__device__ __forceinline__ const bf16* widen_rows(char* smem, int slot, int warp, int lane) {
  using L = Layout<D, true>;
  constexpr int CH = D / 16;
  bf16* wide = reinterpret_cast<bf16*>(smem + L::wide) + warp * 2 * 16 * kLD<D>;
  for (int i = lane; i < 2 * 16 * CH; i += 32) {
    const int kv = i / (16 * CH), r = (i / CH) % 16, c = i % CH;
    uint4 w = *reinterpret_cast<const uint4*>(
        smem + L::ring + ((slot * 2 + kv) * kTile + 16 * warp + r) * D + 16 * c);
    w.x ^= 0x80808080u;
    w.y ^= 0x80808080u;
    w.z ^= 0x80808080u;
    w.w ^= 0x80808080u;
    uint4* dst = reinterpret_cast<uint4*>(wide + (kv * 16 + r) * kLD<D> + 16 * c);
    dst[0] = make_uint4(widen2(w.x, 0), widen2(w.x, 2), widen2(w.y, 0), widen2(w.y, 2));
    dst[1] = make_uint4(widen2(w.z, 0), widen2(w.z, 2), widen2(w.w, 0), widen2(w.w, 2));
  }
  __syncwarp();
  return wide;
}

template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[D / 16][4], const char* smem,
                                             int lane) {
  const bf16* q_s = reinterpret_cast<const bf16*>(smem);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], smem_addr(q_s + (lane & 15) * kLD<D> + 16 * kk + 8 * (lane >> 4)));
}

// Q rows of beams b*K + k0 .. + kg - 1 (rows past kg zero) into smem
template <int D>
__device__ __forceinline__ void stage_q(char* smem, const bf16* q, int b, int K, int k0, int kg,
                                        int H, int h) {
  constexpr int CH = D / 8;
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  for (int i = threadIdx.x; i < kBM * CH; i += kMmaThreads) {
    const int r = i / CH, c = i % CH;
    const bool in = r < kg;
    cp_async_16(smem_addr(q_s + r * kLD<D> + 8 * c),
                in ? q + (((size_t)b * K + k0 + r) * H + h) * D + 8 * c : q, in ? 16 : 0);
  }
}

template <int D>
__device__ __forceinline__ void init_acc(WarpAcc<D>& acc) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc.o[n][e] = 0.f;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    acc.m[hh] = kNegInf;
    acc.l[hh] = 0.f;
  }
}

// One warp's 16 keys of a tile, ks / vs its first K / V row (bf16, stride
// LD): S = Q K^T, the online softmax, O += P V. cols(c, kmul, bias, vmul)
// gives key c's (0..15) logit factor (scale * log2 e, times the K scale),
// ALiBi bias (log2 domain) and p factor (the V scale); ok(r, c) whether
// beam row r (0..15) sees key c. p is 0 where ok is false, chosen before
// the exp; l takes the unscaled p; p * vmul rounds to bf16 for P V.
template <int D, typename Cols, typename Ok>
__device__ __forceinline__ void warp_tile(const bf16* ks, const bf16* vs,
                                          const uint32_t (&qf)[D / 16][4], WarpAcc<D>& acc,
                                          int lane, Cols cols, Ok ok) {
  constexpr int LD = kLD<D>;
  const int g = lane >> 2, t4 = lane & 3;
  float s[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // matrices: keys 0..7 at d 16kk and 16kk + 8, then keys 8..15
    uint32_t r[4];
    ldmatrix_x4(r, smem_addr(ks + ((lane & 7) + ((lane >> 4) << 3)) * LD + 16 * kk +
                             8 * ((lane >> 3) & 1)));
    const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
    mma_bf16_16816(s[0], qf[kk], b0);
    mma_bf16_16816(s[1], qf[kk], b1);
  }
  // this lane's keys: c = 8 (i >> 1) + 2 t4 + (i & 1), element s[i >> 1][2hh + (i & 1)]
  float kmul[4], bias[4], vmul[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) cols(8 * (i >> 1) + 2 * t4 + (i & 1), kmul[i], bias[i], vmul[i]);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = g + 8 * hh;
    float mx = kNegInf;
    uint32_t ok_bits = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool a = ok(row, 8 * (i >> 1) + 2 * t4 + (i & 1));
      float& x = s[i >> 1][2 * hh + (i & 1)];
      x = a ? fmaf(x, kmul[i], bias[i]) : kNegInf;
      ok_bits |= (uint32_t)a << i;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(acc.m[hh], mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float& x = s[i >> 1][2 * hh + (i & 1)];
      const float p = (ok_bits >> i) & 1u ? fast_exp2(x - m_new) : 0.f;
      sum += p;
      x = p * vmul[i];
    }
    const float alpha = fast_exp2(acc.m[hh] - m_new);
    acc.l[hh] = acc.l[hh] * alpha + sum;
    acc.m[hh] = m_new;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc.o[n][2 * hh] *= alpha;
      acc.o[n][2 * hh + 1] *= alpha;
    }
  }
  // O += P V: P's C fragments, rounded to bf16, are the A fragment of one k16 step
  const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                         pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    // matrices: keys 0..7 and 8..15 at d 16dp, then at d 16dp + 8
    uint32_t r[4];
    ldmatrix_x4_trans(r, smem_addr(vs + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
                                   16 * dp + 8 * (lane >> 4)));
    const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
    mma_bf16_16816(acc.o[2 * dp], a, b0);
    mma_bf16_16816(acc.o[2 * dp + 1], a, b1);
  }
}

// The warp's K / V rows of ring stage ``slot`` as bf16 (int8: widened first)
template <int D, bool kInt8>
__device__ __forceinline__ const bf16* warp_rows(char* smem, int slot, int warp, int lane) {
  using L = Layout<D, kInt8>;
  if constexpr (kInt8) return widen_rows<D>(smem, slot, warp, lane);
  return reinterpret_cast<const bf16*>(smem + L::ring) + (slot * 2 * kTile + 16 * warp) * kLD<D>;
}

// Merge the 4 warps' states in warp order and write the group's first
// ``rows`` beam rows: row r to out + out_off(r).
template <int D, bool kInt8, typename OutOff>
__device__ __forceinline__ void merge_store(char* smem, const WarpAcc<D>& acc, int warp,
                                            int lane, int rows, bf16* out, OutOff out_off) {
  using L = Layout<D, kInt8>;
  const int g = lane >> 2, t4 = lane & 3;
  float* ob = reinterpret_cast<float*>(smem + L::ring);  // [4][16][D]
  float2* ml = reinterpret_cast<float2*>(smem + L::ml);  // [4][16]
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * kBM + g + 8 * hh;
    float l = acc.l[hh];
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    if (t4 == 0) ml[r] = make_float2(acc.m[hh], l);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(ob + r * D + 8 * n + 2 * t4) =
          make_float2(acc.o[n][2 * hh], acc.o[n][2 * hh + 1]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * D; i += kMmaThreads) {
    const int r = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) mx = fmaxf(mx, ml[w * kBM + r].x);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      const float2 wl = ml[w * kBM + r];
      const float a = fast_exp2(wl.x - mx);
      l += wl.y * a;
      o += ob[(w * kBM + r) * D + d] * a;
    }
    out[out_off(r) + d] = __float2bfloat16(o / (l > 0.f ? l : 1.f));
  }
  __syncthreads();  // the ring and the states are free for the next beam group
}

constexpr int kGenPos = 64;               // gen positions a pass lists
constexpr int kGenSlots = kGenPos * kBM;  // (position, beam) slots of a pass

template <int D, bool kInt8>
constexpr int decode_smem_bytes() {
  // the pass's list (ancestor; position and beams) and its [8][4] counts
  return Layout<D, kInt8>::extra + 2 * kGenSlots * 4 + 8 * kMmaWarps * 4;
}

// grid (H, B). Tiles 0 .. n_p - 1 walk the prompt window [lo, hi), 64
// positions each. The gen positions g < step go in passes of 64: a pass
// lists the (ancestor, position) rows that its beams reference, each once,
// with the mask of the beams that read it, and its tiles walk that list.
template <int D, bool kInt8>
__global__ void __launch_bounds__(kMmaThreads)
decode_attn_mma_kernel(const bf16* __restrict__ q,
                       const std::conditional_t<kInt8, int8_t, bf16>* __restrict__ pk,
                       const std::conditional_t<kInt8, int8_t, bf16>* __restrict__ pv,
                       const std::conditional_t<kInt8, int8_t, bf16>* __restrict__ gk,
                       const std::conditional_t<kInt8, int8_t, bf16>* __restrict__ gv,
                       Scales ps, Scales gs, const int* __restrict__ beam_sel,
                       const int* __restrict__ kv_start, const int* __restrict__ prompt_len,
                       const float* __restrict__ alibi, bf16* __restrict__ out, int K, int H,
                       int Hkv, int Tp, int G, const int* __restrict__ n_gen, float scale) {
  using L = Layout<D, kInt8>;
  const int step = *n_gen;
  extern __shared__ __align__(16) char smem[];
  int* ent_a = reinterpret_cast<int*>(smem + L::extra);  // [1024] a listed row's ancestor
  int* ent_pm = ent_a + kGenSlots;  // [1024] its position in the pass << 16 | beams reading it
  int* cnt_s = ent_pm + kGenSlots;  // [8][4] rows listed by each (sweep, warp)

  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lo = kv_start ? max(kv_start[b], 0) : 0;
  const int hi = prompt_len ? min(prompt_len[b], Tp) : Tp;
  const int g_hi = min(step, G);
  const int n_p = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;
  const int n_pass = (g_hi + kGenPos - 1) / kGenPos;
  const float scale2 = scale * kLog2e;
  const float slope2 = alibi ? alibi[h] * kLog2e : 0.f;
  const float q_abs = (float)(Tp + step - 1);
  const size_t prompt_row = ((size_t)b * Hkv + hk) * Tp;  // row of position 0

  for (int k0 = 0; k0 < K; k0 += kBM) {
    const int kg = min(kBM, K - k0);

    // List the gen rows of the pass at gc0: slot 128 sw + tid is position
    // gc0 + 8 sw + tid / 16 of beam k0 + tid % 16; the first slot of a
    // position that names an ancestor lists it, with the mask of the
    // position's beams that name it. Returns the number of rows listed.
    auto list_rows = [&](int gc0) {
      int anc[8];
#pragma unroll
      for (int sw = 0; sw < 8; ++sw) {
        const int g = gc0 + 8 * sw + (tid >> 4), s = tid & 15;
        anc[sw] = -1;
        if (g < g_hi && s < kg)
          anc[sw] = beam_sel
                        ? min(max(beam_sel[((size_t)b * K + k0 + s) * G + g], 0), K - 1)
                        : k0 + s;
      }
      unsigned lead[8], mask[8];
#pragma unroll
      for (int sw = 0; sw < 8; ++sw) {
        const unsigned same = __match_any_sync(kFull, anc[sw]) & (0xffffu << (lane & 16));
        lead[sw] = __ballot_sync(kFull, anc[sw] >= 0 && __ffs(same) - 1 == lane);
        mask[sw] = same >> (lane & 16);
        if (lane == 0) cnt_s[sw * kMmaWarps + warp] = __popc(lead[sw]);
      }
      __syncthreads();
      int listed = 0;  // rows listed before sweep sw (in sweep, then warp, then lane order)
#pragma unroll
      for (int sw = 0; sw < 8; ++sw) {
        int before = 0, all = 0;
#pragma unroll
        for (int w = 0; w < kMmaWarps; ++w) {
          const int c = cnt_s[sw * kMmaWarps + w];
          before += w < warp ? c : 0;
          all += c;
        }
        if ((lead[sw] >> lane) & 1u) {
          const int e = listed + before + __popc(lead[sw] & ((1u << lane) - 1u));
          ent_a[e] = anc[sw];
          ent_pm[e] = ((8 * sw + (tid >> 4)) << 16) | (int)mask[sw];
        }
        listed += all;
      }
      __syncthreads();  // the list is complete
      return listed;
    };

    uint32_t qf[D / 16][4];
    WarpAcc<D> acc;
    init_acc<D>(acc);
    // Walk the prompt tiles (n_prompt of them), then the tiles of the gen
    // pass at gc0 (n_keys listed rows), through the ring.
    auto walk = [&](int n_prompt, int n_keys, int gc0) {
      auto stage_tile = [&](int t) {  // K/V (and int8 scales) of tile t into stage t & 1
        if (t < n_prompt) {
          const int base = lo + t * kTile;
          auto row = [&](int j) -> long long {
            return base + j < hi ? (long long)(prompt_row + base + j) : -1;
          };
          stage_kv<D, kInt8>(smem, t & 1, pk, pv,
                             [&](int j) { const long long r = row(j); return r >= 0 ? r * D : r; });
          if constexpr (kInt8) stage_scales<D>(smem, t & 1, ps, row);
        } else {
          const int e0 = (t - n_prompt) * kTile;
          auto row = [&](int j) -> long long {
            const int e = e0 + j;
            return e < n_keys ? (long long)((((size_t)b * K + ent_a[e]) * Hkv + hk) * G + gc0 +
                                            (ent_pm[e] >> 16))
                              : -1;
          };
          stage_kv<D, kInt8>(smem, t & 1, gk, gv,
                             [&](int j) { const long long r = row(j); return r >= 0 ? r * D : r; });
          if constexpr (kInt8) stage_scales<D>(smem, t & 1, gs, row);
        }
      };
      const int n = n_prompt + (n_keys + kTile - 1) / kTile;
      if (n > 0) stage_tile(0);
      cp_async_commit();
      for (int t = 0; t < n; ++t) {
        if (t + 1 < n) stage_tile(t + 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();  // tile t landed
        const bf16* ks = warp_rows<D, kInt8>(smem, t & 1, warp, lane);
        const bf16* vs = ks + (kInt8 ? 16 : kTile) * kLD<D>;
        const float* ksc = reinterpret_cast<const float*>(smem + L::scales) +
                           (t & 1) * 2 * kTile + 16 * warp;  // int8 only
        auto scales = [&](int c, float& kmul, float& vmul) {
          kmul = scale2;
          vmul = 1.f;
          if constexpr (kInt8) {
            kmul *= ksc[c];
            vmul = ksc[kTile + c];
          }
        };
        if (t < n_prompt) {
          const int base = lo + t * kTile + 16 * warp;  // the warp's first key
          warp_tile<D>(ks, vs, qf, acc, lane,
                       [&](int c, float& kmul, float& bias, float& vmul) {
                         scales(c, kmul, vmul);
                         bias = alibi ? slope2 * ((float)(base + c) - q_abs) : 0.f;
                       },
                       [&](int, int c) { return base + c < hi; });
        } else {
          const int e0 = (t - n_prompt) * kTile + 16 * warp;  // the warp's first listed row
          warp_tile<D>(ks, vs, qf, acc, lane,
                       [&](int c, float& kmul, float& bias, float& vmul) {
                         scales(c, kmul, vmul);
                         const int pos = gc0 + (ent_pm[e0 + c] >> 16);
                         bias = alibi ? slope2 * ((float)(Tp + pos) - q_abs) : 0.f;
                       },
                       [&](int r, int c) {
                         return e0 + c < n_keys && ((ent_pm[e0 + c] >> r) & 1) != 0;
                       });
        }
        __syncthreads();  // stage t & 1 consumed: the next iteration loads into it
      }
    };

    stage_q<D>(smem, q, b, K, k0, kg, H, h);
    cp_async_commit();
    const int n_keys = n_pass > 0 ? list_rows(0) : 0;
    cp_async_wait<0>();
    __syncthreads();  // Q landed
    load_q_frags<D>(qf, smem, lane);
    walk(n_p, n_keys, 0);
    for (int pass = 1; pass < n_pass; ++pass) {
      cp_async_wait<0>();
      __syncthreads();  // the last walk is done with the list
      walk(0, list_rows(pass * kGenPos), pass * kGenPos);
    }
    merge_store<D, kInt8>(smem, acc, warp, lane, kg, out, [&](int r) {
      return (((size_t)b * K + k0 + r) * H + h) * D;
    });
  }
}

template <int D, bool kInt8>
constexpr int single_smem_bytes() {
  return Layout<D, kInt8>::extra + kSqTiles * (8 + 4) + 16;  // bits_s, list_s, n_list
}

// grid (H, B). Per pass of up to 64 tiles of 64 latents: each tile's allowed
// bits, the list of tiles with any, then the ring over that list only.
template <int D, bool kInt8>
__global__ void __launch_bounds__(kMmaThreads)
single_query_mma_kernel(const bf16* __restrict__ q,
                        const std::conditional_t<kInt8, int8_t, bf16>* __restrict__ k,
                        const std::conditional_t<kInt8, int8_t, bf16>* __restrict__ v,
                        Scales sc, const uint8_t* __restrict__ allowed, bf16* __restrict__ out,
                        int K, int H, int Hkv, int S, float scale) {
  using L = Layout<D, kInt8>;
  extern __shared__ __align__(16) char smem[];
  auto* bits_s = reinterpret_cast<unsigned long long*>(smem + L::extra);  // [64]
  int* list_s = reinterpret_cast<int*>(bits_s + kSqTiles);                 // [64]
  int* n_list_s = list_s + kSqTiles;

  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = (S + kTile - 1) / kTile;
  const size_t kv_row = ((size_t)b * Hkv + hk) * S;  // row of latent 0
  const uint8_t* mrow = allowed + (size_t)b * S;
  const float scale2 = scale * kLog2e;

  for (int k0 = 0; k0 < K; k0 += kBM) {
    const int kg = min(kBM, K - k0);
    stage_q<D>(smem, q, b, K, k0, kg, H, h);
    cp_async_commit();
    WarpAcc<D> acc;
    init_acc<D>(acc);
    for (int c0 = 0; c0 < n_tiles; c0 += kSqTiles) {
      const int nc = min(kSqTiles, n_tiles - c0);
      __syncthreads();  // the last pass is done with bits_s and list_s
      for (int i = warp; i < nc; i += kMmaWarps) {
        const int p0 = (c0 + i) * kTile + lane;
        const unsigned lo_bits = __ballot_sync(kFull, p0 < S && mrow[p0] != 0);
        const unsigned hi_bits = __ballot_sync(kFull, p0 + 32 < S && mrow[p0 + 32] != 0);
        if (lane == 0) bits_s[i] = lo_bits | (unsigned long long)hi_bits << 32;
      }
      __syncthreads();
      if (warp == 0) {
        int count = 0;
        for (int i0 = 0; i0 < nc; i0 += 32) {
          const bool any = i0 + lane < nc && bits_s[i0 + lane] != 0;
          const unsigned ballot = __ballot_sync(kFull, any);
          if (any) list_s[count + __popc(ballot & ((1u << lane) - 1u))] = i0 + lane;
          count += __popc(ballot);
        }
        if (lane == 0) *n_list_s = count;
      }
      __syncthreads();
      const int nl = *n_list_s;
      auto stage_tile = [&](int t) {
        const int base = (c0 + list_s[t]) * kTile;
        auto row = [&](int j) -> long long {
          return base + j < S ? (long long)(kv_row + base + j) : -1;
        };
        stage_kv<D, kInt8>(smem, t & 1, k, v,
                           [&](int j) { const long long r = row(j); return r >= 0 ? r * D : r; });
        if constexpr (kInt8) stage_scales<D>(smem, t & 1, sc, row);
      };
      if (nl > 0) stage_tile(0);
      cp_async_commit();
      for (int t = 0; t < nl; ++t) {
        if (t + 1 < nl) stage_tile(t + 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();  // tile t (and Q, an older group) landed
        // a block walks one to a few tiles: Q's fragments are reloaded from
        // shared memory for each rather than held across the passes (held,
        // they spilled at d128 with int8 latents)
        uint32_t qf[D / 16][4];
        load_q_frags<D>(qf, smem, lane);
        const bf16* ks = warp_rows<D, kInt8>(smem, t & 1, warp, lane);
        const bf16* vs = ks + (kInt8 ? 16 : kTile) * kLD<D>;
        const float* ksc = reinterpret_cast<const float*>(smem + L::scales) +
                           (t & 1) * 2 * kTile + 16 * warp;  // int8 only
        const uint32_t bits = (uint32_t)(bits_s[list_s[t]] >> (16 * warp)) & 0xffffu;
        warp_tile<D>(ks, vs, qf, acc, lane,
                     [&](int c, float& kmul, float& bias, float& vmul) {
                       kmul = scale2;
                       vmul = 1.f;
                       bias = 0.f;
                       if constexpr (kInt8) {
                         kmul *= ksc[c];
                         vmul = ksc[kTile + c];
                       }
                     },
                     [&](int, int c) { return ((bits >> c) & 1u) != 0; });
        __syncthreads();  // stage t & 1 consumed
      }
    }
    merge_store<D, kInt8>(smem, acc, warp, lane, kg, out, [&](int r) {
      return (((size_t)b * K + k0 + r) * H + h) * D;
    });
  }
}

// Opt the kernel into ``bytes`` of dynamic shared memory once (above 48 KB)
template <typename Kernel>
int smem_opt_in(Kernel kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  done = true;
  return 0;
}

template <int D, bool kInt8>
int launch_decode_mma(const void* q, const void* pk, const void* pv, const void* gk,
                      const void* gv, Scales ps, Scales gs, const int* beam_sel,
                      const int* kv_start, const int* prompt_len, const float* alibi, void* out,
                      int B, int K, int H, int Hkv, int Tp, int G, const int* n_gen, float scale,
                      cudaStream_t s) {
  using KV = std::conditional_t<kInt8, int8_t, bf16>;
  constexpr int bytes = decode_smem_bytes<D, kInt8>();
  static bool opted = false;
  if (const int err = smem_opt_in(decode_attn_mma_kernel<D, kInt8>, bytes, opted)) return err;
  decode_attn_mma_kernel<D, kInt8><<<dim3(H, B), kMmaThreads, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const KV*>(pk), static_cast<const KV*>(pv),
      static_cast<const KV*>(gk), static_cast<const KV*>(gv), ps, gs, beam_sel, kv_start,
      prompt_len, alibi, static_cast<bf16*>(out), K, H, Hkv, Tp, G, n_gen, scale);
  return 0;
}

template <int D, bool kInt8>
int launch_single_mma(const void* q, const void* k, const void* v, Scales sc,
                      const uint8_t* allowed, void* out, int B, int K, int H, int Hkv, int S,
                      float scale, cudaStream_t s) {
  using KV = std::conditional_t<kInt8, int8_t, bf16>;
  constexpr int bytes = single_smem_bytes<D, kInt8>();
  static bool opted = false;
  if (const int err = smem_opt_in(single_query_mma_kernel<D, kInt8>, bytes, opted)) return err;
  single_query_mma_kernel<D, kInt8><<<dim3(H, B), kMmaThreads, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v), sc,
      allowed, static_cast<bf16*>(out), K, H, Hkv, S, scale);
  return 0;
}

inline int warps_for(int K) { return K < kMaxWarps ? K : kMaxWarps; }

template <typename TKV, int D>
void launch_decode(const void* q, const void* pk, const void* pv, const void* gk,
                   const void* gv, Scales ps, Scales gs, const int* beam_sel,
                   const int* kv_start, const int* prompt_len, const float* alibi, void* out,
                   int B, int K, int H, int Hkv, int Tp, int G, const int* n_gen, float scale,
                   cudaStream_t s) {
  decode_attn_kernel<TKV, D><<<dim3(H, B), 32 * warps_for(K), 0, s>>>(
      static_cast<const float*>(q), static_cast<const TKV*>(pk), static_cast<const TKV*>(pv),
      static_cast<const TKV*>(gk), static_cast<const TKV*>(gv), ps, gs, beam_sel, kv_start,
      prompt_len, alibi, static_cast<float*>(out), K, H, Hkv, Tp, G, n_gen, scale);
}

template <typename TKV, int D>
void launch_single(const void* q, const void* k, const void* v, Scales sc,
                   const uint8_t* allowed, void* out, int B, int K, int H, int Hkv, int S,
                   float scale, cudaStream_t s) {
  single_query_kernel<TKV, D><<<dim3(H, B), 32 * warps_for(K), 0, s>>>(
      static_cast<const float*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), sc,
      allowed, static_cast<float*>(out), K, H, Hkv, S, scale);
}

// TKV is q's dtype (float KV) or int8_t (int8 KV with scales)
template <bool kInt8>
int decode_dispatch(int dtype, int d, const void* q, const void* pk, const void* pv,
                    const void* gk, const void* gv, Scales ps, Scales gs, const int* beam_sel,
                    const int* kv_start, const int* prompt_len, const float* alibi, void* out,
                    int B, int K, int H, int Hkv, int T, int G, const int* n_gen, float scale,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using KV = std::conditional_t<kInt8, int8_t, float>;
    UNIMP_DISPATCH_D(d, (launch_decode<KV, D>(q, pk, pv, gk, gv, ps, gs, beam_sel, kv_start,
                                              prompt_len, alibi, out, B, K, H, Hkv, T, G, n_gen,
                                              scale, s)))
  } else if (dtype == 1) {
    int err = 0;
    UNIMP_DISPATCH_D(d, err = (launch_decode_mma<D, kInt8>(q, pk, pv, gk, gv, ps, gs, beam_sel,
                                                           kv_start, prompt_len, alibi, out, B,
                                                           K, H, Hkv, T, G, n_gen, scale, s)))
    if (err != 0) return err;
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
    UNIMP_DISPATCH_D(d, (launch_single<KV, D>(q, k, v, sc, mask, out, B, K, H, Hkv, S, scale,
                                              s)))
  } else if (dtype == 1) {
    int err = 0;
    UNIMP_DISPATCH_D(d, err = (launch_single_mma<D, kInt8>(q, k, v, sc, mask, out, B, K, H, Hkv,
                                                           S, scale, s)))
    if (err != 0) return err;
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (of q and out): 0 = float32, 1 = bfloat16. n_gen points to one
// int in device memory: the generated tokens including the current one
// (the "step" of the kernels), read by each block, so that a launch
// captured into a CUDA graph serves every decode step. Null beam_sel: each beam
// reads its own gen row; null kv_start / prompt_len / alibi switch those
// off. Returns cudaGetLastError() after the launch, or -1 for an
// unsupported dtype or head dim.
extern "C" int decode_attn(int dtype, int d, const void* q, const void* pk,
                           const void* pv, const void* gk, const void* gv,
                           const int* beam_sel, const int* kv_start,
                           const int* prompt_len, const float* alibi, void* out,
                           int B, int K, int H, int Hkv, int T, int G, const int* n_gen,
                           float scale, void* stream) {
  return decode_dispatch<false>(dtype, d, q, pk, pv, gk, gv, Scales{}, Scales{}, beam_sel,
                                kv_start, prompt_len, alibi, out, B, K, H, Hkv, T, G, n_gen,
                                scale, stream);
}

// The same over int8 caches: pks / pvs [B, Hkv, T] and gks / gvs
// [B*K, Hkv, G] f32 scales, all four required.
extern "C" int decode_attn_int8(int dtype, int d, const void* q, const void* pk,
                                const void* pv, const void* gk, const void* gv,
                                const float* pks, const float* pvs, const float* gks,
                                const float* gvs, const int* beam_sel, const int* kv_start,
                                const int* prompt_len, const float* alibi, void* out,
                                int B, int K, int H, int Hkv, int T, int G, const int* n_gen,
                                float scale, void* stream) {
  if (!pks || !pvs || !gks || !gvs) return -1;
  return decode_dispatch<true>(dtype, d, q, pk, pv, gk, gv, Scales{pks, pvs},
                               Scales{gks, gvs}, beam_sel, kv_start, prompt_len, alibi, out, B,
                               K, H, Hkv, T, G, n_gen, scale, stream);
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
