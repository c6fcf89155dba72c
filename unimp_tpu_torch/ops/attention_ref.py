"""Plain PyTorch attention: the reference for the flash-attention kernel.

Counterpart of ``unimp_tpu/ops/attention_ref.py``. ``attention_ref`` is
the plain version of the hand-written forward kernel in
``ops/flash_attention.py`` (the same function, computed by materializing
the [B, H, Sq, Skv] logits) and the path every CPU tensor takes;
``flash_bwd_dkv_ref`` and ``flash_bwd_dq_ref`` are the plain versions of
the two backward kernels.

Patterns: causal self-attention, a per-row valid KV window, bidirectional
attention (ViT / perceiver) and Flamingo media-masked cross-attention
("immediate": q_media == kv_media; "all_previous": 0 < kv_media <=
q_media). Layout is [B, S, H, D] throughout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

NEG_INF = -1e30  # large finite negative: avoids NaNs from (-inf) - (-inf)


@dataclasses.dataclass(frozen=True)
class AttnMask:
    """Declarative attention-mask spec shared by the kernel and plain paths.

    causal: lower-triangular mask over (q_pos, kv_pos).
    q_media: [B, Sq] int32 index of the most recent media at/preceding each
      query (0 = before any media). kv_media: [B, Skv] int32 1-based media
      index of each KV latent. media_mode: None | "immediate" |
      "all_previous". kv_valid: [B, Skv] bool, False masks the position.
    """

    causal: bool = False
    q_media: Optional[torch.Tensor] = None
    kv_media: Optional[torch.Tensor] = None
    media_mode: Optional[str] = None
    kv_valid: Optional[torch.Tensor] = None

    def allowed(self, b: int, sq: int, skv: int, device) -> Optional[torch.Tensor]:
        """[B, Sq, Skv] boolean 'allowed' mask, or None if unmasked."""
        allowed = None

        def _and(a, m):
            return m if a is None else a & m

        if self.causal:
            qi = torch.arange(sq, device=device)[:, None]
            ki = torch.arange(skv, device=device)[None, :]
            allowed = _and(allowed, (ki <= qi)[None])
        if self.media_mode is not None:
            qm = self.q_media[:, :, None]
            km = self.kv_media[:, None, :]
            if self.media_mode == "immediate":
                allowed = _and(allowed, qm == km)
            elif self.media_mode == "all_previous":
                allowed = _and(allowed, (km <= qm) & (km > 0))
            else:
                raise ValueError(f"unknown media_mode: {self.media_mode}")
        if self.kv_valid is not None:
            allowed = _and(allowed, self.kv_valid[:, None, :])
        if allowed is None:
            return None
        return allowed.expand(b, sq, skv)


def alibi_slopes(num_heads: int) -> torch.Tensor:
    """Standard ALiBi slopes: geometric sequence 2^(-8i/n)."""

    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start**i) for i in range(n)]

    n = num_heads
    if math.log2(n).is_integer():
        vals = pow2_slopes(n)
    else:
        closest = 2 ** math.floor(math.log2(n))
        vals = pow2_slopes(closest) + pow2_slopes(2 * closest)[0::2][: n - closest]
    return torch.tensor(vals, dtype=torch.float32)


def window_mask(mask: Optional[AttnMask], b: int, skv: int, device,
                kv_len=None, kv_start=None) -> AttnMask:
    """Fold a [kv_start, kv_len) window into ``mask.kv_valid``."""
    mask = mask or AttnMask()
    if kv_len is None and kv_start is None:
        return mask
    pos = torch.arange(skv, device=device)[None, :]
    valid = torch.ones(b, skv, dtype=torch.bool, device=device)
    if kv_len is not None:
        valid = valid & (pos < kv_len[:, None])
    if kv_start is not None:
        valid = valid & (pos >= kv_start[:, None])
    if mask.kv_valid is not None:
        valid = valid & mask.kv_valid
    return dataclasses.replace(mask, kv_valid=valid)


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[AttnMask] = None,
    *,
    kv_len: Optional[torch.Tensor] = None,
    kv_start: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    alibi: Optional[torch.Tensor] = None,
):
    """Scaled-dot-product attention over [B, S, H, D] tensors.

    q [B, Sq, H, D]; k, v [B, Skv, Hkv, D] (Hkv divides H). Returns
    (out [B, Sq, H, D] in q.dtype, lse [B, H, Sq] f32). A fully masked
    row gives out 0 and lse NEG_INF, as the kernel does.
    """
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if hkv != h:
        if h % hkv:
            raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    if scale is None:
        scale = 1.0 / (d**0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if alibi is not None:
        rel = (torch.arange(skv, device=q.device)[None, :]
               - torch.arange(sq, device=q.device)[:, None]).float()
        logits = logits + alibi.float()[None, :, None, None] * rel
    allowed = window_mask(mask, b, skv, q.device, kv_len, kv_start).allowed(
        b, sq, skv, q.device)
    if allowed is not None:
        logits = torch.where(allowed[:, None], logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    if allowed is not None:
        p = torch.where(allowed[:, None], p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    has = l > 0
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = out / torch.where(has, l, 1.0).permute(0, 2, 1, 3)
    lse = torch.where(has, m + torch.log(torch.where(has, l, 1.0)), NEG_INF)
    return out.to(q.dtype), lse[..., 0]


def _bwd_terms(q, k, v, do, lse, delta, mask, kv_len, kv_start, scale, alibi):
    """What both backward kernels recompute: (p, ds_rounded, k and v
    repeated to H heads), with p and ds [B, H, Sq, Skv] in f32.

    p = exp(s - lse) on allowed pairs and 0 elsewhere: the mask picks 0
    before the exp, since a fully masked row has lse = NEG_INF and
    s - lse would overflow to inf (and inf * 0 to NaN). ds = p * (dp -
    delta) * scale, rounded to q's dtype as the kernels round it.
    """
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if hkv != h:
        if h % hkv:
            raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    if scale is None:
        scale = 1.0 / (d**0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if alibi is not None:
        rel = (torch.arange(skv, device=q.device)[None, :]
               - torch.arange(sq, device=q.device)[:, None]).float()
        s = s + alibi.float()[None, :, None, None] * rel
    z = s - lse.float()[..., None]
    allowed = window_mask(mask, b, skv, q.device, kv_len, kv_start).allowed(
        b, sq, skv, q.device)
    if allowed is not None:
        z = torch.where(allowed[:, None], z, -math.inf)
    p = torch.exp(z)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta.float()[..., None]) * scale
    return p, ds.to(q.dtype).float(), k, v


def _group_sum(g, hkv):
    """[B, S, H, D] -> [B, S, Hkv, D]: sum over the H / Hkv query heads of
    each KV head (what differentiating the GQA repeat gives)."""
    b, s, h, d = g.shape
    return g if h == hkv else g.reshape(b, s, hkv, h // hkv, d).sum(3)


def flash_bwd_dkv_ref(
    q, k, v, do, lse, delta, mask: Optional[AttnMask] = None, *,
    kv_len=None, kv_start=None, scale: Optional[float] = None, alibi=None,
):
    """Plain version of the dK/dV backward kernel (K2).

    q, do [B, Sq, H, D]; k, v [B, Skv, Hkv, D]; lse (the forward's) and
    delta = rowsum(dO * O), both [B, H, Sq] f32; masks as ``attention_ref``.
    dV = p^T dO with p rounded to dO's dtype; dK = ds^T Q. Returns
    (dk, dv) in k's / v's dtype, summed over each KV head's query heads.
    """
    hkv = k.shape[2]
    p, ds, _, _ = _bwd_terms(q, k, v, do, lse, delta, mask, kv_len, kv_start, scale, alibi)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return _group_sum(dk, hkv).to(k.dtype), _group_sum(dv, hkv).to(v.dtype)


def flash_bwd_dq_ref(
    q, k, v, do, lse, delta, mask: Optional[AttnMask] = None, *,
    kv_len=None, kv_start=None, scale: Optional[float] = None, alibi=None,
):
    """Plain version of the dQ backward kernel (K3): dQ = ds K, in q's
    dtype. Arguments as ``flash_bwd_dkv_ref``."""
    _, ds, k_rep, _ = _bwd_terms(q, k, v, do, lse, delta, mask, kv_len, kv_start, scale, alibi)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k_rep.float()).to(q.dtype)
