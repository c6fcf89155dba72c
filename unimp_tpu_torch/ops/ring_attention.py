"""Ring attention: causal self-attention with the sequence split over ranks.

Counterpart of ``unimp_tpu/ops/ring_attention.py`` (``ring_attention``
under ``shard_map``, ``ring_attention_sharded``). Rank i of the ring's
group holds the sequence block [i*S/n, (i+1)*S/n) of q, k and v; the K/V
blocks travel around the ring (``batch_isend_irecv`` to rank i+1, from
rank i-1) and each rank attends its q block to every K/V block with the
port's own flash attention (K1 on the card, its plain version on the
CPU), which returns each block's lse: the blocks' outputs merge by lse.
Under the causal mask the diagonal block is causal, earlier blocks are
unmasked and later blocks are skipped; ``kv_len`` (valid global prefix
per row) is shifted by each block's offset. The backward
(``RingAttentionFn``) runs the ring again with K2 / K3 on each block
against the merged lse, and the dK / dV partials travel with their block
until they are home.

``ring_attention_sharded`` takes each rank's own rows of whole sequences,
as the data-parallel loader gives them: it all-gathers the rows of the
ring's group, keeps this rank's sequence block, runs the ring, all-gathers
the blocks of the output and keeps this rank's rows (the resharding XLA
does on entry and exit of the JAX ``shard_map``); each all-gather's
gradient is a reduce-scatter.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from unimp_tpu_torch.ops.flash_attention import (attention_delta, flash_attention,
                                                 flash_backward)


def _rotate(tensors, group):
    """Send each tensor to the next rank of the group and receive the
    previous rank's: one ``batch_isend_irecv``. Gloo's point-to-point
    takes no CUDA tensors (torch 2.11 closes the connection), so under
    gloo CUDA blocks travel through host memory, as gloo's collectives
    move them."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    device = tensors[0].device
    host = device.type == "cuda" and dist.get_backend(group) == "gloo"
    send = [t.cpu() if host else t.contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in send]
    ops = []
    for t, buf in zip(send, recv):
        ops.append(dist.P2POp(dist.isend, t, nxt, group))
        ops.append(dist.P2POp(dist.irecv, buf, prv, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [t.to(device) for t in recv] if host else recv


def _block_masks(src: int, rank: int, sq: int, kv_len, scale: float) -> dict:
    """flash_attention's masks for q block ``rank`` against K/V block
    ``src`` (src <= rank)."""
    shifted = None if kv_len is None else (kv_len - src * sq).clamp(0, sq).to(torch.int32)
    return dict(causal=src == rank, kv_len=shifted, scale=scale)


def _merge(out, lse, o, l_blk):
    """Fold a block's normalized (o [B, S, H, D], lse [B, H, S]) into the
    running ones (float32)."""
    if out is None:
        return o.float(), l_blk
    m = torch.maximum(lse, l_blk)
    a, b = torch.exp(lse - m), torch.exp(l_blk - m)
    new = m + torch.log(a + b)
    wa = torch.exp(lse - new).transpose(1, 2)[..., None]
    wb = torch.exp(l_blk - new).transpose(1, 2)[..., None]
    return out * wa + o.float() * wb, new


class RingAttentionFn(torch.autograd.Function):
    """Causal ring attention over ``group`` of per-rank blocks [B, S/n, H,
    D]; ``kv_len`` [B] bounds the valid global prefix."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, group, scale):
        # the kernels take dense blocks; a block cut from whole sequences is not
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        n, r = dist.get_world_size(group), dist.get_rank(group)
        sq = q.shape[1]
        out = lse = None
        kc, vc = k, v
        for step in range(n):
            src = (r - step) % n
            if src <= r:
                o, l_blk = flash_attention(q, kc, vc, **_block_masks(src, r, sq, kv_len, scale))
                out, lse = _merge(out, lse, o, l_blk)
            if step < n - 1:
                kc, vc = _rotate([kc, vc], group)
        out = out.to(q.dtype)
        ctx.group, ctx.scale = group, scale
        ctx.save_for_backward(q, k, v, out, lse, kv_len)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse, kv_len = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        n, r = dist.get_world_size(group), dist.get_rank(group)
        sq = q.shape[1]
        do = d_out.to(q.dtype).contiguous()
        delta = attention_delta(do, out)
        dq = torch.zeros_like(q, dtype=torch.float32)
        kc, vc = k, v
        dk, dv = torch.zeros_like(k, dtype=torch.float32), torch.zeros_like(v, dtype=torch.float32)
        for step in range(n):
            src = (r - step) % n
            if src <= r:
                dq_b, dk_b, dv_b = flash_backward(q, kc, vc, do, lse, delta,
                                                  **_block_masks(src, r, sq, kv_len, scale))
                dq += dq_b.float()
                dk += dk_b.float()
                dv += dv_b.float()
            # the partials travel with their block: n hops bring them home
            if step < n - 1:
                kc, vc, dk, dv = _rotate([kc, vc, dk, dv], group)
            else:
                dk, dv = _rotate([dk, dv], group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


class _AllGatherDim(torch.autograd.Function):
    """All-gather of ``dim`` over ``group``; the gradient is reduce-scattered
    back (every rank's result may read any rank's block)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = dist.get_world_size(group)
        x = x.movedim(dim, 0).contiguous()
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        g = g.movedim(ctx.dim, 0).contiguous()
        out = torch.empty((g.shape[0] // n,) + tuple(g.shape[1:]), dtype=g.dtype,
                          device=g.device)
        dist.reduce_scatter_tensor(out, g, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


def ring_attention(q, k, v, group, *, kv_len: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention of this rank's sequence block [B, S/n, H, D] over
    the whole sequence held by ``group`` (rank i the i-th block)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return RingAttentionFn.apply(q, k, v, kv_len, group, float(scale))


def ring_attention_sharded(q, k, v, group, *, kv_len: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention of this rank's rows [B, S, H, D] (whole sequences),
    computed as ring attention over ``group``: returns this rank's rows of
    the output. The ranks of ``group`` hold the same B; their S may differ
    (each is padded to the group's longest, rounded up to a multiple of
    the group's size, behind a ``kv_len`` that keeps the padding out)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    b, s = q.shape[:2]
    s_max = torch.tensor([s], dtype=torch.int64, device=q.device)
    dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
    s_pad = -(-int(s_max.item()) // n) * n
    if kv_len is None:
        kv_len = torch.full((b,), s, dtype=torch.int32, device=q.device)
    pad = (0, 0, 0, 0, 0, s_pad - s)
    q, k, v = (F.pad(t, pad) for t in (q, k, v))
    rows = _AllGatherDim.apply(torch.stack([q, k, v]), 1, group)  # [3, n*B, S, H, D]
    lens = _AllGatherDim.apply(kv_len.to(torch.int32), 0, group)
    blk = s_pad // n
    qb, kb, vb = rows[:, :, r * blk:(r + 1) * blk].unbind(0)
    out = ring_attention(qb, kb, vb, group, kv_len=lens, scale=scale)
    out = _AllGatherDim.apply(out, 1, group)  # [n*B, S, H, D]
    return out[r * b:(r + 1) * b, :s]
