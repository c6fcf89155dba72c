"""flash_roofline.train: the least time of the window's flash attention,
forward and backward, over the device time of K1 / K2 / K3, in %.

Kernels (``unimp_tpu_torch/ops/flash_attention.py``: K1 ``flash_fwd``, K2
``flash_bwd_dkv``, K3 ``flash_bwd_dq``, ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu``): every device operation whose name contains one of
``KERNELS``.

Work (``yardstick.flash_work``, from the cell's shapes and each
micro-batch's masks): per micro-batch, the tower's self-attention forward
where the step runs the tower (no mask), the perceiver's latents over
[patches; latents] forward and backward (no mask), each cross-attention
layer's text over the media latents forward and backward (each query
after a medium sees that medium's latents), and each LM layer's causal
self-attention with the keys at or past the row's length masked, forward
and backward. Recomputation (``remat``) is not counted.
"""

import torch

from gpubench import yardstick as Y
from gpubench.readers import device_trace, share

KERNELS = ("flash_fwd", "flash_bwd")


def micro_batch_least(s, t, rows, program) -> float:
    v, rs, lm = s.vision, s.resampler, s.lm
    ids, seq_len = rows["input_ids"], rows["seq_len"].tolist()
    b, sq = ids.shape
    n_img = b * t["media"]
    least = 0.0
    if not program.get("cache_vision_latents"):
        p = v.num_patches + 1
        least += v.num_layers * Y.bound(*Y.flash_work(
            n_img, p, p, v.num_heads, v.num_heads, v.head_dim, n_img * p * p, backward=False))
    src = v.num_patches + rs.num_latents
    for bwd in (False, True):
        least += rs.depth * Y.bound(*Y.flash_work(
            n_img, rs.num_latents, src, rs.num_heads, rs.num_heads, rs.head_dim,
            n_img * rs.num_latents * src, backward=bwd))
    q_media = torch.cumsum(ids == s.tokens["media"], dim=1)
    counts = (q_media > 0).sum(dim=1).tolist()
    lat = t["media"] * rs.num_latents
    x_pairs = Y.media_pairs(counts, rs.num_latents)
    lm_pairs = Y.causal_pairs(seq_len, sq)
    for bwd in (False, True):
        least += Y.n_xattn(s) * Y.bound(*Y.flash_work(
            b, sq, lat, lm.num_heads, lm.num_heads, lm.head_dim, x_pairs, backward=bwd,
            mask_bytes=4 * b * (sq + lat)))
        least += lm.num_layers * Y.bound(*Y.flash_work(
            b, sq, sq, lm.num_heads, lm.kv_heads, lm.head_dim, lm_pairs, backward=bwd,
            mask_bytes=4 * b))
    return least


def read(r):
    dt = device_trace(r)
    if dt is None:
        return None
    least = sum(micro_batch_least(r.sizes, r.spec["traffic"], rows, r.spec["program"])
                for rows in r.record["micro_batches"])
    return share(least, dt.ns_matching(KERNELS))
