"""decode_attn_roofline.eval: the least time of the window's decode
attention over the device time of the port's decode-attention kernels, in
%.

Kernels (``unimp_tpu_torch/ops/decode_attention.py``'s entries
``decode_attention``, K4, and ``single_query_attention``, K5, launch the
``csrc/decode_attn.cu`` kernels, bf16 and int8 caches alike): every
device operation whose name contains one of ``KERNELS``.

Work (``yardstick.k4_work`` / ``k5_work``, counted from the cell's
shapes, never from the program): at each decode step each LM layer reads
q, writes out, reads each user's valid prompt rows once and one gen row
per user and position (the beams of a user may share every ancestor, and
the timed path does not return the ancestry, so this is the least); each
cross-attention layer reads the latents its "immediate" mask allows (one
medium's) once.
"""

from gpubench import yardstick as Y
from gpubench.readers import device_trace, share

KERNELS = ("decode_attn", "single_query")


def read(r):
    dt = device_trace(r)
    if dt is None:
        return None
    s, t = r.sizes, r.spec["traffic"]
    lm, lat = s.lm, s.resampler.num_latents
    int8 = r.spec["program"]["kv_int8"]
    elt, scale = (1, 4) if int8 else (2, 0)
    b, kb = t["batch"], t["beams"]
    least = 0.0
    for steps, seq_len in zip(r.record["decode_steps"], r.record["seq_lens"]):
        prompt_rows = int(sum(seq_len))
        for step in range(steps):
            k4 = Y.k4_work(prompt_rows, b, kb, step + 1, lm.num_heads, lm.kv_heads,
                           lm.head_dim, elt, scale)
            k5 = Y.k5_work(b, kb, t["media"] * lat, b * lat, lm.num_heads, lm.kv_heads,
                           lm.head_dim, elt, scale)
            least += lm.num_layers * Y.bound(*k4) + Y.n_xattn(s) * Y.bound(*k5)
    return share(least, dt.ns_matching(KERNELS))
