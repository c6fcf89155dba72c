"""k6_roofline.eval: the least time of the window's int8 weight-streaming
matmuls over the device time of K6, in %.

Kernels (``unimp_tpu_torch/ops/quant_matmul.py``'s ``quant_matmul``, K6,
``csrc/quant_matmul.cu``): every device operation whose name contains one
of ``KERNELS`` (the split-K reduction included).

Work (``yardstick.k6_work``, from the cell's shapes): at each decode step
of b x beams rows, each LM block's fused q/k/v, o, MLP up and down, each
cross-attention block's q, o, MLP up and down (its K / V are cached), and
an untied head; an untied head once more a batch at the prefill's last
position. Each reads its int8 weights, their f32 scales, x and the output
once, 2 * M * K * N operations.
"""

from gpubench import yardstick as Y
from gpubench.readers import device_trace, share

KERNELS = ("qmm_",)


def step_matmuls(s, rows):
    lm = s.lm
    d, hd = lm.hidden_size, lm.num_heads * lm.head_dim
    kv = lm.kv_heads * lm.head_dim
    block = [(d, hd + 2 * kv), (hd, d), (d, lm.mlp_dim), (lm.mlp_dim, d)]
    xattn = [(d, hd), (hd, d), (d, 4 * d), (4 * d, d)]
    out = [(rows, k, n) for k, n in block] * lm.num_layers
    out += [(rows, k, n) for k, n in xattn] * Y.n_xattn(s)
    if not lm.tie_embeddings:
        out.append((rows, d, lm.vocab_size))
    return out


def read(r):
    dt = device_trace(r)
    if dt is None or r.spec["program"]["eval_param_dtype"] != "int8":
        return None
    s, t = r.sizes, r.spec["traffic"]
    per_step = sum(Y.bound(*Y.k6_work(*mkn)) for mkn in step_matmuls(s, t["batch"] * t["beams"]))
    head = 0.0 if s.lm.tie_embeddings else Y.bound(*Y.k6_work(t["batch"], s.lm.hidden_size,
                                                              s.lm.vocab_size))
    least = sum(steps * per_step + head for steps in r.record["decode_steps"])
    return share(least, dt.ns_matching(KERNELS))
