"""The port's weights -> a torch state dict under the reference's names.

Counterpart of ``unimp_tpu/tools/export_torch.py`` (``--save_hf_model``):
the reverse of ``tools/convert_torch.py``, writing a ``.pt`` whose names
and layouts follow the reference's OpenFlamingo conventions, with the
fused projections packed again (``to_kv``; ``query_key_value`` per head
for "neox", ``Wqkv`` in thirds for "mpt"), so weights trained here load
into the reference stack or back through the converter. Values are host
float32 (an int8 kernel as its dequantized floats, a bfloat16 tensor
widened), as the JAX package writes them. The layouts are made on the
tensors' own device (the card's copy engines and memory, not the host's
one thread), each result then copied to the host.
"""

from __future__ import annotations

import os
import re
from typing import Dict

import numpy as np
import torch
from torch import nn

from unimp_tpu_torch.tools.from_flax import flatten_tree
from unimp_tpu_torch.train.checkpoint import full_model_tree, is_writer


def _f32(val) -> torch.Tensor:
    if isinstance(val, torch.Tensor):
        return val.detach().float()
    return torch.from_numpy(np.array(val, np.float32))  # a copy: the input may be read-only


def _t(val: torch.Tensor) -> torch.Tensor:
    """A kernel [in, out] or [in, H, d] as a torch Linear weight [out, in]
    (numpy's ``.T``: all axes reversed)."""
    val = val.reshape(val.shape[0], -1) if val.ndim == 3 else val
    return val.permute(*reversed(range(val.ndim)))


def _vision_name(sub: str) -> str:
    sub = (sub.replace("cls_token", "embeddings.class_embedding")
           .replace("pos_embed", "embeddings.position_embedding.weight")
           .replace("pre_ln/", "pre_layrnorm.").replace("post_ln/", "post_layernorm."))
    sub = re.sub(r"block_(\d+)/", r"encoder.layers.\1.", sub)
    for ours, theirs in (("attn/q_proj/", "self_attn.q_proj."), ("attn/k_proj/", "self_attn.k_proj."),
                         ("attn/v_proj/", "self_attn.v_proj."),
                         ("attn/o_proj/", "self_attn.out_proj."), ("ln1/", "layer_norm1."),
                         ("ln2/", "layer_norm2."), ("mlp/up/", "mlp.fc1."),
                         ("mlp/down/", "mlp.fc2.")):
        sub = sub.replace(ours, theirs)
    return sub.replace("/scale", ".weight").replace("/", ".")


def export_state_dict(model_or_tree, lm_family: str = "neox") -> Dict[str, torch.Tensor]:
    """A model (its whole tree: tp blocks gathered, int8 kernels
    dequantized; collective under tp) or a flat / nested tree -> a
    torch-layout state dict of host float32 tensors under OpenFlamingo
    names."""
    tree = (full_model_tree(model_or_tree) if isinstance(model_or_tree, nn.Module)
            else model_or_tree)
    flat = {p: _f32(v) for p, v in flatten_tree(tree).items()}
    del tree
    out: Dict[str, torch.Tensor] = {}

    def put(name, val):
        # the JAX exporter's np.ascontiguousarray makes a scalar (a gate) [1]
        val = (val.reshape(1) if val.ndim == 0 else val).contiguous().cpu()
        # a view of a larger host storage (a parameter of a CPU model)
        # would be saved with all of that storage
        out[name] = val.clone() if val.untyped_storage().nbytes() != val.nbytes else val

    qkv: Dict[str, Dict[str, torch.Tensor]] = {}
    fused_kv: Dict[str, Dict[str, torch.Tensor]] = {}  # resampler / xattn to_kv
    for path in list(flat):
        val = flat.pop(path)
        path = path.replace("/scale", "/weight")
        m = re.match(r"block_(\d+)/attn/([qkv])_proj/(kernel|bias)", path)
        if m:
            qkv.setdefault(m.group(1), {})[f"{m.group(2)}_{m.group(3)}"] = val
            continue
        m = re.match(r"(resampler/block_\d+/attn|xattn_\d+/xattn)/([kv])_proj/kernel", path)
        if m:
            fused_kv.setdefault(m.group(1), {})[m.group(2)] = val
            continue
        m = re.match(r"vision/(.*)", path)
        if m:
            sub, base = m.group(1), "vision_encoder.vision_model"
            if sub == "patch_embed/kernel":  # [kh * kw * 3, out] -> conv [out, 3, kh, kw]
                kh = int(round((val.shape[0] // 3) ** 0.5))
                put(f"{base}.embeddings.patch_embedding.weight",
                    val.reshape(kh, kh, 3, val.shape[1]).permute(3, 2, 0, 1))
                continue
            name = f"{base}.{_vision_name(sub)}"
            if name.endswith("kernel"):
                name = name[: -len("kernel")] + "weight"
                if val.ndim in (2, 3):
                    val = _t(val)
            put(name, val)
            continue
        m = re.match(r"resampler/(.*)", path)
        if m:
            sub = m.group(1)
            if sub == "latents":
                put("perceiver.latents", val)
                continue
            sub = re.sub(r"block_(\d+)/", r"layers.\1.", sub.replace("out_ln/", "norm."))
            for ours, theirs in (("ln_media/", "0.norm_media."), ("ln_latents/", "0.norm_latents."),
                                 ("attn/q_proj/kernel", "0.to_q.weight"),
                                 ("attn/o_proj/kernel", "0.to_out.weight"), ("ln_ff/", "1.0."),
                                 ("mlp/up/kernel", "1.1.weight"),
                                 ("mlp/down/kernel", "1.3.weight")):
                sub = sub.replace(ours, theirs)
            sub = sub.replace("/scale", ".weight").replace("/", ".")
            put(f"perceiver.{sub}", _t(val) if sub.endswith(".weight") and val.ndim >= 2 else val)
            continue
        m = re.match(r"xattn_(\d+)/(.*)", path)
        if m:
            i, sub = m.group(1), m.group(2)
            for ours, theirs in (("ln_attn/", "attn.norm."),
                                 ("xattn/q_proj/kernel", "attn.to_q.weight"),
                                 ("xattn/o_proj/kernel", "attn.to_out.weight"), ("ln_ff/", "ff.0."),
                                 ("mlp/up/kernel", "ff.1.weight"), ("mlp/down/kernel", "ff.3.weight")):
                sub = sub.replace(ours, theirs)
            sub = sub.replace("/scale", ".weight").replace("/", ".")
            put(f"lang_encoder.gated_cross_attn_layers.{i}.{sub}",
                _t(val) if sub.endswith(".weight") and val.ndim >= 2 else val)
            continue
        m = re.match(r"block_(\d+)/(.*)", path)
        if m:
            i, sub = m.group(1), m.group(2)
            if lm_family == "neox":
                base = f"lang_encoder.gpt_neox.layers.{i}"
                pairs = (("ln1/", "input_layernorm."), ("ln2/", "post_attention_layernorm."),
                         ("attn/o_proj/", "attention.dense."), ("mlp/up/", "mlp.dense_h_to_4h."),
                         ("mlp/down/", "mlp.dense_4h_to_h."),
                         ("mlp/gate/", "mlp.gate."))  # no torch counterpart
            else:
                base = f"lang_encoder.transformer.blocks.{i}"
                pairs = (("ln1/", "norm_1."), ("ln2/", "norm_2."), ("attn/o_proj/", "attn.out_proj."),
                         ("mlp/up/", "ffn.up_proj."), ("mlp/down/", "ffn.down_proj."))
            for ours, theirs in pairs:
                sub = sub.replace(ours, theirs)
            sub = sub.replace("/scale", ".weight").replace("/", ".")
            if sub.endswith("kernel"):
                sub = sub[: -len("kernel")] + "weight"
                val = _t(val)
            put(f"{base}.{sub}", val)
            continue
        if path == "embed/embedding":
            put("lang_encoder.gpt_neox.embed_in.weight" if lm_family == "neox"
                else "lang_encoder.transformer.wte.weight", val)
            continue
        if path.startswith("final_ln/"):
            base = ("lang_encoder.gpt_neox.final_layer_norm" if lm_family == "neox"
                    else "lang_encoder.transformer.norm_f")
            put(f"{base}.{path.split('/')[-1].replace('scale', 'weight')}", val)
            continue
        if path == "lm_head/kernel":
            put("lang_encoder.embed_out.weight", _t(val))
            continue
        put(path.replace("/", "."), val)  # our own name, dotted

    for owner, parts in fused_kv.items():
        w = torch.cat([_t(parts["k"]), _t(parts["v"])], dim=0)
        m = re.match(r"resampler/block_(\d+)/attn", owner)
        if m:
            put(f"perceiver.layers.{m.group(1)}.0.to_kv.weight", w)
        else:
            i = re.match(r"xattn_(\d+)/xattn", owner).group(1)
            put(f"lang_encoder.gated_cross_attn_layers.{i}.attn.to_kv.weight", w)

    for i, parts in qkv.items():
        qk, kk, vk = parts["q_kernel"], parts["k_kernel"], parts["v_kernel"]
        if lm_family == "neox":  # [in, H, d] x 3 -> per head (q, k, v): [H * 3 * d, in]
            h, d = qk.shape[1], qk.shape[2]
            stacked = torch.stack([x.permute(1, 2, 0) for x in (qk, kk, vk)], dim=1)
            put(f"lang_encoder.gpt_neox.layers.{i}.attention.query_key_value.weight",
                stacked.reshape(h * 3 * d, -1))
            if "q_bias" in parts:
                put(f"lang_encoder.gpt_neox.layers.{i}.attention.query_key_value.bias",
                    torch.stack([parts["q_bias"], parts["k_bias"], parts["v_bias"]], 1).reshape(-1))
        else:
            put(f"lang_encoder.transformer.blocks.{i}.attn.Wqkv.weight",
                torch.cat([_t(x) for x in (qk, kk, vk)], dim=0))
    return out


def save_torch_checkpoint(model_or_tree, path: str, lm_family: str = "neox") -> str:
    """Write ``{"model_state_dict": ...}`` (float32) to ``path`` (rank 0
    writes; every rank of a model's tp group calls it)."""
    sd = export_state_dict(model_or_tree, lm_family)
    if is_writer():
        tmp = path + ".tmp"
        torch.save({"model_state_dict": sd}, tmp)
        os.replace(tmp, path)
    return path


def family_of(positions: str) -> str:
    """The exported decoder's naming: "mpt" for ALiBi positions, else
    "neox" (the JAX CLI's choice)."""
    return "mpt" if positions == "alibi" else "neox"

