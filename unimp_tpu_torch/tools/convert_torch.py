"""Reference ``.pt`` state dicts -> the port's flat Flax-path tree.

Counterpart of ``unimp_tpu/tools/convert_torch.py``. The reference
trains OpenFlamingo models and saves filtered torch state dicts
(``{"model_state_dict": {name: tensor}}``); this maps those names and
layouts onto the port's parameters, which keep Flax's names and layouts
(``tools/from_flax.py``):

  * ``Linear.weight`` [out, in] -> ``kernel`` [in, out]; attention
    projections reshape to [in, H, head_dim]; the conv patch embedding
    [out, in, kh, kw] -> [kh * kw * in, out]
  * fused projections split: perceiver and gated x-attn ``to_kv``
    [2 * inner, in] into k / v halves, GPT-NeoX ``query_key_value``
    [H * 3 * d, in] per head (q, k, v interleaved), MPT ``Wqkv``
    [3 * H * d, in] in straight thirds
  * names rewritten by the tables below: HF CLIP vision tower,
    open_flamingo perceiver and gated x-attn, GPT-NeoX, MPT and LLaMA
  * an embedding grown by the task vocabulary takes the file's rows and
    keeps the target's beyond them (``resize_token_embeddings``)

A name no rule maps, or a tensor whose shape does not fit, keeps the
target's value and is reported as missed (the reference's
``strict=False`` load); RoPE caches, mask biases and position-id buffers
are skipped. The source side is host numpy, as in the JAX package (a
bfloat16 tensor raises where ``Tensor.numpy()`` does); each result is a
host tensor in its target's dtype, for ``tools/from_flax.py:
load_flax_params``.
"""

from __future__ import annotations

import functools
import re
import warnings
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from unimp_tpu_torch.tools.from_flax import flatten_tree

# (torch-name regex, Flax-path template): renames; layouts are fixed by
# _fit_value, fused tensors by _FUSED_RULES
_RENAME_RULES: List[Tuple[str, str]] = [
    # vision tower (HF CLIP ViT)
    (r"vision_encoder\.vision_model\.embeddings\.class_embedding", r"vision/cls_token"),
    (r"vision_encoder\.vision_model\.embeddings\.patch_embedding\.weight",
     r"vision/patch_embed/kernel"),
    (r"vision_encoder\.vision_model\.embeddings\.position_embedding\.weight",
     r"vision/pos_embed"),
    (r"vision_encoder\.vision_model\.pre_layrnorm\.(weight|bias)", r"vision/pre_ln/\1"),
    (r"vision_encoder\.vision_model\.post_layernorm\.(weight|bias)", r"vision/post_ln/\1"),
    (r"vision_encoder\.vision_model\.encoder\.layers\.(\d+)\.self_attn\.([qkv])_proj\."
     r"(weight|bias)", r"vision/block_\1/attn/\2_proj/\3"),
    (r"vision_encoder\.vision_model\.encoder\.layers\.(\d+)\.self_attn\.out_proj\.(weight|bias)",
     r"vision/block_\1/attn/o_proj/\2"),
    (r"vision_encoder\.vision_model\.encoder\.layers\.(\d+)\.layer_norm1\.(weight|bias)",
     r"vision/block_\1/ln1/\2"),
    (r"vision_encoder\.vision_model\.encoder\.layers\.(\d+)\.layer_norm2\.(weight|bias)",
     r"vision/block_\1/ln2/\2"),
    (r"vision_encoder\.vision_model\.encoder\.layers\.(\d+)\.mlp\.fc1\.(weight|bias)",
     r"vision/block_\1/mlp/up/\2"),
    (r"vision_encoder\.vision_model\.encoder\.layers\.(\d+)\.mlp\.fc2\.(weight|bias)",
     r"vision/block_\1/mlp/down/\2"),
    # perceiver resampler (open_flamingo)
    (r"perceiver\.latents", r"resampler/latents"),
    (r"perceiver\.norm\.(weight|bias)", r"resampler/out_ln/\1"),
    (r"perceiver\.layers\.(\d+)\.0\.norm_media\.(weight|bias)",
     r"resampler/block_\1/ln_media/\2"),
    (r"perceiver\.layers\.(\d+)\.0\.norm_latents\.(weight|bias)",
     r"resampler/block_\1/ln_latents/\2"),
    (r"perceiver\.layers\.(\d+)\.0\.to_q\.weight", r"resampler/block_\1/attn/q_proj/kernel"),
    (r"perceiver\.layers\.(\d+)\.0\.to_out\.weight", r"resampler/block_\1/attn/o_proj/kernel"),
    (r"perceiver\.layers\.(\d+)\.1\.0\.(weight|bias)", r"resampler/block_\1/ln_ff/\2"),
    (r"perceiver\.layers\.(\d+)\.1\.1\.weight", r"resampler/block_\1/mlp/up/kernel"),
    (r"perceiver\.layers\.(\d+)\.1\.3\.weight", r"resampler/block_\1/mlp/down/kernel"),
    # gated cross-attention (open_flamingo)
    (r"lang_encoder\.gated_cross_attn_layers\.(\d+)\.attn_gate", r"xattn_\1/attn_gate"),
    (r"lang_encoder\.gated_cross_attn_layers\.(\d+)\.ff_gate", r"xattn_\1/ff_gate"),
    (r"lang_encoder\.gated_cross_attn_layers\.(\d+)\.attn\.norm\.(weight|bias)",
     r"xattn_\1/ln_attn/\2"),
    (r"lang_encoder\.gated_cross_attn_layers\.(\d+)\.attn\.to_q\.weight",
     r"xattn_\1/xattn/q_proj/kernel"),
    (r"lang_encoder\.gated_cross_attn_layers\.(\d+)\.attn\.to_out\.weight",
     r"xattn_\1/xattn/o_proj/kernel"),
    (r"lang_encoder\.gated_cross_attn_layers\.(\d+)\.ff\.0\.(weight|bias)", r"xattn_\1/ln_ff/\2"),
    (r"lang_encoder\.gated_cross_attn_layers\.(\d+)\.ff\.1\.weight", r"xattn_\1/mlp/up/kernel"),
    (r"lang_encoder\.gated_cross_attn_layers\.(\d+)\.ff\.3\.weight",
     r"xattn_\1/mlp/down/kernel"),
    # GPT-NeoX / RedPajama decoder
    (r"lang_encoder\.gpt_neox\.embed_in\.weight", r"embed/embedding"),
    (r"lang_encoder\.embed_out\.weight", r"lm_head/kernel"),
    (r"lang_encoder\.gpt_neox\.final_layer_norm\.(weight|bias)", r"final_ln/\1"),
    (r"lang_encoder\.gpt_neox\.layers\.(\d+)\.input_layernorm\.(weight|bias)", r"block_\1/ln1/\2"),
    (r"lang_encoder\.gpt_neox\.layers\.(\d+)\.post_attention_layernorm\.(weight|bias)",
     r"block_\1/ln2/\2"),
    (r"lang_encoder\.gpt_neox\.layers\.(\d+)\.attention\.dense\.(weight|bias)",
     r"block_\1/attn/o_proj/\2"),
    (r"lang_encoder\.gpt_neox\.layers\.(\d+)\.mlp\.dense_h_to_4h\.(weight|bias)",
     r"block_\1/mlp/up/\2"),
    (r"lang_encoder\.gpt_neox\.layers\.(\d+)\.mlp\.dense_4h_to_h\.(weight|bias)",
     r"block_\1/mlp/down/\2"),
    # LLaMA decoder (separate q / k / v projections)
    (r"lang_encoder\.model\.embed_tokens\.weight", r"embed/embedding"),
    (r"lang_encoder\.lm_head\.weight", r"lm_head/kernel"),
    (r"lang_encoder\.model\.norm\.weight", r"final_ln/weight"),
    (r"lang_encoder\.model\.layers\.(\d+)\.input_layernorm\.weight", r"block_\1/ln1/weight"),
    (r"lang_encoder\.model\.layers\.(\d+)\.post_attention_layernorm\.weight",
     r"block_\1/ln2/weight"),
    (r"lang_encoder\.model\.layers\.(\d+)\.self_attn\.([qkv])_proj\.weight",
     r"block_\1/attn/\2_proj/kernel"),
    (r"lang_encoder\.model\.layers\.(\d+)\.self_attn\.o_proj\.weight",
     r"block_\1/attn/o_proj/kernel"),
    (r"lang_encoder\.model\.layers\.(\d+)\.mlp\.gate_proj\.weight", r"block_\1/mlp/gate/kernel"),
    (r"lang_encoder\.model\.layers\.(\d+)\.mlp\.up_proj\.weight", r"block_\1/mlp/up/kernel"),
    (r"lang_encoder\.model\.layers\.(\d+)\.mlp\.down_proj\.weight", r"block_\1/mlp/down/kernel"),
    # MPT decoder
    (r"lang_encoder\.transformer\.wte\.weight", r"embed/embedding"),
    (r"lang_encoder\.transformer\.norm_f\.(weight|bias)", r"final_ln/\1"),
    (r"lang_encoder\.transformer\.blocks\.(\d+)\.norm_1\.(weight|bias)", r"block_\1/ln1/\2"),
    (r"lang_encoder\.transformer\.blocks\.(\d+)\.norm_2\.(weight|bias)", r"block_\1/ln2/\2"),
    (r"lang_encoder\.transformer\.blocks\.(\d+)\.attn\.out_proj\.(weight|bias)",
     r"block_\1/attn/o_proj/\2"),
    (r"lang_encoder\.transformer\.blocks\.(\d+)\.ffn\.up_proj\.(weight|bias)",
     r"block_\1/mlp/up/\2"),
    (r"lang_encoder\.transformer\.blocks\.(\d+)\.ffn\.down_proj\.(weight|bias)",
     r"block_\1/mlp/down/\2"),
]

# buffers of a torch state dict that hold no learned state (recomputed here)
_SKIP_RULES: List[str] = [
    r".*rotary_emb\.inv_freq$",
    r".*rotary_emb\.(cos|sin)_cached$",
    r".*embeddings\.position_ids$",
    r".*attention\.(bias|masked_bias)$",  # NeoX causal-mask buffers
    r".*attn\.(bias|masked_bias)$",
]


def is_skipped_buffer(name: str) -> bool:
    return any(re.fullmatch(p, name) for p in _SKIP_RULES)


def _split_kv(val: np.ndarray, targets: List) -> List[np.ndarray]:
    """open_flamingo ``to_kv`` [2 * inner, in] -> k, v halves."""
    return list(np.split(val, 2, axis=0))


def _split_neox_qkv(val: np.ndarray, targets: List) -> List[np.ndarray]:
    """NeoX ``query_key_value`` [H * 3 * d, in]: per head a (q, k, v) block."""
    h, d = targets[0].shape[1], targets[0].shape[2]  # q's target [in, H, d]
    if val.ndim == 2:
        out = val.reshape(h, 3, d, val.shape[1])
        return [out[:, i].reshape(h * d, -1) for i in range(3)]
    out = val.reshape(h, 3, d)
    return [out[:, i].reshape(h * d) for i in range(3)]


def _split_mpt_qkv(val: np.ndarray, targets: List) -> List[np.ndarray]:
    """MPT ``Wqkv`` [3 * H * d, in]: straight thirds."""
    return list(np.split(val, 3, axis=0))


# fused tensors: regex -> (the Flax paths it fills, splitter(value, targets));
# a "/KB" leaf resolves to kernel or bias, whichever the target has
_FUSED_RULES: List[Tuple[str, List[str], Callable]] = [
    (r"perceiver\.layers\.(\d+)\.0\.to_kv\.weight",
     [r"resampler/block_\1/attn/k_proj/kernel", r"resampler/block_\1/attn/v_proj/kernel"],
     _split_kv),
    (r"lang_encoder\.gated_cross_attn_layers\.(\d+)\.attn\.to_kv\.weight",
     [r"xattn_\1/xattn/k_proj/kernel", r"xattn_\1/xattn/v_proj/kernel"], _split_kv),
    (r"lang_encoder\.gpt_neox\.layers\.(\d+)\.attention\.query_key_value\.(weight|bias)",
     [r"block_\1/attn/q_proj/KB", r"block_\1/attn/k_proj/KB", r"block_\1/attn/v_proj/KB"],
     _split_neox_qkv),
    (r"lang_encoder\.transformer\.blocks\.(\d+)\.attn\.Wqkv\.(weight|bias)",
     [r"block_\1/attn/q_proj/KB", r"block_\1/attn/k_proj/KB", r"block_\1/attn/v_proj/KB"],
     _split_mpt_qkv),
]


def _dtype(target):
    """The target's dtype as a torch dtype."""
    if isinstance(target, torch.Tensor):
        return target.dtype
    return torch.from_numpy(np.zeros(0, np.asarray(target).dtype)).dtype


def _host(x) -> torch.Tensor:
    """A host tensor of a numpy array (a view) or of a tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    with warnings.catch_warnings():  # a read-only (file-mapped) array stays read-only
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.asarray(x))


def _grow(val: np.ndarray, base: torch.Tensor) -> torch.Tensor:
    """``base`` with ``val`` in its leading block, in place."""
    base[tuple(slice(0, d) for d in val.shape)] = _host(val).to(base.dtype)
    return base


def _fit_value(path: str, val: np.ndarray, target):
    """The torch tensor in the target's layout and dtype: kernels
    transposed (a conv patch embedding flattened), a reshape where the
    sizes agree, an embedding grown; None when it does not fit. A meta
    target (``tools/from_flax.py:build_model``'s seeded tree, made later
    one tensor at a time) is grown by a function of its seeded tensor."""
    shape = tuple(target.shape)
    if path.endswith("/kernel") and val.ndim >= 2:
        if val.ndim == 4:  # conv patch embed [out, in, kh, kw]
            val = val.transpose(2, 3, 1, 0).reshape(-1, val.shape[0])
        else:
            val = val.T
    if val.shape != shape:
        if val.size == int(np.prod(shape)):
            val = val.reshape(shape)
        elif val.ndim == len(shape) and all(v <= s for v, s in zip(val.shape, shape)):
            if isinstance(target, torch.Tensor) and target.is_meta:
                return functools.partial(_grow, val)
            return _grow(val, _host(target).clone())
        else:
            return None
    return _host(val).to(_dtype(target))


def _resolve(path: str, target: Mapping) -> Optional[str]:
    """Map weight / bias suffixes onto kernel / scale / embedding / bias."""
    if path in target:
        return path
    if path.endswith("/weight"):
        base = path[: -len("/weight")]
        for suffix in ("kernel", "scale", "embedding"):
            if f"{base}/{suffix}" in target:
                return f"{base}/{suffix}"
    if path.endswith("/KB"):
        base = path[: -len("/KB")]
        for suffix in ("kernel", "bias"):
            if f"{base}/{suffix}" in target:
                return f"{base}/{suffix}"
    return None


def convert_state_dict(state_dict: Mapping, target: Mapping) -> Tuple[Dict, Dict]:
    """Map a torch state dict ({name: numpy array}) onto ``target`` (a
    flat {"a/b/c": tensor or array} tree, or a nested one); returns the
    flat tree (every target path: converted host tensors, the target's own
    values where nothing mapped, a grown meta target's function of its
    seeded tensor) and the report {"matched", "missed", "skipped"}."""
    target_flat = flatten_tree(target)
    out = dict(target_flat)
    matched, missed, skipped = [], [], []

    def place(path: str, val: np.ndarray, origin: str):
        resolved = _resolve(path, target_flat)
        if resolved is None:
            missed.append(origin)
            return
        fitted = _fit_value(resolved, val, out[resolved])
        if fitted is None:
            missed.append(f"{origin} (shape {val.shape} vs {tuple(out[resolved].shape)})")
            return
        out[resolved] = fitted
        matched.append(origin)

    for name, val in state_dict.items():
        val = np.asarray(val)
        if is_skipped_buffer(name):
            skipped.append(name)
            continue
        fused = next(((m, templates, split) for pat, templates, split in _FUSED_RULES
                      for m in [re.fullmatch(pat, name)] if m), None)
        if fused is not None:
            m, templates, split = fused
            paths = [m.expand(t) for t in templates]
            targets = [out[r] if r else np.zeros(0) for r in
                       (_resolve(p, target_flat) for p in paths)]
            try:
                parts = split(val, targets)
            except Exception as e:
                missed.append(f"{name} (split failed: {e})")
                continue
            for p, part in zip(paths, parts):
                place(p, part, name)
            continue
        path = name.replace(".", "/")
        if path not in target_flat:
            for pat, tmpl in _RENAME_RULES:
                m = re.fullmatch(pat, name)
                if m:
                    path = m.expand(tmpl)
                    break
        place(path, val, name)
    return out, {"matched": matched, "missed": missed, "skipped": skipped}


def read_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A ``.pt`` file's state dict (``model_state_dict`` unwrapped) as
    numpy arrays mapped from the file, not copied into memory."""
    payload = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if isinstance(payload, dict) and "model_state_dict" in payload:
        payload = payload["model_state_dict"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in payload.items()}


def load_torch_checkpoint(path: str, target: Mapping) -> Dict:
    """Read a ``.pt`` and convert it onto ``target``; prints the
    ``[convert]`` report lines and returns the flat tree."""
    flat, report = convert_state_dict(read_state_dict(path), target)
    print(f"[convert] matched {len(report['matched'])} tensors, "
          f"left {len(report['missed'])} untouched")
    for m in report["missed"][:10]:
        print(f"[convert]   unmatched: {m}")
    return flat
