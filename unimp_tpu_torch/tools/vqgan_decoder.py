"""A taming-transformers VQGAN decoder as a torch module.

Counterpart of ``unimp_tpu/tools/vqgan_decoder.py``. The reference's
img_gen task generates ``img_{i}`` codebook-token strings and decodes them
offline with a taming-transformers VQGAN (its README; the VQGAN itself is
not in its tree). This module loads such a checkpoint's ``state_dict``
(``quantize.embedding`` / ``post_quant_conv`` / ``decoder.*``; the encoder
and discriminator are dropped), infers the decoder's architecture from the
keys (levels, ResnetBlocks a level, where attention sits), and maps codes
to images in NCHW with the torch OIHW weights as they come: ResnetBlocks
with nin shortcuts, mid attention, nearest 2x upsampling convs,
``GroupNorm(32, eps 1e-6)`` and swish. The convolutions are ``F.conv2d``
and the attention plain torch, as the JAX package computes them with
``lax.conv`` and einsums outside any Pallas kernel.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unimp_tpu_torch.data.png import encode_png


def _swish(x):
    return x * torch.sigmoid(x)


class VQGANDecoder(nn.Module):
    """codes [N, G] -> images: ``forward`` gives float NCHW (taming's
    [-1, 1] range), ``decode`` uint8 NHWC."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        self.keys = sorted(params)
        for k in self.keys:  # buffers, so .to(device) moves them
            self.register_buffer(k.replace(".", "__"), params[k].float().contiguous())
        self.n_embed, self.embed_dim = params["quantize.embedding.weight"].shape
        blocks: Dict[int, int] = {}
        self.attn_levels = set()
        for key in params:
            m = re.match(r"decoder\.up\.(\d+)\.block\.(\d+)\.", key)
            if m:
                i, j = int(m.group(1)), int(m.group(2))
                blocks[i] = max(blocks.get(i, 0), j + 1)
            if re.match(r"decoder\.up\.(\d+)\.attn\.", key):
                self.attn_levels.add(int(key.split(".")[2]))
        self.num_levels = max(blocks) + 1 if blocks else 0
        self.blocks_per_level = blocks

    @classmethod
    def from_state_dict(cls, sd) -> "VQGANDecoder":
        """A torch state dict (tensors or numpy arrays): the quantizer's,
        ``post_quant_conv``'s and the decoder's tensors, as float32."""
        return cls({k: torch.as_tensor(np.asarray(v.detach().cpu() if hasattr(v, "detach")
                                                  else v, np.float32))
                    for k, v in sd.items()
                    if k.startswith(("quantize.", "post_quant_conv.", "decoder."))})

    @classmethod
    def from_torch_checkpoint(cls, path: str) -> "VQGANDecoder":
        # a taming checkpoint is a Lightning file with its hyperparameters
        # pickled beside the weights: loaded in full, as the JAX package does
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        return cls.from_state_dict(ckpt.get("state_dict", ckpt))

    def _w(self, key: str) -> torch.Tensor:
        return getattr(self, key.replace(".", "__"))

    def _conv(self, x, prefix: str):
        w = self._w(prefix + "weight")
        return F.conv2d(x, w, self._w(prefix + "bias"), padding=w.shape[-1] // 2)

    def _norm(self, x, prefix: str):
        return F.group_norm(x, min(32, x.shape[1]), self._w(prefix + "weight"),
                            self._w(prefix + "bias"), eps=1e-6)

    def _resnet(self, x, p: str):
        h = self._conv(_swish(self._norm(x, p + "norm1.")), p + "conv1.")
        h = self._conv(_swish(self._norm(h, p + "norm2.")), p + "conv2.")
        if p + "nin_shortcut.weight" in self.keys:
            x = self._conv(x, p + "nin_shortcut.")
        elif p + "conv_shortcut.weight" in self.keys:
            x = self._conv(x, p + "conv_shortcut.")
        return x + h

    def _attn(self, x, p: str):
        n, c, hh, ww = x.shape
        h = self._norm(x, p + "norm.")
        q, k, v = (self._conv(h, p + f"{name}.").reshape(n, c, hh * ww) for name in "qkv")
        att = torch.softmax(torch.einsum("ncq,nck->nqk", q, k) * (c ** -0.5), dim=-1)
        h = torch.einsum("nqk,nck->ncq", att, v).reshape(n, c, hh, ww)
        return x + self._conv(h, p + "proj_out.")

    def forward(self, codes: torch.Tensor) -> torch.Tensor:
        n, g = codes.shape
        gh = int(round(g ** 0.5))
        z = self._w("quantize.embedding.weight")[codes.long()]
        z = z.reshape(n, gh, g // gh, self.embed_dim).permute(0, 3, 1, 2)
        h = self._conv(self._conv(z, "post_quant_conv."), "decoder.conv_in.")
        h = self._resnet(h, "decoder.mid.block_1.")
        h = self._attn(h, "decoder.mid.attn_1.")
        h = self._resnet(h, "decoder.mid.block_2.")
        # taming's Decoder: up[i] by level (0 = full resolution), lowest first
        for i in reversed(range(self.num_levels)):
            for j in range(self.blocks_per_level[i]):
                h = self._resnet(h, f"decoder.up.{i}.block.{j}.")
                if i in self.attn_levels:
                    h = self._attn(h, f"decoder.up.{i}.attn.{j}.")
            if i != 0:
                h = self._conv(F.interpolate(h, scale_factor=2.0, mode="nearest"),
                               f"decoder.up.{i}.upsample.conv.")
        h = _swish(self._norm(h, "decoder.norm_out."))
        return self._conv(h, "decoder.conv_out.")

    @torch.no_grad()
    def decode(self, tokens, grid=None) -> np.ndarray:
        """int tokens [N, G] -> uint8 images [N, H, W, 3] (taming's
        [-1, 1] -> pixels); ``PatchVQTokenizer.decode``'s signature."""
        device = self._w("quantize.embedding.weight").device
        x = self(torch.as_tensor(np.asarray(tokens), device=device))
        x = x.permute(0, 2, 3, 1).float().cpu().numpy()
        return np.clip((x + 1.0) / 2.0 * 255.0, 0, 255).astype(np.uint8)


def decode_img_gen_dump(dump_path: str, decoder, out_dir: str, token_prefix: str = "img_") -> int:
    """Render an eval img_gen dump (``save_img_gen/*.json``) to PNG files,
    the reference's offline decode step. Returns the number written; a
    generation whose token count is not a square is padded with token 0."""
    with open(dump_path) as f:
        gens = json.load(f)
    os.makedirs(out_dir, exist_ok=True)
    written = 0
    for i, g in enumerate(gens):
        text = g["generated"] if isinstance(g, dict) else str(g)
        toks = [int(w[len(token_prefix):].rstrip(","))
                for w in text.replace(",", ", ").split()
                if w.startswith(token_prefix) and w[len(token_prefix):].rstrip(",").isdigit()]
        if not toks:
            continue
        side = int(np.ceil(np.sqrt(len(toks))))
        toks = (toks + [0] * (side * side - len(toks)))[: side * side]
        img = decoder.decode(np.asarray([toks], np.int64))[0]
        with open(os.path.join(out_dir, f"gen_{i}.png"), "wb") as f:
            f.write(encode_png(img))
        written += 1
    return written
