"""Seeded weights and inputs, made by the benchmark and handed to both sides.

Every tensor is a function of (seed, name, shape) alone, drawn on the
device from a ``torch.Generator`` of its own, so the program's build and
the plain reference draw the same values in any order and neither keeps
the other's copy. This module imports nothing of the program.

Distributions (float32): a kernel is normal with variance 1 / fan-in over
its contracted axes (two for an ``o_proj`` kernel [H, d, out], one
otherwise), and each of its output columns carries one outlier of
``OUTLIER`` times that scale at a row drawn from the seed, as trained
weights carry a few large entries (so that a weight-only int8 or int4
quantization, whose step follows a column's largest entry, costs here what
it costs on trained weights; with Gaussian columns alone an int8 model read
within 3x of the bfloat16 one); an embedding normal with variance 1 / width; a bias normal(0,
0.02); a norm scale 1 + normal(0, 0.05); a gate uniform in [0.5, 1)
(opened, so that cross-attention reaches the logits); ``cls_token``,
``pos_embed`` and ``latents`` normal(0, 0.02).
"""

from __future__ import annotations

import math
import zlib

import torch

OUTLIER = 20.0
_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1


def tensor_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed for tensor ``name`` under run seed ``seed``
    (any whole number, negative or above 2**32 included)."""
    return ((int(seed) * _MIX) ^ (zlib.crc32(name.encode()) << 20) ^ len(name)) & _MASK


def generator(seed: int, name: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(tensor_seed(seed, name))


def contracted_axes(name: str, ndim: int) -> int:
    parent = name.rsplit(".", 2)[-2] if name.count(".") >= 1 else ""
    return 2 if parent == "o_proj" and ndim == 3 else 1


def draw(seed: int, name: str, shape, device) -> torch.Tensor:
    """The float32 value of parameter ``name`` (the port's dotted Flax path)."""
    shape = tuple(int(s) for s in shape)
    gen = generator(seed, name, device)
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("attn_gate", "ff_gate"):
        return 0.5 + 0.5 * torch.rand(shape, generator=gen, device=device)
    out = torch.randn(shape, generator=gen, device=device)
    if leaf == "kernel":
        fan_in = math.prod(shape[: contracted_axes(name, len(shape))])
        cols = out.view(fan_in, -1)
        n = cols.shape[1]
        rows = torch.randint(0, fan_in, (n,), generator=gen, device=device)
        signs = torch.randint(0, 2, (n,), generator=gen, device=device) * 2 - 1
        cols[rows, torch.arange(n, device=device)] = OUTLIER * signs.float()
        return out.mul_(1.0 / math.sqrt(fan_in))
    if leaf == "embedding":
        return out.mul_(1.0 / math.sqrt(shape[-1]))
    if leaf == "scale":
        return out.mul_(0.05).add_(1.0)
    if leaf in ("bias", "cls_token", "pos_embed", "latents"):
        return out.mul_(0.02)
    raise KeyError(f"no distribution for parameter {name}")


def images(seed: int, name: str, n: int, size: int, device) -> torch.Tensor:
    """[n, size, size, 3] uint8 images drawn on the device."""
    gen = generator(seed, name, device)
    return torch.randint(0, 256, (n, size, size, 3), generator=gen, device=device,
                         dtype=torch.uint8)
