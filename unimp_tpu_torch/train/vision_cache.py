"""Frozen vision-tower feature cache for training.

Counterpart of ``unimp_tpu/train/vision_cache.py``. The reference runs the
frozen CLIP tower on the same item images every epoch (the tower is frozen
by the open_flamingo factory, UniMP's mmrec.py:475-524, and the train-time
transform is deterministic: resize and normalize, rec_dataset.py:90-107),
so each item image's tower output is a constant of training. This module
encodes every item once through ``UniMPModel.encode_vision_tower`` and
keeps the features on the device; train batches then carry ``image_ids``
(``TaskDataset(load_images=False)``) and the step gathers rows and runs
only the trainable perceiver (``Trainer.vision_cache``).

Memory: n_items x patches x vision width at the compute dtype; CLIP-L/14
at 224 px in bfloat16 is 256 x 1024 x 2 B = 524 KB an item.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch

from unimp_tpu_torch.data.transforms import normalize_on_device

# refuses a larger cache: the JAX package's default guard on the catalogue
# size (a check against an unexpected catalogue, not a figure tuned on the
# card)
MAX_BYTES = 6 << 30


def tower_cache_bytes(n_items: int, cfg) -> int:
    """Device bytes of a tower cache of ``n_items`` at cfg's compute dtype
    (the tower drops its class token: one row a patch; the JAX package's
    guard also counts the class token's row)."""
    p = cfg.vision.num_patches
    itemsize = torch.empty((), dtype=cfg.compute_dtype).element_size()
    return n_items * p * cfg.vision.hidden_size * itemsize


@torch.no_grad()
def build_tower_cache(model, get_image: Callable[[int], np.ndarray], n_items: int, *,
                      chunk: int = 64, max_bytes: int = MAX_BYTES) -> torch.Tensor:
    """Encode every item image through the frozen tower once.

    get_image(i) -> uint8 [H, W, 3] (``TaskDataset.item_image``). Returns a
    tensor [n_items, P, Dv] in the model's compute dtype, on the model's
    device."""
    cfg = model.cfg
    need = tower_cache_bytes(n_items, cfg)
    if need > max_bytes:
        raise ValueError(f"tower cache for {n_items} items needs {need / 2**30:.1f} GiB "
                         f"(> max_bytes {max_bytes / 2**30:.1f} GiB); train without "
                         "--cache_vision_latents for this catalog size")
    device = next(model.parameters()).device
    cache = torch.empty((n_items, cfg.vision.num_patches, cfg.vision.hidden_size),
                        dtype=cfg.compute_dtype, device=device)
    zero = getattr(model, "zero", None)
    # a ZeRO-3 tower is gathered once for the whole loop, not once a chunk
    with zero.held(model.vision) if zero is not None else contextlib.nullcontext():
        for start in range(0, n_items, chunk):
            stop = min(start + chunk, n_items)
            imgs = torch.from_numpy(np.stack([get_image(i) for i in range(start, stop)]))
            pixels = normalize_on_device(imgs.to(device)[:, None], cfg.compute_dtype)
            cache[start:stop] = model.encode_vision_tower(pixels)[:, 0]
    return cache
