"""Device-resident item-image latent cache for evaluation.

Counterpart of ``unimp_tpu/evals/latent_cache.py``. At eval time every
item image is static, so each unique item is encoded (CLIP tower +
perceiver) exactly once, in fixed-size chunks, and every batch is served
by a gather on the device: a batch carries a [B, M] array of item ids
instead of B * M images.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from unimp_tpu_torch.data.transforms import normalize_on_device
from unimp_tpu_torch.device import resolve_device
from unimp_tpu_torch.parallel.mesh import lockstep_calls

# refuse a cache larger than this (n_items x latents x width x dtype size)
MAX_BYTES = 6 << 30


class ItemLatentCache:
    def __init__(self, model, get_image: Callable[[int], np.ndarray], n_items: int,
                 *, chunk: int = 64, device="cuda"):
        self.model = model
        self.get_image = get_image
        self.n_items = int(n_items)
        self.chunk = chunk
        self.device = resolve_device(device)
        self._cached = np.zeros(self.n_items, bool)
        self._cache = None  # [n_items, L, D] on the device

    @torch.no_grad()
    def _ensure(self, ids: np.ndarray) -> None:
        ids = ids[(ids >= 0) & (ids < self.n_items)]
        new = np.unique(ids[~self._cached[ids]])
        offsets = list(range(0, new.size, self.chunk))
        # a ZeRO-3 model's forwards gather over fsdp: every rank encodes as
        # many chunks as the rank with the most misses (the extra ones
        # encode this call's last miss, or item 0, again)
        extra = lockstep_calls(self.model, len(offsets)) - len(offsets)
        if extra:
            new = new if new.size else np.zeros(1, np.int64)
            offsets += [new.size - 1] * extra
        for off in offsets:
            part = new[off : off + self.chunk]
            # pad to the fixed chunk shape (repeat the last id)
            pad = np.concatenate([part, np.full(self.chunk - part.size, part[-1], part.dtype)])
            imgs = torch.from_numpy(np.stack([self.get_image(int(i)) for i in pad]))
            imgs = imgs.to(self.device)[:, None]
            lat = self.model.encode_vision(normalize_on_device(imgs))[:, 0]  # [chunk, L, D]
            if self._cache is None:
                nbytes = self.n_items * lat[0].numel() * lat.element_size()
                if nbytes > MAX_BYTES:
                    raise MemoryError(f"latent cache would need {nbytes / 2**30:.1f} GiB "
                                      f"(> {MAX_BYTES / 2**30:.1f})")
                self._cache = torch.zeros((self.n_items,) + lat.shape[1:],
                                          dtype=lat.dtype, device=self.device)
            self._cache[torch.from_numpy(pad).to(self.device)] = lat
        self._cached[new] = True

    def gather(self, image_ids: np.ndarray) -> torch.Tensor:
        """[B, M] host item ids -> latents [B, M, L, D] (encoding misses)."""
        ids = np.asarray(image_ids)
        self._ensure(ids.ravel())
        return self._cache[torch.from_numpy(ids).long().to(self.device)]
