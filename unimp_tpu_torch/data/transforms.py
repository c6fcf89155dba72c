"""CLIP normalization on the device.

Counterpart of ``normalize_on_device`` in ``unimp_tpu/data/transforms.py``
(the reference's FLAMINGO mean / std). Images travel to the card as uint8,
a byte per channel, and are normalized there.
"""

from __future__ import annotations

import torch

FLAMINGO_MEAN = (0.48145466, 0.4578275, 0.40821073)
FLAMINGO_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_on_device(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [..., H, W, 3] -> CLIP-normalized ``dtype`` on x's device
    (computed in float32, then cast)."""
    mean = torch.tensor(FLAMINGO_MEAN, device=x.device)
    std = torch.tensor(FLAMINGO_STD, device=x.device)
    return ((x.float() / 255.0 - mean) / std).to(dtype)
