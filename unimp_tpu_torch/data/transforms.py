"""Image preprocessing: decode, resize, CLIP-normalize.

Counterpart of ``unimp_tpu/data/transforms.py`` (the reference's
RandomResize -> ToTensor -> Normalize(FLAMINGO mean/std)). The host
decodes and resizes to uint8 through the port's own JPEG codec
(``data/jpeg.py``: libjpeg's decode and the JAX package's native resize,
bit for bit); images travel to the card as uint8, a byte per channel, and
are normalized there.
"""

from __future__ import annotations

import numpy as np
import torch

from unimp_tpu_torch.data import jpeg

FLAMINGO_MEAN = (0.48145466, 0.4578275, 0.40821073)
FLAMINGO_STD = (0.26862954, 0.26130258, 0.27577711)


def load_image_rgb(path: str) -> np.ndarray:
    """Decode a JPEG file to uint8 RGB [H, W, 3]."""
    with open(path, "rb") as f:
        return jpeg.decode_jpeg(f.read())


def preprocess_uint8(img: np.ndarray, size: int = 224) -> np.ndarray:
    """Resize only; keep uint8 for cheap host->device transfer."""
    if img.shape[0] != size or img.shape[1] != size:
        img = jpeg.resize_bilinear(img, size)
    return img


def load_resized_uint8(path: str, size: int) -> np.ndarray:
    """Decode + resize to uint8 [size, size, 3], as the JAX package's
    native pipe gives it."""
    with open(path, "rb") as f:
        return jpeg.decode_resize(f.read(), size)


def normalize_on_device(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [..., H, W, 3] -> CLIP-normalized ``dtype`` on x's device
    (computed in float32, then cast)."""
    mean = torch.tensor(FLAMINGO_MEAN, device=x.device)
    std = torch.tensor(FLAMINGO_STD, device=x.device)
    return ((x.float() / 255.0 - mean) / std).to(dtype)
