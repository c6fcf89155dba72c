"""Image preprocessing: decode, resize, CLIP-normalize.

Counterpart of ``unimp_tpu/data/transforms.py`` (the reference's
RandomResize -> ToTensor -> Normalize(FLAMINGO mean/std)). The host
decodes and resizes to uint8 through the port's own decoders, chosen by
the file's first bytes (``decode_image``): ``data/jpeg.py`` (libjpeg's
decode, bit for bit), and ``data/png.py``, ``data/gif.py`` (the first
frame), ``data/bmp.py``, ``data/tiff.py`` (the first page) and
``data/webp.py`` (the first frame; ``data/vp8.py`` for lossy frames):
PIL's ``convert("RGB")`` of each.
``load_resized_uint8`` resizes as the JAX package does for the same
file: a JPEG of 1 or 3 components goes through its native pipe's resize
(``jpeg.resize_bilinear``), any other image (which the pipe declines: a
CMYK or lossless JPEG, every other format) through PIL's bilinear resize
(``resize_bilinear_pil``). Images
travel to the card as uint8, a byte per channel, and are normalized
there. The serving worker's ``preprocess_image`` resizes every format as
PIL's ``Image.resize(BILINEAR)`` does, as the JAX worker does through PIL.
What these decoders still refuse (ROADMAP.md §3, fault 5) raises a
``ValueError`` that names it.
"""

from __future__ import annotations

import numpy as np
import torch

from unimp_tpu_torch.data import bmp, gif, jpeg, png, tiff, webp

FLAMINGO_MEAN = (0.48145466, 0.4578275, 0.40821073)
FLAMINGO_STD = (0.26862954, 0.26130258, 0.27577711)


# decoders that read a cut file as PIL with LOAD_TRUNCATED_IMAGES does, or
# raise with ``strict`` (a cut PNG raises either way)
_DECODERS = {"jpeg": jpeg.decode_jpeg, "gif": gif.decode_gif, "bmp": bmp.decode_bmp,
             "tiff": tiff.decode_tiff, "webp": webp.decode_webp}


def image_format(data: bytes) -> str:
    """"jpeg", "png", "gif", "bmp", "tiff" or "webp" by the file's first bytes; raises
    ``ValueError`` naming any other format."""
    if data[:2] == b"\xff\xd8":
        return "jpeg"
    if data.startswith(png.SIGNATURE):
        return "png"
    if data[:6] in gif.SIGNATURES:
        return "gif"
    if data[:2] == b"BM":
        return "bmp"
    if data[:4] in tiff.SIGNATURES:
        return "tiff"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "webp"
    raise ValueError("not an image the port reads (JPEG, PNG, GIF, BMP, TIFF or WebP)")


def decode_image(data: bytes, strict: bool = False) -> np.ndarray:
    """JPEG, PNG, GIF, BMP, TIFF or WebP bytes -> uint8 RGB [H, W, 3] (PIL's
    ``convert("RGB")``); ``strict``: a file cut short raises."""
    fmt = image_format(data)
    return png.decode_png(data) if fmt == "png" else _DECODERS[fmt](data, strict=strict)


def image_ok(path: str) -> bool:
    """Whether the file is an image the port reads whole: a decoder error,
    an unread format or a file cut short says no, as PIL's
    ``Image.open(path).convert("RGB")`` says no in a fresh process."""
    try:
        with open(path, "rb") as f:
            decode_image(f.read(), strict=True)
        return True
    except Exception:
        return False


def load_image_rgb(path: str) -> np.ndarray:
    """Decode a JPEG, PNG, GIF, BMP, TIFF or WebP file to uint8 RGB [H, W, 3]."""
    with open(path, "rb") as f:
        return decode_image(f.read())


def preprocess_uint8(img: np.ndarray, size: int = 224) -> np.ndarray:
    """Resize only; keep uint8 for cheap host->device transfer."""
    if img.shape[0] != size or img.shape[1] != size:
        img = jpeg.resize_bilinear(img, size)
    return img


def load_resized_uint8(path: str, size: int) -> np.ndarray:
    """Decode + resize to uint8 [size, size, 3], as the JAX package gives
    it: a JPEG of 1 or 3 components as its native pipe does, any other
    image as its PIL fallback does."""
    with open(path, "rb") as f:
        data = f.read()
    if (image_format(data) == "jpeg" and jpeg.component_count(data) in (1, 3)
            and not jpeg.is_lossless(data)):
        return jpeg.decode_resize(data, size)
    img = decode_image(data)
    if img.shape[0] != size or img.shape[1] != size:
        img = resize_bilinear_pil(img, size)
    return img


def _pil_taps(src: int, dst: int):
    """PIL's bilinear ``precompute_coeffs`` and ``normalize_coeffs_8bpc``:
    per output index the first source index and the taps as integers of
    22 fractional bits, [dst, ksize] int64."""
    scale = src / dst
    support = max(scale, 1.0)
    ksize = int(np.ceil(support)) * 2 + 1
    lo = np.zeros(dst, np.int64)
    taps = np.zeros((dst, ksize), np.int64)
    for x in range(dst):
        center = (x + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), src) - xmin
        w = [max(0.0, 1.0 - abs((i + xmin - center + 0.5) / support)) for i in range(xmax)]
        total = sum(w)
        for i, wi in enumerate(w):
            wi = wi / total if total != 0.0 else wi
            taps[x, i] = int(-0.5 + wi * (1 << 22)) if wi < 0 else int(0.5 + wi * (1 << 22))
        lo[x] = xmin
    return lo, taps


def _pil_pass(img: np.ndarray, size: int, axis: int) -> np.ndarray:
    """One of PIL's 8-bit resampling passes along ``axis`` (0 rows, 1
    columns): integer taps, a rounding half added, >> 22, clipped."""
    n = img.shape[axis]
    lo, taps = _pil_taps(n, size)
    src = np.moveaxis(img.astype(np.int64), axis, 0)
    acc = np.full((size,) + src.shape[1:], 1 << 21, np.int64)
    for i in range(taps.shape[1]):
        acc += taps[:, i].reshape((size,) + (1,) * (src.ndim - 1)) * src[np.minimum(lo + i, n - 1)]
    return np.moveaxis(np.clip(acc >> 22, 0, 255).astype(np.uint8), 0, axis)


def resize_bilinear_pil(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 [H, W, 3] -> uint8 [size, size, 3] as PIL's
    ``Image.resize((size, size), BILINEAR)`` gives it: the horizontal pass,
    then the vertical one, each skipped where that side keeps its size."""
    if img.shape[1] != size:
        img = _pil_pass(img, size, 1)
    if img.shape[0] != size:
        img = _pil_pass(img, size, 0)
    return img


def preprocess_image(img: np.ndarray, size: int = 224) -> np.ndarray:
    """uint8 [H, W, 3] -> float32 CLIP-normalized [size, size, 3] (the
    serving worker's path; PIL's resize)."""
    if img.shape[0] != size or img.shape[1] != size:
        img = resize_bilinear_pil(img, size)
    x = img.astype(np.float32) / np.float32(255.0)
    return (x - np.asarray(FLAMINGO_MEAN, np.float32)) / np.asarray(FLAMINGO_STD, np.float32)


def normalize_on_device(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [..., H, W, 3] -> CLIP-normalized ``dtype`` on x's device
    (computed in float32, then cast)."""
    mean = torch.tensor(FLAMINGO_MEAN, device=x.device)
    std = torch.tensor(FLAMINGO_STD, device=x.device)
    return ((x.float() / 255.0 - mean) / std).to(dtype)
