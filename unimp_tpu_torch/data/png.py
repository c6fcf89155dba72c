"""PNG decoder (and a plain RGB writer) in numpy and the standard library's ``zlib``.

The JAX package reads PNG item images through PIL (``unimp_tpu/data/
transforms.py:19-25``), which the card's machine does not have. This
decoder gives what ``np.asarray(Image.open(f).convert("RGB"))`` gives:
every colour type (0 gray, 2 RGB, 3 palette, 4 gray + alpha, 6 RGBA), bit
depths 1, 2 and 4 (gray and palette), 8 and 16, the five scanline filters,
Adam7 interlacing; ``tRNS`` and alpha are dropped, as ``convert("RGB")``
drops them. PIL's own conversions are kept where they are not the obvious
ones: gray below 8 bits is scaled to 0-255 (1 bit: 0 / 255, 2 bits: x 85,
4 bits: x 17), 16-bit gray is clipped to 255 (PIL's "I;16" -> "RGB"), and
16-bit colour keeps each sample's high byte.
"""

from __future__ import annotations

import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (row start, column start, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
          (1, 0, 2, 1))


def _chunks(data: bytes):
    """Yield (type, payload) up to IEND."""
    i = len(SIGNATURE)
    while i + 8 <= len(data):
        n = int.from_bytes(data[i:i + 4], "big")
        kind = data[i + 4:i + 8]
        yield kind, data[i + 8:i + 8 + n]
        if kind == b"IEND":
            return
        i += 12 + n


def _unfilter(raw: np.ndarray, rows: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (0 none, 1 sub, 2 up, 3 average, 4
    Paeth) of ``rows`` lines of ``row_bytes`` bytes, ``bpp`` bytes a pixel
    (at least 1); returns uint8 [rows, row_bytes]."""
    lines = raw[:rows * (row_bytes + 1)].reshape(rows, row_bytes + 1)
    out = np.zeros((rows, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.int64)
    for r in range(rows):
        kind, x = int(lines[r, 0]), lines[r, 1:].astype(np.int64)
        if kind == 0:
            cur = x
        elif kind == 1:  # each byte plus the one bpp to its left: a sum by channel
            cur = np.zeros(row_bytes, np.int64)
            for c in range(bpp):
                cur[c::bpp] = np.cumsum(x[c::bpp]) & 0xFF
        elif kind == 2:
            cur = (x + prev) & 0xFF
        elif kind in (3, 4):  # each byte depends on the one to its left: a loop
            xs, up, row = x.tolist(), prev.tolist(), [0] * row_bytes
            for i in range(row_bytes):
                a = row[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                row[i] = (xs[i] + pred) & 0xFF
            cur = np.asarray(row, np.int64)
        else:
            raise ValueError(f"corrupt PNG: filter type {kind}")
        out[r] = cur
        prev = cur
    return out


def _samples(lines: np.ndarray, width: int, depth: int, channels: int) -> np.ndarray:
    """Unfiltered lines -> samples [rows, width, channels] (uint16 at 16
    bits, else uint8 values of ``depth`` bits)."""
    rows = lines.shape[0]
    if depth == 16:
        s = lines.view(">u2").astype(np.uint16)
    elif depth == 8:
        s = lines
    else:  # 1, 2, 4 bits, one channel: unpack MSB first
        bits = np.unpackbits(lines, axis=1).reshape(rows, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        s = (bits * weights).sum(axis=2).astype(np.uint8)
    return s[:, :width * channels].reshape(rows, width, channels)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 RGB [H, W, 3], as PIL's ``convert("RGB")`` gives
    it."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG (no signature)")
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = payload
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None or not idat:
        raise ValueError("not a complete PNG (no IHDR or no IDAT)")
    width, height = int.from_bytes(header[0:4], "big"), int.from_bytes(header[4:8], "big")
    depth, ctype, interlace = header[8], header[9], header[12]
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"PNG colour type {ctype} at {depth} bits is not valid")
    if ctype == 3 and palette is None:
        raise ValueError("corrupt PNG: a palette image without PLTE")
    channels = _CHANNELS[ctype]
    bits = channels * depth
    bpp = max(1, bits // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if interlace:
        img = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
        at = 0
        for r0, c0, dr, dc in _ADAM7:
            rows, cols = -(-(height - r0) // dr), -(-(width - c0) // dc)
            if rows <= 0 or cols <= 0:
                continue
            row_bytes = -(-cols * bits // 8)
            lines = _unfilter(raw[at:], rows, row_bytes, bpp)
            img[r0::dr, c0::dc] = _samples(lines, cols, depth, channels)
            at += rows * (row_bytes + 1)
    else:
        row_bytes = -(-width * bits // 8)
        if raw.size < height * (row_bytes + 1):
            raise ValueError("corrupt PNG: image data ends early")
        img = _samples(_unfilter(raw, height, row_bytes, bpp), width, depth, channels)
    return _to_rgb(img, ctype, depth, palette)


def _to_rgb(img: np.ndarray, ctype: int, depth: int, palette) -> np.ndarray:
    """Samples -> uint8 RGB, PIL's conversions (alpha and tRNS dropped)."""
    if ctype == 3:
        lut = np.zeros((256, 3), np.uint8)  # indices past PLTE: black
        lut[:len(palette)] = palette[:256]
        return lut[img[..., 0]]
    if depth == 16:
        # gray: PIL's "I;16" -> "RGB" clips at 255; colour: the high byte
        img = np.minimum(img, 255) if ctype == 0 else img >> 8
    elif depth < 8:
        img = img * {1: 255, 2: 85, 4: 17}[depth]
    img = img.astype(np.uint8)
    if ctype in (0, 4):
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _chunk(kind: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(kind + payload) & 0xFFFFFFFF
    return len(payload).to_bytes(4, "big") + kind + payload + crc.to_bytes(4, "big")


def encode_png(rgb: np.ndarray) -> bytes:
    """uint8 RGB [H, W, 3] -> an 8-bit RGB PNG (no filter, zlib level 6)."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb, np.uint8).reshape(h, w * 3)], axis=1)
    ihdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes((8, 2, 0, 0, 0))
    return (SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
