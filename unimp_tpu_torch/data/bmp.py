"""BMP decoder: PIL's ``Image.open(...).convert("RGB")`` of a Windows or
OS/2 bitmap, in numpy.

Headers of 12 (OS/2, 3-byte palette entries) and 40 to 124 bytes;
bottom-up rows, or top-down when the height is negative. 1, 4 and 8 bits
a pixel through the palette (an index past it is black), 16 bits as
5-5-5, 24 as BGR, 32 as BGRX; RLE8 and RLE4; BITFIELDS with the masks PIL
takes (5-6-5 and 5-5-5 at 16 bits, BGR at 24, the byte-aligned orders at
32), others raise as PIL raises. Channels of fewer than 8 bits scale as
``v * 255 // max``; alpha is dropped.

PIL's readings are kept where they are its own: a palette that is the
grey ramp (black and white for two colours) makes the image grey, read
at 8 bits (1 bit for two colours) whatever the header says (a 4-bit file
over a 16-grey ramp, which PIL reads past its rows, and RLE over a
black-and-white palette raise); the pixel data starts after the palette
when the header points at the palette; RLE's delta escape skips by the
second pair of the four bytes it reads; RLE4's absolute run of an odd
count drops its last pixel; the absolute run's padding follows the file
offset.

Pixel data that ends early leaves the remaining rows zero, as PIL does
with ``LOAD_TRUNCATED_IMAGES``; with ``strict`` it raises instead.
"""

from __future__ import annotations

import numpy as np

# BITFIELDS masks PIL takes: (bits, masks) -> the channel order of its raw mode
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_RAW = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR", 32: "BGRX"}


def _u16(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 2], "little")


def _u32(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 4], "little")


def _unpack(rows: np.ndarray, raw: str, width: int) -> np.ndarray:
    """[H, stride] uint8 rows -> [H, W] indices or [H, W, 3] RGB."""
    if raw in ("P;1", "1"):
        idx = np.unpackbits(rows, axis=1)[:, :width]
        return idx * np.uint8(255) if raw == "1" else idx
    if raw == "P;4":
        return np.stack([rows >> 4, rows & 15], axis=2).reshape(len(rows), -1)[:, :width]
    if raw in ("P", "L"):
        return rows[:, :width]
    if raw.startswith("BGR;"):
        v = rows[:, :2 * width].reshape(len(rows), width, 2).astype(np.int32)
        v = v[..., 0] | (v[..., 1] << 8)
        if raw == "BGR;16":
            r, g, b = (v >> 11) & 31, (v >> 5) & 63, v & 31
            return np.stack([r * 255 // 31, g * 255 // 63, b * 255 // 31], 2).astype(np.uint8)
        r, g, b = (v >> 10) & 31, (v >> 5) & 31, v & 31
        return np.stack([r * 255 // 31, g * 255 // 31, b * 255 // 31], 2).astype(np.uint8)
    px = rows[:, :len(raw) * width].reshape(len(rows), width, len(raw))
    return np.stack([px[..., raw.index(c)] for c in "RGB"], axis=2)


def _rle(data: bytes, start: int, width: int, height: int, rle4: bool) -> bytes:
    """PIL's ``BmpRleDecoder`` from file offset ``start``: rows of
    ``width`` indices, in file order."""
    out = bytearray()
    x, i, n, need = 0, start, len(data), width * height
    while len(out) < need:
        if i + 2 > n:
            break
        count, byte = data[i], data[i + 1]
        i += 2
        if count:  # encoded run
            count = max(0, width - x) if x + count > width else count
            if rle4:
                pair = (byte >> 4, byte & 15)
                out += bytes(pair[k % 2] for k in range(count))
            else:
                out += bytes((byte,)) * count
            x += count
        elif byte == 0:  # end of line
            out += b"\x00" * ((-len(out)) % width)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: PIL reads two bytes, then skips by the next two
            if i + 2 > n:
                break
            if i + 4 > n:
                raise ValueError("BMP RLE delta cut short")
            right, up = data[i + 2], data[i + 3]
            i += 4
            out += b"\x00" * (right + up * width)
            x = len(out) % width
        else:  # absolute run
            nbytes = byte // 2 if rle4 else byte
            chunk = data[i:i + nbytes]
            i += len(chunk)
            if rle4:
                out += bytes(v for b in chunk for v in (b >> 4, b & 15))
            else:
                out += chunk
            if len(chunk) < nbytes:
                break
            x += byte
            if i % 2:
                i += 1
    return bytes(out)


def decode_bmp(data: bytes, strict: bool = False) -> np.ndarray:
    """BMP bytes -> uint8 RGB [H, W, 3]."""
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    offset = _u32(data, 10)
    header = _u32(data, 14)
    info = data[18:14 + header]
    pos = 14 + header
    masks = None
    if header == 12:
        width, height = _u16(info, 0), _u16(info, 2)
        bits, compression, pad, flip = _u16(info, 6), 0, 3, False
        colors = 0
    elif header in (40, 52, 56, 64, 108, 124):
        flip = info[7] == 0xFF
        width = _u32(info, 0)
        height = 2**32 - _u32(info, 4) if flip else _u32(info, 4)
        bits, compression = _u16(info, 10), _u32(info, 12)
        colors, pad = _u32(info, 28), 4
        if compression == 3:
            if len(info) >= 48:
                masks = [_u32(info, 36 + 4 * k) for k in range(4 if len(info) >= 52 else 3)]
                masks += [0] * (4 - len(masks))
            else:
                masks = [_u32(data, pos + 4 * k) for k in range(3)] + [0]
                pos += 12
    else:
        raise ValueError(f"unsupported BMP header type ({header})")
    colors = colors or (1 << bits)
    if offset == 14 + header and bits <= 8:
        offset += 4 * colors
    if bits not in _RAW:
        raise ValueError(f"unsupported BMP pixel depth ({bits})")
    raw = _RAW[bits]
    if compression == 3:
        key = (bits, tuple(masks)) if bits == 32 else (bits, tuple(masks[:3]))
        if key not in _MASK_MODES:
            raise ValueError("unsupported BMP bitfields layout")
        raw = _MASK_MODES[key]
    elif compression not in (0, 1, 2):
        raise ValueError(f"unsupported BMP compression ({compression})")
    lut = None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"unsupported BMP palette size ({colors})")
        pal = data[pos:pos + pad * colors]
        grey = all(pal[k * pad:k * pad + 3] == bytes((v,)) * 3 for k, v in
                   enumerate((0, 255) if colors == 2 else range(colors)))
        if grey:
            raw = "1" if colors == 2 else "L"
            if raw == "L" and bits < 8:
                raise ValueError("a 4-bit BMP over a grey-ramp palette (PIL reads it at 8 bits)")
        else:
            entries = np.frombuffer(pal[:len(pal) // pad * pad], np.uint8).reshape(-1, pad)
            lut = np.zeros((256, 3), np.uint8)
            lut[:min(256, len(entries))] = entries[:256, 2::-1]
    if compression in (1, 2):
        px = _rle(data, offset, width, height, compression == 2)
        if len(px) < width * height:
            raise ValueError("not enough image data in the BMP's RLE stream")
        img = np.frombuffer(px[:width * height], np.uint8).reshape(height, width)
        img = img if flip else img[::-1]
        if raw == "1":
            raise ValueError("RLE data over a black-and-white palette")
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        body = data[offset:offset + stride * height]
        rows = len(body) // stride if stride else 0
        if strict and rows < height:
            raise ValueError("truncated BMP (the pixel data ends early)")
        # rows the data does not reach stay zero; bottom-up files fill from the last row
        block = np.zeros((height, stride), np.uint8)
        got = np.frombuffer(body[:rows * stride], np.uint8).reshape(rows, stride)
        if flip:
            block[:rows] = got
        elif rows:
            block[height - rows:] = got[::-1]
        img = _unpack(block, raw, width)
    if img.ndim == 3:
        return np.ascontiguousarray(img)
    if raw == "L" or lut is None:
        return np.repeat(img[:, :, None], 3, axis=2)
    return lut[img]
