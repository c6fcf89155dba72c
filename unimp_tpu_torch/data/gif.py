"""GIF decoder: the first frame as PIL's ``Image.open(...).convert("RGB")``
gives it, in numpy.

The frame's colour table (its own, else the file's global one) maps each
LZW-coded index to RGB; an index past the table's end is black, and a
table that is the identity grey ramp is no table (PIL then reads the
indices as grey levels, which the ramp gives too, past its end as well).
Interlaced frames are put back in row order. The canvas is the logical
screen, grown to hold the frame; outside the frame it holds index 0, or
the transparency index when the frame's graphic control extension sets
one. The transparency itself is dropped, as ``convert("RGB")`` drops it.

Data that ends before the frame is full (a cut file) leaves the rest of
the canvas as it was, as PIL does with ``LOAD_TRUNCATED_IMAGES``; with
``strict`` it raises instead, as PIL does without that flag.
"""

from __future__ import annotations

import numpy as np

SIGNATURES = (b"GIF87a", b"GIF89a")


def _palette_needed(p: bytes) -> bool:
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2]) for i in range(0, len(p), 3))


def _sub_blocks(data: bytes, i: int):
    """The concatenated payload of the sub-blocks from ``i``, the offset
    after their terminator, and whether the data ended before it."""
    out = bytearray()
    n = len(data)
    while i < n:
        size = data[i]
        i += 1
        if size == 0:
            return bytes(out), i, False
        out += data[i:i + size]
        i += size
    return bytes(out), i, True


def _lzw(data: bytes, min_size: int, count: int) -> np.ndarray:
    """Up to ``count`` indices of GIF's variable-width LZW stream."""
    clear = 1 << min_size
    eoi = clear + 1
    out = bytearray()
    table = [bytes((i,)) for i in range(clear)] + [b"", b""]
    size, nxt, prev = min_size + 1, clear + 2, None
    acc = nbits = pos = 0
    n = len(data)
    while len(out) < count:
        while nbits < size and pos < n:
            acc |= data[pos] << nbits
            nbits += 8
            pos += 1
        if nbits < size:
            break
        code = acc & ((1 << size) - 1)
        acc >>= size
        nbits -= size
        if code == clear:
            del table[clear + 2:]
            size, nxt, prev = min_size + 1, clear + 2, None
            continue
        if code == eoi:
            break
        if code < nxt:
            entry = table[code]
            if prev is not None and nxt < 4096:
                table.append(prev + entry[:1])
                nxt += 1
        elif code == nxt and prev is not None:
            entry = prev + prev[:1]
            if nxt < 4096:
                table.append(entry)
                nxt += 1
        else:
            break  # a code the table does not hold yet: the data is broken
        out += entry
        prev = entry
        if nxt == 1 << size and size < 12:
            size += 1
    return np.frombuffer(bytes(out[:count]), np.uint8)


def decode_gif(data: bytes, strict: bool = False) -> np.ndarray:
    """GIF bytes -> uint8 RGB [H, W, 3] of the first frame."""
    if data[:6] not in SIGNATURES:
        raise ValueError("not a GIF file")
    width = int.from_bytes(data[6:8], "little")
    height = int.from_bytes(data[8:10], "little")
    flags = data[10]
    i = 13
    palette = None
    if flags & 0x80:
        p = data[i:i + (3 << ((flags & 7) + 1))]
        i += len(p)
        if _palette_needed(p):
            palette = p
    transparency = None
    n = len(data)
    while True:
        if i >= n or data[i] == 0x3B:
            raise ValueError("image not found in GIF file")
        kind = data[i]
        i += 1
        if kind == 0x21:  # extension: a label, then sub-blocks
            label = data[i]
            block_size = data[i + 1] if i + 1 < n else 0
            if label == 0xF9 and block_size and data[i + 2] & 1:
                transparency = data[i + 5]
            _, i, _ = _sub_blocks(data, i + 1)
        elif kind == 0x2C:  # image descriptor
            x0, y0, w, h = (int.from_bytes(data[i + 2 * k:i + 2 * k + 2], "little")
                            for k in range(4))
            fflags = data[i + 8]
            i += 9
            if fflags & 0x80:
                p = data[i:i + (3 << ((fflags & 7) + 1))]
                i += len(p)
                palette = p if _palette_needed(p) else None
            min_size = data[i]
            payload, _, _ = _sub_blocks(data, i + 1)
            break
        # any other byte between blocks is skipped, as PIL skips it
    width, height = max(width, x0 + w), max(height, y0 + h)
    canvas = np.full((height, width), transparency or 0, np.uint8)
    idx = _lzw(payload, min_size, w * h)
    if strict and len(idx) < w * h:
        raise ValueError("truncated GIF (the frame's data ends early)")
    rows = np.arange(h)
    if fflags & 0x40:  # interlaced: rows 0, 8, ..; 4, 12, ..; 2, 6, ..; 1, 3, ..
        rows = np.concatenate([np.arange(s, h, step) for s, step in
                               ((0, 8), (4, 8), (2, 4), (1, 2))])
    full, rest = divmod(len(idx), w) if w else (0, 0)
    frame = canvas[y0:y0 + h, x0:x0 + w]
    frame[rows[:full]] = idx[:full * w].reshape(full, w)
    if rest:
        frame[rows[full], :rest] = idx[full * w:]
    if palette is None:
        return np.repeat(canvas[:, :, None], 3, axis=2)
    lut = np.zeros((256, 3), np.uint8)
    colours = np.frombuffer(palette, np.uint8).reshape(-1, 3)[:256]
    lut[:len(colours)] = colours
    return lut[canvas]
