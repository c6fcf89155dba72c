"""WebP decoder in numpy, as PIL reads a WebP and converts it to RGB.

The JAX package reads any image through PIL (``unimp_tpu/data/
transforms.py``), whose WebP reader is libwebp's animation decoder: the
first frame composited on a transparent canvas, then ``convert("RGB")``
drops the alpha. The card's machine has no PIL, so the port decodes:

  * the RIFF container: simple ``VP8 `` and ``VP8L``, extended ``VP8X``
    with an ``ALPH`` chunk (raw or VP8L-compressed, with its horizontal,
    vertical and gradient filters), and an animation's first ``ANMF``
    frame placed on its canvas;
  * VP8L lossless (RFC 9649): the predictor, colour, subtract-green and
    colour-indexing transforms, the colour cache, meta prefix codes and
    LZ77 backward references;
  * VP8 lossy (RFC 6386) as libwebp decodes it: the boolean decoder,
    segment and loop-filter headers, intra prediction, the inverse WHT
    and DCT, the simple and normal loop filters, then libwebp's "fancy"
    chroma upsampling and fixed-point YUV -> RGB (``yuv.h``).
"""

from __future__ import annotations

import struct

import numpy as np

UNREAD = "is not read by the port (ROADMAP.md §3, fault 5)"


# ---------------------------------------------------------------- VP8L

class _BitReader:
    """LSB-first bits (VP8L)."""

    def __init__(self, data: bytes):
        self.v = int.from_bytes(data, "little")
        self.pos = 0
        self.n = 8 * len(data)

    def read(self, n: int) -> int:
        if not n:
            return 0
        v = (self.v >> self.pos) & ((1 << n) - 1)
        self.pos += n
        return v


class _Prefix:
    """A canonical prefix code, read MSB of the code first."""

    def __init__(self, lengths):
        self.single = None
        nonzero = [i for i, n in enumerate(lengths) if n]
        if len(nonzero) == 1:
            self.single = nonzero[0]
            return
        if not nonzero:
            raise ValueError("corrupt WebP: an empty prefix code")
        self.table = {}
        code = 0
        maxlen = max(lengths)
        for n in range(1, maxlen + 1):
            for sym, ln in enumerate(lengths):
                if ln == n:
                    self.table[(n, code)] = sym
                    code += 1
            code <<= 1
        self.maxlen = maxlen

    def read(self, br: _BitReader) -> int:
        if self.single is not None:
            return self.single
        code, v, pos = 0, br.v, br.pos
        table = self.table
        for n in range(1, self.maxlen + 1):
            code = (code << 1) | ((v >> pos) & 1)
            pos += 1
            sym = table.get((n, code))
            if sym is not None:
                br.pos = pos
                return sym
        raise ValueError("corrupt WebP: bad prefix code")


_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# distance codes 1..120 -> (x, y) offsets (RFC 9649 §4.2.2)
_DIST_MAP = (
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2), (2, 1), (-2, 1), (2, 2),
    (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3), (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2),
    (0, 4), (4, 0), (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4), (4, 2),
    (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0), (1, 5), (-1, 5), (5, 1), (-5, 1),
    (2, 5), (-2, 5), (5, 2), (-5, 2), (4, 4), (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6),
    (6, 0), (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2), (4, 5), (-4, 5),
    (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3), (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5),
    (-5, 5), (7, 1), (-7, 1), (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2),
    (3, 7), (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5), (8, 0), (4, 7), (-4, 7),
    (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6), (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5),
    (8, 4), (6, 7), (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7))


def _read_code(br: _BitReader, alphabet: int) -> _Prefix:
    if br.read(1):  # simple code: one or two symbols
        n = br.read(1) + 1
        lengths = [0] * alphabet
        first = br.read(1 + 7 * br.read(1))
        lengths[first] = 1
        if n == 2:
            lengths[br.read(8)] = 1
        return _Prefix(lengths)
    cl = [0] * 19
    for i in range(4 + br.read(4)):
        cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
    clcode = _Prefix(cl)
    max_symbol = alphabet
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            raise ValueError("corrupt WebP: code length count")
    lengths, prev, sym = [0] * alphabet, 8, 0
    while sym < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        c = clcode.read(br)
        if c < 16:
            lengths[sym] = c
            sym += 1
            if c:
                prev = c
        else:
            extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
            rep = br.read(extra) + offset
            if sym + rep > alphabet:
                raise ValueError("corrupt WebP: code lengths overflow")
            val = prev if c == 16 else 0
            lengths[sym:sym + rep] = [val] * rep
            sym += rep
    return _Prefix(lengths)


def _prefix_value(br: _BitReader, p: int) -> int:
    if p < 4:
        return p + 1
    extra = (p - 2) >> 1
    return ((2 + (p & 1)) << extra) + br.read(extra) + 1


def _read_image(br: _BitReader, w: int, h: int, main: bool) -> list:
    """An entropy-coded image of w x h ARGB pixels (a list of ints)."""
    cache_bits = br.read(4) if br.read(1) else 0
    if cache_bits > 11:
        raise ValueError("corrupt WebP: colour cache bits")
    groups_img, gbits = None, 0
    if main and br.read(1):  # meta prefix codes: a group a block of 2^gbits
        gbits = br.read(3) + 2
        groups_img = [(p >> 8) & 0xFFFF for p in _read_image(
            br, -(-w // (1 << gbits)), -(-h // (1 << gbits)), False)]
    n_groups = max(groups_img) + 1 if groups_img else 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    groups = [[_read_code(br, a) for a in (256 + 24 + cache_size, 256, 256, 256, 40)]
              for _ in range(n_groups)]
    out = [0] * (w * h)
    cache = [0] * cache_size
    shift = 32 - cache_bits
    gw = -(-w // (1 << gbits)) if groups_img else 0
    pos, total = 0, w * h
    last_cached = 0
    while pos < total:
        if groups_img:
            y, x = divmod(pos, w)
            g = groups[groups_img[(y >> gbits) * gw + (x >> gbits)]]
        else:
            g = groups[0]
        code = g[0].read(br)
        if code < 256:
            red, blue, alpha = g[1].read(br), g[2].read(br), g[3].read(br)
            out[pos] = (alpha << 24) | (red << 16) | (code << 8) | blue
            pos += 1
        elif code < 280:
            length = _prefix_value(br, code - 256)
            dcode = _prefix_value(br, g[4].read(br))
            if dcode > 120:
                dist = dcode - 120
            else:
                dx, dy = _DIST_MAP[dcode - 1]
                dist = max(1, dx + dy * w)
            if dist > pos or pos + length > total:
                raise ValueError("corrupt WebP: backward reference out of the image")
            for k in range(length):
                out[pos + k] = out[pos + k - dist]
            pos += length
        else:
            idx = code - 280
            if idx >= cache_size:
                raise ValueError("corrupt WebP: colour cache index")
            while last_cached < pos:  # fill the cache up to here
                p = out[last_cached]
                cache[((p * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = p
                last_cached += 1
            out[pos] = cache[idx]
            pos += 1
        if cache_size:
            while last_cached < pos:
                p = out[last_cached]
                cache[((p * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = p
                last_cached += 1
    return out


def _argb(pixels, w, h) -> np.ndarray:
    """[h, w, 4] int64 as (a, r, g, b)."""
    p = np.asarray(pixels, np.int64).reshape(h, w)
    return np.stack([(p >> 24) & 255, (p >> 16) & 255, (p >> 8) & 255, p & 255], -1)


def _avg2(a, b):
    return (a + b) >> 1


def _predict(img: np.ndarray, modes: np.ndarray, bits: int) -> np.ndarray:
    """The inverse predictor transform, in place on [h, w, 4] residuals."""
    h, w, _ = img.shape
    out = img.tolist()
    mw = modes.shape[1]
    for y in range(h):
        row = out[y]
        up = out[y - 1] if y else None
        for x in range(w):
            px = row[x]
            if y == 0:
                pred = (255, 0, 0, 0) if x == 0 else row[x - 1]
            elif x == 0:
                pred = up[0]
            else:
                m = int(modes[y >> bits, x >> bits]) if mw else 0
                L, T, TL = row[x - 1], up[x], up[x - 1]
                TR = up[x + 1] if x + 1 < w else row[0]
                if m == 0:
                    pred = (255, 0, 0, 0)
                elif m == 1:
                    pred = L
                elif m == 2:
                    pred = T
                elif m == 3:
                    pred = TR
                elif m == 4:
                    pred = TL
                elif m == 5:
                    pred = [_avg2(_avg2(a, c), b) for a, b, c in zip(L, T, TR)]
                elif m == 6:
                    pred = [_avg2(a, b) for a, b in zip(L, TL)]
                elif m == 7:
                    pred = [_avg2(a, b) for a, b in zip(L, T)]
                elif m == 8:
                    pred = [_avg2(a, b) for a, b in zip(TL, T)]
                elif m == 9:
                    pred = [_avg2(a, b) for a, b in zip(T, TR)]
                elif m == 10:
                    pred = [_avg2(_avg2(a, b), _avg2(c, d)) for a, b, c, d in zip(L, TL, T, TR)]
                elif m == 11:
                    d = sum(abs(a - c) - abs(b - c) for a, b, c in zip(L, T, TL))
                    pred = T if d <= 0 else L
                elif m == 12:
                    pred = [min(255, max(0, a + b - c)) for a, b, c in zip(L, T, TL)]
                else:
                    pred = [min(255, max(0, a + int((a - c) / 2)))
                            for a, c in zip([_avg2(p, q) for p, q in zip(L, T)], TL)]
            row[x] = [(p + q) & 255 for p, q in zip(px, pred)]
    return np.asarray(out, np.int64)


def _color_inverse(img: np.ndarray, elems: np.ndarray, bits: int) -> np.ndarray:
    h, w, _ = img.shape
    e = elems[np.arange(h)[:, None] >> bits, np.arange(w)[None, :] >> bits]
    g2r, g2b, r2b = (e[..., 3] ^ 128) - 128, (e[..., 2] ^ 128) - 128, (e[..., 1] ^ 128) - 128
    g = (img[..., 2] ^ 128) - 128
    red = (img[..., 1] + ((g2r * g) >> 5)) & 255
    blue = img[..., 3] + ((g2b * g) >> 5)
    blue = (blue + ((r2b * ((red ^ 128) - 128)) >> 5)) & 255
    out = img.copy()
    out[..., 1], out[..., 3] = red, blue
    return out


def decode_vp8l(data: bytes) -> np.ndarray:
    """A VP8L bitstream -> [h, w, 4] uint8 RGBA."""
    br = _BitReader(data)
    if br.read(8) != 0x2F:
        raise ValueError("corrupt WebP: no VP8L signature")
    w, h = br.read(14) + 1, br.read(14) + 1
    br.read(1)  # alpha hint
    if br.read(3):
        raise ValueError("corrupt WebP: VP8L version")
    return _vp8l_pixels(br, w, h)


def _vp8l_pixels(br: _BitReader, w: int, h: int) -> np.ndarray:
    transforms, xsize = [], w
    while br.read(1):
        kind = br.read(2)
        if kind in (0, 1):
            bits = br.read(3) + 2
            sub = _read_image(br, -(-xsize // (1 << bits)), -(-h // (1 << bits)), False)
            transforms.append((kind, bits, _argb(sub, -(-xsize // (1 << bits)),
                                                 -(-h // (1 << bits)))))
        elif kind == 2:
            transforms.append((2, 0, None))
        else:
            n = br.read(8) + 1
            table = _argb(_read_image(br, n, 1, False), n, 1)[0]
            table = np.cumsum(table, axis=0) & 255
            wbits = 3 if n <= 2 else 2 if n <= 4 else 1 if n <= 16 else 0
            transforms.append((3, wbits, (table, xsize)))
            xsize = -(-xsize // (1 << wbits))
    img = _argb(_read_image(br, xsize, h, True), xsize, h)
    for kind, bits, extra in reversed(transforms):
        if kind == 0:
            img = _predict(img, extra[..., 2] & 15, bits)
        elif kind == 1:
            img = _color_inverse(img, extra, bits)
        elif kind == 2:
            img[..., 1] = (img[..., 1] + img[..., 2]) & 255
            img[..., 3] = (img[..., 3] + img[..., 2]) & 255
        else:
            table, width = extra
            full = np.zeros((256, 4), np.int64)
            full[:len(table)] = table
            idx = img[..., 2]
            if bits:
                per = 1 << bits
                bpp = 8 >> bits
                k = np.arange(width) % per
                idx = (idx[:, np.arange(width) // per] >> (k * bpp)) & ((1 << bpp) - 1)
            img = full[idx]
    a, r, g, b = np.moveaxis(img, -1, 0)
    return np.stack([r, g, b, a], -1).astype(np.uint8)


# ---------------------------------------------------------------- container

def _chunks(data: bytes, start: int = 12):
    i = start
    while i + 8 <= len(data):
        tag, size = data[i:i + 4], struct.unpack_from("<I", data, i + 4)[0]
        yield tag, data[i + 8:i + 8 + size]
        i += 8 + size + (size & 1)


def _alpha(chunk: bytes, w: int, h: int) -> np.ndarray:
    """An ALPH chunk -> [h, w] uint8 (libwebp's ``alpha_dec.c``)."""
    head = chunk[0]
    method, filt = head & 3, (head >> 2) & 3
    if method == 0:
        a = np.frombuffer(chunk, np.uint8, w * h, 1).reshape(h, w).astype(np.int64)
    elif method == 1:
        br = _BitReader(chunk[1:])
        a = _vp8l_pixels(br, w, h)[..., 1].astype(np.int64)
    else:
        raise ValueError(f"WebP alpha compression {method} " + UNREAD)
    if filt:
        a = _unfilter(a, filt)
    return a.astype(np.uint8)


def _unfilter(a: np.ndarray, filt: int) -> np.ndarray:
    """Undo the alpha plane's horizontal (1), vertical (2) or gradient (3)
    filter (``filters.c``): the first row and column are left-predicted
    (top for the first column), then each mode."""
    h, w = a.shape
    out = a.copy()
    out[0] = np.cumsum(out[0]) & 255
    for y in range(1, h):
        prev = out[y - 1]
        row = out[y]
        if filt == 1:
            row[0] = (row[0] + prev[0]) & 255
            row[:] = np.cumsum(row) & 255
        elif filt == 2:
            row[:] = (row + prev) & 255
        else:
            row[0] = (row[0] + prev[0]) & 255
            for x in range(1, w):
                pred = min(255, max(0, int(row[x - 1]) + int(prev[x]) - int(prev[x - 1])))
                row[x] = (row[x] + pred) & 255
    return out


def decode_webp(data: bytes, strict: bool = False) -> np.ndarray:
    """WebP bytes -> uint8 RGB [H, W, 3], as PIL's ``convert("RGB")`` gives
    the first frame. A file cut short raises either way, as PIL refuses
    one with or without ``LOAD_TRUNCATED_IMAGES`` (``strict`` is the other
    decoders' flag)."""
    return decode_webp_rgba(data)[..., :3]


def decode_webp_rgba(data: bytes) -> np.ndarray:
    """WebP bytes -> uint8 RGBA [H, W, 4] of the first frame on its canvas,
    as libwebp's animation decoder gives it to PIL (not premultiplied;
    outside the frame transparent black)."""
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP")
    if len(data) < 8 + struct.unpack_from("<I", data, 4)[0]:
        raise ValueError("truncated WebP (the file is shorter than its RIFF size)")
    chunks = list(_chunks(data))
    first = chunks[0][0] if chunks else b""
    if first in (b"VP8L", b"VP8 "):
        return _frame(chunks[:1])
    if first != b"VP8X":
        raise ValueError("corrupt WebP: no VP8, VP8L or VP8X chunk")
    vp8x = chunks[0][1]
    cw = int.from_bytes(vp8x[4:7], "little") + 1
    ch = int.from_bytes(vp8x[7:10], "little") + 1
    for tag, body in chunks[1:]:
        if tag == b"ANMF":  # the first frame, placed on a transparent canvas
            x0 = 2 * int.from_bytes(body[0:3], "little")
            y0 = 2 * int.from_bytes(body[3:6], "little")
            rgba = _frame(list(_chunks(body, 16)))
            canvas = np.zeros((ch, cw, 4), np.uint8)
            fh, fw = min(rgba.shape[0], ch - y0), min(rgba.shape[1], cw - x0)
            canvas[y0:y0 + fh, x0:x0 + fw] = rgba[:fh, :fw]
            return canvas
        if tag in (b"VP8 ", b"VP8L", b"ALPH"):
            return _frame([(t, b) for t, b in chunks[1:] if t in (b"VP8 ", b"VP8L", b"ALPH")])
    raise ValueError("corrupt WebP: VP8X without an image")


def _frame(chunks) -> np.ndarray:
    """The RGBA of one image: VP8L, or VP8 with its ALPH chunk (opaque
    without one)."""
    from unimp_tpu_torch.data.vp8 import decode_vp8

    alph = next((b for t, b in chunks if t == b"ALPH"), None)
    for tag, body in chunks:
        if tag == b"VP8L":
            return decode_vp8l(body)
        if tag == b"VP8 ":
            rgb = decode_vp8(body)
            h, w = rgb.shape[:2]
            a = _alpha(alph, w, h) if alph is not None else np.full((h, w), 255, np.uint8)
            return np.concatenate([rgb, a[..., None]], -1)
    raise ValueError("corrupt WebP: a frame without an image")
