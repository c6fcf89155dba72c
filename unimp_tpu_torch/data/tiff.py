"""TIFF decoder in numpy, as PIL reads a TIFF and converts it to RGB.

The JAX package reads any image through PIL (``unimp_tpu/data/
transforms.py``); the card's machine has no PIL, so the port reads TIFF
itself: the first image of a classic or BigTIFF file, in strips or
tiles, chunky or planar, and gives what ``Image.open(f).convert("RGB")``
gives (PIL's mode for the file, then its conversion).

  * photometrics: bilevel and gray (white or black is zero), palette, RGB
    and RGBA (unassociated or associated alpha), CMYK, YCbCr (JPEG-coded);
    1, 2, 4, 8 and 16 bits a sample, little- or big-endian;
  * 32-bit floating-point gray samples (SampleFormat 3): PIL's mode F,
    then its F -> L conversion (0 at or below 0 and for NaN, 255 at or
    above 255, the integer part between), with or without the
    floating-point predictor (3);
  * compressions: none, PackBits, LZW (MSB codes, with or without the
    horizontal predictor), Deflate (8 and 32946, ``zlib``), LZMA (34925,
    ``lzma``), ZSTD (50000, ``data/zstd.py``), JPEG (7, with its
    JPEGTables, through ``data/jpeg.py``), CCITT modified Huffman (2),
    Group 3 (1-D and 2-D) and Group 4 (4) for bilevel images, both fill
    orders.

WebP (50001), SGILog (34676 / 34677), old-style JPEG (6) and every other
compression raise a ``ValueError`` that names it (ROADMAP.md §3, fault
5), as do floating-point samples PIL does not open (16 or 64 bits, or
more than one a pixel) and YCbCr that is not JPEG-coded.
"""

from __future__ import annotations

import lzma
import struct
import zlib

import numpy as np

from unimp_tpu_torch.data import zstd

UNREAD = "is not read by the port (ROADMAP.md §3, fault 5)"
SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")

# field type -> (struct code, size)
_TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8),
          16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
_COMPRESSIONS = {1: "none", 2: "CCITT modified Huffman", 3: "CCITT Group 3",
                 4: "CCITT Group 4", 5: "LZW", 6: "old-style JPEG", 7: "JPEG", 8: "Deflate",
                 32773: "PackBits", 32946: "Deflate", 34925: "LZMA", 50000: "ZSTD",
                 50001: "WebP", 34676: "SGILog", 34677: "SGILog24", 34712: "JPEG 2000",
                 32771: "CCITT RLE word", 34887: "LERC", 34892: "lossy JPEG (DNG)"}


def _ifd(data: bytes):
    """The first IFD's tags: {tag: tuple of values}."""
    bo = "<" if data[:2] == b"II" else ">"
    big = struct.unpack_from(bo + "H", data, 2)[0] == 43
    if big:
        off = struct.unpack_from(bo + "Q", data, 8)[0]
        count = struct.unpack_from(bo + "Q", data, off)[0]
        entry, pos, inline = 20, off + 8, 8
    else:
        off = struct.unpack_from(bo + "I", data, 4)[0]
        count = struct.unpack_from(bo + "H", data, off)[0]
        entry, pos, inline = 12, off + 2, 4
    tags = {}
    for k in range(count):
        p = pos + k * entry
        tag, typ = struct.unpack_from(bo + "HH", data, p)
        n = struct.unpack_from(bo + ("Q" if big else "I"), data, p + 4)[0]
        if typ not in _TYPES:
            continue
        code, size = _TYPES[typ]
        where = p + (12 if big else 8)
        if n * size > inline:
            where = struct.unpack_from(bo + ("Q" if big else "I"), data, where)[0]
        if typ in (2, 7):
            tags[tag] = data[where:where + n]
        else:
            vals = struct.unpack_from(f"{bo}{n * len(code)}{code[0]}", data, where)
            if typ in (5, 10):
                vals = tuple(a / b if b else 0.0 for a, b in zip(vals[::2], vals[1::2]))
            tags[tag] = vals
    return tags, bo


# ---------------------------------------------------------------- codecs

def _packbits(buf: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(buf)
    while i < n:
        c = buf[i]
        i += 1
        if c < 128:
            out += buf[i:i + c + 1]
            i += c + 1
        elif c > 128:
            if i < n:
                out += bytes([buf[i]]) * (257 - c)
            i += 1
    return bytes(out)


def _lzw(buf: bytes) -> bytes:
    """TIFF LZW: MSB-first codes of 9 to 12 bits, clear 256, end 257, the
    width growing one code early (``tif_lzw.c``)."""
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    width, acc, nbits, prev = 9, 0, 0, None
    pos, n = 0, len(buf)
    while True:
        while nbits < width:
            if pos >= n:  # the data ends without an end code
                return bytes(out)
            acc = ((acc << 8) | buf[pos]) & 0xFFFFFF
            nbits += 8
            pos += 1
        code = (acc >> (nbits - width)) & ((1 << width) - 1)
        nbits -= width
        if code == 257:
            break
        if code == 256:
            del table[258:]
            width, prev = 9, None
            continue
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        if len(table) + 1 >= (1 << width) and width < 12:
            width += 1
    return bytes(out)


# CCITT run-length codes (T.4 tables 2 and 3): run -> code string
_WHITE = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
    "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
    "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
    "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
    "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100").split()
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 "
    "011001100 011001101 011010010 011010011 011010100 011010101 011010110 011010111 "
    "011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 "
    "010011011").split()
_BLACK = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 "
    "00000100 00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 "
    "00001101100 00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 000011010111 "
    "000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
    "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 "
    "000000100100 000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 000001100111").split()
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 "
    "000000110101 0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 "
    "0000001001101 0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 "
    "0000001011011 0000001100100 0000001100101").split()
_EXT_MAKEUP = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
               "000000010101 000000010110 000000010111 000000011100 000000011101 000000011110 "
               "000000011111").split()
_MODES = {"0001": "P", "001": "H", "1": 0, "011": 1, "000011": 2, "0000011": 3, "010": -1,
          "000010": -2, "0000010": -3}
EOL = "000000000001"


def _run_table(term, makeup):
    table = {c: r for r, c in enumerate(term)}
    table.update({c: 64 * (r + 1) for r, c in enumerate(makeup)})
    table.update({c: 1792 + 64 * r for r, c in enumerate(_EXT_MAKEUP)})
    return table


_RUNS = (_run_table(_WHITE, _WHITE_MAKEUP), _run_table(_BLACK, _BLACK_MAKEUP))


class _Bits:
    def __init__(self, buf: bytes, lsb_first: bool):
        arr = np.frombuffer(buf, np.uint8)
        self.bits = "".join(map(str, np.unpackbits(arr, bitorder="little" if lsb_first
                                                   else "big").tolist()))
        self.pos = 0

    def code(self, table, longest=13):
        s, p = self.bits, self.pos
        for k in range(1, longest + 1):
            v = table.get(s[p:p + k])
            if v is not None:
                self.pos = p + k
                return v
        raise ValueError("corrupt CCITT data: bad code")

    def run(self, color):
        total = 0
        while True:
            r = self.code(_RUNS[color])
            total += r
            if r < 64:
                return total

    def skip_eol(self):
        """Fill bits and an EOL, if the data holds one here."""
        i = self.bits.find(EOL, self.pos)
        if i >= 0 and "1" not in self.bits[self.pos:i]:
            self.pos = i + len(EOL)
            return True
        return False

    def align(self):
        self.pos = -(-self.pos // 8) * 8


def _changes(row, width):
    """Positions where the colour changes, from the row's start (white)."""
    d = np.flatnonzero(np.diff(np.concatenate([[0], row])))
    return d.tolist()


def _decode_1d(bits, width):
    row = np.zeros(width, np.uint8)
    a, color = 0, 0
    while a < width:
        r = bits.run(color)
        row[a:a + r] = color
        a += r
        color ^= 1
    return row


def _decode_2d(bits, ref, width):
    """One T.6 row against the reference row's colour changes."""
    changes = _changes(ref, width) + [width, width]
    row = np.zeros(width, np.uint8)
    a0, color = -1, 0
    while a0 < width:
        start = max(a0, 0)
        # b1: the first change past a0 to the colour opposite a0's
        k = 0
        while k < len(changes) and (changes[k] <= a0 or k % 2 != color):
            k += 1
        b1 = changes[k] if k < len(changes) else width
        b2 = changes[k + 1] if k + 1 < len(changes) else width
        mode = bits.code(_MODES, 7)
        if mode == "P":
            row[start:b2] = color
            a0 = b2
        elif mode == "H":
            r1 = bits.run(color)
            r2 = bits.run(color ^ 1)
            row[start:start + r1] = color
            row[start + r1:start + r1 + r2] = color ^ 1
            a0 = start + r1 + r2
        else:
            a1 = b1 + mode
            row[start:a1] = color
            a0 = a1
            color ^= 1
    return row[:width]


def _ccitt(buf: bytes, width: int, height: int, kind: int, options: int, lsb_first: bool):
    """Rows of 0 (white) and 1 (black) runs: kind 2 modified Huffman (rows
    byte-aligned), 3 Group 3 (EOLs; 2-D rows when T4Options bit 0), 4
    Group 4 (2-D against an all-white row)."""
    bits = _Bits(buf, lsb_first)
    rows = []
    ref = np.zeros(width, np.uint8)
    for _ in range(height):
        if kind == 2:
            row = _decode_1d(bits, width)
            bits.align()
        elif kind == 3:
            bits.skip_eol()
            one_d = True
            if options & 1:
                one_d = bits.bits[bits.pos] == "1"
                bits.pos += 1
            row = _decode_1d(bits, width) if one_d else _decode_2d(bits, ref, width)
        else:
            row = _decode_2d(bits, ref, width)
        rows.append(row)
        ref = row
    return np.stack(rows)


# ---------------------------------------------------------------- decode

def _unpack(raw: bytes, rows: int, cols: int, spp: int, bps: int, bo: str) -> np.ndarray:
    """Samples [rows, cols, spp] of ``bps`` bits, rows padded to bytes."""
    if bps == 16:
        a = np.frombuffer(raw, bo + "u2", rows * cols * spp)
        return a.reshape(rows, cols, spp).astype(np.int64)
    if bps == 8:
        return np.frombuffer(raw, np.uint8, rows * cols * spp).reshape(rows, cols, spp)
    stride = -(-cols * spp * bps // 8)
    a = np.frombuffer(raw, np.uint8, rows * stride).reshape(rows, stride)
    bits = np.unpackbits(a, axis=1).reshape(rows, -1)[:, :cols * spp * bps]
    weights = 1 << np.arange(bps - 1, -1, -1)
    v = (bits.reshape(rows, cols * spp, bps) * weights).sum(-1)
    return v.reshape(rows, cols, spp).astype(np.uint8)


def _undo_predictor(a: np.ndarray, bps: int) -> np.ndarray:
    """Horizontal differencing (Predictor 2): a running sum along each row,
    modulo the sample width."""
    mod = 1 << bps
    return np.cumsum(a.astype(np.int64), axis=1) % mod


def _jpeg_chunk(chunk: bytes, tables: bytes | None) -> np.ndarray:
    """A strip or tile of a JPEG-coded TIFF, with the file's JPEGTables
    (an abbreviated stream of its DQT / DHT segments) put in front."""
    from unimp_tpu_torch.data import jpeg

    if tables and len(tables) > 4:
        chunk = chunk[:2] + tables[2:-2] + chunk[2:]
    return jpeg.decode_jpeg(chunk, inverted_cmyk=False)


def decode_tiff(data: bytes, strict: bool = False) -> np.ndarray:
    """TIFF bytes -> uint8 RGB [H, W, 3], as PIL's ``convert("RGB")``
    gives the first image. ``strict``: a strip or tile past the end of the
    file raises (PIL refuses such a file)."""
    if data[:4] not in SIGNATURES:
        raise ValueError("not a TIFF")
    try:
        tags, bo = _ifd(data)
    except struct.error:
        raise ValueError("truncated TIFF (its first directory is cut)") from None
    w, h = tags[256][0], tags[257][0]
    comp = tags.get(259, (1,))[0]
    photo = tags.get(262, (None,))[0]
    spp = tags.get(277, (1,))[0]
    bps = tags.get(258, (1,) * spp)
    fmt = tags.get(339, (1,))[0]
    planar = tags.get(284, (1,))[0]
    predictor = tags.get(317, (1,))[0]
    lsb_first = tags.get(266, (1,))[0] == 2
    if comp not in (1, 2, 3, 4, 5, 7, 8, 32773, 32946, 34925, 50000):
        raise ValueError(f"TIFF with {_COMPRESSIONS.get(comp, f'compression {comp}')} "
                         f"compression {UNREAD}")
    if fmt == 3 and (bps != (32,) or photo not in (0, 1) or comp in (2, 3, 4, 7)):
        # PIL opens 32-bit gray floats alone (mode F)
        raise ValueError(f"TIFF with {'/'.join(map(str, bps))}-bit floating-point samples, "
                         f"photometric {photo}, {UNREAD}")
    if fmt not in (1, 2, 3) or len(set(bps)) != 1 or bps[0] not in (1, 2, 4, 8, 16, 32) or (
            bps[0] == 32 and fmt != 3):
        raise ValueError(f"TIFF with {bps}-bit samples of format {fmt} {UNREAD}")
    if predictor not in ((1, 3) if fmt == 3 else (1, 2)):
        raise ValueError(f"TIFF with predictor {predictor} {UNREAD}")
    if photo == 6 and comp != 7:
        raise ValueError(f"TIFF with YCbCr samples that are not JPEG-coded {UNREAD}")
    bps = bps[0]
    if 322 in tags:
        tw, th = tags[322][0], tags[323][0]
        offsets, counts = tags[324], tags[325]
        across = -(-w // tw)
        boxes = [((k % across) * tw, (k // across) * th, tw, th) for k in range(
            across * -(-h // th))]
    else:
        rps = min(tags.get(278, (h,))[0], h)
        offsets, counts = tags[273], tags.get(279, (len(data),) * len(tags[273]))
        boxes = [(0, k * rps, w, min(rps, h - k * rps)) for k in range(-(-h // rps))]
    planes = spp if planar == 2 else 1
    per_chunk = 1 if planar == 2 else spp
    jpeg_out = comp == 7
    out_spp = 3 if jpeg_out else spp
    img = np.zeros((h, w, out_spp), np.int64)
    for p in range(planes):
        for k, (x0, y0, cw, ch) in enumerate(boxes):
            idx = p * len(boxes) + k
            if idx >= len(offsets):
                break
            off, cnt = offsets[idx], counts[idx]
            if strict and off + cnt > len(data):
                raise ValueError("truncated TIFF (a strip past the end of the file)")
            chunk = data[off:off + cnt]
            if comp in (2, 3, 4):
                opts = tags.get(292 if comp == 3 else 293, (0,))[0]
                # black runs are 1 bits, as libtiff fills them; the
                # photometric says what a 1 is, as for raw bits
                vals = _ccitt(chunk, cw, ch, comp, opts, lsb_first)[..., None]
            elif comp == 7:
                vals = _jpeg_chunk(chunk, tags.get(347))[:ch, :cw]
            else:
                if comp == 5:
                    raw = _lzw(chunk)
                elif comp in (8, 32946):
                    raw = zlib.decompressobj().decompress(chunk)
                elif comp == 32773:
                    raw = _packbits(chunk)
                elif comp == 34925:
                    raw = lzma.decompress(chunk)
                elif comp == 50000:
                    raw = zstd.decompress(chunk)
                else:
                    # PIL's raw decoder keeps whole rows of a cut strip
                    row = -(-cw * per_chunk * bps // 8)
                    raw = chunk[:len(chunk) // row * row]
                need = ch * -(-cw * per_chunk * bps // 8)
                raw = raw[:need] + bytes(max(0, need - len(raw)))
                if fmt == 3:
                    vals = _float_to_l(_floats(raw, ch, cw, bo, predictor == 3))
                else:
                    vals = _unpack(raw, ch, cw, per_chunk, bps, bo)
                if predictor == 2:
                    vals = _undo_predictor(vals, bps)
            ys, xs = slice(y0, min(y0 + ch, h)), slice(x0, min(x0 + cw, w))
            vals = vals[:ys.stop - y0, :xs.stop - x0]
            if planar == 2:
                img[ys, xs, p] = vals[..., 0]
            else:
                img[ys, xs, :vals.shape[-1]] = vals
    if fmt == 3:  # PIL's F -> L, already applied; no photometric inversion
        return np.repeat(img.astype(np.uint8), 3, axis=2)
    return _to_rgb(img, tags, photo, bps, spp, jpeg_out)


def _floats(raw: bytes, rows: int, cols: int, bo: str, predicted: bool) -> np.ndarray:
    """float32 gray samples [rows, cols, 1]. ``predicted``: libtiff's
    floating-point predictor (3): each row's bytes summed along the row
    (modulo 256), then read as byte planes, most significant first."""
    a = np.frombuffer(raw, np.uint8, rows * cols * 4).reshape(rows, cols * 4)
    if not predicted:
        return a.copy().view(bo + "f4").reshape(rows, cols, 1)
    planes = np.cumsum(a, axis=1, dtype=np.uint8).reshape(rows, 4, cols)
    return planes.transpose(0, 2, 1).copy().view(">f4").reshape(rows, cols, 1)


def _float_to_l(v: np.ndarray) -> np.ndarray:
    """PIL's F -> L: 0 at or below 0 (and NaN), 255 at or above 255, else
    the integer part."""
    v = v.astype(np.float64)
    inside = np.nan_to_num(v, nan=0.0, posinf=0.0, neginf=0.0)
    out = np.trunc(np.clip(inside, 0, 255)).astype(np.int64)
    return np.where(v >= 255, 255, np.where((v > 0) & ~np.isnan(v), out, 0))


def _to_rgb(img, tags, photo, bps, spp, jpeg_out) -> np.ndarray:
    """PIL's reading of the samples and its ``convert("RGB")``."""
    extra = tags.get(338, ())
    if jpeg_out:  # already RGB, as data/jpeg.py converts it
        return img.astype(np.uint8)
    if photo in (0, 1):  # gray, white or black is zero
        g = img[..., 0]
        top = (1 << bps) - 1
        if photo == 0:
            g = top - g
        if bps == 16:
            g = np.minimum(g, 255) if photo == 1 else np.minimum(g, 255)
        elif bps < 8:
            g = g * 255 // top
        return np.repeat(g.astype(np.uint8)[..., None], 3, axis=2)
    if photo == 3:  # palette
        cmap = np.asarray(tags[320], np.int64).reshape(3, -1) // 256
        idx = img[..., 0]
        return cmap[:, np.minimum(idx, cmap.shape[1] - 1)].transpose(1, 2, 0).astype(np.uint8)
    if photo == 2:
        rgb = img[..., :3]
        if bps == 16:
            rgb = rgb >> 8
        if spp >= 4 and extra[:1] == (1,):  # associated alpha: PIL's "RGBa" unpacker
            a = (img[..., 3] >> 8 if bps == 16 else img[..., 3])[..., None]
            rgb = np.where(a == 0, 0, np.minimum(255, rgb * 255 // np.maximum(a, 1)))
        return rgb.astype(np.uint8)
    if photo == 5 and spp >= 4 and tags.get(332, (1,))[0] == 1:  # CMYK
        from unimp_tpu_torch.data.jpeg import _cmyk_to_rgb

        cmyk = img[..., :4] >> 8 if bps == 16 else img[..., :4]
        c, m, y, k = (255 - cmyk).transpose(2, 0, 1)
        return _cmyk_to_rgb(c, m, y, k)
    raise ValueError(f"TIFF with photometric {photo} and {spp} samples {UNREAD}")
