"""Images the port decodes without PIL, against PIL and the JAX package.

Every kind of file of ROADMAP.md §3's fault 5, made here at odd sizes: by
PIL (progressive JPEG with and without Huffman optimization, restart
markers, gray, CMYK, 16-bit quantization tables, a baseline file cut by
its last 200 bytes; PNG in RGB, RGBA, P with tRNS, L, LA, 16-bit gray;
GIF in P and L, with transparency, animated; BMP in RGB, P, L and 1 bit)
and by the small writers below, which PIL does not offer (baseline JPEGs
with one component a scan: YCbCr, YCCK with the Adobe flag, RGB by the
Adobe flag and by its component ids; PNG with each of the five filters,
Adam7 interlacing, 1 / 2 / 4-bit gray and palette, 16-bit RGB and RGBA;
GIF interlaced, without a palette, with a local palette on a frame
smaller or larger than the screen, with indices past the palette; BMP
at 1 / 4 / 8 / 16 / 24 / 32 bits, top-down, OS/2 and v4 / v5 headers,
BITFIELDS, RLE8, RLE4, a grey-ramp palette, a short palette, cut short;
TIFF in strips and tiles, chunky and planar, BigTIFF, 1-16 bits, gray,
palette, RGB(A) with either alpha, 16-bit big-endian; arithmetic-coded
JPEG from a QM encoder over random coefficients, each beside a Huffman
twin that PIL must decode to the same pixels; lossless JPEG with each
predictor; WebP with its ALPH chunk rewritten raw under each filter and
VP8 frames whose first partition is re-coded with another loop-filter
header). PIL writes TIFF under every compression it has (CCITT with both
fill orders and both photometrics, Group 3 2-D, JPEG, LZMA) and WebP
lossy, lossless, with alpha and animated.
Each is held bit for bit to ``np.asarray(Image.open(f).convert("RGB"))``
(``LOAD_TRUNCATED_IMAGES`` on), ``load_resized_uint8`` to the JAX
package's (its native pipe or its PIL fallback, as it picks), and the
serving worker's frames to the JAX worker's; formats still outside the
port raise a ``ValueError`` that names them, and PIL refuses the same
bytes or ROADMAP.md's fault 5 lists them. The committed fixtures under
``tests/data/images`` (the card's oracle) are held to PIL and to the files
``make_fixtures`` writes.
"""

import base64
import contextlib
import functools
import io
import os
import struct
import sys
import types
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageFile

from unimp_tpu.data import transforms as j_transforms
from unimp_tpu.serve import worker as j_worker
from unimp_tpu_torch.data import jpeg, png, tiff, transforms, vp8, webp, zstd
from unimp_tpu_torch.serve.worker import ModelWorker

RNG = np.random.default_rng(7)


def _picture(h, w, c=3):
    """Smooth ramps plus noise: every AC band of a JPEG carries data."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 5 + y * 3 + 41 * k) % 256 for k in range(c)], -1)
    return ((base + RNG.integers(0, 50, (h, w, c))) % 256).astype(np.uint8)


def _pil_save(arr, mode, fmt, **kw):
    im = Image.fromarray(arr if arr.shape[-1] > 1 else arr[..., 0])
    if im.mode != mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


# ---------------------------------------------------------------- writers

def _huff_codes(bits, values):
    codes, code, k = {}, 0, 0
    for length, n in enumerate(bits, 1):
        for _ in range(n):
            codes[values[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return codes


def _extra(v):
    s = abs(int(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _scan_bytes(blocks, dc_codes, ac_codes):
    """Huffman-code [n, 64] zigzag blocks in order: stuffed scan bytes."""
    bits, pred = [], 0

    def put(code, n):
        bits.extend((code >> (n - 1 - i)) & 1 for i in range(n))

    for zz in blocks:
        s, e = _extra(zz[0] - pred)
        pred = zz[0]
        put(*dc_codes[s])
        put(e, s)
        run = 0
        for v in zz[1:]:
            if not v:
                run += 1
                continue
            while run > 15:
                put(*ac_codes[0xF0])
                run -= 16
            s, e = _extra(v)
            put(*ac_codes[(run << 4) | s])
            put(e, s)
            run = 0
        if run:
            put(*ac_codes[0])
    bits += [1] * (-len(bits) % 8)
    out = np.packbits(np.asarray(bits, np.uint8)).tobytes()
    return out.replace(b"\xff", b"\xff\x00")


def _scan_per_component_jpeg(h, w, comps, app=b""):
    """A baseline JPEG with one component a scan (each scan covers its
    component's own blocks, not the MCU grid), random coefficients, the
    standard Huffman tables; ``comps`` is [(id, h, v, table)], ``app``
    segments go after SOI."""
    seg = lambda m, p: bytes((0xFF, m)) + (len(p) + 2).to_bytes(2, "big") + p  # noqa: E731
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    out = [b"\xff\xd8", app, seg(0xDB, bytes([0]) + bytes(range(2, 66))),
           seg(0xDB, bytes([1]) + bytes([12] * 64)),
           seg(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
               + bytes([len(comps)]) + b"".join(bytes([c, (hs << 4) | vs, t])
                                                 for c, hs, vs, t in comps))]
    for (cls, tid), (bits, values) in jpeg.STD_HUFFMAN.items():
        out.append(seg(0xC4, bytes([(cls << 4) | tid, *bits, *values])))
    for cid, hs, vs, table in comps:
        cols = -(-(-(-w * hs // hmax)) // 8)
        rows = -(-(-(-h * vs // vmax)) // 8)
        blocks = np.zeros((rows * cols, 64), np.int64)
        blocks[:, 0] = RNG.integers(-40, 40, rows * cols)
        blocks[:, 1:12] = RNG.integers(-6, 7, (rows * cols, 11)) * (RNG.random((rows * cols, 11))
                                                                   < 0.4)
        out.append(seg(0xDA, bytes([1, cid, table * 0x11, 0, 63, 0])))
        out.append(_scan_bytes(blocks, _huff_codes(*jpeg.STD_HUFFMAN[(0, table)]),
                               _huff_codes(*jpeg.STD_HUFFMAN[(1, table)])))
    out.append(b"\xff\xd9")
    return b"".join(out)


def _adobe(transform):
    """An Adobe APP14 segment with its colour transform flag."""
    payload = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, transform])
    return b"\xff\xee" + (len(payload) + 2).to_bytes(2, "big") + payload


def _png(samples, ctype, depth, *, interlace=False, palette=None, trns=None,
         filters=(0, 1, 2, 3, 4)):
    """samples [H, W, C] (depth-bit values) -> PNG bytes, the scanline
    filters taken in turn row after row."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)

    def rows_of(sub):
        if depth == 16:
            return [r.astype(">u2").tobytes() for r in sub.reshape(sub.shape[0], -1)]
        if depth == 8:
            return [r.astype(np.uint8).tobytes() for r in sub.reshape(sub.shape[0], -1)]
        bits = ((sub.reshape(sub.shape[0], -1, 1) >> np.arange(depth - 1, -1, -1)) & 1)
        return [np.packbits(r.reshape(-1).astype(np.uint8)).tobytes() for r in bits]

    def filtered(rows):
        out, prev = [], bytes(len(rows[0])) if rows else b""
        for i, row in enumerate(rows):
            kind = filters[i % len(filters)]
            x, up = np.frombuffer(row, np.uint8).astype(int), np.frombuffer(prev, np.uint8)
            up = up.astype(int)
            left = np.concatenate([np.zeros(bpp, int), x[:-bpp]])
            ul = np.concatenate([np.zeros(bpp, int), up[:-bpp]])
            if kind == 4:
                pa, pb, pc = np.abs(up - ul), np.abs(left - ul), np.abs(left + up - 2 * ul)
                pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
            else:
                pred = {0: 0 * x, 1: left, 2: up, 3: (left + up) >> 1}[kind]
            out.append(bytes([kind]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes())
            prev = row
        return b"".join(out)

    if interlace:
        passes = [samples[r0::dr, c0::dc] for r0, c0, dr, dc in png._ADAM7]
        raw = b"".join(filtered(rows_of(p)) for p in passes if p.size)
    else:
        raw = filtered(rows_of(samples))

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    out = png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                     int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


# ---------------------------------------------------------------- files

def _jpegs():
    a, g = _picture(37, 53), _picture(29, 46, 1)
    base = _pil_save(a, "RGB", "JPEG", quality=85)
    return {
        "jpeg_baseline": base,
        "jpeg_progressive": _pil_save(a, "RGB", "JPEG", quality=85, progressive=True),
        "jpeg_progressive_optimized": _pil_save(_picture(48, 41), "RGB", "JPEG", quality=92,
                                                progressive=True, optimize=True),
        "jpeg_restart_every_mcu": _pil_save(a, "RGB", "JPEG", quality=85,
                                            restart_marker_blocks=1),
        "jpeg_progressive_restart": _pil_save(a, "RGB", "JPEG", quality=80, progressive=True,
                                              restart_marker_blocks=3),
        "jpeg_non_interleaved": _scan_per_component_jpeg(
            35, 51, [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]),
        "jpeg_ycck_adobe2": _scan_per_component_jpeg(
            27, 38, [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1), (4, 2, 2, 0)], _adobe(2)),
        "jpeg_rgb_adobe0": _scan_per_component_jpeg(
            27, 38, [(1, 1, 1, 0), (2, 1, 1, 0), (3, 1, 1, 0)], _adobe(0)),
        "jpeg_rgb_component_ids": _scan_per_component_jpeg(
            27, 38, [(82, 1, 1, 0), (71, 1, 1, 0), (66, 1, 1, 0)]),
        "jpeg_truncated": _pil_save(_picture(61, 47), "RGB", "JPEG", quality=90)[:-200],
        "jpeg_cmyk": _pil_save(a, "CMYK", "JPEG", quality=85),
        "jpeg_gray": _pil_save(g, "L", "JPEG", quality=80),
        "jpeg_gray_progressive": _pil_save(g, "L", "JPEG", quality=80, progressive=True),
        "jpeg_16bit_tables": _pil_save(a, "RGB", "JPEG", qtables=[[300] * 64, [420] * 64]),
    }


def _pngs():
    a = _picture(23, 31, 4)
    pal = RNG.integers(0, 256, (16, 3))
    wide = (RNG.integers(0, 65536, (19, 27, 4))).astype(np.uint16)
    idx = RNG.integers(0, 16, (21, 30, 1))
    return {
        "png_rgb": _pil_save(a[..., :3], "RGB", "PNG"),
        "png_rgba": _pil_save(a, "RGBA", "PNG"),
        "png_palette_trns": _png(idx, 3, 8, palette=pal, trns=bytes(range(0, 160, 10))),
        "png_pil_palette_trns": _pil_bytes_palette(a[..., :3]),
        "png_l": _pil_save(a[..., :1], "L", "PNG"),
        "png_la": _pil_save(a[..., :2], "LA", "PNG"),
        "png_gray16_pil": _pil_gray16(),
        "png_rgb16": _png(wide[..., :3], 2, 16),
        "png_rgba16_adam7": _png(wide, 6, 16, interlace=True),
        "png_la16": _png(wide[..., :2], 4, 16),
        "png_rgb_adam7": _png(a[..., :3], 2, 8, interlace=True),
        "png_gray1_adam7": _png(idx % 2, 0, 1, interlace=True),
        "png_gray2": _png(idx % 4, 0, 2),
        "png_gray4_trns": _png(idx, 0, 4, trns=b"\x00\x03"),
        "png_palette2_adam7": _png(idx % 4, 3, 2, palette=pal[:4], interlace=True),
        "png_palette4": _png(idx, 3, 4, palette=pal),
        **{f"png_filter_{k}": _png(a[..., :3], 2, 8, filters=(k,)) for k in range(5)},
    }


def _pil_bytes_palette(rgb):
    im = Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=24)
    buf = io.BytesIO()
    im.save(buf, "PNG", transparency=5)
    return buf.getvalue()


def _pil_gray16():
    im = Image.frombytes("I;16", (27, 19), (RNG.integers(0, 600, (19, 27)).astype("<u2")
                                            .tobytes()))
    buf = io.BytesIO()
    im.save(buf, "PNG")
    return buf.getvalue()


def _gif_lzw(idx, min_size):
    """GIF LZW of ``idx`` with a clear code before the table would widen
    the codes: every code is ``min_size + 1`` bits, a valid stream."""
    clear, size = 1 << min_size, min_size + 1
    codes, room = [clear], (1 << size) - clear - 2
    for k, v in enumerate(idx.reshape(-1)):
        if k and k % room == 0:
            codes.append(clear)
        codes.append(int(v))
    codes.append(clear + 1)
    acc = nbits = 0
    out = bytearray()
    for c in codes:
        acc |= c << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc)
    blocks = b"".join(bytes((len(out[i:i + 255]),)) + bytes(out[i:i + 255])
                      for i in range(0, len(out), 255))
    return bytes((min_size,)) + blocks + b"\x00"


def _gif(idx, screen=None, at=(0, 0), global_pal=None, local_pal=None, transparency=None,
         interlace=False, min_size=None):
    """A one-frame GIF: ``idx`` [h, w] indices placed ``at`` (x, y) on a
    logical screen; palettes [2^k, 3]; rows stored in interlaced order
    when asked."""
    h, w = idx.shape
    sw, sh = screen or (w, h)
    def table_bits(pal):
        return int(np.log2(len(pal))) - 1
    flags = 0
    if global_pal is not None:
        flags = 0x80 | table_bits(global_pal)
    out = b"GIF89a" + struct.pack("<HHBBB", sw, sh, flags, 0, 0)
    if global_pal is not None:
        out += np.asarray(global_pal, np.uint8).tobytes()
    if transparency is not None:
        out += b"\x21\xf9\x04" + bytes((1, 0, 0, transparency)) + b"\x00"
    fflags = (0x40 if interlace else 0)
    if local_pal is not None:
        fflags |= 0x80 | table_bits(local_pal)
    out += b"," + struct.pack("<HHHHB", at[0], at[1], w, h, fflags)
    if local_pal is not None:
        out += np.asarray(local_pal, np.uint8).tobytes()
    rows = idx
    if interlace:
        order = np.concatenate([np.arange(s, h, st) for s, st in ((0, 8), (4, 8), (2, 4), (1, 2))])
        rows = idx[order]
    ms = min_size or max(2, int(idx.max()).bit_length())
    return out + _gif_lzw(rows, ms) + b";"


def _gifs():
    pal = RNG.integers(0, 256, (16, 3))
    pal4 = RNG.integers(0, 256, (4, 3))
    idx = RNG.integers(0, 16, (21, 30))
    a = _picture(23, 34)
    first = Image.fromarray(a).convert("P", palette=Image.ADAPTIVE, colors=40)
    second = Image.fromarray(_picture(23, 34)).convert("P", palette=Image.ADAPTIVE, colors=40)
    anim = io.BytesIO()
    first.save(anim, "GIF", save_all=True, append_images=[second], duration=50)
    return {
        "gif_pil": _pil_save(a, "P", "GIF"),
        "gif_pil_gray": _pil_save(_picture(19, 26, 1), "L", "GIF"),
        "gif_pil_transparency": _pil_save(a, "P", "GIF", transparency=3, optimize=False),
        "gif_pil_animated": anim.getvalue(),
        "gif_interlaced": _gif(idx, global_pal=pal, interlace=True),
        "gif_local_palette_offset_transparent": _gif(
            RNG.integers(0, 4, (9, 11)), screen=(20, 17), at=(5, 3), global_pal=pal,
            local_pal=pal4, transparency=2),
        "gif_no_palette": _gif(RNG.integers(0, 256, (13, 10)), min_size=8),
        "gif_index_past_palette": _gif(RNG.integers(0, 8, (7, 9)), global_pal=pal4,
                                       min_size=3),
        "gif_frame_past_screen": _gif(idx[:8, :9], screen=(6, 5), at=(2, 1), global_pal=pal),
    }


def _bmp(pixels, bits, *, palette=None, header=40, compression=0, masks=None, top_down=False,
         body=None):
    """A BMP of ``pixels`` ([h, w] indices, or [h, w] packed 16-/32-bit
    values, or [h, w, 3] RGB at 24 bits), or of a given ``body``."""
    h, w = pixels.shape[:2]
    if body is None:
        rows = []
        for r in pixels:
            if bits < 8:
                per = 8 // bits
                v = np.zeros(-(-w // per) * per, np.uint8)
                v[:w] = r
                v = v.reshape(-1, per)
                line = sum(v[:, k] << (8 - bits * (k + 1)) for k in range(per)).astype(np.uint8)
            elif bits == 8:
                line = r.astype(np.uint8)
            elif bits == 16:
                line = r.astype("<u2")
            elif bits == 24:
                line = r[:, ::-1].astype(np.uint8)
            else:
                line = r.astype("<u4")
            line = line.tobytes()
            rows.append(line + b"\x00" * ((-len(line)) % 4))
        body = b"".join(rows if top_down else rows[::-1])
    pal = b""
    if palette is not None:
        pal = b"".join(bytes((b, g, r)) + (b"" if header == 12 else b"\x00")
                       for r, g, b in np.asarray(palette, np.uint8))
    extra = b""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits,
                           compression, len(body), 2835, 2835,
                           0 if palette is None else len(palette), 0)
        tail = b""
        if masks is not None and header >= 52:
            tail = struct.pack("<4I", *(list(masks) + [0] * (4 - len(masks))))
        elif masks is not None:
            extra = struct.pack("<3I", *masks[:3])
        info += (tail + bytes(header - 40))[:header - 40]
    off = 14 + len(info) + len(extra) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + info + extra + pal + body


def _rle8(idx):
    """RLE8 rows, bottom-up: encoded runs and absolute runs, end-of-line
    and end-of-bitmap escapes."""
    out = bytearray()
    for r in idx[::-1]:
        r = [int(v) for v in r]
        k = 0
        while k < len(r):
            run = 1
            while k + run < len(r) and r[k + run] == r[k] and run < 255:
                run += 1
            if run >= 3 or len(r) - k < 3:
                out += bytes((run, r[k]))
                k += run
            else:
                n = min(len(r) - k, 5)
                out += bytes((0, n)) + bytes(r[k:k + n]) + (b"\x00" if n % 2 else b"")
                k += n
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def _rle4(idx):
    """RLE4 rows, bottom-up: two-index encoded runs and even absolute runs."""
    out = bytearray()
    for r in idx[::-1]:
        r = [int(v) for v in r]
        k = 0
        while k < len(r):
            if len(r) - k >= 4 and k % 3 == 0:
                out += bytes((0, 4, (r[k] << 4) | r[k + 1], (r[k + 2] << 4) | r[k + 3]))
                k += 4
            else:
                n = min(len(r) - k, 2)
                out += bytes((n, (r[k] << 4) | (r[k + 1] if n == 2 else 0)))
                k += n
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def _bmps():
    pal = RNG.integers(0, 256, (256, 3))
    i8, i4, i1 = (RNG.integers(0, n, (17, 23)) for n in (256, 16, 2))
    rgb = _picture(15, 21)
    v16 = RNG.integers(0, 65536, (11, 13))
    v32 = RNG.integers(0, 2**32, (9, 14), dtype=np.uint64)
    gray = np.stack([np.arange(256)] * 3, 1)
    return {
        "bmp_pil_rgb": _pil_save(rgb, "RGB", "BMP"),
        "bmp_pil_palette": _pil_save(_picture(16, 22), "P", "BMP"),
        "bmp_pil_gray": _pil_save(_picture(14, 19, 1), "L", "BMP"),
        "bmp_pil_1bit": _pil_save(_picture(13, 21, 1), "1", "BMP"),
        "bmp_8bit_top_down": _bmp(i8, 8, palette=pal, top_down=True),
        "bmp_4bit": _bmp(i4, 4, palette=pal[:16]),
        "bmp_1bit_colour": _bmp(i1, 1, palette=pal[:2]),
        "bmp_8bit_short_palette": _bmp(RNG.integers(0, 12, (6, 7)), 8, palette=pal[:9]),
        "bmp_8bit_gray_ramp": _bmp(i8, 8, palette=gray),
        "bmp_os2_8bit": _bmp(i8, 8, palette=pal, header=12),
        "bmp_16bit_555": _bmp(v16, 16),
        "bmp_16bit_565_bitfields": _bmp(v16, 16, compression=3, masks=(0xF800, 0x7E0, 0x1F)),
        "bmp_24bit_v5_top_down": _bmp(rgb, 24, header=124, top_down=True),
        "bmp_32bit": _bmp(v32, 32),
        "bmp_32bit_bitfields_rgba_v4": _bmp(v32, 32, header=108, compression=3,
                                            masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
        "bmp_32bit_bitfields_xbgr": _bmp(v32, 32, compression=3,
                                         masks=(0xFF000000, 0xFF0000, 0xFF00)),
        "bmp_rle8": _bmp(i8[:, :11] % 7, 8, palette=pal, compression=1,
                         body=_rle8(np.repeat(i8[:, :11] % 7, 1, 1))),
        "bmp_rle4": _bmp(i4[:, :13], 4, palette=pal[:16], compression=2,
                         body=_rle4(i4[:, :13])),
        "bmp_truncated": _bmp(rgb, 24)[:-100],
    }


def _tiff(samples, photometric, *, bps=8, planar=1, tile=None, compression=1,
          big_endian=False, extra=(), colormap=None, rows_per_strip=None, fill_order=None,
          bigtiff=False, sample_format=None, chunks=None):
    """A TIFF (or BigTIFF) of ``samples`` [H, W, S] in strips
    (``rows_per_strip``) or tiles, chunky or planar, none / Deflate /
    PackBits (literal runs), or ``chunks`` given coded."""
    bo = ">" if big_endian else "<"
    h, w, spp = samples.shape
    tw, th = tile or (w, rows_per_strip or h)
    boxes = [(x, y) for y in range(0, h, th) for x in range(0, w, tw)]
    planes = [samples[..., k:k + 1] for k in range(spp)] if planar == 2 else [samples]

    def pack(block):
        rows = []
        for row in block.reshape(block.shape[0], -1).astype(np.int64):
            if bps == 16:
                rows.append(row.astype(bo + "u2").tobytes())
            elif bps == 8:
                rows.append(row.astype(np.uint8).tobytes())
            else:
                bits = ((row[:, None] >> np.arange(bps - 1, -1, -1)) & 1).reshape(-1)
                rows.append(np.packbits(bits.astype(np.uint8)).tobytes())
        raw = b"".join(rows)
        if compression == 8:
            return zlib.compress(raw)
        if compression == 32773:
            return b"".join(bytes([len(raw[i:i + 128]) - 1]) + raw[i:i + 128]
                            for i in range(0, len(raw), 128))
        return raw

    if chunks is not None:
        planes = []
    chunks = list(chunks or [])
    for plane in planes:
        for x, y in boxes:
            block = plane[y:y + th, x:x + tw]
            if tile:
                block = np.pad(block, ((0, th - block.shape[0]), (0, tw - block.shape[1]),
                                       (0, 0)))
            chunks.append(pack(block))
    body = b"".join(chunks)
    head_len = 16 if bigtiff else 8
    offsets = np.cumsum([head_len] + [len(c) for c in chunks[:-1]]).tolist()
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * spp), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if tile:
        tags.update({322: (3, [tw]), 323: (3, [th]), 324: (4, offsets),
                     325: (4, [len(c) for c in chunks])})
    else:
        tags.update({273: (4, offsets), 278: (4, [th]), 279: (4, [len(c) for c in chunks])})
    if extra:
        tags[338] = (3, list(extra))
    if colormap is not None:
        tags[320] = (3, list(colormap))
    if fill_order:
        tags[266] = (3, [fill_order])
    if sample_format:
        tags[339] = (3, [sample_format] * spp)
    ifd_at = head_len + len(body) + len(body) % 2
    heap = bytearray()
    entries = []
    # BigTIFF: 8-byte counts, values and offsets (LONG8, type 16)
    entry, inline, off = (20, 8, "Q") if bigtiff else (12, 4, "I")
    heap_at = ifd_at + (8 if bigtiff else 2) + entry * len(tags) + inline
    for tag in sorted(tags):
        typ, vals = tags[tag]
        if bigtiff and typ == 4:
            typ = 16
        payload = struct.pack(f"{bo}{len(vals)}{ {3: 'H', 4: 'I', 16: 'Q'}[typ]}", *vals)
        if len(payload) <= inline:
            field = payload.ljust(inline, b"\0")
        else:
            field = struct.pack(bo + off, heap_at + len(heap))
            heap += payload
        entries.append(struct.pack(f"{bo}HH{off}", tag, typ, len(vals)) + field)
    magic = b"MM\x00+" if big_endian else b"II+\x00"
    if bigtiff:
        head = magic + struct.pack(bo + "HHQ", 8, 0, ifd_at)
        count = struct.pack(bo + "Q", len(tags))
    else:
        head = (b"MM\x00*" if big_endian else b"II*\x00") + struct.pack(bo + "I", ifd_at)
        count = struct.pack(bo + "H", len(tags))
    return (head + body + bytes(len(body) % 2) + count + b"".join(entries) + bytes(inline)
            + bytes(heap))


def _bilevel(h, w, block):
    """Bilevel blocks with long runs (CCITT make-up codes) and edges."""
    cells = RNG.integers(0, 2, (-(-h // block), -(-w // block)))
    return np.kron(cells, np.ones((block, block), np.int64))[:h, :w].astype(np.uint8) * 255


def _tiffs():
    a, rgb16 = _picture(37, 53), RNG.integers(0, 65536, (19, 23, 3))
    rgba = _picture(21, 26, 4)
    pal = RNG.integers(0, 65536, 3 * 16)
    files = {}
    for comp in ("raw", "tiff_lzw", "tiff_adobe_deflate", "packbits", "lzma"):
        for mode in ("RGB", "L", "P", "CMYK", "RGBA", "LA", "1"):
            files[f"tiff_pil_{comp}_{mode.lower()}"] = _pil_save(a, mode, "TIFF",
                                                                 compression=comp)
    for mode in ("RGB", "L", "CMYK", "YCbCr"):
        files[f"tiff_pil_jpeg_{mode.lower()}"] = _pil_save(a, mode, "TIFF", compression="jpeg",
                                                           quality=80)
    gray16 = (_picture(23, 29, 1)[..., 0].astype(np.uint16) * 257
              + RNG.integers(0, 256, (23, 29))).astype(np.uint16)
    files["tiff_pil_gray16"] = _pil_bytes(Image.fromarray(gray16), "TIFF",
                                          compression="tiff_lzw")
    files["tiff_pil_lzw_predictor"] = _pil_save(a, "RGB", "TIFF", compression="tiff_lzw",
                                                tiffinfo={317: 2})
    files["tiff_pil_deflate_predictor_gray"] = _pil_save(a, "L", "TIFF",
                                                         compression="tiff_adobe_deflate",
                                                         tiffinfo={317: 2})
    files["tiff_pil_lzw_strips_of_5"] = _pil_save(a, "RGB", "TIFF", compression="tiff_lzw",
                                                  tiffinfo={278: 5})
    bilevel = _bilevel(41, 300, 23)[..., None]
    for comp in ("group3", "group4", "tiff_ccitt"):
        for info, tag in (({}, ""), ({266: 2}, "_lsb_first"), ({262: 0}, "_white_is_zero")):
            files[f"tiff_pil_{comp}{tag}"] = _pil_save(bilevel, "1", "TIFF", compression=comp,
                                                       tiffinfo=info)
    files["tiff_pil_group3_2d"] = _pil_save(bilevel, "1", "TIFF", compression="group3",
                                            tiffinfo={292: 1})
    files["tiff_pil_group3_2d_noise"] = _pil_save(_picture(33, 77, 1), "1", "TIFF",
                                                  compression="group3", tiffinfo={292: 1})
    files["tiff_pil_group4_noise"] = _pil_save(_picture(33, 77, 1), "1", "TIFF",
                                               compression="group4")
    files.update({
        "tiff_planar_deflate": _tiff(a, 2, planar=2, compression=8, rows_per_strip=10),
        "tiff_tiles_deflate": _tiff(a, 2, tile=(16, 16), compression=8),
        "tiff_tiles_planar_packbits": _tiff(a, 2, tile=(16, 16), planar=2,
                                            compression=32773),
        "tiff_rgb16_big_endian": _tiff(rgb16, 2, bps=16, big_endian=True),
        "tiff_rgb16_little_endian_packbits": _tiff(rgb16, 2, bps=16, compression=32773),
        "tiff_rgba_associated": _tiff(rgba, 2, extra=(1,)),
        "tiff_rgba_unassociated": _tiff(rgba, 2, extra=(2,)),
        "tiff_gray2_white_is_zero": _tiff(RNG.integers(0, 4, (17, 27, 1)), 0, bps=2),
        "tiff_gray4": _tiff(RNG.integers(0, 16, (17, 27, 1)), 1, bps=4),
        "tiff_gray16_big_endian": _tiff(RNG.integers(0, 65536, (13, 18, 1)), 1, bps=16,
                                        big_endian=True),
        "tiff_palette4": _tiff(RNG.integers(0, 16, (15, 21, 1)), 3, bps=4, colormap=pal),
        "tiff_palette8_tiles": _tiff(RNG.integers(0, 16, (35, 40, 1)), 3, tile=(16, 16),
                                     colormap=np.pad(pal.reshape(3, 16), ((0, 0), (0, 240)))
                                     .reshape(-1)),
        "tiff_bigtiff_tiles_deflate": _tiff(a, 2, tile=(16, 32), compression=8, bigtiff=True),
        "tiff_bigtiff_strips": _tiff(a, 2, rows_per_strip=7, bigtiff=True),
        "tiff_bilevel_raw": _tiff(_bilevel(13, 29, 3)[..., None] // 255, 1, bps=1),
    })
    return files


# ---------------------------------------------------------------- arithmetic and lossless JPEG

def _seg(marker, payload):
    return bytes((0xFF, marker)) + (len(payload) + 2).to_bytes(2, "big") + payload


class _QMEncoder:
    """The QM coder's encoder (T.81 Annex D as libjpeg's ``jcarith.c``
    writes it), for the arithmetic-coded test files."""

    def __init__(self):
        self.out, self.c, self.a, self.sc, self.zc, self.ct, self.buf = [], 0, 0x10000, 0, 0, 11, -1

    def _flush_zeros(self):
        self.out += [0] * self.zc
        self.zc = 0

    def encode(self, st, i, val):
        sv = st[i]
        qe = jpeg._ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buf >= 0:
                        self._flush_zeros()
                        self.out.append(self.buf + 1)
                        if self.buf + 1 == 0xFF:
                            self.out.append(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buf = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buf == 0:
                        self.zc += 1
                    elif self.buf >= 0:
                        self._flush_zeros()
                        self.out.append(self.buf)
                    if self.sc:
                        self._flush_zeros()
                        self.out += [0xFF, 0] * self.sc
                        self.sc = 0
                    self.buf = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buf >= 0:
                self._flush_zeros()
                self.out.append(self.buf + 1)
                if self.buf + 1 == 0xFF:
                    self.out.append(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buf == 0:
                self.zc += 1
            elif self.buf >= 0:
                self._flush_zeros()
                self.out.append(self.buf)
            if self.sc:
                self._flush_zeros()
                self.out += [0xFF, 0] * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            self._flush_zeros()
            for shift, mask in ((19, 0x7FFF800), (11, 0x7F800)):
                if self.c & mask:
                    b = (self.c >> shift) & 0xFF
                    self.out += [b, 0] if b == 0xFF else [b]
        return bytes(self.out)


def _qm_magnitude(enc, st, i, v, big):
    """F.8 / F.9: the category of v (> 0) from ``st[i]``, then its bits;
    ``big`` the statistics the categories above one continue in."""
    m, v = 0, v - 1
    if v:
        enc.encode(st, i, 1)
        m, v2 = 1, v >> 1
        if big is not None and v2:  # AC: a second category bit in the same bin
            enc.encode(st, i, 1)
            m, i, v2 = 2, big, v2 >> 1
        elif big is None:
            i = 20
        while v2:
            enc.encode(st, i, 1)
            m <<= 1
            i += 1
            v2 >>= 1
    enc.encode(st, i, 0)
    i += 14
    m >>= 1
    while m:
        enc.encode(st, i, 1 if m & v else 0)
        m >>= 1


def _qm_dc(enc, st, ctx, diff, cond=(0, 1)):
    s = ctx[0]
    if not diff:
        enc.encode(st, s, 0)
        ctx[0] = 0
        return
    enc.encode(st, s, 1)
    sign = diff < 0
    enc.encode(st, s + 1, int(sign))
    v = abs(diff)
    m = 1 << (v - 1).bit_length() >> 1 if v > 1 else 0
    lo, hi = cond
    ctx[0] = 0 if m < (1 << lo) >> 1 else (12 if m > (1 << hi) >> 1 else 4) + 4 * sign
    _qm_magnitude(enc, st, s + 2 + sign, v, None)


def _qm_ac(enc, st, fixed, zz, ss, se, al, k_cond=5):
    """F.5 / G.10 first pass: coefficients ss..se of one block, >> al."""
    vals = [(abs(int(v)) >> al) * (1 if v >= 0 else -1) for v in zz]
    ke = se
    while ke >= ss and not vals[ke]:
        ke -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        enc.encode(st, i, 0)
        while not vals[k]:
            enc.encode(st, i + 1, 0)
            i += 3
            k += 1
        enc.encode(st, i + 1, 1)
        enc.encode(fixed, 0, int(vals[k] < 0))
        _qm_magnitude(enc, st, i + 2, abs(vals[k]), 189 if k <= k_cond else 217)
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def _qm_ac_refine(enc, st, fixed, zz, ss, se, al):
    """G.10 refinement at bit al of coefficients first coded above it."""
    mag = [abs(int(v)) for v in zz]
    ke = se
    while ke > 0 and not mag[ke] >> al:
        ke -= 1
    kex = ke
    while kex > 0 and not mag[kex] >> (al + 1):
        kex -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        if k > kex:
            enc.encode(st, i, 0)
        while True:
            v = mag[k] >> al
            if v:
                if v >> 1:
                    enc.encode(st, i + 2, v & 1)
                else:
                    enc.encode(st, i + 1, 1)
                    enc.encode(fixed, 0, int(zz[k] < 0))
                break
            enc.encode(st, i + 1, 0)
            i += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def _coef_blocks(h, w, comps):
    """Random zigzag coefficients [rows, cols, 64] for each component."""
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    out = []
    for _, hs, vs, _ in comps:
        b = np.zeros((mcuy * vs, mcux * hs, 64), np.int64)
        b[..., 0] = RNG.integers(-60, 60, b.shape[:2])
        b[..., 1:15] = RNG.integers(-9, 10, b.shape[:2] + (14,)) * (
            RNG.random(b.shape[:2] + (14,)) < 0.5)
        b[..., 15:40] = RNG.integers(-3, 4, b.shape[:2] + (25,)) * (
            RNG.random(b.shape[:2] + (25,)) < 0.15)
        out.append(b)
    return out


def _frame_head(h, w, comps, sof, app=b""):
    return [b"\xff\xd8", app, _seg(0xDB, bytes([0]) + bytes(range(2, 66))),
            _seg(0xDB, bytes([1]) + bytes([9] * 64)),
            _seg(sof, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
                 + bytes([len(comps)]) + b"".join(bytes([c, (hs << 4) | vs, t])
                                                  for c, hs, vs, t in comps))]


def _huffman_of(h, w, comps, blocks, app=b""):
    """The same coefficients as a baseline Huffman file, one component a
    scan (the oracle's twin)."""
    out = _frame_head(h, w, comps, 0xC0, app)
    for (cls, tid), (bits, values) in jpeg.STD_HUFFMAN.items():
        out.append(_seg(0xC4, bytes([(cls << 4) | tid, *bits, *values])))
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    for (cid, hs, vs, t), b in zip(comps, blocks):
        rows = -(-(-(-h * vs // vmax)) // 8)
        cols = -(-(-(-w * hs // hmax)) // 8)
        out.append(_seg(0xDA, bytes([1, cid, t * 0x11, 0, 63, 0])))
        out.append(_scan_bytes(b[:rows, :cols].reshape(-1, 64),
                               _huff_codes(*jpeg.STD_HUFFMAN[(0, t)]),
                               _huff_codes(*jpeg.STD_HUFFMAN[(1, t)])))
    return b"".join(out + [b"\xff\xd9"])


def _arith_jpeg(h, w, comps, blocks, *, progressive=False, interleaved=True, restart=0,
                dac=None, app=b""):
    """An arithmetic-coded file of the coefficients: sequential (SOF9, one
    interleaved scan or one a component, with restart intervals) or
    progressive (SOF10: DC first at Al 1 and its refinement, AC 1-5 at Al 1
    and 6-63 at Al 0 per component, then AC 1-5's refinement); ``dac``:
    {(class, table): value}."""
    out = _frame_head(h, w, comps, 0xCA if progressive else 0xC9, app)
    cond = dict(dac or {})
    if dac:
        out.append(_seg(0xCC, b"".join(bytes([(c << 4) | t, v]) for (c, t), v in dac.items())))
    if restart:
        out.append(_seg(0xDD, restart.to_bytes(2, "big")))
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))

    def units(ci_list):
        """MCUs of a scan over ``ci_list``: lists of (component, row, col)."""
        if len(ci_list) == 1:
            ci = ci_list[0]
            _, hs, vs, _ = comps[ci]
            rows = -(-(-(-h * vs // vmax)) // 8)
            cols = -(-(-(-w * hs // hmax)) // 8)
            return [[(ci, r, c)] for r in range(rows) for c in range(cols)]
        return [[(ci, my * comps[ci][2] + v, mx * comps[ci][1] + u) for ci in ci_list
                 for v in range(comps[ci][2]) for u in range(comps[ci][1])]
                for my in range(mcuy) for mx in range(mcux)]

    def scan(ci_list, ss, se, ah, al, code):
        out.append(_seg(0xDA, bytes([len(ci_list)]) + b"".join(
            bytes([comps[ci][0], comps[ci][3] * 0x11]) for ci in ci_list)
            + bytes([ss, se, (ah << 4) | al])))
        mcus = units(ci_list)
        per = restart or len(mcus)
        for r, start in enumerate(range(0, len(mcus), per)):
            enc = _QMEncoder()
            dc_st = {t: bytearray(64) for t in range(2)}
            ac_st = {t: bytearray(256) for t in range(2)}
            fixed = bytearray([113])
            ctx = {ci: [0] for ci in ci_list}
            pred = {ci: 0 for ci in ci_list}
            for mcu in mcus[start:start + per]:
                for ci, r_, c_ in mcu:
                    code(enc, dc_st, ac_st, fixed, ctx, pred, ci, blocks[ci][r_, c_])
            if r:
                out.append(bytes([0xFF, 0xD0 + (r - 1) % 8]))
            out.append(enc.finish())

    def dc_cond(ci):
        v = cond.get((0, comps[ci][3]), 0x10)
        return v & 15, v >> 4

    def seq(enc, dc_st, ac_st, fixed, ctx, pred, ci, zz):
        t = comps[ci][3]
        _qm_dc(enc, dc_st[t], ctx[ci], int(zz[0]) - pred[ci], dc_cond(ci))
        pred[ci] = int(zz[0])
        _qm_ac(enc, ac_st[t], fixed, zz, 1, 63, 0, cond.get((1, t), 5))

    def dc_first(enc, dc_st, ac_st, fixed, ctx, pred, ci, zz):
        v = int(zz[0]) >> 1
        _qm_dc(enc, dc_st[comps[ci][3]], ctx[ci], v - pred[ci], dc_cond(ci))
        pred[ci] = v

    def dc_refine(enc, dc_st, ac_st, fixed, ctx, pred, ci, zz):
        enc.encode(fixed, 0, int(zz[0]) & 1)

    def ac_first(ss, se, al):
        def code(enc, dc_st, ac_st, fixed, ctx, pred, ci, zz):
            t = comps[ci][3]
            _qm_ac(enc, ac_st[t], fixed, zz, ss, se, al, cond.get((1, t), 5))
        return code

    def ac_refine(enc, dc_st, ac_st, fixed, ctx, pred, ci, zz):
        _qm_ac_refine(enc, ac_st[comps[ci][3]], fixed, zz, 1, 5, 0)

    every = list(range(len(comps)))
    if not progressive:
        for group in ([every] if interleaved else [[ci] for ci in every]):
            scan(group, 0, 63, 0, 0, seq)
    else:
        scan(every, 0, 0, 0, 1, dc_first)
        for ci in every:
            scan([ci], 1, 5, 0, 1, ac_first(1, 5, 1))
        scan(every, 0, 0, 1, 0, dc_refine)
        for ci in every:
            scan([ci], 6, 63, 0, 0, ac_first(6, 63, 0))
            scan([ci], 1, 5, 1, 0, ac_refine)
    return b"".join(out + [b"\xff\xd9"])


_LOSSLESS_BITS = (0, 0, 0, 0, 17) + (0,) * 11  # 17 codes of 5 bits: categories 0-16


def _lossless_jpeg(samples, predictor, pt=0, app=b"", ids=None):
    """A lossless (SOF3) file: one interleaved scan of the components of
    ``samples`` [H, W, C] (8 bits), predictor 1-7, point transform pt."""
    h, w, n = samples.shape
    x = samples.astype(np.int64) >> pt
    d = np.zeros_like(x)
    for c in range(n):
        p = np.zeros((h, w), np.int64)
        p[0, 0] = 1 << (8 - pt - 1)
        p[0, 1:] = x[0, :-1, c]
        p[1:, 0] = x[:-1, 0, c]
        ra, rb, rc = x[1:, :-1, c], x[:-1, 1:, c], x[:-1, :-1, c]
        p[1:, 1:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                     6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]
        d[..., c] = x[..., c] - p
    codes = _huff_codes(_LOSSLESS_BITS, list(range(17)))
    bits = []
    for v in (((d + 32768) & 0xFFFF) - 32768).reshape(-1).tolist():
        s, e = _extra(v)
        code, length = codes[s]
        bits += [(code >> (length - 1 - i)) & 1 for i in range(length)]
        bits += [(e >> (s - 1 - i)) & 1 for i in range(s)]
    bits += [1] * (-len(bits) % 8)
    data = np.packbits(np.asarray(bits, np.uint8)).tobytes().replace(b"\xff", b"\xff\x00")
    ids = ids or list(range(1, n + 1))
    return b"".join([b"\xff\xd8", app,
                     _seg(0xC3, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
                          + bytes([n]) + b"".join(bytes([i, 0x11, 0]) for i in ids)),
                     _seg(0xC4, bytes([0x00, *_LOSSLESS_BITS, *range(17)])),
                     _seg(0xDA, bytes([n]) + b"".join(bytes([i, 0x00]) for i in ids)
                          + bytes([predictor, 0, pt])), data, b"\xff\xd9"])


_JFIF = _seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
ARITH_PAIRS = {}  # arithmetic file name -> its Huffman twin
REFUSED = {}  # files PIL and the port both refuse


def _arith_and_lossless():
    ycc = [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
    gray = [(1, 1, 1, 0)]
    files = {}
    for name, (h, w, comps, kw) in {
            "seq_ycc420": (35, 51, ycc, {}),
            "seq_ycc420_per_component": (35, 51, ycc, dict(interleaved=False)),
            "seq_restart": (35, 51, ycc, dict(restart=2)),
            "seq_dac": (29, 44, ycc, dict(dac={(0, 0): 0x52, (0, 1): 0x31, (1, 0): 9,
                                                (1, 1): 2})),
            "seq_gray": (27, 38, gray, {}),
            "progressive_ycc420": (35, 51, ycc, dict(progressive=True)),
            "progressive_gray_restart": (27, 38, gray, dict(progressive=True, restart=3)),
    }.items():
        blocks = _coef_blocks(h, w, comps)
        files[f"jpeg_arith_{name}"] = _arith_jpeg(h, w, comps, blocks, **kw)
        ARITH_PAIRS[f"jpeg_arith_{name}"] = _huffman_of(h, w, comps, blocks)
    rgb, g = _picture(23, 31), _picture(21, 26, 1)
    for p in range(1, 8):
        files[f"jpeg_lossless_rgb_p{p}"] = _lossless_jpeg(rgb, p, app=_adobe(0))
    files["jpeg_lossless_gray_p4_pt2"] = _lossless_jpeg(g, 4, pt=2)
    REFUSED["jpeg_lossless_ycc_p1"] = _lossless_jpeg(rgb, 1, app=_JFIF)
    files["jpeg_lossless_rgb_ids_p7"] = _lossless_jpeg(rgb, 7, ids=[82, 71, 66])
    return files


# ---------------------------------------------------------------- WebP

def _riff(chunks):
    body = b"".join(tag + struct.pack("<I", len(b)) + b + bytes(len(b) & 1) for tag, b in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _with_raw_alpha(data, alpha, filt):
    """``data`` (VP8X + ALPH + VP8) with its ALPH chunk rewritten uncompressed
    under filter ``filt`` (1 horizontal, 2 vertical, 3 gradient), filtered
    as libwebp's ``filters.c`` does."""
    a = alpha.astype(np.int64)
    f = a.copy()
    f[0, 1:] = a[0, 1:] - a[0, :-1]
    if filt:
        f[1:, 0] = a[1:, 0] - a[:-1, 0]
        if filt == 1:
            f[1:, 1:] = a[1:, 1:] - a[1:, :-1]
        elif filt == 2:
            f[1:] = a[1:] - a[:-1]
        else:
            f[1:, 1:] = a[1:, 1:] - np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    else:
        f = a
    chunks = list(webp._chunks(data))
    alph = bytes([filt << 2]) + (f & 255).astype(np.uint8).tobytes()
    return _riff([(t, alph if t == b"ALPH" else b) for t, b in chunks])


class _RecordingBool(vp8._Bool):
    """The first boolean decoder of a frame (its first partition), keeping
    every (probability, bit) it reads."""

    record = None

    def __init__(self, data):
        super().__init__(data)
        if _RecordingBool.record is None:
            _RecordingBool.record = self.seen = []
        else:
            self.seen = None

    def bit(self, prob):
        b = super().bit(prob)
        if self.seen is not None:
            self.seen.append((prob, b))
        return b


def _bool_encode(pairs) -> bytes:
    """RFC 6386 §7.3's boolean encoder over (probability, bit) pairs."""
    out, rng, bottom, count = bytearray(), 255, 0, 24
    for prob, bit in pairs:
        split = 1 + (((rng - 1) * prob) >> 8)
        if bit:
            bottom += split
            rng -= split
        else:
            rng = split
        while rng < 128:
            rng <<= 1
            if bottom & (1 << 31):
                k = len(out) - 1
                while out[k] == 255:
                    out[k] = 0
                    k -= 1
                out[k] += 1
            bottom = (bottom << 1) & 0xFFFFFFFF
            count -= 1
            if not count:
                out.append(bottom >> 24)
                bottom &= (1 << 24) - 1
                count = 8
    v = bottom
    if v & (1 << (32 - count)):
        k = len(out) - 1
        while out[k] == 255:
            out[k] = 0
            k -= 1
        out[k] += 1
    v = (v << (count & 7)) & 0xFFFFFFFF
    for _ in range(count >> 3):
        v = (v << 8) & 0xFFFFFFFF
    for _ in range(4):
        out.append(v >> 24)
        v = (v << 8) & 0xFFFFFFFF
    return bytes(out)


def _vp8_with_filter(data, simple, sharpness, deltas=None):
    """A lossy WebP whose first partition is re-encoded with another loop
    filter header: the filter type, the sharpness and, with ``deltas`` (ref,
    mode), loop-filter deltas for intra frames and 4x4 macroblocks. Every
    other symbol is coded as it was."""
    frame = dict(webp._chunks(data))[b"VP8 "]
    _RecordingBool.record = None
    orig, vp8._Bool = vp8._Bool, _RecordingBool
    try:
        vp8.decode_vp8(frame)
    finally:
        vp8._Bool = orig
    pairs = _RecordingBool.record
    i = 3  # colour space, clamping, segmentation on
    if pairs[2][1]:
        update_map, update_data = pairs[3][1], pairs[4][1]
        i = 5
        if update_data:
            i += 1  # absolute or delta
            for bits in (7,) * 4 + (6,) * 4:
                i += 1 + (bits + 1 if pairs[i][1] else 0)
        if update_map:
            for _ in range(3):
                i += 1 + (8 if pairs[i][1] else 0)
    level_bits = pairs[i + 1:i + 7]
    use_delta = pairs[i + 10][1]
    if use_delta:
        raise AssertionError("the source frame already has loop-filter deltas")
    head = [(128, simple)] + level_bits + [(128, (sharpness >> k) & 1) for k in (2, 1, 0)]
    if deltas:
        ref, mode = deltas
        head.append((128, 1))  # use deltas
        head.append((128, 1))  # update them
        for v in (ref, 0, 0, 0, mode, 0, 0, 0):
            head.append((128, int(v != 0)))
            if v:
                head += [(128, (abs(v) >> k) & 1) for k in range(5, -1, -1)]
                head.append((128, int(v < 0)))
    else:
        head.append((128, 0))
    part0 = _bool_encode(pairs[:i] + head + pairs[i + 11:])
    bits = frame[0] | (frame[1] << 8) | (frame[2] << 16)
    rest = frame[10 + (bits >> 5):]
    tag = ((bits & 0x1F) | (len(part0) << 5)).to_bytes(3, "little")
    return _riff([(b"VP8 ", tag + frame[3:10] + part0 + rest)])


def _webp_save(arr, mode, **kw):
    return _pil_save(arr, mode, "WEBP", **kw)


def _webps():
    a, a4 = _picture(37, 53), _picture(30, 41, 4)
    a4[..., 3] = (np.mgrid[0:30, 0:41][1] * 6 + RNG.integers(0, 3, (30, 41))) % 256
    y, x = np.mgrid[0:96, 0:128]
    mixed = np.zeros((96, 128, 3), np.int64)
    mixed[:48] = np.stack([x * 2, y * 3, x + y], -1)[:48]
    mixed[48:, :64] = np.array([[10, 200, 30], [40, 50, 220], [250, 250, 0]])[
        RNG.integers(0, 3, (48, 64))]
    mixed[48:, 64:] = np.stack([x, x, x], -1)[48:, 64:] * 3 + RNG.integers(0, 60, (48, 64, 3))
    g = (np.mgrid[0:40, 0:44][0] * 4 + RNG.integers(0, 40, (40, 44))) % 256
    corr = np.stack([(g + 30 + RNG.integers(0, 3, g.shape)) % 256, g,
                     (g + 70 + RNG.integers(0, 3, g.shape)) % 256], -1)
    flat = a.copy()
    flat[:18, :26] = 200  # a flat corner: skipped macroblocks, 16x16 modes
    files = {
        "webp_lossless": _webp_save(a, "RGB", lossless=True),
        "webp_lossless_fast": _webp_save(a, "RGB", lossless=True, method=0, quality=0),
        "webp_lossless_cache_meta": _webp_save((mixed % 256).astype(np.uint8), "RGB",
                                               lossless=True, method=4),
        "webp_lossless_subtract_green": _webp_save(corr.astype(np.uint8), "RGB",
                                                   lossless=True, method=4, quality=50),
        "webp_lossless_palette6": _webp_save(
            RNG.integers(0, 256, (6, 3))[RNG.integers(0, 6, (29, 31))].astype(np.uint8), "RGB",
            lossless=True),
        "webp_lossless_palette2": _webp_save(
            RNG.integers(0, 256, (2, 3))[RNG.integers(0, 2, (23, 45))].astype(np.uint8), "RGB",
            lossless=True),
        "webp_lossless_rgba": _webp_save(a4, "RGBA", lossless=True),
        "webp_lossy_q80": _webp_save(a, "RGB", quality=80),
        "webp_lossy_q5_flat": _webp_save(flat, "RGB", quality=5),
        "webp_lossy_q100_method6": _webp_save(a, "RGB", quality=100, method=6),
        "webp_lossy_1x1": _webp_save(a[:1, :1], "RGB"),
        "webp_lossy_odd_17x33": _webp_save(_picture(17, 33), "RGB", quality=60),
        "webp_lossy_even_48x64": _webp_save(_picture(48, 64), "RGB", quality=40, method=0),
        "webp_lossy_alpha": _webp_save(a4, "RGBA", quality=70),
    }
    frames = [Image.fromarray(_picture(30, 40)) for _ in range(2)]
    for lossless in (False, True):
        buf = io.BytesIO()
        frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], lossless=lossless,
                       duration=40)
        files[f"webp_animated_{'lossless' if lossless else 'lossy'}"] = buf.getvalue()
    buf = io.BytesIO()
    rgba = [Image.fromarray(_picture(26, 34, 4)) for _ in range(2)]
    rgba[0].save(buf, "WEBP", save_all=True, append_images=rgba[1:], quality=60)
    files["webp_animated_rgba"] = buf.getvalue()
    for name, simple, sharpness, deltas in (("simple_filter", 1, 0, None),
                                            ("normal_sharpness6", 0, 6, None),
                                            ("simple_sharpness3_deltas", 1, 3, (5, -3)),
                                            ("normal_sharpness2_deltas", 0, 2, (-4, 9))):
        files[f"webp_lossy_{name}"] = _vp8_with_filter(files["webp_lossy_q5_flat"], simple,
                                                       sharpness, deltas)
    alpha = np.asarray(Image.open(io.BytesIO(files["webp_lossy_alpha"])).convert("RGBA"))[..., 3]
    for filt in range(4):
        files[f"webp_alpha_raw_filter{filt}"] = _with_raw_alpha(files["webp_lossy_alpha"], alpha,
                                                                filt)
    return files


def _pil_bytes(im, fmt, **kw):
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _natural(rng, h, w):
    """A smooth picture with a little noise (sky, shading): long literal
    runs with few matches."""
    y, x = np.mgrid[0:h, 0:w] / 16.0
    base = [np.sin(x * (1 + k) + np.cos(y * (2 - k * 0.3))) * 60 + 120
            + 20 * np.sin(x * y / 9 + k) for k in range(3)]
    return np.clip(np.stack(base, -1) + rng.normal(0, 3, (h, w, 3)), 0, 255).astype(np.uint8)


def _zstd_strip_tiff(samples) -> bytes:
    """An RGB TIFF in one ZSTD strip (a frame of the test's writing, which
    libtiff's encoder does not make): a compressed block holding the
    leading run of one byte as RLE literals and no sequences, a raw block,
    an RLE block of the trailing run, and the content checksum."""
    from unimp_tpu_torch.data.zstd import _xxh64

    content = samples.tobytes()
    run = len(content) - len(content.lstrip(content[:1]))
    tail = len(content) - len(content.rstrip(content[-1:]))
    assert 32 <= run < 4096 and tail > 0
    lit = bytes([1 | (1 << 2) | ((run & 15) << 4), run >> 4]) + content[:1] + b"\0"
    mid = content[run:len(content) - tail]

    def head(size, kind, last=0):
        return struct.pack("<I", (size << 3) | (kind << 1) | last)[:3]

    frame = (struct.pack("<IB", 0xFD2FB528, (2 << 6) | (1 << 5) | 4)  # 4-byte size, checksum
             + struct.pack("<I", len(content)) + head(len(lit), 2) + lit + head(len(mid), 0)
             + mid + head(tail, 1, 1) + content[-1:]
             + struct.pack("<I", _xxh64(content) & 0xFFFFFFFF))
    return _tiff(samples, 2, compression=50000, chunks=[frame])


def _zstd_and_float_tiffs():
    """ZSTD TIFFs (libtiff's encoder through PIL, the predictor off and
    on; the pictures chosen so that together they reach every kind of
    block, literals and sequence table, ``ZSTD_KINDS``) and 32-bit float
    TIFFs (NaN, infinities, values outside 0-255), from a generator of
    their own: the other fixtures keep their bytes."""
    rng = np.random.default_rng(15)
    tiles = np.tile(rng.integers(0, 256, (16, 16, 3)), (20, 25, 1))
    tiles += rng.integers(0, 3, tiles.shape) * (rng.random(tiles.shape[:2]) < 0.05)[..., None]
    pictures = {
        "flat": (np.full((37, 53, 3), 97, np.uint8), None),
        "noisy": (rng.integers(0, 256, (37, 53, 3), dtype=np.uint8), None),
        "natural": (_natural(rng, 64, 80), None),
        # one strip past a 128 KiB block: the second block is one byte
        "flat_one_strip": (np.full((190, 256, 3), 97, np.uint8), 190),
        "small": ((rng.integers(0, 4, (6, 12, 3)) * 60).astype(np.uint8), None),
        "stripes": (np.repeat(np.repeat(rng.integers(0, 4, (20, 1, 1)), 8, 0), 300, 1)
                    .astype(np.uint8).repeat(3, 2), 160),
        "steps": ((np.arange(256)[None, :, None] // 32 * 30).repeat(120, 0).repeat(3, 2)
                  .astype(np.uint8), 120),
        "sixteen_levels": (rng.integers(0, 16, (300, 400, 3)).astype(np.uint8), 300),
        "tiles": (tiles.astype(np.uint8), 320),
        # a draw (seed 35) whose sequences, under the predictor, share one offset code
        "small_one_offset": ((np.random.default_rng(35).integers(0, 4, (6, 12, 3)) * 60)
                             .astype(np.uint8), None),
    }
    files = {}
    for name, (pic, rows) in pictures.items():
        for predictor in (1, 2):
            info = {} if rows is None else {278: rows}
            if predictor == 2:
                info[317] = 2
            files[f"tiff_pil_zstd_{name}" + ("_predictor" if predictor == 2 else "")] = \
                _pil_save(pic, "RGB", "TIFF", compression="zstd", tiffinfo=info)
    hand = np.concatenate([np.full(200, 40, np.uint8), rng.integers(0, 256, 216, np.uint8),
                           np.full(64, 200, np.uint8)]).reshape(10, 16, 3)
    files["tiff_zstd_rle_literals"] = _zstd_strip_tiff(hand)
    special = np.array([np.nan, np.inf, -np.inf, 255.0, 254.99, 0.5, -0.0, 1e-40, -3.5,
                        255.5, 1e30, 127.9], np.float32)
    floats = np.concatenate([rng.random(209).astype(np.float32) * 400 - 50, special])
    floats = rng.permutation(floats).reshape(13, 17)
    for comp, info, tag in (("raw", {}, ""), ("tiff_adobe_deflate", {}, ""),
                            ("tiff_adobe_deflate", {317: 3}, "_predictor"), ("zstd", {}, ""),
                            ("tiff_lzw", {317: 3}, "_predictor")):
        files[f"tiff_pil_float_{comp}{tag}"] = _pil_bytes(Image.fromarray(floats, "F"), "TIFF",
                                                          compression=comp, tiffinfo=info)
    return files


ZSTD_DECOMPRESS = zstd.decompress
FILES = {**_jpegs(), **_pngs(), **_gifs(), **_bmps(), **_tiffs(), **_arith_and_lossless(),
         **_webps(), **_zstd_and_float_tiffs()}
# which kinds of Zstandard data (``data/zstd.py``'s names) each ZSTD
# fixture's strips reach; together: every kind of block, literals, Huffman
# weights and sequence table, repeat offsets and checksums (skippable and
# several frames: ``test_zstd_frames_equal_libzstd``)
ZSTD_KINDS = {
    "tiff_pil_zstd_flat": {"literals raw", "literal lengths predefined", "offsets predefined",
                           "match lengths predefined", "block compressed"},
    "tiff_pil_zstd_flat_predictor": {"offset repeat"},
    "tiff_pil_zstd_noisy": {"block raw"},
    "tiff_pil_zstd_natural": {"literals huffman", "literals 4 streams", "weights fse"},
    "tiff_pil_zstd_flat_one_strip": {"block rle"},
    "tiff_pil_zstd_small": {"literals 1 stream", "match lengths fse"},
    "tiff_pil_zstd_small_predictor": {"match lengths rle"},
    "tiff_pil_zstd_small_one_offset_predictor": {"offsets rle"},
    "tiff_pil_zstd_stripes": {"literal lengths rle", "offsets fse", "offsets repeat"},
    "tiff_pil_zstd_sixteen_levels": {"literals treeless", "weights direct",
                                     "literal lengths fse", "match lengths fse"},
    "tiff_pil_zstd_tiles": {"literal lengths repeat", "match lengths repeat"},
    "tiff_zstd_rle_literals": {"literals rle", "checksum", "block raw", "block rle"},
}


def _pil_rgb(data):
    ImageFile.LOAD_TRUNCATED_IMAGES = True
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


@pytest.mark.parametrize("name", list(FILES))
def test_decode_equals_pil(name):
    data = FILES[name]
    got = transforms.decode_image(data)
    want = _pil_rgb(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_the_files_are_what_they_claim():
    """The markers and headers that make each case what it is named."""
    files = FILES
    sof = {name: next(files[name][i + 1] for i in range(len(files[name]) - 1)
                      if files[name][i] == 0xFF
                      and files[name][i + 1] in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA))
           for name in files if name.startswith("jpeg")}
    for name in files:
        if name.startswith("jpeg_arith_seq"):
            assert sof[name] == 0xC9, name
        elif name.startswith("jpeg_arith_progressive"):
            assert sof[name] == 0xCA, name
        elif name.startswith("jpeg_lossless"):
            assert sof[name] == 0xC3, name
    assert b"\xff\xcc" in files["jpeg_arith_seq_dac"]
    assert b"\xff\xd0" in files["jpeg_arith_seq_restart"]
    tiff_comp = {name: tiff._ifd(files[name])[0][259][0] for name in files
                 if name.startswith("tiff")}
    for name, want in (("tiff_pil_group3_2d", 3), ("tiff_pil_group4", 4),
                       ("tiff_pil_tiff_ccitt", 2),
                       ("tiff_pil_lzma_rgb", 34925), ("tiff_pil_jpeg_ycbcr", 7),
                       ("tiff_pil_tiff_lzw_rgb", 5), ("tiff_pil_packbits_rgb", 32773),
                       ("tiff_planar_deflate", 8)):
        assert tiff_comp[name] == want, name
    assert tiff._ifd(files["tiff_pil_group3_2d"])[0][292] == (1,)
    assert tiff._ifd(files["tiff_pil_lzw_predictor"])[0][317] == (2,)
    assert files["tiff_bigtiff_tiles_deflate"][2] == 43
    assert files["tiff_rgb16_big_endian"][:2] == b"MM"
    assert files["tiff_bigtiff_strips"][:4] == b"II+\x00"
    assert 322 in tiff._ifd(files["tiff_tiles_planar_packbits"])[0]
    kinds = {name: [t for t, _ in webp._chunks(files[name])] for name in files
             if name.startswith("webp")}
    for name, first in kinds.items():
        want = (b"VP8L" if "lossless" in name and "animated" not in name else
                b"VP8X" if "alpha" in name or "animated" in name else b"VP8 ")
        assert first[0] == want, name
    assert b"ALPH" in kinds["webp_lossy_alpha"] and b"ANMF" in kinds["webp_animated_rgba"]
    for name in ("simple_filter", "normal_sharpness6", "simple_sharpness3_deltas",
                 "normal_sharpness2_deltas"):  # the new filter header changes the pixels
        assert not np.array_equal(_pil_rgb(files[f"webp_lossy_{name}"]),
                                  _pil_rgb(files["webp_lossy_q5_flat"])), name
    assert sof["jpeg_progressive"] == sof["jpeg_gray_progressive"] == 0xC2
    assert sof["jpeg_16bit_tables"] == 0xC1 and sof["jpeg_baseline"] == 0xC0
    assert b"\xff\xdd" in files["jpeg_restart_every_mcu"]
    assert files["jpeg_non_interleaved"].count(b"\xff\xda") == 3
    assert jpeg.component_count(files["jpeg_cmyk"]) == 4
    assert jpeg.component_count(files["jpeg_ycck_adobe2"]) == 4
    assert not files["jpeg_truncated"].endswith(b"\xff\xd9")
    for name, ctype, depth, interlace in (("png_rgba16_adam7", 6, 16, 1),
                                          ("png_gray1_adam7", 0, 1, 1),
                                          ("png_la16", 4, 16, 0)):
        ihdr = files[name][16:29]
        assert (ihdr[9], ihdr[8], ihdr[12]) == (ctype, depth, interlace), name
    for name in ("gif_pil_transparency", "gif_local_palette_offset_transparent"):
        assert b"\x21\xf9\x04\x01" in files[name], name
    assert Image.open(io.BytesIO(files["gif_pil_animated"])).n_frames == 2
    assert files["gif_interlaced"][13 + 48 + 9] & 0x40  # after the header and palette
    for name, compression in (("bmp_rle8", 1), ("bmp_rle4", 2), ("bmp_16bit_565_bitfields", 3),
                              ("bmp_32bit_bitfields_rgba_v4", 3), ("bmp_24bit_v5_top_down", 0)):
        assert struct.unpack_from("<I", files[name], 30)[0] == compression, name
    assert struct.unpack_from("<i", files["bmp_24bit_v5_top_down"], 22)[0] < 0
    assert struct.unpack_from("<I", files["bmp_os2_8bit"], 14)[0] == 12
    assert len(files["bmp_truncated"]) < struct.unpack_from("<I", files["bmp_truncated"], 2)[0]


@pytest.mark.parametrize("name", [n for n in FILES if n.startswith("webp")
                                  and Image.open(io.BytesIO(FILES[n])).mode == "RGBA"])
def test_webp_alpha_equals_pil(name):
    """The alpha ``convert("RGB")`` drops: ALPH (compressed or raw, each
    filter) and VP8L alpha equal PIL's RGBA, not premultiplied."""
    data = FILES[name]
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    np.testing.assert_array_equal(webp.decode_webp_rgba(data), want)
    assert len(np.unique(want[..., 3])) > 2


CUT_PROGRESSIVE = {"jpeg_progressive_optimized": (0.2, 0.5, 0.65),
                   "jpeg_gray_progressive": (0.65,), "jpeg_progressive": (0.5,)}


@pytest.mark.parametrize("name,frac", [(n, f) for n, fs in CUT_PROGRESSIVE.items() for f in fs])
def test_cut_progressive_jpeg_is_block_smoothed(tmp_path, name, frac):
    """A progressive JPEG cut inside a scan is block-smoothed as
    libjpeg-turbo does it: equal to the JAX package's ``load_resized_uint8``
    (its native pipe, libjpeg-turbo with a fake EOI at the cut) and, where
    PIL's incremental feed outputs the image, to PIL."""
    data = FILES[name][:int(len(FILES[name]) * frac)]
    path = tmp_path / "cut.jpg"
    path.write_bytes(data)
    for size in (28, 64):
        np.testing.assert_array_equal(transforms.load_resized_uint8(str(path), size),
                                      j_transforms.load_resized_uint8(str(path), size))
    got, want = transforms.decode_image(data), _pil_rgb(data)
    if (name, frac) != ("jpeg_progressive", 0.5):  # here PIL's image differs by 1 (untraced)
        np.testing.assert_array_equal(got, want)
    unsmoothed = jpeg._block_smoothing
    try:
        jpeg._block_smoothing = lambda frame, coefs, *a: coefs
        assert not np.array_equal(transforms.decode_image(data), got)  # smoothing mattered
    finally:
        jpeg._block_smoothing = unsmoothed


# random cuts (one draw) of the four progressive files that still differ
# from the JAX package's native pipe after block smoothing and the black
# image of a cut table: (file, length) -> max |Δ| at 28 and 64 px
PROGRESSIVE_CUTS_UNEQUAL = {}
# the cuts of that draw where libjpeg-turbo's SIMD IDCT saturates a block's
# 16-bit lanes, so that its C path (``JSIMD_FORCENONE``) gives other pixels
SIMD_SATURATED_CUTS = {("jpeg_gray_progressive", 377)}


@contextlib.contextmanager
def _c_idct_decoder():
    """The port with libjpeg's C islow IDCT (32-bit, its range-limit table)
    in place of the SIMD one."""
    simd = jpeg.idct_blocks
    jpeg.idct_blocks = lambda coef, quant: jpeg.idct_islow(coef * quant)
    try:
        yield
    finally:
        jpeg.idct_blocks = simd


def _jax_pipe_c_path(paths, sizes=(28, 64)) -> list:
    """The JAX package's ``load_resized_uint8`` of each path at each size
    with libjpeg-turbo's SIMD off (``JSIMD_FORCENONE``, read when the
    library loads: a process of its own)."""
    import pickle
    import subprocess

    script = ("import sys, pickle\n"
              "from unimp_tpu.data import transforms\n"
              "paths, sizes = pickle.load(sys.stdin.buffer)\n"
              "out = [[transforms.load_resized_uint8(p, s) for s in sizes] for p in paths]\n"
              "sys.stdout.buffer.write(pickle.dumps(out))\n")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", script], input=pickle.dumps((paths, sizes)),
                         capture_output=True, check=True, cwd=str(root),
                         env={**os.environ, "JSIMD_FORCENONE": "1", "JAX_PLATFORMS": "cpu",
                              "PYTHONPATH": str(root)})
    return pickle.loads(out.stdout)


def test_cut_progressive_jpeg_random_cuts(tmp_path):
    """87 random cuts of the four progressive files against the JAX
    package's ``load_resized_uint8`` (its native pipe: libjpeg-turbo with
    a fake EOI): 86 equal. Traced and repaired: a refinement scan's new
    coefficient past the band's end goes where libjpeg's natural order
    runs on to (its entry 63, ``jdphuff.c decode_mcu_AC_refine``), and
    where the data ends with a whole restart interval libjpeg reads the
    next interval's first MCU from zero bits (the fake EOI stands for its
    RSTn). The cut of ``SIMD_SATURATED_CUTS`` has a smoothed block that
    saturates libjpeg-turbo's SIMD IDCT in its 16-bit lanes: the port's
    emulation of that IDCT equals the pipe there (all 87 equal), and the
    port with libjpeg's C IDCT equals the pipe with its SIMD off and differs
    from the SIMD pipe. Cuts inside a later table or scan header are equal
    (``test_cut_inside_a_later_table_or_scan_header_is_black``)."""
    rng = np.random.default_rng(0)
    unequal, paths = {}, {}
    for name in ("jpeg_progressive", "jpeg_progressive_optimized", "jpeg_progressive_restart",
                 "jpeg_gray_progressive"):
        data = FILES[name]
        for n in sorted(set(rng.integers(data.index(b"\xff\xda") + 10, len(data) - 2,
                                         22).tolist())):
            path = tmp_path / f"{name}_{n}.jpg"
            path.write_bytes(data[:n])
            worst = max(int(np.abs(transforms.load_resized_uint8(str(path), size).astype(int)
                                   - j_transforms.load_resized_uint8(str(path), size)).max())
                        for size in (28, 64))
            if worst:
                unequal[name, n] = worst
            if (name, n) in SIMD_SATURATED_CUTS:
                paths[name, n] = str(path)
    assert unequal == PROGRESSIVE_CUTS_UNEQUAL and set(paths) == SIMD_SATURATED_CUTS
    for key, want in zip(paths, _jax_pipe_c_path(list(paths.values()))):
        for size, w in zip((28, 64), want):
            with _c_idct_decoder():
                np.testing.assert_array_equal(transforms.load_resized_uint8(paths[key], size), w)
            assert not np.array_equal(transforms.load_resized_uint8(paths[key], size), w)


def _marker_after_first_scan(data: bytes, marker: bytes) -> int:
    """The offset of the first ``marker`` segment after the first scan."""
    return data.index(marker, data.index(b"\xff\xda") + 2)


@pytest.mark.parametrize("name", ["jpeg_progressive", "jpeg_progressive_optimized",
                                  "jpeg_progressive_restart", "jpeg_gray_progressive"])
@pytest.mark.parametrize("where", ["table_length", "table_counts", "scan_header"])
def test_cut_inside_a_later_table_or_scan_header_is_black(tmp_path, name, where):
    """A progressive file cut inside the Huffman table or scan header
    that follows a scan: libjpeg reads its source's fake EOI bytes as the
    rest of the segment, refuses the table's counts or the scan's
    components and stops; PIL and the JAX package keep a black image."""
    data = FILES[name]
    dht = _marker_after_first_scan(data, b"\xff\xc4")
    sos = data.index(b"\xff\xda", dht)
    cut = data[:{"table_length": dht + 3, "table_counts": dht + 8, "scan_header": sos + 7}[where]]
    path = tmp_path / "cut.jpg"
    path.write_bytes(cut)
    got = transforms.decode_image(cut)
    assert not got.any()
    np.testing.assert_array_equal(got, _pil_rgb(cut))
    for size in (28, 64):
        np.testing.assert_array_equal(transforms.load_resized_uint8(str(path), size),
                                      j_transforms.load_resized_uint8(str(path), size))


@pytest.mark.parametrize("frac", [0.3, 0.6, 0.9])
@pytest.mark.parametrize("name", ["jpeg_lossless_rgb_p1", "jpeg_lossless_rgb_p5",
                                  "jpeg_lossless_gray_p4_pt2", "jpeg_lossless_rgb_ids_p7"])
def test_cut_lossless_jpeg_equals_pil_and_jax(tmp_path, name, frac):
    """A lossless JPEG cut inside its data: the row whose decoding reads
    past the data reads zero bits; every later row is CENTERJSAMPLE, as
    libjpeg-turbo's ``decode_mcus`` resets the undifferencer on each row
    once the data ran out. Equal to PIL (with its fake EOI) and to the
    JAX package (which reads lossless files through PIL)."""
    cut = FILES[name][:int(len(FILES[name]) * frac)]
    got = transforms.decode_image(cut)
    np.testing.assert_array_equal(got, _pil_rgb(cut))
    assert (got[-1] == 128).all()
    path = tmp_path / "cut.jpg"
    path.write_bytes(cut)
    for size in (28, 64):
        np.testing.assert_array_equal(transforms.load_resized_uint8(str(path), size),
                                      j_transforms.load_resized_uint8(str(path), size))


@pytest.mark.parametrize("frac", [0.3, 0.7])
@pytest.mark.parametrize("mode", ["rgb", "l", "cmyk"])
def test_cut_uncompressed_tiff_keeps_whole_rows(tmp_path, mode, frac):
    """An uncompressed TIFF cut inside its strip: whole rows decoded, the
    cut row and the rest zero samples (black; white in CMYK), as PIL's raw
    decoder leaves them. The JAX
    package reads the RGB file through PIL to the same pixels; for the
    gray and CMYK files its own buffer handling raises."""
    cut = FILES[f"tiff_pil_raw_{mode}"][:int(len(FILES[f"tiff_pil_raw_{mode}"]) * frac)]
    got = transforms.decode_image(cut)
    np.testing.assert_array_equal(got, _pil_rgb(cut))
    assert len(np.unique(got[-1])) == 1
    path = tmp_path / "cut.tif"
    path.write_bytes(cut)
    for size in (28, 64):
        if mode == "rgb":
            np.testing.assert_array_equal(transforms.load_resized_uint8(str(path), size),
                                          j_transforms.load_resized_uint8(str(path), size))
        else:
            with pytest.raises(ValueError, match="buffer is not large enough"):
                j_transforms.load_resized_uint8(str(path), size)


def _libjpeg_c_path(datas, simd: str = "NONE") -> list:
    """PIL's decodes of ``datas`` with libjpeg-turbo's SIMD level forced
    (``JSIMD_FORCE{simd}``, read when the library loads: a process of its
    own; ``NONE`` is its C path), each with a fake EOI after it as the JAX
    package's pipe gives libjpeg one."""
    import subprocess

    import pickle

    script = ("import io, sys, pickle, numpy\n"
              "from PIL import Image, ImageFile\n"
              "ImageFile.LOAD_TRUNCATED_IMAGES = True\n"
              "out = []\n"
              "for x in pickle.load(sys.stdin.buffer):\n"
              "    with Image.open(io.BytesIO(x + b'\\xff\\xd9')) as im:\n"
              "        out.append(numpy.asarray(im.convert('RGB')))\n"
              "sys.stdout.buffer.write(pickle.dumps(out))\n")

    out = subprocess.run([sys.executable, "-c", script], input=pickle.dumps(list(datas)),
                         capture_output=True, check=True,
                         env={**{k: v for k, v in os.environ.items()
                                  if not k.startswith("JSIMD_")}, f"JSIMD_FORCE{simd}": "1"})
    return pickle.loads(out.stdout)


def _scan_cuts(data: bytes, step: int) -> list:
    """``data`` cut at every ``step``-th byte from its first scan's data on."""
    sos = data.index(b"\xff\xda")
    start = sos + 3 + int.from_bytes(data[sos + 2:sos + 4], "big")
    return [data[:k] for k in range(start, len(data) - 2, step)]


ARITH_CUT_EQUAL = ["jpeg_arith_seq_ycc420", "jpeg_arith_seq_ycc420_per_component",
                   "jpeg_arith_seq_restart", "jpeg_arith_seq_dac", "jpeg_arith_seq_gray",
                   "jpeg_arith_progressive_gray_restart"]


# cuts at every 7th byte of each file's scans where libjpeg-turbo's SIMD
# and C IDCTs give other pixels (33 of 419 over the sequential files)
ARITH_SIMD_SATURATED = {"jpeg_arith_seq_ycc420": 12, "jpeg_arith_seq_ycc420_per_component": 7,
                        "jpeg_arith_seq_restart": 7, "jpeg_arith_seq_dac": 5,
                        "jpeg_arith_seq_gray": 2, "jpeg_arith_progressive_gray_restart": 0}


@pytest.mark.parametrize("name", ARITH_CUT_EQUAL)
def test_cut_arithmetic_jpeg_equals_libjpeg(name):
    """An arithmetic-coded JPEG cut at every 5th and every 7th byte of its
    scans: the QM decoder reads zero bytes past the cut, a bad code (an
    overflow) ends its restart interval as ``jdarith.c`` sets ``ct = -1``,
    the intervals after the cut are read from zero bytes with fresh
    statistics, and a progressive file is block-smoothed (a cut arithmetic
    scan is no "insufficient data" to libjpeg: every row counts as good).
    Equal at every cut to libjpeg-turbo as PIL and the JAX package run it
    (its AVX2 IDCT; its SSE2 IDCT gives the same pixels), and, with the
    port's C IDCT, to libjpeg-turbo's C path.

    The zero bytes decode to coefficients in the thousands (6,190 at one
    cut of the 4:2:0 file), which the SIMD islow IDCT saturates in 16-bit
    lanes where the C IDCT wraps: ``ARITH_SIMD_SATURATED`` counts the cuts
    at every 7th byte where the two libjpeg paths differ. PIL's incremental
    feed cannot suspend an arithmetic scan (``JERR_CANT_SUSPEND``: a black
    or partial image), so the oracle gets each cut with a fake EOI."""
    cuts = _scan_cuts(FILES[name], 5) + _scan_cuts(FILES[name], 7)
    n5 = len(_scan_cuts(FILES[name], 5))
    simd, sse2, c_path = (_libjpeg_c_path(cuts, level) for level in ("AVX2", "SSE2", "NONE"))
    for k, (cut, want) in enumerate(zip(cuts, simd)):
        np.testing.assert_array_equal(transforms.decode_image(cut), want, err_msg=str(k))
        np.testing.assert_array_equal(sse2[k], want, err_msg=str(k))
    with _c_idct_decoder():
        for k, (cut, want) in enumerate(zip(cuts, c_path)):
            np.testing.assert_array_equal(transforms.decode_image(cut), want, err_msg=str(k))
    saturated = sum(not np.array_equal(a, b) for a, b in zip(simd[n5:], c_path[n5:]))
    assert saturated == ARITH_SIMD_SATURATED[name]


def test_cut_arithmetic_progressive_420_jpeg_differs_by_at_most_19(tmp_path):
    """The 4:2:0 progressive arithmetic file, cut at every 5th byte of its
    scans, equals the JAX package's ``load_resized_uint8`` at every cut
    (28 and 64 px), and, with the port's C IDCT, the same with libjpeg's
    SIMD off. The differences in its second iMCU row, up to 19, were
    against PIL's decode of the cut file (an incremental feed, which
    libjpeg cannot suspend inside an arithmetic scan), not the JAX
    package's one-shot read of its bytes. The JAX package's SIMD and C
    paths differ at the 4 cuts below, whose zero bytes decode to
    coefficients that the SIMD IDCT saturates in 16-bit lanes."""
    cuts = _scan_cuts(FILES["jpeg_arith_progressive_ycc420"], 5)
    paths = []
    for k, cut in enumerate(cuts):
        paths.append(str(tmp_path / f"{k}.jpg"))
        Path(paths[-1]).write_bytes(cut)
    simd = {}
    for k, (path, want) in enumerate(zip(paths, _jax_pipe_c_path(paths))):
        for size, w in zip((28, 64), want):
            got = transforms.load_resized_uint8(path, size)
            np.testing.assert_array_equal(got, j_transforms.load_resized_uint8(path, size),
                                          err_msg=str(k))
            with _c_idct_decoder():
                np.testing.assert_array_equal(transforms.load_resized_uint8(path, size), w,
                                              err_msg=str(k))
            d = int(np.abs(got.astype(int) - w).max())
            if d:
                simd[k] = max(simd.get(k, 0), d)
    assert len(cuts) == 154 and simd == {4: 255, 52: 242, 83: 254, 135: 202}


@pytest.mark.parametrize("name", ["webp_lossy_q80", "webp_lossless", "webp_lossy_alpha"])
def test_cut_webp_raises_as_pil_does(name):
    data = FILES[name][:-40]
    with pytest.raises(ValueError, match="truncated WebP"):
        transforms.decode_image(data)
    with pytest.raises(OSError):  # LOAD_TRUNCATED_IMAGES is on
        _pil_rgb(data)


@pytest.mark.parametrize("name", list(FILES))
@pytest.mark.parametrize("size", [28, 64])
def test_load_resized_uint8_equals_jax(tmp_path, name, size):
    """The JAX package resizes a 1- or 3-component JPEG through its native
    pipe and a PNG or a CMYK JPEG (which the pipe declines) through PIL;
    the port picks the same for each file."""
    path = tmp_path / name
    path.write_bytes(FILES[name])
    got = transforms.load_resized_uint8(str(path), size)
    want = j_transforms.load_resized_uint8(str(path), size)
    assert got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["jpeg_progressive", "png_rgba", "png_rgb16"])
def test_worker_frames_equal_jax(name):
    fake = types.SimpleNamespace(image_size=32)
    b64 = [base64.b64encode(FILES[name]).decode()]
    got = ModelWorker.decode_images(fake, b64)
    want = j_worker.ModelWorker._decode_images(fake, b64)
    assert got.shape == (1, 1, 32, 32, 3)
    np.testing.assert_array_equal(got, want)


def _patched_sof(marker=None, precision=None, height=None):
    data = bytearray(FILES["jpeg_baseline"])
    i = data.index(b"\xff\xc0")
    if marker is not None:
        data[i + 1] = marker
    if precision is not None:
        data[i + 4] = precision
    if height is not None:
        data[i + 5:i + 7] = height.to_bytes(2, "big")
    return bytes(data)


def _tiff_with_compression(code):
    """A small deflate TIFF with its Compression tag set to ``code``."""
    data = bytearray(_tiff(_picture(9, 9), 2, compression=8))
    i = data.index(struct.pack("<HHI", 259, 3, 1))
    data[i + 8:i + 10] = struct.pack("<H", code)
    return bytes(data)


def _float_tiff(bps):
    """A gray floating-point TIFF of ``bps``-bit samples (16 or 64), which
    libtiff writes and PIL does not open."""
    vals = np.arange(12, dtype={16: "<f2", 64: "<f8"}[bps]).reshape(3, 4, 1) * 20
    return _tiff(vals.view(f"<u{bps // 8}").astype(np.int64), 1, bps=bps, sample_format=3)


ZSTD_EVERY_KIND = {f"{table} {mode}" for table in ("literal lengths", "offsets", "match lengths")
                   for mode in ("predefined", "rle", "fse", "repeat")} | {
    f"block {k}" for k in ("raw", "rle", "compressed")} | {
    f"literals {k}" for k in ("raw", "rle", "huffman", "treeless", "1 stream", "4 streams")} | {
    "weights direct", "weights fse", "offset repeat", "checksum"}


def test_zstd_tiff_fixtures_reach_every_kind(monkeypatch):
    """Each ZSTD fixture reaches the kinds ``ZSTD_KINDS`` names for it (its
    equality to PIL and to the JAX package is ``test_decode_equals_pil``
    and ``test_load_resized_uint8_equals_jax``), and together they reach
    every kind."""
    seen_all = set()
    for name, want in ZSTD_KINDS.items():
        seen = set()
        monkeypatch.setattr(zstd, "decompress", functools.partial(ZSTD_DECOMPRESS, kinds=seen))
        transforms.decode_image(FILES[name])
        assert want <= seen, (name, sorted(want - seen))
        seen_all |= seen
    assert ZSTD_EVERY_KIND <= seen_all, sorted(ZSTD_EVERY_KIND - seen_all)


def _libzstd():
    """PIL's bundled libzstd (its TIFF codec), through ctypes."""
    import ctypes
    import PIL

    (path,) = Path(PIL.__file__).parents[1].glob("pillow.libs/libzstd*")
    lib = ctypes.CDLL(str(path))
    lib.ZSTD_compressBound.restype = lib.ZSTD_compress2.restype = ctypes.c_size_t
    lib.ZSTD_decompress.restype = lib.ZSTD_getFrameContentSize.restype = ctypes.c_size_t
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    return lib


@pytest.mark.parametrize("level", [1, 19])
@pytest.mark.parametrize("kind", ["text", "noise", "runs", "geometric"])
def test_zstd_frames_equal_libzstd(kind, level):
    """libzstd's frames at two levels, with content checksums, two of them
    around a skippable frame: ``data/zstd.py`` gives what libzstd's own
    decoder gives, and the input; a flipped checksum byte raises."""
    import ctypes

    lib = _libzstd()
    rng = np.random.default_rng(3)
    data = {"text": b" ".join(rng.choice([b"the", b"item", b"beauty", b"review", b"of"], 30000)),
            "noise": rng.integers(0, 256, 70000, np.uint8).tobytes(),
            "runs": np.repeat(rng.integers(0, 3, 5000), rng.integers(1, 40, 5000))
            .astype(np.uint8).tobytes(),
            "geometric": np.minimum(rng.geometric(0.02, 150000), 255).astype(np.uint8)
            .tobytes()}[kind]

    def compress(raw):
        cctx = ctypes.c_void_p(lib.ZSTD_createCCtx())
        lib.ZSTD_CCtx_setParameter(cctx, 100, level)  # ZSTD_c_compressionLevel
        lib.ZSTD_CCtx_setParameter(cctx, 201, 1)  # ZSTD_c_checksumFlag
        cap = lib.ZSTD_compressBound(len(raw))
        buf = ctypes.create_string_buffer(cap)
        n = lib.ZSTD_compress2(cctx, buf, ctypes.c_size_t(cap), raw, ctypes.c_size_t(len(raw)))
        lib.ZSTD_freeCCtx(cctx)
        return buf.raw[:n]

    half = len(data) // 2
    frames = (compress(data[:half]) + struct.pack("<II", 0x184D2A5F, 3) + b"pad"
              + compress(data[half:]))
    out = ctypes.create_string_buffer(len(data))
    n = lib.ZSTD_decompress(out, ctypes.c_size_t(len(data)), frames, ctypes.c_size_t(len(frames)))
    assert out.raw[:n] == data
    kinds = set()
    assert zstd.decompress(frames, kinds) == data
    assert {"checksum", "skippable frame", "frames"} <= kinds
    bad = bytearray(frames)
    bad[len(compress(data[:half])) - 1] ^= 1  # the first frame's checksum
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(bad))


# formats the port refuses: name -> (the file, whether PIL reads it); one
# that PIL reads stands in ROADMAP.md's fault 5 as still to do
UNREAD = {
    "16-bit floating-point": (lambda: _float_tiff(16), False),
    "64-bit floating-point": (lambda: _float_tiff(64), False),
    "WebP": (lambda: _tiff_with_compression(50001), False),
    "SGILog": (lambda: _tiff_with_compression(34676), False),
    "old-style JPEG": (lambda: _tiff_with_compression(6), False),
    "hierarchical JPEG": (lambda: _patched_sof(marker=0xC5), False),
    "arithmetic-coded lossless JPEG": (lambda: _patched_sof(marker=0xCB), False),
    "12-bit": (lambda: _patched_sof(precision=12), False),
    "DNL": (lambda: _patched_sof(height=0), False),
    "lossless JPEG in YCbCr": (lambda: REFUSED["jpeg_lossless_ycc_p1"], False),
}


@pytest.mark.parametrize("name", list(UNREAD))
def test_unread_formats_raise_and_name_themselves(name):
    make, pil_reads = UNREAD[name]
    data = make()
    with pytest.raises(ValueError, match=name) as e:
        transforms.decode_image(data)
    assert "fault 5" in str(e.value)
    if pil_reads:  # still to do: ROADMAP.md's fault 5 names it
        assert name in (Path(__file__).parents[1] / "ROADMAP.md").read_text()
    else:  # parity: PIL refuses the same bytes
        ImageFile.LOAD_TRUNCATED_IMAGES = False
        try:
            with pytest.raises(Exception):
                Image.open(io.BytesIO(data)).load()
        finally:
            ImageFile.LOAD_TRUNCATED_IMAGES = True
    with pytest.raises(ValueError, match="not an image the port reads"):
        transforms.decode_image(b"plain text")
    with pytest.raises(ValueError, match="no SOI"):
        jpeg.decode_jpeg(b"\x00" + FILES["jpeg_baseline"])


# ---------------------------------------------------------------- committed fixtures

FIXTURE_DIR = Path(__file__).parent / "data" / "images"


def _fixture_picture(h=48, w=64):
    """A smooth scene with edges: gradients, a disc and bars."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // w, y * 255 // h, (x + y) * 127 // (w + h) + 64], -1)
    disc = (y - h / 2) ** 2 + (x - w / 3) ** 2 < (h / 4) ** 2
    img[disc] = (220, 40, 60)
    img[:, (x[0] // 6) % 2 == 1 & (x[0] > 2 * w // 3)] //= 2
    return img.astype(np.uint8)


def make_fixtures() -> dict:
    """The committed fixtures (name -> bytes): what the card's machine,
    which has no PIL, decodes in ``chip_smoke.py``'s phase 15."""
    a = _fixture_picture()
    a4 = np.concatenate([a, (np.mgrid[0:48, 0:64][1] * 4)[..., None].astype(np.uint8)], -1)
    frames = [Image.fromarray(a4), Image.fromarray(255 - a4)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], quality=70)
    comps = [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
    rgb_planes = jpeg.rgb_to_ycc(a.astype(np.int64))
    blocks = []
    for (cid, hs, vs, t), plane in zip(comps, rgb_planes):
        if hs == 1:  # 2x2 chroma averaging
            plane = (plane[0::2, 0::2] + plane[1::2, 0::2] + plane[0::2, 1::2]
                     + plane[1::2, 1::2] + 2) >> 2
        rows, cols = plane.shape[0] // 8, plane.shape[1] // 8
        q = np.asarray(range(2, 66)) if t == 0 else np.full(64, 9)
        coef = jpeg.fdct_islow(plane.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3)
                               .reshape(-1, 8, 8) - 128).reshape(-1, 64)
        zz = np.round(coef[:, jpeg.ZIGZAG] / 8 / q[np.arange(64)]).astype(np.int64)
        b = np.zeros((3 * vs, 4 * hs, 64), np.int64)
        b[:rows, :cols] = zz.reshape(rows, cols, 64)
        blocks.append(b)
    return {
        "webp_lossy.webp": _webp_save(a, "RGB", quality=75),
        "webp_lossless.webp": _webp_save(a, "RGB", lossless=True),
        "webp_animated_alpha.webp": buf.getvalue(),
        "tiff_lzw_predictor.tif": _pil_save(a, "RGB", "TIFF", compression="tiff_lzw",
                                            tiffinfo={317: 2}),
        "tiff_group4.tif": _pil_save(a, "1", "TIFF", compression="group4"),
        "tiff_jpeg_ycbcr.tif": _pil_save(a, "YCbCr", "TIFF", compression="jpeg", quality=85),
        "jpeg_arithmetic.jpg": _arith_jpeg(48, 64, comps, blocks, restart=4),
        "jpeg_arithmetic_progressive.jpg": _arith_jpeg(48, 64, comps, blocks, progressive=True),
        "jpeg_lossless.jpg": _lossless_jpeg(a, 4, app=_adobe(0)),
    }


def _fixture_names():
    return sorted(p.name for p in FIXTURE_DIR.iterdir() if p.suffix != ".npy")


@pytest.mark.parametrize("name", _fixture_names())
def test_committed_fixtures_equal_pil_and_their_arrays(name):
    """Each committed fixture decodes, in PIL and in the port, to its
    committed array (the card's oracle)."""
    data = (FIXTURE_DIR / name).read_bytes()
    want = np.load(FIXTURE_DIR / (Path(name).stem + ".npy"))
    np.testing.assert_array_equal(_pil_rgb(data), want)
    np.testing.assert_array_equal(transforms.decode_image(data), want)


def test_committed_fixtures_are_the_made_ones():
    """The committed files are what ``make_fixtures`` writes (none missing,
    none extra), so a change to a writer shows here."""
    made = make_fixtures()
    assert sorted(made) == _fixture_names()
    for name, data in made.items():
        assert _pil_rgb(data).shape == np.load(FIXTURE_DIR / (Path(name).stem + ".npy")).shape


if __name__ == "__main__":  # rewrite them: PYTHONPATH=. python tests/test_torch_images.py
    FIXTURE_DIR.mkdir(parents=True, exist_ok=True)
    for fname, fdata in make_fixtures().items():
        (FIXTURE_DIR / fname).write_bytes(fdata)
        np.save(FIXTURE_DIR / (Path(fname).stem + ".npy"), _pil_rgb(fdata))
