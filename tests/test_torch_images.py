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
BITFIELDS, RLE8, RLE4, a grey-ramp palette, a short palette, cut short).
Each is held bit for bit to ``np.asarray(Image.open(f).convert("RGB"))``
(``LOAD_TRUNCATED_IMAGES`` on), ``load_resized_uint8`` to the JAX
package's (its native pipe or its PIL fallback, as it picks), and the
serving worker's frames to the JAX worker's; formats still outside the
port raise a ``ValueError`` that names them.
"""

import base64
import io
import struct
import types
import zlib

import numpy as np
import pytest
from PIL import Image, ImageFile

from unimp_tpu.data import transforms as j_transforms
from unimp_tpu.serve import worker as j_worker
from unimp_tpu_torch.data import jpeg, png, transforms
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


FILES = {**_jpegs(), **_pngs(), **_gifs(), **_bmps()}


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
                      if files[name][i] == 0xFF and files[name][i + 1] in (0xC0, 0xC1, 0xC2))
           for name in files if name.startswith("jpeg")}
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


def _patched_sof(marker=None, precision=None):
    data = bytearray(FILES["jpeg_baseline"])
    i = data.index(b"\xff\xc0")
    if marker is not None:
        data[i + 1] = marker
    if precision is not None:
        data[i + 4] = precision
    return bytes(data)


UNREAD = {
    "TIFF": lambda: _pil_save(_picture(9, 9), "RGB", "TIFF"),
    "WebP": lambda: b"RIFF\x10\x00\x00\x00WEBPVP8 " + bytes(16),
    "arithmetic-coded": lambda: _patched_sof(marker=0xC9),
    "lossless": lambda: _patched_sof(marker=0xC3),
    "12-bit": lambda: _patched_sof(precision=12),
}


@pytest.mark.parametrize("name", list(UNREAD))
def test_unread_formats_raise_and_name_themselves(name):
    with pytest.raises(ValueError, match=name) as e:
        transforms.decode_image(UNREAD[name]())
    assert "fault 5" in str(e.value)
    with pytest.raises(ValueError, match="not an image the port reads"):
        transforms.decode_image(b"plain text")
    with pytest.raises(ValueError, match="no SOI"):
        jpeg.decode_jpeg(b"\x00" + FILES["jpeg_baseline"])
