"""Images the port decodes without PIL, against PIL and the JAX package.

Every kind of file of ROADMAP.md §3's fault 5, made here at odd sizes: by
PIL (progressive JPEG with and without Huffman optimization, restart
markers, gray, CMYK, 16-bit quantization tables, a baseline file cut by
its last 200 bytes; PNG in RGB, RGBA, P with tRNS, L, LA, 16-bit gray) and
by the small writers below, which PIL does not offer (baseline JPEGs with
one component a scan: YCbCr, YCCK with the Adobe flag, RGB by the Adobe
flag and by its component ids; PNG with each of the five filters,
Adam7 interlacing, 1 / 2 / 4-bit gray and palette, 16-bit RGB and RGBA).
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


FILES = {**_jpegs(), **_pngs()}


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
    "GIF": lambda: _pil_save(_picture(9, 9), "P", "GIF"),
    "BMP": lambda: _pil_save(_picture(9, 9), "RGB", "BMP"),
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
