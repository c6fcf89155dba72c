"""Baseline JPEG codec and bilinear resize in numpy.

The JAX package decodes item images with libjpeg (``unimp_tpu/native/
imagepipe.cc``) and writes them with PIL. The card's machine has neither
libjpeg nor a place in the port for PIL, so the port carries its own
codec, written to give libjpeg's (libjpeg-turbo's) numbers exactly:

  * decode: baseline Huffman, the integer "islow" IDCT (``jidctint.c``)
    with its 10-bit range-limit table, "fancy" (triangle) upsampling of
    2x2 and 2x1 chroma (``jdsample.c``) and the fixed-point YCbCr -> RGB
    tables (``jdcolor.c``);
  * encode: the fixed-point RGB -> YCbCr tables (``jccolor.c``), 2x2
    chroma averaging with the 1, 2, 1, 2 rounding bias (``jcsample.c``),
    libjpeg's edge replication and dummy blocks, the integer "islow" FDCT
    (``jfdctint.c``), quality-scaled standard tables and the standard
    Huffman tables, as PIL's ``save(quality=q)`` writes them;
  * resize: the pipe's separable triangle filter (PIL BILINEAR for
    downscaling), float32 operation for operation.

Progressive, arithmetic-coded, 12-bit, CMYK and restart-marker files are
refused. Huffman decoding is a Python loop (about a microsecond a
coefficient); everything else is vectorized over blocks.
"""

from __future__ import annotations

import functools

import numpy as np

# zigzag position -> natural (row-major) index in an 8x8 block
ZIGZAG = np.array(sorted(range(64), key=lambda i: (
    i // 8 + i % 8, (i // 8) if (i // 8 + i % 8) % 2 else -(i // 8))), np.int64)

# the JPEG standard's quantization tables (Annex K.1), in zigzag order
_LUMA_Q = (16, 11, 12, 14, 12, 10, 16, 14, 13, 14, 18, 17, 16, 19, 24, 40, 26, 24, 22, 22, 24,
           49, 35, 37, 29, 40, 58, 51, 61, 60, 57, 51, 56, 55, 64, 72, 92, 78, 64, 68, 87, 69,
           55, 56, 80, 109, 81, 87, 95, 98, 103, 104, 103, 62, 77, 113, 121, 112, 100, 120, 92,
           101, 103, 99)
_CHROMA_Q = (17, 18, 18, 24, 21, 24, 47, 26, 26, 47, 99, 66, 56, 66) + (99,) * 50

# the standard Huffman tables (Annex K.3): (bits per code length 1..16, values)
_DC_VALUES = tuple(range(12))
_AC_LUMA_VALUES = (
    1, 2, 3, 0, 4, 17, 5, 18, 33, 49, 65, 6, 19, 81, 97, 7, 34, 113, 20, 50, 129, 145, 161, 8,
    35, 66, 177, 193, 21, 82, 209, 240, 36, 51, 98, 114, 130, 9, 10, 22, 23, 24, 25, 26, 37,
    38, 39, 40, 41, 42, 52, 53, 54, 55, 56, 57, 58, 67, 68, 69, 70, 71, 72, 73, 74, 83, 84, 85,
    86, 87, 88, 89, 90, 99, 100, 101, 102, 103, 104, 105, 106, 115, 116, 117, 118, 119, 120,
    121, 122, 131, 132, 133, 134, 135, 136, 137, 138, 146, 147, 148, 149, 150, 151, 152, 153,
    154, 162, 163, 164, 165, 166, 167, 168, 169, 170, 178, 179, 180, 181, 182, 183, 184, 185,
    186, 194, 195, 196, 197, 198, 199, 200, 201, 202, 210, 211, 212, 213, 214, 215, 216, 217,
    218, 225, 226, 227, 228, 229, 230, 231, 232, 233, 234, 241, 242, 243, 244, 245, 246, 247,
    248, 249, 250)
_AC_CHROMA_VALUES = (
    0, 1, 2, 3, 17, 4, 5, 33, 49, 6, 18, 65, 81, 7, 97, 113, 19, 34, 50, 129, 8, 20, 66, 145,
    161, 177, 193, 9, 35, 51, 82, 240, 21, 98, 114, 209, 10, 22, 36, 52, 225, 37, 241, 23, 24,
    25, 26, 38, 39, 40, 41, 42, 53, 54, 55, 56, 57, 58, 67, 68, 69, 70, 71, 72, 73, 74, 83, 84,
    85, 86, 87, 88, 89, 90, 99, 100, 101, 102, 103, 104, 105, 106, 115, 116, 117, 118, 119,
    120, 121, 122, 130, 131, 132, 133, 134, 135, 136, 137, 138, 146, 147, 148, 149, 150, 151,
    152, 153, 154, 162, 163, 164, 165, 166, 167, 168, 169, 170, 178, 179, 180, 181, 182, 183,
    184, 185, 186, 194, 195, 196, 197, 198, 199, 200, 201, 202, 210, 211, 212, 213, 214, 215,
    216, 217, 218, 226, 227, 228, 229, 230, 231, 232, 233, 234, 242, 243, 244, 245, 246, 247,
    248, 249, 250)
STD_HUFFMAN = {  # (class, table id): (bits, values); class 0 = DC, 1 = AC
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), _DC_VALUES),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125), _AC_LUMA_VALUES),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), _DC_VALUES),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119), _AC_CHROMA_VALUES),
}

# islow fixed point (CONST_BITS 13, PASS1_BITS 2)
_CB, _P1 = 13, 2
(F0_298, F0_390, F0_541, F0_765, F0_899, F1_175, F1_501, F1_847, F1_961, F2_053, F2_562,
 F3_072) = (2446, 3196, 4433, 6270, 7373, 9633, 12299, 15137, 16069, 16819, 20995, 25172)

# jdmaster.c's post-IDCT range limit, indexed by (value & 1023): 0..127 ->
# value + 128, 128..511 -> 255, 512..895 -> 0, 896..1023 -> value - 896
_IDCT_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384),
                              np.arange(0, 128)]).astype(np.uint8)

_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def quant_table(base, quality: int) -> np.ndarray:
    """libjpeg's ``jpeg_set_quality(quality, force_baseline=TRUE)``."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((np.asarray(base, np.int64) * scale + 50) // 100, 1, 255)


def _huff_codes(bits, values):
    """Canonical codes: {symbol: (code, length)}."""
    out, code, k = {}, 0, 0
    for length, n in enumerate(bits, start=1):
        for _ in range(n):
            out[values[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


@functools.lru_cache(maxsize=16)
def _huff_lut(bits: tuple, values: tuple) -> list:
    """16-bit prefix -> (length << 8) | symbol; 0 for no code."""
    lut = np.zeros(1 << 16, np.int64)
    for sym, (code, length) in _huff_codes(bits, values).items():
        lo = code << (16 - length)
        lut[lo:lo + (1 << (16 - length))] = (length << 8) | sym
    return lut.tolist()


# ---------------------------------------------------------------- DCT

def _idct_1d(c0, c1, c2, c3, c4, c5, c6, c7, shift):
    """One islow pass over the columns (then rows) of int64 arrays."""
    z1 = (c2 + c6) * F0_541
    tmp2 = z1 + c6 * (-F1_847)
    tmp3 = z1 + c2 * F0_765
    tmp0 = (c0 + c4) << _CB
    tmp1 = (c0 - c4) << _CB
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c7, c5, c3, c1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * F1_175
    t0, t1, t2, t3 = t0 * F0_298, t1 * F2_053, t2 * F3_072, t3 * F1_501
    z1, z2 = z1 * (-F0_899), z2 * (-F2_562)
    z3, z4 = z3 * (-F1_961) + z5, z4 * (-F0_390) + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return [_descale(v, shift) for v in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                                         tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantized coefficients [N, 8, 8] (natural order, int) -> uint8
    samples [N, 8, 8]: ``jpeg_idct_islow``. Its all-zero-AC shortcuts give
    the same numbers as the full passes, so none is taken."""
    c = coef.astype(np.int64)
    cols = _idct_1d(*[c[:, k, :] for k in range(8)], _CB - _P1)  # 8 x [N, 8(col)]
    ws = np.stack(cols, axis=1)  # [N, row, col]
    rows = _idct_1d(*[ws[:, :, k] for k in range(8)], _CB + _P1 + 3)
    out = np.stack(rows, axis=2)
    return _IDCT_LIMIT[out & 1023]


def _fdct_1d(d, shift_even, descale_n):
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    out[0], out[4] = shift_even(tmp10 + tmp11), shift_even(tmp10 - tmp11)
    z1 = (tmp12 + tmp13) * F0_541
    out[2] = _descale(z1 + tmp13 * F0_765, descale_n)
    out[6] = _descale(z1 + tmp12 * (-F1_847), descale_n)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * F1_175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * F0_298, tmp5 * F2_053, tmp6 * F3_072, tmp7 * F1_501
    z1, z2 = z1 * (-F0_899), z2 * (-F2_562)
    z3, z4 = z3 * (-F1_961) + z5, z4 * (-F0_390) + z5
    out[7] = _descale(tmp4 + z1 + z3, descale_n)
    out[5] = _descale(tmp5 + z2 + z4, descale_n)
    out[3] = _descale(tmp6 + z2 + z3, descale_n)
    out[1] = _descale(tmp7 + z1 + z4, descale_n)
    return out


def fdct_islow(samples: np.ndarray) -> np.ndarray:
    """uint8 samples [N, 8, 8] -> DCT coefficients [N, 8, 8] scaled by 8
    (``jpeg_fdct_islow`` on samples minus 128)."""
    d = samples.astype(np.int64) - 128
    rows = _fdct_1d([d[:, :, k] for k in range(8)], lambda x: x << _P1, _CB - _P1)
    ws = np.stack(rows, axis=2)
    cols = _fdct_1d([ws[:, k, :] for k in range(8)], lambda x: _descale(x, _P1), _CB + _P1)
    return np.stack(cols, axis=1)


# ---------------------------------------------------------------- colour

def rgb_to_ycc(rgb: np.ndarray):
    """``jccolor.c`` rgb_ycc_convert: three int planes."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    off = (128 << _SCALEBITS) + _ONE_HALF - 1
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + _ONE_HALF) >> _SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + off) >> _SCALEBITS
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + off) >> _SCALEBITS
    return y, cb, cr


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """``jdcolor.c`` ycc_rgb_convert: uint8 [H, W, 3]."""
    y, cb, cr = (p.astype(np.int64) for p in (y, cb, cr))
    cb, cr = cb - 128, cr - 128
    r = y + ((_fix(1.40200) * cr + _ONE_HALF) >> _SCALEBITS)
    g = y + ((-_fix(0.34414) * cb + _ONE_HALF - _fix(0.71414) * cr) >> _SCALEBITS)
    b = y + ((_fix(1.77200) * cb + _ONE_HALF) >> _SCALEBITS)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _upsample_h2(x: np.ndarray) -> np.ndarray:
    """``h2v1_fancy_upsample``: [H, w] -> [H, 2w]."""
    p = np.pad(x.astype(np.int64), ((0, 0), (1, 1)), mode="edge")
    t = 3 * p[:, 1:-1]
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int64)
    out[:, 0::2] = (t + p[:, :-2] + 1) >> 2
    out[:, 1::2] = (t + p[:, 2:] + 2) >> 2
    return out


def _upsample_h2v2(x: np.ndarray) -> np.ndarray:
    """``h2v2_fancy_upsample``: [h, w] -> [2h, 2w]; rows above the first
    and below the last repeat them."""
    p = np.pad(x.astype(np.int64), ((1, 1), (0, 0)), mode="edge")
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int64)
    for v, near in ((0, p[:-2]), (1, p[2:])):
        s = np.pad(3 * p[1:-1] + near, ((0, 0), (1, 1)), mode="edge")  # column sums
        t = 3 * s[:, 1:-1]
        out[v::2, 0::2] = (t + s[:, :-2] + 8) >> 4
        out[v::2, 1::2] = (t + s[:, 2:] + 7) >> 4
    return out


# ---------------------------------------------------------------- decode

def _segments(data: bytes):
    """Yield (marker, payload, offset after the payload) up to SOS."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (no SOI)")
    i = 2
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            raise ValueError(f"bad marker at byte {i}")
        marker = data[i + 1]
        if marker == 0xFF:  # fill byte
            i += 1
            continue
        length = int.from_bytes(data[i + 2:i + 4], "big")
        yield marker, data[i + 4:i + 2 + length], i + 2 + length
        if marker == 0xDA:
            return
        i += 2 + length
    raise ValueError("truncated JPEG (no SOS)")


def _entropy_bytes(data: bytes, start: int) -> np.ndarray:
    """The scan's bytes with stuffing removed, up to the next marker."""
    buf = np.frombuffer(data, np.uint8, offset=start)
    ff = np.flatnonzero(buf[:-1] == 0xFF)
    nxt = buf[ff + 1]
    ends = ff[(nxt != 0x00) & (nxt != 0xFF)]
    if ends.size:
        buf = buf[:ends[0]]
        ff = ff[ff < ends[0]]
    keep = np.ones(buf.size, bool)
    keep[ff[buf[np.minimum(ff + 1, buf.size - 1)] == 0x00] + 1] = False
    return buf[keep]


def decode_jpeg(data: bytes) -> np.ndarray:
    """Baseline JPEG bytes -> uint8 RGB [H, W, 3], as libjpeg decodes it
    with its defaults (islow IDCT, fancy upsampling, RGB out)."""
    qt, huff, frame, scan, restart = {}, {}, None, None, 0
    for marker, seg, end in _segments(data):
        if marker == 0xDB:
            j = 0
            while j < len(seg):
                if seg[j] >> 4:
                    raise ValueError("16-bit quantization tables are not supported")
                qt[seg[j] & 15] = np.frombuffer(seg, np.uint8, 64, j + 1).astype(np.int64)
                j += 65
        elif marker == 0xC4:
            j = 0
            while j < len(seg):
                bits = tuple(seg[j + 1:j + 17])
                n = sum(bits)
                huff[(seg[j] >> 4, seg[j] & 15)] = _huff_lut(bits, tuple(seg[j + 17:j + 17 + n]))
                j += 17 + n
        elif marker in (0xC0, 0xC1):
            if seg[0] != 8:
                raise ValueError(f"{seg[0]}-bit samples are not supported")
            h, w = int.from_bytes(seg[1:3], "big"), int.from_bytes(seg[3:5], "big")
            comps = [(seg[6 + 3 * k], seg[7 + 3 * k] >> 4, seg[7 + 3 * k] & 15, seg[8 + 3 * k])
                     for k in range(seg[5])]
            frame = (h, w, comps)
        elif 0xC2 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise ValueError(f"JPEG process SOF{marker - 0xC0} is not supported (baseline only)")
        elif marker == 0xDD:
            restart = int.from_bytes(seg[:2], "big")
        elif marker == 0xDA:
            scan = ([(seg[1 + 2 * k], seg[2 + 2 * k] >> 4, seg[2 + 2 * k] & 15)
                     for k in range(seg[0])], end)
    if frame is None or scan is None:
        raise ValueError("no frame header")
    if restart:
        raise ValueError("restart intervals are not supported")
    h, w, comps = frame
    if len(comps) not in (1, 3):
        raise ValueError(f"{len(comps)} components are not supported")
    scan_comps, start = scan
    if len(scan_comps) != len(comps):
        raise ValueError("multi-scan (non-interleaved) files are not supported")
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    if len(comps) == 1:  # one non-interleaved component: blocks in raster order
        hmax = vmax = 1
        comps = [(comps[0][0], 1, 1, comps[0][3])]
    mcu_cols = -(-w // (8 * hmax))
    mcu_rows = -(-h // (8 * vmax))
    if len(comps) == 1:
        mcu_cols, mcu_rows = -(-w // 8), -(-h // 8)
    by_id = {c[0]: c for c in comps}
    plan = []  # per component of the scan: (blocks array, h, v, dc lut, ac lut)
    for cid, td, ta in scan_comps:
        _, hs, vs, tq = by_id[cid]
        plan.append((np.zeros((mcu_rows * vs, mcu_cols * hs, 64), np.int64), hs, vs,
                     huff[(0, td)], huff[(1, ta)], cid))
    coefs = _huffman_decode(_entropy_bytes(data, start), plan, mcu_rows, mcu_cols)
    planes = {}
    for (blocks, hs, vs, _, _, cid), c in zip(plan, coefs):
        tq = by_id[cid][3]
        deq = np.zeros(blocks.shape, np.int64)
        deq[..., ZIGZAG] = c * qt[tq]
        br, bc = blocks.shape[:2]
        pix = idct_islow(deq.reshape(-1, 8, 8)).reshape(br, bc, 8, 8)
        plane = pix.transpose(0, 2, 1, 3).reshape(br * 8, bc * 8)
        ch, cw = -(-h * vs // vmax), -(-w * hs // hmax)
        plane = plane[:ch, :cw]
        if (hs, vs) != (hmax, vmax):
            if (hmax // hs, vmax // vs) == (2, 2) and hmax % hs == 0 and vmax % vs == 0:
                plane = _upsample_h2v2(plane)
            elif (hmax // hs, vmax // vs) == (2, 1) and hmax % hs == 0 and vmax == vs:
                plane = _upsample_h2(plane)
            else:
                raise ValueError(f"chroma sampling {hs}x{vs} of {hmax}x{vmax} is not supported")
        planes[cid] = plane[:h, :w]
    if len(comps) == 1:
        return np.repeat(planes[comps[0][0]].astype(np.uint8)[..., None], 3, axis=2)
    return ycc_to_rgb(*(planes[c[0]] for c in comps))


def _huffman_decode(buf: np.ndarray, plan, mcu_rows: int, mcu_cols: int):
    """Interleaved baseline scan -> per component [rows, cols, 64] zigzag
    coefficients (not dequantized)."""
    b = np.concatenate([buf, np.zeros(8, np.uint8)]).astype(np.uint64)
    win = ((b[:-3] << np.uint64(24)) | (b[1:-2] << np.uint64(16)) | (b[2:-1] << np.uint64(8))
           | b[3:]).tolist()  # 32 bits from each byte
    nbits = 8 * buf.size
    outs = [np.zeros(p[0].shape, np.int64) for p in plan]
    flat = [o.reshape(-1) for o in outs]
    pos = 0
    preds = [0] * len(plan)
    for my in range(mcu_rows):
        for mx in range(mcu_cols):
            for ci, (_, hs, vs, dc_lut, ac_lut, _) in enumerate(plan):
                ncols = mcu_cols * hs
                out = flat[ci]
                for v in range(vs):
                    for hh in range(hs):
                        base = ((my * vs + v) * ncols + mx * hs + hh) * 64
                        # DC
                        e = dc_lut[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                        if not e:
                            raise ValueError("corrupt JPEG: bad Huffman code")
                        pos += e >> 8
                        s = e & 0xFF
                        if s:
                            r = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                            pos += s
                            preds[ci] += r if r >= 1 << (s - 1) else r - (1 << s) + 1
                        out[base] = preds[ci]
                        k = 1
                        while k < 64:
                            e = ac_lut[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                            if not e:
                                raise ValueError("corrupt JPEG: bad Huffman code")
                            pos += e >> 8
                            rs = e & 0xFF
                            s = rs & 15
                            if s:
                                k += rs >> 4
                                if k > 63:
                                    raise ValueError("corrupt JPEG: coefficient past 63")
                                r = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                                pos += s
                                out[base + k] = r if r >= 1 << (s - 1) else r - (1 << s) + 1
                                k += 1
                            elif rs == 0xF0:
                                k += 16
                            else:
                                break
            if pos > nbits + 64:
                raise ValueError("corrupt JPEG: scan data ended early")
    return outs


# ---------------------------------------------------------------- encode

def _pad_edge(x: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return np.pad(x, ((0, rows - x.shape[0]), (0, cols - x.shape[1])), mode="edge")


def _bit_length(v: np.ndarray) -> np.ndarray:
    a = np.abs(v)
    out = np.zeros(v.shape, np.int64)
    nz = a > 0
    out[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return out


def _code_arrays(bits, values):
    codes = _huff_codes(bits, values)
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    for sym, (c, ln) in codes.items():
        code[sym], length[sym] = c, ln
    return code, length


_ENC_TABLES = {k: _code_arrays(*v) for k, v in STD_HUFFMAN.items()}


def _entropy_encode(zz: np.ndarray, table_of_block: np.ndarray, comp_of_block: np.ndarray,
                    n_comps: int) -> bytes:
    """Zigzag coefficients [N, 64] in scan order -> stuffed scan bytes."""
    n = zz.shape[0]
    dc = zz[:, 0].copy()
    diff = np.zeros(n, np.int64)
    for c in range(n_comps):
        idx = np.flatnonzero(comp_of_block == c)
        diff[idx] = np.diff(dc[idx], prepend=0)
    fields_key, fields_val, fields_len = [], [], []

    def add(key, sym, extra, s, cls):
        for t in (0, 1):
            sel = table_of_block[key // 128] == t
            if not sel.any():
                continue
            code, length = _ENC_TABLES[(cls, t)]
            sy = sym[sel]
            if np.any(length[sy] == 0):
                raise ValueError("value out of range for the standard Huffman tables")
            fields_key.append(key[sel])
            fields_val.append((code[sy] << s[sel]) | extra[sel])
            fields_len.append(length[sy] + s[sel])

    def extra_bits(v, s):
        return np.where(v >= 0, v, v + (1 << s) - 1) & ((1 << s) - 1)

    blocks = np.arange(n)
    s = _bit_length(diff)
    add(blocks * 128, s, extra_bits(diff, s), s, 0)
    b, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[b, k]
    prev = np.zeros_like(k)
    same = np.zeros(k.size, bool)
    same[1:] = b[1:] == b[:-1]
    prev[same] = k[:-1][same[1:]]
    run = k - prev - 1
    nzrl = run // 16
    zb = np.repeat(b, nzrl)
    zk = np.repeat(2 * k, nzrl)
    zero = np.zeros(zb.size, np.int64)
    add(zb * 128 + zk, np.full(zb.size, 0xF0), zero, zero, 1)
    s = _bit_length(v)
    add(b * 128 + 2 * k + 1, ((run % 16) << 4) | s, extra_bits(v, s), s, 1)
    last = np.zeros(n, np.int64)
    np.maximum.at(last, b, k)
    eob = np.flatnonzero(last < 63)
    zero = np.zeros(eob.size, np.int64)
    add(eob * 128 + 127, zero, zero, zero, 1)

    key = np.concatenate(fields_key)
    order = np.argsort(key, kind="stable")
    val = np.concatenate(fields_val)[order]
    ln = np.concatenate(fields_len)[order]
    total = int(ln.sum())
    field = np.repeat(np.arange(ln.size), ln)
    start = np.cumsum(ln) - ln
    j = np.arange(total) - start[field]
    bits = ((val[field] >> (ln[field] - 1 - j)) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-total % 8, np.uint8)])  # pad with 1-bits
    out = np.packbits(bits)
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).tobytes()


def encode_jpeg(rgb: np.ndarray, quality: int = 75) -> bytes:
    """uint8 RGB [H, W, 3] -> baseline JFIF bytes, 4:2:0, standard tables,
    as libjpeg writes with ``jpeg_set_defaults`` + ``jpeg_set_quality(q,
    TRUE)`` (PIL's ``save(quality=q)``)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"want uint8 [H, W, 3], got {rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    mcu_rows, mcu_cols = -(-h // 16), -(-w // 16)
    y, cb, cr = rgb_to_ycc(rgb)
    h2 = h + h % 2  # libjpeg pads the last row group (2 rows)
    # luma: real blocks from edge-replicated samples
    yb_rows, yb_cols = -(-h // 8), -(-w // 8)
    yp = _pad_edge(_pad_edge(y, h2, w), mcu_rows * 16, yb_cols * 8)
    # chroma: replicate to twice the block width, then 2x2 average with
    # bias 1, 2, 1, 2 along each row; pad the bottom to the iMCU row
    cw = -(-((w + 1) // 2) // 8) * 8
    chroma = []
    for p in (cb, cr):
        p = _pad_edge(p, h2, 2 * cw)
        bias = np.tile(np.array([1, 2], np.int64), cw // 2)
        d = (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2] + bias) >> 2
        chroma.append(_pad_edge(d, mcu_rows * 8, cw))
    q_luma = quant_table(_LUMA_Q, quality)
    q_chroma = quant_table(_CHROMA_Q, quality)

    def quantize(plane, rows, cols, q):
        blk = plane[:rows * 8, :cols * 8].reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3)
        coef = fdct_islow(blk.reshape(-1, 8, 8)).reshape(rows, cols, 64)[..., ZIGZAG]
        div = q << 3
        a = (np.abs(coef) + (div >> 1)) // div
        return np.where(coef < 0, -a, a)

    yq = np.zeros((2 * mcu_rows, 2 * mcu_cols, 64), np.int64)
    yq[:yb_rows, :yb_cols] = quantize(yp, yb_rows, yb_cols, q_luma)
    # dummy blocks (jccoefct.c): zero AC; right edge copies the DC on its
    # left, a bottom dummy row the DC of its MCU's last upper block
    for col in range(yb_cols, 2 * mcu_cols):
        yq[:yb_rows, col, 0] = yq[:yb_rows, col - 1, 0]
    if yb_rows < 2 * mcu_rows:
        yq[yb_rows, :, 0] = np.repeat(yq[yb_rows - 1, 1::2, 0], 2)
    cq = [quantize(p, mcu_rows, mcu_cols, q_chroma) for p in chroma]

    # scan order: per MCU Y00 Y01 Y10 Y11 Cb Cr
    ymcu = yq.reshape(mcu_rows, 2, mcu_cols, 2, 64).transpose(0, 2, 1, 3, 4)
    ymcu = ymcu.reshape(mcu_rows, mcu_cols, 4, 64)
    mcus = np.concatenate([ymcu, cq[0][:, :, None], cq[1][:, :, None]], axis=2).reshape(-1, 64)
    per_mcu = np.array([0, 0, 0, 0, 1, 2])
    comp = np.tile(per_mcu, mcu_rows * mcu_cols)
    scan = _entropy_encode(mcus, np.minimum(comp, 1), comp, 3)

    def seg(marker, payload):
        return bytes((0xFF, marker)) + (len(payload) + 2).to_bytes(2, "big") + payload

    out = [b"\xff\xd8", seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for tid, q in ((0, q_luma), (1, q_chroma)):
        out.append(seg(0xDB, bytes([tid]) + bytes(q.astype(np.uint8).tolist())))
    out.append(seg(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
                   + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for cls, tid in ((0, 0), (1, 0), (0, 1), (1, 1)):
        bits, values = STD_HUFFMAN[(cls, tid)]
        out.append(seg(0xC4, bytes([(cls << 4) | tid, *bits, *values])))
    out.append(seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out += [scan, b"\xff\xd9"]
    return b"".join(out)


# ---------------------------------------------------------------- resize

_F0, _F05, _F1 = np.float32(0.0), np.float32(0.5), np.float32(1.0)


@functools.lru_cache(maxsize=64)
def _filter(src: int, dst: int):
    """The pipe's ``build_filter``: per output index the first source
    index and the normalized float32 taps [dst, max_len]."""
    scale = np.float32(src) / np.float32(dst)
    support = scale if scale >= _F1 else _F1
    los, rows = [], []
    for x in range(dst):
        center = (np.float32(x) + _F05) * scale
        lo = max(int(center - support + _F05), 0)
        hi = min(int(center + support + _F05), src)
        taps, wsum = [], _F0
        for i in range(lo, hi):
            d = (np.float32(i) + _F05 - center) / support
            v = _F1 + d if d < _F0 else _F1 - d
            v = v if v >= _F0 else _F0
            taps.append(v)
            wsum = wsum + v
        if wsum <= _F0:
            taps, wsum = [_F1] * (hi - lo), np.float32(hi - lo)
        los.append(lo)
        rows.append([t / wsum for t in taps])
    width = max(len(r) for r in rows)
    coef = np.zeros((dst, width), np.float32)
    for x, r in enumerate(rows):
        coef[x, :len(r)] = r
    return np.asarray(los), coef


def resize_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 [H, W, 3] -> uint8 [size, size, 3]: the pipe's triangle
    filter, horizontal then vertical, float32 sums in tap order, +0.5 and
    truncation."""
    h, w = img.shape[:2]
    lo_x, cx = _filter(w, size)
    lo_y, cy = _filter(h, size)
    src = img.astype(np.float32)
    tmp = np.zeros((h, size, 3), np.float32)
    for i in range(cx.shape[1]):
        tmp = tmp + cx[None, :, i, None] * src[:, np.minimum(lo_x + i, w - 1)]
    acc = np.zeros((size, size, 3), np.float32)
    for i in range(cy.shape[1]):
        acc = acc + cy[:, i, None, None] * tmp[np.minimum(lo_y + i, h - 1)]
    v = acc + _F05
    return np.clip(v, 0, 255).astype(np.uint8)


def decode_resize(data: bytes, size: int) -> np.ndarray:
    """JPEG bytes -> uint8 [size, size, 3] (the pipe's ``decode_resize``:
    no resize when the image already has that size)."""
    img = decode_jpeg(data)
    if img.shape[0] == size and img.shape[1] == size:
        return img
    return resize_bilinear(img, size)
