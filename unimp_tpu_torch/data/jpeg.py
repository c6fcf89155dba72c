"""Baseline JPEG codec and bilinear resize in numpy.

The JAX package decodes item images with libjpeg (``unimp_tpu/native/
imagepipe.cc``) and writes them with PIL. The card's machine has neither
libjpeg nor a place in the port for PIL, so the port carries its own
codec, written to give libjpeg's (libjpeg-turbo's) numbers exactly:

  * decode: Huffman entropy decoding (sequential and progressive), the
    integer "islow" IDCT (``jidctint.c``) with its 10-bit range-limit
    table, "fancy" (triangle) upsampling of 2x2, 2x1 and 1x2 chroma
    (``jdsample.c``), the fixed-point YCbCr -> RGB tables (``jdcolor.c``),
    and CMYK as PIL converts it to RGB;
  * encode: the fixed-point RGB -> YCbCr tables (``jccolor.c``), 2x2
    chroma averaging with the 1, 2, 1, 2 rounding bias (``jcsample.c``),
    libjpeg's edge replication and dummy blocks, the integer "islow" FDCT
    (``jfdctint.c``), quality-scaled standard tables and the standard
    Huffman tables, as PIL's ``save(quality=q)`` writes them;
  * resize: the pipe's separable triangle filter (PIL BILINEAR for
    downscaling), float32 operation for operation.

Decode reads every Huffman-coded 8-bit JPEG that libjpeg reads: baseline
and extended, interleaved or one component a scan, progressive (DC and AC
first and refinement scans with end-of-band runs, ``jdphuff.c``), restart
intervals, 16-bit quantization tables, gray / YCbCr / RGB / CMYK / YCCK,
and files cut short; arithmetic-coded too (the QM decoder of T.81 Annex
D as ``jdarith.c`` runs it: sequential and progressive, DAC conditioning,
restart intervals), and lossless (SOF3: predictors 1-7, the point
transform; gray or RGB, components not subsampled, no restart interval).
A progressive file cut short is block-smoothed as libjpeg-turbo does it
(``jdcoefct.c decompress_smooth_data``). 12-bit, hierarchical, arithmetic
lossless, a DNL height, chroma sampling that does not divide the largest
and a lossless file in YCbCr (libjpeg-turbo refuses to convert it) raise
a ``ValueError`` that names them (ROADMAP.md §3, fault 5).
Huffman decoding is a Python loop (about a microsecond a coefficient);
everything else is vectorized over blocks.
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


def _wrap(x, bits):
    """Two's-complement wrap of int64 values to ``bits`` bits."""
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


def _idct_1d_simd(i0, i1, i2, i3, i4, i5, i6, i7, shift):
    """One pass of ``jidctint-avx2.asm``'s ``dodct`` on int16 lanes: the
    sums ``in0 ± in4``, ``in7 + in3`` and ``in5 + in1`` wrap in 16 bits
    (``vpaddw``), the rotations are ``vpmaddwd`` pairs summed in 32 bits
    (wrapping), the descale is an arithmetic shift and ``vpackssdw``
    saturates each output to 16 bits."""
    w16 = functools.partial(_wrap, bits=16)
    tmp0, tmp1 = w16(i0 + i4) << _CB, w16(i0 - i4) << _CB
    tmp3 = i2 * (F0_541 + F0_765) + i6 * F0_541
    tmp2 = i2 * F0_541 + i6 * (F0_541 - F1_847)
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    z3, z4 = w16(i7 + i3), w16(i5 + i1)
    z3, z4 = z3 * (F1_175 - F1_961) + z4 * F1_175, z3 * F1_175 + z4 * (F1_175 - F0_390)
    t0 = i7 * (F0_298 - F0_899) + i1 * -F0_899 + z3
    t1 = i5 * (F2_053 - F2_562) + i3 * -F2_562 + z4
    t2 = i5 * -F2_562 + i3 * (F3_072 - F2_562) + z3
    t3 = i7 * -F0_899 + i1 * (F1_501 - F0_899) + z4
    return [np.clip(_wrap(v + (1 << (shift - 1)), 32) >> shift, -32768, 32767)
            for v in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                      tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow_simd(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """Quantized coefficients [N, 8, 8] and their table [8, 8] (natural
    order) -> uint8 samples [N, 8, 8]: libjpeg-turbo's x86 SIMD islow IDCT
    (``jidctint-avx2.asm``; ``jidctint-sse2.asm`` computes the same), which
    PIL and the JAX package's native pipe run on x86-64. It dequantizes with
    a 16-bit ``vpmullw``, works in 16-bit lanes between its passes, and
    ends with ``vpacksswb`` and a wrapping +128, where ``idct_islow``
    (libjpeg's C path) works in 32 bits and wraps through its range-limit
    table. A block whose AC coefficients are all zero takes the column
    pass' shortcut: its dequantized DC shifted left in 16 bits, wrapping.
    The two agree while a block's values stay in range."""
    c = _wrap(coef.astype(np.int64), 16)
    deq = _wrap(c * _wrap(np.asarray(quant, np.int64), 16), 16)
    cols = _idct_1d_simd(*[deq[:, k, :] for k in range(8)], _CB - _P1)  # 8 x [N, 8(col)]
    ws = np.stack(cols, axis=1)  # [N, row, col]
    dc_only = ~c.reshape(-1, 64)[:, 8:].any(axis=1)
    ws[dc_only] = _wrap(deq[dc_only, :1, :] << _P1, 16)
    rows = _idct_1d_simd(*[ws[:, :, k] for k in range(8)], _CB + _P1 + 3)
    out = np.clip(np.stack(rows, axis=2), -128, 127) + 128
    return out.astype(np.uint8)


def idct_blocks(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """The IDCT the decoder runs: the SIMD one, as libjpeg-turbo on x86-64."""
    return idct_islow_simd(coef, quant)


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

# the JPEG processes the port does not read (ROADMAP.md §3, fault 5)
_UNREAD_SOF = {0xC5: "hierarchical JPEG (SOF5)",
               0xC6: "hierarchical JPEG (SOF6)", 0xC7: "hierarchical lossless JPEG (SOF7)",
               0xCB: "arithmetic-coded lossless JPEG (SOF11)",
               0xCD: "arithmetic-coded hierarchical JPEG (SOF13)",
               0xCE: "arithmetic-coded hierarchical JPEG (SOF14)",
               0xCF: "arithmetic-coded hierarchical lossless JPEG (SOF15)"}
UNREAD = "is not read by the port (ROADMAP.md §3, fault 5)"
# zero bytes behind a scan that the end of the file cut: enough for any
# MCU read from zero bits (10 blocks of 64 codes of at most 16 + 16 bits)
_ZERO_TAIL = 2600


def _scan_segments(data: bytes, start: int):
    """The entropy-coded data of the scan starting at ``start``, split at
    its RSTn markers: (segments, each unstuffed as a uint8 array; the
    offset of the marker that ends the scan; whether the file ended
    first). A run of FF before 00 is one FF data byte, as libjpeg reads
    it."""
    buf = np.frombuffer(data, np.uint8, offset=start)
    n = buf.size
    segments, pieces, p = [], [], 0
    for i in np.flatnonzero(buf == 0xFF).tolist():
        if i < p:
            continue
        j = i + 1
        while j < n and buf[j] == 0xFF:
            j += 1
        if j >= n:  # the file ends inside a run of FF
            n = i
            break
        if buf[j] == 0x00:
            pieces.append(buf[p:i + 1])
        else:
            pieces.append(buf[p:i])
            segments.append(np.concatenate(pieces))
            pieces = []
            if not 0xD0 <= buf[j] <= 0xD7:
                return segments, start + i, False
        p = j + 1
    pieces.append(buf[p:n])
    segments.append(np.concatenate(pieces))
    return segments, len(data), True


def _windows(seg: np.ndarray, tail: int) -> list:
    """32 bits from each byte of ``seg`` followed by ``tail`` zero bytes."""
    b = np.concatenate([seg, np.zeros(tail + 4, np.uint8)]).astype(np.uint64)
    return ((b[:-3] << np.uint64(24)) | (b[1:-2] << np.uint64(16)) | (b[2:-1] << np.uint64(8))
            | b[3:]).tolist()


def _bad_code():
    raise ValueError("corrupt JPEG: bad Huffman code")


def _read_baseline(win, mcus, flat, dc, ac, preds, al, ss, se, nbits):
    """Sequential Huffman MCUs: each block's DC difference and its 63 AC
    coefficients. Stops after the MCU in which the data ran out (it read
    zero bits): the rest of the segment keeps what it had (zero here).
    The other readers stop alike."""
    pos = 0
    for n_mcu, mcu in enumerate(mcus):
        for ci, base in mcu:
            out, dc_lut, ac_lut = flat[ci], dc[ci], ac[ci]
            e = dc_lut[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if not e:
                _bad_code()
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
                    _bad_code()
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
        if pos > nbits:
            return n_mcu
    return None


def _read_dc_first(win, mcus, flat, dc, ac, preds, al, ss, se, nbits):
    """Progressive DC first scan (``jdphuff.c decode_mcu_DC_first``)."""
    pos = 0
    for n_mcu, mcu in enumerate(mcus):
        for ci, base in mcu:
            e = dc[ci][(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if not e:
                _bad_code()
            pos += e >> 8
            s = e & 0xFF
            if s:
                r = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                preds[ci] += r if r >= 1 << (s - 1) else r - (1 << s) + 1
            flat[ci][base] = preds[ci] * (1 << al)
        if pos > nbits:
            return n_mcu
    return None


def _read_dc_refine(win, mcus, flat, dc, ac, preds, al, ss, se, nbits):
    """Progressive DC refinement: one bit a block (``decode_mcu_DC_refine``)."""
    pos, p1 = 0, 1 << al
    for n_mcu, mcu in enumerate(mcus):
        for ci, base in mcu:
            if (win[pos >> 3] >> (31 - (pos & 7))) & 1:
                flat[ci][base] |= p1
            pos += 1
        if pos > nbits:
            return n_mcu
    return None


def _read_ac_first(win, mcus, flat, dc, ac, preds, al, ss, se, nbits):
    """Progressive AC first scan over one component, with end-of-band runs
    (``decode_mcu_AC_first``)."""
    pos, eobrun = 0, 0
    for n_mcu, mcu in enumerate(mcus):
        (ci, base), = mcu
        if eobrun:
            eobrun -= 1
            continue
        out, lut = flat[ci], ac[ci]
        k = ss
        while k <= se:
            e = lut[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if not e:
                _bad_code()
            pos += e >> 8
            rs = e & 0xFF
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                if k > 63:
                    raise ValueError("corrupt JPEG: coefficient past 63")
                v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                out[base + k] = (v if v >= 1 << (s - 1) else v - (1 << s) + 1) * (1 << al)
                k += 1
            elif r == 15:
                k += 16
            else:
                eobrun = 1 << r
                if r:
                    eobrun += (win[pos >> 3] >> (32 - (pos & 7) - r)) & ((1 << r) - 1)
                    pos += r
                eobrun -= 1
                break
        if pos > nbits:
            return n_mcu
    return None


def _read_ac_refine(win, mcus, flat, dc, ac, preds, al, ss, se, nbits):
    """Progressive AC refinement over one component: new coefficients of
    +-1 << al and a correction bit for each nonzero one passed, with
    end-of-band runs (``decode_mcu_AC_refine``)."""
    pos, eobrun = 0, 0
    p1, m1 = 1 << al, -1 << al
    for n_mcu, mcu in enumerate(mcus):
        (ci, base), = mcu
        out, lut = flat[ci], ac[ci]
        k = ss
        if not eobrun:
            while k <= se:
                e = lut[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                if not e:
                    _bad_code()
                pos += e >> 8
                rs = e & 0xFF
                r, s = rs >> 4, rs & 15
                if s:
                    s = p1 if (win[pos >> 3] >> (31 - (pos & 7))) & 1 else m1
                    pos += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += (win[pos >> 3] >> (32 - (pos & 7) - r)) & ((1 << r) - 1)
                        pos += r
                    break
                while k <= se:  # pass nonzero coefficients and r zero ones
                    c = out[base + k]
                    if c:
                        if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and not c & p1:
                            out[base + k] = c + (p1 if c >= 0 else m1)
                        pos += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:  # past the band too, as libjpeg writes it: its natural
                    out[base + min(k, 63)] = s  # order table gives 63 past 63
                k += 1
        if eobrun:
            while k <= se:  # the rest of the band: correction bits only
                c = out[base + k]
                if c:
                    if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and not c & p1:
                        out[base + k] = c + (p1 if c >= 0 else m1)
                    pos += 1
                k += 1
            eobrun -= 1
        if pos > nbits:
            return n_mcu
    return None


# the QM coder's probability estimation (T.81 Table D.2, as libjpeg's
# ``jaricom.c`` packs it): Qe << 16 | next index after an MPS << 8 |
# switch << 7 | next index after an LPS; entry 113 is the fixed 0.5 bin
_ARITAB = (
    0x5a1d0181, 0x2586020e, 0x11140310, 0x80b0412, 0x3d80514, 0x1da0617, 0xe50719, 0x6f081c,
    0x36091e, 0x1a0a21, 0xd0b23, 0x60c09, 0x30d0a, 0x10d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126,
    0x207c1227, 0x17b91328, 0x1182142a, 0xcef152b, 0x9a1162d, 0x72f172e, 0x55c1830, 0x4061931,
    0x3031a33, 0x2401b34, 0x1b11c36, 0x1441d38, 0xf51e39, 0xb71f3b, 0x8a203c, 0x68213e, 0x4e223f,
    0x3b2320, 0x2c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0xe742e4a, 0xbfb2f4b, 0x9f8304d, 0x861314e, 0x706324f,
    0x5cd3330, 0x4de3432, 0x40f3532, 0x3633633, 0x2d43734, 0x25c3835, 0x1f83936, 0x1a43a37,
    0x1603b38, 0x1253c39, 0xf63d3a, 0xcb3e3b, 0xab3f3d, 0x8f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48,
    0x14244b48, 0x119c4c4a, 0xf6b4d4a, 0xd514e4b, 0xbb64f4d, 0xa40304d, 0x583251d0, 0x4d1c5258,
    0x438e5359, 0x3bdd545a, 0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266,
    0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9,
    0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171)


class _Arith:
    """The QM decoder of one entropy-coded segment (``jdarith.c
    arith_decode``): zero bytes once the segment's data is spent, as libjpeg
    supplies after a marker."""

    def __init__(self, seg: np.ndarray):
        self.data, self.pos, self.c, self.a, self.ct = seg.tolist(), 0, 0, 0, -16

    def __call__(self, st: bytearray, i: int) -> int:
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                data = self.data[self.pos] if self.pos < len(self.data) else 0
                self.pos += 1
                c = (c << 8) | data
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe = _ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                a = qe
                st[i] = (sv & 0x80) ^ nm
            else:
                a = qe
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


class _BadArithCode(Exception):
    """``jdarith.c``'s JWRN_ARITH_BAD_CODE: libjpeg warns and decodes
    nothing more in the restart interval (``ct = -1``)."""


def _arith_dc(dec, st, ctx, ci, cond):
    """One DC difference (T.81 F.19-F.24, ``jdarith.c``), with the
    component's conditioning context updated; ``cond`` is (L, U)."""
    s = ctx[ci]
    if not dec(st, s):
        ctx[ci] = 0
        return 0
    sign = dec(st, s + 1)
    i = s + 2 + sign
    m = dec(st, i)
    if m:
        i = 20
        while dec(st, i):
            m <<= 1
            if m == 0x8000:
                raise _BadArithCode
            i += 1
    lo, hi = cond
    if m < (1 << lo) >> 1:
        ctx[ci] = 0
    elif m > (1 << hi) >> 1:
        ctx[ci] = 12 + sign * 4
    else:
        ctx[ci] = 4 + sign * 4
    v = m
    i += 14
    m >>= 1
    while m:
        if dec(st, i):
            v |= m
        m >>= 1
    v += 1
    return -v if sign else v


def _arith_ac_value(dec, st, i, k, kx, fixed):
    """The value of a nonzero AC coefficient at band position k whose
    statistics start at ``st[i]``."""
    sign = dec(fixed, 0)
    i += 2
    m = dec(st, i)
    if m and dec(st, i):
        m <<= 1
        i = 189 if k <= kx else 217
        while dec(st, i):
            m <<= 1
            if m == 0x8000:
                raise _BadArithCode
            i += 1
    v = m
    i += 14
    m >>= 1
    while m:
        if dec(st, i):
            v |= m
        m >>= 1
    v += 1
    return -v if sign else v


def _arith_ac_band(dec, st, out, base, ss, se, kx, fixed, al):
    """AC coefficients ss..se of one block (F.20): end-of-block flags, zero
    runs, values scaled by 2^al."""
    k = ss
    while k <= se:
        i = 3 * (k - 1)
        if dec(st, i):
            return
        while not dec(st, i + 1):
            i += 3
            k += 1
            if k > se:
                raise _BadArithCode
        out[base + k] = _arith_ac_value(dec, st, i, k, kx, fixed) * (1 << al)
        k += 1


def _read_arith(seg_bytes, mcus, flat, kind, tables, ss, se, al):
    """One restart interval of an arithmetic-coded scan: fresh statistics
    (``jdarith.c`` start_pass / process_restart), then its MCUs, until a
    bad code (an overflow: libjpeg then leaves the interval's other MCUs
    as they are). Zero bytes past the data are no "insufficient data" to
    ``jdarith.c``: a cut arithmetic scan leaves the smoothing's
    ``last_good_iMCU_row`` where it was (no ``trace``)."""
    try:
        _arith_mcus(_Arith(seg_bytes), mcus, flat, kind, tables, ss, se, al)
    except _BadArithCode:
        pass


def _arith_mcus(dec, mcus, flat, kind, tables, ss, se, al):
    dct, act, dc_cond, ac_k = tables
    dc_st = {t: bytearray(64) for t in set(dct)}
    ac_st = {t: bytearray(256) for t in set(act)}
    fixed = bytearray([113])
    ctx = [0] * len(flat)
    preds = [0] * len(flat)
    for mcu in mcus:
        for ci, base in mcu:
            out = flat[ci]
            if kind in ("baseline", "dc_first"):
                diff = _arith_dc(dec, dc_st[dct[ci]], ctx, ci, dc_cond[ci])
                preds[ci] = (preds[ci] + diff) & 0xFFFF
                v = preds[ci] - 0x10000 if preds[ci] & 0x8000 else preds[ci]
                out[base] = v if kind == "baseline" else v * (1 << al)
                if kind == "baseline":
                    _arith_ac_band(dec, ac_st[act[ci]], out, base, 1, 63, ac_k[ci], fixed, 0)
            elif kind == "dc_refine":
                if dec(fixed, 0):
                    out[base] |= 1 << al
            elif kind == "ac_first":
                _arith_ac_band(dec, ac_st[act[ci]], out, base, ss, se, ac_k[ci], fixed, al)
            else:
                _arith_ac_refine(dec, ac_st[act[ci]], out, base, ss, se, fixed, al)


def _arith_ac_refine(dec, st, out, base, ss, se, fixed, al):
    """A progressive AC refinement of one block (``decode_mcu_AC_refine``)."""
    p1, m1 = 1 << al, -1 << al
    kex = se
    while kex > 0 and not out[base + kex]:
        kex -= 1
    k = ss
    while k <= se:
        i = 3 * (k - 1)
        if k > kex and dec(st, i):
            return
        while True:
            c = out[base + k]
            if c:
                if dec(st, i + 2):
                    out[base + k] = c + (m1 if c < 0 else p1)
                break
            if dec(st, i + 1):
                out[base + k] = m1 if dec(fixed, 0) else p1
                break
            i += 3
            k += 1
            if k > se:
                raise _BadArithCode
        k += 1


def _read_lossless(segments, frame, scan_comps, huff, td, pred, pt, restart):
    """The samples of a lossless (SOF3) scan whose components are not
    subsampled: Huffman-coded differences (a DC-style category, 16 for
    32768), then libjpeg-turbo's predictor ``pred`` (``jdlossls.c``)."""
    h, w, comps, *_ = frame
    if restart:
        raise ValueError("lossless JPEG with restart intervals " + UNREAD)
    n = len(scan_comps)
    diffs = np.zeros((h * w, n), np.int64)
    seg = segments[0]
    win = _windows(seg, _ZERO_TAIL)
    luts = [huff[(0, t)] for t in td]
    pos, out = 0, diffs.reshape(-1).tolist()
    limit, ran_out = 8 * seg.size, None
    for j in range(h * w * n):
        lut = luts[j % n]
        e = lut[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
        if not e:
            _bad_code()
        pos += e >> 8
        s = e & 0xFF
        if s == 16:
            out[j] = 32768
        elif s:
            r = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
            pos += s
            out[j] = r if r >= 1 << (s - 1) else r - (1 << s) + 1
        if pos > limit and ran_out is None:
            ran_out = j // (w * n)  # the row whose decoding read past the data
    diffs = np.asarray(out, np.int64).reshape(h, w, n)
    planes = []
    for c in range(n):
        d = diffs[..., c]
        x = np.zeros((h, w), np.int64)
        x[0] = (np.cumsum(d[0]) + (1 << (8 - pt - 1))) & 0xFFFF
        for y in range(1, h):
            prev, row = x[y - 1], x[y]
            row[0] = (d[y, 0] + prev[0]) & 0xFFFF
            if pred == 1:
                row[:] = (np.cumsum(np.concatenate([[row[0]], d[y, 1:]]))) & 0xFFFF
            elif pred == 2:
                row[1:] = (d[y, 1:] + prev[1:]) & 0xFFFF
            elif pred == 3:
                row[1:] = (d[y, 1:] + prev[:-1]) & 0xFFFF
            else:
                ra, dy, pl = int(row[0]), d[y].tolist(), prev.tolist()
                vals = [ra]
                for i in range(1, w):
                    rb, rc = pl[i], pl[i - 1]
                    if pred == 4:
                        p = ra + rb - rc
                    elif pred == 5:
                        p = ra + ((rb - rc) >> 1)
                    elif pred == 6:
                        p = rb + ((ra - rc) >> 1)
                    else:
                        p = (ra + rb) >> 1
                    ra = (dy[i] + p) & 0xFFFF
                    vals.append(ra)
                row[:] = vals
        if ran_out is not None:
            # libjpeg-turbo (``jdlhuff.c decode_mcus``): once a row has read
            # past the data (as zero bits), each later row decodes no
            # differences and resets the undifferencer: CENTERJSAMPLE
            x[ran_out + 1:] = 1 << (8 - pt - 1)
        planes.append((x << pt) & 0xFF)
    return planes


def _scan_mcus(frame, scan_comps):
    """MCUs of a scan in order: each a list of (scan component, flat offset
    of a block's 64 coefficients). One component: its own blocks in raster
    order, as many as its samples need; several: the frame's MCU grid,
    each component's h x v blocks an MCU."""
    h, w, comps, hmax, vmax, mcux, mcuy = frame
    if len(scan_comps) == 1:
        c = scan_comps[0]
        _, hs, vs, _ = comps[c]
        cols = -(-(-(-w * hs // hmax)) // 8)
        rows = -(-(-(-h * vs // vmax)) // 8)
        stride = mcux * hs
        return [[(0, (r * stride + q) * 64)] for r in range(rows) for q in range(cols)]
    mcus = []
    for my in range(mcuy):
        for mx in range(mcux):
            mcu = []
            for si, c in enumerate(scan_comps):
                _, hs, vs, _ = comps[c]
                for v in range(vs):
                    for u in range(hs):
                        mcu.append((si, ((my * vs + v) * mcux * hs + mx * hs + u) * 64))
            mcus.append(mcu)
    return mcus


_READERS = {"baseline": _read_baseline, "dc_first": _read_dc_first,
            "dc_refine": _read_dc_refine, "ac_first": _read_ac_first,
            "ac_refine": _read_ac_refine}


def _read_scan(data, end, frame, coefs, huff, seg, progressive, restart, strict=False,
               arith=None, trace=None):
    """Decode one scan into the coefficient buffers; returns the offset
    after its entropy-coded data. ``strict``: raise if the file ends
    inside the scan. ``arith``: the scan is arithmetic-coded, under these
    DAC conditioning values ({(class, table): value}). ``trace`` (a dict)
    gets "cut": (the scan's components, the MCU in which the data ran
    out) when the file ends inside a Huffman scan."""
    h, w, comps, *_ = frame
    ids = [c[0] for c in comps]
    ns = seg[0]
    scan_comps, td, ta = [], [], []
    for k in range(ns):
        cid, tables = seg[1 + 2 * k], seg[2 + 2 * k]
        if cid not in ids:
            raise ValueError(f"corrupt JPEG: scan component {cid} is not in the frame")
        scan_comps.append(ids.index(cid))
        td.append(tables >> 4)
        ta.append(tables & 15)
    ss, se, ah, al = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
    if not progressive:
        kind, ss, se, al = "baseline", 0, 63, 0
    elif ss == 0:
        kind = "dc_first" if ah == 0 else "dc_refine"
    else:
        if ns != 1 or se > 63 or ss > se:
            raise ValueError("corrupt JPEG: bad progressive AC scan")
        kind = "ac_first" if ah == 0 else "ac_refine"
    segments, after, cut = _scan_segments(data, end)
    if cut and strict:
        raise ValueError("truncated JPEG (the file ends inside a scan)")
    mcus = _scan_mcus(frame, scan_comps)
    per = restart or len(mcus)
    flat = [coefs[c].reshape(-1) for c in scan_comps]
    if arith is not None:  # defaults L 0, U 1, K 5 (``jdarith.c``)
        dc_cond = [(arith.get((0, t), 0x10) & 15, arith.get((0, t), 0x10) >> 4) for t in td]
        tables = (td, ta, dc_cond, [arith.get((1, t), 5) for t in ta])
        lists = [f.tolist() for f in flat]
        # intervals past the cut are read from zero bytes with fresh
        # statistics, as libjpeg reads them after the fake EOI
        empty = np.zeros(0, np.uint8)
        for s in range(-(-len(mcus) // per)):
            seg_bytes = segments[s] if s < len(segments) else empty
            _read_arith(seg_bytes, mcus[s * per:(s + 1) * per], lists, kind, tables, ss, se, al)
        for f, v in zip(flat, lists):
            f[:] = v
        return after
    try:
        dc = [huff[(0, t)] if kind in ("baseline", "dc_first") else None for t in td]
        ac = [huff[(1, t)] if kind in ("baseline", "ac_first", "ac_refine") else None for t in ta]
    except KeyError as e:
        raise ValueError(f"corrupt JPEG: Huffman table {e} is not defined") from None
    read = _READERS[kind]
    if cut:
        # where the data ends with a whole restart interval, libjpeg takes
        # the fake EOI for the next RSTn and reads that interval's first
        # MCU from zero bits (``jdhuff.c process_restart`` leaves its
        # out-of-data flag clear): an empty segment stands for it
        segments = segments + [np.zeros(0, np.uint8)]
    for s, seg_bytes in enumerate(segments):
        chunk = mcus[s * per:(s + 1) * per]
        if not chunk:
            break
        last = cut and s >= len(segments) - 2
        win = _windows(seg_bytes, _ZERO_TAIL if last else 8)
        try:
            ran_out = read(win, chunk, flat, dc, ac, [0] * ns, al, ss, se, 8 * seg_bytes.size)
        except IndexError:
            raise ValueError("corrupt JPEG: scan data ended early") from None
        if last and ran_out is not None:
            if trace is not None:
                trace["cut"] = (scan_comps, s * per + ran_out)
            break  # libjpeg reads nothing more of the scan
    return after


def _lossless_scan(data, end, frame, coefs, huff, seg, restart, strict):
    """Decode one lossless scan into its components' sample buffers;
    returns the offset after its data."""
    h, w, comps, *_ = frame
    ids = [c[0] for c in comps]
    ns = seg[0]
    scan_comps = [ids.index(seg[1 + 2 * k]) for k in range(ns)]
    td = [seg[2 + 2 * k] >> 4 for k in range(ns)]
    pred, pt = seg[1 + 2 * ns], seg[3 + 2 * ns] & 15
    if not 1 <= pred <= 7:
        raise ValueError(f"lossless JPEG with predictor {pred} {UNREAD}")
    segments, after, cut = _scan_segments(data, end)
    if cut and strict:
        raise ValueError("truncated JPEG (the file ends inside a scan)")
    try:
        planes = _read_lossless(segments, frame, scan_comps, huff, td, pred, pt, restart)
    except KeyError as e:
        raise ValueError(f"corrupt JPEG: Huffman table {e} is not defined") from None
    for c, plane in zip(scan_comps, planes):
        coefs[c][:h, :w, 0] = plane
    return after


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """libjpeg-turbo's upsampling by (fh, fv): "fancy" (triangle) for 2x1,
    2x2 and 1x2 where the component is wider than 2 samples, else box
    replication (``jdsample.c``)."""
    if (fh, fv) == (1, 1):
        return plane
    if plane.shape[1] > 2:
        if (fh, fv) == (2, 2):
            return _upsample_h2v2(plane)
        if (fh, fv) == (2, 1):
            return _upsample_h2(plane)
        if (fh, fv) == (1, 2):
            p = np.pad(plane.astype(np.int64), ((1, 1), (0, 0)), mode="edge")
            out = np.empty((2 * plane.shape[0], plane.shape[1]), np.int64)
            out[0::2] = (3 * p[1:-1] + p[:-2] + 1) >> 2
            out[1::2] = (3 * p[1:-1] + p[2:] + 2) >> 2
            return out
    return np.repeat(np.repeat(plane, fv, axis=0), fh, axis=1)


def _cmyk_to_rgb(c, m, y, k) -> np.ndarray:
    """Adobe-inverted CMYK samples, as PIL reads them ("CMYK;I": 255 - x),
    then PIL's ``convert("RGB")``: 255 - k less (255 - k) * c / 255
    rounded as its MULDIV255, per channel."""
    nk = k.astype(np.int64)  # 255 - (255 - k)
    out = []
    for ch in (c, m, y):
        v = 255 - ch.astype(np.int64)
        t = v * nk + 128
        out.append(nk - (((t >> 8) + t) >> 8))
    return np.clip(np.stack(out, axis=-1), 0, 255).astype(np.uint8)


def component_count(data: bytes) -> int:
    """The number of components in a JPEG's frame header (0 if it has
    none before its first scan)."""
    return _frame_header(data)[1]


def is_lossless(data: bytes) -> bool:
    """Whether a JPEG's frame is lossless (SOF3), which the JAX package's
    native pipe declines (libjpeg-turbo converts no colour in lossless
    mode, and the pipe asks for RGB)."""
    return _frame_header(data)[0] == 0xC3


def _frame_header(data: bytes) -> tuple:
    """(SOF marker, component count) of a JPEG's frame header ((0, 0) if it
    has none before its first scan)."""
    i = 2
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        if marker == 0xFF or marker in (0x00, 0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            i += 1 if marker == 0xFF else 2
            continue
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return marker, data[i + 9] if i + 9 < len(data) else 0
        if marker in (0xD9, 0xDA):
            return 0, 0
        i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
    return 0, 0


# block smoothing estimates zigzag coefficients 1-9 (``jdcoefct.c``
# Q01_POS ... Q30_POS) from the DC values
_SMOOTH_COEFS = 10


def _note_scan_bits(frame, seg, bits, scans):
    """libjpeg's ``coef_bits`` before a progressive scan: for each of its
    components, the point transform left on each coefficient of the band
    (-1: never coded), and the state before this scan ("prev")."""
    comps = frame[2]
    ns = seg[0]
    ss, se, al = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns] & 15
    for k in range(ns):
        ci = next((j for j, c in enumerate(comps) if c[0] == seg[1 + 2 * k]), None)
        if ci is None:
            continue
        cur, prev = bits.setdefault(ci, ([-1] * 64, [-1] * 64))
        for coefi in range(min(ss, 1), max(se, 9) + 1):
            prev[coefi] = cur[coefi] if scans else 0
        for coefi in range(ss, se + 1):
            cur[coefi] = al


def _smooth_pred(num, q, al):
    """``decompress_smooth_data``'s estimate: num / (q << 8), rounded, C
    division toward zero, capped below 2^al when al > 0."""
    pred = ((q << 7) + abs(num)) // (q << 8)
    if al > 0 and pred >= 1 << al:
        pred = (1 << al) - 1
    return pred if num >= 0 else -pred


def _block_smoothing(frame, coefs, tables, bits, trace, scans):
    """libjpeg-turbo's interblock smoothing of a progressive file whose
    coefficients are not all known (a file cut short): the first 9 AC
    coefficients, still zero and not known to full precision, estimated
    from the 5 x 5 neighbourhood of DC values; with no AC data at all, the
    DC too, by its Gaussian-like kernel (``jdcoefct.c smoothing_ok`` /
    ``decompress_smooth_data``). Rows past the last iMCU row the cut scan
    completed use the unknown bits as they were before that scan."""
    h, w, comps, hmax, vmax, mcux, mcuy = frame
    if len(bits) != len(comps) or any(t is None for t in tables):
        return coefs
    for cur, _ in bits.values():
        if cur[0] < 0:
            return coefs
    for t in tables:
        if any(t[k] == 0 for k in range(_SMOOTH_COEFS)):
            return coefs
    if all(cur[k] == 0 for cur, _ in bits.values() for k in range(1, _SMOOTH_COEFS)):
        return coefs  # every estimated coefficient is known exactly
    last_good = mcuy - 1
    if "cut" in trace:
        scan_comps, mcu = trace["cut"]
        if len(scan_comps) == 1:
            _, hs, vs, _ = comps[scan_comps[0]]
            cols = -(-(-(-w * hs // hmax)) // 8)
            row = (mcu // cols) // vs
        else:
            row = mcu // mcux
        last_good = row
    out = []
    for ci, ((_, hs, vs, _), c, q) in enumerate(zip(comps, coefs, tables)):
        cur, prev = bits[ci]
        prev_latch = [prev[k] if scans > 1 else -1 for k in range(_SMOOTH_COEFS)]
        rows = -(-(-(-h * vs // vmax)) // 8)
        cols = -(-(-(-w * hs // hmax)) // 8)
        q = [int(v) for v in q[:_SMOOTH_COEFS]]
        dc = c[..., 0].tolist()
        new = c.copy()
        for r in range(rows):
            imcu, block_row = divmod(r, vs)
            last_imcu = mcuy - 1
            block_rows = vs if imcu < last_imcu else (rows % vs or vs)
            cb = prev_latch if imcu > last_good else cur
            change_dc = all(cb[k] == -1 for k in range(1, _SMOOTH_COEFS))
            pr = r - 1 if block_row > 0 or imcu > 0 else r
            ppr = r - 2 if block_row > 1 or imcu > 1 else pr
            nr = r + 1 if block_row < block_rows - 1 or imcu < last_imcu else r
            nnr = r + 2 if block_row < block_rows - 2 or imcu + 1 < last_imcu else nr
            grid = [dc[x] for x in (ppr, pr, r, nr, nnr)]
            for col in range(cols):
                cc = [max(col - 2, 0), max(col - 1, 0), col, min(col + 1, cols - 1),
                      min(col + 2, cols - 1)]
                if cols == 1:
                    cc = [0] * 5
                d = [[g[x] for x in cc] for g in grid]
                (D01, D02, D03, D04, D05), (D06, D07, D08, D09, D10), \
                    (D11, D12, D13, D14, D15), (D16, D17, D18, D19, D20), \
                    (D21, D22, D23, D24, D25) = d
                ws = new[r, col]
                est = []
                if change_dc:
                    est = [
                        (1, -D01 - D02 + D04 + D05 - 3 * D06 + 13 * D07 - 13 * D09 + 3 * D10
                         - 3 * D11 + 38 * D12 - 38 * D14 + 3 * D15 - 3 * D16 + 13 * D17
                         - 13 * D19 + 3 * D20 - D21 - D22 + D24 + D25),
                        (2, -D01 - 3 * D02 - 3 * D03 - 3 * D04 - D05 - D06 + 13 * D07
                         + 38 * D08 + 13 * D09 - D10 + D16 - 13 * D17 - 38 * D18 - 13 * D19
                         + D20 + D21 + 3 * D22 + 3 * D23 + 3 * D24 + D25),
                        (3, D03 + 2 * D07 + 7 * D08 + 2 * D09 - 5 * D12 - 14 * D13 - 5 * D14
                         + 2 * D17 + 7 * D18 + 2 * D19 + D23),
                        (4, -D01 + D05 + 9 * D07 - 9 * D09 - 9 * D17 + 9 * D19 + D21 - D25),
                        (5, 2 * D07 - 5 * D08 + 2 * D09 + D11 + 7 * D12 - 14 * D13 + 7 * D14
                         + D15 + 2 * D17 - 5 * D18 + 2 * D19),
                        (6, D07 - D09 + 2 * D12 - 2 * D14 + D17 - D19),
                        (7, D07 - 3 * D08 + D09 - D17 + 3 * D18 - D19),
                        (8, D07 - D09 - 3 * D12 + 3 * D14 + D17 - D19),
                        (9, D07 + 2 * D08 + D09 - D17 - 2 * D18 - D19)]
                else:
                    est = [
                        (1, -7 * D11 + 50 * D12 - 50 * D14 + 7 * D15),
                        (2, -7 * D03 + 50 * D08 - 50 * D18 + 7 * D23),
                        (3, -D03 + 13 * D08 - 24 * D13 + 13 * D18 - D23),
                        (4, D10 + D16 - 10 * D17 + 10 * D19 - D02 - D20 + D22 - D24 + D04
                         - D06 + 10 * D07 - 10 * D09),
                        (5, -D11 + 13 * D12 - 24 * D13 + 13 * D14 - D15)]
                for k, kernel in est:
                    al = cb[k]
                    if al != 0 and ws[k] == 0:
                        ws[k] = _smooth_pred(q[0] * kernel, q[k], al)
                if change_dc:
                    num = q[0] * (
                        -2 * D01 - 6 * D02 - 8 * D03 - 6 * D04 - 2 * D05 - 6 * D06 + 6 * D07
                        + 42 * D08 + 6 * D09 - 6 * D10 - 8 * D11 + 42 * D12 + 152 * D13
                        + 42 * D14 - 8 * D15 - 6 * D16 + 6 * D17 + 42 * D18 + 6 * D19
                        - 6 * D20 - 2 * D21 - 6 * D22 - 8 * D23 - 6 * D24 - 2 * D25)
                    ws[0] = _smooth_pred(num, q[0], 0)
        out.append(new)
    return out


def _cut_segment_fails(marker: int, head: bytes, length: int) -> bool:
    """Whether libjpeg stops with an error on a marker segment that the end
    of the file cut, its missing bytes read as the fake EOI markers the
    data source supplies (``jdatasrc.c``, FF D9 again and again): a scan
    header always (a component id or spectral range it refuses), a
    Huffman table whose counts then pass 256 or the segment
    (``jdmarker.c get_dht``); other segments are skipped or read
    harmlessly."""
    if marker == 0xDA:
        return True
    if marker != 0xC4:
        return False
    seg = (head + b"\xff\xd9" * length)[:length]
    j = 0
    while j + 17 <= len(seg):
        count = sum(seg[j + 1:j + 17])
        if count > 256 or 17 + count > len(seg) - j:
            return True
        j += 17 + count
    return False


def decode_jpeg(data: bytes, strict: bool = False, inverted_cmyk: bool = True) -> np.ndarray:
    """JPEG bytes -> uint8 RGB [H, W, 3], as libjpeg-turbo decodes it with
    its defaults (islow IDCT, fancy upsampling) and PIL's
    ``convert("RGB")`` gives it: baseline and extended (SOF0 / SOF1) with
    interleaved or one-component scans, progressive (SOF2), restart
    intervals, 8- and 16-bit quantization tables; 1 component (gray), 3
    (YCbCr, or RGB by the Adobe or component-id rule) or 4 (CMYK, YCCK by
    the Adobe transform flag). A file cut short decodes as libjpeg does
    with the end of its data replaced by zero bits (PIL with
    ``LOAD_TRUNCATED_IMAGES``): the MCU where the data ends reads zeros,
    the rest of that scan's interval stays zero (gray in a baseline file;
    a progressive file keeps what its earlier scans gave, block-smoothed
    as libjpeg-turbo smooths it); with ``strict`` such a file raises, as PIL
    does without ``LOAD_TRUNCATED_IMAGES``. ``inverted_cmyk``: PIL reads a
    CMYK JPEG file's samples as Adobe-inverted; a JPEG-coded CMYK TIFF
    holds them as they are (False)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (no SOI marker)")
    qt, latched, huff, conditioning = {}, {}, {}, {}
    coef_bits, trace = {}, {}  # progressive: unknown bits a coefficient; where data ran out
    frame = coefs = None
    progressive, restart, adobe, jfif, scans = False, 0, None, False, 0
    arith = lossless = False
    i, n = 2, len(data)
    while i < n:
        if data[i] != 0xFF:  # bytes between segments: skipped, as libjpeg does
            i += 1
            continue
        while i < n and data[i] == 0xFF:
            i += 1
        if i >= n:
            break
        marker = data[i]
        i += 1
        if marker == 0xD9:  # EOI
            break
        if marker in (0x00, 0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            continue  # no payload
        # a length cut short reads on into the fake EOI's bytes
        end = i + int.from_bytes((data[i:n] + b"\xff\xd9")[:2], "big")
        seg = data[i + 2:end]
        if end > n:
            if frame is None and i + 2 <= n:
                raise ValueError("truncated JPEG (cut before its first scan)")
            if frame is None:
                break
            if scans and _cut_segment_fails(marker, seg, end - i - 2):
                # libjpeg reads the source's fake EOI bytes as the rest of
                # the segment and stops with an error: PIL (and so the JAX
                # package) keep the image they allocated, black
                return np.zeros((frame[0], frame[1], 3), np.uint8)
            break
        i = end
        if marker == 0xDB:
            j = 0
            while j < len(seg):
                wide, tq = seg[j] >> 4, seg[j] & 15
                if wide:
                    qt[tq] = np.frombuffer(seg, ">u2", 64, j + 1).astype(np.int64)
                else:
                    qt[tq] = np.frombuffer(seg, np.uint8, 64, j + 1).astype(np.int64)
                j += 1 + 64 * (1 + wide)
        elif marker == 0xC4:
            j = 0
            while j < len(seg):
                bits = tuple(seg[j + 1:j + 17])
                m = sum(bits)
                huff[(seg[j] >> 4, seg[j] & 15)] = _huff_lut(bits, tuple(seg[j + 17:j + 17 + m]))
                j += 17 + m
        elif marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
            if seg[0] != 8:
                raise ValueError(f"{seg[0]}-bit JPEG {UNREAD}")
            h, w = int.from_bytes(seg[1:3], "big"), int.from_bytes(seg[3:5], "big")
            if not h or not w:
                raise ValueError("JPEG with its height in a DNL marker " + UNREAD)
            comps = [(seg[6 + 3 * k], seg[7 + 3 * k] >> 4, seg[7 + 3 * k] & 15, seg[8 + 3 * k])
                     for k in range(seg[5])]
            if len(comps) not in (1, 3, 4):
                raise ValueError(f"JPEG with {len(comps)} components {UNREAD}")
            hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
            mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            frame = (h, w, comps, hmax, vmax, mcux, mcuy)
            progressive = marker in (0xC2, 0xCA)
            arith, lossless = marker in (0xC9, 0xCA), marker == 0xC3
            # a lossless frame's buffers hold its samples
            coefs = [np.zeros((h, w, 1) if lossless else (mcuy * c[2], mcux * c[1], 64),
                              np.int64) for c in comps]
            if lossless and (hmax, vmax) != (1, 1):
                raise ValueError(f"lossless JPEG with subsampled components {UNREAD}")
        elif marker in _UNREAD_SOF:
            raise ValueError(f"{_UNREAD_SOF[marker]} {UNREAD}")
        elif marker == 0xCC:  # DAC: arithmetic conditioning, (class, table) -> value
            for j in range(0, len(seg) - 1, 2):
                conditioning[(seg[j] >> 4, seg[j] & 15)] = seg[j + 1]
        elif marker == 0xDD:
            restart = int.from_bytes(seg[:2], "big")
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("corrupt JPEG: a scan before the frame header")
            for k in range(0 if lossless else seg[0]):  # tables latch at a first scan
                cid = seg[1 + 2 * k]
                comp = next((c for c in frame[2] if c[0] == cid), None)
                if comp is not None and cid not in latched:
                    if comp[3] not in qt:
                        raise ValueError(f"corrupt JPEG: quantization table {comp[3]} is missing")
                    latched[cid] = qt[comp[3]]
            if progressive:  # what each scan leaves unknown (``jdphuff.c`` start_pass)
                _note_scan_bits(frame, seg, coef_bits, scans)
            if lossless:
                i = _lossless_scan(data, end, frame, coefs, huff, seg, restart, strict)
            else:
                i = _read_scan(data, end, frame, coefs, huff, seg, progressive, restart, strict,
                               conditioning if arith else None, trace)
            scans += 1
    if frame is None or not scans:
        raise ValueError("not a complete JPEG (no frame header or no scan)")
    h, w, comps, hmax, vmax, *_ = frame
    if progressive:
        coefs = _block_smoothing(frame, coefs, [latched.get(c[0]) for c in comps], coef_bits,
                                 trace, scans)
    planes = []
    for (cid, hs, vs, _), c in zip(comps, coefs):
        if lossless:  # the samples themselves, in the buffer's first plane
            planes.append(c[:h, :w, 0])
            continue
        nat, q = np.zeros(c.shape, np.int64), np.zeros(64, np.int64)
        nat[..., ZIGZAG] = c
        if cid in latched:  # a component no scan reached stays zero
            q[ZIGZAG] = latched[cid]
        br, bc = c.shape[:2]
        pix = idct_blocks(nat.reshape(-1, 8, 8), q.reshape(8, 8)).reshape(br, bc, 8, 8)
        plane = pix.transpose(0, 2, 1, 3).reshape(br * 8, bc * 8)
        plane = plane[:-(-h * vs // vmax), :-(-w * hs // hmax)]
        if hmax % hs or vmax % vs:
            raise ValueError(f"JPEG chroma sampling {hs}x{vs} of {hmax}x{vmax} {UNREAD}")
        planes.append(_upsample(plane, hmax // hs, vmax // vs)[:h, :w])
    if len(comps) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=2)
    if len(comps) == 3:
        # libjpeg's colour space rule (``jdapimin.c``): JFIF means YCbCr,
        # else the Adobe transform flag (0: RGB), else the component ids
        if jfif:
            rgb = False
        elif adobe is not None:
            rgb = adobe == 0
        else:
            rgb = tuple(c[0] for c in comps) == (82, 71, 66)  # 'R', 'G', 'B'
        if rgb:
            return np.stack(planes, axis=-1).astype(np.uint8)
        if lossless:  # libjpeg-turbo converts no colour in lossless mode; PIL fails
            raise ValueError("lossless JPEG in YCbCr (libjpeg-turbo refuses to convert it) "
                             + UNREAD)
        return ycc_to_rgb(*planes)
    if adobe not in (None, 0):  # YCCK -> CMYK (``jdcolor.c ycck_cmyk_convert``)
        c, m, y = (255 - ycc_to_rgb(*planes[:3]).astype(np.int64)).transpose(2, 0, 1)
        planes = [c, m, y, planes[3]]
    if not inverted_cmyk:
        planes = [255 - p.astype(np.int64) for p in planes]
    return _cmyk_to_rgb(*planes)


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
