"""VP8 lossy key frames in numpy, as libwebp decodes them (``src/dec``).

The frame header and the boolean decoder (RFC 6386 §7, §9), segment,
loop-filter and quantizer headers with libwebp's dequantization tables,
the coefficient probabilities and their updates, intra modes (16x16,
4x4 with its contexts, chroma), the residual tokens with their contexts,
the inverse WHT and DCT (``dsp/dec.c`` ``TransformWHT`` /
``TransformOne``), intra prediction over the unfiltered samples with
libwebp's frame borders (127 above, 129 on the left), the simple and
normal loop filters in macroblock order, and the output as libwebp emits
it in RGBA: "fancy" chroma upsampling (``dsp/upsampling.c``) and the
fixed-point YUV -> RGB of ``dsp/yuv.h``. The tables are libwebp's.
"""

from __future__ import annotations

import numpy as np

UNREAD = "is not read by the port (ROADMAP.md §3, fault 5)"

# libwebp's tables: coefficient probabilities [4][8][3][11] and their update
# probabilities, the 4x4 mode probabilities [top][left][9], and the
# dequantization tables (``tree_dec.c``, ``quant_dec.c``)
_COEFFS0 = bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88feffe4db8080808080"
    "bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2ffff808080b585eefeddeaff9a808080"
    "4e86caf7c6b4ffdb80808001b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece68080808080"
    "0165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080"
    "cfa0faffee8080808080806667e7ffd3ab80808080800198fcfff0ff8080808080b187f3ffeae18080808080"
    "5081d3ffc2e080808080800101ff8080808080808080f601ff8080808080808080ff80808080808080808080"
    "c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f92d095a7dda2ffdf800195f1ffdde0ffff808080"
    "b88deafddedcffc78080805163b5f2b0bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080"
    "175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ffff808080"
    "0184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9ffe8eb8080808080"
    "7c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ffff808080"
    "2d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080"
    "fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080"
    "ef5af4fad3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba8080808080"
    "452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff80808080808d7cf8ffff808080808080"
    "0110f8ffff808080808080be24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080"
    "f7c0ff8080808080808080f080ff80808080808080800186fcffff808080808080d53efaffff808080808080"
    "375dff8080808080808080808080808080808080808080808080808080808080808080808080808080808080"
    "ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff79fffff80"
    "a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7f9dcffff807c4abff3b7c1faddffff80"
    "184782db9aaaf3b6ffff8001b6e1f9dbf0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff80"
    "0151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8ffd8d58080808080"
    "a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caffdb808080"
    "2a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff8080808080808080ee01ff8080808080808080")
_COEFFS_UPDATE = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ffffffffffffffffff"
    "dff1fcfffffffffffffffff9fdfdfffffffffffffffffff4fcffffffffffffffffeafefeffffffffffffffff"
    "fdfffffffffffffffffffffff6feffffffffffffffffeffdfefffffffffffffffffefffeffffffffffffffff"
    "fff8fefffffffffffffffffbfffefffffffffffffffffffffffffffffffffffffffffdfeffffffffffffffff"
    "fbfefefffffffffffffffffefffefffffffffffffffffffefdfffefffffffffffffafffefffeffffffffffff"
    "feffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "d9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafaf1fafdfffdfefffffffffeffffffffffffffffff"
    "dffefeffffffffffffffffeefdfefefffffffffffffffff8fefffffffffffffffff9feffffffffffffffffff"
    "fffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefeffffffffffffffff"
    "fdfffffffffffffffffffffffffffffffffffffffffffffefdfffffffffffffffffaffffffffffffffffffff"
    "feffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "bafbfaffffffffffffffffeafbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffff"
    "ecfdfefffffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffffffffffff"
    "fffffffffffffffffffffffffefffffffffffffffffffefefffffffffffffffffffeffffffffffffffffffff"
    "fffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "f8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfdffffffffffffffff"
    "f6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcfffffffffffffffff8fefdffffffffffffffff"
    "fdfffefefffffffffffffffffbfefffffffffffffffff5fbfefffffffffffffffffdfdfeffffffffffffffff"
    "fffbfdfffffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcffffffffffffffffff"
    "f9fffefffffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff")
_BMODES = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98721a11a32cc3150a"
    "ad791850c31a3e2c405590470a26abd590221aaa2e371388a021ce473f14087272d00c09e251280b60b6541d"
    "102486b7598962656aa59448bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a6"
    "31179d412669a033341f7380684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5"
    "bd171216585893962a2e2dc4cd2b61b775552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab"
    "3aa55a6240221674ce17222ba6496b36201a3301512b1f44196a1640ab24e1722213156684bc104c7c3e124e"
    "5f5539323033c165239fd76f592e6f3c941facdbe415126f70714d55b3ff267872282a01c4f5d10a196d582b"
    "1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd33"
    "3211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748fd12227af"
    "2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd2803097333c01206"
    "df572509733b4d40152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a8598740a"
    "2086271335dd1a722049ff1f0941ea020f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd"
    "2d25c03726467c49660122627d622a58685575af525f543559806471652d4b4f7b2f338051ab013911054766"
    "3935293126210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a39120a66"
    "66d522142b75140f24a38044011a663d472522351ff3c0453c472649771cde25442d8022012f0bf5ab3e1113"
    "469255373e46252b259a64a355a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808"
    "118489ff3774803a0f145287391a7928a4321f899a851923da33672c83837b1f069e5628408794e02db78016"
    "1a1183f09a0e01d12d10155b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab"
    "120b073f90ab0404f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420654b808b76927480"
    "5538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e9224131eabff611b148a2d3d3edb0151"
    "bc4020291475978e1415a370130c3dc380300418")
_DC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42,
    43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64,
    65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86,
    87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118, 122,
    124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157)
_AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
    28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50,
    51, 52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88,
    90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131,
    134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189,
    193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269,
    274, 279, 284)

_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT3456 = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
            (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# libwebp's mode numbers: 4x4 modes, and the 16x16 / chroma ones among them
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)


class _Bool:
    """The boolean entropy decoder (RFC 6386 §7.3); zero bytes past the end
    of its data, as libwebp reads them."""

    def __init__(self, data: bytes):
        self.data, self.n = data, len(data)
        self.value = (data[0] << 8 if self.n > 0 else 0) | (data[1] if self.n > 1 else 0)
        self.pos, self.range, self.count = 2, 255, 0

    def bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            r = 1
            self.range -= split
            self.value -= big
        else:
            r = 0
            self.range = split
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                if self.pos < self.n:
                    self.value |= self.data[self.pos]
                self.pos += 1
        return r

    def value_of(self, bits: int) -> int:
        v = 0
        for k in range(bits - 1, -1, -1):
            v |= self.bit(128) << k
        return v

    def signed(self, bits: int) -> int:
        v = self.value_of(bits)
        return -v if self.bit(128) else v


def _large_value(br: _Bool, p) -> int:
    """``tree_dec.c`` GetLargeValue: a coefficient of 2 or more."""
    if not br.bit(p[3]):
        return 2 if not br.bit(p[4]) else 3 + br.bit(p[5])
    if not br.bit(p[6]):
        if not br.bit(p[7]):
            return 5 + br.bit(159)
        return 7 + 2 * br.bit(165) + br.bit(145)
    bit1 = br.bit(p[8])
    cat = 2 * bit1 + br.bit(p[9 + bit1])
    v = 0
    for prob in _CAT3456[cat]:
        v = v + v + br.bit(prob)
    return v + 3 + (8 << cat)


def _coeffs(br: _Bool, bands, ctx: int, dq, n: int, out: list) -> int:
    """One block's tokens from position n (``GetCoeffs``); the dequantized
    values land in ``out`` in raster order; returns the position after the
    last nonzero one."""
    p = bands[n][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = bands[n][0]
        if not br.bit(p[2]):
            v, nxt = 1, 1
        else:
            v, nxt = _large_value(br, p), 2
        if br.bit(128):
            v = -v
        out[_ZIGZAG[n]] = v * dq[n > 0]
        n += 1
        if n < 16:
            p = bands[n][nxt]
    return 16


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct_add(c, dst, y, x):
    """``TransformOne``: the 4x4 inverse DCT of c (raster order) added to
    dst[y:y+4, x:x+4] with clipping."""
    tmp = [0] * 16
    for i in range(4):
        a = c[i] + c[8 + i]
        b = c[i] - c[8 + i]
        cc = _mul2(c[4 + i]) - _mul1(c[12 + i])
        d = _mul1(c[4 + i]) + _mul2(c[12 + i])
        tmp[4 * i:4 * i + 4] = (a + d, b + cc, b - cc, a - d)
    for i in range(4):
        dc = tmp[i] + 4
        a = dc + tmp[8 + i]
        b = dc - tmp[8 + i]
        cc = _mul2(tmp[4 + i]) - _mul1(tmp[12 + i])
        d = _mul1(tmp[4 + i]) + _mul2(tmp[12 + i])
        row = dst[y + i]
        for k, v in enumerate((a + d, b + cc, b - cc, a - d)):
            s = row[x + k] + (v >> 3)
            row[x + k] = 0 if s < 0 else 255 if s > 255 else s



def _wht(c) -> list:
    """``TransformWHT``: the 16 luma DCs, in block raster order."""
    tmp = [0] * 16
    for i in range(4):
        a0 = c[i] + c[12 + i]
        a1 = c[4 + i] + c[8 + i]
        a2 = c[4 + i] - c[8 + i]
        a3 = c[i] - c[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        dc = tmp[4 * i] + 3
        a0 = dc + tmp[4 * i + 3]
        a1 = tmp[4 * i + 1] + tmp[4 * i + 2]
        a2 = tmp[4 * i + 1] - tmp[4 * i + 2]
        a3 = dc - tmp[4 * i + 3]
        out[4 * i:4 * i + 4] = ((a0 + a1) >> 3, (a3 + a2) >> 3, (a0 - a1) >> 3, (a3 - a2) >> 3)
    return out


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _clip(v):
    return 0 if v < 0 else 255 if v > 255 else v


def _pred4(mode, top, left, tl):
    """A 4x4 prediction (``dsp/dec.c``): top[0:8] (with the top-right),
    left[0:4], tl the corner; returns 4 rows."""
    A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    X = tl
    if mode == B_DC:
        v = (sum(top[:4]) + sum(left) + 4) >> 3
        return [[v] * 4 for _ in range(4)]
    if mode == B_TM:
        return [[_clip(t + left_ - X) for t in top[:4]] for left_ in left]
    if mode == B_VE:
        vals = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        return [list(vals) for _ in range(4)]
    if mode == B_HE:
        return [[v] * 4 for v in (_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L),
                                  _avg3(K, L, L))]
    d = [[0] * 4 for _ in range(4)]

    def put(v, *xy):
        for x, y in xy:
            d[y][x] = v

    if mode == B_RD:
        put(_avg3(J, K, L), (0, 3))
        put(_avg3(I, J, K), (1, 3), (0, 2))
        put(_avg3(X, I, J), (2, 3), (1, 2), (0, 1))
        put(_avg3(A, X, I), (3, 3), (2, 2), (1, 1), (0, 0))
        put(_avg3(B, A, X), (3, 2), (2, 1), (1, 0))
        put(_avg3(C, B, A), (3, 1), (2, 0))
        put(_avg3(D, C, B), (3, 0))
    elif mode == B_LD:
        put(_avg3(A, B, C), (0, 0))
        put(_avg3(B, C, D), (1, 0), (0, 1))
        put(_avg3(C, D, E), (2, 0), (1, 1), (0, 2))
        put(_avg3(D, E, F), (3, 0), (2, 1), (1, 2), (0, 3))
        put(_avg3(E, F, G), (3, 1), (2, 2), (1, 3))
        put(_avg3(F, G, H), (3, 2), (2, 3))
        put(_avg3(G, H, H), (3, 3))
    elif mode == B_VR:
        put(_avg2(X, A), (0, 0), (1, 2))
        put(_avg2(A, B), (1, 0), (2, 2))
        put(_avg2(B, C), (2, 0), (3, 2))
        put(_avg2(C, D), (3, 0))
        put(_avg3(K, J, I), (0, 3))
        put(_avg3(J, I, X), (0, 2))
        put(_avg3(I, X, A), (0, 1), (1, 3))
        put(_avg3(X, A, B), (1, 1), (2, 3))
        put(_avg3(A, B, C), (2, 1), (3, 3))
        put(_avg3(B, C, D), (3, 1))
    elif mode == B_VL:
        put(_avg2(A, B), (0, 0))
        put(_avg2(B, C), (1, 0), (0, 2))
        put(_avg2(C, D), (2, 0), (1, 2))
        put(_avg2(D, E), (3, 0), (2, 2))
        put(_avg3(A, B, C), (0, 1))
        put(_avg3(B, C, D), (1, 1), (0, 3))
        put(_avg3(C, D, E), (2, 1), (1, 3))
        put(_avg3(D, E, F), (3, 1), (2, 3))
        put(_avg3(E, F, G), (3, 2))
        put(_avg3(F, G, H), (3, 3))
    elif mode == B_HD:
        put(_avg2(I, X), (0, 0), (2, 1))
        put(_avg2(J, I), (0, 1), (2, 2))
        put(_avg2(K, J), (0, 2), (2, 3))
        put(_avg2(L, K), (0, 3))
        put(_avg3(A, B, C), (3, 0))
        put(_avg3(X, A, B), (2, 0))
        put(_avg3(I, X, A), (1, 0), (3, 1))
        put(_avg3(J, I, X), (1, 1), (3, 2))
        put(_avg3(K, J, I), (1, 2), (3, 3))
        put(_avg3(L, K, J), (1, 3))
    else:  # B_HU
        put(_avg2(I, J), (0, 0))
        put(_avg2(J, K), (2, 0), (0, 1))
        put(_avg2(K, L), (2, 1), (0, 2))
        put(_avg3(I, J, K), (1, 0))
        put(_avg3(J, K, L), (3, 0), (1, 1))
        put(_avg3(K, L, L), (3, 1), (1, 2))
        put(L, (3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3))
    return d


def _pred_block(mode, plane, y0, x0, size, has_top, has_left):
    """16x16 luma or 8x8 chroma prediction into plane[y0:, x0:] from the
    padded plane's border (row y0 - 1, column x0 - 1)."""
    top = plane[y0 - 1][x0:x0 + size]
    left = [plane[y0 + k][x0 - 1] for k in range(size)]
    tl = plane[y0 - 1][x0 - 1]
    shift = 4 if size == 16 else 3
    if mode == B_DC:
        if has_top and has_left:
            v = (sum(top) + sum(left) + size) >> (shift + 1)
        elif has_left:
            v = (sum(left) + (size >> 1)) >> shift
        elif has_top:
            v = (sum(top) + (size >> 1)) >> shift
        else:
            v = 128
        rows = [[v] * size for _ in range(size)]
    elif mode == B_VE:
        rows = [list(top) for _ in range(size)]
    elif mode == B_HE:
        rows = [[v] * size for v in left]
    else:  # TM
        rows = [[_clip(t + v - tl) for t in top] for v in left]
    for k in range(size):
        plane[y0 + k][x0:x0 + size] = rows[k]


def _filter_params(level, sharpness):
    """(limit, interior limit, hev threshold) of a filter level
    (``frame_dec.c`` PrecomputeFilterStrengths), or None for no filter."""
    if level <= 0:
        return None
    ilevel = level
    if sharpness > 0:
        ilevel >>= 2 if sharpness > 4 else 1
        ilevel = min(ilevel, 9 - sharpness)
    ilevel = max(ilevel, 1)
    return 2 * level + ilevel, ilevel, 2 if level >= 40 else 1 if level >= 15 else 0


def _sclip1(v):  # [-1020, 1020] -> [-128, 127]
    return -128 if v < -128 else 127 if v > 127 else v


def _sclip2(v):  # [-112, 112] -> [-16, 15]
    return -16 if v < -16 else 15 if v > 15 else v


def _edge(px, idx, step, thresh2, ithresh, hev, kind):
    """One position of a loop-filter edge (``dsp/dec.c``): ``kind`` "simple",
    "mb" (6 taps) or "inner" (4 taps); px a flat list, idx the q0 sample."""
    p1, p0, q0, q1 = px[idx - 2 * step], px[idx - step], px[idx], px[idx + step]
    if 4 * abs(p0 - q0) + abs(p1 - q1) > thresh2:
        return
    if kind != "simple":
        p3, p2 = px[idx - 4 * step], px[idx - 3 * step]
        q2, q3 = px[idx + 2 * step], px[idx + 3 * step]
        if (abs(p3 - p2) > ithresh or abs(p2 - p1) > ithresh or abs(p1 - p0) > ithresh
                or abs(q3 - q2) > ithresh or abs(q2 - q1) > ithresh
                or abs(q1 - q0) > ithresh):
            return
    if kind == "simple" or abs(p1 - p0) > hev or abs(q1 - q0) > hev:
        a = 3 * (q0 - p0) + _sclip1(p1 - q1)
        a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
        px[idx - step] = _clip(p0 + a2)
        px[idx] = _clip(q0 - a1)
    elif kind == "mb":
        a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        px[idx - 3 * step] = _clip(p2 + a3)
        px[idx - 2 * step] = _clip(p1 + a2)
        px[idx - step] = _clip(p0 + a1)
        px[idx] = _clip(q0 - a1)
        px[idx + step] = _clip(q1 - a2)
        px[idx + 2 * step] = _clip(q2 - a3)
    else:
        a = 3 * (q0 - p0)
        a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
        a3 = (a1 + 1) >> 1
        px[idx - 2 * step] = _clip(p1 + a3)
        px[idx - step] = _clip(p0 + a2)
        px[idx] = _clip(q0 - a1)
        px[idx + step] = _clip(q1 - a3)


def _filter_mb(planes, strides, mbx, mby, params, inner, simple):
    """``frame_dec.c`` DoFilter for one macroblock: the left edge, the inner
    vertical edges, the top edge, the inner horizontal edges."""
    limit, ilevel, hev = params
    chans = [(planes[0], strides[0], 16)] + ([] if simple else
                                               [(planes[1], strides[1], 8),
                                                (planes[2], strides[2], 8)])
    kind_mb, kind_in = ("simple", "simple") if simple else ("mb", "inner")
    for direction in ("h", "v"):
        for px, stride, size in chans:
            x0, y0 = mbx * size, mby * size
            edges = []
            if (mbx if direction == "h" else mby) > 0:
                edges.append((0, kind_mb, limit + 4))
            if inner:
                edges += [(k, kind_in, limit) for k in range(4, size, 4)]
            for off, kind, thresh in edges:
                t2 = 2 * thresh + 1
                for k in range(size):
                    if direction == "h":  # a vertical edge: filter across columns
                        _edge(px, (y0 + k) * stride + x0 + off, 1, t2, ilevel, hev, kind)
                    else:
                        _edge(px, (y0 + off) * stride + x0 + k, stride, t2, ilevel, hev, kind)


def _parse_modes(br, mbw, mbh, update_map, seg_probs, skip_prob):
    """Per macroblock (segment, skip, is_i4x4, 16 luma modes, chroma mode),
    all from the first partition (``tree_dec.c`` ParseIntraMode)."""
    bm = _BMODES
    top = [B_DC] * (4 * mbw)
    out = []
    for _ in range(mbh):
        left = [B_DC] * 4
        row = []
        for mx in range(mbw):
            seg = 0
            if update_map:
                seg = (br.bit(seg_probs[1]) if not br.bit(seg_probs[0])
                       else br.bit(seg_probs[2]) + 2)
            skip = br.bit(skip_prob) if skip_prob is not None else 0
            i4 = not br.bit(145)
            t = top[4 * mx:4 * mx + 4]
            if not i4:
                ymode = ((B_TM if br.bit(128) else B_HE) if br.bit(156)
                         else (B_VE if br.bit(163) else B_DC))
                modes = [ymode]
                t[:] = [ymode] * 4
                left = [ymode] * 4
            else:
                modes = []
                for y in range(4):
                    ym = left[y]
                    for x in range(4):
                        prob = bm[(t[x] * 10 + ym) * 9:(t[x] * 10 + ym) * 9 + 9]
                        if not br.bit(prob[0]):
                            ym = B_DC
                        elif not br.bit(prob[1]):
                            ym = B_TM
                        elif not br.bit(prob[2]):
                            ym = B_VE
                        elif not br.bit(prob[3]):
                            ym = (B_HE if not br.bit(prob[4])
                                  else (B_RD if not br.bit(prob[5]) else B_VR))
                        else:
                            ym = (B_LD if not br.bit(prob[6]) else
                                  (B_VL if not br.bit(prob[7]) else
                                   (B_HD if not br.bit(prob[8]) else B_HU)))
                        t[x] = ym
                        modes.append(ym)
                    left[y] = ym
            top[4 * mx:4 * mx + 4] = t
            uv = (B_DC if not br.bit(142) else B_VE if not br.bit(114)
                  else B_TM if br.bit(183) else B_HE)
            row.append((seg, skip, i4, modes, uv))
        out.append(row)
    return out


def decode_vp8(data: bytes) -> np.ndarray:
    """A VP8 key frame (the payload of a ``VP8 `` chunk) -> uint8 RGB
    [H, W, 3], as libwebp gives it in RGBA."""
    if len(data) < 10:
        raise ValueError("corrupt WebP: a VP8 frame too short")
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    if bits & 1:
        raise ValueError("WebP with a VP8 inter frame " + UNREAD)
    part0 = bits >> 5
    if data[3:6] != b"\x9d\x01\x2a":
        raise ValueError("corrupt WebP: no VP8 start code")
    w = (data[6] | (data[7] << 8)) & 0x3FFF
    h = (data[8] | (data[9] << 8)) & 0x3FFF
    br = _Bool(data[10:10 + part0])
    br.bit(128), br.bit(128)  # colour space, clamping type
    use_seg = br.bit(128)
    update_map, absolute, seg_q, seg_f, seg_probs = 0, 0, [0] * 4, [0] * 4, [255] * 3
    if use_seg:
        update_map = br.bit(128)
        if br.bit(128):  # segment data
            absolute = br.bit(128)
            seg_q = [br.signed(7) if br.bit(128) else 0 for _ in range(4)]
            seg_f = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
        if update_map:
            seg_probs = [br.value_of(8) if br.bit(128) else 255 for _ in range(3)]
    simple = br.bit(128)
    level, sharpness = br.value_of(6), br.value_of(3)
    ref_delta, mode_delta = [0] * 4, [0] * 4
    use_delta = br.bit(128)
    if use_delta and br.bit(128):
        ref_delta = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
        mode_delta = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
    nparts = 1 << br.value_of(2)
    pos = 10 + part0
    sizes = [int.from_bytes(data[pos + 3 * k:pos + 3 * k + 3], "little")
             for k in range(nparts - 1)]
    pos += 3 * (nparts - 1)
    parts = []
    for k in range(nparts):
        size = sizes[k] if k < nparts - 1 else len(data) - pos
        parts.append(_Bool(data[pos:pos + size]))
        pos += size
    base_q = br.value_of(7)
    dq = [br.signed(4) if br.bit(128) else 0 for _ in range(5)]  # y1dc y2dc y2ac uvdc uvac
    quant = []
    for sgm in range(4):
        q = (seg_q[sgm] + (0 if absolute else base_q)) if use_seg else base_q

        def clipq(v, hi=127):
            return 0 if v < 0 else hi if v > hi else v

        y2ac = (_AC_TABLE[clipq(q + dq[2])] * 101581) >> 16
        quant.append(((_DC_TABLE[clipq(q + dq[0])], _AC_TABLE[clipq(q)]),
                      (_DC_TABLE[clipq(q + dq[1])] * 2, max(y2ac, 8)),
                      (_DC_TABLE[clipq(q + dq[3], 117)], _AC_TABLE[clipq(q + dq[4])])))
    br.bit(128)  # refresh entropy probabilities: ignored, as libwebp does
    probs = []
    for t in range(4):
        bands = []
        for b in range(8):
            ctxs = []
            for c in range(3):
                base = ((t * 8 + b) * 3 + c) * 11
                ctxs.append([br.value_of(8) if br.bit(_COEFFS_UPDATE[base + k])
                             else _COEFFS0[base + k] for k in range(11)])
            bands.append(ctxs)
        probs.append([bands[_BANDS[n]] for n in range(17)])
    skip_prob = br.value_of(8) if br.bit(128) else None
    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    modes = _parse_modes(br, mbw, mbh, update_map, seg_probs, skip_prob)

    # filter strengths by segment and i4x4 (``PrecomputeFilterStrengths``)
    fparams = {}
    for sgm in range(4):
        base = (seg_f[sgm] + (0 if absolute else level)) if use_seg else level
        for i4 in (0, 1):
            lv = base
            if use_delta:
                lv += ref_delta[0] + (mode_delta[0] if i4 else 0)
            fparams[(sgm, i4)] = _filter_params(max(0, min(63, lv)), sharpness)
    filter_on = level != 0

    # padded planes: one row above and one column left (127 above, 129 left,
    # as libwebp's borders), 4 more columns on the right for the top-right
    ys, cs = 16 * mbw + 5, 8 * mbw + 1
    Y = [[127] * ys] + [[129] + [0] * (ys - 1) for _ in range(16 * mbh)]
    U = [[127] * cs] + [[129] + [0] * (cs - 1) for _ in range(8 * mbh)]
    V = [[127] * cs] + [[129] + [0] * (cs - 1) for _ in range(8 * mbh)]
    top_nz = [[0] * 9 for _ in range(mbw)]  # 4 luma, 2 u, 2 v columns, dc
    inner_of = {}
    for my in range(mbh):
        tokens = parts[my & (nparts - 1)]
        left_nz = [0] * 9
        for mx in range(mbw):
            sgm, skip, i4, imodes, uvmode = modes[my][mx]
            (y1, y2, uvq) = quant[sgm]
            coeffs = [[0] * 16 for _ in range(24)]
            nz_any = False
            tn, ln = top_nz[mx], left_nz
            if not skip:
                if not i4:
                    dc = [0] * 16
                    nz = _coeffs(tokens, probs[1], tn[8] + ln[8], y2, 0, dc)
                    tn[8] = ln[8] = int(nz > 0)
                    for k, v in enumerate(_wht(dc)):
                        coeffs[k][0] = v
                    first, band = 1, probs[0]
                else:
                    first, band = 0, probs[3]
                for by in range(4):
                    for bx in range(4):
                        blk = coeffs[4 * by + bx]
                        nz = _coeffs(tokens, band, ln[by] + tn[bx], y1, first, blk)
                        ln[by] = tn[bx] = int(nz > first)
                        if nz > 1 or blk[0]:
                            nz_any = True
                for ch in (0, 1):
                    for by in range(2):
                        for bx in range(2):
                            blk = coeffs[16 + 4 * ch + 2 * by + bx]
                            li, ti = 4 + 2 * ch + by, 4 + 2 * ch + bx
                            nz = _coeffs(tokens, probs[2], ln[li] + tn[ti], uvq, 0, blk)
                            ln[li] = tn[ti] = int(nz > 0)
                            if nz > 1 or blk[0]:
                                nz_any = True
            else:
                for k in range(8):
                    tn[k] = ln[k] = 0
                if not i4:
                    tn[8] = ln[8] = 0
            inner_of[(mx, my)] = bool(i4 or nz_any)
            _reconstruct(Y, U, V, mx, my, mbw, i4, imodes, uvmode, coeffs)
    if filter_on:
        planes = [sum(Y[1:], []), sum(U[1:], []), sum(V[1:], [])]
        strides = [ys, cs, cs]
        # the planes without their border: offset by one column
        planes = [p[1:] + [0] for p in planes]
        for my in range(mbh):
            for mx in range(mbw):
                prm = fparams[(modes[my][mx][0], int(modes[my][mx][2]))]
                if prm is not None:
                    _filter_mb(planes, strides, mx, my, prm, inner_of[(mx, my)], simple)
        y = np.asarray(planes[0][:16 * mbh * ys], np.int64).reshape(16 * mbh, ys)
        u = np.asarray(planes[1][:8 * mbh * cs], np.int64).reshape(8 * mbh, cs)
        v = np.asarray(planes[2][:8 * mbh * cs], np.int64).reshape(8 * mbh, cs)
    else:
        y = np.asarray(Y[1:], np.int64)[:, 1:]
        u = np.asarray(U[1:], np.int64)[:, 1:]
        v = np.asarray(V[1:], np.int64)[:, 1:]
    return yuv_to_rgb(y[:h, :w], u[:(h + 1) // 2, :(w + 1) // 2], v[:(h + 1) // 2, :(w + 1) // 2])


def _reconstruct(Y, U, V, mx, my, mbw, i4, imodes, uvmode, coeffs):
    """Predict one macroblock from its unfiltered neighbours and add its
    residuals (``frame_dec.c`` ReconstructRow); planes are padded by one
    row and column."""
    y0, x0 = 16 * my + 1, 16 * mx + 1
    if i4:
        # the top-right of the macroblock: the next one's bottom row above
        # it, or the last pixel above repeated at the right edge; 127 on top
        if my == 0:
            tr = [127] * 4
        elif mx == mbw - 1:
            tr = [Y[y0 - 1][x0 + 15]] * 4
        else:
            tr = Y[y0 - 1][x0 + 16:x0 + 20]
        for n in range(16):
            by, bx = divmod(n, 4)
            yy, xx = y0 + 4 * by, x0 + 4 * bx
            # top-right: the block above-right, or the macroblock's for the
            # last column of blocks
            top = Y[yy - 1][xx:xx + 4] + (tr if bx == 3 else Y[yy - 1][xx + 4:xx + 8])
            left = [Y[yy + k][xx - 1] for k in range(4)]
            pred = _pred4(imodes[n], top, left, Y[yy - 1][xx - 1])
            for k in range(4):
                Y[yy + k][xx:xx + 4] = pred[k]
            _idct_add(coeffs[n], Y, yy, xx)
    else:
        _pred_block(imodes[0], Y, y0, x0, 16, my > 0, mx > 0)
        for n in range(16):
            by, bx = divmod(n, 4)
            _idct_add(coeffs[n], Y, y0 + 4 * by, x0 + 4 * bx)
    cy, cx = 8 * my + 1, 8 * mx + 1
    for ch, P in enumerate((U, V)):
        _pred_block(uvmode, P, cy, cx, 8, my > 0, mx > 0)
        for n in range(4):
            by, bx = divmod(n, 2)
            _idct_add(coeffs[16 + 4 * ch + n], P, cy + 4 * by, cx + 4 * bx)


def _upsample_pair(top_c, cur_c, width):
    """libwebp's fancy upsampler (``UPSAMPLE_FUNC``) on one chroma channel
    for a pair of luma rows: top_c / cur_c are the chroma rows above and
    below; returns the chroma of the top and bottom luma rows, ``width``
    samples each."""
    rows_top = width
    tl, l_ = top_c[0], cur_c[0]
    out_t = [0] * rows_top
    out_b = [0] * rows_top
    out_t[0] = (3 * tl + l_ + 2) >> 2
    out_b[0] = (3 * l_ + tl + 2) >> 2
    last_pair = (rows_top - 1) >> 1
    for x in range(1, last_pair + 1):
        t, c = top_c[x], cur_c[x]
        avg = tl + t + l_ + c + 8
        d12 = (avg + 2 * (t + l_)) >> 3
        d03 = (avg + 2 * (tl + c)) >> 3
        out_t[2 * x - 1] = (d12 + tl) >> 1
        out_t[2 * x] = (d03 + t) >> 1
        out_b[2 * x - 1] = (d03 + l_) >> 1
        out_b[2 * x] = (d12 + c) >> 1
        tl, l_ = t, c
    if not rows_top & 1:
        out_t[rows_top - 1] = (3 * tl + l_ + 2) >> 2
        out_b[rows_top - 1] = (3 * l_ + tl + 2) >> 2
    return out_t, out_b


def _upsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """A chroma plane [(h+1)//2, (w+1)//2] -> [h, w] as ``EmitFancyRGB``
    pairs the rows: row 0 with itself, rows 2k-1 / 2k between chroma rows
    k-1 and k, the last row of an even height with the last chroma row."""
    rows = c.tolist()
    out = [None] * h
    out[0] = _upsample_pair(rows[0], rows[0], w)[0]
    for k in range(1, (h + 1) // 2 + 1):
        top, bot = 2 * k - 1, 2 * k
        if top >= h:
            break
        if bot < h:
            out[top], out[bot] = _upsample_pair(rows[k - 1], rows[k], w)
        else:  # even height: the last row from the last chroma row alone
            out[top] = _upsample_pair(rows[k - 1], rows[k - 1], w)[0]
    return np.asarray(out, np.int64)


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """libwebp's RGB output: fancy-upsampled chroma, then ``yuv.h``'s
    VP8YUVToR / G / B (14-bit fixed point, MultHi)."""
    h, w = y.shape
    uu, vv = _upsample(u, h, w), _upsample(v, h, w)
    yy = (y * 19077) >> 8

    def clip8(x):
        return np.where((x & ~16383) == 0, x >> 6, np.where(x < 0, 0, 255))

    r = clip8(yy + ((vv * 26149) >> 8) - 14234)
    g = clip8(yy - ((uu * 6419) >> 8) - ((vv * 13320) >> 8) + 8708)
    b = clip8(yy + ((uu * 33050) >> 8) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)
