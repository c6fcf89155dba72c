"""Zstandard frame decoder (RFC 8878) in pure Python with numpy.

TIFF's compression 50000 (``data/tiff.py``) stores each strip or tile as
Zstandard frames. The card's Python has no ``compression.zstd`` (Python
3.14) and neither machine has the ``zstandard`` package, so the port
decodes the format itself:

  * frames: the magic, the header (window, dictionary ID, content size;
    a dictionary is refused), the content checksum (XXH64, checked), one
    or several frames, skippable frames;
  * blocks: raw, RLE and compressed;
  * literals: raw, RLE, and Huffman-coded in one or four streams, with a
    new tree (weights direct or FSE-coded) or the previous block's
    (treeless);
  * sequences: literal length, offset and match length codes under
    predefined, RLE, FSE-described or repeated tables, and the three
    repeat offsets.

``decompress(data, kinds)`` records in the set ``kinds`` each of those
kinds it meets ("block raw", "literals huffman 4", "weights fse",
"offsets fse", "offset repeat", ...), so that a test can show which
input reaches which code path.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

MAGIC = 0xFD2FB528
SKIPPABLE = 0x184D2A50  # to 0x184D2A5F

# (baseline, extra bits) of each literal length and match length code
_LL = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4),
    (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11), (4096, 12),
    (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
_ML = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4),
    (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12),
    (8195, 13), (16387, 14), (32771, 15), (65539, 16)]
# the predefined distributions: (accuracy log, normalized counts)
_LL_DEFAULT = (6, [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                   3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1])
_ML_DEFAULT = (6, [1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7)
_OF_DEFAULT = (5, [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                   -1, -1, -1, -1, -1])
_MAX_SYMBOL = {"literal lengths": 35, "offsets": 31, "match lengths": 52}
_MAX_LOG = {"literal lengths": 9, "offsets": 8, "match lengths": 9}


class ZstdError(ValueError):
    pass


# ---------------------------------------------------------------- bit readers


class _ForwardBits:
    """Little-endian bits from ``data[pos:]``, low bits first (FSE table
    descriptions)."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.start, self.bit = data, pos, 0

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.bit += n
        return v

    def peek(self, n: int) -> int:
        b = self.start + (self.bit >> 3)
        chunk = int.from_bytes(self.data[b:b + ((self.bit & 7) + n + 7) // 8], "little")
        return (chunk >> (self.bit & 7)) & ((1 << n) - 1)

    def end(self) -> int:
        """The byte after the last one read from."""
        return self.start + (self.bit + 7) // 8


class _BackwardBits:
    """A backward bitstream: read from its last byte's highest bit under
    the end marker (the highest set bit) towards its first byte; bits past
    the start read as zeros."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("corrupt Zstandard bitstream: no end marker")
        self.data = data
        self.pos = (len(data) - 1) * 8 + data[-1].bit_length() - 1  # bits left

    def peek(self, n: int) -> int:
        p = self.pos - n
        if p >= 0:
            v = int.from_bytes(self.data[p >> 3:(self.pos + 7) >> 3], "little") >> (p & 7)
        else:
            v = int.from_bytes(self.data[:(self.pos + 7) >> 3], "little") << -p
        return v & ((1 << n) - 1)

    def read(self, n: int) -> int:
        v = self.peek(n) if n else 0
        self.pos -= n
        return v

    def overflowed(self) -> bool:
        return self.pos < 0


# ---------------------------------------------------------------- FSE


def _read_distribution(data: bytes, pos: int, max_symbol: int, max_log: int):
    """An FSE table description at ``data[pos:]``: ((accuracy log,
    normalized counts), the position after it)."""
    bits = _ForwardBits(data, pos)
    log = bits.read(4) + 5
    if log > max_log:
        raise ZstdError(f"corrupt Zstandard data: FSE accuracy log {log} > {max_log}")
    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    counts: List[int] = []
    while remaining > 1 and len(counts) <= max_symbol:
        hi = 2 * threshold - 1 - remaining
        low = bits.peek(nbits - 1)
        if low & (threshold - 1) < hi:
            value = low & (threshold - 1)
            bits.bit += nbits - 1
        else:
            value = bits.peek(nbits) & (2 * threshold - 1)
            if value >= threshold:
                value -= hi
            bits.bit += nbits
        count = value - 1
        remaining -= abs(count)
        counts.append(count)
        if count == 0:  # runs of zero counts: 2-bit repeat flags, 3 continues
            while True:
                flag = bits.read(2)
                counts += [0] * flag
                if flag != 3:
                    break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise ZstdError("corrupt Zstandard data: bad FSE distribution")
    return (log, counts), bits.end()


def _fse_table(dist) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decoding table of a distribution: (symbol, bits to read, baseline)
    for each state."""
    log, counts = dist
    size = 1 << log
    symbol = np.zeros(size, np.int64)
    high = size - 1
    for s, c in enumerate(counts):  # "less than 1" symbols take the top cells
        if c == -1:
            symbol[high] = s
            high -= 1
    step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbol[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("corrupt Zstandard data: FSE table does not fill")
    nxt = [1 if c == -1 else c for c in counts]
    nbits = np.zeros(size, np.int64)
    base = np.zeros(size, np.int64)
    for u in range(size):
        s = int(symbol[u])
        x = nxt[s]
        nxt[s] += 1
        nbits[u] = log - (x.bit_length() - 1)
        base[u] = (x << int(nbits[u])) - size
    return symbol, nbits, base


class _Fse:
    """One FSE decoding state over a backward bitstream."""

    def __init__(self, table, bits: _BackwardBits):
        self.symbol, self.nbits, self.base = (t.tolist() for t in table)
        self.log = len(self.symbol).bit_length() - 1
        self.state = bits.read(self.log)

    def peek(self) -> int:
        return self.symbol[self.state]

    def update(self, bits: _BackwardBits) -> None:
        self.state = self.base[self.state] + bits.read(self.nbits[self.state])


# ---------------------------------------------------------------- Huffman


def _huffman_weights(data: bytes, pos: int, kinds) -> Tuple[List[int], int]:
    """The literal tree's weights (the last one implied) and the position
    after its description."""
    header = data[pos]
    pos += 1
    if header >= 128:  # direct: 4 bits a weight
        n = header - 127
        raw = data[pos:pos + (n + 1) // 2]
        weights = [(raw[i // 2] >> 4) if i % 2 == 0 else raw[i // 2] & 15 for i in range(n)]
        pos += (n + 1) // 2
        kinds.add("weights direct")
    else:  # FSE-coded, two interleaved states
        end = pos + header
        dist, start = _read_distribution(data[:end], pos, 255, 6)
        table = _fse_table(dist)
        bits = _BackwardBits(data[start:end])
        states = [_Fse(table, bits), _Fse(table, bits)]
        weights = []
        i = 0
        while True:
            weights.append(states[i].peek())
            states[i].update(bits)
            if bits.overflowed():
                weights.append(states[1 - i].peek())
                break
            i = 1 - i
        pos = end
        kinds.add("weights fse")
    total = sum(1 << (w - 1) for w in weights if w)
    if not total:
        raise ZstdError("corrupt Zstandard data: empty Huffman tree")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise ZstdError("corrupt Zstandard data: Huffman weights do not complete a tree")
    weights.append(rest.bit_length())
    return weights, pos


def _huffman_table(weights: List[int]):
    """(symbol, code length) for each value of the tree's longest code's
    bits."""
    max_bits = sum(1 << (w - 1) for w in weights if w).bit_length() - 1
    symbol = np.zeros(1 << max_bits, np.int64)
    length = np.zeros(1 << max_bits, np.int64)
    pos = 0
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                n = 1 << (w - 1)
                symbol[pos:pos + n] = s
                length[pos:pos + n] = max_bits + 1 - w
                pos += n
    return symbol.tolist(), length.tolist(), max_bits


def _huffman_stream(stream: bytes, table, n: int) -> bytes:
    symbol, length, max_bits = table
    bits = _BackwardBits(stream)
    out = bytearray(n)
    for i in range(n):
        v = bits.peek(max_bits)
        out[i] = symbol[v]
        bits.pos -= length[v]
    if bits.pos != 0:
        raise ZstdError("corrupt Zstandard data: Huffman stream not consumed exactly")
    return bytes(out)


# ---------------------------------------------------------------- blocks


class _Frame:
    """Decoding state carried from block to block within a frame."""

    def __init__(self, kinds):
        self.out = bytearray()
        self.huffman = None
        self.tables = {"literal lengths": None, "offsets": None, "match lengths": None}
        self.rep = [1, 4, 8]
        self.kinds = kinds


def _literals(data: bytes, pos: int, frame: _Frame) -> Tuple[bytes, int]:
    kind = data[pos] & 3
    fmt = (data[pos] >> 2) & 3
    if kind in (0, 1):  # raw, RLE
        if fmt in (0, 2):
            size, pos = data[pos] >> 3, pos + 1
        elif fmt == 1:
            size, pos = (data[pos] >> 4) + (data[pos + 1] << 4), pos + 2
        else:
            size = (data[pos] >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12)
            pos += 3
        if kind == 0:
            frame.kinds.add("literals raw")
            return bytes(data[pos:pos + size]), pos + size
        frame.kinds.add("literals rle")
        return bytes(data[pos:pos + 1]) * size, pos + 1
    nbytes, width = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[fmt]
    header = int.from_bytes(data[pos:pos + nbytes], "little") >> 4
    regen, comp = header & ((1 << width) - 1), header >> width
    pos += nbytes
    end = pos + comp
    if kind == 2:
        weights, pos = _huffman_weights(data[:end], pos, frame.kinds)
        frame.huffman = _huffman_table(weights)
        frame.kinds.add("literals huffman")
    else:
        if frame.huffman is None:
            raise ZstdError("corrupt Zstandard data: treeless literals with no tree")
        frame.kinds.add("literals treeless")
    if fmt == 0:
        frame.kinds.add("literals 1 stream")
        return _huffman_stream(data[pos:end], frame.huffman, regen), end
    frame.kinds.add("literals 4 streams")
    sizes = struct.unpack_from("<3H", data, pos)
    pos += 6
    sizes = list(sizes) + [end - pos - sum(sizes)]
    each = (regen + 3) // 4
    parts = []
    for k, size in enumerate(sizes):
        n = each if k < 3 else regen - 3 * each
        parts.append(_huffman_stream(data[pos:pos + size], frame.huffman, n))
        pos += size
    return b"".join(parts), end


def _sequence_tables(data: bytes, pos: int, frame: _Frame) -> int:
    modes = data[pos]
    pos += 1
    for name, shift, default in (("literal lengths", 6, _LL_DEFAULT),
                                 ("offsets", 4, _OF_DEFAULT),
                                 ("match lengths", 2, _ML_DEFAULT)):
        mode = (modes >> shift) & 3
        if mode == 0:
            frame.tables[name] = _fse_table(default)
            frame.kinds.add(f"{name} predefined")
        elif mode == 1:
            s = data[pos]
            pos += 1
            frame.tables[name] = (np.array([s]), np.array([0]), np.array([0]))
            frame.kinds.add(f"{name} rle")
        elif mode == 2:
            dist, pos = _read_distribution(data, pos, _MAX_SYMBOL[name], _MAX_LOG[name])
            frame.tables[name] = _fse_table(dist)
            frame.kinds.add(f"{name} fse")
        else:
            if frame.tables[name] is None:
                raise ZstdError(f"corrupt Zstandard data: repeated {name} table with none")
            frame.kinds.add(f"{name} repeat")
    return pos


def _compressed_block(data: bytes, frame: _Frame) -> None:
    literals, pos = _literals(data, 0, frame)
    n = data[pos]
    if n == 0:
        pos += 1
    elif n < 128:
        pos += 1
    elif n < 255:
        n, pos = ((n - 128) << 8) + data[pos + 1], pos + 2
    else:
        n, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    out, lit = frame.out, 0
    if n:
        pos = _sequence_tables(data, pos, frame)
        bits = _BackwardBits(data[pos:])
        ll = _Fse(frame.tables["literal lengths"], bits)
        of = _Fse(frame.tables["offsets"], bits)
        ml = _Fse(frame.tables["match lengths"], bits)
        rep = frame.rep
        for i in range(n):
            of_code, ml_code, ll_code = of.peek(), ml.peek(), ll.peek()
            offset = (1 << of_code) + bits.read(of_code)
            mlb, mle = _ML[ml_code]
            match = mlb + bits.read(mle)
            llb, lle = _LL[ll_code]
            length = llb + bits.read(lle)
            if offset > 3:
                offset -= 3
                rep[:] = [offset, rep[0], rep[1]]
            else:
                frame.kinds.add("offset repeat")
                # a sequence without literals shifts the choice by one
                idx = offset - 1 + (length == 0)
                if idx == 1:
                    rep[:] = [rep[1], rep[0], rep[2]]
                elif idx == 2:
                    rep[:] = [rep[2], rep[0], rep[1]]
                elif idx == 3:  # libzstd turns a 0 into 1
                    rep[:] = [max(rep[0] - 1, 1), rep[0], rep[1]]
                offset = rep[0]
            out += literals[lit:lit + length]
            lit += length
            if offset > len(out) or offset == 0:
                raise ZstdError("corrupt Zstandard data: match before the start")
            start = len(out) - offset
            if offset >= match:
                out += out[start:start + match]
            else:  # overlapping: the period repeats
                period = bytes(out[start:])
                out += (period * (match // offset + 1))[:match]
            if i < n - 1:
                ll.update(bits)
                ml.update(bits)
                of.update(bits)
        if bits.pos != 0:
            raise ZstdError("corrupt Zstandard data: sequences not consumed exactly")
        frame.kinds.add("sequences")
    out += literals[lit:]


# ---------------------------------------------------------------- frames


def _xxh64(data: bytes) -> int:
    """XXH64 with seed 0."""
    p1, p2, p3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
    p4, p5, m = 9650029242287828579, 2870177450012600261, (1 << 64) - 1

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & m

    def rnd(acc, lane):
        return rotl((acc + lane * p2) & m, 31) * p1 & m

    n, i = len(data), 0
    if n >= 32:
        v = [(p1 + p2) & m, p2, 0, (-p1) & m]
        lanes = np.frombuffer(data, "<u8", (n // 32) * 4).tolist()
        for j in range(0, len(lanes), 4):
            v = [rnd(v[k], lanes[j + k]) for k in range(4)]
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)) & m
        for x in v:
            h = ((h ^ rnd(0, x)) * p1 + p4) & m
        i = (n // 32) * 32
    else:
        h = p5
    h = (h + n) & m
    while i + 8 <= n:
        h = (rotl(h ^ rnd(0, struct.unpack_from("<Q", data, i)[0]), 27) * p1 + p4) & m
        i += 8
    if i + 4 <= n:
        h = (rotl(h ^ (struct.unpack_from("<I", data, i)[0] * p1 & m), 23) * p2 + p3) & m
        i += 4
    while i < n:
        h = rotl(h ^ (data[i] * p5 & m), 11) * p1 & m
        i += 1
    h = (h ^ (h >> 33)) * p2 & m
    h = (h ^ (h >> 29)) * p3 & m
    return h ^ (h >> 32)


def _frame(data: bytes, pos: int, kinds) -> Tuple[bytes, int]:
    desc = data[pos + 4]
    fcs_flag, single, checksum, dict_flag = desc >> 6, (desc >> 5) & 1, (desc >> 2) & 1, desc & 3
    if desc & 8:
        raise ZstdError("corrupt Zstandard data: reserved frame header bit set")
    pos += 5 + (0 if single else 1)
    dict_size = (0, 1, 2, 4)[dict_flag]
    if dict_size and int.from_bytes(data[pos:pos + dict_size], "little"):
        raise ZstdError("a Zstandard frame that needs a dictionary is not read")
    pos += dict_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content = int.from_bytes(data[pos:pos + fcs_size], "little") if fcs_size else None
    if fcs_size == 2:
        content += 256
    pos += fcs_size
    frame = _Frame(kinds)
    while True:
        if pos + 3 > len(data):
            raise ZstdError("truncated Zstandard frame")
        head = int.from_bytes(data[pos:pos + 3], "little")
        last, kind, size = head & 1, (head >> 1) & 3, head >> 3
        pos += 3
        if kind == 0:
            frame.out += data[pos:pos + size]
            pos += size
            kinds.add("block raw")
        elif kind == 1:
            frame.out += data[pos:pos + 1] * size
            pos += 1
            kinds.add("block rle")
        elif kind == 2:
            if pos + size > len(data):
                raise ZstdError("truncated Zstandard frame")
            _compressed_block(data[pos:pos + size], frame)
            pos += size
            kinds.add("block compressed")
        else:
            raise ZstdError("corrupt Zstandard data: reserved block type")
        if last:
            break
    out = bytes(frame.out)
    if content is not None and content != len(out):
        raise ZstdError(f"corrupt Zstandard frame: {len(out)} bytes, its header says {content}")
    if checksum:
        want = struct.unpack_from("<I", data, pos)[0]
        if _xxh64(out) & 0xFFFFFFFF != want:
            raise ZstdError("corrupt Zstandard frame: content checksum mismatch")
        pos += 4
        kinds.add("checksum")
    return out, pos


def decompress(data: bytes, kinds: Optional[set] = None) -> bytes:
    """The content of every frame in ``data``, concatenated; skippable
    frames are passed over. ``kinds``: a set that collects the kinds of
    blocks, literals, tables and frames met (see the module doc)."""
    kinds = set() if kinds is None else kinds
    data = bytes(data)
    out, pos = [], 0
    while pos < len(data):
        if pos + 4 > len(data):
            raise ZstdError("truncated Zstandard data")
        magic = struct.unpack_from("<I", data, pos)[0]
        if magic & 0xFFFFFFF0 == SKIPPABLE:
            pos += 8 + struct.unpack_from("<I", data, pos + 4)[0]
            kinds.add("skippable frame")
        elif magic == MAGIC:
            content, pos = _frame(data, pos, kinds)
            out.append(content)
            kinds.add("frame")
        else:
            raise ZstdError("not Zstandard data (bad magic number)")
    if len(out) > 1:
        kinds.add("frames")
    return b"".join(out)
