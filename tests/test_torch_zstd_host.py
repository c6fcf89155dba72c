"""The host C++ Zstandard decoder (``data/zstd_host.py``) against ``data/zstd.py``.

The Python decoder is the plain version: on libzstd's frames at several
levels (which together reach every kind of block, literals, Huffman
weights and sequence table), on the ZSTD TIFF fixtures' strips, on
hand-made frames (RLE literals, raw and RLE blocks, skippable frames,
several frames in one buffer) and on the records of the committed Orbax
checkpoint, the C++ decoder gives the same bytes byte for byte. On cut
and corrupted frames it raises ``ZstdError`` and reads nothing past its
buffer. The decoder builds with the host compiler at first use
(``ops/kernel_lib.py:build_host``), here as on the card's machine.
"""

import ctypes
import struct
import threading
from pathlib import Path

import numpy as np
import pytest

from unimp_tpu_torch.data import zstd, zstd_host
from unimp_tpu_torch.ops import kernel_lib
from unimp_tpu_torch.train import orbax

FIXTURE = Path(__file__).parent / "data" / "orbax"
LEVELS = (1, 3, 19)


def _libzstd():
    """PIL's bundled libzstd (its TIFF codec), through ctypes: the encoder."""
    import PIL

    (path,) = Path(PIL.__file__).parents[1].glob("pillow.libs/libzstd*")
    lib = ctypes.CDLL(str(path))
    lib.ZSTD_compressBound.restype = lib.ZSTD_compress2.restype = ctypes.c_size_t
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    return lib


def _compress(raw: bytes, level: int, checksum: bool = True) -> bytes:
    lib = _libzstd()
    cctx = ctypes.c_void_p(lib.ZSTD_createCCtx())
    lib.ZSTD_CCtx_setParameter(cctx, 100, level)  # ZSTD_c_compressionLevel
    lib.ZSTD_CCtx_setParameter(cctx, 201, int(checksum))  # ZSTD_c_checksumFlag
    cap = lib.ZSTD_compressBound(len(raw))
    buf = ctypes.create_string_buffer(cap)
    n = lib.ZSTD_compress2(cctx, buf, ctypes.c_size_t(cap), raw, ctypes.c_size_t(len(raw)))
    lib.ZSTD_freeCCtx(cctx)
    return buf.raw[:n]


def _data(kind: str) -> bytes:
    rng = np.random.default_rng(3)
    if kind == "text":
        return b" ".join(rng.choice([b"the", b"item", b"beauty", b"review", b"of"], 30000))
    if kind == "noise":
        return rng.integers(0, 256, 70000, np.uint8).tobytes()
    if kind == "runs":
        return np.repeat(rng.integers(0, 3, 5000), rng.integers(1, 40, 5000)).astype(
            np.uint8).tobytes()
    if kind == "geometric":
        return np.minimum(rng.geometric(0.02, 150000), 255).astype(np.uint8).tobytes()
    # bfloat16 weights, as a checkpoint stores them: the exponent bytes compress
    w = rng.standard_normal(200000).astype(np.float32) * 0.02
    return (w.view(np.uint32) >> 16).astype(np.uint16).tobytes()


KINDS = ("text", "noise", "runs", "geometric", "bf16")


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("kind", KINDS)
def test_libzstd_frames_equal_python(kind, level):
    """libzstd's frames, with and without the content checksum: the C++
    decoder gives the Python decoder's bytes, which are the input."""
    data = _data(kind)
    for checksum in (True, False):
        frame = _compress(data, level, checksum)
        assert zstd_host.decompress(frame) == zstd.decompress(frame) == data


def test_frames_reach_every_kind():
    """Together the frames of ``test_libzstd_frames_equal_python`` and the
    hand-made ones reach every kind ``data/zstd.py`` names but the RLE
    offsets and repeated match-length tables, which the TIFF strips reach
    (``test_tiff_strips_equal_python``)."""
    seen = set()
    for kind in KINDS:
        for level in LEVELS:
            zstd.decompress(_compress(_data(kind), level), seen)
    for frame, _ in _hand_frames():
        zstd.decompress(frame, seen)
    want = {"block raw", "block rle", "block compressed", "literals raw", "literals rle",
            "literals huffman", "literals treeless", "literals 1 stream", "literals 4 streams",
            "weights direct", "weights fse", "offset repeat", "checksum", "skippable frame",
            "frames", "literal lengths fse", "offsets fse", "match lengths fse",
            "literal lengths predefined", "offsets predefined", "match lengths predefined",
            "match lengths rle", "literal lengths rle", "offsets repeat",
            "literal lengths repeat"}
    assert want <= seen, sorted(want - seen)


def _head(size, kind, last=0):
    return struct.pack("<I", (size << 3) | (kind << 1) | last)[:3]


def _hand_frames():
    """(frame, content) pairs of the kinds libzstd's encoder does not make
    here: RLE literals, raw + RLE blocks, a checksum, two frames around a
    skippable frame, and a frame with no content size."""
    rng = np.random.default_rng(7)
    content = bytes([40]) * 200 + rng.integers(0, 256, 216, np.uint8).tobytes() + bytes([9]) * 64
    run, mid = 200, content[200:416]
    lit = bytes([1 | (1 << 2) | ((run & 15) << 4), run >> 4]) + content[:1] + b"\0"
    with_size = (struct.pack("<IB", zstd.MAGIC, (2 << 6) | (1 << 5) | 4)
                 + struct.pack("<I", len(content)) + _head(len(lit), 2) + lit
                 + _head(len(mid), 0) + mid + _head(64, 1, 1) + content[-1:]
                 + struct.pack("<I", zstd_host.xxh64(content) & 0xFFFFFFFF))
    no_size = struct.pack("<IBB", zstd.MAGIC, 0, 0x30) + _head(len(mid), 0, 1) + mid
    second = _compress(content[::-1], 3)
    skip = struct.pack("<II", 0x184D2A5A, 5) + b"skip!"
    return [(with_size, content), (no_size, mid),
            (with_size + skip + second + no_size, content + content[::-1] + mid)]


def test_hand_made_frames_equal_python():
    for frame, content in _hand_frames():
        assert zstd_host.decompress(frame) == zstd.decompress(frame) == content
    assert zstd_host.xxh64(b"") == zstd._xxh64(b"")
    blob = np.random.default_rng(1).integers(0, 256, 1000, np.uint8).tobytes()
    for n in (0, 3, 4, 7, 8, 31, 32, 33, 64, 1000):
        assert zstd_host.xxh64(blob[:n]) == zstd._xxh64(blob[:n])


def test_tiff_strips_equal_python():
    """The strips of the ZSTD TIFF fixtures (libtiff's encoder through PIL,
    ``tests/test_torch_images.py``), which reach every kind of table."""
    import test_torch_images as images

    seen = 0
    for name in images.ZSTD_KINDS:
        frames = []
        orig = zstd.decompress

        def spy(data, kinds=None):
            frames.append(bytes(data))
            return orig(data, kinds)

        zstd.decompress = spy
        try:
            images.transforms.decode_image(images.FILES[name])
        finally:
            zstd.decompress = orig
        for frame in frames:
            assert zstd_host.decompress(frame) == zstd.decompress(frame)
            seen += 1
    assert seen >= len(images.ZSTD_KINDS)


@pytest.mark.parametrize("kind", KINDS)
def test_cut_and_corrupt_frames_raise(kind):
    """Every cut of a frame (with its checksum) raises ``ZstdError`` in C++;
    so does a flipped checksum byte, a bad magic number and a reserved
    block type. Each cut is the start of a longer buffer, so a read past
    the cut would see valid bytes and not fail."""
    frame = _compress(_data(kind), 3)
    step = max(1, len(frame) // 150)
    cuts = sorted(set(range(1, len(frame), step)) | {len(frame) - 1, len(frame) - 4, 5, 6})
    backing = np.frombuffer(frame + frame, np.uint8)
    for cut in cuts:
        with pytest.raises(zstd.ZstdError):
            zstd_host.decompress_batch([(backing, 0, cut)])
    bad = bytearray(frame)
    bad[-1] ^= 1
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd_host.decompress(bytes(bad))
    with pytest.raises(zstd.ZstdError, match="magic"):
        zstd_host.decompress(b"\0" + frame[1:])
    raw = struct.pack("<IB", zstd.MAGIC, 0x20) + bytes([3]) + _head(1, 3, 1) + b"x"
    with pytest.raises(zstd.ZstdError, match="reserved block"):
        zstd_host.decompress(raw)
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(raw)


def test_batch_into_buffers_and_sizes():
    """A batch on several threads fills the given buffers; a buffer of the
    wrong size raises, naming the record."""
    datas = [_data(kind) for kind in KINDS]
    frames = [_compress(d, 3) for d in datas]
    outs = [np.empty(len(d), np.uint8) for d in datas]
    got = zstd_host.decompress_batch([(f, 0, len(f)) for f in frames], outs, threads=3)
    assert all(g is o and g.tobytes() == d for g, o, d in zip(got, outs, datas))
    short = [np.empty(len(d) - 1, np.uint8) for d in datas]
    with pytest.raises(zstd.ZstdError, match="record 0 of 5"):
        zstd_host.decompress_batch([(f, 0, len(f)) for f in frames], short)
    long = [np.empty(len(d) + 1, np.uint8) for d in datas]
    with pytest.raises(zstd.ZstdError, match="less content"):
        zstd_host.decompress_batch([(f, 0, len(f)) for f in frames], long)
    with pytest.raises(zstd.ZstdError, match="outside"):
        zstd_host.decompress_batch([(frames[0], 1, len(frames[0]))])


def test_orbax_records_equal_python():
    """Every Zstandard record of the committed JAX-written checkpoint's
    values (its zarr chunks), decoded in one batch, equals ``data/zstd.py``."""
    n = 0
    for name in ("final_weights", "checkpoint_0"):
        records = orbax.zstd_records(str(FIXTURE / name))
        got = zstd_host.decompress_batch([(r, 0, len(r)) for r in records])
        assert got == [zstd.decompress(r) for r in records]
        n += len(records)
    assert n > 100


def test_concurrent_builds_do_not_race(tmp_path, monkeypatch):
    """Builds started at once (as the test workers may) each write a file
    of their own and rename it into place; the library loads after."""
    monkeypatch.setattr(kernel_lib, "BUILD_DIR", tmp_path / "build")
    paths, errors = [], []

    def build():
        try:
            paths.append(kernel_lib.build_host("zstd_host"))
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1
    assert [p.name for p in (tmp_path / "build").iterdir()] == [paths[0].name]
    lib = ctypes.CDLL(str(paths[0]))
    lib.zstd_xxh64.restype = ctypes.c_uint64
    assert lib.zstd_xxh64(b"abc", ctypes.c_int64(3)) == zstd._xxh64(b"abc")
