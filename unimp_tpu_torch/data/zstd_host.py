"""Zstandard decoding in host C++ (``csrc/zstd_host.cc``), on a thread pool.

The plain version is ``data/zstd.py``: the same format and the same
errors, in pure Python, at about 1 MB/s, which is too slow for a
checkpoint of gigabytes (``train/orbax.py``). This module builds the C++
decoder with the host compiler the first time it is called
(``ops/kernel_lib.py:build_host``) and calls it through ``ctypes``, which
lets go of the GIL for the call. There is no fallback: a failed build or
a malformed record raises.

``decompress_batch(records, outs)`` decodes a list of records, each a
(buffer, offset, length) triple, one record at a time per thread; ``outs``
may give each record's destination (a writable uint8 numpy array that the
content must fill exactly), else each comes back as ``bytes``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from unimp_tpu_torch.data.zstd import ZstdError

ERR_LEN = 256
_lib = None
_lock = threading.Lock()


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            from unimp_tpu_torch.ops.kernel_lib import build_host

            lib = ctypes.CDLL(str(build_host("zstd_host")))
            P, I64 = ctypes.c_void_p, ctypes.c_int64
            lib.zstd_decode_batch.argtypes = [I64, P, P, P, P, P, P, ctypes.c_int, P, I64]
            lib.zstd_decode_batch.restype = ctypes.c_int
            lib.zstd_free.argtypes = [P]
            lib.zstd_free.restype = None
            lib.zstd_xxh64.argtypes = [P, I64]
            lib.zstd_xxh64.restype = ctypes.c_uint64
            lib.host_crc32c.argtypes = [P, I64]
            lib.host_crc32c.restype = ctypes.c_uint32
            _lib = lib
    return _lib


def default_threads() -> int:
    """The host cores this process may run on."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def _address(buf) -> Tuple[int, int, object]:
    """(address, size, the array keeping it alive) of a bytes-like buffer."""
    arr = buf if isinstance(buf, np.ndarray) else np.frombuffer(buf, np.uint8)
    if not arr.flags.c_contiguous:
        raise ValueError("a Zstandard record's buffer must be contiguous")
    return arr.ctypes.data, arr.nbytes, arr


Record = Tuple[object, int, int]


def decompress_batch(records: Sequence[Record], outs: Optional[Sequence[np.ndarray]] = None,
                     threads: Optional[int] = None) -> List:
    """Decode every record (buffer, offset, length) on ``threads`` host
    threads (default: every core this process may use). With ``outs``,
    record i's content fills ``outs[i]`` (a writable C-contiguous uint8
    array of exactly its size) and the list holds those arrays; else it
    holds ``bytes``. Raises ``ZstdError`` naming the first record that
    failed."""
    lib = _load()
    n = len(records)
    if n == 0:
        return []
    keep = []
    src = (ctypes.c_void_p * n)()
    src_len = (ctypes.c_int64 * n)()
    for i, (buf, offset, length) in enumerate(records):
        addr, size, arr = _address(buf)
        if offset < 0 or length < 0 or offset + length > size:
            raise ZstdError(f"record {i}: bytes {offset}:{offset + length} outside a buffer "
                            f"of {size}")
        keep.append(arr)
        src[i], src_len[i] = addr + offset, length
    dst = (ctypes.c_void_p * n)()
    cap = (ctypes.c_int64 * n)()
    if outs is not None:
        if len(outs) != n:
            raise ValueError(f"{len(outs)} outputs for {n} records")
        for i, out in enumerate(outs):
            if out.dtype != np.uint8 or not out.flags.c_contiguous or not out.flags.writeable:
                raise ValueError("an output must be a writable C-contiguous uint8 array")
            dst[i], cap[i] = out.ctypes.data, out.nbytes
    out_len = (ctypes.c_int64 * n)()
    owned = (ctypes.c_void_p * n)()
    errors = ctypes.create_string_buffer(n * ERR_LEN)
    threads = default_threads() if threads is None else threads
    failed = lib.zstd_decode_batch(n, src, src_len, dst, cap, out_len, owned,
                                   max(1, min(threads, n)), errors, ERR_LEN)
    result = list(outs) if outs is not None else []
    first, raw = None, errors.raw
    for i in range(n):
        msg = raw[i * ERR_LEN:(i + 1) * ERR_LEN].split(b"\0", 1)[0]
        if msg and first is None:
            first = (i, msg.decode(errors="replace"))
        if outs is None:
            p = owned[i]
            if p:
                if not msg:
                    result.append(ctypes.string_at(p, out_len[i]))
                lib.zstd_free(p)
            elif not msg:
                result.append(b"")
    if failed:
        i, msg = first
        raise ZstdError(f"record {i} of {n}: {msg}")
    return result


def decompress(data) -> bytes:
    """The content of every frame in ``data`` (``data/zstd.py:decompress``'s
    result), decoded in C++."""
    return decompress_batch([(data, 0, len(data))], threads=1)[0]


def xxh64(data) -> int:
    """XXH64 (seed 0) of a bytes-like buffer."""
    addr, size, _ = _address(data)
    return int(_load().zstd_xxh64(addr, size))


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of a bytes-like buffer."""
    addr, size, _ = _address(data)
    return int(_load().host_crc32c(addr, size))
