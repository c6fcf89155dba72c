"""Read the JAX package's Orbax checkpoints without JAX, Orbax or tensorstore.

``unimp_tpu/train/checkpoint.py`` writes every checkpoint with
``ocp.StandardCheckpointer()``: a directory holding

  * ``_METADATA``: JSON, ``tree_metadata`` keyed by the tuple string of
    each leaf's path (``"('params', 'lm', 'w')"``), with its
    ``value_type`` (``jax.Array``, ``np.ndarray``, ``scalar``, or ``None``
    / ``Tuple`` / ``Dict`` for empty nodes, ``skip_deserialize``), and
    ``use_ocdbt`` / ``use_zarr3``;
  * an OCDBT database (tensorstore's "optionally-cooperative distributed
    B+tree", google.github.io/tensorstore/kvstore/ocdbt): the root
    ``manifest.ocdbt`` (and ``d/`` B-tree nodes) that merges what each
    process wrote under ``ocdbt.process_{i}/``;
  * in it, a zarr v2 array for each leaf, named by the path joined with
    ".": ``name/.zarray`` (dtype, shape, chunks, order, fill value,
    compressor, dimension separator) and one key a chunk
    (``name/0.1``).

The OCDBT structures read here:

  * every file (manifest, B-tree node) starts with a 4-byte big-endian
    magic number, its length (8 bytes, little-endian), a format version
    and a compression (0 none, 1 Zstandard) as varints, and ends with a
    CRC-32C (checked); the body between is compressed as the header says;
  * the manifest's body: the configuration (uuid, manifest kind,
    inline-value limit, node-size limit, version-tree arity, compression,
    data-file prefixes), then the latest versions inline, columns of
    (generation, root height, root node reference, statistics, commit
    time), then references to older version-tree nodes (not needed to
    read the latest version);
  * a data-file table before every list of references: each path as the
    previous one's first ``prefix`` bytes plus a suffix, and its base path
    (``ocdbt.process_0/``) as its first ``base`` bytes; a reference is
    (file index, offset, length) into that table;
  * B-tree nodes: a height, then the entries in columns. Keys are
    prefix-compressed against the previous key; an interior node's entry
    also gives the length of its subtree's common prefix, which the
    child's keys leave out, then the child's reference and statistics; a
    leaf's entry gives its value's length and kind (0 inline, 1 a
    reference), the references of the indirect values, then the inline
    values' bytes.

Values (the zarr chunks) are Zstandard frames, decoded in one batch on a
pool of host threads by ``data/zstd_host.py``'s C++ decoder; a chunk that
is not stored reads as the array's fill value. bfloat16 arrays are built
from their bytes (``torch.frombuffer``), never through float32.

``read_tree(path)`` gives {flat Flax path "a/b/c": host tensor} (a
``scalar`` leaf as a Python number), the naming of ``train/checkpoint.py``
and ``tools/from_flax.py:load_flax_params``. ``opt_state_dict`` maps the
optax state of a JAX ``checkpoint_{e}`` onto the port optimizer's
``state_dict()``.
"""

from __future__ import annotations

import ast
import json
import mmap
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from unimp_tpu_torch.data import zstd_host

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
MANIFEST = "manifest.ocdbt"
PROCESS_PREFIX = "ocdbt.process_"


class OrbaxError(ValueError):
    pass


# ---------------------------------------------------------------- encoding


class _Reader:
    """Varints and bytes from a node's body, bounds checked."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise OrbaxError(f"{self.what}: truncated")

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            self._need(1)
            b = self.data[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise OrbaxError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def byte(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def take(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]


def _envelope(raw: bytes, magic: int, what: str) -> Tuple[int, bytes]:
    """(compression, body) of a manifest or node file's bytes."""
    if len(raw) < 4 + 8 + 2 + 4 or int.from_bytes(raw[:4], "big") != magic:
        raise OrbaxError(f"{what}: not an OCDBT {what.split()[0]} (bad magic number)")
    if int.from_bytes(raw[4:12], "little") != len(raw):
        raise OrbaxError(f"{what}: length field differs from its size")
    if zstd_host.crc32c(memoryview(raw)[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise OrbaxError(f"{what}: CRC-32C checksum mismatch")
    r = _Reader(raw[:-4], what)
    r.pos = 12
    version = r.varint()
    if version != 0:
        raise OrbaxError(f"{what}: format version {version} is not read")
    compression = r.varint()
    if compression not in (0, 1):
        raise OrbaxError(f"{what}: unknown compression {compression}")
    return compression, raw[r.pos:-4]


def _decode_bodies(items: List[Tuple[int, bytes]]) -> List[bytes]:
    """The bodies of several envelopes, the compressed ones in one batch."""
    packed = [body for comp, body in items if comp == 1]
    plain = iter(zstd_host.decompress_batch([(b, 0, len(b)) for b in packed]) if packed else ())
    return [next(plain) if comp == 1 else body for comp, body in items]


def _file_table(r: _Reader) -> List[str]:
    """The data-file table: each file's path (base path + relative path)."""
    n = r.varint()
    if n == 0:
        return []
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    base = r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OrbaxError(f"{r.what}: bad data-file prefix")
        path = prev[:prefix[i]] + r.take(suffix[i])
        if base[i] > len(path):
            raise OrbaxError(f"{r.what}: bad data-file base path")
        paths.append(path.decode())
        prev = path
    return paths


def _ref(paths: List[str], file_id: int, what: str) -> str:
    if file_id >= len(paths):
        raise OrbaxError(f"{what}: data file {file_id} not in its table of {len(paths)}")
    return paths[file_id]


# ---------------------------------------------------------------- OCDBT


class _Files:
    """The database's files, mapped once each."""

    def __init__(self, root: str):
        self.root = root
        self.maps: Dict[str, object] = {}

    def get(self, rel: str):
        m = self.maps.get(rel)
        if m is None:
            path = os.path.join(self.root, rel)
            if not os.path.isfile(path):
                raise OrbaxError(f"{path}: missing OCDBT data file")
            with open(path, "rb") as f:
                size = os.fstat(f.fileno()).st_size
                m = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) if size else b""
            self.maps[rel] = m
        return m

    def read(self, ref: Tuple[str, int, int]) -> bytes:
        rel, offset, length = ref
        m = self.get(rel)
        if offset + length > len(m):
            raise OrbaxError(f"{rel}: bytes {offset}:{offset + length} past its end {len(m)}")
        return m[offset:offset + length]

    def close(self) -> None:
        """Drop the maps; each closes once no array views it."""
        self.maps.clear()


def _manifest_root(raw: bytes, what: str) -> Optional[Tuple[Tuple[str, int, int], int]]:
    """(reference, height) of the latest version's root B-tree node, or
    None for an empty database."""
    compression, body = _envelope(raw, MANIFEST_MAGIC, what)
    (body,) = _decode_bodies([(compression, body)])
    r = _Reader(body, what)
    r.take(16)  # uuid
    kind = r.varint()
    if kind != 0:
        raise OrbaxError(f"{what}: a numbered manifest (kind {kind}) is not read")
    r.varint()  # max_inline_value_bytes
    r.varint()  # max_decoded_node_bytes
    r.byte()  # version_tree_arity_log2
    if r.varint() == 1:  # Zstandard: its level
        r.varint()
    for _ in range(3):  # value, B-tree node and version-tree node data prefixes
        r.take(r.varint())
    paths = _file_table(r)
    n = r.varint()
    if n == 0:
        return None
    generation = r.varints(n)
    height = [r.byte() for _ in range(n)]
    file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
    num_keys = r.varints(n)
    r.varints(2 * n)  # tree bytes, indirect value bytes
    r.take(8 * n)  # commit times
    last = max(range(n), key=generation.__getitem__)
    if num_keys[last] == 0 or length[last] == 0:
        return None
    return (_ref(paths, file_id[last], what), offset[last], length[last]), height[last]


def _node_entries(body: bytes, what: str, height: int):
    """A B-tree node's entries: (key, (common prefix length, child ref))
    for an interior node, (key, bytes or ref) for a leaf."""
    r = _Reader(body, what)
    if r.byte() != height:
        raise OrbaxError(f"{what}: height differs from its parent's")
    paths = _file_table(r)
    n = r.varint()
    prefix = [0] + (r.varints(n - 1) if n else [])
    suffix = r.varints(n)
    common = r.varints(n) if height else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OrbaxError(f"{what}: bad key prefix")
        prev = prev[:prefix[i]] + r.take(suffix[i])
        keys.append(prev)
    if height:
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # statistics
        return [(keys[i], (common[i], (_ref(paths, file_id[i], what), offset[i], length[i])))
                for i in range(n)]
    length = r.varints(n)
    kind = r.varints(n)
    if any(k > 1 for k in kind):
        raise OrbaxError(f"{what}: unknown value kind")
    indirect = [i for i in range(n) if kind[i] == 1]
    file_id, offset = r.varints(len(indirect)), r.varints(len(indirect))
    values: List[object] = [None] * n
    for j, i in enumerate(indirect):
        values[i] = (_ref(paths, file_id[j], what), offset[j], length[i])
    for i in range(n):
        if kind[i] == 0:
            values[i] = r.take(length[i])
    return list(zip(keys, values))


def _read_kv(files: _Files, base: str) -> Dict[bytes, object]:
    """Every key of the database whose manifest is ``base/manifest.ocdbt``:
    {key: inline bytes or (file, offset, length)}, the file relative to
    ``files.root``. The nodes of each level are decoded in one batch."""
    what = os.path.join(base, MANIFEST) or MANIFEST
    root = _manifest_root(bytes(files.read((what, 0, len(files.get(what))))), what)
    out: Dict[bytes, object] = {}
    if root is None:
        return out
    level = [(b"", os.path.join(base, root[0][0]), root[0][1], root[0][2])]
    height = root[1]
    while level:
        items = []
        for _, rel, offset, length in level:
            raw = bytes(files.read((rel, offset, length)))
            items.append(_envelope(raw, BTREE_MAGIC, f"B-tree node {rel}:{offset}"))
        bodies = _decode_bodies(items)
        nxt = []
        for (pre, rel, offset, _), body in zip(level, bodies):
            for key, value in _node_entries(body, f"B-tree node {rel}:{offset}", height):
                if height:
                    common, (crel, coff, clen) = value
                    nxt.append((pre + key[:common], os.path.join(base, crel), coff, clen))
                elif isinstance(value, tuple):
                    out[pre + key] = (os.path.join(base, value[0]), value[1], value[2])
                else:
                    out[pre + key] = value
        level, height = nxt, height - 1
        if height < -1:
            raise OrbaxError(f"{what}: B-tree deeper than its manifest says")
    return out


def read_kv(path: str, files: Optional[_Files] = None) -> Dict[bytes, object]:
    """The key-value store of an Orbax directory: its root database, or,
    where the processes' databases were never merged, each of them."""
    own = files is None
    files = files or _Files(path)
    try:
        if os.path.exists(os.path.join(path, MANIFEST)):
            return _read_kv(files, "")
        out: Dict[bytes, object] = {}
        for sub in sorted(os.listdir(path)):
            if sub.startswith(PROCESS_PREFIX) and os.path.exists(
                    os.path.join(path, sub, MANIFEST)):
                out.update(_read_kv(files, sub))
        if not out:
            raise OrbaxError(f"{path}: no OCDBT manifest")
        return out
    finally:
        if own:
            files.close()


# ---------------------------------------------------------------- zarr v2


def _zarr_dtype(spec) -> Tuple[np.dtype, Optional[torch.dtype]]:
    """(numpy dtype holding the bytes, torch dtype) of a zarr dtype."""
    if spec == "bfloat16":
        return np.dtype("<u2"), torch.bfloat16
    if not isinstance(spec, str):
        raise OrbaxError(f"structured zarr dtype {spec!r} is not read")
    dt = np.dtype(spec)
    if dt.kind not in "biuf":
        raise OrbaxError(f"zarr dtype {spec!r} is not read")
    return dt, None


def _fill(value, dt: np.dtype, bf16: bool):
    """The fill value as one element of ``dt``'s bytes."""
    if value is None:
        return np.zeros((), dt)
    if isinstance(value, str):
        value = {"NaN": float("nan"), "Infinity": float("inf"),
                 "-Infinity": float("-inf")}[value]
    if bf16:
        bits = torch.tensor(float(value), dtype=torch.bfloat16).view(torch.int16).item()
        return np.array(bits & 0xFFFF, dt)
    return np.array(value, dt)


class _Array:
    """One zarr v2 array: its metadata, destination and chunk keys."""

    def __init__(self, name: str, meta: dict):
        if meta.get("zarr_format") != 2:
            raise OrbaxError(f"{name}: zarr format {meta.get('zarr_format')} is not read")
        if meta.get("filters"):
            raise OrbaxError(f"{name}: zarr filters {meta['filters']} are not read")
        comp = meta.get("compressor")
        if comp is not None and comp.get("id") != "zstd":
            raise OrbaxError(f"{name}: compressor {comp.get('id')!r} is not read")
        self.name, self.zstd = name, comp is not None
        self.shape = tuple(int(d) for d in meta["shape"])
        self.chunks = tuple(int(c) for c in meta["chunks"])
        if len(self.chunks) != len(self.shape) or any(c < 1 for c in self.chunks):
            raise OrbaxError(f"{name}: chunks {self.chunks} for shape {self.shape}")
        self.order = meta.get("order", "C")
        self.sep = meta.get("dimension_separator", ".")
        self.dt, self.torch_dtype = _zarr_dtype(meta["dtype"])
        self.fill = _fill(meta.get("fill_value"), self.dt, self.torch_dtype is not None)
        self.grid = [-(-s // c) for s, c in zip(self.shape, self.chunks)]
        self.dest = np.empty(self.shape, self.dt)  # host bytes in the array's layout

    def chunk_keys(self):
        """(chunk index, key) of every chunk of the grid."""
        for idx in np.ndindex(*self.grid):
            key = self.sep.join(str(i) for i in idx) if idx else "0"
            yield idx, f"{self.name}/{key}".encode()

    def chunk_bytes(self) -> int:
        return int(np.prod(self.chunks, dtype=np.int64)) * self.dt.itemsize

    def whole(self) -> bool:
        """One chunk covers the array exactly (its bytes go straight into
        the destination)."""
        return self.chunks == self.shape and (self.order == "C" or len(self.shape) < 2)

    def _region(self, idx) -> tuple:
        """The slices of the array that chunk ``idx`` covers (an edge chunk
        is cut to the array)."""
        return tuple(slice(i * c, min((i + 1) * c, s))
                     for i, c, s in zip(idx, self.chunks, self.shape))

    def place(self, idx, flat: np.ndarray) -> None:
        """Put a chunk's bytes (uint8) at its place in the array."""
        chunk = flat.view(self.dt).reshape(self.chunks, order=self.order)
        sl = self._region(idx)
        self.dest[sl] = chunk[tuple(slice(0, s.stop - s.start) for s in sl)]

    def fill_chunk(self, idx) -> None:
        self.dest[self._region(idx)] = self.fill

    def tensor(self) -> torch.Tensor:
        arr = self.dest  # C-contiguous
        if arr.dtype.byteorder == ">":
            arr = arr.byteswap().view(arr.dtype.newbyteorder("<"))
        if self.torch_dtype is None:
            return torch.from_numpy(arr)
        if not arr.size:
            return torch.empty(self.shape, dtype=self.torch_dtype)
        return torch.frombuffer(memoryview(arr.reshape(-1)).cast("B"),
                                dtype=self.torch_dtype).reshape(self.shape)


# ---------------------------------------------------------------- the tree


def _metadata(path: str) -> dict:
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.exists(meta_path):
        raise OrbaxError(f"{path}: no _METADATA (not an Orbax checkpoint of the JAX package)")
    with open(meta_path) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", True):
        raise OrbaxError(f"{path}: a checkpoint written without OCDBT is not read")
    if meta.get("use_zarr3"):
        raise OrbaxError(f"{path}: a zarr3 checkpoint is not read")
    return meta


def leaf_paths(path: str, meta: Optional[dict] = None) -> Dict[Tuple[str, ...], dict]:
    """{tree path (tuple of keys): value metadata} of an Orbax directory's
    leaves, empty nodes included."""
    out = {}
    for key, entry in (meta or _metadata(path))["tree_metadata"].items():
        keys = tuple(str(k["key"]) for k in entry["key_metadata"]) if "key_metadata" in entry \
            else tuple(str(k) for k in ast.literal_eval(key))
        out[keys] = entry["value_metadata"]
    return out


def read_tree(path: str, keep: Optional[Callable[[Tuple[str, ...]], bool]] = None) -> dict:
    """{flat path "a/b/c": host tensor} of an Orbax directory (a ``scalar``
    leaf as a Python number), the leaves for which ``keep(path tuple)`` is
    true (default: all). Every chunk of every array is read in one batch
    on the decoder's pool of host threads (``data/zstd_host.py``). A chunk
    that is not stored reads as the fill value where the writer skipped such
    chunks (``store_array_data_equal_to_fill_value`` false, or absent as in
    older writes), and raises otherwise, as the JAX package's restore
    does."""
    path = os.path.abspath(path)
    meta = _metadata(path)
    leaves = leaf_paths(path, meta)
    sparse = not meta.get("store_array_data_equal_to_fill_value", False)
    files = _Files(path)
    try:
        kv = read_kv(path, files)
        arrays, kinds = {}, {}
        for keys, vm in leaves.items():
            vtype = vm.get("value_type")
            if vm.get("skip_deserialize") or vtype in ("None", "Tuple", "Dict", "List"):
                continue  # an empty node (optax's EmptyState, a masked leaf)
            if vtype not in ("jax.Array", "np.ndarray", "scalar"):
                raise OrbaxError(f"{path}: leaf {keys} of type {vtype!r} is not read")
            if keep is not None and not keep(keys):
                continue
            name = ".".join(keys)
            zarray = kv.get(f"{name}/.zarray".encode())
            if zarray is None:
                raise OrbaxError(f"{path}: leaf {keys} has no {name}/.zarray")
            if isinstance(zarray, tuple):
                zarray = bytes(files.read(zarray))
            arrays[keys] = _Array(name, json.loads(zarray))
            kinds[keys] = vtype
        records, outs, places = [], [], []
        for keys, arr in arrays.items():
            for idx, key in arr.chunk_keys():
                value = kv.get(key)
                if value is None:
                    if not sparse:
                        raise OrbaxError(f"{path}: chunk {key.decode()} is missing")
                    arr.fill_chunk(idx)
                    continue
                if isinstance(value, tuple):
                    rel, offset, length = value
                    buf = files.get(rel)
                    if offset + length > len(buf):
                        raise OrbaxError(f"{rel}: bytes {offset}:{offset + length} past its end")
                else:
                    buf, offset, length = value, 0, len(value)
                if arr.whole():
                    dst = arr.dest.reshape(-1).view(np.uint8)
                    places.append(None)
                else:
                    dst = np.empty(arr.chunk_bytes(), np.uint8)
                    places.append((arr, idx, dst))
                if arr.zstd:
                    records.append((buf, offset, length))
                    outs.append(dst)
                else:
                    if length != dst.nbytes:
                        raise OrbaxError(f"{key.decode()}: {length} bytes, expected {dst.nbytes}")
                    dst[:] = np.frombuffer(buf, np.uint8, length, offset)
        if records:
            zstd_host.decompress_batch(records, outs)
        for place in places:
            if place is not None:
                arr, idx, dst = place
                arr.place(idx, dst)
        tree = {}
        for keys, arr in arrays.items():
            t = arr.tensor()
            tree["/".join(keys)] = t.item() if kinds[keys] == "scalar" else t
        return tree
    finally:
        files.close()


def zstd_records(path: str) -> List[bytes]:
    """Every stored value of an Orbax directory's latest version that is a
    Zstandard frame (the compressed zarr chunks)."""
    files = _Files(os.path.abspath(path))
    try:
        frames: List[bytes] = []
        kv = read_kv(files.root, files)
        for value in kv.values():
            raw = bytes(files.read(value)) if isinstance(value, tuple) else value
            if raw[:4] == b"\x28\xb5\x2f\xfd":
                frames.append(raw)
        return frames
    finally:
        files.close()


# ---------------------------------------------------------------- optax state


def opt_state_dict(tree: dict) -> dict:
    """The port optimizer's ``state_dict()`` from the optax state of a JAX
    ``checkpoint_{e}`` (``read_tree``'s flat paths under ``opt_state/``):
    the chain of ``unimp_tpu/train/optimizer.py:make_optimizer`` (clip,
    adam, masked decay, schedule), inside ``optax.MultiSteps``
    (``inner_opt_state``, ``acc_grads``, ``mini_step``, ``gradient_step``)
    where the run accumulated that way. Moments keep their stored dtype
    (bfloat16 under ``--bf16_opt_state``) and are named as the port's
    parameters ("a.b.c"); masked (frozen) leaves hold none."""
    sub = {k[len("opt_state/"):]: v for k, v in tree.items() if k.startswith("opt_state/")}
    multi = any(k.startswith("inner_opt_state/") for k in sub)
    inner = "inner_opt_state/" if multi else ""

    def moments(prefix):
        return {k[len(prefix):].replace("/", "."): v for k, v in sub.items()
                if k.startswith(prefix)}

    counts = {k: sub.get(f"{inner}{i}/count") for k, i in (("count", 1), ("schedule_count", 3))}
    if any(v is None for v in counts.values()):
        raise OrbaxError("the optimizer state is not make_optimizer's chain: "
                         f"{sorted(sub)[:8]} ...")
    state = {"mu": moments(f"{inner}1/mu/"), "nu": moments(f"{inner}1/nu/"),
             **{k: int(v) for k, v in counts.items()}}
    if multi:
        state.update(acc=moments("acc_grads/"), mini_step=int(sub["mini_step"]),
                     gradient_step=int(sub["gradient_step"]))
    return state
