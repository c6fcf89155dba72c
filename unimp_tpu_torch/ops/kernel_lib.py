"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``build/lib<name>.so`` (a plain C interface, no PyTorch headers) the first
time a wrapper launches it, and is loaded with ``ctypes``. The library
file name carries a hash of the sources and flags, so an edited source
rebuilds. Host code (``csrc/<name>.cc``) builds the same way with the host
C++ compiler (``build_host``), its hash taking in the compiler's version.
A build writes a file of its own and renames it into place, so processes
that build at once do not race. Nothing here runs at import: the CPU
tests import every module.

``LAUNCHES`` counts kernel launches per kernel; each wrapper adds one
where it launches, and a replayed CUDA graph adds the launches that were
counted while it was captured (``add_launches``; ``decode/sampler.py``).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC", "-pthread"]

# kernel library -> its C functions' argument types (the last is always
# the CUDA stream)
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "flash_fwd": {
        # dtype, d, q, k, v, out, lse, kv_start, kv_len, alibi, q_media,
        # kv_media, B, Sq, Skv, H, Hkv, causal, media_mode, scale, stream
        "flash_fwd": [I, I, P, P, P, P, P, P, P, P, P, P,
                      I, I, I, I, I, I, I, F, P],
    },
    "flash_bwd": {
        # dtype, d, q, k, v, dout, lse, delta, dk, dv, kv_start, kv_len,
        # alibi, q_media, kv_media, B, Sq, Skv, H, Hkv, causal, media_mode,
        # scale, stream
        "flash_bwd_dkv": [I, I, P, P, P, P, P, P, P, P, P, P, P, P, P,
                          I, I, I, I, I, I, I, F, P],
        # dtype, d, q, k, v, dout, lse, delta, dq, kv_start, kv_len, alibi,
        # q_media, kv_media, B, Sq, Skv, H, Hkv, causal, media_mode, scale,
        # stream
        "flash_bwd_dq": [I, I, P, P, P, P, P, P, P, P, P, P, P, P,
                         I, I, I, I, I, I, I, F, P],
    },
    "decode_attn": {
        # dtype, d, q, pk, pv, gk, gv, beam_sel, kv_start, prompt_len,
        # alibi, out, B, K, H, Hkv, T, G, n_gen (device int: step), scale,
        # stream
        "decode_attn": [I, I, P, P, P, P, P, P, P, P, P, P,
                        I, I, I, I, I, I, P, F, P],
        # dtype, d, q, pk, pv, gk, gv, pk_scale, pv_scale, gk_scale,
        # gv_scale, beam_sel, kv_start, prompt_len, alibi, out, B, K, H, Hkv,
        # T, G, n_gen, scale, stream
        "decode_attn_int8": [I, I, P, P, P, P, P, P, P, P, P, P, P, P, P, P,
                             I, I, I, I, I, I, P, F, P],
        # dtype, d, q, k, v, allowed, out, B, K, H, Hkv, S, scale, stream
        "single_query_attn": [I, I, P, P, P, P, P, I, I, I, I, I, F, P],
        # dtype, d, q, k, v, k_scale, v_scale, allowed, out, B, K, H, Hkv, S,
        # scale, stream
        "single_query_attn_int8": [I, I, P, P, P, P, P, P, P, I, I, I, I, I, F, P],
    },
    "quant_matmul": {
        # dtype, x, q, scale, out, part (split-K scratch), M, K, N, ldq,
        # splits, k_chunk, stream
        "quant_matmul": [I, P, P, P, P, P, I, I, I, I, I, I, P],
    },
}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 80, 128)

LAUNCHES = {name: 0 for fns in SIGNATURES.values() for name in fns}

_libs: dict = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def add_launches(counts: dict) -> None:
    """Count ``counts`` ({kernel: launches}) as launched again: a CUDA
    graph's replay runs the launches its capture counted."""
    for name, n in counts.items():
        LAUNCHES[name] += n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}\n{proc.stderr}")
    (BUILD_DIR / f"{name}.ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, out)
    return out


def _host_cxx() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++) found")


def build_host(name: str) -> Path:
    """Compile ``csrc/<name>.cc`` with the host C++ compiler unless its
    library is already built; raises if the compiler fails."""
    cxx = _host_cxx()
    src = CSRC_DIR / f"{name}.cc"
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode() + version.encode() + src.read_bytes())
    out = BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed for {name}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


HOST_LIBS = ("zstd_host",)  # csrc/<name>.cc, built with the host compiler


def build_all() -> dict:
    """Build every kernel library and host library at once (one compiler
    per source, in parallel); returns {name: library path}."""
    with concurrent.futures.ThreadPoolExecutor(len(SIGNATURES) + len(HOST_LIBS)) as ex:
        futures = {name: ex.submit(build, name) for name in SIGNATURES}
        futures.update({name: ex.submit(build_host, name) for name in HOST_LIBS})
        return {name: f.result() for name, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return lib


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def check_cuda_tensor(name: str, t: torch.Tensor, dtype=None, ndim=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given dtype."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def rows_i32(name, t, shape, device):
    """Index tensor -> contiguous int32 on ``device`` (raises elsewhere)."""
    if t is None:
        return None
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the kernel runs on {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    return t.to(torch.int32).contiguous()


def alibi_f32(slopes, h, device):
    """[H] ALiBi slopes -> contiguous f32 on ``device`` (None passes)."""
    if slopes is None:
        return None
    if slopes.device != device or tuple(slopes.shape) != (h,):
        raise ValueError(f"alibi slopes {tuple(slopes.shape)} on {slopes.device}; "
                         f"expected ({h},) on {device}")
    return slopes.to(torch.float32).contiguous()


def launch(kernel: str, lib_name: str, *args) -> None:
    """Call one C entry point on the current stream; raise on a CUDA error."""
    lib = load(lib_name)
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, kernel)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    LAUNCHES[kernel] += 1
