"""Weight-streaming int8 matmul: the plain version, the dispatch, and
``quant_dot``.

Counterpart of ``unimp_tpu/ops/quant_matmul.py``. ``quant_matmul``
computes x @ (q * scale) with the f32 sum taken over x @ q and the
per-output-channel scale applied once after it; a CUDA tensor goes to the
kernel (``quant_matmul_cuda``, K6 in ``csrc/quant_matmul.cu``), a CPU
tensor to ``quant_matmul_ref``. ``QuantMatmulFn`` gives it the JAX
custom VJP's backward (the int8 frozen backbone under autograd).
``quant_dot`` is the call site the model uses for every matmul weight.
"""

from __future__ import annotations

import functools
import os

import torch

from unimp_tpu_torch.ops import kernel_lib
from unimp_tpu_torch.utils.quant import QuantizedKernel


def quant_matmul_ref(x, q, scale):
    """Plain K6: x [..., K] @ q [K, N] int8 with an f32 sum, times scale
    [N] (f32), rounded to x.dtype. int8 -> x.dtype is exact and a
    bf16 * int8 product is exact in f32, so the kernel differs from this
    only in the order of the sum."""
    acc = x.float() @ q.float()
    return (acc * scale.float()).to(x.dtype)


# K6's bf16 tiling (csrc/quant_matmul.cu) on an H100 SXM's 132 SMs
SMS = 132
K6_BN, K6_BK = 128, 64
K6_MAX_SPLITS = 8
K6_MIN_SPLIT_TILES = 4  # k tiles per split: enough to fill the 4-stage ring


def k6_block_rows(m: int) -> int:
    """Rows of one K6 bf16 block: 64 for the bytes-bound small M, else 256
    (the 240 decode rows in one block)."""
    return 64 if m <= 64 else 256


@functools.lru_cache(maxsize=256)
def split_k_plan(m: int, k: int, n: int) -> tuple[int, int]:
    """(splits, k_chunk) of K6's bf16 branch for x [m, k] @ q [k, n].

    Split z sums k in [z * k_chunk, min(k, (z + 1) * k_chunk)); k_chunk is
    a whole number of 64-deep k tiles and no split is empty. K is split
    only where the output tiles leave SMs idle, up to 8 ways and no
    thinner than 4 k tiles a split: 20 tiles (o, down at 240 rows) take 6
    splits, 60 (fused QKV) 2, 80 and more 1."""
    k_tiles = max(1, -(-k // K6_BK))
    blocks = -(-n // K6_BN) * -(-m // k6_block_rows(m))
    splits = max(1, min(K6_MAX_SPLITS, SMS // max(blocks, 1), k_tiles // K6_MIN_SPLIT_TILES))
    chunk_tiles = -(-k_tiles // splits)
    return -(-k_tiles // chunk_tiles), chunk_tiles * K6_BK


def split_k_scratch(m: int, k: int, n: int, device):
    """(splits, k_chunk, part) for K6's bf16 branch: the plan of
    ``split_k_plan`` and the f32 partial sums [splits, m, n] that the
    kernel fills and its second pass adds (None for one split)."""
    splits, k_chunk = split_k_plan(m, k, n)
    part = (torch.empty(splits, m, n, dtype=torch.float32, device=device)
            if splits > 1 else None)
    return splits, k_chunk, part


def quant_matmul_cuda(x, q, scale):
    """Launch K6; returns [..., N] in x.dtype.

    x [..., K] float32 or bfloat16; q [K, N]
    int8 whose rows may be strided (N contiguous); scale [N] float32.
    bfloat16 splits K by ``split_k_plan`` through the f32 scratch buffer
    of ``split_k_scratch``, allocated here."""
    if x.dtype not in kernel_lib.DTYPE_CODES:
        raise TypeError(f"quant_matmul takes float32 or bfloat16 x, got {x.dtype}")
    *lead, k = x.shape
    x2 = x.reshape(-1, k)
    kernel_lib.check_cuda_tensor("x", x2, x.dtype, 2)
    if not q.is_cuda or q.dtype != torch.int8 or q.dim() != 2 or q.stride(1) != 1:
        raise ValueError(f"q must be a 2-D int8 CUDA tensor with contiguous rows, got "
                         f"{q.dtype} {tuple(q.shape)} on {q.device}")
    if q.shape[0] != k:
        raise ValueError(f"x {tuple(x.shape)} does not contract with q {tuple(q.shape)}")
    n = q.shape[1]
    kernel_lib.check_cuda_tensor("scale", scale, torch.float32, 1)
    if scale.shape[0] != n:
        raise ValueError(f"scale {tuple(scale.shape)} does not fit q {tuple(q.shape)}")
    m = x2.shape[0]
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    if m:
        # float32 runs on the CUDA cores without split-K
        splits, k_chunk, part = (split_k_scratch(m, k, n, x.device)
                                 if x.dtype == torch.bfloat16 else (1, k, None))
        P = kernel_lib.ptr
        kernel_lib.launch("quant_matmul", "quant_matmul", kernel_lib.DTYPE_CODES[x.dtype],
                          P(x2), P(q), P(scale), P(out), P(part), m, k, n, q.stride(0),
                          splits, k_chunk)
    return out.reshape(*lead, n)


def quant_matmul(x, q, scale):
    """x @ (q * scale) streaming the int8 weight: the CUDA kernel on the
    card, the plain version on the CPU."""
    if x.device.type == "cpu":
        return quant_matmul_ref(x, q, scale)
    return quant_matmul_cuda(x, q, scale)


class QuantMatmulFn(torch.autograd.Function):
    """``quant_matmul`` under autograd, as the JAX custom VJP defines it
    (``unimp_tpu/ops/quant_matmul.py:134-145``): the forward is K6 on a
    CUDA tensor and ``quant_matmul_ref`` on a CPU one; the backward is
    dx = (g * scale in g's dtype) @ q^T summed in float32 and rounded to
    g's dtype, a plain matmul (JAX computes it in XLA, outside the Pallas
    kernel). q and scale are constants of the frozen weight: no gradient.
    Nothing is saved but the weight, so a recompute under activation
    checkpointing launches K6 again and saves nothing new."""

    @staticmethod
    def forward(ctx, x, q, scale):
        ctx.save_for_backward(q, scale)
        return quant_matmul(x, q, scale)

    @staticmethod
    def backward(ctx, g):
        q, scale = ctx.saved_tensors
        gs = g * scale.to(g.dtype)
        return (gs.float() @ q.float().t()).to(g.dtype), None, None


def default_max_rows() -> int:
    """The row count up to which an int8 matmul streams through K6:
    ``UNIMP_QMM_MAX_ROWS``, 512 where it is unset, as the JAX package reads
    it (``unimp_tpu/ops/quant_matmul.py:88-89``)."""
    return int(os.environ.get("UNIMP_QMM_MAX_ROWS", "512"))


def quant_dot(x, kernel, *, max_rows: int = None):
    """x [..., in] @ kernel, contracting x's last dim with the kernel's
    leading axes (Dense [in, N], Proj [in, H, d], o_proj [H, d, out] with
    x flattened to H*d); returns [..., N].

    A ``QuantizedKernel`` at <= ``max_rows`` rows (a decode step, a
    prefill head) goes to ``QuantMatmulFn``: the f32 sum of x @ q, then
    the scale, with the JAX custom VJP's gradient for x. More rows take
    the dequantized matmul x @ (q * scale in x.dtype), whose autograd
    reaches x only, as the JAX package does (``unimp_tpu/ops/
    quant_matmul.py:75-96``). The threshold decides which arithmetic runs,
    so it is the JAX package's: ``max_rows``, else ``default_max_rows()``
    (``UNIMP_QMM_MAX_ROWS``, 512 unset); a float kernel is a plain
    matmul."""
    if max_rows is None:
        max_rows = default_max_rows()
    in_dim = x.shape[-1]
    if isinstance(kernel, QuantizedKernel):
        q, scale = kernel.flat(in_dim)
        if x.numel() // in_dim <= max_rows:
            return QuantMatmulFn.apply(x, q, scale)
        return x @ (q.to(x.dtype) * scale.to(x.dtype))
    return x @ kernel.reshape(in_dim, -1).to(x.dtype)
