"""The port's CUDA kernels against their plain versions.

Imports no JAX, so the card's machine (which has none) runs it without
the suite's conftest:

    python -m pytest tests/test_torch_kernels.py -m gpu -q --noconftest

On the CPU the card test skips; the wrapper tests check that a kernel
wrapper given a CPU tensor raises instead of falling back.
"""

import numpy as np
import pytest
import torch

from unimp_tpu_torch.ops import AttnMask
from unimp_tpu_torch.ops.attention_ref import attention_ref
from unimp_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_ref,
    single_query_attention,
    single_query_attention_ref,
)
from unimp_tpu_torch.ops.decode_attention_kernels import (
    decode_attention_cuda,
    single_query_attention_cuda,
)
from unimp_tpu_torch.ops.flash_attention import flash_attention, flash_attention_cuda

torch.set_num_threads(2)  # six test workers share the cores
# float32 kernel vs plain: the sums run in another order
TOL = dict(atol=1e-4, rtol=1e-4)


def _randn(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_on_card(cuda_device):
    """K1, K4 and K5 on the card against their plain versions (f32)."""
    dev = cuda_device
    rng = np.random.default_rng(0)
    q, k, v = (_randn(rng, *s).to(dev) for s in ((2, 40, 4, 80), (2, 40, 2, 80), (2, 40, 2, 80)))
    kv_start = torch.tensor([0, 5], device=dev)
    got, lse = flash_attention(q, k, v, causal=True, kv_start=kv_start)
    want, want_lse = attention_ref(q, k, v, AttnMask(causal=True), kv_start=kv_start)
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(lse, want_lse, **TOL)

    b, kb, t, g, h, d = 2, 3, 16, 50, 4, 64
    q = _randn(rng, b * kb, h, d).to(dev)
    pk, pv = (_randn(rng, b, h, t, d).to(dev) for _ in range(2))
    gk, gv = (_randn(rng, b * kb, h, g, d).to(dev) for _ in range(2))
    sel = torch.from_numpy(rng.integers(0, kb, size=(b * kb, g)).astype(np.int32)).to(dev)
    kv_start = torch.tensor([0, 3], device=dev)
    for step in (1, 17, 50):
        got = decode_attention(q, pk, pv, gk, gv, step=step, kv_start=kv_start, beam_sel=sel)
        want = decode_attention_ref(q, pk, pv, gk, gv, step=step, kv_start=kv_start,
                                    beam_sel=sel)
        torch.testing.assert_close(got, want, **TOL)
    mask = torch.from_numpy(rng.random((b, t)) < 0.6).to(dev)
    mask[0] = False  # a row with nothing allowed gives 0
    got = single_query_attention(q, pk, pv, mask)
    torch.testing.assert_close(got, single_query_attention_ref(q, pk, pv, mask), **TOL)
    assert torch.equal(got[:kb], torch.zeros_like(got[:kb]))


def test_kernel_wrappers_reject_cpu_tensors():
    """A kernel wrapper never computes on the CPU: it raises."""
    rng = np.random.default_rng(1)
    q = _randn(rng, 1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    qd, kv = _randn(rng, 2, 2, 64), _randn(rng, 1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(qd, kv, kv, _randn(rng, 2, 2, 4, 64), _randn(rng, 2, 2, 4, 64),
                              step=1)
    with pytest.raises(ValueError, match="CUDA"):
        single_query_attention_cuda(qd, kv, kv, torch.ones(1, 8, dtype=torch.bool))
