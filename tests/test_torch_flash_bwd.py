"""The port's flash-attention gradient against the JAX package, on the CPU.

The same seeded numpy inputs go through ``jax.grad`` of the JAX
``flash_attention`` (the Pallas backward kernels K2 / K3 in interpret
mode), ``jax.grad`` of ``attention_xla``, the port's ``FlashAttentionFn``
on CPU tensors (its plain backward), and the two plain functions
``flash_bwd_dkv_ref`` / ``flash_bwd_dq_ref`` called directly; float32, at
the JAX suite's gradient tolerance (atol = rtol = 3e-4), and the plain
functions again in bfloat16 against ``jax.vjp`` of the interpret-mode
kernels (``BF16_TOL``). The CUDA kernels themselves run only on the card:
``tests/test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from unimp_tpu.ops.attention_ref import AttnMask as JAttnMask
from unimp_tpu.ops.attention_ref import alibi_slopes as j_alibi_slopes
from unimp_tpu.ops.attention_ref import attention_xla
from unimp_tpu.ops.flash_attention import flash_attention as j_flash_attention
from unimp_tpu_torch.ops import AttnMask, multi_head_attention
from unimp_tpu_torch.ops.attention_ref import attention_ref, flash_bwd_dkv_ref, flash_bwd_dq_ref
from unimp_tpu_torch.ops.flash_attention import flash_attention

torch.set_num_threads(2)  # six test workers share the cores
TOL = dict(atol=3e-4, rtol=3e-4)

CASES = {
    # name: (b, sq, skv, h, hkv, d); masks from _kwargs
    "bidirectional": (2, 33, 40, 2, 2, 64),
    "causal": (2, 40, 40, 2, 2, 80),
    "kv_len_window": (2, 40, 40, 2, 2, 80),
    "kv_start_window": (2, 24, 48, 2, 2, 64),
    "immediate_masked_rows": (2, 24, 32, 2, 2, 80),
    "all_previous": (2, 24, 32, 2, 2, 64),
    "alibi": (1, 36, 36, 4, 4, 128),
    "gqa": (2, 24, 24, 4, 2, 64),
}


def _kwargs(name, b, sq, skv, rng):
    kw = {}
    if name in ("causal", "kv_len_window", "alibi", "gqa"):
        kw["causal"] = True
    if name == "kv_len_window":
        kw["kv_len"] = np.array([skv, skv - 9], np.int32)
    if name == "kv_start_window":
        kw["kv_start"] = np.array([0, 11], np.int32)
        kw["kv_len"] = np.array([skv - 3, skv], np.int32)
    if name in ("immediate_masked_rows", "all_previous"):
        # text before the first media has q_media 0: fully masked rows under
        # "immediate" (and under "all_previous" too)
        qm = np.sort(rng.integers(0, 5, size=(b, sq)), axis=1).astype(np.int32)
        qm[:, :4] = 0
        kw["q_media"] = qm
        kw["kv_media"] = np.repeat(np.arange(1, 5, dtype=np.int32), skv // 4)[None].repeat(b, 0)
        kw["media_mode"] = name.split("_masked")[0]
    return kw


def _inputs(name):
    b, sq, skv, h, hkv, d = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    kw = _kwargs(name, b, sq, skv, rng)
    alibi = np.asarray(j_alibi_slopes(h)) if name == "alibi" else None
    return q, k, v, kw, alibi


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _jax_grads(q, k, v, kw, alibi):
    """(flash interpret-mode grads, attention_xla grads) of sum(o cos o)."""
    jkw = {key: jnp.asarray(val) if isinstance(val, np.ndarray) else val
           for key, val in kw.items()}
    slopes = None if alibi is None else jnp.asarray(alibi)
    skv = k.shape[1]

    def loss_flash(q, k, v):
        o = j_flash_attention(q, k, v, **jkw, alibi_slopes=slopes, interpret=True)
        return jnp.sum(o * jnp.cos(o))

    kv_valid = None
    if "kv_len" in kw:
        pos = np.arange(skv)[None]
        valid = pos < kw["kv_len"][:, None]
        if "kv_start" in kw:
            valid &= pos >= kw["kv_start"][:, None]
        kv_valid = jnp.asarray(valid)
    jmask = JAttnMask(causal=kw.get("causal", False), q_media=jkw.get("q_media"),
                      kv_media=jkw.get("kv_media"), media_mode=kw.get("media_mode"),
                      kv_valid=kv_valid)

    def loss_xla(q, k, v):
        o = attention_xla(q, k, v, jmask, alibi=slopes)
        return jnp.sum(o * jnp.cos(o))

    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (jax.grad(loss_flash, argnums=(0, 1, 2))(*args),
            jax.grad(loss_xla, argnums=(0, 1, 2))(*args))


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_gradients_match_jax(name):
    q, k, v, kw, alibi = _inputs(name)
    tkw = {key: _t(val) if isinstance(val, np.ndarray) else val for key, val in kw.items()}
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out, _ = flash_attention(tq, tk, tv, **tkw, alibi_slopes=_t(alibi))
    dq, dk, dv = torch.autograd.grad((out * torch.cos(out)).sum(), (tq, tk, tv))
    got = [g.numpy() for g in (dq, dk, dv)]
    assert all(np.isfinite(g).all() for g in got)
    g_flash, g_xla = _jax_grads(q, k, v, kw, alibi)
    for want in (g_flash, g_xla):
        for a, b_ in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b_), **TOL)

    # the two plain backward functions called directly on the same residuals
    mask = AttnMask(causal=tkw.get("causal", False), q_media=tkw.get("q_media"),
                    kv_media=tkw.get("kv_media"), media_mode=tkw.get("media_mode"))
    win = dict(kv_len=tkw.get("kv_len"), kv_start=tkw.get("kv_start"), alibi=_t(alibi))
    o, lse = attention_ref(_t(q), _t(k), _t(v), mask, **win)
    do = torch.cos(o) - o * torch.sin(o)
    delta = (do * o).sum(-1).transpose(1, 2)
    dk_ref, dv_ref = flash_bwd_dkv_ref(_t(q), _t(k), _t(v), do, lse, delta, mask, **win)
    dq_ref = flash_bwd_dq_ref(_t(q), _t(k), _t(v), do, lse, delta, mask, **win)
    for a, b_ in zip((dq_ref, dk_ref, dv_ref), g_flash):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), **TOL)


def test_fully_masked_rows_get_zero_gradient():
    """Rows that see nothing (lse = -1e30) give dq = 0 and add nothing to
    dk / dv: the plain versions pick 0 before the exp, so no inf * 0."""
    q, k, v, kw, _ = _inputs("immediate_masked_rows")
    mask = AttnMask(q_media=_t(kw["q_media"]), kv_media=_t(kw["kv_media"]),
                    media_mode="immediate")
    o, lse = attention_ref(_t(q), _t(k), _t(v), mask)
    rows = torch.from_numpy(kw["q_media"] == 0)  # [B, Sq]
    assert torch.all(lse.transpose(1, 2)[rows] < -1e29)
    do = torch.ones_like(o)
    delta = (do * o).sum(-1).transpose(1, 2)
    dq = flash_bwd_dq_ref(_t(q), _t(k), _t(v), do, lse, delta, mask)
    dk, dv = flash_bwd_dkv_ref(_t(q), _t(k), _t(v), do, lse, delta, mask)
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()
    assert torch.equal(dq[rows], torch.zeros_like(dq[rows]))
    # the same rows with a huge upstream gradient change nothing in dk / dv
    do2 = do.clone()
    do2[rows] = 1e6
    delta2 = (do2 * o).sum(-1).transpose(1, 2)
    dk2, dv2 = flash_bwd_dkv_ref(_t(q), _t(k), _t(v), do2, lse, delta2, mask)
    torch.testing.assert_close(dk2, dk)
    torch.testing.assert_close(dv2, dv)


def test_checkpointed_attention_gives_the_same_gradients():
    """torch.utils.checkpoint around multi_head_attention recomputes the
    forward in the backward and gives the same gradients as without it
    (the JAX custom VJP saved its residuals whatever the remat policy)."""
    q, k, v, kw, _ = _inputs("causal")
    kv_start = torch.tensor([0, 5])

    def run(q, k, v):
        return multi_head_attention(q, k, v, AttnMask(causal=True), kv_start=kv_start)

    grads = []
    for use_ckpt in (False, True):
        tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
        out = checkpoint(run, tq, tk, tv, use_reentrant=False) if use_ckpt else run(tq, tk, tv)
        grads.append(torch.autograd.grad((out * torch.cos(out)).sum(), (tq, tk, tv)))
    for a, b_ in zip(*grads):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)


# bf16: the plain K2 / K3 (the oracle the card's bf16 kernels are held to)
# against jax.vjp of the JAX flash_attention in interpret mode, on the same
# bf16 q, k, v and upstream gradient. Both round p to bf16 before p^T dO and
# dS to bf16 before dS^T Q and dS K, and sum in f32; they differ in the
# forward each backward starts from (out, whose bf16 rounding feeds delta,
# and lse, which can flip a bf16 rounding of p or dS by one unit) and in
# the order of the f32 sums. Held to two units in the last bf16 place of
# the largest gradient, max |d| <= 2^-7 * max |JAX| per gradient (the
# worst seen is 1.7e-3 * max |JAX|, under "immediate"; the card holds the
# kernels to this oracle at 2e-2).
BF16_TOL = 2.0**-7


@pytest.mark.parametrize("name", ["kv_len_window", "immediate_masked_rows", "bidirectional"])
def test_bf16_plain_backward_matches_jax(name):
    q, k, v, kw, _ = _inputs(name)
    b, sq, _, h, _, d = CASES[name]
    do = np.random.default_rng(7).normal(size=(b, sq, h, d)).astype(np.float32)
    jkw = {key: jnp.asarray(val) if isinstance(val, np.ndarray) else val
           for key, val in kw.items()}

    def run(q, k, v):
        return j_flash_attention(q, k, v, **jkw, interpret=True)

    bf = lambda x: jnp.asarray(x).astype(jnp.bfloat16)  # noqa: E731
    _, vjp = jax.vjp(run, bf(q), bf(k), bf(v))
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(bf(do))]

    tkw = {key: _t(val) if isinstance(val, np.ndarray) else val for key, val in kw.items()}
    tq, tk, tv, tdo = (_t(x).to(torch.bfloat16) for x in (q, k, v, do))
    mask = AttnMask(causal=tkw.get("causal", False), q_media=tkw.get("q_media"),
                    kv_media=tkw.get("kv_media"), media_mode=tkw.get("media_mode"))
    win = dict(kv_len=tkw.get("kv_len"), kv_start=tkw.get("kv_start"))
    o, lse = attention_ref(tq, tk, tv, mask, **win)
    delta = (tdo.float() * o.float()).sum(-1).transpose(1, 2)
    dk, dv = flash_bwd_dkv_ref(tq, tk, tv, tdo, lse, delta, mask, **win)
    dq = flash_bwd_dq_ref(tq, tk, tv, tdo, lse, delta, mask, **win)
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == torch.bfloat16 and got.shape == w.shape
        err = np.abs(got.float().numpy() - w).max()
        assert err <= BF16_TOL * np.abs(w).max(), err
