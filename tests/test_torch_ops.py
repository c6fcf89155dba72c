"""The port's attention ops against the JAX package, on the CPU.

The plain versions of the CUDA kernels (``attention_ref`` for the flash
forward, ``decode_attention_ref`` / ``single_query_attention_ref`` for the
decode kernels) must match the JAX XLA reference and the Pallas kernels
(interpret mode) on the same numpy inputs, in float32, at the tolerance
of the JAX suite's own kernel tests (atol = rtol = 2e-5). The kernels
themselves run only on the card: ``tests/test_torch_kernels.py``.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimp_tpu.ops.attention_ref import AttnMask as JAttnMask
from unimp_tpu.ops.attention_ref import alibi_slopes as j_alibi_slopes
from unimp_tpu.ops.attention_ref import attention_xla
from unimp_tpu.ops.decode_attention import decode_attention as j_decode_attention
from unimp_tpu.ops.decode_attention import single_query_attention as j_single_query
from unimp_tpu.ops.flash_attention import flash_attention as j_flash_attention
from unimp_tpu_torch.ops import AttnMask, alibi_slopes, multi_head_attention
from unimp_tpu_torch.ops.attention_ref import NEG_INF, attention_ref
from unimp_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_ref,
    single_query_attention,
    single_query_attention_ref,
)
from unimp_tpu_torch.ops.flash_attention import flash_attention

torch.set_num_threads(2)  # six test workers share the cores
# float32 plain path vs JAX: the two sum in different orders. Measured on
# the flash cases (the alibi case at d128 is the widest): at most 1.4% of
# this bar, and bit for bit the same output with 1 to 8 torch threads, XLA
# with and without its multi-threaded Eigen, one pinned core, and six
# processes at once; so the thread count's summation order does not reach it.
TOL = dict(atol=2e-5, rtol=2e-5)
REPO = pathlib.Path(__file__).resolve().parent.parent


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_close(actual, desired, what):
    """``assert_allclose`` at ``TOL`` whose message gives the worst
    element's |error| / (atol + rtol * |desired|): 1.0 is the bar."""
    desired = np.asarray(desired)
    err = np.abs(actual.astype(np.float64) - desired)
    ratio = err / (TOL["atol"] + TOL["rtol"] * np.abs(desired))
    worst = np.unravel_index(int(np.argmax(ratio)), ratio.shape) if ratio.size else ()
    np.testing.assert_allclose(actual, desired, **TOL, err_msg=(
        f"{what}: max |error| {err.max() if err.size else 0.0:.3e}, worst error / bar "
        f"{ratio.max() if ratio.size else 0.0:.4f} at {worst}; torch threads "
        f"{torch.get_num_threads()}"))


def _lse_numpy(q, k, v, allowed, scale, alibi=None):
    """Definition of the logsumexp output: [B, H, Sq] f64."""
    h = q.shape[2]
    rep = h // k.shape[2]
    k = np.repeat(k, rep, axis=2).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k) * scale
    if alibi is not None:
        rel = np.arange(k.shape[1])[None, :] - np.arange(q.shape[1])[:, None]
        s = s + alibi[None, :, None, None] * rel
    s = np.where(allowed[:, None], s, -np.inf)
    m = s.max(-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        lse = m + np.log(np.exp(s - np.where(np.isfinite(m), m, 0)[..., None]).sum(-1))
    return np.where(np.isfinite(m), lse, NEG_INF)


def _case(seed, b, sq, skv, h, hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    return q, k, v


FLASH_CASES = {
    # name: (b, sq, skv, h, hkv, d); masks come from _flash_kwargs
    "bidirectional": (2, 33, 33, 2, 2, 64),
    "causal": (2, 40, 40, 2, 2, 80),
    "causal_window": (2, 40, 40, 2, 2, 80),
    "immediate": (2, 24, 32, 2, 2, 80),
    "all_previous": (2, 24, 32, 2, 2, 64),
    "alibi": (2, 36, 36, 4, 4, 128),
    "gqa": (2, 24, 24, 4, 2, 64),
}


def _flash_kwargs(name, b, sq, skv, rng):
    kw = {}
    if name in ("causal", "causal_window", "alibi", "gqa"):
        kw["causal"] = True
    if name == "causal_window":
        kw["kv_start"] = np.array([0, 7], np.int32)
        kw["kv_len"] = np.array([skv, skv - 5], np.int32)
    if name in ("immediate", "all_previous"):
        # text before the first media (q_media 0) -> fully masked rows
        # under "immediate"; media 1..4 over 8-latent groups
        qm = np.sort(rng.integers(0, 5, size=(b, sq)), axis=1).astype(np.int32)
        qm[:, :3] = 0
        kw["q_media"] = qm
        kw["kv_media"] = np.repeat(np.arange(1, 5, dtype=np.int32), skv // 4)[None].repeat(b, 0)
        kw["media_mode"] = name
    return kw


def _allowed_numpy(kw, b, sq, skv):
    allowed = np.ones((b, sq, skv), bool)
    ki, qi = np.arange(skv)[None, None, :], np.arange(sq)[None, :, None]
    if kw.get("causal"):
        allowed &= ki <= qi
    if "kv_len" in kw:
        allowed &= ki < kw["kv_len"][:, None, None]
        allowed &= ki >= kw["kv_start"][:, None, None]
    if "media_mode" in kw:
        qm, km = kw["q_media"][:, :, None], kw["kv_media"][:, None, :]
        allowed &= (qm == km) if kw["media_mode"] == "immediate" else ((km <= qm) & (km > 0))
    return allowed


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_plain_matches_jax(name):
    """Plain K1 (the CPU path of ``flash_attention``) == JAX attention_xla
    and the Pallas kernel in interpret mode; lse == its definition."""
    b, sq, skv, h, hkv, d = FLASH_CASES[name]
    q, k, v = _case(sorted(FLASH_CASES).index(name), b, sq, skv, h, hkv, d)
    kw = _flash_kwargs(name, b, sq, skv, np.random.default_rng(1))
    alibi = np.asarray(j_alibi_slopes(h)) if name == "alibi" else None
    tkw = {key: _t(val) if isinstance(val, np.ndarray) else val for key, val in kw.items()}
    out, lse = flash_attention(_t(q), _t(k), _t(v), **tkw,
                               alibi_slopes=None if alibi is None else _t(alibi))
    jkw = {key: jnp.asarray(val) if isinstance(val, np.ndarray) else val
           for key, val in kw.items()}
    want_pallas = j_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw,
                                    alibi_slopes=None if alibi is None else jnp.asarray(alibi),
                                    interpret=True)
    _assert_close(out.numpy(), np.asarray(want_pallas), "out vs Pallas (interpret)")

    kv_valid = None
    if "kv_len" in kw:
        pos = np.arange(skv)[None]
        kv_valid = jnp.asarray((pos < kw["kv_len"][:, None]) & (pos >= kw["kv_start"][:, None]))
    jmask = JAttnMask(causal=kw.get("causal", False), q_media=jkw.get("q_media"),
                      kv_media=jkw.get("kv_media"), media_mode=kw.get("media_mode"),
                      kv_valid=kv_valid)
    want_xla = attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask,
                             alibi=None if alibi is None else jnp.asarray(alibi))
    _assert_close(out.numpy(), np.asarray(want_xla), "out vs attention_xla")
    allowed = _allowed_numpy(kw, b, sq, skv)
    want_lse = _lse_numpy(q, k, v, allowed, 1.0 / d**0.5, alibi)
    _assert_close(lse.numpy(), want_lse, "lse vs its float64 definition")


def test_flash_plain_fully_masked_rows_are_zero():
    """Rows with nothing to attend give out 0 and lse -1e30, no NaN."""
    q, k, v = _case(5, 2, 8, 8, 2, 2, 80)
    out, lse = attention_ref(_t(q), _t(k), _t(v), AttnMask(
        q_media=torch.zeros(2, 8, dtype=torch.int32),
        kv_media=torch.ones(2, 8, dtype=torch.int32), media_mode="immediate"))
    assert torch.equal(out, torch.zeros_like(out))
    assert torch.all(lse == NEG_INF)


def test_multi_head_attention_cpu_is_plain():
    q, k, v = _case(6, 2, 16, 16, 2, 2, 64)
    kv_start = torch.tensor([0, 4])
    got = multi_head_attention(_t(q), _t(k), _t(v), AttnMask(causal=True),
                               kv_start=kv_start)
    want = attention_ref(_t(q), _t(k), _t(v), AttnMask(causal=True), kv_start=kv_start)[0]
    assert torch.equal(got, want)


def test_alibi_slopes_match_jax():
    for n in (4, 12, 16, 32):
        np.testing.assert_allclose(alibi_slopes(n).numpy(), np.asarray(j_alibi_slopes(n)))


def _decode_case(seed, b, kb, t, g, h, hkv, d):
    rng = np.random.default_rng(seed)
    bk = b * kb
    return dict(
        q=rng.normal(size=(bk, h, d)).astype(np.float32),
        pk=rng.normal(size=(b, hkv, t, d)).astype(np.float32),
        pv=rng.normal(size=(b, hkv, t, d)).astype(np.float32),
        gk=rng.normal(size=(bk, hkv, g, d)).astype(np.float32),
        gv=rng.normal(size=(bk, hkv, g, d)).astype(np.float32),
        kv_start=rng.integers(0, t // 2, size=b).astype(np.int32),
        sel=rng.integers(0, kb, size=(bk, g)).astype(np.int32),
    )


# bfloat16 plain K4 / K5 vs JAX: both take the logits in f32 from the same
# bf16 inputs, but p rounds to bf16 under each segment's own max here and
# under the running max of each chunk in the Pallas kernel (a relative 2^-9
# apart per weight), and the output rounds to bf16 after sums taken in
# another order, which can flip its last bit (2^-8 relative, 7.8e-3 at the
# outputs' size of 1-2). 2e-2 holds both with margin, and is the bar the
# card holds the CUDA kernels to against these plain versions. JAX's XLA
# path cannot run there in bf16: the CPU backend has no bf16 x bf16 -> f32
# batched dot (DotThunk), so bf16 is held to the Pallas kernel (interpret),
# the TPU kernel the CUDA one replaces.
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
F32_IMPLS, BF16_IMPLS = ("xla", "pallas"), ("pallas",)


def _shared_ancestry(sel, kb, n, seed):
    """beam_sel whose beams of a row share one ancestor for their first n
    positions, as a real beam search's beams share their early history."""
    rng = np.random.default_rng(seed)
    sel = sel.copy()
    sel[:, :n] = np.repeat(rng.integers(0, kb, size=(sel.shape[0] // kb, 1)), kb, axis=0)
    return sel


def _as(x, dtype):
    """numpy f32 -> (torch, jax) arrays of ``dtype`` holding the same values."""
    t = torch.from_numpy(np.array(x))
    if dtype == "bf16":
        t = t.to(torch.bfloat16)
        return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return t, jnp.asarray(x)


@pytest.mark.parametrize("step", [1, 13, 50])
@pytest.mark.parametrize("mode", ["beam", "beam_alibi", "greedy", "gqa", "beam_d80",
                                  "bf16_shared_d80", "bf16_gqa_alibi_d80"])
def test_decode_plain_matches_jax(step, mode):
    """Plain K4 == JAX decode_attention, XLA and Pallas (interpret), at TOL
    in float32; bfloat16 (the dtype of the card's tensor-core kernel; beams
    sharing their first 20 ancestors) against Pallas at BF16_TOL."""
    b, kb, t, g, h, d = 2, 3, 16, 50, 4, 16
    hkv = 2 if "gqa" in mode else h
    if mode == "greedy":
        kb = 1
    if mode.endswith("d80"):
        d = 80
    dtype = "bf16" if mode.startswith("bf16") else "f32"
    c = _decode_case(step, b, kb, t, g, h, hkv, d)
    sel = c["sel"] if kb > 1 else None
    if mode == "bf16_shared_d80":
        sel = _shared_ancestry(sel, kb, 20, step)
    slopes = np.linspace(0.1, 1.0, h).astype(np.float32) if "alibi" in mode else None
    (tq, jq), (tpk, jpk), (tpv, jpv), (tgk, jgk), (tgv, jgv) = (
        _as(c[n], dtype) for n in ("q", "pk", "pv", "gk", "gv"))
    got = decode_attention(
        tq, tpk, tpv, tgk, tgv, step=step,
        kv_start=_t(c["kv_start"]), alibi=None if slopes is None else _t(slopes),
        beam_sel=None if sel is None else _t(sel))
    jkw = dict(step=jnp.int32(step), kv_start=jnp.asarray(c["kv_start"]),
               alibi=None if slopes is None else jnp.asarray(slopes),
               beam_sel=None if sel is None else jnp.asarray(sel))
    for impl in BF16_IMPLS if dtype == "bf16" else F32_IMPLS:
        extra = {"gen_chunk": 0} if impl == "xla" else {}
        want = j_decode_attention(jq, jpk, jpv, jgk, jgv, **jkw, impl=impl, **extra)
        assert got.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   **(BF16_TOL if dtype == "bf16" else TOL))


def test_decode_plain_prompt_len():
    c = _decode_case(0, 1, 2, 8, 24, 2, 2, 8)
    plen = np.array([6], np.int32)
    for s in (1, 9, 24):
        got = decode_attention_ref(
            _t(c["q"]), _t(c["pk"]), _t(c["pv"]), _t(c["gk"]), _t(c["gv"]), step=s,
            prompt_len=_t(plen), beam_sel=_t(c["sel"]))
        want = j_decode_attention(
            *[jnp.asarray(c[n]) for n in ("q", "pk", "pv", "gk", "gv")],
            step=jnp.int32(s), prompt_len=jnp.asarray(plen),
            beam_sel=jnp.asarray(c["sel"]), gen_chunk=0, impl="xla")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kb,gqa,d,dtype", [
    pytest.param(1, False, 16, "f32", id="1-False-16"),
    pytest.param(3, False, 80, "f32", id="3-False-80"),
    pytest.param(3, True, 16, "f32", id="3-True-16"),
    pytest.param(10, False, 80, "bf16", id="10-False-80-bf16"),
    pytest.param(3, True, 80, "bf16", id="3-True-80-bf16"),
])
def test_single_query_plain_matches_jax(kb, gqa, d, dtype):
    """Plain K5 == JAX single_query_attention, XLA and Pallas (interpret),
    including a row with no allowed latents (gives 0): float32 at TOL,
    bfloat16 against Pallas at BF16_TOL."""
    b, s, h = 3, 24, 4
    hkv = 2 if gqa else h
    rng = np.random.default_rng(kb + 10 * gqa + d)
    q = rng.normal(size=(b * kb, h, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    mask = rng.random((b, s)) < 0.7
    mask[0] = False
    (tq, jq), (tk, jk), (tv, jv) = (_as(x, dtype) for x in (q, k, v))
    got = single_query_attention(tq, tk, tv, _t(mask))
    assert torch.equal(got[:kb], torch.zeros_like(got[:kb]))
    for impl in BF16_IMPLS if dtype == "bf16" else F32_IMPLS:
        want = j_single_query(jq, jk, jv, jnp.asarray(mask), impl=impl)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   **(BF16_TOL if dtype == "bf16" else TOL))
    assert torch.equal(single_query_attention_ref(tq, tk, tv, _t(mask)), got)


def _port_python_files():
    files = sorted((REPO / "unimp_tpu_torch").rglob("*.py"))
    # the ranks of the multi-GPU tests run on the card's machine too
    return files + [REPO / "chip_smoke.py", REPO / "tests" / "torch_parallel_worker.py"]


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax, flax,
    optax, orbax or the JAX package, nor ``tokenizers``, PIL or
    ``requests``, which the card's machine lacks; the training CLI's,
    the serving and the multi-GPU modules (and the multi-GPU tests' rank
    worker) are among those walked."""
    banned = ("jax", "flax", "optax", "orbax", "unimp_tpu", "tokenizers", "PIL", "requests")
    bad = []
    for path in _port_python_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for n in names:
                if n.split(".")[0] in banned:
                    bad.append(f"{path.relative_to(REPO)}: {n}")
    walked = {str(p.relative_to(REPO)) for p in _port_python_files()}
    assert len(walked) > 10
    assert {f"unimp_tpu_torch/{m}.py" for m in (
        "cli/mmrec", "train/checkpoint", "train/vision_cache", "utils/profiling",
        "decode/streaming", "serve/constants", "serve/conversation", "serve/batching",
        "serve/worker", "serve/controller", "serve/cli_chat", "serve/register_worker",
        "serve/test_message", "serve/web_server", "parallel/mesh", "parallel/sharding",
        "parallel/seq_shard", "ops/ring_attention", "evals/dist")} | {
        "tests/torch_parallel_worker.py"} <= walked
    assert not bad, bad
