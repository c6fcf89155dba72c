"""The port's CUDA kernels against their plain versions.

Imports no JAX, so the card's machine (which has none) runs it without
the suite's conftest:

    python -m pytest tests/test_torch_kernels.py -m gpu -q --noconftest

On the CPU the card tests skip; the wrapper tests check that a kernel
wrapper given a CPU tensor raises instead of falling back.
"""

import numpy as np
import pytest
import torch

from unimp_tpu_torch.ops import AttnMask
from unimp_tpu_torch.ops.attention_ref import attention_ref, flash_bwd_dkv_ref, flash_bwd_dq_ref
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
from unimp_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_cuda,
    flash_attention_cuda,
    flash_bwd_dkv_cuda,
    flash_bwd_dq_cuda,
)
from unimp_tpu_torch.ops.quant_matmul import (
    K6_BK,
    SMS,
    QuantMatmulFn,
    k6_block_rows,
    quant_matmul_cuda,
    quant_matmul_ref,
    split_k_plan,
    split_k_scratch,
)
from unimp_tpu_torch.ops import kernel_lib
from unimp_tpu_torch.utils.quant import quantize_kv

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


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["causal_gqa_window", "immediate_masked_rows",
                                  "all_previous_d64", "alibi_d128"])
def test_flash_backward_kernels_match_plain_on_card(cuda_device, case):
    """K2 and K3 on the card against flash_bwd_dkv_ref / flash_bwd_dq_ref
    (f32), and FlashAttentionFn's gradient on the card against autograd
    through the plain forward."""
    dev = cuda_device
    rng = np.random.default_rng(2)
    b, sq, skv, h, hkv, d = dict(causal_gqa_window=(2, 40, 40, 4, 2, 80),
                                 immediate_masked_rows=(2, 37, 48, 2, 2, 80),
                                 all_previous_d64=(2, 37, 48, 2, 2, 64),
                                 alibi_d128=(1, 50, 50, 4, 4, 128))[case]
    q, do = (_randn(rng, b, sq, h, d).to(dev) for _ in range(2))
    k, v = (_randn(rng, b, skv, hkv, d).to(dev) for _ in range(2))
    kw, mask = {}, AttnMask()
    if case in ("causal_gqa_window", "alibi_d128"):
        kw["causal"] = True
        mask = AttnMask(causal=True)
    if case == "causal_gqa_window":
        kw.update(kv_start=torch.tensor([0, 5], device=dev), kv_len=torch.tensor([40, 33], device=dev))
    if case == "alibi_d128":
        kw["alibi_slopes"] = torch.linspace(0.05, 0.5, h, device=dev)
    if case in ("immediate_masked_rows", "all_previous_d64"):
        qm = torch.from_numpy(np.sort(rng.integers(0, 4, size=(b, sq)), 1).astype(np.int32))
        qm[:, :5] = 0  # text before the first media: fully masked rows
        km = torch.arange(1, 4, dtype=torch.int32).repeat_interleave(skv // 3)[None].repeat(b, 1)
        mode = "immediate" if case.startswith("immediate") else "all_previous"
        kw.update(q_media=qm.to(dev), kv_media=km.to(dev), media_mode=mode)
        mask = AttnMask(q_media=kw["q_media"], kv_media=kw["kv_media"], media_mode=mode)
    win = dict(kv_len=kw.get("kv_len"), kv_start=kw.get("kv_start"), alibi=kw.get("alibi_slopes"))

    out, lse = flash_attention_cuda(q, k, v, **kw)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    dk, dv = flash_bwd_dkv_cuda(*args, **kw)
    want_dk, want_dv = flash_bwd_dkv_ref(*args, mask, **win)
    torch.testing.assert_close(dk, want_dk, **TOL)
    torch.testing.assert_close(dv, want_dv, **TOL)
    torch.testing.assert_close(flash_bwd_dq_cuda(*args, **kw),
                               flash_bwd_dq_ref(*args, mask, **win), **TOL)

    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(flash_attention(qs, ks, vs, **kw)[0], (qs, ks, vs), do)
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(attention_ref(qs, ks, vs, mask, **win)[0], (qs, ks, vs), do)
    for a, b_ in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b_, **TOL)


def test_kernel_wrappers_reject_cpu_tensors():
    """A kernel wrapper never computes on the CPU: it raises."""
    rng = np.random.default_rng(1)
    q = _randn(rng, 1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    lse = torch.zeros(1, 2, 8)
    for fn in (flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_attention_bwd_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, q, q, q, lse, lse)
    qd, kv = _randn(rng, 2, 2, 64), _randn(rng, 1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(qd, kv, kv, _randn(rng, 2, 2, 4, 64), _randn(rng, 2, 2, 4, 64),
                              step=1)
    with pytest.raises(ValueError, match="CUDA"):
        single_query_attention_cuda(qd, kv, kv, torch.ones(1, 8, dtype=torch.bool))


def _int8(rng, *shape):
    """Random int8 KV rows and their f32 scales, quantized as the model does."""
    return quantize_kv(_randn(rng, *shape))


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,ldq", [(240, 256, 320, 320), (24, 160, 96, 96),
                                       (1, 100, 70, 70), (37, 72, 130, 192),
                                       (4, 2560, 10240, 10240), (256, 1024, 2560, 2560)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_matches_plain_on_card(cuda_device, m, k, n, ldq, dtype):
    """K6 against quant_matmul_ref: decode-like rows, one row, K and N off
    the tiles, a strided int8 weight (a column slice of a wider one), the
    serving engine's 4-row decode (MLP up) and 256-row prefill (the
    cross-attention's latent projection).
    float32 at 1e-4; bf16 at 2e-2 relative to max |plain| (the f32 sums
    differ in order, then both round to bf16)."""
    rng = np.random.default_rng(m + k)
    x = _randn(rng, m, k).to(cuda_device, dtype)
    wide = torch.from_numpy(rng.integers(-127, 128, size=(k, ldq)).astype(np.int8))
    q = wide.to(cuda_device)[:, :n]
    scale = torch.from_numpy(rng.random(n).astype(np.float32) / 64).to(cuda_device)
    got = quant_matmul_cuda(x, q, scale)
    want = quant_matmul_ref(x, q, scale)
    assert got.dtype == dtype and got.shape == (m, n)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2e-2 * want.float().abs().max().item(), err


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(256, 2048, 2048), (180, 8192, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_fn_backward_on_card(cuda_device, m, k, n, dtype):
    """``QuantMatmulFn`` (the int8 frozen backbone under autograd): K6's
    forward, and dx against the gradient through the weight dequantized
    in float32, within 2e-2 of max |plain| (bf16 and float32 alike, as
    chip_smoke holds it); dx keeps x's dtype."""
    rng = np.random.default_rng(m + n)
    x = _randn(rng, m, k).to(cuda_device, dtype).requires_grad_()
    g = _randn(rng, m, n).to(cuda_device, dtype)
    q = torch.from_numpy(rng.integers(-127, 128, size=(k, n)).astype(np.int8)).to(cuda_device)
    scale = torch.from_numpy(rng.random(n).astype(np.float32) / 512).to(cuda_device)
    (dx,) = torch.autograd.grad(QuantMatmulFn.apply(x, q, scale), x, g)
    x32 = x.detach().float().requires_grad_()
    (want,) = torch.autograd.grad(x32 @ (q.float() * scale), x32, g.float())
    assert dx.dtype == dtype
    err = (dx.float() - want).abs().max().item()
    assert err <= 2e-2 * want.abs().max().item(), err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_decode_kernels_match_plain_on_card(cuda_device, dtype):
    """The int8-KV branches of K4 (random beam_sel, kv_start, steps 1 / 17
    / 50) and K5 (a fully masked row gives 0) against their plain
    versions; float32 at 1e-4, bf16 at 2e-2."""
    dev = cuda_device
    rng = np.random.default_rng(3)
    b, kb, t, g, h, hkv, d = 2, 3, 16, 50, 4, 2, 80
    q = _randn(rng, b * kb, h, d).to(dev, dtype)
    (pk, pks), (pv, pvs) = (_int8(rng, b, hkv, t, d) for _ in range(2))
    (gk, gks), (gv, gvs) = (_int8(rng, b * kb, hkv, g, d) for _ in range(2))
    sel = torch.from_numpy(rng.integers(0, kb, size=(b * kb, g)).astype(np.int32))
    args = [x.to(dev) for x in (pk, pv, gk, gv)]
    kw = dict(kv_start=torch.tensor([0, 3], device=dev), beam_sel=sel.to(dev),
              prompt_k_scale=pks.to(dev), prompt_v_scale=pvs.to(dev),
              gen_k_scale=gks.to(dev), gen_v_scale=gvs.to(dev))
    tol = TOL if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    for step in (1, 17, 50):
        got = decode_attention(q, *args, step=step, **kw)
        torch.testing.assert_close(got, decode_attention_ref(q, *args, step=step, **kw), **tol)
    mask = torch.from_numpy(rng.random((b, t)) < 0.6).to(dev)
    mask[0] = False
    skw = dict(k_scale=pks.to(dev), v_scale=pvs.to(dev))
    got = single_query_attention(q, args[0], args[1], mask, **skw)
    torch.testing.assert_close(got, single_query_attention_ref(q, args[0], args[1], mask, **skw),
                               **tol)
    assert torch.equal(got[:kb], torch.zeros_like(got[:kb]))


def test_int8_kernel_wrappers_reject_bad_inputs():
    """K6's wrapper raises on CPU tensors; the decode wrappers raise on int8
    caches without their scales and on a partial set of scales."""
    rng = np.random.default_rng(4)
    with pytest.raises(ValueError, match="CUDA"):
        quant_matmul_cuda(_randn(rng, 4, 8), torch.zeros(8, 16, dtype=torch.int8),
                          torch.ones(16))
    qd = _randn(rng, 2, 2, 64)
    kv, kvs = _int8(rng, 1, 2, 8, 64)
    gen, gens = _int8(rng, 2, 2, 4, 64)
    with pytest.raises(ValueError, match="scales"):
        decode_attention_cuda(qd, kv, kv, gen, gen, step=1)
    with pytest.raises(ValueError, match="scales"):
        decode_attention_cuda(qd, kv, kv, gen, gen, step=1, prompt_k_scale=kvs,
                              prompt_v_scale=kvs, gen_k_scale=gens)
    with pytest.raises(ValueError, match="scales"):
        single_query_attention_cuda(qd, kv, kv, torch.ones(1, 8, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        single_query_attention_cuda(qd, kv, kv, torch.ones(1, 8, dtype=torch.bool),
                                    k_scale=kvs, v_scale=kvs)


# the int8 matmuls of a 4b-instruct decode step (M = 240 beam rows) and its
# prefill head (M = 24), (m, k, n)
K6_MAIN = [(240, 2560, 7680), (240, 2560, 2560), (240, 2560, 10240), (240, 10240, 2560),
           (240, 2560, 54656), (24, 2560, 54656)]
K6_PLAN_SHAPES = K6_MAIN + [(1, 2560, 7680), (256, 10240, 2560), (300, 10240, 2560),
                            (512, 10240, 2560), (512, 2560, 7680), (240, 1000, 2560),
                            (100, 1000, 130), (37, 100, 70), (1, 72, 130), (3, 0, 16),
                            (240, 64, 128)]


@pytest.mark.parametrize("m,k,n", K6_PLAN_SHAPES)
def test_split_k_chunks_tile_k(m, k, n):
    """K6's split plan: whole 64-deep k tiles a chunk, at most 8 splits,
    and the chunks [z * k_chunk, min(k, (z + 1) * k_chunk)) cover K
    exactly, none empty (what the kernel's C entry point checks)."""
    splits, k_chunk = split_k_plan(m, k, n)
    assert 1 <= splits <= 8 and k_chunk % K6_BK == 0 and k_chunk > 0
    chunks = [(z * k_chunk, min(k, (z + 1) * k_chunk)) for z in range(splits)]
    assert chunks[0][0] == 0 and chunks[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert splits == 1 or all(hi > lo for lo, hi in chunks)


@pytest.mark.parametrize("m,k,n", K6_PLAN_SHAPES)
def test_split_k_only_where_sms_idle(m, k, n):
    """One split where the output tiles already fill the 132 SMs; more
    only while the split grid still fits on them."""
    splits, _ = split_k_plan(m, k, n)
    blocks = -(-n // 128) * -(-m // k6_block_rows(m))
    if blocks >= SMS:
        assert splits == 1
    assert splits * blocks <= max(SMS, blocks)


def test_split_k_plan_at_the_decode_shapes():
    """o and down (20 N tiles) split 6 ways, the fused QKV (60) 2, the
    rest (80 and more tiles) not at all."""
    assert [split_k_plan(*s)[0] for s in K6_MAIN] == [2, 6, 1, 6, 1, 1]
    assert k6_block_rows(240) == k6_block_rows(256) == 256 and k6_block_rows(64) == 64


@pytest.mark.parametrize("m,k,n", K6_PLAN_SHAPES)
def test_split_k_scratch_matches_plan(m, k, n):
    """The wrapper's f32 scratch holds [splits, m, n] partial sums (none
    for one split): at most 20 MB at the 4b down projection."""
    splits, k_chunk, part = split_k_scratch(m, k, n, "cpu")
    assert (splits, k_chunk) == split_k_plan(m, k, n)
    if splits == 1:
        assert part is None
    else:
        assert part.dtype == torch.float32 and tuple(part.shape) == (splits, m, n)
    if (m, k, n) == (240, 10240, 2560):
        assert part.numel() * 4 <= 20e6


@pytest.mark.gpu
@pytest.mark.parametrize("m", [256, 300, 512])
def test_quant_matmul_split_k_rows_on_card(cuda_device, m):
    """K6 bf16 with split-K engaged at one full 256-row block, two blocks
    and quant_dot's largest row count, on a strided weight whose K is not
    a multiple of the split: within 2e-2 of max |plain| (the f32 sums
    differ in order, then both round to bf16); the same output twice (no
    atomics)."""
    k, n, ldq = 1000, 640, 672
    assert split_k_plan(m, k, n)[0] > 1
    rng = np.random.default_rng(m)
    x = _randn(rng, m, k).to(cuda_device, torch.bfloat16)
    wide = torch.from_numpy(rng.integers(-127, 128, size=(k, ldq)).astype(np.int8))
    q = wide.to(cuda_device)[:, :n]
    scale = torch.from_numpy(rng.random(n).astype(np.float32) / 64).to(cuda_device)
    got = quant_matmul_cuda(x, q, scale)
    want = quant_matmul_ref(x, q, scale)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item(), err
    assert torch.equal(got, quant_matmul_cuda(x, q, scale))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["vit", "perceiver", "xattn_immediate", "lm_prefill",
                                  "serve_prefill_pad_row"])
def test_flash_forward_bf16_main_shapes_on_card(cuda_device, case):
    """K1's bf16 tensor-core path at the 4b main-path shapes, batch cut to
    2, and at the serving wave's prefill (4 slots, 64 tokens, the last an
    unused slot: all pad, kv_start 64): out within 2e-2 of the plain
    version (P and the output round to bf16 in both), lse within 1e-3; the
    all-pad row gives 0 and lse -1e30."""
    dev = cuda_device
    b, sq, skv, h, d = dict(vit=(2, 257, 257, 16, 64), perceiver=(2, 64, 320, 16, 64),
                            xattn_immediate=(2, 128, 256, 32, 80),
                            lm_prefill=(2, 128, 128, 32, 80),
                            serve_prefill_pad_row=(4, 64, 64, 32, 80))[case]
    rng = np.random.default_rng(5)
    q = _randn(rng, b, sq, h, d).to(dev, torch.bfloat16)
    k, v = (_randn(rng, b, skv, h, d).to(dev, torch.bfloat16) for _ in range(2))
    kw, mask = {}, AttnMask()
    if case == "xattn_immediate":
        pos = torch.zeros(b, sq, dtype=torch.int32)
        pos[:, [10, 34, 58, 82]] = 1  # text before the first <image>: fully masked
        qm = torch.cumsum(pos, 1, dtype=torch.int32).to(dev)
        km = torch.arange(1, 5, dtype=torch.int32).repeat_interleave(64)[None].repeat(b, 1).to(dev)
        kw = dict(q_media=qm, kv_media=km, media_mode="immediate")
        mask = AttnMask(q_media=qm, kv_media=km, media_mode="immediate")
    if case == "lm_prefill":
        kw = dict(causal=True, kv_start=torch.tensor([0, 27], device=dev))
        mask = AttnMask(causal=True)
    if case == "serve_prefill_pad_row":
        kw = dict(causal=True, kv_start=torch.tensor([0, 37, 12, 64], device=dev))
        mask = AttnMask(causal=True)
    got, lse = flash_attention_cuda(q, k, v, **kw)
    want, want_lse = attention_ref(q, k, v, mask, kv_start=kw.get("kv_start"))
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-3)
    if case == "serve_prefill_pad_row":
        assert torch.equal(got[3], torch.zeros_like(got[3]))
        assert bool((lse[3] == -1e30).all())


def _media_ids(b, sq, n_media, lat, first, gap):
    """(q_media [B, Sq], kv_media [B, n_media * lat]) int32: an <image> every
    ``gap`` tokens from ``first``; queries before it see nothing under
    "immediate"."""
    pos = np.zeros((b, sq), np.int32)
    pos[:, [first + i * gap for i in range(n_media)]] = 1
    km = np.repeat(np.arange(1, n_media + 1, dtype=np.int32), lat)[None].repeat(b, 0)
    return torch.from_numpy(np.cumsum(pos, 1, dtype=np.int32)), torch.from_numpy(km)


# name: ((b, sq, skv, h, hkv, d), masks); the 4b training shapes (the ViT's
# when the transfer entry trains the tower: 257 keys, one past four tiles),
# then the edges of the 64-row / 64-column tiles of the tensor-core kernels
BF16_BWD_CASES = {
    "lm_train_3x256_d80_causal_kvlen": ((3, 256, 256, 32, 32, 80),
                                        dict(causal=True, kv_len=[256, 229, 203])),
    "xattn_train_3x256x384_d80_immediate": ((3, 256, 384, 32, 32, 80),
                                            dict(media=(6, 64, 4, 31))),
    "perceiver_train_18x64x320_d64": ((18, 64, 320, 16, 16, 64), {}),
    "vit_train_18x16_257_d64": ((18, 257, 257, 16, 16, 64), {}),
    "one_1x1_d64": ((2, 1, 1, 4, 4, 64), {}),
    "tile_edge_65_d80_causal": ((2, 65, 65, 8, 8, 80), dict(causal=True)),
    "skv63_d80": ((2, 100, 63, 8, 8, 80), {}),
    "gqa_32_8_d80_causal_kv_start": ((2, 100, 100, 32, 8, 80),
                                     dict(causal=True, kv_start=[3, 0], kv_len=[100, 77])),
    "immediate_masked_rows_d80": ((2, 128, 256, 8, 8, 80), dict(media=(4, 64, 40, 24))),
    "alibi_d128_causal": ((2, 256, 256, 16, 16, 128), dict(causal=True, alibi=True)),
    # 3b-mpt's training (MPT-1B: 16 heads, d128, ALiBi; x-attn over 6 x 64 latents)
    "mpt_train_3x256_d128_causal_alibi_kvlen": ((3, 256, 256, 16, 16, 128),
                                                dict(causal=True, alibi=True,
                                                     kv_len=[256, 231, 204])),
    "mpt_xattn_train_3x256x384_d128_immediate": ((3, 256, 384, 16, 16, 128),
                                                 dict(media=(6, 64, 4, 31))),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(BF16_BWD_CASES))
def test_flash_backward_bf16_matches_plain_on_card(cuda_device, case):
    """K2 and K3 in bf16 (the tensor-core kernels) against flash_bwd_dkv_ref /
    flash_bwd_dq_ref on the same inputs (lse from K1): max |d| <= 2e-2 *
    max |plain| per gradient, as chip_smoke's REL_TOL (p and dS round to
    bf16 in both, the f32 sums run in another order); a gradient that is 0
    by construction (one key: dq, dk) is f32 rounding noise of dp - delta
    on both sides and is held to max |kernel| <= 1e-5 (chip_smoke's
    NOISE_ATOL). Rows that see nothing get dq = 0; a second launch gives
    the same bits (no atomics)."""
    dev = cuda_device
    (b, sq, skv, h, hkv, d), spec = BF16_BWD_CASES[case]
    rng = np.random.default_rng(6)
    q, do = (_randn(rng, b, sq, h, d).to(dev, torch.bfloat16) for _ in range(2))
    k, v = (_randn(rng, b, skv, hkv, d).to(dev, torch.bfloat16) for _ in range(2))
    kw, mask = {}, AttnMask()
    if spec.get("causal"):
        kw["causal"] = True
        mask = AttnMask(causal=True)
    for name in ("kv_start", "kv_len"):
        if name in spec:
            kw[name] = torch.tensor(spec[name], device=dev)
    if spec.get("alibi"):
        kw["alibi_slopes"] = torch.linspace(0.05, 0.5, h, device=dev)
    if "media" in spec:
        n_media, lat, first, gap = spec["media"]
        qm, km = (x.to(dev) for x in _media_ids(b, sq, n_media, lat, first, gap))
        kw.update(q_media=qm, kv_media=km, media_mode="immediate")
        mask = AttnMask(q_media=qm, kv_media=km, media_mode="immediate")
    win = dict(kv_len=kw.get("kv_len"), kv_start=kw.get("kv_start"), alibi=kw.get("alibi_slopes"))

    out, lse = flash_attention_cuda(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    dk, dv = flash_bwd_dkv_cuda(*args, **kw)
    dq = flash_bwd_dq_cuda(*args, **kw)
    want_dk, want_dv = flash_bwd_dkv_ref(*args, mask, **win)
    want_dq = flash_bwd_dq_ref(*args, mask, **win)
    for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk), ("dv", dv, want_dv)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert torch.isfinite(got.float()).all(), name
        size = want.float().abs().max().item()
        if size < 1e-5:
            assert got.float().abs().max().item() <= 1e-5, name
            continue
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2e-2 * size, (name, err)
    if "media" in spec:
        blind = kw["q_media"] == 0
        assert blind.any() and torch.equal(dq[blind], torch.zeros_like(dq[blind]))
    assert torch.equal(dk, flash_bwd_dkv_cuda(*args, **kw)[0])
    assert torch.equal(dq, flash_bwd_dq_cuda(*args, **kw))


# K4 cases: (b, kb, t, g, h, hkv, d, options); the 4b decode shape, then the
# edges of the tensor-core kernel: one beam (greedy, no beam_sel), 16 beams
# (one full tile of rows), beams sharing one ancestor for the first 20 gen
# positions, ragged kv_start / prompt_len windows, GQA 16/4 with ALiBi, and
# 130 gen positions (the kernel lists them 64 at a time); then the other
# tasks' decodes at the 4b heads: img_gen greedy to 600 positions, exp's 5
# beams to 256, img_sel's 2 beams to 40; the serving engine's wave (4 slots,
# one query each, a 64-token window, 32 gen positions) with two unused slots,
# whose prompt window is empty (kv_start = T)
K4_CARD_CASES = {
    "4b_b24_k10_d80": (24, 10, 128, 50, 32, 32, 80, {}),
    "greedy_k1_d80": (4, 1, 128, 50, 32, 32, 80, {}),
    "k16_d80": (2, 16, 128, 50, 8, 8, 80, {}),
    "shared_ancestor_20_d80": (4, 10, 128, 50, 8, 8, 80, dict(share=20)),
    "ragged_windows_d80": (3, 10, 100, 50, 8, 8, 80, dict(ragged=True)),
    "gqa_16_4_alibi_d64": (3, 4, 100, 50, 16, 4, 64, dict(alibi=True, ragged=True)),
    "gqa_16_4_alibi_d128": (3, 4, 100, 50, 16, 4, 128, dict(alibi=True, ragged=True)),
    "long_gen_130_d64": (2, 5, 64, 130, 4, 4, 64, dict(share=70)),
    "img_gen_greedy_b24_g600_d80": (24, 1, 128, 600, 32, 32, 80, {}),
    "exp_b24_k5_g256_d80": (24, 5, 128, 256, 32, 32, 80, dict(share=8)),
    "img_sel_b24_k2_g40_d80": (24, 2, 256, 40, 32, 32, 80, dict(share=4)),
    "serve_b4_k1_t64_g32_two_empty_d80": (4, 1, 64, 32, 32, 32, 80, dict(empty=2)),
}


def _kv(rng, dev, int8, *shape):
    """bf16 K or V rows, or int8 rows and their f32 scales."""
    x = _randn(rng, *shape)
    if int8:
        q8, s = quantize_kv(x)
        return q8.to(dev), s.to(dev)
    return x.to(dev, torch.bfloat16), None


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("case", list(K4_CARD_CASES))
def test_decode_kernel_bf16_matches_plain_on_card(cuda_device, case, kv):
    """K4 with bf16 q (the tensor-core kernel), bf16 or int8 caches, against
    decode_attention_ref at steps 1, 17 and the last: within 2e-2 (p and the
    output round to bf16 in both, p under different maxima); a second
    launch gives the same bits."""
    dev, int8 = cuda_device, kv == "int8"
    b, kb, t, g, h, hkv, d, opt = K4_CARD_CASES[case]
    rng = np.random.default_rng(7)
    q = _randn(rng, b * kb, h, d).to(dev, torch.bfloat16)
    (pk, pks), (pv, pvs) = (_kv(rng, dev, int8, b, hkv, t, d) for _ in range(2))
    (gk, gks), (gv, gvs) = (_kv(rng, dev, int8, b * kb, hkv, g, d) for _ in range(2))
    sel = rng.integers(0, kb, size=(b * kb, g))
    if opt.get("share"):
        sel[:, :opt["share"]] = np.repeat(rng.integers(0, kb, size=(b, 1)), kb, axis=0)
    kw = dict(kv_start=torch.from_numpy(rng.integers(0, t // 4, size=b)).to(dev),
              beam_sel=torch.from_numpy(sel.astype(np.int32)).to(dev) if kb > 1 else None)
    if opt.get("empty"):
        kw["kv_start"][:opt["empty"]] = t
    if opt.get("ragged"):
        kw["prompt_len"] = torch.from_numpy(rng.integers(t // 2, t + 1, size=b)).to(dev)
    if opt.get("alibi"):
        kw["alibi"] = torch.linspace(0.05, 0.5, h, device=dev)
    if int8:
        kw.update(prompt_k_scale=pks, prompt_v_scale=pvs, gen_k_scale=gks, gen_v_scale=gvs)
    args = (q, pk, pv, gk, gv)
    for step in (1, 17, g):
        got = decode_attention_cuda(*args, step=step, **kw)
        want = decode_attention_ref(*args, step=step, **kw)
        assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(got, decode_attention_cuda(*args, step=g, **kw))


# ------------------------------------------- the decode step on the device


def _decode_inputs(rng, int8, b=2, kb=3, t=12, g=8, h=4, hkv=2, d=64):
    """q, caches and keywords of a split-cache decode: float32 q, float32
    or int8 caches (with their scales), ragged prompt windows, ALiBi and a
    random ancestry table."""
    def kv(*shape):
        x = _randn(rng, *shape)
        return quantize_kv(x) if int8 else (x, None)

    (pk, pks), (pv, pvs) = kv(b, hkv, t, d), kv(b, hkv, t, d)
    (gk, gks), (gv, gvs) = kv(b * kb, hkv, g, d), kv(b * kb, hkv, g, d)
    kw = dict(kv_start=torch.tensor([0, 3]), alibi=torch.linspace(0.1, 0.4, h),
              beam_sel=torch.from_numpy(rng.integers(0, kb, size=(b * kb, g)).astype(np.int32)))
    if int8:
        kw.update(prompt_k_scale=pks, prompt_v_scale=pvs, gen_k_scale=gks, gen_v_scale=gvs)
    return (_randn(rng, b * kb, h, d), pk, pv, gk, gv), kw


@pytest.mark.parametrize("beam_sel", [True, False])
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_decode_attention_ref_takes_the_step_as_a_tensor(kv, beam_sel):
    """The plain K4 given ``step`` as a one-element tensor (the model's
    form) equals the int form bit for bit, at every step."""
    args, kw = _decode_inputs(np.random.default_rng(11), kv == "int8")
    if not beam_sel:
        kw["beam_sel"] = None
    for step in (1, 5, 8):
        want = decode_attention_ref(*args, step=step, **kw)
        for t in (torch.tensor([step], dtype=torch.int32), torch.tensor([step])):
            assert torch.equal(decode_attention_ref(*args, step=t, **kw), want)


@pytest.mark.parametrize("gen_index", [True, False])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_attention_decode_takes_the_step_as_a_tensor(kv, gen_index):
    """``Attention``'s decode with ``step`` an int, a one-element int64
    tensor, or with the model's ``step_tensors``: the same output and gen
    caches bit for bit, this token's K/V (quantized with their scales in
    an int8 cache) written at column ``step`` and nowhere else."""
    from unimp_tpu_torch.models.layers import Attention, decode_step_tensors
    from unimp_tpu_torch.models.lm import init_gen_cache
    from unimp_tpu_torch.models.config import LMConfig

    torch.manual_seed(0)
    b, kb, t, g, step = 2, 3, 10, 6, 4
    lm = LMConfig(vocab_size=64, hidden_size=128, num_layers=1, num_heads=2,
                  positions="alibi" if kv == "int8" else "rope", use_bias=False)
    attn = Attention(128, 2, 64, positions_mode=lm.positions, dtype=torch.bfloat16).eval()
    with torch.no_grad():
        for p in attn.parameters():
            p.normal_(0.0, 0.05)
    rng = np.random.default_rng(12)
    x = _randn(rng, b * kb, 1, 128).to(torch.bfloat16)
    prompt = {n: _randn(rng, b, 2, t, 64).to(torch.bfloat16) for n in ("k", "v")}
    if kv == "int8":
        prompt = {**dict(zip(("k", "k_scale"), quantize_kv(prompt["k"]))),
                  **dict(zip(("v", "v_scale"), quantize_kv(prompt["v"])))}
    anc = torch.from_numpy(rng.integers(0, b * kb, size=(b * kb, g)))
    pos = torch.full((b * kb, 1), t + step)

    def run(**step_kw):
        gen = init_gen_cache(b * kb, g, lm, torch.bfloat16, "cpu", quantized=kv == "int8")
        for c in gen.values():  # earlier steps' entries
            c[:, :, :step] = torch.from_numpy(rng.normal(size=c[:, :, :step].shape)).to(c.dtype)
        ds = dict(prompt=prompt, gen=gen, kv_start=torch.tensor([0, 2]),
                  gen_index=anc if gen_index else None, **step_kw)
        with torch.no_grad():
            out, cache = attn(x, positions=pos, decode_state=ds)
        return out, cache

    rng_state = rng.bit_generator.state
    want, want_gen = run(step=step)
    for form in (dict(step=torch.tensor([step])),
                 dict(step=step, step_tensors=decode_step_tensors(step, torch.device("cpu")))):
        rng.bit_generator.state = rng_state  # the same earlier entries
        got, got_gen = run(**form)
        assert torch.equal(got, want)
        assert all(torch.equal(got_gen[n], want_gen[n]) for n in want_gen)
    # this token's K/V at column `step`, and nothing after it
    with torch.no_grad():
        k = attn.k_proj(x)
        if lm.positions == "rope":
            from unimp_tpu_torch.models.layers import apply_rope
            k = apply_rope(k, pos, attn.rotary_pct, attn.rope_theta)
    k = k[:, 0]
    if kv == "int8":
        k8, ks = quantize_kv(k)
        assert torch.equal(want_gen["k"][:, :, step], k8)
        assert torch.equal(want_gen["k_scale"][:, :, step], ks)
    else:
        assert torch.equal(want_gen["k"][:, :, step], k.to(torch.bfloat16))
    assert not want_gen["k"][:, :, step + 1:].any()


# the graph path's models (``debug`` widths, head dim 64): bf16 with
# rotary positions, and int8 weights (every kernel) with int8 KV and ALiBi
GRAPH_MODELS = {"bf16_rope": (dict(), False), "int8_alibi": (
    dict(positions="alibi", norm="layernorm", act="gelu"), True)}
GRAPH_MEDIA_ID = 7


def _graph_model(kind, dev):
    import dataclasses

    from unimp_tpu_torch.models import get_config
    from unimp_tpu_torch.tools.from_flax import build_model
    from unimp_tpu_torch.utils.quant import quantize_params_int8

    lm_kw, int8 = GRAPH_MODELS[kind]
    cfg = get_config("debug", dtype="bfloat16")
    cfg = cfg.replace(lm=dataclasses.replace(cfg.lm, **lm_kw))
    model = build_model(cfg, device=dev, seed=3, eval_param_dtype="bf16")
    if int8:
        quantize_params_int8(model, min_size=1)
    with torch.no_grad():  # the gates open, so the x-attn blocks count
        for name, p in model.named_parameters():
            if name.endswith(("attn_gate", "ff_gate")):
                p.fill_(1.0)
    return model, int8


def _graph_batch(model, dev, b, t, seed):
    """Right-padded prompts with two media tokens each, ragged lengths, and
    seeded latents in place of the vision tower's."""
    rng = np.random.default_rng(seed)
    cfg = model.cfg
    ids = rng.integers(10, cfg.lm.vocab_size, size=(b, t))
    seq_len = t - rng.integers(0, t // 3, size=b)
    seq_len[0] = t
    ids[:, 1] = ids[:, 5] = GRAPH_MEDIA_ID
    for r in range(b):
        ids[r, seq_len[r]:] = 0
    lat = rng.normal(size=(b, 2, cfg.resampler.num_latents, cfg.vision.hidden_size))
    return (torch.from_numpy(ids).to(dev), torch.from_numpy(seq_len).to(dev),
            torch.from_numpy(lat).to(dev, torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("beams", [10, 1])
@pytest.mark.parametrize("kind", list(GRAPH_MODELS))
def test_decode_graph_matches_the_eager_loop_on_card(cuda_device, kind, beams):
    """The decode step as a CUDA graph against the same loop calling the
    model: equal tokens and scores bit for bit, for two consecutive batches
    of different shapes through one ``Generator`` (a graph captured for
    each) with an EOS that finishes rows early; ``LAUNCHES`` per kernel
    equal to the eager loop's; the counters read one capture a batch and a
    replay for every later step, and the graph is gone after the call."""
    from unimp_tpu_torch.decode import sampler
    from unimp_tpu_torch.decode.sampler import GenerationConfig, Generator

    class EagerGenerator(Generator):
        def _decode_step(self, tokens, state, gen, step, positions, gen_index=None):
            ds = dict(state, gen=gen, step=step, gen_index=gen_index)
            return self.model(tokens, positions=positions, decode_state=ds)

    dev = cuda_device
    model, int8 = _graph_model(kind, dev)

    def run(cls, batch, eos):
        gen = cls(model, GenerationConfig(max_new_tokens=12, eos_id=eos, pad_id=0,
                                          num_beams=beams, num_return_sequences=beams,
                                          kv_int8=int8), media_id=GRAPH_MEDIA_ID)
        steps, real = [0], gen._decode_step

        def counted(*args, **kwargs):
            steps[0] += 1
            return real(*args, **kwargs)

        gen._decode_step = counted
        kernel_lib.reset_launches()
        sampler.reset_decode_steps()
        tokens, scores = gen.generate(*batch)
        assert gen._graph is None
        return tokens, scores, dict(kernel_lib.LAUNCHES), dict(sampler.DECODE_STEPS), steps[0]

    batches = [_graph_batch(model, dev, 3, 16, 1), _graph_batch(model, dev, 2, 24, 2)]
    # an EOS the model emits: row 0's third token, or the commonest beam token
    pilot = run(EagerGenerator, batches[0], eos=model.cfg.lm.vocab_size - 1)[0]
    eos = int(pilot[0, 0, 2]) if beams == 1 else int(torch.mode(pilot[pilot > 0]).values)
    run(Generator, batches[1], eos)  # the model's first graph step: its warm-up
    ended_early = False
    for batch in batches:
        want_tok, want_sc, want_launches, eager, steps = run(EagerGenerator, batch, eos)
        got_tok, got_sc, got_launches, counts, got_steps = run(Generator, batch, eos)
        assert eager == {"captures": 0, "replays": 0, "eager": 0}
        assert got_steps == steps
        assert torch.equal(got_tok, want_tok) and torch.equal(got_sc, want_sc)
        assert got_launches == want_launches
        assert counts == {"captures": 1, "replays": steps - 1, "eager": 0}
        ended_early |= bool((want_tok[..., -1] == 0).any())
    assert ended_early, "no sequence ended before the last step (padded after it)"


# K5 cases: (b, kb, s, h, hkv, d, mask); "immediate": the last of s / 64
# media allowed (one 64-latent tile in four at the 4b shape); "one_tile":
# latents 130-140 only (one tile of five); "random" with row 0 fully masked;
# img_sel's 9 media (576 latents) at 5 and 2 beams; the serving wave's one
# medium with row 0 fully masked (a slot without an image)
K5_CARD_CASES = {
    "4b_b24_k10_s256_d80_immediate": (24, 10, 256, 32, 32, 80, "immediate"),
    "one_tile_of_five_d80": (4, 10, 320, 8, 8, 80, "one_tile"),
    "masked_row_gqa_d128": (4, 3, 96, 16, 4, 128, "random"),
    "k16_d64": (2, 16, 256, 8, 8, 64, "random"),
    "k1_d80": (3, 1, 100, 4, 4, 80, "random"),
    "exp_b24_k5_s576_d80_immediate": (24, 5, 576, 32, 32, 80, "immediate"),
    "img_sel_b24_k2_s576_d80_immediate": (24, 2, 576, 32, 32, 80, "immediate"),
    "serve_b4_k1_s64_d80_masked_row": (4, 1, 64, 32, 32, 80, "masked_row"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("case", list(K5_CARD_CASES))
def test_single_query_kernel_bf16_matches_plain_on_card(cuda_device, case, kv):
    """K5 with bf16 q (the tensor-core kernel), bf16 or int8 latents, against
    single_query_attention_ref: within 2e-2; a row with nothing allowed
    gives exactly 0; a second launch gives the same bits."""
    dev, int8 = cuda_device, kv == "int8"
    b, kb, s, h, hkv, d, mode = K5_CARD_CASES[case]
    rng = np.random.default_rng(8)
    q = _randn(rng, b * kb, h, d).to(dev, torch.bfloat16)
    (k, ks), (v, vs) = (_kv(rng, dev, int8, b, hkv, s, d) for _ in range(2))
    mask = np.zeros((b, s), bool)
    if mode in ("immediate", "masked_row"):
        mask[:, s - 64:] = True
        if mode == "masked_row":
            mask[0] = False
    elif mode == "one_tile":
        mask[:, 130:141] = True
        mask[0] = False
    else:
        mask = rng.random((b, s)) < 0.6
        mask[0] = False
    mask = torch.from_numpy(mask).to(dev)
    kw = dict(k_scale=ks, v_scale=vs) if int8 else {}
    got = single_query_attention_cuda(q, k, v, mask, **kw)
    want = single_query_attention_ref(q, k, v, mask, **kw)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    if mode != "immediate":
        assert torch.equal(got[:kb], torch.zeros_like(got[:kb]))
    assert torch.equal(got, single_query_attention_cuda(q, k, v, mask, **kw))


# ---------------------------------------------------------------- ranks on one card


def _spawn_ranks(tmp_path, case, world, inputs, timeout=300):
    """``tests/torch_parallel_worker.py`` on ``world`` gloo ranks sharing
    the card; each rank's result."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    worker = Path(__file__).with_name("torch_parallel_worker.py")
    torch.save(inputs, tmp_path / "inputs.pt")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen([sys.executable, str(worker), case, str(r), str(world),
                               str(tmp_path / "store"), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0].decode()[-3000:] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    failed = [f"rank {r}:\n{log}" for r, (p, log) in enumerate(zip(procs, logs))
              if p.returncode != 0]
    assert not failed, "\n".join(failed)
    return [torch.load(tmp_path / f"{case}_rank{r}.pt", weights_only=False)
            for r in range(world)]


def _card_step_inputs():
    """Seeded ``small`` weights (a flat float tree: head dims 64, which the
    kernels take) and a rec-shaped batch of 8 rows whose even rows hold
    longer answer spans."""
    from unimp_tpu_torch.models import get_config
    from unimp_tpu_torch.tools.from_flax import build_model

    model = build_model(get_config("small", dtype="float32"), device="cpu", seed=3)
    weights = {n.replace(".", "/"): t.clone() for n, t in model.state_dict().items()}
    rng = np.random.default_rng(5)
    ids = rng.integers(10, 30000, size=(8, 24)).astype(np.int32)
    seq_len = rng.integers(21, 25, size=8).astype(np.int32)
    for r in range(8):
        ids[r, 2] = ids[r, 7] = 7
        ids[r, 9] = 8
        ids[r, 19 if r % 2 == 0 else 12] = 9
        ids[r, seq_len[r]:] = 0
    batch = {"input_ids": ids, "seq_len": seq_len,
             "weights": rng.uniform(0.5, 1.5, size=8).astype(np.float32),
             "images": rng.integers(0, 256, size=(8, 2, 224, 224, 3), dtype=np.uint8)}
    ids_kw = dict(media_id=7, answer_id=8, endofchunk_id=9, pad_id=0, gamma=2.0,
                  use_reweight=True)
    return {"weights": weights, "batch": batch, "lr": 1e-3, "ids": ids_kw, "device": "cuda",
            "variant": "small"}


@pytest.mark.gpu
def test_gloo_ranks_on_card_match_one_process(cuda_device, tmp_path):
    """Two gloo ranks sharing the card (dp 2: K1 / K2 / K3 in each rank, the
    gradients all-reduced through the host) against one process on the
    card at the global batch: losses within 1e-5, the reduced gradients
    within 5e-4 of each tensor's largest entry (float32), the replicas
    equal bit for bit."""
    from unimp_tpu_torch.models import get_config
    from unimp_tpu_torch.tools.from_flax import build_model
    from unimp_tpu_torch.train.optimizer import make_optimizer
    from unimp_tpu_torch.train.partition import trainable_params
    from unimp_tpu_torch.train.trainer import Trainer

    inputs = _card_step_inputs()
    model = build_model(get_config("small", dtype="float32"), device=cuda_device, train=True,
                        weights=inputs["weights"])
    trainer = Trainer(model, make_optimizer(trainable_params(model), learning_rate=1e-3),
                      device=cuda_device, accum_steps=2, **inputs["ids"])
    loss, _ = trainer.compute_grads(inputs["batch"])
    want = {n.replace(".", "/"): p.grad.cpu() for n, p in trainer.params.items()}
    out = _spawn_ranks(tmp_path, "step", 2, {**inputs, "meshes": [(2, 1, 1)]})
    got = [res[(2, 1, 1)] for res in out]
    np.testing.assert_allclose(got[0]["metrics"]["loss"], float(loss), rtol=1e-5)
    for path, g in got[0]["grads"].items():
        scale = max(float(want[path].abs().max()), 1e-30)
        torch.testing.assert_close(g, want[path], rtol=0, atol=5e-4 * scale)
    for path, p in got[0]["params"].items():
        assert torch.equal(p, got[1]["params"][path]), path


@pytest.mark.gpu
def test_gloo_sharded_steps_on_card(cuda_device, tmp_path):
    """fsdp 2 and tp 2 on two gloo ranks sharing the card, each against the
    dp 2 step: losses within 1e-5 and gradients within 5e-4 of each
    tensor's largest entry. Skips, naming the collective, where this
    torch's gloo refuses all-gather or reduce-scatter on CUDA tensors."""
    (tmp_path / "probe").mkdir()
    probe = _spawn_ranks(tmp_path / "probe", "probe", 2, {})
    refused = {k: v for k, v in probe[0].items() if v}
    if refused:
        pytest.skip(f"gloo refuses on CUDA tensors: {refused}")
    inputs = {**_card_step_inputs(), "meshes": [(2, 1, 1), (1, 2, 1), (1, 1, 2)]}
    out = _spawn_ranks(tmp_path, "step", 2, inputs)
    base = out[0][(2, 1, 1)]
    for mesh in ((1, 2, 1), (1, 1, 2)):
        for res in out:
            got = res[mesh]
            np.testing.assert_allclose(got["metrics"]["loss"], base["metrics"]["loss"],
                                       rtol=1e-5)
            for path, g in got["grads"].items():
                scale = max(float(base["grads"][path].abs().max()), 1e-30)
                torch.testing.assert_close(g, base["grads"][path], rtol=0, atol=5e-4 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gloo_ring_attention_on_card(cuda_device, tmp_path, dtype):
    """``--seq_shard``'s ring over two gloo ranks sharing the card (K/V
    rotated by ``batch_isend_irecv`` on CUDA tensors, K1 a block merged by
    lse, K2 / K3 a block against the merged lse) against K1 / K2 / K3 on
    the whole sequence in one process, at 3b-mpt's attention shape (16
    heads of 128, T 256: a block of 128 a rank), causal and with a
    ``kv_len`` at or below one block, so that rank 1's own block holds no
    valid key. Forward and gradients within 1e-4 (float32) or 2e-2
    (bfloat16), the card tests' bars."""
    from unimp_tpu_torch.ops.flash_attention import flash_attention

    rng = np.random.default_rng(13)
    b, s, h, d = 2, 256, 16, 128
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(np.float32))
                   for _ in range(4))
    kv_len = torch.tensor([256, 100], dtype=torch.int32)
    inputs = {"q": q.to(dtype), "k": k.to(dtype), "v": v.to(dtype), "do": do,
              "kv_len": kv_len, "device": "cuda"}
    out = _spawn_ranks(tmp_path, "ring", 2, inputs)
    tol = TOL if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    for name, kl in (("causal", None), ("kv_len", kv_len.to(cuda_device))):
        qc, kc, vc = (x.to(cuda_device, dtype).clone().requires_grad_() for x in (q, k, v))
        o = flash_attention(qc, kc, vc, causal=True, kv_len=kl)[0]
        (o.float() * do.to(cuda_device)).sum().backward()
        want = {"out": o, "dq": qc.grad, "dk": kc.grad, "dv": vc.grad}
        for key, t in want.items():
            got = torch.cat([res[name][key] for res in out])
            torch.testing.assert_close(got.float(), t.detach().float().cpu(), **tol,
                                       msg=lambda m: f"{name} {key}: {m}")
