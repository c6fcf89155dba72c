"""The benchmark's frozen counts equal what the program's FLOP counter and
``chip_smoke.py`` phase 3 count at this commit, and its reference's
parameters are the program's, by name and shape."""

import dataclasses

import numpy as np
import pytest
import torch

from gpubench import manifest
from gpubench import yardstick as Y
from gpubench.reference import flamingo as ref

CONFIGS = ["4b-instruct", "9b"]


def port_config(name):
    """The program's registry variant with the deployed vocabulary and
    OpenFlamingo's perceiver heads (8 of 64), as the configuration files
    state them."""
    from unimp_tpu_torch.models.config import get_config

    cfg = get_config(name)
    return cfg.replace(lm=dataclasses.replace(cfg.lm, vocab_size=54656),
                       resampler=dataclasses.replace(cfg.resampler, num_heads=8, head_dim=64))


def sizes(name):
    return manifest.model_sizes(manifest.load_json("configs", name))


@pytest.mark.parametrize("name", CONFIGS)
def test_configuration_files_are_the_registry_variants(name):
    cfg, s = port_config(name), sizes(name)
    for part in ("vision", "resampler", "lm"):
        want = dataclasses.asdict(getattr(cfg, part))
        got = manifest.load_json("configs", name)[part]
        assert got == want, part
    assert s.cross_attn_every_n == cfg.cross_attn_every_n


@pytest.mark.parametrize("name", CONFIGS)
def test_model_flops_equal_the_programs_counter(name):
    from unimp_tpu_torch.utils import flops

    cfg, s = port_config(name), sizes(name)
    for frozen in (False, True):
        assert Y.train_step_flops(s, 6, 256, 6, frozen) == flops.train_step_flops(
            cfg, 6, 256, 6, frozen_backbone=frozen)
    assert Y.decode_flops(s, 24, 128, 4, 10, 50) == flops.decode_flops(cfg, 24, 128, 4, 10, 50)
    window = Y.eval_batch_flops(s, 24, 128, 4, 10, 50)
    assert window == pytest.approx(flops.decode_flops(cfg, 24, 128, 4, 10, 50)
                                   - flops.vision_forward_flops(cfg, 96)
                                   - flops.resampler_forward_flops(cfg, 96))


def test_k4_work_equals_phase_3s_decode_bound():
    import chip_smoke as cs

    b, kb, t, g, h, hkv, d = 3, 4, 16, 8, 4, 4, 16
    c = cs.decode_case(torch.device("cpu"), b, kb, t, g, h, hkv, d, seed=3)
    c["hi"] = torch.full((b,), t)
    # the least: one gen row per user and position (every beam on one ancestor)
    c["sel"][:] = 0
    q = c["q"].to(torch.bfloat16)
    out = torch.empty_like(q)
    for elt, scale in ((2, 0), (1, 4)):
        by, fl, _ = cs.decode_bound(dict(c, q=q), out, g, kb, g, h, hkv, d, elt, scale)
        rows = int((c["hi"] - c["kv_start"]).clamp(min=0).sum())
        got = Y.k4_work(rows, b, kb, g, h, hkv, d, elt, scale)
        kv_start_bytes = c["kv_start"].numel() * c["kv_start"].element_size()
        assert got[1] == fl
        assert got[0] == by - kv_start_bytes + 4 * b


def test_k6_work_equals_phase_3s_count():
    import chip_smoke as cs

    m, k, n = 240, 256, 384
    x = torch.zeros(m, k, dtype=torch.bfloat16)
    q = torch.zeros(k, n, dtype=torch.int8)
    scale, out = torch.zeros(n), torch.zeros(m, n, dtype=torch.bfloat16)
    assert Y.k6_work(m, k, n) == (cs.nbytes(x, q, scale, out), 2.0 * m * k * n)


def test_mask_pairs_equal_the_programs_masks():
    from unimp_tpu_torch.models.flamingo import compute_q_media
    from unimp_tpu_torch.ops.attention_ref import AttnMask, window_mask

    rng = np.random.default_rng(0)
    b, t, lat, media = 3, 40, 8, 2
    seq_len = torch.tensor([40, 31, 25])
    ids = torch.from_numpy(rng.integers(1, 100, (b, t)))
    ids[0, 5], ids[1, 3], ids[1, 20], ids[2, 9] = 400, 400, 400, 400
    causal = window_mask(AttnMask(causal=True), b, t, "cpu", kv_len=seq_len)
    assert Y.causal_pairs(seq_len.tolist(), t) == int(causal.allowed(b, t, t, "cpu").sum())
    qm = compute_q_media(ids, 400)
    km = torch.arange(1, media + 1).repeat_interleave(lat)[None].expand(b, -1)
    media_mask = AttnMask(q_media=qm, kv_media=km, media_mode="immediate")
    want = int(media_mask.allowed(b, t, media * lat, "cpu").sum())
    assert Y.media_pairs((qm > 0).sum(1).tolist(), lat) == want


@pytest.mark.parametrize("name", CONFIGS + ["tiny"])
def test_reference_parameters_are_the_programs(name):
    from unimp_tpu_torch.models.flamingo import UniMPModel
    from unimp_tpu_torch.models.config import LMConfig, ResamplerConfig, UniMPConfig, VisionConfig
    from gpubench.tests import tiny

    cfg_file = tiny.CONFIGS["tiny-mpt"] if name == "tiny" else manifest.load_json("configs", name)
    cfg = UniMPConfig(VisionConfig(**cfg_file["vision"]), ResamplerConfig(**cfg_file["resampler"]),
                      LMConfig(**cfg_file["lm"]), cross_attn_every_n=cfg_file["cross_attn_every_n"])
    with torch.device("meta"):
        model = UniMPModel(cfg)
    want = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert ref.param_shapes(manifest.model_sizes(cfg_file)) == want
