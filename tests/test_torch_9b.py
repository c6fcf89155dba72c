"""``9b`` (CLIP ViT-L/14 + MPT-7B: ALiBi, head dim 128, tied embeddings,
x-attn every 4 layers) against the JAX package on the CPU, at its
structure cut to size: 8 LM layers (two x-attn blocks) of 2 heads of 128,
a 2-layer narrow ViT and perceiver, vocabulary 512. Weights from a seeded
JAX init (gates opened) through numpy: float32 logits, beam tokens, one
``Trainer`` step's loss and gradients, the CLI's
``openflamingo/OpenFlamingo-9B-vitl-mpt7b`` alias, and a ``.pt`` in
OpenFlamingo-9B's key layout through both converters.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import ANSWER, EOC, LR, MEDIA, PAD, _batch, _jax_grads

from unimp_tpu.cli.arguments import variant_name as j_variant_name
from unimp_tpu.decode import GenerationConfig as JGenerationConfig
from unimp_tpu.decode import Generator as JGenerator
from unimp_tpu.models import UniMPModel as JModel
from unimp_tpu.models import compute_q_media as j_compute_q_media
from unimp_tpu.models import get_config as j_get_config
from unimp_tpu.tools import convert_torch as j_convert
from unimp_tpu.tools import export_torch as j_export
from unimp_tpu.train import optimizer as j_opt
from unimp_tpu.train.partition import backbone_trainable_mask as j_trainable_mask
from unimp_tpu.train.partition import partition_params
from unimp_tpu.train.trainer import TrainState
from unimp_tpu.train.trainer import Trainer as JTrainer
from unimp_tpu_torch.cli.arguments import variant_name
from unimp_tpu_torch.decode import GenerationConfig, Generator
from unimp_tpu_torch.models import compute_q_media, get_config
from unimp_tpu_torch.tools import convert_torch
from unimp_tpu_torch.tools.from_flax import build_model, flatten_tree
from unimp_tpu_torch.train.optimizer import make_optimizer
from unimp_tpu_torch.train.partition import trainable_params
from unimp_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)  # six test workers share the cores
VOCAB = 512
CUT = {"vision": dict(image_size=28, patch_size=14, hidden_size=64, num_layers=2, num_heads=1),
       "resampler": dict(num_latents=8, depth=2, num_heads=1, head_dim=64, ff_mult=2),
       "lm": dict(num_layers=8, hidden_size=256, num_heads=2, vocab_size=VOCAB,
                  max_seq_len=128)}
ATOL = 1e-4  # tests/test_torch_models.py's logits bar


def _cut(cfg):
    """``9b`` with the widths and depths of ``CUT``; its structure kept."""
    return cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v) for k, v in CUT.items()})


def _jax_params(jmodel, seed):
    ids = jnp.ones((1, 8), jnp.int32).at[0, 1].set(MEDIA)
    params = jmodel.init(jax.random.PRNGKey(seed), ids,
                         vision_x=jnp.zeros((1, 1, 28, 28, 3), jnp.float32),
                         q_media=j_compute_q_media(ids, MEDIA))["params"]
    params = jax.tree_util.tree_map(lambda x: x, params)
    for key in params:
        if key.startswith("xattn_"):
            params[key]["attn_gate"] = jnp.asarray(1.0)
            params[key]["ff_gate"] = jnp.asarray(1.0)
    return params


@pytest.fixture(scope="module")
def pair():
    """(jax model, its params, flat numpy tree, port config)."""
    jcfg, cfg = _cut(j_get_config("9b", dtype="float32")), _cut(get_config("9b", dtype="float32"))
    assert (cfg.lm.positions, cfg.lm.tie_embeddings, cfg.cross_attn_every_n,
            cfg.lm.hidden_size // cfg.lm.num_heads) == ("alibi", True, 4, 128)
    jmodel = JModel(jcfg)
    params = _jax_params(jmodel, 0)
    flat = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
    return jmodel, params, flat, cfg


def _prompts(b=2, t=24, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, VOCAB, size=(b, t)).astype(np.int32)
    seq_len = np.array([t, t - 5][:b], np.int32)
    ids[:, 1] = ids[:, 9] = MEDIA
    for r in range(b):
        ids[r, seq_len[r]:] = 0
    vision = rng.normal(size=(b, 2, 28, 28, 3)).astype(np.float32)
    return ids, seq_len, vision


def test_9b_alias_resolves_to_9b():
    args = argparse.Namespace(
        pretrained_model_name_or_path="openflamingo/OpenFlamingo-9B-vitl-mpt7b")
    assert variant_name(args) == j_variant_name(args) == "9b"


def test_9b_logits_match_jax(pair):
    jmodel, params, flat, cfg = pair
    model = build_model(cfg, device="cpu", weights=flat)
    ids, _, vision = _prompts()
    want, _ = jmodel.apply({"params": params}, jnp.asarray(ids), vision_x=jnp.asarray(vision),
                           q_media=j_compute_q_media(jnp.asarray(ids), MEDIA))
    t_ids = torch.from_numpy(ids).long()
    with torch.no_grad():
        got, _ = model(t_ids, vision_x=torch.from_numpy(vision),
                       q_media=compute_q_media(t_ids, MEDIA))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_9b_beam_tokens_match_jax(pair):
    jmodel, params, flat, cfg = pair
    model = build_model(cfg, device="cpu", weights=flat)
    ids, seq_len, vision = _prompts()
    gen_kw = dict(max_new_tokens=6, eos_id=3, pad_id=0, num_beams=10, num_return_sequences=10)
    jlat = jmodel.apply({"params": params}, jnp.asarray(vision), method=JModel.encode_vision)
    jtok, jscores = JGenerator(jmodel, JGenerationConfig(**gen_kw), media_id=MEDIA).generate(
        params, jnp.asarray(ids), jnp.asarray(seq_len), jlat)
    with torch.no_grad():
        lat = model.encode_vision(torch.from_numpy(vision))
    tok, scores = Generator(model, GenerationConfig(**gen_kw), media_id=MEDIA).generate(
        torch.from_numpy(ids).long(), torch.from_numpy(seq_len).long(), lat)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), atol=1e-4, rtol=1e-4)


def test_9b_trainer_step_matches_jax(pair):
    """One step (accum 2) held as ``test_trainer_step_matches_jax`` holds
    the debug model's: loss within 1e-5 relative, each gradient within
    1e-4 of its largest entry, the step's metrics within 1e-5."""
    jmodel, params, flat, cfg = pair
    ids = dict(media_id=MEDIA, answer_id=ANSWER, endofchunk_id=EOC, pad_id=PAD, gamma=2.0,
               use_reweight=True)
    jt = JTrainer(jmodel, None, trainable_mask=j_trainable_mask, accum_steps=2, **ids)
    trainable, _ = partition_params(params, j_trainable_mask(params))
    jt.optimizer = j_opt.make_optimizer(trainable, learning_rate=LR)
    state = TrainState(step=jnp.int32(0), params=params, opt_state=jt.optimizer.init(trainable))
    model = build_model(cfg, device="cpu", train=True, weights=flat)
    tt = Trainer(model, make_optimizer(trainable_params(model), learning_rate=LR),
                 accum_steps=2, device="cpu", **ids)
    batch = _batch(4)
    j_loss, j_grads = _jax_grads(jt, state, batch, 2)
    loss, _ = tt.compute_grads(batch)
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-5)
    assert set(j_grads) == {n.replace(".", "/") for n in tt.params}
    for name, p in tt.params.items():
        want = np.asarray(j_grads[name.replace(".", "/")])
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    assert any(float(np.abs(j_grads[n]).max()) > 0 for n in j_grads if "xattn_4/xattn" in n)
    _, j_metrics = jt.train_step(state, batch)
    metrics = tt.train_step(batch)
    for key in ("loss", "grad_norm", "ce", "n_answer_tokens", "accuracy"):
        np.testing.assert_allclose(float(metrics[key]), float(j_metrics[key]), rtol=1e-5,
                                   err_msg=key)


def test_9b_pt_converts_as_jax(pair, tmp_path):
    """A ``.pt`` in OpenFlamingo-9B's key layout (MPT blocks with a fused
    ``Wqkv``, the tied ``wte``) at the cut widths: the port's converter
    gives the JAX converter's tree, and ``build_model`` on the file (the
    converter's function of the seeded tree) holds that tree."""
    jmodel, params, flat, cfg = pair
    sd = j_export.export_state_dict(jax.tree_util.tree_map(np.asarray, params), "mpt")
    assert any(k.endswith("attn.Wqkv.weight") for k in sd) and any(
        k.endswith("transformer.wte.weight") for k in sd)
    path = str(tmp_path / "OpenFlamingo-9B.pt")
    torch.save({"model_state_dict": {k: torch.from_numpy(np.array(v))
                                     for k, v in sd.items()}}, path)
    target = jax.tree_util.tree_map(np.asarray, _jax_params(jmodel, 1))
    want = j_convert._flatten(j_convert.load_torch_checkpoint(path, target))
    got = convert_torch.load_torch_checkpoint(path, j_convert._flatten(target))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    model = build_model(cfg, device="cpu",
                        weights=lambda seeded: convert_torch.load_torch_checkpoint(path, seeded))
    for name, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[name.replace(".", "/")]),
                                      err_msg=name)
