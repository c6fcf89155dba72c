"""The port's training modules against the JAX package, on the CPU.

Labels, loss, freezing and decay masks, schedules, the optimizer, and one
``Trainer`` step on ``debug`` in float32 from one Flax tree (gates at 0.5),
all on the same seeded numpy inputs as the JAX package's counterparts.
Batches are built from numpy: no tokenizer, no PIL. Small enough for
the quick lane.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unimp_tpu.data.masking import answer_span_labels as j_answer_span_labels
from unimp_tpu.data.masking import answer_span_labels_reference
from unimp_tpu.data.transforms import normalize_on_device as j_normalize
from unimp_tpu.models import UniMPModel as JModel
from unimp_tpu.models import compute_q_media as j_compute_q_media
from unimp_tpu.models import get_config as j_get_config
from unimp_tpu.train import optimizer as j_opt
from unimp_tpu.train.loss import masked_focal_loss as j_masked_focal_loss
from unimp_tpu.train.partition import backbone_trainable_mask as j_trainable_mask
from unimp_tpu.train.partition import merge_params, partition_params
from unimp_tpu.train.trainer import TrainState
from unimp_tpu.train.trainer import Trainer as JTrainer
from unimp_tpu.utils import flops as j_flops
from unimp_tpu_torch.data.masking import IGNORE, answer_span_labels
from unimp_tpu_torch.data.transforms import normalize_on_device
from unimp_tpu_torch.models import get_config
from unimp_tpu_torch.tools.from_flax import build_model, flatten_tree, load_flax_params
from unimp_tpu_torch.train.loss import masked_focal_loss
from unimp_tpu_torch.train.optimizer import decay_mask, make_optimizer, make_schedule
from unimp_tpu_torch.train.partition import backbone_trainable_mask, trainable_params
from unimp_tpu_torch.train.trainer import Trainer
from unimp_tpu_torch.utils import flops

torch.set_num_threads(2)  # six test workers share the cores
PAD, MEDIA, ANSWER, EOC = 0, 7, 8, 9
VOCAB = 512  # debug
LR = 1e-3


def _ids(rng, b, t):
    """Token ids with media, answer spans (some unclosed, one stray eoc)
    and right padding."""
    ids = rng.integers(10, VOCAB, size=(b, t))
    for r in range(b):
        n = rng.integers(t // 2, t + 1)
        for name, tok in (("m", MEDIA), ("a", ANSWER), ("e", EOC), ("a2", ANSWER)):
            ids[r, rng.integers(0, n)] = tok
        ids[r, n:] = PAD
    return ids.astype(np.int32)


def test_answer_span_labels_match_jax():
    rng = np.random.default_rng(0)
    ids = _ids(rng, 16, 40)
    got = answer_span_labels(torch.from_numpy(ids), ANSWER, EOC, MEDIA, PAD).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_answer_span_labels(
        jnp.asarray(ids), ANSWER, EOC, MEDIA, PAD)))
    np.testing.assert_array_equal(got, answer_span_labels_reference(ids, ANSWER, EOC, MEDIA, PAD))
    assert (got != IGNORE).any() and (got == IGNORE).any()


def test_normalize_on_device_matches_jax():
    x = np.random.default_rng(1).integers(0, 256, size=(2, 3, 5, 5, 3), dtype=np.uint8)
    got = normalize_on_device(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_normalize(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    assert normalize_on_device(torch.from_numpy(x), torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("use_reweight", [False, True])
def test_masked_focal_loss_matches_jax(use_reweight):
    rng = np.random.default_rng(2)
    b, t, v = 3, 12, 50
    logits = rng.normal(size=(b, t, v)).astype(np.float32) * 3
    labels = rng.integers(0, v, size=(b, t))
    labels[rng.random((b, t)) < 0.5] = IGNORE
    weights = rng.uniform(0.5, 2.0, size=b).astype(np.float32)

    def j_loss(lg):
        return j_masked_focal_loss(lg, jnp.asarray(labels), jnp.asarray(weights), 2.0,
                                   use_reweight)

    (j_l, j_aux), j_g = jax.value_and_grad(j_loss, has_aux=True)(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    loss, aux = masked_focal_loss(tl, torch.from_numpy(labels), torch.from_numpy(weights),
                                  2.0, use_reweight)
    (g,) = torch.autograd.grad(loss, tl)
    np.testing.assert_allclose(loss.item(), float(j_l), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(j_g), rtol=1e-5, atol=1e-7)
    for key in ("ce", "n_answer_tokens", "accuracy"):
        np.testing.assert_allclose(float(aux[key]), float(j_aux[key]), rtol=1e-6)


_CACHE = {}


def _jax_debug():
    """(jax model, its Flax params with gates at 0.5, flat numpy tree)."""
    if "debug" not in _CACHE:
        jcfg = j_get_config("debug", dtype="float32")
        jmodel = JModel(jcfg)
        ids = jnp.asarray(_ids(np.random.default_rng(3), 1, 8))
        vision = jnp.zeros((1, 1, 28, 28, 3), jnp.float32)
        params = jmodel.init(jax.random.PRNGKey(0), ids, vision_x=vision,
                             q_media=j_compute_q_media(ids, MEDIA))["params"]
        params = jax.tree_util.tree_map(lambda x: x, params)
        for key in params:
            if key.startswith("xattn_"):
                params[key]["attn_gate"] = jnp.asarray(0.5)
                params[key]["ff_gate"] = jnp.asarray(0.5)
        flat = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
        _CACHE["debug"] = (jmodel, params, flat)
    return _CACHE["debug"]


def _true_paths(mask_tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(mask_tree)
    return {"/".join(p.key for p in kp) for kp, val in flat if val}


def test_trainable_and_decay_masks_match_jax():
    _, params, flat = _jax_debug()
    model = build_model(get_config("debug", dtype="float32"), device="cpu", train=True)
    tmask = backbone_trainable_mask(model)
    assert {n.replace(".", "/") for n, m in tmask.items() if m} == _true_paths(
        j_trainable_mask(params))
    named = dict(model.named_parameters())
    assert {n.replace(".", "/") for n, m in decay_mask(named).items() if m} == _true_paths(
        j_opt.decay_mask(params))
    assert {n for n, p in named.items() if p.requires_grad} == {n for n, m in tmask.items() if m}
    assert set(trainable_params(model)) == {n for n, m in tmask.items() if m}


@pytest.mark.parametrize("kind", ["linear", "cosine", "constant"])
def test_schedule_matches_optax(kind):
    """Step by step the optax values; optax computes in float32, so the
    values agree to float32 rounding of the base rate."""
    lr = 3e-4
    for total, warmup in ((20, 4), (12, 0)):
        mine = make_schedule(kind, lr, total, warmup)
        theirs = j_opt.make_schedule(kind, lr, total, warmup)
        for step in range(total + 5):
            np.testing.assert_allclose(mine(step), float(theirs(step)), rtol=1e-6, atol=1e-6 * lr)


def test_optimizer_matches_optax_over_three_steps():
    """The same gradients into the JAX make_optimizer (optax) and the
    port's: decay on xattn matrices only, clipping active, warmup."""
    rng = np.random.default_rng(4)
    shapes = {"xattn_0/xattn/q_proj/kernel": (8, 2, 4), "xattn_0/attn_gate": (),
              "xattn_0/ln_ff/scale": (8,), "embed/embedding": (16, 8),
              "resampler/block_0/mlp/up/kernel": (8, 6)}
    flat = {k: np.asarray(rng.normal(size=s), np.float32) for k, s in shapes.items()}
    tree = {}
    for path, val in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(val)
    kw = dict(learning_rate=1e-2, lr_scheduler="linear", total_steps=10, warmup_steps=1)
    j_tx = j_opt.make_optimizer(tree, **kw)
    j_state = j_tx.init(tree)
    params = {k.replace("/", "."): torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in flat.items()}
    opt = make_optimizer(params, **kw)
    for step in range(3):
        grads = {k: np.asarray(rng.normal(size=s) * 3, np.float32) for k, s in shapes.items()}
        j_grads = jax.tree_util.tree_map(lambda x: x, tree)
        for path, g in grads.items():
            node = j_grads
            *parents, leaf = path.split("/")
            for p in parents:
                node = node[p]
            node[leaf] = jnp.asarray(g)
        updates, j_state = j_tx.update(j_grads, j_state, tree)
        tree = optax.apply_updates(tree, updates)
        for k, g in grads.items():
            params[k.replace("/", ".")].grad = torch.from_numpy(g)
        gnorm = opt.grad_norm()
        np.testing.assert_allclose(float(gnorm), float(optax.global_norm(j_grads)), rtol=1e-6)
        opt.step(gnorm)
    got = {k.replace(".", "/"): p.detach().numpy() for k, p in params.items()}
    for path, want in flatten_tree(tree).items():
        np.testing.assert_allclose(got[path], np.asarray(want), rtol=1e-6, atol=1e-6)


def _batch(b, seed=5):
    """A rec-shaped debug batch: text, 2 <image> tokens, an answer span,
    right padding; uint8 images."""
    rng = np.random.default_rng(seed)
    t = 24
    ids = rng.integers(10, VOCAB, size=(b, t)).astype(np.int32)
    seq_len = rng.integers(19, t + 1, size=b).astype(np.int32)
    for r in range(b):
        ids[r, 2] = ids[r, 9] = MEDIA
        ids[r, 14] = ANSWER
        ids[r, 18] = EOC
        ids[r, seq_len[r]:] = PAD
    return {"input_ids": ids, "seq_len": seq_len,
            "weights": rng.uniform(0.5, 1.5, size=b).astype(np.float32),
            "images": rng.integers(0, 256, size=(b, 2, 28, 28, 3), dtype=np.uint8)}


def _trainers(accum, lr=LR):
    jmodel, params, flat = _jax_debug()
    ids = dict(media_id=MEDIA, answer_id=ANSWER, endofchunk_id=EOC, pad_id=PAD,
               gamma=2.0, use_reweight=True)
    jt = JTrainer(jmodel, None, trainable_mask=j_trainable_mask, accum_steps=accum, **ids)
    mask = j_trainable_mask(params)
    trainable, _ = partition_params(params, mask)
    jt.optimizer = j_opt.make_optimizer(trainable, learning_rate=lr)
    state = TrainState(step=jnp.int32(0), params=params, opt_state=jt.optimizer.init(trainable))
    model = build_model(get_config("debug", dtype="float32"), device="cpu", train=True)
    load_flax_params(model, flat)
    tt = Trainer(model, make_optimizer(trainable_params(model), learning_rate=lr),
                 accum_steps=accum, device="cpu", **ids)
    return jt, state, tt


def _jax_grads(jt, state, batch, accum):
    """Mean over micro-batches of the JAX trainer's own loss gradients."""
    mask = jt.resolve_mask(state.params)
    t_params, f_params = partition_params(state.params, mask)
    grad_fn = jax.value_and_grad(
        lambda t, mb: jt._loss_fn(merge_params(t, f_params), mb), has_aux=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    n = batch["input_ids"].shape[0] // accum
    outs = [grad_fn(t_params, {k: v[i * n:(i + 1) * n] for k, v in jb.items()})
            for i in range(accum)]
    loss = sum(o[0][0] for o in outs) / accum
    grads = jax.tree_util.tree_map(lambda *g: sum(g) / accum, *[o[1] for o in outs])
    return float(loss), {k: v for k, v in flatten_tree(grads).items() if v is not None}


@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_step_matches_jax(accum):
    batch = _batch(4)
    jt, state, tt = _trainers(accum)
    frozen_before = {n: p.detach().clone() for n, p in tt.model.named_parameters()
                     if not p.requires_grad}

    j_loss, j_grads = _jax_grads(jt, state, batch, accum)
    loss, _ = tt.compute_grads(batch)
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-5)
    assert set(j_grads) == {n.replace(".", "/") for n in tt.params}
    for name, p in tt.params.items():
        want = np.asarray(j_grads[name.replace(".", "/")])
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    assert any(float(np.abs(j_grads[n]).max()) > 0 for n in j_grads if "xattn_0/xattn" in n)

    new_state, j_metrics = jt.train_step(state, batch)
    metrics = tt.train_step(batch)
    for key in ("loss", "grad_norm", "ce", "n_answer_tokens", "accuracy"):
        np.testing.assert_allclose(float(metrics[key]), float(j_metrics[key]), rtol=1e-5,
                                   err_msg=key)
    assert int(metrics["skipped_nonfinite"]) == int(j_metrics["skipped_nonfinite"]) == 0
    # Adam's first step moves each entry by lr * g / (|g| + eps): where |g|
    # is within a few hundred eps of 0, gradients that differ by float32
    # rounding move it differently. Entries with |g| > 1e-5 agree to 1% of
    # lr; every entry moved by at most lr (plus the decay) on both sides.
    j_params = flatten_tree(new_state.params)
    for name, p in tt.params.items():
        path = name.replace(".", "/")
        got, want = p.detach().numpy(), np.asarray(j_params[path])
        sure = np.abs(np.asarray(j_grads[path])) > 1e-5
        np.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=1e-2 * LR, err_msg=name)
        np.testing.assert_allclose(got, want, rtol=0, atol=2.01 * LR, err_msg=name)
    for name, p in tt.model.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p.detach(), frozen_before[name]), name


def test_nonfinite_step_is_skipped():
    """A NaN-poisoned batch leaves params, both moments, the step count
    and the schedule where they were."""
    _, _, tt = _trainers(1)
    tt.train_step(_batch(2))
    opt = tt.optimizer
    before = {n: p.detach().clone() for n, p in tt.params.items()}
    state = {n: {k: v.clone() for k, v in opt.adamw.state[p].items()}
             for n, p in tt.params.items()}
    lr, epoch = opt.scheduler.get_last_lr(), opt.scheduler.last_epoch
    bad = _batch(2, seed=6)
    bad["weights"][0] = np.nan
    metrics = tt.train_step(bad)
    assert int(metrics["skipped_nonfinite"]) == 1
    assert not np.isfinite(float(metrics["loss"]))
    for n, p in tt.params.items():
        assert torch.equal(p.detach(), before[n]), n
        for k, v in opt.adamw.state[p].items():
            assert torch.equal(v, state[n][k]), (n, k)
    assert opt.scheduler.get_last_lr() == lr and opt.scheduler.last_epoch == epoch
    assert int(tt.train_step(_batch(2))["skipped_nonfinite"]) == 0


def test_mask_lm_head_keeps_only_the_answer_row():
    _, _, tt = _trainers(1)
    tt.mask_lm_head = True
    tt.compute_grads(_batch(2))
    g = tt.params["embed.embedding"].grad
    assert torch.count_nonzero(g[ANSWER]) > 0
    assert torch.count_nonzero(torch.cat([g[:ANSWER], g[ANSWER + 1:]])) == 0


@pytest.mark.parametrize("name", ["debug", "4b-instruct"])
def test_train_step_flops_match_jax(name):
    tcfg, jcfg = get_config(name), j_get_config(name)
    for frozen in (False, True):
        assert flops.train_step_flops(tcfg, 6, 256, 6, frozen_backbone=frozen) == \
            j_flops.train_step_flops(jcfg, 6, 256, 6, frozen_backbone=frozen)
    wide = dataclasses.replace(tcfg.lm, vocab_size=54656)
    assert flops.train_step_flops(tcfg.replace(lm=wide), 6, 256, 6, True) > \
        flops.train_step_flops(tcfg, 6, 256, 6, True)
