"""The JAX package's headline training flags in the port, on the CPU.

``--frozen_int8`` (the frozen kernels int8, ``QuantMatmulFn`` under
autograd), ``--bf16_opt_state`` (bfloat16 gradients and Adam moments) and
``--remat`` with the policies "none" and "dots", each alone and all three
together, in one ``Trainer`` step on ``debug`` in float32 from one Flax
tree (gates at 0.5; the JAX int8 tree loaded as it is), against the JAX
``Trainer`` with the same settings; the bfloat16 optimizer and
``MultiSteps`` against optax on the same gradients; and a checkpoint
round trip of int8 storage and bfloat16 moments.

Tolerances are those of ``tests/test_torch_train.py``: losses and metrics
1e-5 relative, float32 gradients 1e-4 of the tensor's largest entry, the
updated weights 1e-2 of the learning rate where |g| > 1e-5. A bfloat16
gradient is the float32 one rounded to 8 bits: where the two sides' float32
gradients straddle a rounding boundary they land one bfloat16 step apart
(2^-7 of the value at most), and each later bfloat16 rounding (the sum of
the micro-batches) can do the same, so bfloat16 gradients are held to one
step of each rounded operand on top of that, and the moments and the
bfloat16 norm to one step of their value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unimp_tpu.models import UniMPModel as JModel
from unimp_tpu.ops.quant_matmul import quant_matmul as j_quant_matmul
from unimp_tpu.train import optimizer as j_opt
from unimp_tpu.train.partition import backbone_trainable_mask as j_trainable_mask
from unimp_tpu.train.partition import merge_params, partition_params
from unimp_tpu.train.trainer import Trainer as JTrainer
from unimp_tpu.train.trainer import TrainState
from unimp_tpu_torch.models import get_config
from unimp_tpu_torch.ops.quant_matmul import QuantMatmulFn
from unimp_tpu_torch.tools.from_flax import build_model, flatten_tree, load_flax_params
from unimp_tpu_torch.train import checkpoint as ckpt
from unimp_tpu_torch.train.optimizer import MultiSteps, make_optimizer
from unimp_tpu_torch.train.partition import (apply_frozen_storage, int8_kernel_names,
                                             trainable_params)
from unimp_tpu_torch.train.trainer import Trainer
from unimp_tpu_torch.utils.quant import QuantizedKernel, count_quantized

from test_torch_train import ANSWER, EOC, LR, MEDIA, PAD, _batch, _jax_debug

torch.set_num_threads(2)  # six test workers share the cores
BF16_STEP = 2.0 ** -7  # one step of bfloat16's 8-bit significand, at most
IDS = dict(media_id=MEDIA, answer_id=ANSWER, endofchunk_id=EOC, pad_id=PAD, gamma=2.0,
           use_reweight=True)


def _jflat(tree) -> dict:
    """{flat path: numpy} of a JAX tree, an int8 kernel as its q / scale."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): np.asarray(v)
            for path, v in leaves if v is not None}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_matmul_fn_grad_matches_jax(dtype):
    """dx of ``QuantMatmulFn`` against ``jax.grad`` through the JAX custom
    VJP (the Pallas kernel in interpret mode); q and scale get none."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 96)).astype(np.float32)
    q = rng.integers(-127, 128, size=(96, 40)).astype(np.int8)
    scale = rng.uniform(1e-3, 2e-2, size=40).astype(np.float32)
    w = rng.normal(size=(2, 5, 40)).astype(np.float32)
    jdt = jnp.dtype(dtype)

    def j_loss(xx):
        out = j_quant_matmul(xx, jnp.asarray(q), jnp.asarray(scale), interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(w))

    want = np.asarray(jax.grad(j_loss)(jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    qt, st = torch.from_numpy(q), torch.from_numpy(scale)
    out = QuantMatmulFn.apply(xt, qt, st)
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert xt.grad.dtype == tdt
    got = xt.grad.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_STEP, atol=0)


def _setup(frozen_int8=False, bf16=False, remat=None, accum=1):
    """(JAX trainer, its state, the port's trainer) from one Flax tree."""
    jmodel, params, _ = _jax_debug()
    if remat is not None:
        jmodel = JModel(dataclasses.replace(jmodel.cfg, remat=True, remat_policy=remat))
    jt = JTrainer(jmodel, None, trainable_mask=j_trainable_mask, accum_steps=accum,
                  frozen_dtype="int8" if frozen_int8 else None,
                  grad_dtype="bfloat16" if bf16 else None, **IDS)
    trainable, frozen = partition_params(params, j_trainable_mask(params))
    if frozen_int8:
        frozen = jt._apply_frozen_dtype(frozen)
    moments = "bfloat16" if bf16 else None
    jt.optimizer = j_opt.make_optimizer(trainable, learning_rate=LR, mu_dtype=moments,
                                        nu_dtype=moments)
    state = TrainState(step=jnp.int32(0), params=merge_params(trainable, frozen),
                       opt_state=jt.optimizer.init(trainable))

    cfg = get_config("debug", dtype="float32")
    if remat is not None:
        cfg = cfg.replace(remat=True, remat_policy=remat)
    weights = _jflat(state.params)
    model = build_model(cfg, device="cpu", train=True, weights=weights,
                        frozen_dtype="int8" if frozen_int8 else None)
    # the LM's mlp kernels have 2^16 entries: int8 in both trees
    assert count_quantized(model) == sum(p.endswith("kernel/q") for p in weights) == \
        (6 if frozen_int8 else 0)
    tt = Trainer(model, make_optimizer(trainable_params(model), learning_rate=LR,
                                       moment_dtype=torch.bfloat16 if bf16 else None),
                 accum_steps=accum, device="cpu", grad_dtype=torch.bfloat16 if bf16 else None,
                 **IDS)
    return jt, state, tt


def _grads_close(got, want, name, operands=None):
    """float32: 1e-4 of the largest entry; bfloat16 (``operands``: the
    micro-batch mean of |g_i| before the sum): one step of each rounded
    operand and of the result on top of that."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = 1e-4 * max(float(np.abs(want).max()), 1e-30)
    if operands is not None:
        atol = atol + BF16_STEP * (np.asarray(operands, np.float64) + np.abs(want))
    assert np.all(np.abs(got - want) <= atol), (name, float(np.max(np.abs(got - want) - atol)))
    return atol


FLAGS = {
    "int8": dict(frozen_int8=True),
    "bf16": dict(bf16=True, accum=2),
    "remat_none": dict(remat="none"),
    "remat_dots": dict(remat="dots"),
    "all_accum1": dict(frozen_int8=True, bf16=True, remat="dots"),
    "all_accum2": dict(frozen_int8=True, bf16=True, remat="dots", accum=2),
}


@pytest.mark.parametrize("flags", list(FLAGS))
def test_trainer_step_with_flags_matches_jax(flags):
    kw = FLAGS[flags]
    bf16 = kw.get("bf16", False)
    batch = _batch(4)
    jt, state, tt = _setup(**kw)
    frozen_before = {n: t.clone() for n, t in tt.model.state_dict().items()
                     if n not in tt.params}

    # the JAX step's gradients, rounded and summed as its step does them
    mask = jt.resolve_mask(state.params)
    t_params, f_params = partition_params(state.params, mask)
    accum = kw.get("accum", 1)
    n = batch["input_ids"].shape[0] // accum
    gsum, gabs = None, None
    for i in range(accum):
        mb = {k: jnp.asarray(v[i * n:(i + 1) * n]) for k, v in batch.items()}
        g = jax.grad(lambda t: jt._loss_fn(merge_params(t, f_params), mb)[0])(t_params)
        if bf16:
            g = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), g)
        a = jax.tree_util.tree_map(lambda x: jnp.abs(x.astype(jnp.float32)) / accum, g)
        gsum = g if gsum is None else jax.tree_util.tree_map(jnp.add, gsum, g)
        gabs = a if gabs is None else jax.tree_util.tree_map(jnp.add, gabs, a)
    j_grads = _jflat(jax.tree_util.tree_map(lambda a: (a * (1.0 / accum)).astype(a.dtype), gsum))
    j_abs = _jflat(gabs)
    new_state, j_metrics = jt.train_step(state, batch)
    loss, _ = tt.compute_grads(batch)
    np.testing.assert_allclose(float(loss), float(j_metrics["loss"]), rtol=1e-5)
    grads = tt.optimizer.named_grads()
    assert set(j_grads) == {n.replace(".", "/") for n in tt.params}
    allow = {}
    for name, g in grads.items():
        assert g.dtype == (torch.bfloat16 if bf16 else torch.float32), name
        path = name.replace(".", "/")
        allow[path] = _grads_close(g.float().numpy(), j_grads[path].astype(np.float32), name,
                                   j_abs[path] if bf16 else None)

    metrics = tt.train_step(batch)
    for key in ("loss", "ce", "n_answer_tokens", "accuracy"):
        np.testing.assert_allclose(float(metrics[key]), float(j_metrics[key]), rtol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(j_metrics["grad_norm"]),
                               rtol=BF16_STEP if bf16 else 1e-5)
    assert metrics["grad_norm"].dtype == (torch.bfloat16 if bf16 else torch.float32)
    j_params = _jflat(new_state.params)
    for name, p in tt.params.items():
        path = name.replace(".", "/")
        got, want = p.detach().numpy(), j_params[path]
        sure = np.abs(j_grads[path].astype(np.float32)) > 1e-5
        np.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=1e-2 * LR, err_msg=name)
        np.testing.assert_allclose(got, want, rtol=0, atol=2.01 * LR, err_msg=name)
    if bf16:
        # first moments: (1 - b1) * c * g, second: (1 - b2) * (c * g)^2,
        # c the clip factor; each held to what the gradient's allowance
        # gives it, plus one step for the clipped gradient's rounding and
        # one for the moment's own
        norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in j_grads.values()))
        c = min(1.0, 1.0 / norm)
        j_adam = new_state.opt_state[1]
        for which, mom in (("mu", tt.optimizer.mu), ("nu", tt.optimizer.nu)):
            want = _jflat(getattr(j_adam, which))
            for name, m in mom.items():
                assert m.dtype == torch.bfloat16, name
                path = name.replace(".", "/")
                w = want[path].astype(np.float64)
                g, a = np.abs(j_grads[path].astype(np.float64)) * c, allow[path] * c
                bound = 0.1 * a if which == "mu" else 1e-3 * (2 * g + a) * a
                bound = bound + 2 * BF16_STEP * np.abs(w)
                diff = np.abs(m.double().numpy() - w)
                assert np.all(diff <= bound), (which, name, float(np.max(diff - bound)))
    for name, t in tt.model.state_dict().items():
        if name in frozen_before:
            assert torch.equal(t, frozen_before[name]), name


def _grad_list(model, batch, **kw):
    tt = Trainer(model, make_optimizer(trainable_params(model), learning_rate=LR),
                 device="cpu", **IDS, **kw)
    tt.compute_grads(batch)
    return {n: p.grad.clone() for n, p in tt.params.items()}


@pytest.mark.parametrize("policy", ["none", "dots"])
def test_remat_gives_the_same_gradients(policy):
    """Checkpointed blocks recompute the same forward, so the gradients
    equal the ones without remat bit for bit (the int8 backbone too)."""
    _, params, flat = _jax_debug()
    batch = _batch(2)
    cfg = get_config("debug", dtype="float32")
    plain = build_model(cfg, device="cpu", train=True, weights=flat, frozen_dtype="int8")
    remat = build_model(cfg.replace(remat=True, remat_policy=policy), device="cpu", train=True,
                        weights=flat, frozen_dtype="int8")
    want, got = _grad_list(plain, batch), _grad_list(remat, batch)
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_bf16_optimizer_matches_optax():
    """``ClippedAdamWCast`` (bfloat16 moments, float32 arithmetic, the
    float32 clip) over three steps on the same bfloat16 gradients as the
    JAX optimizer; then ``MultiSteps`` over it against ``optax.MultiSteps``
    over two updates of two gradients each, its mean kept in float32 as
    optax keeps it."""
    rng = np.random.default_rng(1)
    shapes = {"xattn_0/xattn/q_proj/kernel": (8, 2, 4), "xattn_0/attn_gate": (),
              "embed/embedding": (16, 8)}
    init = {k: np.asarray(rng.normal(size=s), np.float32) for k, s in shapes.items()}
    steps = [{k: np.asarray(rng.normal(size=s) * (3.0 if i == 1 else 0.2), np.float32)
              for k, s in shapes.items()} for i in range(4)]

    def nest(flat):
        out = {}
        for path, v in flat.items():
            *head, leaf = path.split("/")
            node = out
            for h in head:
                node = node.setdefault(h, {})
            node[leaf] = v
        return out

    for multi in (False, True):
        tree = nest({k: jnp.asarray(v) for k, v in init.items()})
        jopt = j_opt.make_optimizer(tree, learning_rate=LR, lr_scheduler="linear",
                                    total_steps=5, mu_dtype="bfloat16", nu_dtype="bfloat16")
        if multi:
            jopt = optax.MultiSteps(jopt, 2)
        jstate = jopt.init(tree)
        params = {k.replace("/", "."): torch.nn.Parameter(torch.from_numpy(v.copy()))
                  for k, v in init.items()}
        opt = make_optimizer(params, learning_rate=LR, lr_scheduler="linear", total_steps=5,
                             moment_dtype=torch.bfloat16)
        if multi:
            opt = MultiSteps(opt, 2)
        for g in steps[:4 if multi else 3]:
            jg = nest({k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in g.items()})
            upd, jstate = jopt.update(jg, jstate, tree)
            tree = optax.apply_updates(tree, upd)
            opt.set_grads({k.replace("/", "."): torch.from_numpy(v).bfloat16()
                           for k, v in g.items()})
            opt.step(opt.grad_norm())
        got = {k.replace(".", "/"): p.detach().numpy() for k, p in params.items()}
        for path, want in flatten_tree(tree).items():
            np.testing.assert_allclose(got[path], np.asarray(want), rtol=1e-6, atol=1e-7,
                                       err_msg=path)
        inner = opt.inner if multi else opt
        j_adam = (jstate.inner_opt_state if multi else jstate)[1]
        for which in ("mu", "nu"):
            for path, want in flatten_tree(getattr(j_adam, which)).items():
                m = getattr(inner, which)[path.replace("/", ".")]
                assert m.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
                np.testing.assert_array_equal(m.float().numpy(),
                                              np.asarray(want.astype(jnp.float32)))
        if multi:
            for path, acc in flatten_tree(jstate.acc_grads).items():
                assert acc.dtype == jnp.float32
                assert opt.acc[path.replace("/", ".")].dtype == torch.float32


def test_int8_bf16_checkpoint_round_trip(tmp_path):
    """A ``checkpoint_{e}`` of an int8-frozen, bfloat16-moment run is a
    float tree; restored as the CLI restores it (the load, then the int8
    storage again, then the optimizer), the trainable weights, both
    bfloat16 moments and every int8 payload come back bit for bit, and
    each scale within one float32 rounding (127 * scale / 127)."""
    _, state, tt = _setup(frozen_int8=True, bf16=True, accum=2)
    tt.train_step(_batch(4))
    ckpt.save_train_state(str(tmp_path), tt, 0)
    restored = ckpt.restore_params(str(tmp_path), "checkpoint_0")
    assert all(t.is_floating_point() for t in restored.values())
    assert not any(p.endswith(("kernel/q", "kernel/scale")) for p in restored)

    _, _, back = _setup(frozen_int8=True, bf16=True, accum=2)
    int8 = int8_kernel_names(back.model)
    load_flax_params(back.model, restored)
    apply_frozen_storage(back.model, int8)
    back.optimizer.load_state_dict(ckpt.restore_train_state(str(tmp_path), "checkpoint_0")
                                   ["opt_state"])
    assert count_quantized(back.model) == count_quantized(tt.model) == 6
    assert set(back.params) == set(tt.params)
    for name, p in tt.params.items():
        assert torch.equal(back.params[name].detach(), p.detach()), name
    for which in ("mu", "nu"):
        for name, m in getattr(tt.optimizer, which).items():
            other = getattr(back.optimizer, which)[name]
            assert other.dtype == torch.bfloat16 and torch.equal(other, m), (which, name)
    assert back.optimizer.count == tt.optimizer.count == 1
    mods = dict(back.model.named_modules())
    for name, mod in tt.model.named_modules():
        if isinstance(mod, QuantizedKernel) and mod.persistent:
            other = mods[name]
            assert isinstance(other, QuantizedKernel), name
            assert torch.equal(other.q, mod.q), name
            np.testing.assert_allclose(other.scale.numpy(), mod.scale.numpy(), rtol=2 ** -23,
                                       atol=0, err_msg=name)
    for name, p in back.model.named_parameters():
        assert p.requires_grad == (name in back.params), name


def test_int8_alibi_decode_hands_the_kernel_a_dense_query(monkeypatch):
    """An ALiBi model (no rotary copy) with int8 q / k / v fused for decode:
    the decode attention gets q as a dense tensor, as the CUDA wrapper
    requires (a view into the fused output raised on the card)."""
    from unimp_tpu_torch.models import layers
    from unimp_tpu_torch.utils.quant import quantize_params_int8

    cfg = get_config("debug", dtype="float32")
    cfg = cfg.replace(lm=dataclasses.replace(cfg.lm, positions="alibi"))
    model = build_model(cfg, device="cpu", seed=0).eval()
    quantize_params_int8(model, min_size=1, dtype=torch.float32)
    assert all(b.attn.qkv_int8 is not None for b, _ in model._layers())
    seen = []
    orig = layers.decode_attention

    def spy(q, *args, **kw):
        seen.append(q.is_contiguous())
        return orig(q, *args, **kw)

    monkeypatch.setattr(layers, "decode_attention", spy)
    from unimp_tpu_torch.decode import GenerationConfig, Generator

    ids = torch.from_numpy(_batch(2)["input_ids"][:, :12]).long()
    ids[ids == MEDIA] = 11
    Generator(model, GenerationConfig(max_new_tokens=3, eos_id=0, pad_id=PAD, num_beams=2,
                                      num_return_sequences=2), MEDIA).generate(
        ids, torch.full((2,), 12))
    assert seen and all(seen)
