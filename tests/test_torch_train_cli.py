"""The port's training entry point against the JAX package's, on the CPU.

One ``debug`` float32 run of the JAX ``mmrec.main`` and one of the port's,
from the same weights (the JAX init, carried across by
``tools/from_flax.py``) and the same files (the synth writer, seed 0):
cached vision, micro-batch 2 with ``MultiSteps`` over 2, an eval and a
test pass, 8 train users. Against them: the loader's epochs, the
multi-task dataset, the vision tower cache, a cached ``Trainer`` step,
``MultiSteps`` with a non-finite micro-batch, the per-step losses and the
final weights, the files the run writes, resume, the reload eval (float
and int8), the other tasks' runs (exp, search, the curriculum, the default
multi-task list) and the flags that are not ported. Tolerances are those of
``tests/test_torch_train.py``: losses 1e-5 relative, gradients and weights
5e-4 of the tensor's largest entry.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unimp_tpu.cli import common as j_common
from unimp_tpu.cli import mmrec as j_mmrec
from unimp_tpu.data.dataset import TaskDataset as JTaskDataset
from unimp_tpu.data.loader import DataLoader as JDataLoader
from unimp_tpu.data.transforms import normalize_on_device as j_norm
from unimp_tpu.evals import evaluators as j_evaluators
from unimp_tpu.models import UniMPModel as JModel
from unimp_tpu.tools import synth_data as j_synth
from unimp_tpu.train import optimizer as j_opt
from unimp_tpu.train.trainer import Trainer as JTrainer
from unimp_tpu.train.vision_cache import build_tower_cache as j_build_tower_cache
from unimp_tpu.utils.inference import cast_params_for_inference as j_cast
from unimp_tpu.utils.quant import quantize_params_int8 as j_quantize
from unimp_tpu_torch.cli import common, mmrec, mmrec_eval
from unimp_tpu_torch.data.dataset import TaskDataset
from unimp_tpu_torch.data.loader import DataLoader, prefetch_to_device
from unimp_tpu_torch.data.transforms import normalize_on_device
from unimp_tpu_torch.evals import evaluators
from unimp_tpu_torch.models import get_config
from unimp_tpu_torch.parallel.mesh import set_mesh
from unimp_tpu_torch.parallel.seq_shard import get_sequence_sharding, set_sequence_sharding
from unimp_tpu_torch.tools import synth_data
from unimp_tpu_torch.tools.from_flax import build_model, flatten_tree
from unimp_tpu_torch.train import checkpoint as ckpt
from unimp_tpu_torch.train.optimizer import MultiSteps, make_optimizer
from unimp_tpu_torch.train.partition import trainable_params
from unimp_tpu_torch.train.trainer import Trainer
from unimp_tpu_torch.train.vision_cache import build_tower_cache
from unimp_tpu_torch.utils.profiling import maybe_trace
from unimp_tpu_torch.utils.quant import QuantizedKernel

torch.set_num_threads(2)  # six test workers share the cores
N_ITEMS = 40
LOSS_RTOL = 1e-5
REL = 5e-4


def _argv(data, runs, run_name="cli", *extra):
    return ["--mmrec_path", data, "--external_save_dir", runs, "--run_name", run_name,
            "--pretrained_model_name_or_path", "debug", "--subset", "beauty", "--task", "rec",
            "--single_task", "--n_items", str(N_ITEMS), "--history_len", "5",
            "--patch-image-size", "28", "--batch_size", "2", "--gradient_accumulation_steps",
            "2", "--eval_batch_size", "4", "--num_epochs", "1", "--logging_steps", "1",
            "--warmup_steps", "0", "--workers", "0", "--num_beams", "3", "--max_records", "8",
            "--precision", "fp32", "--use_reweight", *extra]


RUN_FLAGS = ("--cache_vision_latents", "--do_eval", "--do_test")


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _flat(params) -> dict:
    return {k: np.asarray(v) for k, v in flatten_tree(params).items() if v is not None}


def _losses(jsonl: Path) -> list:
    return [r["loss_multi_instruct"] for r in map(json.loads, jsonl.read_text().splitlines())
            if "loss_multi_instruct" in r]


def _close(got, want, name, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale, err_msg=name)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    synth_data.generate(str(d), n_items=N_ITEMS, n_users=48, image_size=28, seed=0)
    return str(d)


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """The JAX ``mmrec.main`` run on one device, as the port runs (its
    initial state and its trainer held on the side), then the port's
    ``main`` on the same argv from the JAX initial weights, with the
    answers of the port's eval and test passes."""
    root = tmp_path_factory.mktemp("runs")
    seen = {}
    orig_init, orig_step = JTrainer.init_state, JTrainer.train_step

    def init_state(self, *args, **kw):
        state = orig_init(self, *args, **kw)
        seen["state0"] = _numpy_tree(state)  # before the step donates it
        return state

    def train_step(self, state, batch):
        seen["jt"] = self
        return orig_step(self, state, batch)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTrainer, "init_state", init_state)
        mp.setattr(JTrainer, "train_step", train_step)
        mp.setattr(j_common, "build_mesh", lambda args: None)
        j_state = j_mmrec.main(_argv(data, str(root / "jax"), "cli", *RUN_FLAGS))
    init = _flat(seen["state0"].params)

    orig_build, orig_batches = common.build_model, evaluators._generate_batches
    answers = []

    def build_from_jax(args, tokenizer, **kw):
        return orig_build(args, tokenizer, **{**kw, "weights": init})

    def batches(*args, **kw):
        for rows, batch, ips in orig_batches(*args, **kw):
            answers.append(rows)
            yield rows, batch, ips

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "build_model", build_from_jax)
        mp.setattr(evaluators, "_generate_batches", batches)
        trainer, state = mmrec.main(_argv(data, str(root / "port"), "cli", *RUN_FLAGS,
                                          "--device", "cpu"))
    return dict(root=root, jt=seen["jt"], state0=seen["state0"], init=init,
                j_state=j_state, trainer=trainer, state=state, answers=answers)


@pytest.fixture(scope="module")
def tokenizers(data):
    return (j_synth.build_tokenizer(data, n_items=N_ITEMS, task="rec"),
            synth_data.build_tokenizer(data, n_items=N_ITEMS, task="rec"))


def _train_sets(data, tokenizers, task="rec", load_images=False):
    jtok, tok = tokenizers
    kw = dict(n_items=N_ITEMS, image_size=28, history_len=5, load_images=load_images,
              max_records=8)
    return (JTaskDataset(data, "beauty", task, "train", jtok, **kw),
            TaskDataset(data, "beauty", task, "train", tok, **kw))


@pytest.mark.parametrize("load_images", [False, True])
def test_loader_epochs_match_jax(data, tokenizers, load_images):
    """Epochs 0-2 of a shuffled train loader that drops its last partial
    batch: the same batches in the same order, each epoch its own."""
    jds, ds = _train_sets(data, tokenizers, load_images=load_images)
    kw = dict(shuffle=True, seed=42, drop_last=True, num_workers=0, pad_to_multiple=128)
    jl, tl = JDataLoader(jds, 3, 0, **kw), DataLoader(ds, 3, 0, **kw)
    orders = []
    for epoch in range(3):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        assert len(tl) == len(jl) == 2  # 8 records: the last 2 dropped
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb) == 2
        for a, b in zip(jb, tb):
            assert sorted(a) == sorted(b)
            for key in ("input_ids", "seq_len", "weights", "images" if load_images else
                        "image_ids"):
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        orders.append(tuple(tl._indices()))
    assert len(set(orders)) == 3
    # one process reading rank 0's shard of two: the JAX loader's shard
    jl0, tl0 = (cls(d, 3, 0, process_index=0, process_count=2, **kw)
                for cls, d in ((JDataLoader, jds), (DataLoader, ds)))
    jl0.set_epoch(2)
    tl0.set_epoch(2)  # tl's epoch
    assert len(tl0) == len(jl0) == 1 and list(tl0._indices()) == list(tl._indices()[::2])
    for a, b in zip(jl0, tl0):
        for key in ("input_ids", "seq_len", "weights"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    moved = list(prefetch_to_device(iter(range(5)), lambda i: i * 10))
    assert moved == [0, 10, 20, 30, 40]


def test_multi_task_dataset_matches_jax(data, tokenizers):
    """``[search, rec]``: a 25% subsample of search drawn from the
    dataset's rng, then every rec record; each record keeps its task. Then
    ``[rec, exp]``: exp reads its own file."""
    jtok, tok = tokenizers
    kw = dict(n_items=N_ITEMS, history_len=5, load_images=False)
    jds = JTaskDataset(data, "beauty", ["search", "rec"], "train", jtok, **kw)
    ds = TaskDataset(data, "beauty", ["search", "rec"], "train", tok, **kw)
    assert ds.tasks == jds.tasks and ds.records == jds.records
    assert ds.tasks.count("search") == int(0.25 * 48) and ds.tasks.count("rec") == 48
    for i in range(len(ds)):
        a, b = jds[i], ds[i]
        assert a["task"] == b["task"] and a["weight"] == b["weight"]
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
        np.testing.assert_array_equal(a["image_ids"], b["image_ids"])
    jds = JTaskDataset(data, "beauty", ["rec", "exp"], "train", jtok, **kw)
    ds = TaskDataset(data, "beauty", ["rec", "exp"], "train", tok, **kw)
    assert ds.tasks == jds.tasks and ds.records == jds.records
    assert ds.tasks.count("rec") == int(0.25 * 48) and ds.tasks.count("exp") == 48


@pytest.fixture(scope="module")
def debug_pair(runs):
    """(JAX model, its initial params with gates at 0.5, the port's
    training model on them)."""
    jmodel = runs["jt"].model
    params = jax.tree_util.tree_map(jnp.asarray, runs["state0"].params)
    for key in params:
        if key.startswith("xattn_"):
            params[key]["attn_gate"] = jnp.asarray(0.5)
            params[key]["ff_gate"] = jnp.asarray(0.5)
    cfg = get_config("debug", dtype="float32")
    cfg = cfg.replace(lm=dataclasses.replace(cfg.lm, vocab_size=jmodel.cfg.lm.vocab_size))
    model = build_model(cfg, device="cpu", train=True, weights=_flat(params))
    return jmodel, params, model


def test_vision_tower_and_cache_match_jax(data, tokenizers, debug_pair):
    jmodel, params, model = debug_pair
    _, ds = _train_sets(data, tokenizers)
    imgs = np.stack([ds.item_image(i) for i in range(6)]).reshape(2, 3, 28, 28, 3)
    jx = j_norm(jnp.asarray(imgs))
    j_tower = jmodel.apply({"params": params}, jx, method=JModel.encode_vision_tower)
    j_lat = jmodel.apply({"params": params}, j_tower, method=JModel.resample_tower)
    with torch.no_grad():
        x = normalize_on_device(torch.from_numpy(imgs))
        tower = model.encode_vision_tower(x)
        lat = model.resample_tower(tower)
        np.testing.assert_allclose(tower.numpy(), np.asarray(j_tower), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(lat.numpy(), np.asarray(j_lat), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(model.encode_vision(x), lat, rtol=0, atol=0)
    cache = build_tower_cache(model, ds.item_image, N_ITEMS, chunk=16)
    j_cache = j_build_tower_cache(jmodel, params, ds.item_image, N_ITEMS, chunk=16)
    assert cache.shape == j_cache.shape == (N_ITEMS, 4, jmodel.cfg.vision.hidden_size)
    np.testing.assert_allclose(cache.numpy(), np.asarray(j_cache), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        build_tower_cache(model, ds.item_image, N_ITEMS, max_bytes=1000)


def _jax_loader_batch(data, tokenizers, load_images, index=0):
    jds, _ = _train_sets(data, tokenizers, load_images=load_images)
    loader = JDataLoader(jds, 2, 0, shuffle=True, seed=42, num_workers=0, pad_to_multiple=128)
    return list(loader)[index]


def _port_trainer(model, tok, vision_cache=None, multi=1):
    opt = make_optimizer(trainable_params(model), learning_rate=1e-4, warmup_steps=0)
    if multi > 1:
        opt = MultiSteps(opt, multi)
    return Trainer(model, opt, media_id=tok.media_token_id, answer_id=tok.answer_token_id,
                   endofchunk_id=tok.endofchunk_token_id, pad_id=tok.pad_token_id, gamma=2.0,
                   use_reweight=True, device="cpu", vision_cache=vision_cache)


def _jax_state(state0, params):
    """A fresh device copy (the JAX step donates its state)."""
    return jax.tree_util.tree_map(lambda x: jnp.array(np.asarray(x)),
                                  state0.replace(params=params))


def test_cached_step_matches_image_step_and_jax(data, tokenizers, runs, debug_pair):
    """The cached step (tower features gathered by item id) against the
    image step on the same samples, and against the JAX cached step (its
    MultiSteps mean after one call is that call's gradient)."""
    jmodel, params, model = debug_pair
    tok = tokenizers[1]
    ids_batch = _jax_loader_batch(data, tokenizers, False)
    img_batch = _jax_loader_batch(data, tokenizers, True)
    np.testing.assert_array_equal(ids_batch["input_ids"], img_batch["input_ids"])
    _, ds = _train_sets(data, tokenizers)
    cached = _port_trainer(model, tok, build_tower_cache(model, ds.item_image, N_ITEMS))
    loss_c, _ = cached.compute_grads(ids_batch)
    grads_c = {n: p.grad.clone() for n, p in cached.params.items()}
    loss_i, _ = _port_trainer(model, tok).compute_grads(img_batch)
    np.testing.assert_allclose(float(loss_c), float(loss_i), rtol=LOSS_RTOL)
    for n, p in trainable_params(model).items():
        _close(grads_c[n], p.grad, n)

    jt = runs["jt"]
    jt_cache = jt.vision_cache
    jt.vision_cache = j_build_tower_cache(jmodel, params, ds.item_image, N_ITEMS)
    try:
        new_state, metrics = jt.train_step(_jax_state(runs["state0"], params), ids_batch)
    finally:
        jt.vision_cache = jt_cache
    np.testing.assert_allclose(float(loss_c), float(metrics["loss"]), rtol=LOSS_RTOL)
    j_grads = _flat(new_state.opt_state.acc_grads)
    assert set(j_grads) == {n.replace(".", "/") for n in grads_c}
    for n, g in grads_c.items():
        _close(g, j_grads[n.replace(".", "/")], n)
    assert any(float(g.abs().max()) > 0 for n, g in grads_c.items() if n.startswith("resampler"))


def test_multisteps_matches_jax_trainer(data, tokenizers, runs, debug_pair):
    """k=2 over 4 calls, the second one non-finite: the port's Trainer with
    MultiSteps against the JAX Trainer with optax.MultiSteps. After the
    4 calls, one update (the mean of calls 1 and 3), call 4 in the mean;
    the skipped call leaves no trace."""
    jmodel, params, model0 = debug_pair
    tok = tokenizers[1]
    model = build_model(model0.cfg, device="cpu", train=True, weights=_flat(params))
    _, ds = _train_sets(data, tokenizers)
    jt = runs["jt"]
    jt_cache = jt.vision_cache
    jt.vision_cache = j_build_tower_cache(jmodel, params, ds.item_image, N_ITEMS)
    cache = torch.from_numpy(np.array(jt.vision_cache))
    tt = _port_trainer(model, tok, cache, multi=2)
    batches = [_jax_loader_batch(data, tokenizers, False, i) for i in range(4)]
    batches[1] = dict(batches[1], weights=np.full_like(batches[1]["weights"], np.nan))
    state = _jax_state(runs["state0"], params)
    try:
        for i, batch in enumerate(batches):
            state, j_metrics = jt.train_step(state, batch)
            metrics = tt.train_step(batch)
            assert int(metrics["skipped_nonfinite"]) == int(j_metrics["skipped_nonfinite"]) \
                == (i == 1)
            if i != 1:
                np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]),
                                           rtol=LOSS_RTOL)
                np.testing.assert_allclose(float(metrics["grad_norm"]),
                                           float(j_metrics["grad_norm"]), rtol=1e-4)
    finally:
        jt.vision_cache = jt_cache
    ms = state.opt_state
    adam = ms.inner_opt_state[1]
    sched = ms.inner_opt_state[3]
    got = tt.optimizer.state_dict()
    assert (tt.step, got["mini_step"], got["gradient_step"], got["count"],
            got["schedule_count"]) == (int(state.step), int(ms.mini_step),
                                       int(ms.gradient_step), int(adam.count),
                                       int(sched.count)) == (4, 1, 1, 1, 1)
    for key, tree in (("mu", adam.mu), ("nu", adam.nu), ("acc", ms.acc_grads)):
        want = _flat(tree)
        assert set(want) == {n.replace(".", "/") for n in got[key]}
        for n, t in got[key].items():
            _close(t, want[n.replace(".", "/")], f"{key} {n}")
    # Adam's first update moves each entry by lr * g / (|g| + eps): where the
    # mean gradient is within a few hundred eps of 0, means that differ by
    # float32 rounding move it differently. Entries with |g| > 1e-5 agree
    # to 1% of lr, every entry to lr plus the decay (test_torch_train.py)
    j_params, mu = _flat(state.params), _flat(adam.mu)
    lr = 1e-4
    for n, p in tt.params.items():
        path = n.replace(".", "/")
        sure = np.abs(mu[path]) > 1e-5 * 0.1  # mu = (1 - b1) * the mean gradient
        np.testing.assert_allclose(p.detach().numpy()[sure], j_params[path][sure], rtol=0,
                                   atol=1e-2 * lr, err_msg=n)
        np.testing.assert_allclose(p.detach().numpy(), j_params[path], rtol=0,
                                   atol=2.01 * lr, err_msg=n)


def test_multisteps_optimizer_matches_optax():
    """The same gradients into optax.MultiSteps(make_optimizer, 3) and the
    port's MultiSteps: the running mean, the clip of the mean, one update
    in three, and the schedule counted in updates."""
    rng = np.random.default_rng(7)
    shapes = {"xattn_0/xattn/q_proj/kernel": (8, 2, 4), "xattn_0/attn_gate": (),
              "embed/embedding": (16, 8)}
    flat = {k: np.asarray(rng.normal(size=s), np.float32) for k, s in shapes.items()}
    tree = {"xattn_0": {"xattn": {"q_proj": {"kernel": jnp.asarray(flat[
        "xattn_0/xattn/q_proj/kernel"])}}, "attn_gate": jnp.asarray(flat["xattn_0/attn_gate"])},
        "embed": {"embedding": jnp.asarray(flat["embed/embedding"])}}
    kw = dict(learning_rate=1e-2, lr_scheduler="linear", total_steps=4, warmup_steps=1)
    j_tx = optax.MultiSteps(j_opt.make_optimizer(tree, **kw), 3)
    j_state = j_tx.init(tree)
    params = {k.replace("/", "."): torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in flat.items()}
    opt = MultiSteps(make_optimizer(params, **kw), 3)
    for _ in range(7):
        grads = {k: np.asarray(rng.normal(size=s) * 3, np.float32) for k, s in shapes.items()}
        j_grads = jax.tree_util.tree_map(lambda x: x, tree)
        j_grads["xattn_0"]["xattn"]["q_proj"]["kernel"] = jnp.asarray(
            grads["xattn_0/xattn/q_proj/kernel"])
        j_grads["xattn_0"]["attn_gate"] = jnp.asarray(grads["xattn_0/attn_gate"])
        j_grads["embed"]["embedding"] = jnp.asarray(grads["embed/embedding"])
        updates, j_state = j_tx.update(j_grads, j_state, tree)
        tree = optax.apply_updates(tree, updates)
        for k, g in grads.items():
            params[k.replace("/", ".")].grad = torch.from_numpy(g)
        opt.step(opt.grad_norm())
    got = {k.replace(".", "/"): p.detach().numpy() for k, p in params.items()}
    for path, want in flatten_tree(tree).items():
        np.testing.assert_allclose(got[path], np.asarray(want), rtol=1e-6, atol=1e-6)
    for path, want in flatten_tree(j_state.acc_grads).items():
        np.testing.assert_allclose(opt.acc[path.replace("/", ".")].numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    assert (opt.mini_step, opt.gradient_step) == (int(j_state.mini_step),
                                                  int(j_state.gradient_step)) == (1, 2)


def test_main_losses_and_weights_match_jax(runs):
    """The port's per-step losses are the JAX run's within 1e-5 relative;
    its final trainable weights within 5e-4 of each tensor's largest entry,
    frozen ones unchanged."""
    root = runs["root"]
    want = _losses(root / "jax" / "cli" / "cli_metrics.jsonl")
    got = _losses(root / "port" / "cli" / "cli_metrics.jsonl")
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    j_final = _flat(runs["j_state"].params)
    trainer = runs["trainer"]
    assert trainer.model.training  # the evals ran it in eval() mode and handed it back
    assert runs["state"] == {"step": int(runs["j_state"].step), "epoch": 0}
    for name, p in trainer.model.named_parameters():
        path = name.replace(".", "/")
        if p.requires_grad:
            _close(p.detach(), j_final[path], name)
        else:
            np.testing.assert_array_equal(p.detach().numpy(), runs["init"][path], err_msg=name)


def test_main_writes_what_jax_writes(runs):
    """The same checkpoint directories, result dumps and JSONL keys."""
    root = runs["root"]
    tops = {side: sorted(p.name for p in (root / side / "cli").iterdir())
            for side in ("jax", "port")}
    assert tops["port"] == tops["jax"] == [
        "checkpoint_0", "cli_metrics.jsonl", "final_weights", "results", "weights_epoch_0"]
    dumps = {side: sorted(p.name for p in (root / side / "cli" / "results").iterdir())
             for side in ("jax", "port")}
    assert dumps["port"] == dumps["jax"] == ["cli_rec_eval_epoch_0_rank_0.json",
                                             "cli_rec_test_epoch_0_rank_0.json"]
    keys = {side: [sorted(json.loads(line)) for line in
                   (root / side / "cli" / "cli_metrics.jsonl").read_text().splitlines()]
            for side in ("jax", "port")}
    assert keys["port"] == keys["jax"]
    assert {"loss_multi_instruct", "ce", "accuracy", "grad_norm", "step_time",
            "samples_per_second"} <= set(keys["port"][0])
    port = root / "port" / "cli"
    assert sorted(p.name for p in (port / "checkpoint_0").iterdir()) == ["params.pt",
                                                                          "train_state.pt"]
    saved = ckpt.restore_params(str(port), "final_weights")
    model = runs["trainer"].model
    assert set(saved) == set(ckpt.model_tree(model))
    for path, t in ckpt.model_tree(model).items():
        assert saved[path].dtype == t.dtype and torch.equal(saved[path], t), path


def _resume_argv(data, runs, epochs, *extra):
    argv = _argv(data, runs, "resume", "--train_method", "continue", "--num_epochs",
                 str(epochs), "--device", "cpu", *extra)
    argv[argv.index("--gradient_accumulation_steps") + 1] = "3"  # a mean open at the save
    return argv


def test_resume_is_bit_exact(data, tmp_path):
    """Two epochs straight against one epoch, then a second process with
    --resume_from_checkpoint: params, moments, the MultiSteps mean and the
    step bit for bit (the straight run through the opt-in
    UNIMP_DEVICE_PREFETCH path). Under --train_method continue each epoch
    rebuilds its dataset from the seed; in the default mode the dataset's
    prompt draws carry across the epochs of one process and restart after
    a resume, as in the JAX package."""
    with pytest.MonkeyPatch.context() as mp:  # the opt-in device prefetch changes nothing
        mp.setenv("UNIMP_DEVICE_PREFETCH", "1")
        mmrec.main(_resume_argv(data, str(tmp_path / "straight"), 2))
    mmrec.main(_resume_argv(data, str(tmp_path / "resumed"), 1))
    trainer, state = mmrec.main(_resume_argv(data, str(tmp_path / "resumed"), 2,
                                             "--resume_from_checkpoint"))
    assert state["epoch"] == 1 and trainer.step == 8
    a_dir, b_dir = tmp_path / "straight" / "resume", tmp_path / "resumed" / "resume"
    for name in ("final_weights", "checkpoint_1"):
        a, b = ckpt.restore_params(str(a_dir), name), ckpt.restore_params(str(b_dir), name)
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)
    a, b = (ckpt.restore_train_state(str(d), "checkpoint_1") for d in (a_dir, b_dir))
    assert (a["step"], a["epoch"]) == (b["step"], b["epoch"]) == (8, 1)
    for key in ("count", "schedule_count", "mini_step", "gradient_step"):
        assert a["opt_state"][key] == b["opt_state"][key], key
    assert b["opt_state"]["mini_step"] == 2
    for key in ("mu", "nu", "acc"):
        assert set(a["opt_state"][key]) == set(b["opt_state"][key])
        for n, t in a["opt_state"][key].items():
            assert torch.equal(t, b["opt_state"][key][n]), (key, n)


def _eval_argv(data, runs, *extra):
    return ["--mmrec_path", data, "--external_save_dir", runs, "--run_name", "cli",
            "--pretrained_model_name_or_path", "debug", "--subset", "beauty", "--task", "rec",
            "--single_task", "--n_items", str(N_ITEMS), "--history_len", "5",
            "--patch-image-size", "28", "--eval_batch_size", "4", "--num_beams", "3",
            "--max_records", "8", "--workers", "0", "--precision", "fp32", "--do_test",
            "--device", "cpu", "--load_weights_name", "final_weights", *extra]


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_reload_eval(data, runs, tmp_path, monkeypatch, dtype):
    """``mmrec_eval --load_weights_name final_weights``: in float32 the
    answers of the training run's test pass, user for user; in int8 the
    restored weights quantized (restore, then quantize), payloads equal to
    JAX's ``quantize_params_int8`` of the same weights cast to bf16."""
    seen = {"answers": []}
    orig_build, orig_batches = common.build_model, evaluators._generate_batches

    def build(args, tokenizer, **kw):
        seen["model"] = orig_build(args, tokenizer, **kw)
        return seen["model"]

    def batches(*args, **kw):
        for rows, batch, ips in orig_batches(*args, **kw):
            seen["answers"].append(rows)
            yield rows, batch, ips

    monkeypatch.setattr(common, "build_model", build)
    monkeypatch.setattr(evaluators, "_generate_batches", batches)
    port_dir = str(runs["root"] / "port" / "cli")
    results = mmrec_eval.main(_eval_argv(data, str(tmp_path), "--load_dir", port_dir,
                                         "--eval_param_dtype", dtype))
    assert results["rec"]["n_users"] == 8
    if dtype == "fp32":
        assert seen["answers"] == runs["answers"][-2:]  # the epoch's test pass: 2 batches
        dump = "results/cli_rec_test_epoch_0_rank_0.json"
        assert json.loads((tmp_path / "cli" / dump).read_text()) == json.loads(
            (Path(port_dir) / dump).read_text())
    if dtype == "int8":
        weights = {k: v.numpy() for k, v in ckpt.restore_params(port_dir,
                                                                "final_weights").items()}
        nested = {}
        for path, val in weights.items():
            node = nested
            *parents, leaf = path.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = jnp.asarray(val)
        leaves = jax.tree_util.tree_flatten_with_path(j_quantize(j_cast(nested)))[0]
        want = {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path):
                np.asarray(v) for path, v in leaves}
        got = {f"{n.replace('.', '/')}/{leaf}": getattr(m, leaf)
               for n, m in seen["model"].named_modules()
               if isinstance(m, QuantizedKernel) and m.persistent for leaf in ("q", "scale")}
        assert got and set(got) <= set(want)
        for path, t in got.items():
            np.testing.assert_array_equal(t.numpy(), want[path], err_msg=path)


@pytest.mark.parametrize("extra", [
    ["--mesh_fsdp", "2"], ["--mesh_tp", "2"], ["--seq_shard"], ["--mesh_fsdp", "2", "--mesh_tp", "2"],
    ["--load_from_original_checkpoint", "w.pt"], ["--save_hf_model"],
    ["--save_checkpoints_to_wandb"],
])
def test_unported_flags_raise_before_any_work(data, tmp_path, monkeypatch, extra):
    """Each raises before the tokenizer is built. (``--frozen_int8``,
    ``--bf16_opt_state``, ``--remat`` and ``--remat_policy`` run now:
    ``tests/test_torch_train_flags.py`` holds them to the JAX CLI.) The
    multi-GPU flags run since they were ported: in one process a mesh
    larger than the world raises ``make_mesh``'s error naming the sizes,
    and ``--seq_shard`` passes the checks and sets the ring-attention
    context (``tests/test_torch_parallel.py`` runs them over ranks)."""
    def no_work(*args, **kw):
        raise AssertionError("work started before the check")

    monkeypatch.setattr(common, "build_tokenizer", no_work)
    argv = _argv(data, str(tmp_path), "cli", "--device", "cpu", *extra)
    if "--mesh_fsdp" in extra or "--mesh_tp" in extra:
        with pytest.raises(ValueError, match=r"does not divide world 1"):
            mmrec.main(argv)
    elif extra == ["--seq_shard"]:
        try:
            with pytest.raises(AssertionError, match="work started"):
                mmrec.main(argv)
            ring_mesh = get_sequence_sharding()
            assert ring_mesh is not None and ring_mesh.world == 1
        finally:
            set_sequence_sharding(None)
            set_mesh(None)
    else:
        with pytest.raises(NotImplementedError):
            mmrec.main(argv)


def _run_files(root: Path) -> list:
    """The files a run writes, each checkpoint directory as one entry (its
    layout is Orbax's in the JAX package, ``params.pt`` files in the port)."""
    out = set()
    for p in root.rglob("*"):
        if p.is_file():
            rel = p.relative_to(root)
            top = rel.parts[0]
            ckpt_dir = top == "final_weights" or top.startswith(("weights_epoch_", "checkpoint_"))
            out.add(top if ckpt_dir else str(rel))
    return sorted(out)


@pytest.mark.parametrize("extra", [
    ["--task", "exp"], ["--task", "search", "--do_test"],
    ["--train_method", "continue", "--num_epochs", "4"], [],
])
def test_task_runs_match_jax(data, tmp_path, monkeypatch, extra):
    """The runs that raised before the other tasks were ported, on both
    packages from the JAX initial weights: the same files, per-step losses
    within 1e-5 relative, and (search's test pass) the same answers and
    metrics within 1e-12. The last case drops --single_task: the default
    multi-task list, whose first 8 records are img_sel's."""
    seen = {"answers": {"jax": [], "port": []}}
    orig_init, orig_build = JTrainer.init_state, common.build_model

    def init_state(self, *args, **kw):
        state = orig_init(self, *args, **kw)
        seen["init"] = _flat(state.params)
        return state

    def build(args, tokenizer, **kw):
        return orig_build(args, tokenizer, **{**kw, "weights": seen["init"]})

    for side, mod in (("jax", j_evaluators), ("port", evaluators)):
        orig = mod._generate_batches

        def spy(*args, _orig=orig, _side=side, **kw):
            for rows, batch, ips in _orig(*args, **kw):
                seen["answers"][_side].append(rows)
                yield rows, batch, ips

        monkeypatch.setattr(mod, "_generate_batches", spy)
    monkeypatch.setattr(JTrainer, "init_state", init_state)
    monkeypatch.setattr(j_common, "build_mesh", lambda args: None)
    monkeypatch.setattr(common, "build_model", build)
    argvs = {side: _argv(data, str(tmp_path / side), "cli", *extra) for side in ("jax", "port")}
    argvs["port"] += ["--device", "cpu"]
    for argv in argvs.values():
        if not extra:
            argv.remove("--single_task")
    j_mmrec.main(argvs["jax"])
    mmrec.main(argvs["port"])
    roots = {side: tmp_path / side / "cli" for side in ("jax", "port")}
    assert _run_files(roots["port"]) == _run_files(roots["jax"])
    want, got = (_losses(roots[side] / "cli_metrics.jsonl") for side in ("jax", "port"))
    epochs = 4 if "--num_epochs" in extra else 1
    assert len(got) == len(want) == 4 * epochs
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert seen["answers"]["port"] == seen["answers"]["jax"]
    if "--do_test" in extra:
        name = "results/cli_search_test_epoch_0_rank_0.json"
        a, b = (json.loads((roots[side] / name).read_text()) for side in ("port", "jax"))
        assert len(a) == len(b) == 8
        for u, w in zip(a, b):
            assert sorted(u) == sorted(w) and all(abs(u[k] - w[k]) <= 1e-12 for k in w)


def test_reload_of_a_jax_checkpoint_or_a_pt_name_raises(data, runs, tmp_path):
    jax_dir = str(runs["root"] / "jax" / "cli")
    with pytest.raises(NotImplementedError, match="Orbax"):
        mmrec_eval.main(_eval_argv(data, str(tmp_path), "--load_dir", jax_dir))
    with pytest.raises(NotImplementedError, match="converter"):
        argv = _eval_argv(data, str(tmp_path), "--load_dir", jax_dir)
        argv[argv.index("--load_weights_name") + 1] = "final_weights.pt"
        mmrec_eval.main(argv)


def test_trace_dir_writes_a_trace(tmp_path):
    with maybe_trace(str(tmp_path / "trace")):
        torch.ones(4).add_(1)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
