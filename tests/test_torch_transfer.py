"""Multi-task training and the transfer entry against the JAX package, on the CPU.

``mmrec.main`` on the default four-task list (img_sel, search, rec, exp;
25% subsamples of the first three), then ``mmrec_prefix.main`` (the
``item_domain_{i}`` vocabulary growth, everything but the resampler and
the gated cross-attention trainable, a rec epoch and its test pass, then
``--only_test``) on the JAX run's final weights (the port reads the JAX
run's Orbax directory itself), on both packages: the
same data (the synth writer, seed 0, 8 users), the same initial weights
(the JAX init, carried across by ``tools/from_flax.py``), float32,
micro-batch 2 with ``MultiSteps`` over 2. Per-step losses agree within
1e-5 relative; the weights after the restore with growth are equal bit
for bit; the trainable set is ``frozen_mask``'s; the runs write the same
files and the ``--only_test`` answers are identical. ``merge_with_growth``
is also held to the JAX one on its own.
"""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from unimp_tpu.cli import common as j_common
from unimp_tpu.cli import mmrec as j_mmrec
from unimp_tpu.cli import mmrec_eval as j_mmrec_eval
from unimp_tpu.cli import mmrec_prefix as j_mmrec_prefix
from unimp_tpu.evals import evaluators as j_evaluators
from unimp_tpu.train import checkpoint as j_ckpt
from unimp_tpu.train.trainer import Trainer as JTrainer
from unimp_tpu_torch.cli import common, mmrec, mmrec_prefix
from unimp_tpu_torch.evals import evaluators
from unimp_tpu_torch.tools import synth_data
from unimp_tpu_torch.tools.from_flax import flatten_tree
from unimp_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(2)  # six test workers share the cores
N_ITEMS = 40
LOSS_RTOL = 1e-5
METRIC_TOL = 1e-12


def _argv(data, runs, run_name, *extra):
    return ["--mmrec_path", data, "--external_save_dir", runs, "--run_name", run_name,
            "--pretrained_model_name_or_path", "debug", "--subset", "beauty", "--task", "rec",
            "--n_items", str(N_ITEMS), "--history_len", "5", "--patch-image-size", "28",
            "--batch_size", "2", "--gradient_accumulation_steps", "2", "--eval_batch_size",
            "4", "--num_epochs", "1", "--logging_steps", "1", "--warmup_steps", "0",
            "--workers", "0", "--num_beams", "3", "--precision", "fp32", "--use_reweight",
            *extra]


def _flat(params) -> dict:
    return {k: np.asarray(v) for k, v in flatten_tree(params).items() if v is not None}


def _losses(jsonl: Path) -> list:
    return [r["loss_multi_instruct"] for r in map(json.loads, jsonl.read_text().splitlines())
            if "loss_multi_instruct" in r]


def _files(root: Path) -> list:
    """The files under ``root``, each checkpoint directory as one entry
    (its layout is Orbax's in the JAX package, ``params.pt`` in the port)."""
    out = set()
    for p in root.rglob("*"):
        if p.is_file():
            rel = p.relative_to(root)
            top = rel.parts[0]
            ckpt_dir = top == "final_weights" or top.startswith(("weights_epoch_", "checkpoint_"))
            out.add(top if ckpt_dir else str(rel))
    return sorted(out)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    synth_data.generate(str(d), n_items=N_ITEMS, n_users=8, image_size=28, seed=0)
    return str(d)


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """The JAX runs on one device (multi-task, transfer, --only_test), their
    initial weights, the merged weights and the answers held on the side;
    then the port's runs on the same argv from those initial weights, the
    transfer from the JAX run's final weights written as a port
    checkpoint."""
    root = tmp_path_factory.mktemp("runs")
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    seen = {"inits": [], "merged": [], "answers": {"jax": [], "port": []}, "loaded": []}
    orig = dict(init=JTrainer.init_state, init_params=j_mmrec_eval.init_params,
                merge=j_ckpt.merge_with_growth, jb=j_evaluators._generate_batches,
                build=common.build_model, load=mmrec_prefix.load_flax_params,
                pb=evaluators._generate_batches)

    def init_state(self, *args, **kw):
        state = orig["init"](self, *args, **kw)
        seen["inits"].append(_flat(state.params))
        return state

    def init_params(*args, **kw):
        params = orig["init_params"](*args, **kw)
        seen["inits"].append(_flat(params))
        return params

    def merge(*args, **kw):
        out = orig["merge"](*args, **kw)
        seen["merged"].append(_flat(out))
        return out

    def batches(side, fn):
        def spy(*args, **kw):
            for rows, batch, ips in fn(*args, **kw):
                seen["answers"][side].append(rows)
                yield rows, batch, ips
        return spy

    multi = _argv(data, jax_dir, "multi")
    xfer = _argv(data, jax_dir, "xfer", "--single_task", "--load_run_name", "multi",
                 "--load_weights_name", "final_weights", "--do_test")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTrainer, "init_state", init_state)
        mp.setattr(j_mmrec_eval, "init_params", init_params)
        mp.setattr(j_ckpt, "merge_with_growth", merge)
        mp.setattr(j_evaluators, "_generate_batches", batches("jax", orig["jb"]))
        mp.setattr(j_common, "build_mesh", lambda args: None)
        j_mmrec.main(multi)
        j_mmrec_prefix.main(xfer)
        j_only = j_mmrec_prefix.main(xfer + ["--only_test"])
    multi_init, xfer_init, only_init = seen["inits"]

    # the JAX run's final weights, its Orbax directory as it is (train/orbax.py)
    final = _flat(j_ckpt.restore_params(os.path.join(jax_dir, "multi"), "final_weights"))
    shutil.copytree(os.path.join(jax_dir, "multi", "final_weights"),
                    Path(port_dir) / "multi" / "final_weights")

    inits = iter([multi_init, xfer_init, only_init])
    models = []

    def build_from_jax(args, tokenizer, **kw):
        models.append(orig["build"](args, tokenizer, **{**kw, "weights": next(inits)}))
        return models[-1]

    def load(model, flat):
        orig["load"](model, flat)
        seen["loaded"].append({k: t.clone() for k, t in ckpt.model_tree(model).items()})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "build_model", build_from_jax)
        mp.setattr(mmrec_prefix, "load_flax_params", load)
        mp.setattr(evaluators, "_generate_batches", batches("port", orig["pb"]))
        p_multi = mmrec.main(_argv(data, port_dir + "_multi", "multi", "--device", "cpu"))
        port_xfer = [a.replace(jax_dir, port_dir) for a in xfer] + ["--device", "cpu"]
        p_xfer = mmrec_prefix.main(port_xfer)
        p_only = mmrec_prefix.main(port_xfer + ["--only_test"])
    return dict(root=root, jax_dir=Path(jax_dir), port_dir=Path(port_dir), seen=seen,
                final=final, j_only=j_only, p_multi=p_multi, p_xfer=p_xfer, p_only=p_only,
                models=models, xfer_init=xfer_init)


def test_multi_task_losses_match_jax(runs):
    """Every task in the epoch (7 micro-batches of 2 over 14 records), the
    losses within 1e-5 relative of the JAX run's."""
    want = _losses(runs["jax_dir"] / "multi" / "multi_metrics.jsonl")
    got = _losses(runs["port_dir"].parent / "port_multi" / "multi" / "multi_metrics.jsonl")
    assert len(got) == len(want) == 7
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    trainer, state = runs["p_multi"]
    assert state == {"step": 7, "epoch": 0} and trainer.model.training


def test_transfer_restores_with_growth_like_jax(runs):
    """The restore of the JAX run's final weights onto the grown vocabulary:
    every tensor equal to the JAX entry's merge bit for bit, before the
    transfer's training and for --only_test; the new rows keep the init."""
    merged_train, merged_only = runs["seen"]["merged"]
    loaded_train, loaded_only = runs["seen"]["loaded"]
    final, init = runs["final"], runs["xfer_init"]
    grown = 0
    for merged, loaded in ((merged_train, loaded_train), (merged_only, loaded_only)):
        assert set(loaded) == set(merged)
        for path, want in merged.items():
            np.testing.assert_array_equal(loaded[path].numpy(), want, err_msg=path)
    for path, t in loaded_train.items():
        old = final[path]
        if t.shape != old.shape:
            grown += 1
            rows = old.shape[0]
            np.testing.assert_array_equal(t[:rows].numpy(), old, err_msg=path)
            np.testing.assert_array_equal(t[rows:].numpy(), init[path][rows:], err_msg=path)
    assert grown == 1  # the tied embedding table (debug has no separate lm head)


def test_transfer_trains_like_jax(runs):
    """The trainable set is frozen_mask's (everything but resampler* and
    xattn_*), the per-step losses are the JAX run's within 1e-5 relative,
    and the frozen tensors do not move."""
    trainer, state = runs["p_xfer"]
    mask = j_mmrec_prefix.frozen_mask(_nest(runs["xfer_init"]))
    want = {path for path, m in flatten_tree(mask).items() if m}
    got = {name.replace(".", "/") for name in trainer.params}
    assert got == want and got == {name.replace(".", "/") for name, m in
                                   mmrec_prefix.frozen_mask(trainer.model).items() if m}
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    assert not any(n.startswith("resampler") or "xattn_" in n for n in trainer.params)
    want_l = _losses(runs["jax_dir"] / "xfer_office" / "xfer_metrics.jsonl")
    got_l = _losses(runs["port_dir"] / "xfer_office" / "xfer_metrics.jsonl")
    assert len(got_l) == len(want_l) == 4 and state == {"step": 4, "epoch": 0}
    np.testing.assert_allclose(got_l, want_l, rtol=LOSS_RTOL)
    before = runs["seen"]["loaded"][0]
    moved = set()
    for name, p in trainer.model.named_parameters():
        path = name.replace(".", "/")
        if p.requires_grad:
            moved |= {path.split("/")[0]} if not torch.equal(p.detach(), before[path]) else set()
        else:
            assert torch.equal(p.detach(), before[path]), path
    assert {"vision", "embed", "block_0"} <= moved


def _nest(flat: dict) -> dict:
    tree = {}
    for path, val in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = val
    return tree


def test_transfer_writes_what_jax_writes_and_only_test_matches(runs):
    """The same files (weights under ``{run}_office``, metrics and the test
    dumps under ``{run}``), and --only_test's answers and metrics equal."""
    for run in ("xfer_office", "xfer"):
        assert _files(runs["port_dir"] / run) == _files(runs["jax_dir"] / run), run
    assert sorted(p.name for p in (runs["port_dir"] / "xfer_office").iterdir()) == [
        "final_weights", "weights_epoch_0", "xfer_metrics.jsonl"]
    answers = runs["seen"]["answers"]
    assert answers["port"] == answers["jax"] and len(answers["port"]) == 2  # 2 test passes
    want, got = runs["j_only"]["rec"], runs["p_only"]["rec"]
    assert sorted(got) == sorted(want) and got["n_users"] == want["n_users"] == 4
    for key in want:
        if key != "items_per_sec":
            assert abs(got[key] - want[key]) <= METRIC_TOL, key


def test_prefix_needs_a_card_for_cuda(data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mmrec_prefix.main(_argv(data, str(tmp_path), "xfer", "--device", "cuda"))


def test_merge_with_growth_matches_jax():
    """Equal shapes (cast to the target's dtype), a table grown in rows and
    one grown in rows and columns, a stored table larger than the target
    and one of another rank (both keep the init), a path the checkpoint
    lacks and one the target lacks: the same tree as the JAX merge."""
    rng = np.random.default_rng(0)
    target = {"a/kernel": rng.normal(size=(4, 3)).astype(np.float32),
              "embed/embedding": rng.normal(size=(10, 4)).astype(np.float32),
              "head/kernel": rng.normal(size=(6, 8)).astype(np.float32),
              "big/kernel": rng.normal(size=(3, 3)).astype(np.float32),
              "rank/kernel": rng.normal(size=(3, 3)).astype(np.float32),
              "fresh/scale": rng.normal(size=(5,)).astype(np.float32)}
    restored = {"a/kernel": rng.normal(size=(4, 3)).astype(np.float64),
                "embed/embedding": rng.normal(size=(7, 4)).astype(np.float32),
                "head/kernel": rng.normal(size=(5, 6)).astype(np.float32),
                "big/kernel": rng.normal(size=(4, 3)).astype(np.float32),
                "rank/kernel": rng.normal(size=(9,)).astype(np.float32),
                "gone/kernel": rng.normal(size=(2,)).astype(np.float32)}
    want = _flat(j_ckpt.merge_with_growth(_nest(restored), _nest(target)))
    got = ckpt.merge_with_growth({k: torch.from_numpy(v) for k, v in restored.items()},
                                 {k: torch.from_numpy(v) for k, v in target.items()})
    assert sorted(got) == sorted(want) == sorted(target)
    for path, w in want.items():
        assert got[path].dtype == torch.float32, path
        np.testing.assert_array_equal(got[path].numpy(), w, err_msg=path)
    np.testing.assert_array_equal(got["embed/embedding"][7:].numpy(), target["embed/embedding"][7:])
    np.testing.assert_array_equal(got["big/kernel"].numpy(), target["big/kernel"])
