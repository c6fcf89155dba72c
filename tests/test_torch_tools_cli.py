"""The port's CLIs with the reference ``.pt`` flags, against the JAX CLIs,
on the CPU.

A tiny MPT configuration (``--config_json``; without biases every tensor
of it has a reference name that converts back, so a ``.pt`` covers the
whole model: the JAX converter reads a GPT-NeoX ``query_key_value.bias``
onto the kernel's path and misses it, and the port does the same) on
synthetic files. The variant stays ``debug``, so ``--save_hf_model``
names the decoder "neox", as the JAX CLI picks it.
The reference ``.pt`` is the JAX exporter's, of seeded JAX weights.
``mmrec --load_from_original_checkpoint`` in float32 and under
``--frozen_int8 --bf16_opt_state``: the weights right after the load equal
the JAX run's bit for bit (int8 payloads and scales too), the ``[convert]``
lines match none missed, and the per-step losses agree (1e-5 relative;
after the first update under bfloat16 state 1e-3, as
``tests/test_torch_train_flags_cli.py``). Then ``mmrec --save_hf_model``
writes ``final_weights_torch.pt``, equal bit for bit to the exporter's
state dict of ``final_weights``; ``mmrec_eval --load_weights_name
final_weights_torch.pt`` gives the answers and metrics of the port's
reload of ``final_weights`` and the JAX ``mmrec_eval``'s metrics on the
same file.
"""

import dataclasses
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimp_tpu.cli import common as j_common
from unimp_tpu.cli import mmrec as j_mmrec
from unimp_tpu.cli import mmrec_eval as j_mmrec_eval
from unimp_tpu.models import UniMPModel as JModel
from unimp_tpu.models import compute_q_media
from unimp_tpu.models.config import config_from_json as j_config_from_json
from unimp_tpu.tools import export_torch as j_export
from unimp_tpu.tools import synth_data as j_synth
from unimp_tpu.train.trainer import Trainer as JTrainer
from unimp_tpu_torch.cli import mmrec, mmrec_eval
from unimp_tpu_torch.evals import evaluators
from unimp_tpu_torch.tools import export_torch, synth_data
from unimp_tpu_torch.tools.convert_torch import read_state_dict
from unimp_tpu_torch.train import checkpoint as ckpt
from unimp_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)  # six test workers share the cores
N_ITEMS = 40
CONFIG = {"text_config": {"model_type": "mpt", "hidden_size": 128, "num_hidden_layers": 2,
                          "num_attention_heads": 4},
          "vision_config": {"image_size": 28, "patch_size": 14, "hidden_size": 32,
                            "num_hidden_layers": 1, "num_attention_heads": 2,
                            "intermediate_size": 128},
          "cross_attn_every_n_layers": 1}
INT8_FLAGS = ("--frozen_int8", "--bf16_opt_state")


def _common(data, config):
    return ["--mmrec_path", data, "--pretrained_model_name_or_path", "debug", "--config_json",
            config, "--subset", "beauty", "--task", "rec", "--single_task", "--n_items",
            str(N_ITEMS), "--history_len", "5", "--patch-image-size", "28", "--workers", "0",
            "--max_records", "8", "--precision", "fp32", "--eval_batch_size", "4",
            "--num_beams", "3"]


def _train_argv(data, config, runs, run_name, *extra):
    return [*_common(data, config), "--external_save_dir", runs, "--run_name", run_name,
            "--batch_size", "2", "--gradient_accumulation_steps", "2", "--num_epochs", "1",
            "--logging_steps", "1", "--warmup_steps", "0", "--use_reweight",
            "--cache_vision_latents", "--fused_accumulation", *extra]


def _losses(jsonl: Path) -> list:
    return [r["loss_multi_instruct"] for r in map(json.loads, jsonl.read_text().splitlines())
            if "loss_multi_instruct" in r]


def _jflat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): np.array(v)
            for path, v in leaves if v is not None}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Synthetic files, the config file and the reference ``.pt`` (the JAX
    exporter's, of JAX weights seeded at the CLI's vocabulary)."""
    root = tmp_path_factory.mktemp("tools_cli")
    data = str(root / "data")
    synth_data.generate(data, n_items=N_ITEMS, n_users=24, image_size=28, seed=0)
    config = root / "config.json"
    config.write_text(json.dumps(CONFIG))
    tok = j_synth.build_tokenizer(data, n_items=N_ITEMS, task="rec")
    jcfg = j_config_from_json(str(config)).replace(dtype="float32")
    jcfg = jcfg.replace(lm=dataclasses.replace(jcfg.lm, vocab_size=-(-len(tok) // 128) * 128))
    ids = jnp.ones((1, 8), jnp.int32).at[0, 1].set(tok.media_token_id)
    params = JModel(jcfg).init(jax.random.PRNGKey(3), ids,
                               vision_x=jnp.zeros((1, 1, 28, 28, 3), jnp.float32),
                               q_media=compute_q_media(ids, tok.media_token_id))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    for key in params:  # open the gates, so the cross-attention counts
        if key.startswith("xattn_"):
            params[key]["attn_gate"] = np.float32(0.5)
            params[key]["ff_gate"] = np.float32(0.5)
    pt = str(root / "reference.pt")
    j_export.save_torch_checkpoint(params, pt, lm_family="neox")
    return dict(root=root, data=data, config=str(config), pt=pt)


def _port_state(model) -> dict:
    """The model's tensors by flat path as numpy (an int8 kernel as its
    ``.../kernel/q`` payload and ``.../kernel/scale``)."""
    return {name.replace(".", "/"): (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
            for name, t in model.state_dict().items()}


@pytest.mark.parametrize("flags", [(), INT8_FLAGS], ids=["float", "int8"])
def test_load_from_original_checkpoint_matches_jax(setup, tmp_path, capsys, flags):
    seen = {}
    orig_jstep, orig_step = JTrainer.train_step, Trainer.train_step

    def jstep(self, state, batch):
        seen.setdefault("jax", _jflat(state.params))  # before the step donates it
        return orig_jstep(self, state, batch)

    def step(self, batch):
        seen.setdefault("port", _port_state(self.model))
        return orig_step(self, batch)

    args = (setup["data"], setup["config"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTrainer, "train_step", jstep)
        mp.setattr(j_common, "build_mesh", lambda args: None)
        j_mmrec.main(_train_argv(*args, str(tmp_path / "jax"), "orig", *flags,
                                 "--load_from_original_checkpoint", setup["pt"]))
        j_lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[convert]")]
        mp.setattr(Trainer, "train_step", step)
        mmrec.main(_train_argv(*args, str(tmp_path / "port"), "orig", *flags, "--device", "cpu",
                               "--load_from_original_checkpoint", setup["pt"]))
        lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[convert]")]
    assert lines == j_lines and len(lines) == 1
    assert re.fullmatch(r"\[convert\] matched \d+ tensors, left 0 untouched", lines[0])
    want, got = seen["jax"], seen["port"]
    assert sorted(got) == sorted(want)
    assert any(p.endswith("kernel/q") for p in want) == bool(flags)
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], np.asarray(w, got[path].dtype), err_msg=path)
    want = _losses(tmp_path / "jax" / "orig" / "orig_metrics.jsonl")
    got = _losses(tmp_path / "port" / "orig" / "orig_metrics.jsonl")
    assert len(got) == len(want) >= 2
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-3 if flags else 1e-5)


def test_save_hf_model_then_pt_reload_eval_matches_jax(setup, tmp_path, monkeypatch):
    args = (setup["data"], setup["config"])
    mmrec.main(_train_argv(*args, str(tmp_path), "hf", "--device", "cpu", "--save_hf_model",
                           "--load_from_original_checkpoint", setup["pt"]))
    run = tmp_path / "hf"
    written = read_state_dict(str(run / "final_weights_torch.pt"))
    want = export_torch.export_state_dict(ckpt.restore_params(str(run), "final_weights"), "neox")
    assert sorted(written) == sorted(want)
    for k, v in want.items():
        assert written[k].dtype == np.float32
        np.testing.assert_array_equal(written[k], v, err_msg=k)

    answers = []
    orig = evaluators._generate_batches

    def batches(*a, **kw):
        for rows, batch, ips in orig(*a, **kw):
            answers.append(rows)
            yield rows, batch, ips

    monkeypatch.setattr(evaluators, "_generate_batches", batches)
    results = {}
    for name in ("final_weights_torch.pt", "final_weights"):
        argv = [*_common(*args), "--external_save_dir", str(tmp_path / "eval"), "--run_name",
                name.replace(".", "_"), "--load_dir", str(run), "--load_weights_name", name,
                "--do_test", "--device", "cpu"]
        start = len(answers)
        results[name] = (mmrec_eval.main(argv)["rec"], answers[start:])
    (got, got_answers), (reload, reload_answers) = results.values()
    assert got_answers == reload_answers and got["n_users"] == 4
    jargv = [*_common(*args), "--external_save_dir", str(tmp_path / "jax"), "--run_name", "pt",
             "--load_dir", str(run), "--load_weights_name", "final_weights_torch.pt",
             "--do_test"]
    want = j_mmrec_eval.main(jargv)["rec"]
    assert sorted(got) == sorted(want)
    for key in want:
        if key != "items_per_sec":
            assert got[key] == reload[key], key
            assert abs(got[key] - want[key]) <= 1e-12, key
