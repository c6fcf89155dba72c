"""The port's ``mmrec`` with the JAX package's headline training flags,
against the JAX ``mmrec.main``, on the CPU.

One ``debug`` float32 run of each CLI on the same synthetic files and the
same weights (the JAX initial state, int8 frozen kernels and all, carried
across by ``tools/from_flax.py``) with ``--frozen_int8 --bf16_opt_state
--remat --remat_policy dots --cache_vision_latents --fused_accumulation``
over two epochs: the per-step losses agree. Then the port's resume with
int8 storage and bfloat16 moments: under ``--train_method continue`` (each
epoch draws its prompts from the seed; by default the draws carry across
the epochs of one process, as in the JAX package) a run of one epoch
resumed from its ``checkpoint_0`` for a second logs the losses of two
epochs straight and ends on the same weights. A resume under
``--unfreeze_backbone`` keeps the backbone trainable. Tolerances: the first loss
1e-5 relative (as
``tests/test_torch_train_cli.py``); the later ones 1e-3, since each
update moves a weight by one bfloat16 step of its gradient's rounding
more or less on either side (``tests/test_torch_train_flags.py``).
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from unimp_tpu.cli import common as j_common
from unimp_tpu.cli import mmrec as j_mmrec
from unimp_tpu.train.trainer import Trainer as JTrainer
from unimp_tpu_torch.cli import common, mmrec
from unimp_tpu_torch.tools import synth_data
from unimp_tpu_torch.train import checkpoint as ckpt
from unimp_tpu_torch.train.partition import backbone_trainable_mask
from unimp_tpu_torch.utils.quant import count_quantized

torch.set_num_threads(2)  # six test workers share the cores
N_ITEMS = 40
FLAGS = ("--frozen_int8", "--bf16_opt_state", "--remat", "--remat_policy", "dots",
         "--cache_vision_latents", "--fused_accumulation")


def _argv(data, runs, run_name, *extra, flags=FLAGS):
    return ["--mmrec_path", data, "--external_save_dir", runs, "--run_name", run_name,
            "--pretrained_model_name_or_path", "debug", "--subset", "beauty", "--task", "rec",
            "--single_task", "--n_items", str(N_ITEMS), "--history_len", "5",
            "--patch-image-size", "28", "--batch_size", "2", "--gradient_accumulation_steps",
            "2", "--num_epochs", "2", "--logging_steps", "1", "--warmup_steps", "0",
            "--workers", "0", "--max_records", "8", "--precision", "fp32", "--use_reweight",
            *flags, *extra]


def _losses(jsonl: Path) -> list:
    return [r["loss_multi_instruct"] for r in map(json.loads, jsonl.read_text().splitlines())
            if "loss_multi_instruct" in r]


def _flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): np.asarray(v)
            for path, v in leaves if v is not None}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    synth_data.generate(str(d), n_items=N_ITEMS, n_users=24, image_size=28, seed=0)
    return str(d)


def test_headline_flags_match_jax_and_resume(data, tmp_path):
    seen = {}
    orig_init = JTrainer.init_state

    def init_state(self, *args, **kw):
        state = orig_init(self, *args, **kw)
        seen["init"] = _flat(state.params)  # before the first step donates it
        return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTrainer, "init_state", init_state)
        mp.setattr(j_common, "build_mesh", lambda args: None)
        j_mmrec.main(_argv(data, str(tmp_path / "jax"), "flags"))
    init = seen["init"]
    assert any(p.endswith("kernel/q") for p in init)

    orig_build = common.build_model
    models = []

    def build_from_jax(args, tokenizer, **kw):
        models.append(orig_build(args, tokenizer, **{**kw, "weights": init}))
        return models[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "build_model", build_from_jax)
        trainer, state = mmrec.main(_argv(data, str(tmp_path / "port"), "flags",
                                          "--device", "cpu"))
        cont = ("--device", "cpu", "--train_method", "continue")
        straight, _ = mmrec.main(_argv(data, str(tmp_path / "port"), "straight", *cont))
        mmrec.main(_argv(data, str(tmp_path / "port"), "cut", *cont, "--num_epochs", "1"))
        resumed, _ = mmrec.main(_argv(data, str(tmp_path / "port"), "cut", *cont,
                                      "--resume_from_checkpoint"))
    assert state == {"step": 4, "epoch": 1}
    assert count_quantized(trainer.model) == sum(p.endswith("kernel/q") for p in init) > 0
    assert trainer.model.cfg.remat and trainer.model.cfg.remat_policy == "dots"
    assert trainer.grad_dtype == torch.bfloat16
    assert all(m.dtype == torch.bfloat16 for m in trainer.optimizer.mu.values())

    want = _losses(tmp_path / "jax" / "flags" / "flags_metrics.jsonl")
    got = _losses(tmp_path / "port" / "flags" / "flags_metrics.jsonl")
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-3)

    cut = _losses(tmp_path / "port" / "cut" / "cut_metrics.jsonl")
    whole = _losses(tmp_path / "port" / "straight" / "straight_metrics.jsonl")
    assert len(cut) == len(whole) == 4 and resumed.step == straight.step == 4
    np.testing.assert_allclose(cut, whole, rtol=1e-6)
    assert count_quantized(resumed.model) == count_quantized(straight.model)
    for name, p in straight.params.items():
        np.testing.assert_allclose(resumed.params[name].detach().numpy(),
                                   p.detach().numpy(), rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("state", [(), ("--bf16_opt_state",)], ids=["f32_state", "bf16_state"])
def test_unfreeze_backbone_resume_keeps_the_backbone_training(data, tmp_path, state):
    """--unfreeze_backbone with --resume_from_checkpoint: after the load every
    parameter still requires a gradient and is one the optimizer holds, and
    the resumed epoch's updates move every backbone kernel (the tower's and
    the LM's), as in the JAX CLI, which freezes nothing under the flag."""
    def argv(*more):
        return _argv(data, str(tmp_path), "unfrozen", "--unfreeze_backbone", "--device", "cpu",
                     "--train_method", "continue", *state, *more, flags=())

    mmrec.main(argv("--num_epochs", "1"))
    saved = ckpt.restore_params(str(tmp_path / "unfrozen"), "checkpoint_0")
    trainer, run = mmrec.main(argv("--resume_from_checkpoint"))
    assert run["epoch"] == 1
    names = [n for n, _ in trainer.model.named_parameters()]
    assert all(p.requires_grad for p in trainer.model.parameters())
    assert set(trainer.params) == set(names)
    mask = backbone_trainable_mask(trainer.model)
    backbone = [n for n in names if not mask[n] and n.endswith("kernel")]
    assert {n.split(".", 1)[0] for n in backbone} >= {"vision", "block_0", "block_1"}
    still = [n for n in backbone
             if torch.equal(trainer.params[n].detach(), saved[n.replace(".", "/")])]
    assert not still, still[:8]
