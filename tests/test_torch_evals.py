"""The port's rec evaluator and eval CLI against the JAX package's, on the CPU.

Same data (the synth writer, seed 0), same ``debug`` weights (a seeded
JAX init, gates opened, carried across by ``tools/from_flax.py``), float32,
3 beams: the answers of every user are identical and HR/NDCG/MRR agree to
1e-12, through the latent cache (item ids) and through pixels. The CLI
writes the same files with the same keys as the JAX ``mmrec_eval``, on
every task's own flags the same answers and metrics, and every flag whose
machinery is not ported raises.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimp_tpu.cli import mmrec_eval as j_mmrec_eval
from unimp_tpu.data.dataset import TaskDataset as JTaskDataset
from unimp_tpu.data.loader import DataLoader as JDataLoader
from unimp_tpu.evals import evaluators as j_evaluators
from unimp_tpu.models import UniMPModel as JModel
from unimp_tpu.models import compute_q_media as j_compute_q_media
from unimp_tpu.models import get_config as j_get_config
from unimp_tpu.models.config import config_from_json as j_config_from_json
from unimp_tpu.tools import synth_data as j_synth
from unimp_tpu_torch.cli import mmrec_eval
from unimp_tpu_torch.data.dataset import TaskDataset
from unimp_tpu_torch.data.loader import DataLoader
from unimp_tpu_torch.decode import GenerationConfig
from unimp_tpu_torch.evals import evaluators
from unimp_tpu_torch.models import UniMPModel, get_config
from unimp_tpu_torch.models.config import config_from_json
from unimp_tpu_torch.parallel.mesh import set_mesh
from unimp_tpu_torch.parallel.seq_shard import get_sequence_sharding, set_sequence_sharding
from unimp_tpu_torch.tools import synth_data
from unimp_tpu_torch.tools.from_flax import flatten_tree, load_flax_params

torch.set_num_threads(2)  # six test workers share the cores
N_ITEMS = 40
METRIC_TOL = 1e-12


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    synth_data.generate(str(d), n_items=N_ITEMS, n_users=48, image_size=28, seed=0)
    return str(d)


@pytest.fixture(scope="module")
def models(data):
    """(JAX model, its params, the port's model) on the same weights, and
    the two tokenizers."""
    jtok = j_synth.build_tokenizer(data, n_items=N_ITEMS, task="rec")
    tok = synth_data.build_tokenizer(data, n_items=N_ITEMS, task="rec")
    vocab = -(-len(tok) // 128) * 128
    jcfg = j_get_config("debug", dtype="float32")
    jmodel = JModel(jcfg.replace(lm=dataclasses.replace(jcfg.lm, vocab_size=vocab)))
    media = jtok.media_token_id
    ids = jnp.ones((1, 8), jnp.int32).at[0, 1].set(media)
    img = jcfg.vision.image_size
    params = jmodel.init(jax.random.PRNGKey(0), ids,
                         vision_x=jnp.zeros((1, 1, img, img, 3), jnp.float32),
                         q_media=j_compute_q_media(ids, media))["params"]
    for key in params:
        if key.startswith("xattn_"):
            params[key]["attn_gate"] = jnp.asarray(1.0)
            params[key]["ff_gate"] = jnp.asarray(1.0)
    cfg = get_config("debug", dtype="float32")
    tmodel = UniMPModel(cfg.replace(lm=dataclasses.replace(cfg.lm, vocab_size=vocab)))
    load_flax_params(tmodel, {k: np.asarray(v) for k, v in flatten_tree(params).items()})
    return jmodel, params, tmodel.eval(), jtok, tok


def _loaders(data, jtok, tok, load_images):
    kw = dict(n_items=N_ITEMS, image_size=28, history_len=5, load_images=load_images)
    jds = JTaskDataset(data, "beauty", "rec", "test", jtok, **kw)
    ds = TaskDataset(data, "beauty", "rec", "test", tok, **kw)
    lkw = dict(shuffle=False, drop_last=False, num_workers=0, pad_to_multiple=128)
    return JDataLoader(jds, 4, jtok.pad_token_id, **lkw), DataLoader(ds, 4, tok.pad_token_id, **lkw)


class Retarget:
    """A loader whose batches carry the given targets, in order."""

    def __init__(self, loader, targets):
        self.loader, self.dataset, self.targets = loader, loader.dataset, targets

    def __iter__(self):
        it = iter(self.targets)
        for batch in self.loader:
            yield dict(batch, targets=[next(it) for _ in batch["targets"]])


@pytest.mark.parametrize("load_images", [False, True])
def test_evaluate_rec_matches_jax(data, models, monkeypatch, load_images):
    """Answers per user identical; HR/NDCG/MRR within 1e-12. The targets
    are set so that users hit at every rank (the true targets are never
    generated by random weights): a user u of the 8 takes the port's
    answer at rank u % 4, the fourth keeps its true target."""
    jmodel, params, tmodel, jtok, tok = models
    jloader, loader = _loaders(data, jtok, tok, load_images)
    gen_cfg = GenerationConfig(max_new_tokens=50, eos_id=tok.eos_token_id,
                               pad_id=tok.eos_token_id, num_beams=3, num_return_sequences=3)
    answers, targets = [], []
    for rows, batch, _ in evaluators._generate_batches(tmodel, loader, tok, gen_cfg):
        answers += rows
        targets += batch["targets"]
    assert len(answers) == 8 and all(len(r) == 3 for r in answers)
    new_targets = [row[u % 4] if u % 4 < 3 else t
                   for u, (row, t) in enumerate(zip(answers, targets))]

    seen = []
    orig = j_evaluators._generate_batches

    def spy(*args, **kw):
        for rows, batch, ips in orig(*args, **kw):
            seen.extend(rows)
            yield rows, batch, ips

    monkeypatch.setattr(j_evaluators, "_generate_batches", spy)
    want = j_evaluators.evaluate_rec(jmodel, params, Retarget(jloader, new_targets), jtok,
                                     num_beams=3)
    got = evaluators.evaluate_rec(tmodel, Retarget(loader, new_targets), tok, num_beams=3)
    assert seen == answers
    assert sorted(got) == sorted(want)
    assert got["n_users"] == want["n_users"] == 8
    for key in want:
        if key not in ("items_per_sec", "n_users"):
            assert abs(got[key] - want[key]) <= METRIC_TOL, (key, got[key], want[key])
    assert got["hr@3"] > 0 and got["mrr@10"] < got["hr@10"] < 1


def _argv(data, runs, device_args):
    return ["--mmrec_path", data, "--external_save_dir", runs, "--run_name", "cli",
            "--pretrained_model_name_or_path", "debug", "--subset", "beauty", "--task", "rec",
            "--single_task", "--n_items", str(N_ITEMS), "--history_len", "5",
            "--patch-image-size", "28", "--eval_batch_size", "4", "--num_beams", "3",
            "--max_records", "8", "--workers", "2", "--precision", "fp32",
            "--eval_param_dtype", "fp32", "--do_eval", "--do_test"] + device_args


def test_cli_writes_what_jax_writes(data, tmp_path):
    """The port's ``main`` on the CPU and the JAX ``main`` on the same data:
    the same files, ``eval_results.json`` and the per-user dumps with the
    same keys, 8 users a split."""
    got = mmrec_eval.main(_argv(data, str(tmp_path / "port"), ["--device", "cpu"]))
    want = j_mmrec_eval.main(_argv(data, str(tmp_path / "jax"), []))
    files = {}
    for side in ("port", "jax"):
        root = tmp_path / side / "cli"
        files[side] = sorted(str(p.relative_to(root)) for p in root.rglob("*.json"))
    assert files["port"] == files["jax"] == [
        "eval_results.json", "results/cli_rec_eval_epoch_0_rank_0.json",
        "results/cli_rec_test_epoch_0_rank_0.json"]
    for name in files["port"]:
        a = json.loads((tmp_path / "port" / "cli" / name).read_text())
        b = json.loads((tmp_path / "jax" / "cli" / name).read_text())
        if isinstance(a, list):
            assert len(a) == len(b) == 8 and [sorted(u) for u in a] == [sorted(u) for u in b]
        else:
            assert sorted(a) == sorted(b) == ["eval", "rec"]
            assert sorted(a["rec"]) == sorted(b["rec"]) and sorted(a["eval"]) == sorted(b["eval"])
            assert a["rec"]["n_users"] == b["rec"]["n_users"] == 8
    assert sorted(got) == sorted(want)


@pytest.mark.parametrize("extra", [
    ["--mesh_fsdp", "2"], ["--mesh_tp", "2"], ["--seq_shard"], ["--report_to_wandb"],
])
def test_cli_unported_flags_raise(data, tmp_path, monkeypatch, capsys, extra):
    """The flags the port lacked, each run now that it is ported. The
    multi-GPU ones: in one process ``--mesh_fsdp 2`` / ``--mesh_tp 2`` raise
    ``make_mesh``'s error naming the sizes, and ``--seq_shard`` (no causal
    self-attention is routed in an eval, whose prefill has a window start)
    gives the run's results without it. ``--report_to_wandb`` where wandb
    is missing prints the JAX logger's one line and gives the run's results
    and JSONL without it. ``--load_weights_name *.pt`` runs since the
    converter was ported (``tests/test_torch_tools_cli.py``)."""
    argv = _argv(data, str(tmp_path), ["--device", "cpu"]) + extra
    if extra[0] in ("--mesh_fsdp", "--mesh_tp"):
        with pytest.raises(ValueError, match="does not divide world 1"):
            mmrec_eval.main(argv)
    elif extra == ["--seq_shard"]:
        try:
            got = mmrec_eval.main(argv)
            assert get_sequence_sharding() is not None
        finally:
            set_sequence_sharding(None)
            set_mesh(None)
        want = mmrec_eval.main(_argv(data, str(tmp_path / "plain"), ["--device", "cpu"]))
        assert got["rec"]["n_users"] == want["rec"]["n_users"] == 8
        for key, val in want["rec"].items():
            if key != "items_per_sec":
                assert got["rec"][key] == val, key
    else:
        from unimp_tpu.utils.logging import MetricLogger as JMetricLogger

        monkeypatch.setitem(sys.modules, "wandb", None)  # an import of wandb fails
        capsys.readouterr()
        JMetricLogger(str(tmp_path / "jax_log"), "cli_eval", use_wandb=True)
        line = capsys.readouterr().out
        assert line.startswith("[logging] wandb unavailable (")
        got = mmrec_eval.main(argv)
        assert line in capsys.readouterr().out
        want = mmrec_eval.main(_argv(data, str(tmp_path / "plain"), ["--device", "cpu"]))
        for key, val in want["rec"].items():
            if key != "items_per_sec":
                assert got["rec"][key] == val, key
        logs = [[sorted(json.loads(r)) for r in (root / "cli" / "cli_eval_metrics.jsonl")
                 .read_text().splitlines()] for root in (tmp_path, tmp_path / "plain")]
        assert logs[0] == logs[1] and logs[0]


@pytest.mark.parametrize("extra", [
    ["--eval_embed"], ["--task", "exp", "--eval_embed"], ["--task", "img_sel"],
    ["--task", "search"],
])
def test_cli_tasks_match_jax(data, tmp_path, monkeypatch, extra):
    """The flags that raised before the other tasks were ported: the port's
    ``main`` on the JAX ``main``'s initial weights writes the same files,
    gives the same answers user for user and the same metrics within
    1e-12 (BERTScore, from the model's text tower, within 1e-5)."""
    seen = {"answers": {"jax": [], "port": []}}
    orig_init, orig_build = j_mmrec_eval.init_params, mmrec_eval.common.build_model

    def init_params(*args, **kw):
        params = orig_init(*args, **kw)
        seen["init"] = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
        return params

    def build(args, tokenizer, **kw):
        return orig_build(args, tokenizer, **{**kw, "weights": seen["init"]})

    for side, mod in (("jax", j_evaluators), ("port", evaluators)):
        orig = mod._generate_batches

        def spy(*args, _orig=orig, _side=side, **kw):
            for rows, batch, ips in _orig(*args, **kw):
                seen["answers"][_side].append(rows)
                yield rows, batch, ips

        monkeypatch.setattr(mod, "_generate_batches", spy)
    monkeypatch.setattr(j_mmrec_eval, "init_params", init_params)
    monkeypatch.setattr(mmrec_eval.common, "build_model", build)
    extra = extra + ["--max_records", "4"]  # one batch a split
    want = j_mmrec_eval.main(_argv(data, str(tmp_path / "jax"), []) + extra)
    got = mmrec_eval.main(_argv(data, str(tmp_path / "port"), ["--device", "cpu"]) + extra)
    assert seen["answers"]["port"] == seen["answers"]["jax"]
    assert len(seen["answers"]["port"]) == 2  # the eval and the test split
    files = {side: sorted(str(p.relative_to(tmp_path / side / "cli"))
                          for p in (tmp_path / side / "cli").rglob("*") if p.is_file())
             for side in ("jax", "port")}
    assert files["port"] == files["jax"]
    task = extra[1] if extra[0] == "--task" else "rec"
    assert sorted(got) == sorted(want) == sorted(["eval", task])
    for split_got, split_want in ((got, want), (got["eval"], want["eval"])):
        a, b = split_got[task], split_want[task]
        assert sorted(a) == sorted(b) and a["n_users"] == b["n_users"] == 4
        for key in b:
            tol = 1e-5 if key == "bertscore" else METRIC_TOL
            if key != "items_per_sec":
                assert abs(a[key] - b[key]) <= tol, (key, a[key], b[key])
    if task == "exp":
        assert "bertscore" in got[task] and (tmp_path / "port" / "cli" / "results_exp.txt").exists()
        for name in ("gen_exps_0.json", "real_exps_0.json"):
            assert json.loads((tmp_path / "port" / "cli" / "save_gen" / name).read_text()) == \
                json.loads((tmp_path / "jax" / "cli" / "save_gen" / name).read_text())


def test_cli_needs_a_card_for_cuda(data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mmrec_eval.main(_argv(data, str(tmp_path), ["--device", "cuda"]))


def test_config_from_json_matches(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(json.dumps({
        "text_config": {"model_type": "gpt_neox", "hidden_size": 512, "num_hidden_layers": 4,
                        "num_attention_heads": 8, "intermediate_size": 2048,
                        "rotary_pct": 0.5, "max_position_embeddings": 1024},
        "vision_config": {"image_size": 224, "patch_size": 14, "hidden_size": 256,
                          "num_hidden_layers": 2, "num_attention_heads": 4,
                          "intermediate_size": 1024},
        "cross_attn_every_n_layers": 2, "tie_word_embeddings": True}))
    got, want = config_from_json(str(path)), j_config_from_json(str(path))
    for part in ("vision", "resampler", "lm"):
        a, b = dataclasses.asdict(getattr(got, part)), dataclasses.asdict(getattr(want, part))
        assert a == {k: b[k] for k in a}, part
    assert got.cross_attn_every_n == want.cross_attn_every_n == 2
    path.write_text(json.dumps({"text_config": {"model_type": "opt"}}))
    with pytest.raises(KeyError):
        config_from_json(str(path))
