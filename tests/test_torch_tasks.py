"""The port's other four tasks against the JAX package's, on the CPU.

Datasets (exp, img_sel, img_gen, img_gen_pretrain, the four-task list),
the text metrics, BERTScore (greedy matching and the model's own text
tower), the ``return_hidden`` forward, the search / exp / img_sel /
img_gen evaluators through the ``Generator``, and ``run_evals``' per-task
wiring. Same data (the synth writer, seed 0, 24 users, 4 a test split),
same ``debug`` weights (a seeded JAX init, gates opened, carried across
by ``tools/from_flax.py``), float32. Samples and tokens are identical;
metrics agree to 1e-12; embeddings and BERTScore to 1e-5.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimp_tpu.cli import common as j_common
from unimp_tpu.cli import mmrec as j_mmrec
from unimp_tpu.cli.arguments import build_parser as j_build_parser
from unimp_tpu.data.dataset import TaskDataset as JTaskDataset
from unimp_tpu.data.loader import DataLoader as JDataLoader
from unimp_tpu.evals import EVALUATORS as J_EVALUATORS
from unimp_tpu.evals import bertscore as j_bertscore
from unimp_tpu.evals import evaluators as j_evaluators
from unimp_tpu.evals import text_metrics as j_text_metrics
from unimp_tpu.models import UniMPModel as JModel
from unimp_tpu.models import compute_q_media as j_compute_q_media
from unimp_tpu.models import get_config as j_get_config
from unimp_tpu.tools import synth_data as j_synth
from unimp_tpu.utils import MetricLogger as JMetricLogger
from unimp_tpu_torch.cli import common, mmrec
from unimp_tpu_torch.cli.arguments import build_parser
from unimp_tpu_torch.data.dataset import TaskDataset
from unimp_tpu_torch.data.loader import DataLoader
from unimp_tpu_torch.evals import bertscore, evaluators, text_metrics
from unimp_tpu_torch.models import UniMPModel, get_config
from unimp_tpu_torch.tools import synth_data
from unimp_tpu_torch.tools.from_flax import flatten_tree, load_flax_params
from unimp_tpu_torch.utils.logging import MetricLogger

torch.set_num_threads(2)  # six test workers share the cores
N_ITEMS = 40
METRIC_TOL = 1e-12
EMB_TOL = 1e-5
FOUR_TASKS = ["img_sel", "search", "rec", "exp"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    synth_data.generate(str(d), n_items=N_ITEMS, n_users=24, image_size=28, seed=0)
    return str(d)


@pytest.fixture(scope="module")
def tokenizers(data):
    """Every task's vocabulary (task None adds the VQGAN tokens too)."""
    return (j_synth.build_tokenizer(data, n_items=N_ITEMS),
            synth_data.build_tokenizer(data, n_items=N_ITEMS))


def _sets(data, tokenizers, task, split, subset="beauty", **kw):
    jtok, tok = tokenizers
    kw = {"n_items": N_ITEMS, "image_size": 28, "load_images": False, **kw}
    return (JTaskDataset(data, subset, task, split, jtok, **kw),
            TaskDataset(data, subset, task, split, tok, **kw))


def _same_samples(jds, ds):
    assert ds.tasks == jds.tasks and ds.records == jds.records
    assert ds.builder.history_len == jds.builder.history_len
    for i in range(len(ds)):
        a, b = jds[i], ds[i]
        assert sorted(a) == sorted(b), i
        assert a["task"] == b["task"] and a["weight"] == b["weight"], i
        assert a.get("target") == b.get("target") and a.get("extra") == b.get("extra"), i
        for key in ("input_ids", "image_ids", "images"):
            if key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{key} {i}")


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("task", ["exp", "img_sel", "img_gen", "img_gen_pretrain", "four"])
def test_task_dataset_matches_jax(data, tokenizers, task, split):
    """Records, tasks and every sample (ids, image ids, target, extra,
    weight) equal; the four-task list draws its 25% subsamples from the
    dataset's rng in the JAX package's order."""
    jds, ds = _sets(data, tokenizers, FOUR_TASKS if task == "four" else task, split)
    _same_samples(jds, ds)
    n_users = {"train": 24, "test": 4}[split]
    want = {"exp": n_users, "img_sel": n_users, "img_gen": n_users,
            "img_gen_pretrain": N_ITEMS, "four": 3 * int(0.25 * n_users) + n_users}[task]
    assert len(ds) == want
    if task == "four":
        assert [ds.tasks.count(t) for t in FOUR_TASKS] == [int(0.25 * n_users)] * 3 + [n_users]
    if task == "img_sel" and split == "test":
        assert len(ds[0]["image_ids"]) == 9  # the history's and the 5 candidates' images
    if task == "img_gen" and split == "test":
        assert ds[0]["target"].startswith("img_") and set(ds[0]["extra"]) == {"item"}


def test_task_dataset_with_pixels_matches_jax(data, tokenizers):
    jds, ds = _sets(data, tokenizers, "img_sel", "train", load_images=True, max_records=3)
    _same_samples(jds, ds)
    assert ds[0]["images"].shape[1:] == (28, 28, 3)


def test_img_gen_history_on_subset_all(tmp_path, tokenizers):
    """Subset "all": img_gen alone takes 2 history items, a task list
    holding img_gen does not (the JAX package compares the task to the
    string)."""
    d = str(tmp_path)
    synth_data.generate(d, subset="all", n_items=N_ITEMS, n_users=8, image_size=28, seed=1,
                        write_images=False)
    for task, want in (("img_gen", 2), (["img_gen"], 5), ("rec", 5)):
        jds, ds = _sets(d, tokenizers, task, "test", subset="all")
        assert ds.builder.history_len == want, task
        _same_samples(jds, ds)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_text_metrics_match_jax(seed):
    """BLEU (every field), ROUGE-1/2/L and METEOR on random texts over a
    small vocabulary (repeats, reorders, empty strings) within 1e-12."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(12)]

    def text():
        return " ".join(rng.choice(words, size=int(rng.integers(0, 15))))

    preds, refs = [text() for _ in range(30)], [text() for _ in range(30)]
    refs[3] = preds[3]
    got, want = text_metrics.bleu(preds, refs), j_text_metrics.bleu(preds, refs)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=METRIC_TOL, err_msg=key)
    for fn in ("rouge_l", "meteor"):
        assert abs(getattr(text_metrics, fn)(preds, refs)
                   - getattr(j_text_metrics, fn)(preds, refs)) <= METRIC_TOL, fn
    for n in (1, 2):
        assert abs(text_metrics.rouge_n(preds, refs, n)
                   - j_text_metrics.rouge_n(preds, refs, n)) <= METRIC_TOL, n


def test_greedy_match_scores_match_jax():
    rng = np.random.default_rng(3)
    c, r = rng.normal(size=(5, 7, 16)), rng.normal(size=(5, 9, 16))
    cm, rm = rng.random((5, 7)) < 0.7, rng.random((5, 9)) < 0.7
    cm[0], rm[1] = False, False  # a row with no candidate / no reference token
    got = bertscore.greedy_match_scores(c, cm, r, rm)
    want = j_bertscore.greedy_match_scores(c, cm, r, rm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=METRIC_TOL)
    _, _, f1 = bertscore.greedy_match_scores(c, cm, c, cm)
    np.testing.assert_allclose(f1[1:], 1.0, atol=METRIC_TOL)  # a text against itself


@pytest.fixture(scope="module")
def models(tokenizers):
    """(JAX model, its params, the port's model) on the same ``debug``
    weights, gates opened."""
    jtok, _ = tokenizers
    vocab = -(-len(jtok) // 128) * 128
    jcfg = j_get_config("debug", dtype="float32")
    jmodel = JModel(jcfg.replace(lm=dataclasses.replace(jcfg.lm, vocab_size=vocab)))
    media = jtok.media_token_id
    ids = jnp.ones((1, 8), jnp.int32).at[0, 1].set(media)
    img = jcfg.vision.image_size
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), ids,
                                  vision_x=jnp.zeros((1, 1, img, img, 3), jnp.float32),
                                  q_media=j_compute_q_media(ids, media))["params"]
    for key in params:
        if key.startswith("xattn_"):
            params[key]["attn_gate"] = jnp.asarray(1.0)
            params[key]["ff_gate"] = jnp.asarray(1.0)
    # the selection tokens' rows of the (tied) embedding scaled up, so that
    # img_sel's answers hold some s_i (random weights rarely pick 5 tokens of
    # the vocabulary)
    sel = jnp.asarray([jtok.convert_tokens_to_ids(f"s_{i}") for i in range(5)])
    emb = params["embed"]["embedding"]
    params["embed"]["embedding"] = emb.at[sel].multiply(6.0)
    cfg = get_config("debug", dtype="float32")
    tmodel = UniMPModel(cfg.replace(lm=dataclasses.replace(cfg.lm, vocab_size=vocab)))
    load_flax_params(tmodel, {k: np.asarray(v) for k, v in flatten_tree(params).items()})
    return jmodel, params, tmodel.eval()


def test_return_hidden_matches_jax(models, tokenizers):
    """The final-norm hidden states (no lm head) with right padding, and
    with media, within 1e-5."""
    jmodel, params, tmodel = models
    media = tokenizers[0].media_token_id
    rng = np.random.default_rng(4)
    ids = rng.integers(1, media, size=(3, 20)).astype(np.int32)
    ids[:, 2] = media
    lens = np.array([20, 13, 0], np.int32)
    img = jmodel.cfg.vision.image_size
    vision = rng.normal(size=(3, 1, img, img, 3)).astype(np.float32)
    apply = jax.jit(lambda p, i, n, **kw: jmodel.apply({"params": p}, i, kv_len=n,
                                                       return_hidden=True, **kw)[0])
    for with_media in (False, True):
        kw = dict(vision_x=jnp.asarray(vision),
                  q_media=j_compute_q_media(jnp.asarray(ids), media)) if with_media else {}
        want = apply(params, jnp.asarray(ids), jnp.asarray(lens), **kw)
        tkw = dict(vision_x=torch.from_numpy(vision),
                   q_media=torch.from_numpy(np.array(kw["q_media"]))) if with_media else {}
        with torch.no_grad():
            got, none = tmodel(torch.from_numpy(ids).long(), kv_len=torch.from_numpy(lens),
                               return_hidden=True, **tkw)
        assert none is None and got.shape == want.shape == (3, 20, jmodel.cfg.lm.hidden_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=EMB_TOL, atol=EMB_TOL)


def test_model_bertscore_matches_jax(models, tokenizers):
    """The scorer over the model's text tower: 20 pairs (two batches of 16,
    the second padded), an empty candidate, a pair of equal texts and one
    longer than the 64-token window; F1 within 1e-5."""
    jmodel, params, tmodel = models
    jtok, tok = tokenizers
    rng = np.random.default_rng(5)
    words = "soft cream brush great value for the price too greasy really love".split()
    cands = [" ".join(rng.choice(words, size=int(rng.integers(1, 12)))) for _ in range(20)]
    refs = [" ".join(rng.choice(words, size=int(rng.integers(1, 12)))) for _ in range(20)]
    cands[0], refs[1], cands[2] = "", cands[1], " ".join(["cream"] * 80)
    want = j_bertscore.make_model_bertscore(jmodel, params, jtok)(cands, refs)
    got = bertscore.make_model_bertscore(tmodel, tok)(cands, refs)
    assert got.shape == want.shape == (20,)
    np.testing.assert_allclose(got, want, rtol=0, atol=EMB_TOL)
    assert abs(got[1] - 1.0) < EMB_TOL
    assert bertscore.make_model_bertscore(tmodel, tok)([], []).shape == (0,)


class Retarget:
    """A loader whose batches carry the given targets, in order."""

    def __init__(self, loader, targets):
        self.loader, self.dataset, self.targets = loader, loader.dataset, targets

    def __iter__(self):
        it = iter(self.targets)
        for batch in self.loader:
            yield dict(batch, targets=[next(it) for _ in batch["targets"]])


def _retarget(task, answers, targets):
    """Targets that the port's answers partly hit, so every metric is
    exercised (random weights never generate the true targets)."""
    if task == "exp":
        out = []
        for u, (row, t) in enumerate(zip(answers, targets)):
            words = row[0].split()
            out.append({"rating": float(1 + u % 5), "explanation":
                        " ".join(words[1 + u % 2: 4 + u]) + " " + t["explanation"]})
        return out
    if task == "img_sel":
        out = []
        for u, (row, t) in enumerate(zip(answers, targets)):
            picked = sorted({int(w[2:]) for w in row[0].split()
                             if w.startswith("s_") and w[2:].isdigit()})
            out.append(picked[: 1 + u % 2] + [i for i in t if i not in picked][:1])
        return out
    return targets


@pytest.mark.parametrize("task", ["search", "exp", "img_sel", "img_gen"])
def test_evaluator_matches_jax(data, tokenizers, models, tmp_path, monkeypatch, task):
    """The JAX and port evaluators on the test split's 4 users, at each
    task's own decode (search 3 beams here, exp 5, img_sel 2, img_gen
    greedy): identical answers, metrics within 1e-12 (exp with the same
    stand-in BERTScore on both sides), the same dumps."""
    jmodel, params, tmodel = models
    jtok, tok = tokenizers
    jds, ds = _sets(data, tokenizers, task, "test")
    lkw = dict(shuffle=False, drop_last=False, num_workers=0, pad_to_multiple=128)
    jloader = JDataLoader(jds, 4, jtok.pad_token_id, **lkw)
    loader = DataLoader(ds, 4, tok.pad_token_id, **lkw)

    seen = {}
    for side, mod in (("jax", j_evaluators), ("port", evaluators)):
        orig = mod._generate_batches

        def spy(*args, _orig=orig, _side=side, **kw):
            for rows, batch, ips in _orig(*args, **kw):
                seen.setdefault(_side, []).extend(rows)
                seen.setdefault(f"{_side}_targets", []).extend(batch["targets"])
                yield rows, batch, ips

        monkeypatch.setattr(mod, "_generate_batches", spy)

    def stand_in(cands, refs):  # the same deterministic scorer on both sides
        return np.array([len(c) / (1.0 + len(r)) for c, r in zip(cands, refs)])

    kw = {"search": dict(num_beams=3), "exp": dict(bertscore_fn=stand_in),
          "img_sel": {}, "img_gen": {}}[task]
    targets = [s["target"] for s in (ds[i] for i in range(len(ds)))]
    if task in ("exp", "img_sel"):
        # a first port pass gives the answers the targets are set from
        evaluators.EVALUATORS[task](tmodel, loader, tok, **kw, **(
            {"dump_dir": str(tmp_path / "first")} if task == "exp" else {}))
        targets = _retarget(task, seen.pop("port"), seen.pop("port_targets"))
    outs = {}
    for side, fn, model_args, tk in (
            ("jax", J_EVALUATORS[task], (jmodel, params), jtok),
            ("port", evaluators.EVALUATORS[task], (tmodel,), tok)):
        dump = {"exp": {"dump_dir": str(tmp_path / side)},
                "img_gen": {"dump_path": str(tmp_path / side / "img_gen.json")}}.get(task, {})
        lo = Retarget(jloader if side == "jax" else loader, targets)
        outs[side] = fn(*model_args, lo, tk, **kw, **dump)
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 4
    want, got = outs["jax"], outs["port"]
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if key in ("items_per_sec", "dump_path"):
            continue
        assert abs(got[key] - w) <= METRIC_TOL, (key, got[key], w)
    if task == "exp":
        assert 0 < got["bleu"] and 0 < got["rouge1"] and 0 < got["meteor"]
        for name in ("gen_exps_0.json", "real_exps_0.json"):
            assert json.loads((tmp_path / "port" / name).read_text()) == json.loads(
                (tmp_path / "jax" / name).read_text())
    if task == "img_sel":
        assert 0 < got["recall"] < 1 or 0 < got["precision"] < 1
    if task == "img_gen":
        a = json.loads((tmp_path / "port" / "img_gen.json").read_text())
        assert a == json.loads((tmp_path / "jax" / "img_gen.json").read_text())
        assert len(a) == 4 and all(set(g) == {"generated", "target", "item"} for g in a)


def test_run_evals_dump_wiring(data, tmp_path, monkeypatch):
    """As tests/test_cli.py::test_run_evals_dump_wiring, on both packages
    with stub evaluators: each task gets the same arguments (the JAX
    package's mesh aside), ``--num_beams`` reaches rec and search only,
    --eval_embed gives exp a scorer, and both append the same
    results_exp.txt."""
    calls = {}

    def make_stub(side, task):
        def stub(*args, **kw):
            calls[(side, task)] = kw
            return {"rmse": 1.0, "mae": 0.5, "bleu": 0.1, "rouge1": 0.1, "rouge2": 0.1,
                    "rougeL": 0.1, "meteor": 0.1, "bertscore": 0.2}
        return stub

    tasks = ["rec", "search", "exp", "img_sel", "img_gen"]
    for task in tasks:
        monkeypatch.setitem(J_EVALUATORS, task, make_stub("jax", task))
        monkeypatch.setitem(evaluators.EVALUATORS, task, make_stub("port", task))
    for side, parser, run_evals, logger_cls, com in (
            ("jax", j_build_parser, j_mmrec.run_evals, JMetricLogger, j_common),
            ("port", build_parser, mmrec.run_evals, MetricLogger, common)):
        args = parser().parse_args([
            "--mmrec_path", data, "--external_save_dir", str(tmp_path / side),
            "--run_name", "dumps", "--subset", "beauty", "--n_items", str(N_ITEMS),
            "--patch-image-size", "28", "--num_beams", "7", "--eval_embed"])
        tok = com.build_tokenizer(args)
        monkeypatch.setattr("unimp_tpu.evals.bertscore.make_model_bertscore" if side == "jax"
                            else "unimp_tpu_torch.cli.mmrec.make_model_bertscore",
                            lambda *a, **k: "scorer")
        run_dir = os.path.join(str(tmp_path / side), "dumps")
        model = torch.nn.Linear(1, 1) if side == "port" else None
        model_args = (model,) if side == "port" else (None, None)
        run_evals(args, *model_args, tok, logger_cls(run_dir, "dumps"), epoch=3, tasks=tasks,
                  split="eval")
    for task in tasks:
        want = {k: v for k, v in calls[("jax", task)].items() if k != "mesh"}
        got = {k: str(v).replace(str(tmp_path / "port"), str(tmp_path / "jax"))
               if isinstance(v, str) else v for k, v in calls[("port", task)].items()}
        assert sorted(got) == sorted(want), task
        for k, v in want.items():
            if k != "cache_holder":
                assert got[k] == v, (task, k)
    assert calls[("port", "rec")]["num_beams"] == calls[("port", "search")]["num_beams"] == 7
    assert "num_beams" not in calls[("port", "exp")]
    assert calls[("port", "exp")]["bertscore_fn"] == "scorer"
    assert calls[("port", "img_gen")]["dump_path"].endswith(
        "save_img_gen/img_gen_0_epoch_3_name_dumps.json")
    txt = [(tmp_path / side / "dumps" / "results_exp.txt").read_text() for side in ("jax", "port")]
    assert txt[0] == txt[1] and "rmse: 1.0" in txt[1] and "bertscore: 0.2" in txt[1]
