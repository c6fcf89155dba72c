"""The port's few-shot harness and its CLI against the JAX package's.

Metrics: CIDEr-D, the VQA normalization and accuracy rule, the OK-VQA
stemmer and the generation post-processing, on the JAX tests' golden
cases and on seeded random strings (equal floats, equal strings). Loops:
``evaluate_captioning`` (3 beams), ``evaluate_vqa`` (greedy, VQA and
OK-VQA) and ``evaluate_classification`` (every class prompt in one
forward) on ``debug`` in float32, the JAX weights loaded into the port
(``from_flax``) with the cross-attention gates opened so the images
count: the same decoded tokens, CIDEr, accuracy and argmax classes.
``cli/evaluate.main`` end to end (COCO, OK-VQA, ImageNet; two trial
seeds) on a port checkpoint against the JAX ``main`` on an Orbax
checkpoint of the same weights, and on that Orbax checkpoint itself: the
same results JSON. Prompts are built
so that every record of a loop has one length (one JAX compile a loop).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimp_tpu.cli import evaluate as j_cli
from unimp_tpu.evals import benchmark_harness as j_bh
from unimp_tpu.evals import vqa_normalize as j_vqa
from unimp_tpu.models import UniMPModel as JModel
from unimp_tpu.models import compute_q_media as j_compute_q_media
from unimp_tpu.models import get_config as j_get_config
from unimp_tpu.tools import synth_data as j_synth
from unimp_tpu.train.checkpoint import save_params as j_save_params
from unimp_tpu_torch.cli import evaluate as t_cli
from unimp_tpu_torch.data.tokenizer import UniMPTokenizer
from unimp_tpu_torch.evals import benchmark_harness as t_bh
from unimp_tpu_torch.evals import vqa_normalize as t_vqa
from unimp_tpu_torch.models import get_config
from unimp_tpu_torch.tools.from_flax import build_model, flatten_tree
from unimp_tpu_torch.train.checkpoint import save_params

torch.set_num_threads(2)  # six test workers share the cores

# --------------------------------------------------------------- metrics

GOLDEN_REFS = [
    ["a cat sits on a mat", "the cat is on the mat"],
    ["a dog runs quickly", "dogs run fast"],
    ["a red lipstick on a table", "lipstick placed on the table"],
]
GOLDEN_PREDS = [["a cat sits on a mat", "a dog runs quickly", "a red lipstick on a table"],
                ["totally unrelated words here", "nothing in common", "gibberish tokens only"],
                ["the cat", "dog dog dog dog", "a red table on a lipstick"]]
TRICKY = [
    "don't", "do not", "dont know", "2", "two", "twenty two", "none",
    "a dog", "an apple", "the white house", "1,000", "10,000 feet",
    "yes!", "no?", "black/white", "semi-circle", "b&w photo",
    "it's 2.5 meters", "1.5", ".5", "a.m.", "U.S.A.", "what? is, this.",
    "he's  got   spaces", "tab\there", "new\nline", "", "   ",
    "mc donald's", "(parenthetical)", "[brackets]", "quote\"inside",
    "one; two; three", "x = y + z", "a_b_c", "<html>", "`tick`",
    "50,000", "one hundred", "zero", "ten", "could've been",
    "y'all'd've", "." * 40,
]
VQA_CASES = [
    ("2", ["two", "2", "two", "one", "2", "two", "2", "2", "two", "2"]),
    ("don't", ["do not"] * 5 + ["dont"] * 5),
    ("Blue.", ["blue"] * 10),
    ("blue", ["blue"] * 10),
    ("the cat", ["cat", "cat", "dog", "cat", "cat", "kitten", "cat", "cat", "cat", "cat"]),
    ("1,000", ["1000", "one thousand", "1,000", "1000", "1000", "thousand", "1000", "1000",
               "1000", "1000"]),
    ("light blue", ["blue", "blue", "blue", "light blue", "navy", "blue", "blue", "azure",
                    "blue", "blue"]),
    ("", ["yes"] * 9 + ["no"]),
]
STEMS = ["christmas", "riding", "leaves", "clothes", "firefighters", "yes", "running",
         "sitting", "spelling", "dogs", "benches", "berries", "glass", "skiing man",
         "two dogs playing", "buses", "watches", "knives", "children", "flying kites"]
WORDS = ["a", "the", "an", "cat", "cats", "dog", "two", "2", "ten", "10", "blue", "red",
         "don't", "dont", "it's", "on", "mat", "1,000", "1.5", "yes", "no", "running",
         "Question:", "Answer:", "berries", "u.s.a.", "black/white", "(x)", "semi-circle",
         "playing", "leaves", "!", "?", ".", ","]


def _random_strings(rng, n, lo=0, hi=8):
    return [" ".join(rng.choice(WORDS, rng.integers(lo, hi + 1))) for _ in range(n)]


def test_cider_matches_jax_on_goldens_and_random_corpora():
    for preds in GOLDEN_PREDS:
        assert t_bh.cider_d(preds, GOLDEN_REFS) == j_bh.cider_d(preds, GOLDEN_REFS)
    assert t_bh.cider_d([], []) == j_bh.cider_d([], []) == 0.0
    rng = np.random.default_rng(11)
    for _ in range(20):
        n = int(rng.integers(1, 7))
        preds = _random_strings(rng, n)
        refs = [_random_strings(rng, int(rng.integers(1, 4)), 1) for _ in range(n)]
        assert t_bh.cider_d(preds, refs) == j_bh.cider_d(preds, refs)
        toks = t_bh._caption_tokens(preds[0])
        assert toks == j_bh._caption_tokens(preds[0])
        assert t_bh._ngram_counts(toks) == j_bh._ngram_counts(toks)


def test_vqa_rule_stemmer_and_postprocess_match_jax():
    rng = np.random.default_rng(12)
    texts = TRICKY + _random_strings(rng, 200)
    for s in texts:
        assert t_vqa.process_punctuation(s) == j_vqa.process_punctuation(s), s
        assert t_vqa.process_digit_article(s) == j_vqa.process_digit_article(s), s
        assert t_vqa.postprocess_vqa_generation(s) == j_vqa.postprocess_vqa_generation(s), s
        assert (t_vqa.postprocess_ok_vqa_generation(s)
                == j_vqa.postprocess_ok_vqa_generation(s)), s
    for s in STEMS + _random_strings(rng, 100, 1, 4):
        assert t_vqa.okvqa_stem(s) == j_vqa.okvqa_stem(s), s
    cases = VQA_CASES + [(p, list(rng.choice(WORDS[:20], 10))) for p in _random_strings(rng, 100)]
    for pred, answers in cases:
        assert t_bh.vqa_accuracy(pred, answers) == j_bh.vqa_accuracy(pred, answers), pred
    assert t_vqa.okvqa_stem("riding") == "ride"
    assert t_vqa.vqa_accuracy("Blue.", ["blue"] * 10) == 0.0


# ----------------------------------------------------------------- loops

class _Recorder:
    """A tokenizer proxy that keeps every list of ids it decodes."""

    def __init__(self, tok):
        self.tok, self.decoded = tok, []

    def __getattr__(self, name):
        return getattr(self.tok, name)

    def __len__(self):
        return len(self.tok)

    def decode(self, ids, *a, **kw):
        self.decoded.append([int(i) for i in ids])
        return self.tok.decode(ids, *a, **kw)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """Synth data, the JAX tokenizer and the port's copy of it, ``debug``
    weights (vocab rounded to 128, gates opened) in both packages."""
    d = str(tmp_path_factory.mktemp("harness"))
    j_synth.generate(d, n_items=16, n_users=8, image_size=28)
    jtok = j_synth.build_tokenizer(d, n_items=16)
    tok_path = os.path.join(d, "tok.json")
    jtok.save(tok_path)
    ttok = UniMPTokenizer.load(tok_path)
    vocab = ((len(jtok) + 127) // 128) * 128
    jcfg = j_get_config("debug", dtype="float32")
    jcfg = jcfg.replace(lm=dataclasses.replace(jcfg.lm, vocab_size=vocab))
    jmodel = JModel(jcfg)
    ids = jnp.ones((1, 8), jnp.int32).at[0, 1].set(jtok.media_token_id)
    img = jcfg.vision.image_size
    params = jmodel.init(jax.random.PRNGKey(0), ids,
                         vision_x=jnp.zeros((1, 1, img, img, 3), jnp.float32),
                         q_media=j_compute_q_media(ids, jtok.media_token_id))["params"]
    params = jax.tree_util.tree_map(lambda x: x, params)
    for key in params:
        if key.startswith("xattn_"):
            params[key]["attn_gate"] = jnp.asarray(1.0)
            params[key]["ff_gate"] = jnp.asarray(1.0)
    flat = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
    tcfg = get_config("debug", dtype="float32")
    tcfg = tcfg.replace(lm=dataclasses.replace(tcfg.lm, vocab_size=vocab))
    tmodel = build_model(tcfg, device="cpu", weights=flat)
    images = [os.path.join(d, "beauty", f"{i}.jpg") for i in range(6)]
    return dict(dir=d, jtok=jtok, ttok=ttok, tok_path=tok_path, jmodel=jmodel,
                params=params, tmodel=tmodel, images=images, img=img)


def _manifests(h, out):
    """COCO-, VQA- and ImageNet-style manifests over the synth JPEGs; every
    caption, question and answer one word of the corpus vocabulary long,
    so a loop's prompts share their token length."""
    words = [w for w in ("cream", "serum", "soft", "bright", "gentle", "daily")
             if len(h["jtok"].encode(w)) == 1]
    assert len(words) >= 3, words
    cap = [{"image": p, "captions": [words[i % len(words)], words[(i + 1) % len(words)]]}
           for i, p in enumerate(h["images"])]
    vqa = [{"image": p, "question": words[(i + 2) % len(words)],
            "answers": [words[i % len(words)]] * 6 + [words[(i + 1) % len(words)]] * 4}
           for i, p in enumerate(h["images"])]
    paths = {}
    for name, rows in (("cap", cap), ("vqa", vqa)):
        paths[name] = os.path.join(out, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(rows, f)
    paths["classes"] = words[:4] + ["gentle cream", "bright daily serum"]
    return paths


def test_captioning_matches_jax(harness, tmp_path):
    h, m = harness, _manifests(harness, tmp_path)
    jrec, trec = _Recorder(h["jtok"]), _Recorder(h["ttok"])
    for shots in (0, 2):
        want = j_bh.evaluate_captioning(h["jmodel"], h["params"], jrec, m["cap"],
                                        num_shots=shots, image_size=h["img"], limit=3,
                                        max_new_tokens=5, seed=4)
        got = t_bh.evaluate_captioning(h["tmodel"], trec, m["cap"], num_shots=shots,
                                       image_size=h["img"], limit=3, max_new_tokens=5, seed=4)
        assert got == want
    assert trec.decoded == jrec.decoded and len(trec.decoded) == 6


@pytest.mark.parametrize("ok_vqa", [False, True])
def test_vqa_matches_jax(harness, tmp_path, ok_vqa):
    h, m = harness, _manifests(harness, tmp_path)
    jrec, trec = _Recorder(h["jtok"]), _Recorder(h["ttok"])
    for shots in (0, 2):
        want = j_bh.evaluate_vqa(h["jmodel"], h["params"], jrec, m["vqa"], num_shots=shots,
                                 image_size=h["img"], limit=3, max_new_tokens=4, seed=5,
                                 ok_vqa=ok_vqa)
        got = t_bh.evaluate_vqa(h["tmodel"], trec, m["vqa"], num_shots=shots,
                                image_size=h["img"], limit=3, max_new_tokens=4, seed=5,
                                ok_vqa=ok_vqa)
        assert got == want
    assert trec.decoded == jrec.decoded and len(trec.decoded) == 6


def test_classification_matches_jax(harness, tmp_path):
    """The port's argmax classes, written as the labels, give JAX top-1 1.0
    (JAX picks the same class for every image); labels shifted by one give
    both sides the same top-1."""
    h, m = harness, _manifests(harness, tmp_path)
    names = m["classes"]
    picked = []
    probe = tmp_path / "probe.json"
    probe.write_text(json.dumps([{"image": p, "label": 0} for p in h["images"][:4]]))
    t_bh.evaluate_classification(h["tmodel"], h["ttok"], str(probe), names,
                                 image_size=h["img"], predictions=picked)
    assert len(picked) == 4
    for shift in (0, 1):
        man = tmp_path / f"cls{shift}.json"
        man.write_text(json.dumps([{"image": p, "label": (c + shift) % len(names)}
                                   for p, c in zip(h["images"][:4], picked)]))
        want = j_bh.evaluate_classification(h["jmodel"], h["params"], h["jtok"], str(man),
                                            names, image_size=h["img"])
        got = t_bh.evaluate_classification(h["tmodel"], h["ttok"], str(man), names,
                                           image_size=h["img"])
        assert got == want
        assert got["top1"] == (1.0 if shift == 0 else 0.0)


def test_evaluate_cli_matches_jax(harness, tmp_path):
    """``cli/evaluate.main`` on the port's checkpoint and the JAX ``main``
    on an Orbax checkpoint of the same weights write the same results."""
    h, m = harness, _manifests(harness, tmp_path)
    j_save_params(str(tmp_path / "orbax"), h["params"], name="final_weights")
    save_params(str(tmp_path / "port"), h["tmodel"], name="final_weights")
    classes = tmp_path / "classes.json"
    classes.write_text(json.dumps(m["classes"]))
    cls = tmp_path / "cls.json"
    cls.write_text(json.dumps([{"image": p, "label": i % 3}
                               for i, p in enumerate(h["images"][:3])]))
    common = ["--tokenizer_path", h["tok_path"], "--variant", "debug", "--precision", "fp32",
              "--image_size", str(h["img"]), "--shots", "1", "--trial_seeds", "7", "8",
              "--num_samples", "2",
              "--eval_coco", "--coco_manifest", m["cap"],
              "--eval_ok_vqa", "--ok_vqa_manifest", m["vqa"],
              "--eval_imagenet", "--imagenet_manifest", str(cls),
              "--imagenet_classes", str(classes)]
    want = j_cli.main(["--checkpoint_dir", str(tmp_path / "orbax")] + common
                      + ["--results_file", str(tmp_path / "jax.json")])
    got = t_cli.main(["--checkpoint_dir", str(tmp_path / "port"), "--device", "cpu"] + common
                     + ["--results_file", str(tmp_path / "port.json")])
    assert got == want
    assert list(got) == list(want) and len(got) == 3
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()


def test_evaluate_cli_refuses_orbax_and_runs_on_the_card_by_default(harness, tmp_path):
    """The port's ``main`` on the JAX package's Orbax checkpoint
    (``train/orbax.py``) writes the JAX ``main``'s results on the same
    directory; without ``--device`` it runs on the card, and raises where
    there is none."""
    h, m = harness, _manifests(harness, tmp_path)
    j_save_params(str(tmp_path / "orbax"), h["params"], name="final_weights")
    classes = tmp_path / "classes.json"
    classes.write_text(json.dumps(m["classes"]))
    cls = tmp_path / "cls.json"
    cls.write_text(json.dumps([{"image": p, "label": i % 3}
                               for i, p in enumerate(h["images"][:3])]))
    args = ["--checkpoint_dir", str(tmp_path / "orbax"), "--tokenizer_path", h["tok_path"],
            "--variant", "debug", "--precision", "fp32", "--image_size", str(h["img"])]
    bench = ["--shots", "1", "--trial_seeds", "7", "--num_samples", "2", "--eval_ok_vqa",
             "--ok_vqa_manifest", m["vqa"], "--eval_imagenet", "--imagenet_manifest", str(cls),
             "--imagenet_classes", str(classes)]
    want = j_cli.main(args + bench + ["--results_file", str(tmp_path / "jax.json")])
    got = t_cli.main(args + bench + ["--device", "cpu",
                                     "--results_file", str(tmp_path / "port.json")])
    assert got == want and len(got) == 2
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert t_cli.build_parser().parse_args(args).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_cli.main(args)


def test_bf16_build_casts_once_what_each_use_would_round(harness, tmp_path):
    """``--precision bf16`` casts the matrices to bfloat16 at the load; the
    logits equal those of float32 masters cast at each use (bf16 compute)."""
    h = harness
    save_params(str(tmp_path / "port"), h["tmodel"], name="final_weights")
    args = t_cli.build_parser().parse_args([
        "--checkpoint_dir", str(tmp_path / "port"), "--tokenizer_path", h["tok_path"],
        "--variant", "debug", "--precision", "bf16", "--image_size", str(h["img"]),
        "--device", "cpu"])
    cast = t_cli.build_model(args, h["ttok"])
    assert cast.embed.embedding.dtype == torch.bfloat16
    cfg = get_config("debug", dtype="bfloat16")
    cfg = cfg.replace(lm=dataclasses.replace(cfg.lm, vocab_size=h["tmodel"].cfg.lm.vocab_size),
                      vision=dataclasses.replace(cfg.vision, image_size=h["img"]))
    masters = build_model(cfg, device="cpu",
                          weights={k: v.detach() for k, v in flatten_tree_of(h["tmodel"]).items()})
    assert masters.embed.embedding.dtype == torch.float32
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, 100, (2, 12)))
    ids[:, 1] = h["ttok"].media_token_id
    vis = torch.from_numpy(rng.normal(size=(2, 1, h["img"], h["img"], 3)).astype(np.float32))
    from unimp_tpu_torch.models import compute_q_media

    with torch.no_grad():
        outs = [m(ids, vision_x=vis, q_media=compute_q_media(ids, h["ttok"].media_token_id))[0]
                for m in (cast, masters)]
    assert outs[0].dtype == outs[1].dtype
    assert torch.equal(outs[0], outs[1])


def flatten_tree_of(model):
    return {n.replace(".", "/"): t for n, t in model.state_dict().items()}
