"""The port's span recorder (``unimp_tpu_torch/utils/profiling.py``) and
the spans the hot paths open, on the CPU at the ``debug`` sizes: nothing
is recorded while off, spans nest by thread, a beam or greedy
``generate`` and a ``Trainer`` record their layers and reads step by
step, recording changes no result, and ``maybe_trace`` (the CLIs'
``--trace_dir``, training and evals) writes the spans into its trace on
the profiler's time base."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from unimp_tpu_torch.cli import mmrec, mmrec_eval
from unimp_tpu_torch.decode import GenerationConfig, Generator
from unimp_tpu_torch.evals import evaluators
from unimp_tpu_torch.models import get_config
from unimp_tpu_torch.tools import synth_data
from unimp_tpu_torch.tools.from_flax import build_model
from unimp_tpu_torch.train.optimizer import MultiSteps, make_optimizer
from unimp_tpu_torch.train.partition import trainable_params
from unimp_tpu_torch.train.trainer import Trainer
from unimp_tpu_torch.utils import profiling

torch.set_num_threads(2)  # six test workers share the cores
MEDIA, ANSWER, EOC, PAD, EOS = 7, 8, 9, 0, 3


def children(rec, index):
    return [i for i, s in enumerate(rec.spans) if s[3] == index]


def descendants(rec, index):
    out, todo = [], children(rec, index)
    while todo:
        i = todo.pop()
        out.append(i)
        todo.extend(children(rec, i))
    return out


def names(rec, indices):
    return sorted(rec.spans[i][0] for i in indices)


def test_off_records_nothing_and_shares_one_object(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock while off")

    monkeypatch.setattr(time, "time_ns", no_clock)
    off = profiling.span("a")
    assert profiling.span("b") is off and profiling.read("done") is off
    with profiling.span("a"), profiling.read("done"):
        profiling.request("generate")
    monkeypatch.undo()
    with profiling.recording() as rec:
        with profiling.span("on"):
            pass
    with profiling.span("after"):
        pass
    assert [s[0] for s in rec.spans] == ["on"] and not rec.reads and not rec.requests


def test_spans_nest_with_parents_per_thread():
    opened = threading.Event()
    done = threading.Event()

    def other():
        with profiling.span("t.outer"):
            with profiling.span("t.inner"):
                opened.set()
                assert done.wait(10)

    with profiling.recording() as rec:
        profiling.request("update")
        with profiling.span("a"):
            thread = threading.Thread(target=other)
            thread.start()
            assert opened.wait(10)
            with profiling.span("b"):
                with profiling.read("finite"):
                    pass
            done.set()
            thread.join(10)
        assert not thread.is_alive()
        profiling.request("generate")
        with profiling.span("c"):
            pass
    by_name = {s[0]: (i, s) for i, s in enumerate(rec.spans)}
    parent = {name: s[3] for name, (_, s) in by_name.items()}
    index = {name: i for name, (i, _) in by_name.items()}
    assert parent["a"] == -1 and parent["b"] == index["a"]
    assert parent["read.finite"] == index["b"]
    assert parent["t.outer"] == -1 and parent["t.inner"] == index["t.outer"]
    assert parent["c"] == -1
    assert rec.reads == {"finite": 1} and rec.requests == ["update", "generate"]
    assert {s[0]: s[4] for s in rec.spans} == {"a": 0, "b": 0, "read.finite": 0,
                                              "t.outer": 0, "t.inner": 0, "c": 1}
    for name, start, end, _, _ in rec.spans:
        assert start <= end, name
    a, b = by_name["a"][1], by_name["b"][1]
    assert a[1] <= b[1] and b[2] <= a[2]


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    m = build_model(get_config("debug", dtype="float32"), device="cpu")
    for name, p in m.named_parameters():
        if name.endswith("_gate"):
            p.data.fill_(1.0)  # the cross-attention blocks open
    return m


def prompts(model, b=2, t=12):
    rng = np.random.default_rng(3)
    ids = rng.integers(10, model.cfg.lm.vocab_size, size=(b, t))
    ids[:, 1] = MEDIA
    seq_len = np.array([t, t - 3])[:b]
    for r in range(b):
        ids[r, seq_len[r]:] = PAD
    g = torch.Generator().manual_seed(4)
    latents = torch.randn(b, 1, model.cfg.resampler.num_latents, model.cfg.vision.hidden_size,
                          generator=g)
    return torch.from_numpy(ids), torch.from_numpy(seq_len), latents


@pytest.mark.parametrize("beams", [1, 3])
def test_generate_records_each_step(model, beams):
    gen = Generator(model, GenerationConfig(max_new_tokens=5, eos_id=EOS, pad_id=PAD,
                                            num_beams=beams, num_return_sequences=beams),
                    media_id=MEDIA)
    ids, seq_len, latents = prompts(model)
    off = gen.generate(ids, seq_len, latents)
    with profiling.recording() as rec:
        on = gen.generate(ids, seq_len, latents)
    for a, b in zip(off, on):
        assert torch.equal(a, b)

    layers = model.cfg.lm.num_layers
    n_xattn = sum(1 for _, x in model._layers() if x is not None)
    steps = [i for i, s in enumerate(rec.spans) if s[0] == "generate.step"]
    decoded = [i for i in steps if "generate.decode" in names(rec, children(rec, i))]
    assert len(decoded) == 5 and all(rec.spans[i][3] == -1 for i in steps)
    for i in decoded:
        below = names(rec, descendants(rec, i))
        reads = [n for n in below if n.startswith("read.")]
        assert reads == ["read.done"] + ["read.top_k"] * (3 if beams > 1 else 0)
        assert below.count("generate.decode") == below.count("generate.select") == 1
        assert below.count("model.block") == layers and below.count("model.xattn") == n_xattn
        assert below.count("model.embed") == below.count("model.logits") == 1
        assert names(rec, children(rec, i)) == ["generate.decode", "generate.select",
                                                 "read.done"]
    # a loop that stops early ends in a step holding only its check
    for i in set(steps) - set(decoded):
        assert i == steps[-1] and names(rec, descendants(rec, i)) == ["read.done"]
    prefill = [i for i, s in enumerate(rec.spans) if s[0] == "generate.prefill"]
    assert len(prefill) == 1
    assert names(rec, children(rec, prefill[0])).count("model.block") == layers
    # the finished set's last top-k reads once more, outside the steps
    tail = 1 if beams > 1 else 0
    assert rec.reads["top_k"] == 3 * len(decoded) * (beams > 1) + tail
    assert rec.reads["done"] == len(steps)
    assert rec.requests == ["generate"] and {s[4] for s in rec.spans} == {0}


def train_batch(b, seed):
    rng = np.random.default_rng(seed)
    t = 24
    ids = rng.integers(10, 512, size=(b, t)).astype(np.int32)
    seq_len = rng.integers(19, t + 1, size=b).astype(np.int32)
    for r in range(b):
        ids[r, 2] = ids[r, 9] = MEDIA
        ids[r, 14] = ANSWER
        ids[r, 18] = EOC
        ids[r, seq_len[r]:] = PAD
    return {"input_ids": ids, "seq_len": seq_len,
            "weights": rng.uniform(0.5, 1.5, size=b).astype(np.float32),
            "images": rng.integers(0, 256, size=(b, 2, 28, 28, 3), dtype=np.uint8)}


def trainer(remat=False):
    torch.manual_seed(0)
    cfg = get_config("debug", dtype="float32", remat=remat)
    m = build_model(cfg, device="cpu", train=True)
    opt = MultiSteps(make_optimizer(trainable_params(m), learning_rate=1e-3), 2)
    return Trainer(m, opt, media_id=MEDIA, answer_id=ANSWER, endofchunk_id=EOC, pad_id=PAD,
                   use_reweight=True, device="cpu")


@pytest.mark.parametrize("remat", [False, True])
def test_trainer_records_each_micro_batch(remat):
    batches = [train_batch(2, seed) for seed in range(4)]
    t = trainer(remat)
    losses = [float(t.train_step(batches[0])["loss"])]
    with profiling.recording() as rec:
        losses += [float(t.train_step(b)["loss"]) for b in batches[1:]]
    t_off = trainer(remat)
    off = [float(t_off.train_step(b)["loss"]) for b in batches]
    assert losses == off

    steps = [i for i, s in enumerate(rec.spans) if s[0] == "train.step"]
    assert len(steps) == 3
    layers = t.model.cfg.lm.num_layers
    for n, i in enumerate(steps):
        kids = names(rec, children(rec, i))
        assert kids == ["read.finite", "train.backward", "train.forward", "train.grad_norm",
                        "train.optimizer"]
        opt = next(j for j in children(rec, i) if rec.spans[j][0] == "train.optimizer")
        # the first update's second micro-batch, then the second update's two
        want = ["optimizer.accumulate"] + (["optimizer.apply"] if n != 1 else [])
        assert names(rec, children(rec, opt)) == want
        fwd = next(j for j in children(rec, i) if rec.spans[j][0] == "train.forward")
        bwd = next(j for j in children(rec, i) if rec.spans[j][0] == "train.backward")
        assert names(rec, descendants(rec, fwd)).count("model.block") == layers
        assert names(rec, descendants(rec, fwd)).count("vision.tower") == 1
        # remat recomputes each block in the backward, on the thread that runs it
        assert names(rec, descendants(rec, bwd)).count("model.block") == (layers if remat else 0)
    assert rec.reads == {"finite": 3}
    assert rec.requests == ["update"]  # the micro-batch after the first starts the second
    assert [rec.spans[i][4] for i in steps] == [-1, 0, 0]


def test_maybe_trace_writes_the_spans_on_the_profilers_time_base(tmp_path):
    x = torch.ones(64, 64)
    with profiling.maybe_trace(str(tmp_path)):
        with profiling.span("outer"):
            with profiling.span("inner"):
                y = x @ x
            with profiling.read("done"):
                bool((y > 0).all())
    trace = json.loads((tmp_path / "trace.json").read_text())
    events = trace["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(spans) == {"outer", "inner", "read.done"}
    assert spans["inner"]["args"]["parent"] == spans["outer"]["args"]["index"]
    mm = [e for e in events if e.get("name") in ("aten::mm", "aten::matmul")
          and e.get("ph") == "X"]
    assert mm
    inner = spans["inner"]
    for e in mm:  # the profiler's matmul falls inside the span that holds it
        assert inner["ts"] <= e["ts"] and e["ts"] + e["dur"] <= inner["ts"] + inner["dur"]


def _trace_file(tmp_path, layout):
    """A Chrome trace as a profiler writes it, its scalar keys before the
    events ("head", torch's newer layout), after them ("tail", the older),
    around an empty array ("empty"), or followed by a list ("list")."""
    events = [] if layout == "empty" else [{"ph": "X", "name": "aten::mm", "ts": 5.0,
                                           "dur": 1.0, "pid": 1, "tid": 1,
                                           "args": {"shape": [[2, 2], [2]]}}]
    body = ",\n  ".join(json.dumps(e) for e in events)
    base = '"baseTimeNanoseconds": 1000000000'
    if layout == "head":
        text = '{"schemaVersion": 1, %s,\n "traceEvents": [\n  %s\n  ],' \
            '"traceName": "a]b.json" }' % (base, body)
    elif layout == "list":
        text = '{"traceEvents": [%s], %s, "extra": [1]}' % (body, base)
    else:
        text = '{"schemaVersion": 1, "deviceProperties": [],\n "traceEvents": [\n  %s\n  ],\n' \
            ' "traceName": "t.json", "displayTimeUnit": "ms", %s\n}' % (body, base)
    path = tmp_path / "trace.json"
    path.write_text(text)
    return path, events


@pytest.mark.parametrize("layout", ["head", "tail", "empty", "list"])
def test_spans_go_into_the_trace_on_its_time_base(tmp_path, layout):
    path, events = _trace_file(tmp_path, layout)
    # the events are not parsed, but for a list after them
    assert (profiling._events_end(path.read_bytes()) is None) == (layout == "list")
    rec = profiling.Record()
    rec.spans = [["outer", 1_000_004_000, 1_000_009_000, -1, 0],
                 ["read.done", 1_000_005_000, 1_000_006_500, 0, 0],
                 ["open", 1_000_007_000, None, 0, 0]]
    profiling._add_spans_to_trace(str(path), rec)
    trace = json.loads(path.read_text())
    assert trace["baseTimeNanoseconds"] == 1_000_000_000
    assert trace["traceEvents"][:len(events)] == events
    spans = [e for e in trace["traceEvents"] if e.get("cat") == "program_span"]
    assert [(e["name"], e["ts"], e["dur"], e["args"]["parent"]) for e in spans] == \
        [("outer", 4.0, 5.0, -1), ("read.done", 5.0, 1.5, 0)]


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    synth_data.generate(str(d), n_items=40, n_users=24, image_size=28, seed=0)
    return str(d)


@pytest.mark.parametrize("entry", ["mmrec", "mmrec_eval"])
def test_trace_dir_holds_the_evals_spans(cli_data, tmp_path, entry):
    """``--trace_dir`` traces the evals too: the beam loop's spans and reads
    are in ``trace.json`` (``mmrec``: after the epoch's training steps)."""
    argv = ["--mmrec_path", cli_data, "--external_save_dir", str(tmp_path), "--run_name",
            "cli", "--pretrained_model_name_or_path", "debug", "--subset", "beauty",
            "--task", "rec", "--single_task", "--n_items", "40", "--history_len", "5",
            "--patch-image-size", "28", "--eval_batch_size", "4", "--num_beams", "3",
            "--max_records", "4", "--workers", "0", "--precision", "fp32", "--do_test",
            "--device", "cpu", "--trace_dir", str(tmp_path / "trace")]
    if entry == "mmrec":
        argv += ["--batch_size", "2", "--num_epochs", "1", "--warmup_steps", "0"]
        mmrec.main(argv)
    else:
        mmrec_eval.main(argv)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    spans = [e for e in trace["traceEvents"] if e.get("cat") == "program_span"]
    got = {e["name"] for e in spans}
    assert {"generate.prefill", "generate.step", "generate.decode", "generate.select",
            "read.done", "read.top_k", "model.block", "model.xattn"} <= got
    assert ("train.step" in got) == (entry == "mmrec")
    # the spans sit on the profiler's clock: inside the trace's own events
    others = [e for e in trace["traceEvents"] if e.get("ph") == "X"
              and e.get("cat") != "program_span"]
    first, last = min(e["ts"] for e in others), max(e["ts"] + e["dur"] for e in others)
    assert all(first <= e["ts"] and e["ts"] + e["dur"] <= last for e in spans)


class _Tokenizer:
    media_token_id, eos_token_id = MEDIA, EOS

    def batch_decode(self, rows, skip_special_tokens=True):
        return ["a? item_1" for _ in rows]


def test_items_per_sec_is_users_over_the_loops_wall(monkeypatch):
    """4 users in 0.1 s, then 1 in 0.3 s: 5 over 0.4 s (12.5 a second; the
    mean of the two batches' rates would be 21.7)."""
    seconds = {4: 0.1, 1: 0.3}

    class Slow:
        def __init__(self, model, cfg, media_id):
            self.cfg = cfg

        def generate(self, ids, seq_len, latents):
            time.sleep(seconds[ids.shape[0]])
            return torch.zeros(ids.shape[0], self.cfg.num_return_sequences, 2,
                               dtype=torch.long), None

    monkeypatch.setattr(evaluators, "Generator", Slow)
    loader = [{"input_ids": np.ones((n, 4), np.int64), "seq_len": np.full(n, 4),
               "targets": ["item_1"] * n} for n in (4, 1)]
    metrics = evaluators.evaluate_rec(torch.nn.Linear(1, 1), loader, _Tokenizer(),
                                      num_beams=2)
    assert metrics["n_users"] == 5
    assert 5 / 0.6 < metrics["items_per_sec"] <= 5 / 0.4
