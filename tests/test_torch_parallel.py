"""The port's multi-GPU path against the JAX package, on CPU process groups.

Each case spawns its ranks as processes (``tests/torch_parallel_worker.py``:
gloo over a ``FileStore`` under ``tmp_path``, one thread each, no JAX),
with one join timeout for the group, and holds what they report to the
JAX package run in this process on the suite's 8 virtual devices:

* the loader's rank shards == the JAX loader's (in process);
* ``evals/dist.py`` over 2 ranks: the values ``test_dist_multiprocess.py``
  asserts of the JAX gather;
* one ``Trainer`` step (float32, accum 2, ranks holding unequal counts of
  answer tokens) at dp 2, fsdp 2, tp 2 and (2, 2, 2) == the JAX
  ``Trainer`` on ``make_mesh(dp=2, fsdp=2, tp=2)`` at the same global
  batch: metrics within 1e-5 relative and the reduced gradients within
  5e-4 of each tensor's largest entry (the bars of
  ``tests/test_torch_train_cli.py``); the trainables after the step as
  ``tests/test_torch_train.py`` holds them (1e-2 lr where the gradient
  is above 1e-5, 2.01 lr elsewhere: Adam's first step moves an entry by
  lr * g / (|g| + eps), so a gradient within rounding of 0 may move it
  either way); the ranks' replicas equal bit for bit;
* ring attention over 2 ranks == ``ring_attention_sharded`` (8-way):
  forward 2e-5, gradients 3e-4 (``tests/test_ring_attention.py``), causal
  and with ``kv_len``;
* ``evaluate_rec`` over 5 users on 2 ranks at dp 2, fsdp 2 and tp 2 ==
  the JAX evaluator on one device, metrics within 1e-12;
* the weight bridge: a JAX tree (float and int8) placed on 2 tp ranks;
* ``mmrec.main`` on 2 ranks (tp 2, int8 frozen kernels, bf16 moments)
  writes a checkpoint that resumes in 1 rank bit for bit, and 1-rank
  checkpoints resume on 2 ranks (fsdp 2; tp 2 with int8 kernels).
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimp_tpu.data.dataset import TaskDataset as JTaskDataset
from unimp_tpu.data.loader import DataLoader as JDataLoader
from unimp_tpu.evals import evaluators as j_evaluators
from unimp_tpu.models import UniMPModel as JModel
from unimp_tpu.models import compute_q_media as j_compute_q_media
from unimp_tpu.models import get_config as j_get_config
from unimp_tpu.ops.ring_attention import ring_attention_sharded as j_ring
from unimp_tpu.parallel import make_mesh as j_make_mesh
from unimp_tpu.parallel.sharding import param_specs as j_param_specs
from unimp_tpu.tools import synth_data as j_synth
from unimp_tpu.train import optimizer as j_opt
from unimp_tpu.train.partition import backbone_trainable_mask as j_trainable_mask
from unimp_tpu.train.partition import merge_params, partition_params
from unimp_tpu.train.trainer import TrainState
from unimp_tpu.train.trainer import Trainer as JTrainer
from unimp_tpu.utils.quant import quantize_params_int8 as j_quantize_params_int8
from unimp_tpu_torch.data.dataset import TaskDataset
from unimp_tpu_torch.data.loader import DataLoader
from unimp_tpu_torch.data.masking import IGNORE, answer_span_labels
from unimp_tpu_torch.decode import GenerationConfig
from unimp_tpu_torch.evals import evaluators
from unimp_tpu_torch.models import UniMPModel, get_config
from unimp_tpu_torch.data.transforms import normalize_on_device
from unimp_tpu_torch.models.flamingo import compute_q_media
from unimp_tpu_torch.parallel.sharding import param_specs, tensor_tp_dim, tp_layout
from unimp_tpu_torch.tools import synth_data
from unimp_tpu_torch.tools.from_flax import build_model, flatten_tree, load_flax_params
from unimp_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(2)  # six test workers share the cores
WORKER = Path(__file__).with_name("torch_parallel_worker.py")
GROUP_TIMEOUT = 120  # seconds for one spawned group, start to end
PAD, MEDIA, ANSWER, EOC = 0, 7, 8, 9
VOCAB = 512  # debug
LR = 1e-3
LOSS_RTOL = 1e-5
REL = 5e-4
METRIC_TOL = 1e-12
N_ITEMS = 40
IDS = dict(media_id=MEDIA, answer_id=ANSWER, endofchunk_id=EOC, pad_id=PAD, gamma=2.0,
           use_reweight=True)


def _spawn(tmp_path, case, world, inputs):
    """Run ``case`` on ``world`` ranks; returns each rank's result. The
    group gets GROUP_TIMEOUT seconds, then every rank is killed."""
    d = tmp_path / f"{case}_{world}"
    d.mkdir(parents=True)
    torch.save(inputs, d / "inputs.pt")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    logs = [open(d / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), case, str(r), str(world),
                               str(d / "store"), str(d)], stdout=logs[r],
                              stderr=subprocess.STDOUT, env=env) for r in range(world)]
    deadline = time.monotonic() + GROUP_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{case} on {world} ranks did not finish in {GROUP_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (d / f"rank{r}.log").read_text()[-3000:]
    return [torch.load(d / f"{case}_rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    synth_data.generate(str(d), n_items=N_ITEMS, n_users=48, image_size=28, seed=0)
    return str(d)


def test_loader_rank_shards_match_jax(data):
    """Each of 3 ranks' shard of a shuffled epoch: the JAX loader's batches
    for that rank, and together every sample once."""
    jtok = j_synth.build_tokenizer(data, n_items=N_ITEMS, task="rec")
    tok = synth_data.build_tokenizer(data, n_items=N_ITEMS, task="rec")
    kw = dict(n_items=N_ITEMS, image_size=28, history_len=5, load_images=False,
              max_records=13)
    jds = JTaskDataset(data, "beauty", "rec", "train", jtok, **kw)
    ds = TaskDataset(data, "beauty", "rec", "train", tok, **kw)
    lkw = dict(shuffle=True, seed=3, drop_last=True, num_workers=0, pad_to_multiple=128)
    seen = []
    for rank in range(3):
        jl = JDataLoader(jds, 2, 0, process_index=rank, process_count=3, **lkw)
        tl = DataLoader(ds, 2, 0, process_index=rank, process_count=3, **lkw)
        jl.set_epoch(1)
        tl.set_epoch(1)
        assert len(tl) == len(jl) == 2  # 13 samples: 5, 4, 4 a rank
        for a, b in zip(jl, tl):
            for key in ("input_ids", "seq_len", "weights", "image_ids"):
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        seen += list(tl._indices())
    assert sorted(seen) == list(range(13))


def test_dist_gather_mean_barrier(tmp_path):
    """Lengths 2 and 3 gathered (the NaN padding dropped), means over
    ranks, a barrier."""
    out = _spawn(tmp_path, "dist", 2, {})
    for res in out:
        assert res["gathered"] == [0.0, 0.0, 1.0, 1.0, 1.0]
        assert res["mean"] == {"x": 0.5, "y": 1.0}


# ---------------------------------------------------------------- one Trainer step


@functools.lru_cache(maxsize=None)
def _jax_debug(gate=0.5, vocab=None):
    jcfg = j_get_config("debug", dtype="float32")
    if vocab:
        jcfg = jcfg.replace(lm=dataclasses.replace(jcfg.lm, vocab_size=vocab))
    jmodel = JModel(jcfg)
    ids = jnp.ones((1, 8), jnp.int32).at[0, 1].set(MEDIA)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), ids,
                                  vision_x=jnp.zeros((1, 1, 28, 28, 3), jnp.float32),
                                  q_media=j_compute_q_media(ids, MEDIA))["params"]
    params = jax.tree_util.tree_map(lambda x: x, params)
    for key in params:
        if key.startswith("xattn_"):
            params[key]["attn_gate"] = jnp.asarray(gate)
            params[key]["ff_gate"] = jnp.asarray(gate)
    return jmodel, params


def _batch(b=8, seed=5):
    """A rec-shaped debug batch whose even rows hold long answer spans and
    odd rows short ones: ranks of the data axis see unequal counts."""
    rng = np.random.default_rng(seed)
    t = 24
    ids = rng.integers(10, VOCAB, size=(b, t)).astype(np.int32)
    seq_len = rng.integers(21, t + 1, size=b).astype(np.int32)
    for r in range(b):
        ids[r, 2] = ids[r, 7] = MEDIA
        ids[r, 9] = ANSWER
        ids[r, 19 if r % 2 == 0 else 12] = EOC
        ids[r, seq_len[r]:] = PAD
    return {"input_ids": ids, "seq_len": seq_len,
            "weights": rng.uniform(0.5, 1.5, size=b).astype(np.float32),
            "images": rng.integers(0, 256, size=(b, 2, 28, 28, 3), dtype=np.uint8)}


def _jax_mesh_step(bf16):
    """The JAX Trainer's step (accum 2) on the global batch, sharded over
    make_mesh(dp=2, fsdp=2, tp=2): (metrics, new params, the reduced
    gradients, the |gradient| bound of their bfloat16 sum, flat init).
    ``bf16``: ``--bf16_opt_state`` (bfloat16 gradients and moments)."""
    jmodel, params = _jax_debug()
    flat = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
    mesh = j_make_mesh(dp=2, fsdp=2, tp=2)
    jt = JTrainer(jmodel, None, trainable_mask=j_trainable_mask, accum_steps=2, mesh=mesh,
                  grad_dtype="bfloat16" if bf16 else None, **IDS)
    trainable, _ = partition_params(params, j_trainable_mask(params))
    moments = "bfloat16" if bf16 else None
    jt.optimizer = j_opt.make_optimizer(trainable, learning_rate=LR, mu_dtype=moments,
                                        nu_dtype=moments)
    # the batch is sharded over (dp, fsdp) by the trainer; the step donates
    # its state, so it gets a copy of the cached tree
    state = TrainState(step=jnp.int32(0), params=jax.tree_util.tree_map(jnp.copy, params),
                       opt_state=jt.optimizer.init(trainable))
    batch = _batch()
    t_params, f_params = partition_params(params, jt.resolve_mask(params))
    grad_fn = jax.jit(jax.value_and_grad(
        lambda t, mb: jt._loss_fn(merge_params(t, f_params), mb), has_aux=True))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    g = [grad_fn(t_params, {k: v[m * 4:(m + 1) * 4] for k, v in jb.items()})[1]
         for m in range(2)]
    if bf16:  # each micro-batch's gradient rounded, then summed, as the step does
        g = [jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), x) for x in g]
    grads = {k: np.asarray(v.astype(jnp.float32)) for k, v in flatten_tree(
        jax.tree_util.tree_map(lambda a, b: ((a + b) * 0.5).astype(a.dtype), *g)).items()
        if v is not None}
    operands = {k: np.asarray(v) for k, v in flatten_tree(jax.tree_util.tree_map(
        lambda a, b: (jnp.abs(a.astype(jnp.float32)) + jnp.abs(b.astype(jnp.float32))) / 2,
        *g)).items() if v is not None}
    new_state, metrics = jt.train_step(state, batch)
    new = {k: np.asarray(v) for k, v in flatten_tree(new_state.params).items()}
    return {k: float(v) for k, v in metrics.items()}, new, grads, operands, flat


@pytest.fixture(scope="module")
def jax_step():
    return _jax_mesh_step(bf16=False)


@pytest.fixture(scope="module")
def jax_step_bf16():
    return _jax_mesh_step(bf16=True)


def test_tp_layout_follows_the_jax_rules():
    """Every tensor the port slices over tp is one whose JAX rule names tp,
    on the same dimension, and the port's spec table equals the JAX one
    (an int8 tree's payloads and scales included)."""
    _, params = _jax_debug()
    shapes = {k: np.shape(v) for k, v in flatten_tree(params).items()}
    leaves = jax.tree_util.tree_flatten_with_path(
        j_param_specs(params), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    jspecs = {"/".join(p.key for p in kp): tuple(spec) for kp, spec in leaves}
    specs = param_specs(shapes)
    assert {k: tuple(v) for k, v in specs.items()} == jspecs
    model = build_model(get_config("debug", dtype="float32"), device="cpu", train=True)
    layout = tp_layout(model, 2)

    def tp_dim(spec):
        return next((i for i, axis in enumerate(spec)
                     if axis == "tp" or (isinstance(axis, tuple) and "tp" in axis)), None)

    assert layout and all(tp_dim(specs[p]) == d for p, d in layout.items())
    q = {f"{p}/q": s for p, s in shapes.items() if p.endswith("kernel")}
    q.update({f"{p}/scale": s[1:] for p, s in shapes.items() if p.endswith("kernel")})
    assert all(param_specs(q)[p] == () for p in q if p.endswith("/scale"))


def _local_counts(batch, data_size):
    """Answer tokens of each data rank's rows, per micro-batch."""
    labels = answer_span_labels(torch.from_numpy(batch["input_ids"]), ANSWER, EOC, MEDIA,
                                PAD)[:, 1:] != IGNORE
    g = batch["input_ids"].shape[0] // 2
    return [[int(labels[m * g:(m + 1) * g][r::data_size].sum()) for m in range(2)]
            for r in range(data_size)]


TWO_RANK_MESHES = [(2, 1, 1), (1, 2, 1), (1, 1, 2)]
# under --bf16_opt_state: bfloat16 gradients (each micro-batch's float32
# gradient summed over the data axis, then rounded) and moments
BF16_MESHES = [(2, 1, 1, "bf16"), (1, 2, 1, "bf16")]
BF16_STEP = 2.0 ** -7  # one step of bfloat16's 8-bit significand, at most


@pytest.fixture(scope="module")
def two_rank_steps(jax_step, tmp_path_factory):
    """The step at each 2-rank mesh, one after the other in one group."""
    inputs = {"meshes": TWO_RANK_MESHES + BF16_MESHES, "weights": jax_step[-1],
              "batch": _batch(), "lr": LR, "ids": IDS}
    return _spawn(tmp_path_factory.mktemp("steps"), "step", 2, inputs)


@pytest.mark.parametrize("mesh", TWO_RANK_MESHES + [(2, 2, 2)] + BF16_MESHES,
                         ids=["dp2", "fsdp2", "tp2", "dp2_fsdp2_tp2", "dp2_bf16", "fsdp2_bf16"])
def test_trainer_step_matches_jax_mesh(request, tmp_path, two_rank_steps, mesh):
    """Under bf16 the gradients are held as ``tests/test_torch_train_flags.py``
    holds one process's: within one bfloat16 step of each rounded operand
    (the two micro-batches' |g|) and of the result, on top of the float32
    bar; the logged norm within one bfloat16 step. A wrong reduction (a
    mean for a sum, a second sum) is off by a factor of 2 there."""
    bf16 = len(mesh) > 3
    j_metrics, j_new, j_grads, j_abs, flat = request.getfixturevalue(
        "jax_step_bf16" if bf16 else "jax_step")
    batch = _batch()
    data_size = mesh[0] * mesh[1]
    if data_size > 1:
        counts = _local_counts(batch, data_size)
        assert all(len({c[m] for c in counts}) > 1 for m in range(2)), counts
    if mesh in TWO_RANK_MESHES + BF16_MESHES:
        out = [res[mesh] for res in two_rank_steps]
    else:
        inputs = {"meshes": [mesh], "weights": flat, "batch": batch, "lr": LR, "ids": IDS}
        out = [res[mesh] for res in _spawn(tmp_path, "step", 8, inputs)]
    for key in ("loss", "grad_norm", "ce", "n_answer_tokens", "accuracy"):
        rtol = BF16_STEP if bf16 and key == "grad_norm" else LOSS_RTOL
        for res in out:
            np.testing.assert_allclose(res["metrics"][key], j_metrics[key], rtol=rtol,
                                       err_msg=key)
    assert out[0]["metrics"]["skipped_nonfinite"] == 0
    params = out[0]["params"]
    for res in out[1:]:  # the replicas stay in step
        for path, t in res["params"].items():
            assert torch.equal(t, params[path]), path
    assert set(params) == set(j_grads)
    for path, t in out[0]["grads"].items():
        assert t.dtype == (torch.bfloat16 if bf16 else torch.float32), path
        want = j_grads[path]
        atol = REL * max(float(np.abs(want).max()), 1e-30)
        if bf16:
            atol = atol + BF16_STEP * (j_abs[path] + np.abs(want))
        err = np.abs(t.float().numpy().astype(np.float64) - want)
        assert np.all(err <= atol), (path, float(np.max(err - atol)))
    for path, t in params.items():
        want, got = j_new[path], t.numpy()
        sure = np.abs(j_grads[path]) > 1e-5
        np.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=1e-2 * LR,
                                   err_msg=path)
        np.testing.assert_allclose(got, want, rtol=0, atol=2.01 * LR, err_msg=path)


def test_weight_bridge_places_a_jax_tree_on_tp(tmp_path):
    """One seeded JAX init, int8-quantized by the JAX package (every
    kernel) and as floats, placed on 2 tp ranks: each rank holds its block
    of every tensor the layout shards (an int8 scale with its columns, a
    row-parallel kernel's scale whole), the rest whole; the gathered tree
    is the one-process model's; logits (float32) within 1e-5 of the
    one-process int8 model's and its 3-beam tokens equal."""
    _, params = _jax_debug()
    flat = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
    qparams = j_quantize_params_int8(params, min_size=1, dtype=jnp.float32)
    leaves = jax.tree_util.tree_flatten_with_path(qparams)[0]
    int8 = {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path):
            np.asarray(v) for path, v in leaves}
    cfg = get_config("debug", dtype="float32")
    one = UniMPModel(cfg).eval()
    load_flax_params(one, int8)
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(10, VOCAB, size=(2, 12)))
    ids[:, 1] = ids[:, 6] = MEDIA
    inputs = {"int8": int8, "float": flat, "ids": ids, "seq_len": torch.tensor([12, 9]),
              "pixels": torch.from_numpy(rng.integers(0, 256, size=(2, 2, 28, 28, 3),
                                                      dtype=np.uint8)), "media": MEDIA}
    inputs["ids"][1, 9:] = PAD
    with torch.no_grad():
        want_logits = one(ids, vision_x=normalize_on_device(inputs["pixels"]),
                          q_media=compute_q_media(ids, MEDIA), kv_len=inputs["seq_len"])[0]
        want_tokens = _port_generate(one, inputs)
    layout = tp_layout(UniMPModel(cfg), 2)
    out = _spawn(tmp_path, "bridge", 2, inputs)
    sliced_scales = 0
    for rank, res in enumerate(out):
        for tree, got in ((int8, res["int8"]), (flat, res["float"])):
            for name, t in got.items():
                path = name.replace(".", "/")
                want = torch.from_numpy(np.array(tree[path]))
                dim = tensor_tp_dim(layout, path)
                if dim is not None:
                    size = want.shape[dim] // 2
                    want = want.narrow(dim, rank * size, size)
                    sliced_scales += path.endswith("kernel/scale")
                assert torch.equal(t, want.to(t.dtype)), (rank, path)
        assert res["int8"]["block_0.attn.o_proj.kernel.scale"].shape == (128,)
        whole = ckpt.model_tree(one)
        assert set(res["whole"]) == set(whole)
        for path, t in whole.items():
            assert torch.equal(res["whole"][path], t.cpu()), path
        scale = float(want_logits.abs().max())
        np.testing.assert_allclose(res["logits"].numpy(), want_logits.numpy(), rtol=0,
                                   atol=1e-5 * scale)
        assert torch.equal(res["tokens"], want_tokens)
    assert sliced_scales > 0


def _port_generate(model, inputs):
    from unimp_tpu_torch.decode import Generator

    gen = Generator(model, GenerationConfig(max_new_tokens=8, eos_id=1, pad_id=1, num_beams=3,
                                            num_return_sequences=3), media_id=MEDIA)
    latents = model.encode_vision(normalize_on_device(inputs["pixels"]))
    return gen.generate(inputs["ids"], inputs["seq_len"], latents)[0]


# ---------------------------------------------------------------- ring attention


def test_ring_attention_matches_jax(tmp_path):
    """2 ranks, each holding 2 rows of whole sequences, against the JAX
    ring over 8 sequence blocks: causal, then with ``kv_len`` through the
    model's dispatch under a sequence-sharding context."""
    rng = np.random.default_rng(11)
    b, s, h, d = 4, 24, 2, 64
    q, k, v, do = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(4))
    kv_len = np.array([24, 17, 9, 1], np.int32)
    mesh = j_make_mesh(dp=1, fsdp=8, tp=1)

    @jax.jit
    def f(q_, k_, v_, kl):  # causal alone is kv_len = S: one compile for both
        out = j_ring(q_, k_, v_, mesh, causal=True, kv_len=kl)
        return jnp.sum(out * do), out

    want = {}
    for name, kl in (("causal", np.full(b, s, np.int32)), ("kv_len", kv_len)):
        (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kl))
        want[name] = {"out": np.asarray(out),
                      **{g: np.asarray(x) for g, x in zip(("dq", "dk", "dv"), grads)}}
    inputs = {x: torch.from_numpy(a) for x, a in zip(("q", "k", "v", "do"), (q, k, v, do))}
    inputs["kv_len"] = torch.from_numpy(kv_len)
    out = _spawn(tmp_path, "ring", 2, inputs)
    for name in want:
        for key, bar in (("out", 2e-5), ("dq", 3e-4), ("dk", 3e-4), ("dv", 3e-4)):
            got = torch.cat([res[name][key] for res in out]).numpy()
            np.testing.assert_allclose(got, want[name][key], atol=bar, rtol=bar,
                                       err_msg=f"{name} {key}")


# ---------------------------------------------------------------- evaluation


@pytest.fixture(scope="module")
def eval_setup(data, tmp_path_factory):
    """The JAX evaluator's metrics on 5 users whose targets the port's
    single-process answers hit at every rank, and the ranks' inputs."""
    jtok = j_synth.build_tokenizer(data, n_items=N_ITEMS, task="rec")
    tok = synth_data.build_tokenizer(data, n_items=N_ITEMS, task="rec")
    vocab = -(-len(tok) // 128) * 128
    jmodel, params = _jax_debug(gate=1.0, vocab=vocab)
    flat = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
    cfg = get_config("debug", dtype="float32")
    tmodel = UniMPModel(cfg.replace(lm=dataclasses.replace(cfg.lm, vocab_size=vocab)))
    load_flax_params(tmodel, flat)
    kw = dict(n_items=N_ITEMS, image_size=28, history_len=5, load_images=False, max_records=5)
    lkw = dict(shuffle=False, drop_last=False, num_workers=0, pad_to_multiple=128)
    loader = DataLoader(TaskDataset(data, "beauty", "rec", "test", tok, **kw), 2,
                        tok.pad_token_id, **lkw)
    gen_cfg = GenerationConfig(max_new_tokens=50, eos_id=tok.eos_token_id,
                               pad_id=tok.eos_token_id, num_beams=3, num_return_sequences=3)
    answers, targets = [], []
    for rows, batch, _ in evaluators._generate_batches(tmodel.eval(), loader, tok, gen_cfg):
        answers += rows
        targets += batch["targets"]
    assert len(answers) == 5
    new_targets = [row[u % 4] if u % 4 < 3 else t
                   for u, (row, t) in enumerate(zip(answers, targets))]
    jloader = JDataLoader(JTaskDataset(data, "beauty", "rec", "test", jtok, **kw), 2,
                          jtok.pad_token_id, **lkw)

    class Retarget:
        dataset = jloader.dataset

        def __iter__(self):
            it = iter(new_targets)
            for batch in jloader:
                yield dict(batch, targets=[next(it) for _ in batch["targets"]])

    want = j_evaluators.evaluate_rec(jmodel, params, Retarget(), jtok, num_beams=3)
    tok_path = tmp_path_factory.mktemp("tok") / "tok.json"
    tok.save(str(tok_path))
    inputs = {"weights": flat, "vocab": vocab, "tokenizer": str(tok_path), "data": data,
              "n_items": N_ITEMS, "targets": new_targets, "meshes": TWO_RANK_MESHES}
    # every mesh one after the other in one group
    out = _spawn(tmp_path_factory.mktemp("evals"), "eval", 2, inputs)
    return want, out


@pytest.mark.parametrize("mesh", TWO_RANK_MESHES, ids=["dp2", "fsdp2", "tp2"])
def test_evaluate_rec_two_ranks_matches_jax(eval_setup, mesh):
    want, out = eval_setup
    for res in out:
        got = res[mesh]["metrics"]
        assert sorted(got) == sorted(want)
        assert got["n_users"] == want["n_users"] == 5
        for key in want:
            if key not in ("items_per_sec", "n_users"):
                assert abs(got[key] - want[key]) <= METRIC_TOL, (key, got[key], want[key])
    assert want["hr@3"] > 0


# ---------------------------------------------------------------- checkpoints


def _argv(data, runs, run_name, *extra):
    return ["--mmrec_path", data, "--external_save_dir", runs, "--run_name", run_name,
            "--pretrained_model_name_or_path", "debug", "--subset", "beauty", "--task", "rec",
            "--single_task", "--n_items", str(N_ITEMS), "--history_len", "5",
            "--patch-image-size", "28", "--batch_size", "2", "--gradient_accumulation_steps",
            "2", "--fused_accumulation", "--num_epochs", "1", "--logging_steps", "1",
            "--warmup_steps", "0", "--workers", "0", "--max_records", "8",
            "--precision", "fp32", "--use_reweight", "--cache_vision_latents",
            "--device", "cpu", *extra]


def _assert_state_equal(got, want, what):
    assert set(got) == set(want), what
    for key, val in want.items():
        if isinstance(val, dict):
            _assert_state_equal(got[key], val, f"{what}/{key}")
        elif isinstance(val, torch.Tensor):
            assert torch.equal(got[key].cpu(), val.cpu()), f"{what}/{key}"
        else:
            assert got[key] == val, f"{what}/{key}"


@pytest.mark.parametrize("writer,reader,flags", [
    (("--mesh_tp", "2", "--do_test"), (), ("--frozen_int8", "--bf16_opt_state")),
    ((), ("--mesh_fsdp", "2"), ()),
    ((), ("--mesh_tp", "2"), ("--frozen_int8",)),
], ids=["tp2_to_1_int8_bf16", "1_to_fsdp2", "1_to_tp2_int8"])
def test_checkpoint_resumes_across_world_sizes(tmp_path, data, writer, reader, flags):
    """``mmrec.main`` writes ``checkpoint_0`` on one world size; a resume on
    the other reads weights and optimizer state bit for bit: its
    ``final_weights`` (written whole again, no step taken) equal the
    checkpoint's weights and its whole optimizer state the checkpoint's.
    Under ``--frozen_int8`` a checkpoint holds each frozen kernel
    dequantized and the resume quantizes it again: the int8 payloads equal
    the writer's (a tp rank's row block of a row-parallel kernel must take
    the whole kernel's scale for that), and the re-read kernels are those
    payloads times scales within an ulp of the writer's, so the weights
    are held bit for bit everywhere else. The tp 2 writer's test pass
    dumps its users once: the two ranks of a tp group read the same
    users, so the first writes them, named by its data-axis rank."""
    runs = str(tmp_path / "runs")
    world_w, world_r = (2 if writer else 1), (2 if reader else 1)
    wrote = _spawn(tmp_path / "w", "cli", world_w,
                   {"argv": _argv(data, runs, "run", *writer, *flags)})
    if "--do_test" in writer:
        results = os.path.join(runs, "run", "results")
        assert os.listdir(results) == ["run_rec_test_epoch_0_rank_0.json"]
        with open(os.path.join(results, "run_rec_test_epoch_0_rank_0.json")) as f:
            per_user = json.load(f)
        for res in wrote:
            (metrics,) = [e["rec"] for e in res["evals"]]
            assert len(per_user) == metrics["n_users"] > 0
            assert abs(np.mean([u["hr@3"] for u in per_user]) - metrics["hr@3"]) <= METRIC_TOL
    saved = ckpt.restore_params(os.path.join(runs, "run"), "checkpoint_0")
    state = ckpt.restore_train_state(os.path.join(runs, "run"), "checkpoint_0")
    assert state["opt_state"]["mu"] and state["step"] == 2  # 8 records, 4 a step
    out = _spawn(tmp_path / "r", "cli", world_r,
                 {"argv": _argv(data, runs, "run", "--resume_from_checkpoint", *reader, *flags)})
    for res in out:
        _assert_state_equal(res["opt_state"], state["opt_state"], "opt_state")
        _assert_state_equal(res["payloads"], wrote[0]["payloads"], "int8 payloads")
    assert bool(wrote[0]["payloads"]) == ("--frozen_int8" in flags)
    final = dict(ckpt.restore_params(os.path.join(runs, "run"), "final_weights"))
    int8 = {p[: -len("/q")] for p in wrote[0]["payloads"]}
    _assert_state_equal({p: t for p, t in final.items() if p not in int8},
                        {p: t for p, t in saved.items() if p not in int8}, "weights")
    assert set(final) == set(saved)
