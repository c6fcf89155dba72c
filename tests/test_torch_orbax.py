"""The port's reader of the JAX package's Orbax checkpoints, on the CPU.

``train/orbax.py`` reads what ``unimp_tpu/train/checkpoint.py`` writes
(``ocp.StandardCheckpointer``: OCDBT + zarr v2, Zstandard chunks) with no
JAX, Orbax or tensorstore. Against the JAX package's own
``restore_params``, bit for bit: trees of bfloat16, float32, int and
scalar leaves sharded over the 8 host devices, B-trees forced to interior
nodes, chunks left out (``store_array_data_equal_to_fill_value`` off, as
older writes did), a checkpoint written by two ``jax.distributed``
processes, and the committed JAX-written checkpoint
(``tests/data/orbax``). Then the entry points on it: the resume of a JAX
``checkpoint_{e}`` (the optax state mapped onto the port's optimizer) takes
the JAX CLI's next update, and the serving worker gives the JAX worker's
tokens. ``chip_smoke.py``'s Orbax writer is restored by the JAX package
bit for bit. The other entry points are held in their own files
(``test_torch_train_cli.py``, ``test_torch_transfer.py``,
``test_torch_harness.py``).

The committed checkpoint is the JAX CLI's one-epoch ``debug`` run (micro-
batch 2, ``MultiSteps`` over 2) at the widths of
``tests/data/orbax/config.json`` (debug cut to one layer, head dim 64 so
that the card's kernels take it): ``final_weights`` and ``checkpoint_0``,
about 2.3 MB. ``PYTHONPATH=. python tests/test_torch_orbax.py`` writes it
again.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from unimp_tpu.cli import common as j_common
from unimp_tpu.cli import mmrec as j_mmrec
from unimp_tpu.serve import worker as j_worker
from unimp_tpu.tools import synth_data as j_synth
from unimp_tpu.train import checkpoint as j_ckpt
from unimp_tpu.train.trainer import Trainer as JTrainer
from unimp_tpu_torch.cli import common, mmrec
from unimp_tpu_torch.data import zstd
from unimp_tpu_torch.serve import worker
from unimp_tpu_torch.tools.from_flax import flatten_tree
from unimp_tpu_torch.train import checkpoint as ckpt
from unimp_tpu_torch.train import orbax
from unimp_tpu_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "data" / "orbax"
SPEC = json.loads((FIXTURE / "config.json").read_text())
N_ITEMS = 40
LR = 1e-4
B1 = 0.9  # AdamW's first-moment decay (the CLIs' default)
torch.set_num_threads(2)  # six test workers share the cores


def fixture_config(get_config):
    """``get_config`` with the fixture's variant at the widths of
    ``config.json`` (either package's)."""
    def get(name, **kw):
        cfg = get_config(name, **kw)
        if name == SPEC["base"]:
            cfg = cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **SPEC[k])
                                 for k in ("vision", "resampler", "lm")},
                              cross_attn_every_n=SPEC["cross_attn_every_n"])
        return cfg
    return get


def fixture_argv(data, runs, run_name, *extra):
    """The JAX CLI's command line that wrote the fixture."""
    return ["--mmrec_path", str(data), "--external_save_dir", str(runs), "--run_name", run_name,
            "--pretrained_model_name_or_path", SPEC["base"], "--subset", "beauty", "--task",
            "rec", "--single_task", "--n_items", str(N_ITEMS), "--history_len", "5",
            "--patch-image-size", "28", "--batch_size", "2", "--gradient_accumulation_steps",
            "2", "--eval_batch_size", "4", "--num_epochs", "1", "--logging_steps", "1",
            "--warmup_steps", "0", "--workers", "0", "--num_beams", "3", "--max_records", "8",
            "--precision", "fp32", "--use_reweight", *extra]


def write_fixture(out: Path = FIXTURE) -> None:
    """Train one epoch with the JAX CLI and keep its ``final_weights`` and
    ``checkpoint_0`` under ``out``."""
    with tempfile.TemporaryDirectory() as d:
        j_synth.generate(os.path.join(d, "data"), n_items=N_ITEMS, n_users=48, image_size=28,
                         seed=0)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(j_common, "get_config", fixture_config(j_common.get_config))
            mp.setattr(j_common, "build_mesh", lambda args: None)
            j_mmrec.main(fixture_argv(os.path.join(d, "data"), os.path.join(d, "runs"),
                                      "fixture"))
        for name in ("final_weights", "checkpoint_0"):
            shutil.rmtree(out / name, ignore_errors=True)
            shutil.copytree(os.path.join(d, "runs", "fixture", name), out / name)


def _jax_flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): v
            for path, v in leaves}


def _assert_equal_trees(got: dict, want: dict) -> None:
    """Bit for bit: bfloat16 by its bits, the rest by value and dtype."""
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        if not isinstance(g, torch.Tensor):  # a scalar leaf
            assert isinstance(g, (int, float)) and g == w, path
            assert isinstance(g, int) == np.issubdtype(type(w), np.integer), path
            continue
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, path
        if g.dtype == torch.bfloat16:
            assert w.dtype == jnp.bfloat16, path
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16),
                                          err_msg=path)
        else:
            assert g.numpy().dtype == w.dtype, path
            np.testing.assert_array_equal(g.numpy(), w, err_msg=path)


def _tree() -> dict:
    """bf16, float32 and int32 leaves (sharded over the 8 host
    devices in one and two dimensions, replicated, single-device), a 0-d
    array and Python scalars."""
    rng = np.random.default_rng(0)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("a", "b"))
    sharded = rng.standard_normal((64, 48)).astype(np.float32)
    return {
        "params": {
            "lm": {"w": jax.device_put(jnp.asarray(rng.standard_normal((40, 24)), jnp.bfloat16),
                                       NamedSharding(mesh, P("a", "b"))),
                   "s": jax.device_put(jnp.asarray(sharded), NamedSharding(mesh, P("a", "b"))),
                   "b": jnp.zeros((7,), jnp.float32),
                   "gate": jnp.zeros((), jnp.float32)},
            "rows": jax.device_put(jnp.arange(96, dtype=jnp.int32).reshape(32, 3),
                                   NamedSharding(mesh, P("a"))),
            "big": jnp.asarray(rng.standard_normal((300, 70)), jnp.float32),
            "rep": jax.device_put(jnp.asarray(rng.integers(0, 9, (5, 6)), jnp.int32),
                                  NamedSharding(mesh, P())),
        },
        "step": jnp.int32(11),
        "epoch": 3,
        "lr": 0.5,
    }


@pytest.mark.parametrize("case", ["sharded", "interior_nodes", "absent_chunks"])
def test_reader_equals_jax_restore(tmp_path, monkeypatch, case):
    """The reader gives what the JAX package's ``restore_params`` gives,
    bit for bit. ``interior_nodes`` caps tensorstore's node and inline
    value sizes so the B-tree is three levels deep and every value over 16
    bytes is a reference into ``ocdbt.process_0/d/``. ``absent_chunks``
    writes with ``store_array_data_equal_to_fill_value`` off (as older
    Orbax did) and deletes chunks through tensorstore afterwards (a second
    version of the database), as such a write leaves the chunks equal to
    the fill value, one array with a fill value of 0.5 in its
    ``.zarray``; with the flag on, a missing chunk raises on both sides."""
    from orbax.checkpoint._src.serialization import tensorstore_utils as tsu

    if case == "interior_nodes":
        orig = tsu.add_ocdbt_write_options

        def small(spec, target_data_file_size=None):
            orig(spec, target_data_file_size)
            spec["config"].update(max_decoded_node_bytes=400, max_inline_value_bytes=16)

        monkeypatch.setattr(tsu, "add_ocdbt_write_options", small)
    if case == "absent_chunks":
        j_ckpt.save_params(str(tmp_path), _tree(), name="strict")
        monkeypatch.setattr(tsu, "STORE_ARRAY_DATA_EQUAL_TO_FILL_VALUE", False)
    j_ckpt.save_params(str(tmp_path), _tree(), name="ck")
    path = tmp_path / "ck"
    if case == "absent_chunks":
        import tensorstore as ts

        for name in ("ck", "strict"):
            store = ts.KvStore.open({"driver": "ocdbt",
                                     "base": f"file://{tmp_path / name}/"}).result()
            meta = json.loads(store.read(b"params.lm.b/.zarray").result().value)
            store.write(b"params.lm.b/.zarray", json.dumps({**meta, "fill_value": 0.5})).result()
            for key in (b"params.lm.s/1.0", b"params.lm.s/1.1", b"params.lm.b/0"):
                store.delete_range(ts.KvStore.KeyRange(key, key + b"\0")).result()
        with pytest.raises(Exception, match="missing"):
            j_ckpt.restore_params(str(tmp_path), "strict")
        with pytest.raises(orbax.OrbaxError, match="missing"):
            orbax.read_tree(str(tmp_path / "strict"))
    want = _jax_flat(j_ckpt.restore_params(str(tmp_path), "ck"))
    got = orbax.read_tree(str(path))
    _assert_equal_trees(got, want)
    assert got["params/lm/w"].dtype == torch.bfloat16 and got["epoch"] == 3
    kv = orbax.read_kv(str(path))
    meta = kv[b"params.lm.s/.zarray"]
    if isinstance(meta, tuple):  # a reference (file, offset, length)
        meta = (path / meta[0]).read_bytes()[meta[1]:meta[1] + meta[2]]
    meta = json.loads(meta)
    assert meta["chunks"] == [16, 24] and meta["shape"] == [64, 48]
    if case == "interior_nodes":
        refs = [v for v in kv.values() if isinstance(v, tuple)]
        assert len(refs) > 20 and all(v[0].startswith("ocdbt.process_0/") for v in refs)
        assert all(len(v) <= 16 for v in kv.values() if not isinstance(v, tuple))
        root = (path / "manifest.ocdbt").read_bytes()
        assert orbax._manifest_root(root, "manifest")[1] >= 2  # the root's height
    if case == "absent_chunks":
        assert b"params.lm.s/1.0" not in kv and b"params.lm.s/0.0" in kv
        assert not got["params/lm/s"][16:32].any() and got["params/lm/s"][:16].all()
        assert (got["params/lm/b"] == 0.5).all()


_TWO_PROCESS_WRITER = r"""
import os, sys
pid, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.distributed.initialize(coordinator_address=f"localhost:{port}", num_processes=2,
                           process_id=pid)
import numpy as np, jax.numpy as jnp, orbax.checkpoint as ocp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()).reshape(4), ("x",))
rng = np.random.default_rng(5)
w = rng.standard_normal((64, 40)).astype(np.float32)
e = rng.standard_normal((32, 16)).astype(np.float32)
tree = {"params": {
    "w": jax.make_array_from_callback(w.shape, NamedSharding(mesh, P("x")), lambda i: w[i]),
    "e": jax.make_array_from_callback(e.shape, NamedSharding(mesh, P("x")),
                                      lambda i: e[i].astype(jnp.bfloat16)),
    "r": jax.make_array_from_callback((3, 5), NamedSharding(mesh, P()),
                                      lambda i: np.full((3, 5), 2.5, np.float32)[i])},
    "step": 7}
ckptr = ocp.StandardCheckpointer()
ckptr.save(out, tree, force=True)
ckptr.wait_until_finished()
"""


def test_reader_reads_a_checkpoint_of_two_processes(tmp_path):
    """Two ``jax.distributed`` CPU processes (two devices each) write one
    checkpoint: each process' shards go to its ``ocdbt.process_{i}/``, and
    the root manifest merges them with references into both. The reader
    equals the JAX package's restore of it in this process."""
    script = tmp_path / "writer.py"
    script.write_text(_TWO_PROCESS_WRITER)
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen([sys.executable, str(script), str(i), port, str(tmp_path / "ck")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for i in range(2)]
    logs = [p.communicate(timeout=240)[0].decode(errors="replace") for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    path = tmp_path / "ck"
    assert (path / "ocdbt.process_0").is_dir() and (path / "ocdbt.process_1").is_dir()
    kv = orbax.read_kv(str(path))
    procs_seen = {v[0].split("/")[0] for v in kv.values() if isinstance(v, tuple)}
    assert procs_seen == {"ocdbt.process_0", "ocdbt.process_1"}
    like = {"params": {"w": jnp.zeros((64, 40), jnp.float32), "e": jnp.zeros((32, 16),
                                                                              jnp.bfloat16),
                       "r": jnp.zeros((3, 5), jnp.float32)}, "step": 0}
    want = _jax_flat(j_ckpt.restore_params(str(tmp_path), "ck", like=like))
    _assert_equal_trees(orbax.read_tree(str(path)), want)


def test_reader_raises_on_damaged_directories(tmp_path):
    """A chunk whose frame lost its magic number, a B-tree node with a
    flipped byte (its CRC-32C), a lost data file, a manifest cut short and
    a missing ``_METADATA`` raise; nothing falls back to another
    decoder."""
    for name in ("chunk", "node", "lost", "cut", "bare"):
        shutil.copytree(FIXTURE / "final_weights", tmp_path / name)
    kv = orbax.read_kv(str(tmp_path / "chunk"))
    rel, offset, length = next(v for v in kv.values() if isinstance(v, tuple))
    blob = bytearray((tmp_path / "chunk" / rel).read_bytes())
    blob[offset] ^= 0x40
    (tmp_path / "chunk" / rel).write_bytes(bytes(blob))
    with pytest.raises(zstd.ZstdError, match="magic"):
        orbax.read_tree(str(tmp_path / "chunk"))
    (node,) = (tmp_path / "node" / "d").iterdir()  # the root's B-tree leaf
    blob = bytearray(node.read_bytes())
    blob[len(blob) // 2] ^= 1
    node.write_bytes(bytes(blob))
    with pytest.raises(orbax.OrbaxError, match="CRC-32C"):
        orbax.read_tree(str(tmp_path / "node"))
    (tmp_path / "lost" / rel).unlink()
    with pytest.raises(orbax.OrbaxError, match="missing OCDBT data file"):
        orbax.read_tree(str(tmp_path / "lost"))
    manifest = tmp_path / "cut" / "manifest.ocdbt"
    manifest.write_bytes(manifest.read_bytes()[:-9])
    with pytest.raises(orbax.OrbaxError, match="length"):
        orbax.read_tree(str(tmp_path / "cut"))
    (tmp_path / "bare" / "_METADATA").unlink()
    assert ckpt.is_orbax(str(tmp_path / "bare"))  # the manifest marks it
    with pytest.raises(orbax.OrbaxError, match="_METADATA"):
        ckpt.restore_params(str(tmp_path), "bare")


def test_committed_checkpoint_reads_as_jax_restores_it():
    """The committed JAX-written checkpoint: the reader equals the JAX
    package's restore of each directory; ``restore_params`` takes a
    ``checkpoint_{e}``'s params and ``restore_train_state`` its optax state
    (``MultiSteps`` over the masked AdamW chain), step and epoch."""
    size = sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file())
    assert size < 2_600_000
    for name in ("final_weights", "checkpoint_0"):
        want = _jax_flat(j_ckpt.restore_params(str(FIXTURE), name))
        _assert_equal_trees(orbax.read_tree(str(FIXTURE / name)), want)
    params = ckpt.restore_params(str(FIXTURE), "checkpoint_0")
    final = ckpt.restore_params(str(FIXTURE), "final_weights")
    assert sorted(params) == sorted(final)
    for path, t in final.items():
        assert torch.equal(params[path], t), path  # one epoch: the last update is both
    state = ckpt.restore_train_state(str(FIXTURE), "checkpoint_0")
    opt = state["opt_state"]
    assert (state["step"], state["epoch"]) == (4, 0)
    assert (opt["count"], opt["schedule_count"], opt["mini_step"], opt["gradient_step"]) == \
        (2, 2, 0, 2)
    trainable = {p for p in final if p.split("/")[0] in ("resampler", "embed")
                 or p.startswith("xattn_")}
    for key in ("mu", "nu", "acc"):
        assert {n.replace(".", "/") for n in opt[key]} == trainable, key
    assert all(not t.any() for t in opt["acc"].values())  # reset after each update
    assert ckpt.latest_checkpoint(str(FIXTURE)) == "checkpoint_0"


def _resume_both(tmp_path, checkpoint: Path, extra, updates: int):
    """Both packages resume ``checkpoint`` (``--resume_from_checkpoint``,
    epoch 1 of 2) and stop after ``updates`` optimizer updates; returns
    each side's losses, parameters, moments, step and epoch."""
    data = tmp_path / "data"
    j_synth.generate(str(data), n_items=N_ITEMS, n_users=48, image_size=28, seed=0)
    out = {}

    class Stop(Exception):
        pass

    accum = 1 if "--fused_accumulation" in extra else 2
    for side in ("jax", "port"):
        run = tmp_path / side / "resume"
        run.mkdir(parents=True)
        shutil.copytree(checkpoint, run / "checkpoint_0")
        argv = fixture_argv(data, tmp_path / side, "resume", "--num_epochs", "2",
                            "--resume_from_checkpoint", *extra)
        seen = {"losses": []}
        with pytest.MonkeyPatch.context() as mp:
            if side == "jax":
                orig = JTrainer.train_step

                def step(self, state, batch):
                    state, metrics = orig(self, state, batch)
                    seen["losses"].append(float(metrics["loss"]))
                    if len(seen["losses"]) == updates * accum:
                        seen["state"] = jax.tree_util.tree_map(np.array, state)
                        raise Stop
                    return state, metrics

                mp.setattr(JTrainer, "train_step", step)
                mp.setattr(j_common, "get_config", fixture_config(j_common.get_config))
                mp.setattr(j_common, "build_mesh", lambda args: None)
                with pytest.raises(Stop):
                    j_mmrec.main(argv)
                st = seen["state"]
                flat = {k: np.asarray(v) for k, v in flatten_tree(st.params).items()}
                inner = st.opt_state.inner_opt_state if accum > 1 else st.opt_state
                moments = {f"{m}/{k}": np.asarray(v)
                           for m in ("mu", "nu")
                           for k, v in flatten_tree(getattr(inner[1], m)).items()
                           if v is not None}
                out[side] = dict(losses=seen["losses"], params=flat, moments=moments,
                                 step=int(st.step))
            else:
                orig = Trainer.train_step

                def step(self, batch):
                    metrics = orig(self, batch)
                    seen["losses"].append(float(metrics["loss"]))
                    if len(seen["losses"]) == updates * accum:
                        seen["trainer"] = self
                        raise Stop
                    return metrics

                mp.setattr(Trainer, "train_step", step)
                mp.setattr(common, "get_config", fixture_config(common.get_config))
                with pytest.raises(Stop):
                    mmrec.main(argv + ["--device", "cpu"])
                tr = seen["trainer"]
                opt = tr.optimizer.state_dict()
                flat = {k: t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
                        for k, t in ckpt.model_tree(tr.model).items()}
                moments = {f"{m}/{n.replace('.', '/')}": t.detach().float().numpy()
                           for m in ("mu", "nu") for n, t in opt[m].items()}
                out[side] = dict(losses=seen["losses"], params=flat, moments=moments,
                                 step=tr.step)
    return out["jax"], out["port"]


@pytest.mark.parametrize("flags", [[], ["--frozen_int8", "--bf16_opt_state",
                                        "--fused_accumulation"]])
def test_resume_of_a_jax_checkpoint_matches_jax(tmp_path, flags):
    """The JAX CLI's one-epoch ``checkpoint_0`` (the committed one:
    ``MultiSteps`` over 2; or, with int8 frozen weights, bfloat16 moments
    and fused accumulation, one written here), resumed by both packages for
    one update: the losses within 1e-5 relative, the moments within 1e-4
    of their largest entry, the parameters as ``test_trainer_step_matches_jax``
    holds them (within 1e-2 LR where JAX's averaged gradient, from its new
    ``mu`` and the checkpoint's, exceeds 1e-5; within 2.01 LR elsewhere),
    frozen tensors equal, and the same step. A skipped or reversed update,
    or one with the restored counts reset, moves the first set by about LR."""
    if flags:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(j_common, "get_config", fixture_config(j_common.get_config))
            mp.setattr(j_common, "build_mesh", lambda args: None)
            j_synth.generate(str(tmp_path / "src_data"), n_items=N_ITEMS, n_users=48,
                             image_size=28, seed=0)
            j_mmrec.main(fixture_argv(tmp_path / "src_data", tmp_path / "src", "src", *flags))
        checkpoint = tmp_path / "src" / "src" / "checkpoint_0"
    else:
        checkpoint = FIXTURE / "checkpoint_0"
    want, got = _resume_both(tmp_path, checkpoint, flags, updates=1)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    state0 = ckpt.restore_train_state(str(checkpoint.parent), checkpoint.name)
    assert got["step"] == want["step"] == state0["step"] + (1 if flags else 2)
    assert sorted(got["moments"]) == sorted(want["moments"]) and got["moments"]
    for name, w in want["moments"].items():
        w = np.asarray(w, np.float32)
        tol = 1e-4 * max(float(np.abs(w).max()), 1e-30)
        if flags:  # bfloat16 storage: one rounding step of the stored value
            tol = max(tol, float(np.abs(w).max()) * 2 ** -7)
        np.testing.assert_allclose(got["moments"][name], w, rtol=0, atol=tol, err_msg=name)
    start = ckpt.restore_params(str(checkpoint.parent), checkpoint.name)
    mu0 = state0["opt_state"]["mu"]
    n_sure = 0
    for path, w in want["params"].items():
        g = got["params"][path]
        if np.asarray(w).dtype == np.int8 or path not in start:
            continue  # int8 payloads: held through their float checkpoint below
        w = np.asarray(w, np.float32)
        name = path.replace("/", ".")
        if name in mu0:
            grad = (want["moments"][f"mu/{path}"].astype(np.float32)
                    - B1 * mu0[name].float().numpy()) / (1 - B1)
            sure = np.abs(grad) > 1e-5
            n_sure += int(sure.sum())
            np.testing.assert_allclose(g[sure], w[sure], rtol=0, atol=1e-2 * LR, err_msg=path)
        np.testing.assert_allclose(g, w, rtol=0, atol=2.01 * LR, err_msg=path)
        if not any(path.startswith(t) for t in ("resampler", "embed", "xattn_")):
            np.testing.assert_array_equal(g, start[path].float().numpy(), err_msg=path)
    assert n_sure > 1000


def test_served_tokens_from_a_jax_checkpoint_match_jax(tmp_path, monkeypatch):
    """The serving worker's ``--load_weights_name`` on the committed
    ``final_weights``, float32, greedy: the port's worker streams the JAX
    worker's text for each prompt."""
    data = tmp_path / "data"
    j_synth.generate(str(data), n_items=N_ITEMS, n_users=8, image_size=28, seed=0)
    argv = ["--mmrec_path", str(data), "--pretrained_model_name_or_path", SPEC["base"],
            "--subset", "beauty", "--task", "rec", "--n_items", str(N_ITEMS),
            "--patch-image-size", "28", "--precision", "fp32", "--eval_param_dtype", "fp32",
            "--load_dir", str(FIXTURE), "--load_weights_name", "final_weights",
            "--no-batched-streaming"]
    built = {}
    monkeypatch.setattr(j_worker, "serve", lambda w, host, port: built.setdefault("jax", w))
    monkeypatch.setattr(j_common, "get_config", fixture_config(j_common.get_config))
    monkeypatch.setattr(common, "get_config", fixture_config(common.get_config))
    j_worker.main(argv)
    port_worker = worker.build_worker(worker.build_parser().parse_args(argv + ["--device",
                                                                                "cpu"]))
    texts = {"jax": [], "port": []}
    for prompt in ("hello world", "what item next", "rate this cream"):
        req = {"prompt": prompt, "max_new_tokens": 8, "temperature": 0.0}
        for side, w in (("jax", built["jax"]), ("port", port_worker)):
            chunks = list(w.generate_stream(dict(req)))
            assert chunks[-1]["error_code"] == 0
            texts[side].append(chunks[-1]["text"])
    assert texts["port"] == texts["jax"]
    assert any(texts["port"])


class _FakeWandb:
    """A ``wandb`` module that records each call with its arguments."""

    def __init__(self, root: Path):
        self.calls, self.root = [], root

    def init(self, **kw):
        self.calls.append(("init", kw))

    def log(self, metrics, step=None):
        self.calls.append(("log", {k: float(v) for k, v in metrics.items()}, step))

    def Artifact(self, name, type):
        calls, root = self.calls, self.root
        calls.append(("Artifact", name, type))

        class Art:
            def add_dir(self, path):
                calls.append(("add_dir", os.path.relpath(path, root)))

            def add_file(self, path):
                calls.append(("add_file", os.path.relpath(path, root)))

        art = Art()
        art.name = name
        return art

    def log_artifact(self, art):
        self.calls.append(("log_artifact", art.name))


def test_wandb_calls_match_jax(tmp_path, monkeypatch):
    """``mmrec.main --report_to_wandb --save_checkpoints_to_wandb`` with a
    fake ``wandb`` module: both packages (from the same initial weights)
    call ``wandb.init`` with the same project, entity, name and
    configuration keys, log the same metrics at the same steps (losses
    within 1e-5 relative), and upload ``final_weights`` as the same
    artifact."""
    import types

    data = tmp_path / "data"
    j_synth.generate(str(data), n_items=N_ITEMS, n_users=48, image_size=28, seed=0)
    wandbs, seen = {}, {}
    orig_init, orig_build = JTrainer.init_state, common.build_model

    def init_state(self, *args, **kw):
        state = orig_init(self, *args, **kw)
        seen["init"] = {k: np.asarray(v) for k, v in flatten_tree(state.params).items()
                        if v is not None}
        return state

    def build(args, tokenizer, **kw):
        return orig_build(args, tokenizer, **{**kw, "weights": seen["init"]})

    monkeypatch.setattr(JTrainer, "init_state", init_state)
    monkeypatch.setattr(common, "build_model", build)
    monkeypatch.setattr(j_common, "get_config", fixture_config(j_common.get_config))
    monkeypatch.setattr(common, "get_config", fixture_config(common.get_config))
    monkeypatch.setattr(j_common, "build_mesh", lambda args: None)
    flags = ("--report_to_wandb", "--save_checkpoints_to_wandb", "--wandb_project", "proj",
             "--wandb_entity", "team")
    for side, main in (("jax", j_mmrec.main), ("port", mmrec.main)):
        fake = wandbs[side] = _FakeWandb(tmp_path / side)
        module = types.ModuleType("wandb")
        for name in ("init", "log", "Artifact", "log_artifact"):
            setattr(module, name, getattr(fake, name))
        monkeypatch.setitem(sys.modules, "wandb", module)
        main(fixture_argv(data, tmp_path / side, "run", *flags)
             + (["--device", "cpu"] if side == "port" else []))
    jc, pc = wandbs["jax"].calls, wandbs["port"].calls
    assert [c[0] for c in pc] == [c[0] for c in jc]
    (_, j_init), (_, p_init) = jc[0], pc[0]
    assert {k: v for k, v in p_init.items() if k != "config"} == \
        {k: v for k, v in j_init.items() if k != "config"} == \
        {"project": "proj", "entity": "team", "name": "run"}
    assert set(p_init["config"]) - {"device"} == set(j_init["config"])
    logs = [(c, d) for c, d in zip(pc, jc) if c[0] == "log"]
    assert len(logs) >= 4
    for (_, got, step), (_, want, j_step) in logs:
        assert step == j_step and sorted(got) == sorted(want)
        if "loss_multi_instruct" in want:
            np.testing.assert_allclose(got["loss_multi_instruct"],
                                       want["loss_multi_instruct"], rtol=1e-5)
    assert pc[-3:] == jc[-3:] == [("Artifact", "run_final_weights", "checkpoint"),
                                   ("add_dir", os.path.join("run", "final_weights")),
                                   ("log_artifact", "run_final_weights")]


def test_chip_smoke_writer_is_restored_by_jax(tmp_path):
    """``chip_smoke.py``'s ``write_orbax_checkpoint`` (raw-block Zstandard
    frames, an OCDBT manifest and one leaf node, zarr v2): the JAX
    package's ``restore_params`` gives back the tree bit for bit (bf16,
    float32, int32, a 0-d array and a Python scalar), and so does the
    reader; chunks past one frame's block limit span several blocks."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    rng = np.random.default_rng(2)
    tree = {"vision/w": torch.from_numpy(rng.standard_normal((70, 3000)).astype(np.float32)),
            "lm/e": torch.from_numpy(rng.standard_normal((33, 17)).astype(np.float32))
            .to(torch.bfloat16),
            "lm/i": torch.arange(12, dtype=torch.int32).reshape(3, 4),
            "lm/gate": torch.tensor(0.25), "step": torch.tensor(9, dtype=torch.int32)}
    nested = {}
    for path, t in tree.items():
        node = nested
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = t
    chip_smoke.write_orbax_checkpoint(tree, tmp_path / "ck", scalars={"epoch": 4})
    want = _jax_flat(j_ckpt.restore_params(str(tmp_path), "ck"))
    got = orbax.read_tree(str(tmp_path / "ck"))
    _assert_equal_trees(got, want)
    assert want["epoch"] == 4
    for path, t in tree.items():
        w = np.asarray(want[path])
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), w.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), w)
    assert flatten_tree(nested).keys() == tree.keys()


if __name__ == "__main__":
    write_fixture()
