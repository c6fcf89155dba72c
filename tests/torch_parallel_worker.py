"""One rank of a ``tests/test_torch_parallel.py`` process group.

    python tests/torch_parallel_worker.py CASE RANK WORLD STORE DIR

Joins a gloo group over the ``FileStore`` at STORE (no TCP port), runs
CASE with the port alone (no JAX; on the CPU, or on one shared card for
``tests/test_torch_kernels.py``'s card tests) and writes what it found to
``DIR/CASE_rank{RANK}.pt``; inputs come from ``DIR/inputs.pt``.
"""

import os
import sys
import warnings

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
warnings.filterwarnings("ignore", category=FutureWarning)  # torch 2.13 renames collectives

from unimp_tpu_torch.parallel.mesh import make_mesh, set_mesh  # noqa: E402


def case_dist(inputs, rank):
    from unimp_tpu_torch.evals.dist import barrier, gather_metric_lists, mean_over_hosts

    set_mesh(make_mesh(device="cpu"))
    out = {"gathered": sorted(gather_metric_lists([float(rank)] * (2 + rank)).tolist()),
           "mean": mean_over_hosts({"x": float(rank), "y": 2.0 * rank})}
    barrier()
    return out


def _debug_model(inputs, mesh, train=True, flags=()):
    """The debug model on ``mesh``; ``flags`` "int8" (``--frozen_int8``,
    from the JAX-quantized tree ``inputs["weights_int8"]``) and "remat"
    (``--remat --remat_policy dots``)."""
    from unimp_tpu_torch.models import get_config
    from unimp_tpu_torch.tools.from_flax import build_model

    cfg = get_config(inputs.get("variant", "debug"), dtype="float32")
    if "vocab" in inputs:
        import dataclasses

        cfg = cfg.replace(lm=dataclasses.replace(cfg.lm, vocab_size=inputs["vocab"]))
    if "remat" in flags:
        cfg = cfg.replace(remat=True, remat_policy="dots")
    int8 = "int8" in flags
    return build_model(cfg, device=inputs.get("device", "cpu"), train=train,
                       weights=inputs["weights_int8" if int8 else "weights"],
                       frozen_dtype="int8" if int8 else None, mesh=mesh)


def case_step(inputs, rank):
    """{mesh: one Trainer step's results} for each of ``inputs["meshes"]``,
    one after the other in this group."""
    return {mesh: _step(inputs, mesh) for mesh in inputs["meshes"]}


def _step(inputs, mesh_dims):
    """One Trainer step on this rank's rows of the global batch (accum 2:
    micro-batch m of every rank together is the global micro-batch m);
    ``mesh_dims`` (dp, fsdp, tp, flags...) with the flags "bf16"
    (``--bf16_opt_state``), "int8" and "remat" (``_debug_model``). Under
    fsdp it also reports the ZeRO-3 gathers' high-water mark over the
    gradient computation and each unit's gathered bytes."""
    from unimp_tpu_torch.parallel.sharding import gather_tp, whole_like
    from unimp_tpu_torch.train import checkpoint as ckpt
    from unimp_tpu_torch.train.optimizer import decay_mask, make_optimizer
    from unimp_tpu_torch.train.partition import trainable_params
    from unimp_tpu_torch.train.trainer import Trainer

    dp, fsdp, tp = mesh_dims[:3]
    bf16 = torch.bfloat16 if "bf16" in mesh_dims[3:] else None  # --bf16_opt_state
    device = inputs.get("device", "cpu")
    mesh = make_mesh(dp, fsdp, tp, device=device)
    set_mesh(mesh)
    model = _debug_model(inputs, mesh, flags=mesh_dims[3:])
    trainable = trainable_params(model)
    zero = model.zero
    opt = make_optimizer(trainable, learning_rate=inputs["lr"], moment_dtype=bf16,
                         decay=decay_mask(whole_like(model, trainable)))
    trainer = Trainer(model, opt, device=device, accum_steps=2, mesh=mesh, grad_dtype=bf16,
                      **inputs["ids"])
    batch, accum, p = inputs["batch"], 2, mesh.data_size
    g = batch["input_ids"].shape[0] // accum
    rows = np.concatenate([np.arange(m * g, (m + 1) * g)[mesh.data_rank::p]
                           for m in range(accum)])
    local = {k: v[rows] for k, v in batch.items()}
    # the reduced gradient, whole (before the step's clip scales it)
    if zero is not None:
        zero.reset_counters()
    trainer.compute_grads(local)
    alive = None if zero is None else {"peak": zero.peak_alive_bytes,
                                       "units": zero.unit_bytes(),
                                       "gathered": zero.gathered_bytes}
    grads = {}
    for name, t in trainer.optimizer.named_grads().items():
        if zero is not None and zero.sharded(name):
            t = zero.full(name, t)
        dim = model.tp_layout.get(name.replace(".", "/"))
        if dim is not None:
            t = gather_tp(t, dim, mesh.group("tp"), device)
        grads[name.replace(".", "/")] = t.detach().cpu().clone()
    metrics = trainer.train_step(local)
    tree = ckpt.full_model_tree(model)
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
            "params": {n: tree[n].detach().cpu().clone() for n in grads}, "alive": alive}


def case_ring(inputs, rank):
    from unimp_tpu_torch.ops.ring_attention import ring_attention_sharded
    from unimp_tpu_torch.parallel.seq_shard import sequence_sharding
    from unimp_tpu_torch.ops.attention import multi_head_attention
    from unimp_tpu_torch.ops import AttnMask

    device = inputs.get("device", "cpu")
    mesh = make_mesh(1, dist.get_world_size(), 1, device=device)
    out = {}
    b = inputs["q"].shape[0] // mesh.fsdp
    rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
    for name, kv_len in (("causal", None), ("kv_len", inputs["kv_len"][rows].to(device))):
        q, k, v = (inputs[x][rows].to(device).clone().requires_grad_() for x in "qkv")
        if name == "causal":
            o = ring_attention_sharded(q, k, v, mesh.group("fsdp"))
        else:  # through the model's dispatch, as --seq_shard routes it
            with sequence_sharding(mesh):
                o = multi_head_attention(q, k, v, AttnMask(causal=True), kv_len=kv_len)
        (o.float() * inputs["do"][rows].to(device)).sum().backward()
        out[name] = {key: t.detach().cpu() for key, t in
                     (("out", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad))}
    return out


def case_eval(inputs, rank):
    """{mesh: evaluate_rec's metrics} for each of ``inputs["meshes"]``."""
    return {mesh: _eval(inputs, mesh) for mesh in inputs["meshes"]}


def _eval(inputs, mesh_dims):
    from unimp_tpu_torch.data.dataset import TaskDataset
    from unimp_tpu_torch.data.loader import DataLoader
    from unimp_tpu_torch.data.tokenizer import UniMPTokenizer
    from unimp_tpu_torch.evals import evaluators

    dp, fsdp, tp = mesh_dims
    mesh = make_mesh(dp, fsdp, tp, device="cpu")
    set_mesh(mesh)
    model = _debug_model(inputs, mesh, train=False)
    tok = UniMPTokenizer.load(inputs["tokenizer"])
    ds = TaskDataset(inputs["data"], "beauty", "rec", "test", tok, n_items=inputs["n_items"],
                     image_size=28, history_len=5, load_images=False, max_records=5)
    loader = DataLoader(ds, 2, tok.pad_token_id, shuffle=False, drop_last=False,
                        num_workers=0, pad_to_multiple=128, process_index=mesh.data_rank,
                        process_count=mesh.data_size)
    targets = inputs["targets"][mesh.data_rank::mesh.data_size]

    class Retarget:
        dataset = loader.dataset

        def __len__(self):
            return len(loader)

        def __iter__(self):
            it = iter(targets)
            for batch in loader:
                yield dict(batch, targets=[next(it) for _ in batch["targets"]])

    from unimp_tpu_torch.decode import sampler
    from unimp_tpu_torch.parallel.mesh import lockstep_group

    sampler.reset_decode_steps()
    metrics = evaluators.evaluate_rec(model, Retarget(), tok, num_beams=3)
    return {"metrics": metrics, "decode_steps": dict(sampler.DECODE_STEPS),
            "lockstep": lockstep_group(model) is not None}


def _generate(model, inputs):
    from unimp_tpu_torch.decode import GenerationConfig, Generator
    from unimp_tpu_torch.data.transforms import normalize_on_device

    gen = Generator(model, GenerationConfig(max_new_tokens=8, eos_id=1, pad_id=1, num_beams=3,
                                            num_return_sequences=3), media_id=inputs["media"])
    latents = model.encode_vision(normalize_on_device(inputs["pixels"]))
    return gen.generate(inputs["ids"], inputs["seq_len"], latents)[0]


def case_bridge(inputs, rank):
    """A JAX tree placed on a tp 2 mesh two ways: the int8 tree loaded into
    a sliced model, the float tree through ``build_model(mesh=)``."""
    from unimp_tpu_torch.models import UniMPModel, get_config
    from unimp_tpu_torch.models.flamingo import compute_q_media
    from unimp_tpu_torch.parallel.sharding import shard_model_tp
    from unimp_tpu_torch.tools.from_flax import build_model, load_flax_params
    from unimp_tpu_torch.train import checkpoint as ckpt

    mesh = make_mesh(1, 1, 2, device="cpu")
    set_mesh(mesh)
    cfg = get_config("debug", dtype="float32")
    int8 = shard_model_tp(UniMPModel(cfg).eval(), mesh)
    load_flax_params(int8, inputs["int8"])
    fp = build_model(cfg, device="cpu", weights=inputs["float"], mesh=mesh)
    with torch.no_grad():
        from unimp_tpu_torch.data.transforms import normalize_on_device

        logits = int8(inputs["ids"], vision_x=normalize_on_device(inputs["pixels"]),
                      q_media=compute_q_media(inputs["ids"], inputs["media"]),
                      kv_len=inputs["seq_len"])[0]
        tokens = _generate(int8, inputs)
    return {"int8": {k: t.clone() for k, t in int8.state_dict().items()},
            "float": {k: t.clone() for k, t in fp.state_dict().items()},
            "logits": logits, "tokens": tokens, "whole": ckpt.full_model_tree(int8)}


def case_bridge_fsdp(inputs, rank):
    """A JAX tree placed on an fsdp 2 mesh two ways: the int8 tree loaded
    into a ZeRO-3 float model (its kernels become int8 chunks), the float
    tree through ``build_model(mesh=)``."""
    from unimp_tpu_torch.data.transforms import normalize_on_device
    from unimp_tpu_torch.models import get_config
    from unimp_tpu_torch.models.flamingo import compute_q_media
    from unimp_tpu_torch.tools.from_flax import build_model, load_flax_params
    from unimp_tpu_torch.train import checkpoint as ckpt

    mesh = make_mesh(1, 2, 1, device="cpu")
    set_mesh(mesh)
    cfg = get_config("debug", dtype="float32")
    int8 = build_model(cfg, device="cpu", weights=inputs["float"], mesh=mesh)
    load_flax_params(int8, inputs["int8"])
    fp = build_model(cfg, device="cpu", weights=inputs["float"], mesh=mesh)
    with torch.no_grad():
        logits = int8(inputs["ids"], vision_x=normalize_on_device(inputs["pixels"]),
                      q_media=compute_q_media(inputs["ids"], inputs["media"]),
                      kv_len=inputs["seq_len"])[0]
        tokens = _generate(int8, inputs)
    return {"int8": {k: t.clone() for k, t in int8.state_dict().items()},
            "sharded": sorted(int8.zero.entries), "logits": logits, "tokens": tokens,
            "whole_int8": ckpt.full_model_tree(int8), "whole_float": ckpt.full_model_tree(fp)}


# ---------------------------------------------------------------- the build

BUILD_KINDS = ("fp32", "bf16", "int8", "frozen_bf16", "frozen_int8", "unfrozen", "transfer")


def build_kwargs(kind: str) -> dict:
    """``build_model``'s arguments for a build kind: inference at each
    ``--eval_param_dtype``; training with frozen bf16 / int8 storage,
    float32 (``--unfreeze_backbone``, whose CLI then sets every tensor
    trainable) and the transfer entry's ``frozen_mask``."""
    from unimp_tpu_torch.cli.mmrec_prefix import frozen_mask

    return {"fp32": {}, "bf16": {"eval_param_dtype": "bf16"},
            "int8": {"eval_param_dtype": "int8"},
            "frozen_bf16": {"train": True, "frozen_dtype": torch.bfloat16},
            "frozen_int8": {"train": True, "frozen_dtype": "int8"},
            "unfrozen": {"train": True},
            "transfer": {"train": True, "trainable_mask": frozen_mask}}[kind]


def build_weights(source: dict):
    """``build_model``'s ``weights`` for a source: None (seeded), a flat
    tree, the ``.pt`` converter's function of the seeded tree, or an Orbax
    checkpoint's restored tree."""
    from unimp_tpu_torch.tools.convert_torch import load_torch_checkpoint
    from unimp_tpu_torch.train import checkpoint as ckpt

    if source["kind"] == "flat":
        return source["tree"]
    if source["kind"] == "pt":
        return lambda seeded: load_torch_checkpoint(source["path"], seeded)
    if source["kind"] == "orbax":
        return ckpt.restore_params(source["dir"], source["name"])
    return None


def whole_build(cfg, weights, seed=0, eval_param_dtype="fp32", train=False, frozen_dtype=None,
                trainable_mask=None):
    """The whole model as ``build_model`` made it on every rank before it
    built tensor by tensor: made whole, seeded, loaded, then frozen, or
    cast and quantized."""
    from unimp_tpu_torch.models import UniMPModel
    from unimp_tpu_torch.tools.from_flax import (EVAL_PARAM_DTYPES, init_params,
                                                 load_flax_params)
    from unimp_tpu_torch.train.partition import backbone_trainable_mask, freeze
    from unimp_tpu_torch.utils.inference import cast_params_for_inference
    from unimp_tpu_torch.utils.quant import quantize_params_int8

    model = UniMPModel(cfg)
    if weights is None or callable(weights):
        init_params(model, torch.Generator().manual_seed(seed))
    if callable(weights):
        weights = weights({n.replace(".", "/"): t.detach() for n, t in model.state_dict().items()})
    if weights is not None:
        load_flax_params(model, weights)
    if train:
        freeze(model, (trainable_mask or backbone_trainable_mask)(model), frozen_dtype)
        return model.train()
    cast = EVAL_PARAM_DTYPES[eval_param_dtype]
    if cast is not None:
        cast_params_for_inference(model, cast)
    if eval_param_dtype == "int8":
        quantize_params_int8(model)
    return model.eval()


def sliced(model, mesh) -> dict:
    """{name: tensor} a rank of ``mesh`` keeps of a whole model: its tp
    block (``shard_model_tp``), then its fsdp chunk where the JAX table
    shards the tensor."""
    from unimp_tpu_torch.parallel.sharding import ZeroShards, fsdp_chunk, shard_model_tp

    if mesh is None:
        return dict(model.state_dict())
    shard_model_tp(model, mesh)
    zero = ZeroShards(model, mesh) if mesh.fsdp > 1 else None
    out = {}
    for name, t in model.state_dict().items():
        if zero is not None and zero.placement(name.replace(".", "/"), t.shape) is not None:
            t = fsdp_chunk(t, zero.rank, zero.n)
        out[name] = t
    return out


class BuildSpy:
    """Watches ``build_model``'s materializing step: a weak reference on
    the storage of each whole tensor it makes. A whole tensor is transient
    until it is freed, unless the model keeps it (an unsliced, uncast
    tensor is its own parameter). Records the most transient whole tensors
    alive when a tensor is made, and the build's live bytes (the model's
    tensors placed so far plus the transient whole ones) just after."""

    def __init__(self):
        self.alive = {}  # key -> (storage's data pointer, bytes)
        self.most_alive_before = self.peak_live = self.calls = 0

    def _transient(self, model) -> list:
        placed = {t.untyped_storage().data_ptr() for t in model.state_dict().values()
                  if not t.is_meta}
        return [(ptr, n) for ptr, n in self.alive.values() if ptr not in placed]

    def __enter__(self):
        import weakref

        from unimp_tpu_torch.tools import from_flax

        self.cls, self.orig = from_flax._Build, from_flax._Build.materialize
        spy = self

        def materialize(build, name, meta):
            spy.most_alive_before = max(spy.most_alive_before, len(spy._transient(build.model)))
            out = spy.orig(build, name, meta)
            for t in out if isinstance(out, tuple) else (out,):
                st = t.untyped_storage()
                key = spy.calls = spy.calls + 1
                spy.alive[key] = (st.data_ptr(), st.nbytes())
                weakref.finalize(st, spy.alive.pop, key, None)
            placed = sum(t.numel() * t.element_size() for t in build.model.state_dict().values()
                         if not t.is_meta)
            live = placed + sum(n for _, n in spy._transient(build.model))
            spy.peak_live = max(spy.peak_live, live)
            return out

        self.cls.materialize = materialize
        return self

    def __exit__(self, *exc):
        self.cls.materialize = self.orig


def build_report(cfg, source: dict, kind: str, mesh) -> dict:
    """This rank's tensors from ``build_model(mesh=)`` against the whole
    build sliced: the names that differ (bits, dtype, shape, trainable or
    an int8 kernel's compute dtype) and the spy's readings."""
    from unimp_tpu_torch.tools.from_flax import build_model
    from unimp_tpu_torch.utils.quant import QuantizedKernel

    kw = build_kwargs(kind)
    with BuildSpy() as spy:
        got = build_model(cfg, device="cpu", weights=build_weights(source), mesh=mesh, **kw)
    whole = whole_build(cfg, build_weights(source), **kw)
    largest = max([p.numel() for p in whole.parameters()]
                  + [m.q.numel() for m in whole.modules() if isinstance(m, QuantizedKernel)]) * 4
    want = sliced(whole, mesh)
    have = dict(got.state_dict())
    bad = sorted(set(have) ^ set(want))

    def bits(t):
        return t.detach().reshape(-1).contiguous().view(torch.uint8)

    for name in set(have) & set(want):
        a, b = have[name], want[name]
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(bits(a), bits(b)):
            bad.append(name)
    grads = ({n: p.requires_grad for n, p in got.named_parameters()},
             {n: p.requires_grad for n, p in whole.named_parameters()})
    bad += [n for n in grads[0] if grads[0][n] != grads[1].get(n)]
    qdt = [({n: m.dtype for n, m in mod.named_modules() if isinstance(m, QuantizedKernel)})
           for mod in (got, whole)]
    if qdt[0] != qdt[1]:
        bad.append("QuantizedKernel.dtype")
    resident = sum(t.numel() * t.element_size() for t in got.state_dict().values())
    # the bytes the model's tensors hold: a tp block that is a view of its
    # whole tensor would keep the whole storage
    held = sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in got.state_dict().values()}.values())
    return {"bad": bad, "n": len(have), "resident": resident, "held": held,
            "largest_f32": largest,
            "peak_live": spy.peak_live, "most_alive_before": spy.most_alive_before,
            "sharded": len(got.zero.entries) if got.zero is not None else 0,
            "int8": sum(isinstance(m, QuantizedKernel) for m in got.modules())}


def build_config(source: dict):
    """debug in float32, at the source's vocabulary and widths."""
    import dataclasses

    from unimp_tpu_torch.models import get_config

    cfg = get_config("debug", dtype="float32")
    if "widths" in source:
        w = source["widths"]
        cfg = cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **w[k])
                             for k in ("vision", "resampler", "lm")},
                          cross_attn_every_n=w["cross_attn_every_n"])
    return cfg.replace(lm=dataclasses.replace(cfg.lm, vocab_size=source["vocab"]))


def case_build(inputs, rank):
    """{(mesh, source, kind): ``build_report``} for every source and build
    kind of ``inputs``, on tp 2 and on fsdp 2 in turn."""
    out = {}
    for dims in ((1, 1, 2), (1, 2, 1)):
        mesh = make_mesh(*dims, device="cpu")
        set_mesh(mesh)
        name = "tp2" if dims[2] == 2 else "fsdp2"
        for src_name, source in inputs["sources"].items():
            for kind in BUILD_KINDS:
                out[name, src_name, kind] = build_report(build_config(source), source, kind,
                                                         mesh)
    return out


def case_probe(inputs, rank):
    """Which collectives gloo takes on CUDA tensors: {name: None or the
    error}."""
    dev = torch.device("cuda", 0)
    world = dist.get_world_size()
    tries = {
        "all_reduce": lambda: dist.all_reduce(torch.ones(4, device=dev)),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * world, device=dev), torch.ones(4, device=dev)),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=dev), torch.ones(4 * world, device=dev)),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            out[name] = None
        except Exception as e:  # the refusal is the answer
            out[name] = f"{type(e).__name__}: {e}"[:300]
    return out


def case_cli(inputs, rank):
    """``mmrec.main`` (the group is up: ``build_mesh`` keeps it); returns
    the optimizer state and the int8 payloads as the run left them, whole,
    and what each of its eval passes returned."""
    from unimp_tpu_torch.cli import mmrec
    from unimp_tpu_torch.parallel.sharding import gather_tp, tensor_tp_dim
    from unimp_tpu_torch.utils.quant import QuantizedKernel

    evals, run_evals = [], mmrec.run_evals

    def spy(*args, **kw):
        evals.append(run_evals(*args, **kw))
        return evals[-1]

    mmrec.run_evals = spy
    trainer, state = mmrec.main(inputs["argv"])
    model, payloads = trainer.model, {}
    for name, mod in model.named_modules():
        if isinstance(mod, QuantizedKernel) and mod.persistent:
            path = f"{name.replace('.', '/')}/q"
            dim = tensor_tp_dim(model.tp_layout, path)
            q = model.zero.full(path, mod.q) if model.zero and model.zero.sharded(path) else mod.q
            payloads[path] = (q if dim is None else
                              gather_tp(q, dim, model.tp_group, "cpu")).cpu()
    return {"opt_state": trainer.optimizer_state(), "state": state, "payloads": payloads,
            "evals": evals}


def main():
    case, rank, world, store, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    if torch.cuda.is_available():
        torch.cuda.set_device(0)  # the ranks of a card test share one card
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    result = globals()[f"case_{case}"](inputs, rank)
    torch.save(result, os.path.join(out_dir, f"{case}_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
