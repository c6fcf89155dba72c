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


def _debug_model(inputs, mesh, train=True):
    from unimp_tpu_torch.models import get_config
    from unimp_tpu_torch.tools.from_flax import build_model

    cfg = get_config(inputs.get("variant", "debug"), dtype="float32")
    if "vocab" in inputs:
        import dataclasses

        cfg = cfg.replace(lm=dataclasses.replace(cfg.lm, vocab_size=inputs["vocab"]))
    return build_model(cfg, device=inputs.get("device", "cpu"), train=train,
                       weights=inputs["weights"], mesh=mesh)


def case_step(inputs, rank):
    """{mesh: one Trainer step's results} for each of ``inputs["meshes"]``,
    one after the other in this group."""
    return {mesh: _step(inputs, mesh) for mesh in inputs["meshes"]}


def _step(inputs, mesh_dims):
    """One Trainer step on this rank's rows of the global batch (accum 2:
    micro-batch m of every rank together is the global micro-batch m)."""
    from unimp_tpu_torch.parallel.sharding import ZeroShards, gather_tp
    from unimp_tpu_torch.train import checkpoint as ckpt
    from unimp_tpu_torch.train.optimizer import decay_mask, make_optimizer
    from unimp_tpu_torch.train.partition import trainable_params
    from unimp_tpu_torch.train.trainer import Trainer

    dp, fsdp, tp = mesh_dims[:3]
    bf16 = torch.bfloat16 if "bf16" in mesh_dims[3:] else None  # --bf16_opt_state
    device = inputs.get("device", "cpu")
    mesh = make_mesh(dp, fsdp, tp, device=device)
    set_mesh(mesh)
    model = _debug_model(inputs, mesh)
    trainable = trainable_params(model)
    zero = ZeroShards(trainable, mesh) if fsdp > 1 else None
    opt = make_optimizer(zero.shards if zero else trainable, learning_rate=inputs["lr"],
                         moment_dtype=bf16, decay=decay_mask(trainable))
    trainer = Trainer(model, opt, device=device, accum_steps=2, mesh=mesh, zero=zero,
                      grad_dtype=bf16, **inputs["ids"])
    batch, accum, p = inputs["batch"], 2, mesh.data_size
    g = batch["input_ids"].shape[0] // accum
    rows = np.concatenate([np.arange(m * g, (m + 1) * g)[mesh.data_rank::p]
                           for m in range(accum)])
    local = {k: v[rows] for k, v in batch.items()}
    # the reduced gradient, whole (before the step's clip scales it)
    trainer.compute_grads(local)
    grads = {}
    for name, t in trainer.optimizer.named_grads().items():
        if zero is not None:
            t = zero.full(name, t)
        dim = model.tp_layout.get(name.replace(".", "/"))
        if dim is not None:
            t = gather_tp(t, dim, mesh.group("tp"), device)
        grads[name.replace(".", "/")] = t.detach().cpu().clone()
    metrics = trainer.train_step(local)
    tree = ckpt.full_model_tree(model)
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
            "params": {n: tree[n].detach().cpu().clone() for n in grads}}


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

        def __iter__(self):
            it = iter(targets)
            for batch in loader:
                yield dict(batch, targets=[next(it) for _ in batch["targets"]])

    return {"metrics": evaluators.evaluate_rec(model, Retarget(), tok, num_beams=3)}


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
            payloads[path] = (mod.q if dim is None else
                              gather_tp(mod.q, dim, model.tp_group, "cpu")).cpu()
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
