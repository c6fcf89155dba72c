"""``tools/from_flax.py:build_model`` builds tensor by tensor, each rank's
straight into its chunks, as the JAX trainer makes its parameters already
sharded (``unimp_tpu/train/trainer.py``, ``jit(init_fn,
out_shardings=pshard)``).

Every rank's resident tensors equal, bit for bit, what the whole model
(made whole, seeded, loaded, frozen or cast and quantized, as the build
did before) gives when it is sliced to the rank's tp block and cut to its
fsdp chunk: for seeded weights, a flat float tree, a flat tree with int8
kernels, a ``.pt`` through the converter (a grown embedding and tensors
the file does not map) and the committed Orbax fixture; for inference at
fp32 / bf16 / int8 and training with frozen bf16 / int8, unfrozen and the
transfer's mask; on one device (in process), and at tp 2 and fsdp 2 (two
gloo ranks, ``tests/torch_parallel_worker.py:case_build``). A spy on the
materializing step shows one whole tensor alive at a time and the build's
live bytes within the resident bytes plus the largest whole float32
tensor, and the built tensors' storages hold no more than their own
bytes (a tp block must not keep its whole tensor alive).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
import torch_parallel_worker as W  # noqa: E402
from test_torch_parallel import _spawn  # noqa: E402

from unimp_tpu_torch.models import UniMPModel  # noqa: E402
from unimp_tpu_torch.tools.export_torch import export_state_dict  # noqa: E402
from unimp_tpu_torch.tools.from_flax import build_model  # noqa: E402
from unimp_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from unimp_tpu_torch.utils.quant import _quantize_leaf, quantize_kernel  # noqa: E402

torch.set_num_threads(2)  # six test workers share the cores
ORBAX = Path(__file__).parent / "data" / "orbax"
SOURCES = ("seeded", "flat", "flat_int8", "pt", "orbax")
MESHES = ("none", "tp2", "fsdp2")


def _flat_tree(cfg, seed: int, int8: bool) -> dict:
    """A flat tree of random numpy values at the model's shapes; with
    ``int8``, its MLP kernels as int8 payloads and scales (the JAX
    quantizer's leaves)."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        model = UniMPModel(cfg)
    shapes = {n.replace(".", "/"): tuple(p.shape) for n, p in model.named_parameters()}
    tree = {path: rng.normal(0, 0.05, shape).astype(np.float32) for path, shape in shapes.items()}
    if int8:
        for path in [p for p in tree if "/mlp/" in p and p.endswith("kernel")]:
            q, scale = _quantize_leaf(torch.from_numpy(tree.pop(path)), 1)
            tree[f"{path}/q"], tree[f"{path}/scale"] = q.numpy(), scale.numpy()
    return tree


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """{name: source} as ``torch_parallel_worker.build_weights`` reads them."""
    d = tmp_path_factory.mktemp("build")
    out = {"seeded": {"kind": "seeded", "vocab": 512}}
    cfg = W.build_config({"vocab": 512})
    out["flat"] = {"kind": "flat", "vocab": 512, "tree": _flat_tree(cfg, 1, False)}
    out["flat_int8"] = {"kind": "flat", "vocab": 512, "tree": _flat_tree(cfg, 2, True)}
    # a .pt of a smaller vocabulary (the embedding grows) that leaves two
    # tensors unmapped (they keep their seeded values)
    small = build_model(W.build_config({"vocab": 384}), device="cpu", seed=5)
    sd = export_state_dict(small, "neox")
    dropped = ["vision_encoder.vision_model.pre_layrnorm.weight",
               "perceiver.layers.0.0.to_kv.weight"]
    for key in dropped:
        del sd[key]
    torch.save({"model_state_dict": sd}, d / "model.pt")
    out["pt"] = {"kind": "pt", "vocab": 512, "path": str(d / "model.pt")}
    spec = json.loads((ORBAX / "config.json").read_text())
    vocab = ckpt.restore_params(str(ORBAX), "final_weights")["embed/embedding"].shape[0]
    out["orbax"] = {"kind": "orbax", "vocab": vocab, "dir": str(ORBAX), "name": "final_weights",
                    "widths": {k: spec[k] for k in ("vision", "resampler", "lm",
                                                    "cross_attn_every_n")}}
    return out


@pytest.fixture(scope="module")
def two_ranks(sources, tmp_path_factory):
    """Rank 0's and rank 1's reports of every case at tp 2 and fsdp 2."""
    return _spawn(tmp_path_factory.mktemp("ranks"), "build", 2, {"sources": sources})


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", W.BUILD_KINDS)
@pytest.mark.parametrize("source", SOURCES)
def test_build_places_each_rank_as_the_whole_build_sliced(request, sources, mesh, kind,
                                                          source):
    if mesh == "none":
        src = sources[source]
        reports = [W.build_report(W.build_config(src), src, kind, None)]
    else:
        reports = [r[mesh, source, kind] for r in request.getfixturevalue("two_ranks")]
    for rank, rep in enumerate(reports):
        assert rep["bad"] == [], (rank, rep["bad"][:8])
        assert rep["held"] == rep["resident"], rank  # no whole storage behind a block
        assert rep["most_alive_before"] == 0, rank  # one whole tensor alive at a time
        assert rep["peak_live"] <= rep["resident"] + rep["largest_f32"], (rank, rep)
        assert (rep["sharded"] > 0) == (mesh == "fsdp2"), rank
        # the fixture's kernels are all below the quantizer's 65,536 elements
        assert (rep["int8"] > 0) == (kind in ("int8", "frozen_int8") and source != "orbax"
                                     or source == "flat_int8")


def test_pt_source_grows_and_keeps_seeded_values(sources):
    """The ``.pt`` source exercises both deferred cases of the converter's
    meta target: the grown embedding and the tensors it does not map."""
    cfg = W.build_config(sources["pt"])
    seeded = build_model(cfg, device="cpu")
    got = build_model(cfg, device="cpu", weights=W.build_weights(sources["pt"]))
    small = build_model(W.build_config({"vocab": 384}), device="cpu", seed=5)
    emb = got.embed.embedding.detach()
    assert torch.equal(emb[:384], small.embed.embedding.detach())
    assert torch.equal(emb[384:], seeded.embed.embedding.detach()[384:])
    attn, seeded_attn = got.resampler.block_0.attn, seeded.resampler.block_0.attn
    for proj in ("k_proj", "v_proj"):  # from the unmapped ``to_kv``
        assert torch.equal(getattr(attn, proj).kernel, getattr(seeded_attn, proj).kernel)
    assert torch.equal(attn.q_proj.kernel, small.resampler.block_0.attn.q_proj.kernel)
    assert not torch.equal(attn.q_proj.kernel, seeded_attn.q_proj.kernel)


@pytest.mark.parametrize("shape,n_in,cast", [
    ((128, 512), 1, None), ((64, 2, 32), 1, torch.bfloat16), ((2, 32, 96), 2, torch.bfloat16),
    ((300, 7), 1, None)])
def test_quantize_kernel_equals_the_whole_quantizer(shape, n_in, cast):
    """``quantize_kernel`` in column blocks gives ``_quantize_leaf``'s
    payload and scales bit for bit, from the float32 tensor or its
    bfloat16 cast."""
    w = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    q, scale = quantize_kernel(w, n_in, cast, block=64)
    want_q, want_scale = _quantize_leaf(w if cast is None else w.to(cast), n_in)
    assert torch.equal(q, want_q) and torch.equal(scale, want_scale)
