"""A tiny benchmark tree for the CPU tests: a manifest, configuration and
cell files at sizes a test process holds, in a temporary directory."""

from __future__ import annotations

import json
from pathlib import Path

TOKENS = {"media": 400, "answer": 399, "endofchunk": 398, "item_base": 401, "pad": 0, "eos": 0}
VISION = {"image_size": 28, "patch_size": 14, "hidden_size": 64, "num_layers": 2,
          "num_heads": 2, "mlp_ratio": 4, "layernorm_eps": 1e-5}
RESAMPLER = {"num_latents": 8, "depth": 1, "num_heads": 2, "head_dim": 32, "ff_mult": 4}
NEOX = {"vocab_size": 512, "hidden_size": 128, "num_layers": 2, "num_heads": 2,
        "num_kv_heads": None, "mlp_hidden": None, "norm": "layernorm", "positions": "rope",
        "rotary_pct": 0.25, "rope_theta": 10000.0, "act": "gelu", "parallel_block": True,
        "use_bias": True, "tie_embeddings": False, "layernorm_eps": 1e-5, "max_seq_len": 512}
MPT = dict(NEOX, positions="alibi", rotary_pct=1.0, parallel_block=False, use_bias=False,
           tie_embeddings=True)

EVAL = {"batch": 4, "prompt_len": 32, "min_len": 20, "media": 2, "n_items": 100, "beams": 3,
        "new_tokens": 6, "pool": 3, "encode_chunk": 16}
TRAIN = {"micro_batch": 2, "accum": 2, "seq_len": 32, "min_len": 24, "media": 2,
         "n_items": 100, "pool": 8, "learning_rate": 2e-4, "lr_scheduler": "cosine",
         "total_updates": 100, "warmup_updates": 2, "weight_decay": 0.1, "gamma": 2.0,
         "check_updates": 3}


def config(name: str, lm: dict, every: int = 1) -> dict:
    return {"name": name, "source": "test", "vision": VISION, "resampler": RESAMPLER, "lm": lm,
            "cross_attn_every_n": every, "media_mode": "immediate", "dtype": "float32",
            "tokens": TOKENS, "reduced": []}


CONFIGS = {"tiny-neox": config("tiny-neox", NEOX), "tiny-mpt": config("tiny-mpt", MPT, 2)}

CELLS = {
    "rec.tiny-neox": {"config": "tiny-neox", "family": "rec_beam", "traffic": EVAL,
                      "program": {"eval_param_dtype": "fp32", "kv_int8": False},
                      "check": {"users": 2, "limits": {
                          "mean_score_gap_nats": 1e-3, "worst_user_gap_nats": 1e-3,
                          "rank_inversions": 0}}},
    "rec-int8.tiny-mpt": {"config": "tiny-mpt", "family": "rec_beam", "traffic": EVAL,
                          "program": {"eval_param_dtype": "int8", "kv_int8": True},
                          "check": {"users": 2, "limits": {
                              "mean_score_gap_nats": 2e-2, "worst_user_gap_nats": 4e-2,
                              "rank_inversions": 0}}},
    "train.tiny-neox": {"config": "tiny-neox", "family": "train", "traffic": TRAIN,
                        "program": {"frozen": "fp32"},
                        "check": {"limits": {"loss_gap": 1e-4, "grad_leaf_gap": 1e-3,
                                             "change_leaf_gap": 1e-2}}},
    "train.tiny-mpt": {"config": "tiny-mpt", "family": "train", "traffic": TRAIN,
                       "program": {"frozen": "int8", "bf16_opt_state": True, "remat": True,
                                   "remat_policy": "dots", "cache_vision_latents": True},
                       "check": {"limits": {"loss_gap": 1e-4, "grad_leaf_gap": 1e-2,
                                            "change_leaf_gap": 0.2}}},
}


def write_tree(root: Path, cells=CELLS, configs=CONFIGS) -> dict:
    """The manifest and files of ``cells`` under ``root``; returns the
    manifest."""
    for kind in ("workloads", "configs"):
        (root / "gpubench" / kind).mkdir(parents=True, exist_ok=True)
    for name, c in configs.items():
        (root / "gpubench" / "configs" / f"{name}.json").write_text(json.dumps(c))
    for name, c in cells.items():
        (root / "gpubench" / "workloads" / f"{name}.json").write_text(
            json.dumps({"name": name, "chips": 1, "why": "test", **c}))
    evals = [n for n, c in cells.items() if c["family"] == "rec_beam"]
    trains = [n for n, c in cells.items() if c["family"] == "train"]
    bench = {
        "command": ["python3", "gpubench/run.py"], "paths": ["gpubench"], "run_seconds": 1,
        "configs": [{"name": n, "source": "test", "file": f"gpubench/configs/{n}.json",
                     "reduced": [], "why": "test"} for n in configs],
        "workloads": [{"name": n, "config": c["config"], "traffic": n.split(".")[0], "chips": 1,
                       "why": "test"} for n, c in cells.items()],
        "end_to_end": [
            {"name": "items_per_s", "unit": "items/s", "better": "higher", "bound": 0.05,
             "source": "host_clock", "workloads": evals},
            {"name": "samples_per_s", "unit": "samples/s", "better": "higher", "bound": 0.05,
             "source": "host_clock", "workloads": trains},
            {"name": "peak_mem_gib", "unit": "GiB", "better": "lower", "bound": 0.01,
             "source": "device_trace"},
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
             "source": "host_clock"}],
        "per_layer": [],
    }
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench
