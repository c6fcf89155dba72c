"""CLI for the few-shot vision-language benchmark harness.

Counterpart of ``unimp_tpu/cli/evaluate.py`` (the inherited OpenFlamingo
harness entry, UniMP's pipeline/eval/evaluate.py:28-120 flags and its
main: per-benchmark switches, shot counts, trial seeds, a results file).
The model is a checkpoint directory (``train/checkpoint.py``: one that the
port's ``mmrec`` wrote, e.g. ``final_weights``, or the JAX package's Orbax
directory of the same name). Datasets are JSON manifests
(``evals/benchmark_harness.py``). Runs on the card unless ``--device cpu``.
Under ``torchrun`` with ``--mesh_fsdp N`` the model is ZeRO-3 over fsdp
(``parallel/sharding.py:ZeroShards``: each rank keeps its chunk of every
tensor the JAX table shards over fsdp and gathers a block's tensors per
forward call); every rank runs the same examples and rank 0 writes the
results file.

Usage:
    python -m unimp_tpu_torch.cli.evaluate \\
        --checkpoint_dir runs/x --checkpoint_name final_weights \\
        --variant 4b-instruct --tokenizer_path tok.json \\
        --eval_coco --coco_manifest coco_val.json \\
        --shots 0 4 --results_file results.json [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from unimp_tpu_torch.data.tokenizer import UniMPTokenizer
from unimp_tpu_torch.evals import benchmark_harness as bh
from unimp_tpu_torch.models import get_config
from unimp_tpu_torch.parallel import mesh as pmesh
from unimp_tpu_torch.tools import from_flax
from unimp_tpu_torch.train.checkpoint import is_writer, restore_params


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint_dir", type=str, required=True,
                   help="directory holding the port's checkpoint")
    p.add_argument("--checkpoint_name", type=str, default="final_weights")
    p.add_argument("--variant", type=str, default="4b-instruct",
                   help="model variant (models/config.py VARIANTS)")
    p.add_argument("--tokenizer_path", type=str, required=True)
    p.add_argument("--results_file", type=str, default=None,
                   help="JSON file to write all metrics to")
    p.add_argument("--shots", nargs="+", type=int, default=[0, 4, 8])
    p.add_argument("--trial_seeds", nargs="+", type=int, default=[42],
                   help="one trial per seed; metrics report the mean")
    p.add_argument("--num_samples", type=int, default=None,
                   help="cap evaluated examples per benchmark")
    p.add_argument("--batch_size", type=int, default=8)  # surface parity
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--precision", type=str, default="bf16",
                   choices=["bf16", "fp32"])
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda unless cpu is asked for")
    p.add_argument("--mesh_fsdp", type=int, default=1,
                   help="ranks that shard the parameters (ZeRO-3); the rest of the "
                        "world replicates")
    # benchmark switches + manifests
    p.add_argument("--eval_coco", action="store_true")
    p.add_argument("--coco_manifest", type=str, default=None)
    p.add_argument("--eval_vqa", action="store_true")
    p.add_argument("--vqa_manifest", type=str, default=None)
    p.add_argument("--eval_ok_vqa", action="store_true")
    p.add_argument("--ok_vqa_manifest", type=str, default=None)
    p.add_argument("--eval_imagenet", action="store_true")
    p.add_argument("--imagenet_manifest", type=str, default=None)
    p.add_argument("--imagenet_classes", type=str, default=None,
                   help="JSON list of class names (index = label)")
    return p


def build_model(args, tokenizer, mesh=None):
    """The variant at the CLI's precision, vocabulary (the tokenizer's,
    rounded up to 128) and image size, with the checkpoint's weights. Under
    ``--precision bf16`` the matrices are cast to bfloat16 once at the load
    (``eval_param_dtype`` "bf16"): the values the JAX package's float32
    parameters round to at each use in its bf16 compute."""
    cfg = get_config(args.variant,
                     dtype="float32" if args.precision == "fp32" else "bfloat16")
    vocab = ((len(tokenizer) + 127) // 128) * 128
    cfg = cfg.replace(
        lm=dataclasses.replace(cfg.lm, vocab_size=vocab),
        vision=dataclasses.replace(cfg.vision, image_size=args.image_size),
    )
    weights = restore_params(args.checkpoint_dir, args.checkpoint_name)
    return from_flax.build_model(cfg, device=args.device, weights=weights, mesh=mesh,
                                 eval_param_dtype="fp32" if args.precision == "fp32" else "bf16")


def _mean_over_seeds(args, run, key: str) -> float:
    scores = [run(seed)[key] for seed in args.trial_seeds]
    return sum(scores) / len(scores)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    tokenizer = UniMPTokenizer.load(args.tokenizer_path)
    pmesh.init_distributed(device=args.device)
    mesh = pmesh.make_mesh(dp=None, fsdp=args.mesh_fsdp, device=args.device)
    model = build_model(args, tokenizer, mesh=mesh)
    common = dict(image_size=args.image_size, limit=args.num_samples)

    results: dict = {}
    if args.eval_coco:
        assert args.coco_manifest, "--coco_manifest required with --eval_coco"
        for shots in args.shots:
            key = f"coco_cider_shots_{shots}"
            results[key] = _mean_over_seeds(args, lambda seed: bh.evaluate_captioning(
                model, tokenizer, args.coco_manifest, num_shots=shots, seed=seed,
                **common), "cider")
            print(f"coco shots={shots} cider={results[key]:.3f}")
    for switch, manifest, name, ok_vqa in (
            (args.eval_vqa, args.vqa_manifest, "vqa", False),
            (args.eval_ok_vqa, args.ok_vqa_manifest, "ok_vqa", True)):
        if not switch:
            continue
        assert manifest, f"--{name}_manifest required with --eval_{name}"
        for shots in args.shots:
            key = f"{name}_accuracy_shots_{shots}"
            results[key] = _mean_over_seeds(args, lambda seed: bh.evaluate_vqa(
                model, tokenizer, manifest, num_shots=shots, seed=seed, ok_vqa=ok_vqa,
                **common), "vqa_accuracy")
            print(f"{name} shots={shots} acc={results[key]:.3f}")
    if args.eval_imagenet:
        assert args.imagenet_manifest and args.imagenet_classes, (
            "--imagenet_manifest and --imagenet_classes required")
        with open(args.imagenet_classes) as f:
            class_names = json.load(f)
        m = bh.evaluate_classification(model, tokenizer, args.imagenet_manifest,
                                       class_names, **common)
        results["imagenet_top1"] = m["top1"]
        print(f"imagenet top1={m['top1']:.3f}")

    if args.results_file and is_writer():
        with open(args.results_file, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
