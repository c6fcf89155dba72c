"""Eval-only entry point: the port's ``mmrec_eval`` (counterpart of
``unimp_tpu/cli/mmrec_eval.py``, the reference's mmrec_eval.py:303-798).

    python -m unimp_tpu_torch.cli.mmrec_eval --mmrec_path DATA --subset beauty \\
        --task rec --single_task --do_test [--device cpu] ...

Builds the tokenizer (corpus + task vocabulary), the model with the
port's seeded weights or, with ``--load_weights_name``, the weights of a
checkpoint of the port's ``mmrec`` (``train/checkpoint.py``; under
``{load_dir}``, or ``{external_save_dir}/{load_run_name or run_name}``),
then cast, or quantized to int8 after the cast, as ``--eval_param_dtype``
says (restore first, then quantize, as the JAX package does). It then
evaluates the test split (and the eval split with ``--do_eval``): per-user
metric dumps under ``{external_save_dir}/{run_name}/results/`` and
``eval_results.json``. Under ``torchrun`` each rank evaluates its shard
of the users (the metrics are joined over ranks; rank 0 writes
``eval_results.json``), with the model sliced over ``--mesh_tp``.
"""

from __future__ import annotations

import json
import os

from unimp_tpu_torch.cli import common
from unimp_tpu_torch.cli.arguments import build_parser
from unimp_tpu_torch.cli.mmrec import run_evals
from unimp_tpu_torch.train import checkpoint as ckpt
from unimp_tpu_torch.utils.logging import MetricLogger


def main(argv=None):
    args = build_parser(eval_only=True).parse_args(argv)
    common.check_ported(args)
    mesh = common.build_mesh(args)
    tokenizer = common.build_tokenizer(args)
    weights = None
    if args.load_weights_name:
        weights = ckpt.restore_params(common.weights_dir(args), args.load_weights_name)
    model = common.build_model(args, tokenizer, weights=weights, mesh=mesh)
    del weights  # the model holds a copy: release the file's mapping

    save_dir = os.path.join(args.external_save_dir or ".", args.run_name)
    logger = MetricLogger(save_dir, f"{args.run_name}_eval", use_wandb=args.report_to_wandb,
                          wandb_project=args.wandb_project, wandb_entity=args.wandb_entity,
                          config=vars(args), rank=mesh.rank)
    tasks = [args.task] if args.single_task else None
    results = {}
    shared_cache = {}  # one latent cache across both splits
    if args.do_eval:
        results["eval"] = run_evals(args, model, tokenizer, logger, epoch=0, tasks=tasks,
                                    split="eval", cache_holder=shared_cache)
    if args.do_test or not args.do_eval:
        results.update(run_evals(args, model, tokenizer, logger, epoch=0, tasks=tasks,
                                 split="test", cache_holder=shared_cache))
    out = os.path.join(save_dir, "eval_results.json")
    if ckpt.is_writer():
        with open(out, "w") as f:
            json.dump(results, f, indent=2)
    common.pmesh.barrier()
    logger.print(f"Wrote {out}")
    return results


if __name__ == "__main__":
    main()
