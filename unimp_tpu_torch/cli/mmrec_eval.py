"""Eval-only entry point: the port's ``mmrec_eval`` (counterpart of
``unimp_tpu/cli/mmrec_eval.py``, the reference's mmrec_eval.py:303-798).

    python -m unimp_tpu_torch.cli.mmrec_eval --mmrec_path DATA --subset beauty \\
        --task rec --single_task --do_test [--device cpu] ...

Builds the tokenizer (corpus + task vocabulary), the model with the
port's seeded weights (cast, or quantized to int8 after the cast, as
``--eval_param_dtype`` says), then evaluates the test split (and the eval
split with ``--do_eval``): per-user metric dumps under
``{external_save_dir}/{run_name}/results/`` and ``eval_results.json``.
Restoring trained weights is not ported yet.
"""

from __future__ import annotations

import json
import os

from unimp_tpu_torch.cli import common
from unimp_tpu_torch.cli.arguments import build_parser
from unimp_tpu_torch.evals.evaluators import evaluate_rec
from unimp_tpu_torch.utils.logging import MetricLogger

EVALUATORS = {"rec": evaluate_rec}


def run_evals(args, model, tokenizer, logger, epoch, tasks=None, split="test",
              cache_holder=None):
    """Evaluate ``tasks`` on ``split``; per-user dumps named as the
    reference names them (eval_rec.py:158), rooted in the run dir."""
    tasks = tasks or ([args.task] if args.single_task else ["rec", "exp", "img_sel", "search"])
    run_dir = os.path.join(args.external_save_dir or ".", args.run_name)
    rank = 0
    if cache_holder is None:
        cache_holder = {}
    results = {}
    for task in tasks:
        try:
            ds = common.make_dataset(args, tokenizer, split, task=task)
        except FileNotFoundError as e:
            logger.print(f"[eval] skipping {task} ({split}): {e}")
            continue
        if task not in EVALUATORS:
            raise NotImplementedError(f"the {task} evaluator is not ported yet "
                                      "(ROADMAP.md §1, item 5)")
        loader = common.make_loader(args, ds, tokenizer)
        metrics = EVALUATORS[task](
            model, loader, tokenizer, num_beams=args.num_beams,
            kv_int8=getattr(args, "kv_int8", False), cache_holder=cache_holder,
            dump_path=os.path.join(
                run_dir, "results",
                f"{args.run_name}_{task}_{split}_epoch_{epoch}_rank_{rank}.json"))
        results[task] = metrics
        prefix = task if split == "test" else f"{task}/{split}"
        logger.log({f"{prefix}/{k}": v for k, v in metrics.items()
                    if isinstance(v, (int, float))}, step=epoch)
        logger.print(f"[epoch {epoch}] {task} ({split}): " + " ".join(
            f"{k}={v:.4f}" for k, v in metrics.items() if isinstance(v, (int, float))))
    return results


def main(argv=None):
    args = build_parser(eval_only=True).parse_args(argv)
    common.check_ported(args)
    tokenizer = common.build_tokenizer(args)
    model = common.build_model(args, tokenizer)

    save_dir = os.path.join(args.external_save_dir or ".", args.run_name)
    logger = MetricLogger(save_dir, f"{args.run_name}_eval", use_wandb=args.report_to_wandb,
                          wandb_project=args.wandb_project, wandb_entity=args.wandb_entity,
                          config=vars(args))
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
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    logger.print(f"Wrote {out}")
    return results


if __name__ == "__main__":
    main()
