"""The comparisons that decide ``correct``: what the timed path produced,
held to the plain reference (``reference/flamingo.py``) after the window,
once the program's state is freed.

Rec evaluation (beam search): a sample of the window's users, drawn from
the seed with the longest in it, and every beam served to them. Beam
tokens are not the argmax at each step, so a served token's logit is not
held to the reference's best; instead each beam's score is: the program
returns, per beam, its log-probability sum normalised by the hypothesis'
length (prompt plus generated tokens, the ``length_norm="full"`` rule),
and the reference rescores the same tokens (prompt, served tokens and, for
a finished beam, the end token) in one full forward. Numbers, each
compared where the cell's file gives it a limit:

- ``mean_score_gap_nats``: the mean over the sampled beams of the gap
  between the two sums (the widest gap swings from seed to seed by its
  nature, and in bfloat16 reads within 2x of the int8 control);
- ``worst_user_gap_nats``: the largest of the users' mean gaps, so that a
  fault in one user's rows is not diluted by the others';
- ``selection_deficit_nats``: the beam search's choices. A token a beam
  keeps has fewer than K non-end siblings above it (the top-2K expansion
  keeps the first K that do not end; an end token retires only within
  the first K), so its log-probability is at least the (K+1)-th best at
  its position. The number is the mean over the sampled beams of the sum
  of the amounts by which the reference puts a served token below its
  (K+1)-th best: a selection that keeps worse candidates, with scores
  true to their tokens, reads here and nowhere else;
- ``rank_inversions``: returned beams whose score exceeds the one ranked
  above it (exact: the returned set is sorted by score).

It covers the catalogue's latents (the reference encodes the sampled
users' items again), the prefill with gated cross-attention, decoding
through the prompt / gen KV caches, the beam selection, and where the
cell sets them int8 weights and int8 KV caches.

Training: set-up drives the trainer through its first three updates on
distinct rows (``families/train.py``) and reads each micro-batch's loss,
the first update's gradient as the optimizer got it (Adam's first moment
over 1 - beta1) and the parameters' change after three updates, by leaf.
The reference runs the same three updates in float32. Compared: the
widest relative gap of a loss, and for the gradient and the change the
worst leaf's gap of norms over the larger of that leaf's reference norm
and the median leaf's.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench.reference import flamingo as ref


def judge(numbers: dict, limits: dict) -> dict:
    """{"correct", "numbers": {name: {"value", "limit"}}}: correct when
    every number that ``limits`` names is finite and at most its limit."""
    unknown = set(limits) - set(numbers)
    if unknown:
        raise KeyError(f"limits for numbers the check does not compute: {sorted(unknown)}")
    out = {name: {"value": float(v), "limit": float(limits[name])}
           for name, v in numbers.items() if name in limits}
    ok = all(np.isfinite(x["value"]) and x["value"] <= x["limit"] for x in out.values())
    return {"correct": bool(ok), "numbers": out}


def served_sums(tokens: np.ndarray, scores: np.ndarray, seq_len: int, eos: int):
    """Per beam: (generated tokens before the end token, unnormalised
    log-probability sum) from the program's tokens [R, G] and normalised
    scores [R]."""
    out = []
    for row, score in zip(tokens, scores):
        ends = np.flatnonzero(row == eos)
        n = int(ends[0]) if ends.size else row.shape[0]
        out.append((n, float(score) * (seq_len + n)))
    return out


@torch.no_grad()
def rescore(sizes, params, seqs, n_prompt, n_scored, latents, kv_int8, media_id, beams,
            rows=20):
    """Reference (log-probability sum, selection deficit) of each of
    ``seqs`` [N, L] (prompt, then the scored tokens), ``n_prompt`` /
    ``n_scored`` [N], ``latents`` [N, M, Lt, D]; the tokens at n_prompt ..
    n_prompt + n_scored - 1 are scored. The deficit sums, over those
    tokens, how far each lies below the (``beams`` + 1)-th best
    log-probability at its position. ``rows`` sequences at a time, each
    pass drawing the weights again."""
    out = []
    for lo in range(0, seqs.shape[0], rows):
        hi = min(lo + rows, seqs.shape[0])
        out += _rescore(sizes, params, seqs[lo:hi], n_prompt[lo:hi], n_scored[lo:hi],
                        latents[lo:hi], kv_int8, media_id, beams)
    return out


def _rescore(sizes, params, seqs, n_prompt, n_scored, latents, kv_int8, media_id, beams):
    dev = latents.device
    n, length = seqs.shape
    ids = torch.as_tensor(seqs, device=dev)
    pos = torch.arange(length, device=dev)
    np_t = torch.as_tensor(n_prompt, device=dev)
    in_prompt = pos[None] < np_t[:, None]
    q_media = torch.cumsum((ids == media_id) & in_prompt, dim=1)
    # generated tokens see the prompt's last medium (the decode state's)
    q_media = torch.where(in_prompt, q_media, q_media.gather(1, (np_t - 1)[:, None]))
    causal = pos[None, :, None] >= pos[None, None, :]
    logits = ref.lm_logits(params, sizes, ids, latents, q_media, causal.expand(n, -1, -1),
                           pos[None].expand(n, -1), gen_rows=~in_prompt if kv_int8 else None)
    logp = torch.log_softmax(logits, dim=-1)
    out = []
    for i in range(n):
        a, k = int(n_prompt[i]), int(n_scored[i])
        rows = logp[i, a - 1: a - 1 + k]
        served = rows.gather(1, ids[i, a: a + k, None].long())[:, 0]
        floor = rows.topk(beams + 1, dim=-1).values[:, -1]
        out.append((float(served.double().sum()),
                    float((floor - served).clamp(min=0).double().sum())))
    return out


def rec_beam(r, catalogue: np.ndarray, outputs: list) -> dict:
    """``outputs``: (pool index, tokens [B, R, G], scores [B, R]) of each
    batch of the window; the prompts are drawn again from the seed."""
    from gpubench import traffic

    t, tok, spec = r.spec["traffic"], r.sizes.tokens, r.spec
    prog = spec["program"]
    rng = np.random.default_rng([r.seed % 2**63, 0])
    pool = [traffic.prompts(rng, t["batch"], t["prompt_len"], t["media"], t["n_items"],
                            t["min_len"], tok) for _ in range(t["pool"])]
    users = [(k, row) for k in range(len(outputs)) for row in range(t["batch"])]

    def length(u):
        k, row = u
        ids, seq_len, _ = pool[outputs[k][0]]
        served = served_sums(outputs[k][1][row].numpy(), outputs[k][2][row].numpy(),
                             int(seq_len[row]), tok["eos"])
        return int(seq_len[row]) + max(n for n, _ in served)

    pick = [max(users, key=length)]
    rest = [u for u in users if u != pick[0]]
    n_more = min(spec["check"]["users"] - 1, len(rest))
    pick += [rest[i] for i in np.random.default_rng([r.seed % 2**63, 1]).choice(
        len(rest), n_more, replace=False)]

    dev = r.device
    served_as = prog["eval_param_dtype"]
    params = ref.Drawn(r.sizes, r.seed, dev, served_as)
    item_ids = sorted({int(i) for k, row in pick for i in pool[outputs[k][0]][2][row]})
    images = torch.from_numpy(catalogue[item_ids]).to(dev)
    lat = ref.encode(params, r.sizes, images)
    index = {item: j for j, item in enumerate(item_ids)}

    seqs, n_prompt, n_scored, user_lat, prog_sums = [], [], [], [], []
    for k, row in pick:
        ids, seq_len, image_ids = pool[outputs[k][0]]
        n0 = int(seq_len[row])
        tokens, scores = outputs[k][1][row].numpy(), outputs[k][2][row].numpy()
        for beam, (n, s) in zip(tokens, served_sums(tokens, scores, n0, tok["eos"])):
            scored = list(beam[:n]) + ([tok["eos"]] if n < beam.shape[0] else [])
            seqs.append(list(ids[row, :n0]) + scored)
            n_prompt.append(n0)
            n_scored.append(len(scored))
            user_lat.append(lat[[index[int(i)] for i in image_ids[row]]])
            prog_sums.append(s)
    width = max(len(s) for s in seqs)
    seqs = np.array([s + [tok["pad"]] * (width - len(s)) for s in seqs], dtype=np.int64)
    latents = torch.stack(user_lat)
    ref_sums, deficits = zip(*rescore(r.sizes, params, seqs, n_prompt, n_scored, latents,
                                      prog["kv_int8"], tok["media"], t["beams"]))
    control = r.overrides.get("reference_in_place")
    if control:  # the reference at a lower precision, put in the program's place
        lower = ref.Drawn(r.sizes, r.seed, dev, control)
        lat_lower = ref.encode(lower, r.sizes, images)
        latents = torch.stack([lat_lower[[index[int(i)] for i in pool[outputs[k][0]][2][row]]]
                               for k, row in pick for _ in range(t["beams"])])
        prog_sums = [s for s, _ in rescore(r.sizes, lower, seqs, n_prompt, n_scored, latents,
                                           prog["kv_int8"], tok["media"], t["beams"])]
    gaps = [abs(a - b) for a, b in zip(prog_sums, ref_sums)]
    user_gaps = np.mean(np.reshape(gaps, (len(pick), -1)), axis=1)
    scores = np.stack([outputs[k][2][row].numpy() for k, row in pick])
    numbers = {"mean_score_gap_nats": float(np.mean(gaps)),
               "worst_user_gap_nats": float(user_gaps.max()),
               "selection_deficit_nats": float(np.mean(deficits)),
               "rank_inversions": int((scores[:, 1:] > scores[:, :-1]).sum())}
    out = judge(numbers, spec["check"]["limits"])
    out["checked"] = {"users": len(pick), "beams": len(seqs), "tokens": int(sum(n_scored)),
                      "widest_gap_nats": max(gaps), "median_gap_nats": float(np.median(gaps)),
                      "widest_deficit_nats": max(deficits),
                      **{k: v for k, v in numbers.items() if k not in out["numbers"]}}
    return out


# ------------------------------------------------------------ training

def leaf_gap(prog: dict, want: dict, skip=()) -> float:
    """The worst leaf's |norm(program) - norm(reference)| over the larger of
    the reference leaf's norm and the median leaf's."""
    median = float(np.median([v for v in want.values()]))
    return max(abs(prog[n] - want[n]) / max(want[n], median) for n in want if n not in skip)


def train(r, readings: dict, reference: dict) -> dict:
    """``readings`` / ``reference``: {"losses": [...], "grad": {leaf:
    norm}, "change": {leaf: norm}}. Leaves whose reference gradient is
    under a thousandth of the median leaf's move under Adam by rounding
    alone: they are left out of the change."""
    grads = reference["grad"]
    median = float(np.median(list(grads.values())))
    still = {n for n, g in grads.items() if g < 1e-3 * median}
    losses = max(abs(a - b) / abs(b) for a, b in zip(readings["losses"], reference["losses"]))
    numbers = {"loss_gap": losses,
               "grad_leaf_gap": leaf_gap(readings["grad"], grads),
               "change_leaf_gap": leaf_gap(readings["change"], reference["change"], still)}
    out = judge(numbers, r.spec["check"]["limits"])
    rel = [abs(a - b) / abs(b) for a, b in zip(readings["losses"], reference["losses"])]
    g_leaf = {n: abs(readings["grad"][n] - grads[n]) / max(grads[n], median) for n in grads}
    c_med = float(np.median(list(reference["change"].values())))
    c_leaf = {n: abs(readings["change"][n] - reference["change"][n])
              / max(reference["change"][n], c_med) for n in grads if n not in still}
    out["checked"] = {"losses": len(reference["losses"]), "leaves": len(grads),
                      "still_leaves": len(still), "loss_gaps": rel,
                      "grad_median_leaf_gap": float(np.median(list(g_leaf.values()))),
                      "grad_worst_leaf": max(g_leaf, key=g_leaf.get),
                      "change_median_leaf_gap": float(np.median(list(c_leaf.values()))),
                      "change_worst_leaf": max(c_leaf, key=c_leaf.get)}
    return out
