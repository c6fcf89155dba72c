"""Task-weighted masked (focal) cross-entropy.

Counterpart of ``unimp_tpu/train/loss.py`` (the reference's training loss,
mmrec.py:177-213):

  * logits upcast to float32; next-token shift: logits[:, :-1] vs
    labels[:, 1:]
  * per-token CE where the label is not IGNORE (answer-span masking)
  * per-sample task weight multiplies each token loss
  * optional focal reweighting (1 - p_true)^gamma, with gradients flowing
    through the focal term
  * normalization by the count of valid labels
"""

from __future__ import annotations

import torch

from unimp_tpu_torch.data.masking import IGNORE


def masked_focal_loss(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
                      gamma: float = 2.0, use_reweight: bool = False, n_total=None):
    """logits [B, T, V] (any float dtype), labels [B, T], weights [B] ->
    (scalar loss, aux {"ce", "n_answer_tokens", "accuracy"}); aux carries
    no gradient. ``n_total`` (a rank's share of a batch spread over
    ranks): the batch's count of valid labels, which then normalizes in
    place of this share's own count, so that the ranks' losses sum to the
    batch's."""
    shift_logits = logits[:, :-1].float()
    lab = labels[:, 1:]
    valid = lab != IGNORE
    lab_safe = torch.where(valid, lab, 0).long()
    logp = torch.log_softmax(shift_logits, dim=-1)
    ce = -logp.gather(-1, lab_safe[..., None])[..., 0]
    loss_tok = weights.float()[:, None] * ce
    if use_reweight:
        pt = torch.exp(-ce)  # softmax(logits)[label]; the gradient flows through
        loss_tok = loss_tok * (1.0 - pt) ** gamma
    loss_tok = torch.where(valid, loss_tok, 0.0)
    n_valid = valid.sum() if n_total is None else n_total
    denom = n_valid.clamp(min=1)
    loss = loss_tok.sum() / denom
    with torch.no_grad():
        hit = (shift_logits.argmax(-1) == lab_safe) & valid
        aux = {"ce": torch.where(valid, ce, 0.0).sum() / denom,
               "n_answer_tokens": n_valid,
               "accuracy": hit.sum() / denom}
    return loss, aux
