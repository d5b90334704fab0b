"""Loss functions for relation training (a copy of
``openpsg_tpu/train/losses.py``).

* :func:`multilabel_categorical_crossentropy`: the circular-softmax
  multi-label loss (v4 multiclass existence filter);
* :func:`reweighted_mcce`: the reference's self-normalized reweighting
  ``loss * (loss / loss.max())**alpha``;
* :func:`binary_existence_loss`: BCE-with-logits for the pair-existence
  filter;
* :func:`llm_teacher_forcing_loss`: shift-by-one CE with masked labels;
* :func:`recall_at_k`: the in-training recall metric.

All shapes are static: invalid entries are excluded by weight masks.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -9999.0  # the reference's masking constant


def multilabel_categorical_crossentropy(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """[..., C] {0,1} targets, [..., C] logits → [...] loss."""
    y_pred = (1.0 - 2.0 * y_true) * y_pred
    pred_neg = y_pred - y_true * -NEG_INF          # positives pushed to -inf
    pred_pos = y_pred - (1.0 - y_true) * -NEG_INF  # negatives pushed to -inf
    zeros = torch.zeros_like(y_pred[..., :1])
    neg = torch.logsumexp(torch.cat([pred_neg, zeros], -1), dim=-1)
    pos = torch.logsumexp(torch.cat([pred_pos, zeros], -1), dim=-1)
    return neg + pos


def reweighted_mcce(y_true: torch.Tensor, y_pred: torch.Tensor, alpha: float = 1.0,
                    sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MCCE with the reweighting ``loss * (loss / loss.max())**alpha``, then
    the mean (over the weights' sum with ``sample_weight``)."""
    loss = multilabel_categorical_crossentropy(y_true, y_pred)
    if sample_weight is not None:
        loss = loss * sample_weight
    w = (loss / (loss.max() + 1e-12)) ** alpha
    loss = loss * w
    if sample_weight is not None:
        return loss.sum() / sample_weight.sum().clamp(min=1.0)
    return loss.mean()


def binary_existence_loss(logits: torch.Tensor, labels: torch.Tensor,
                          weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean BCE-with-logits over (optionally weighted) pairs."""
    per = logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    if weight is None:
        return per.mean()
    return (per * weight).sum() / weight.sum().clamp(min=1.0)


def llm_teacher_forcing_loss(logits: torch.Tensor, label_ids: torch.Tensor,
                             label_mask: torch.Tensor) -> torch.Tensor:
    """logits [B, L, V] over the label region, label_ids [B, L], label_mask
    [B, L] bool (False is the reference's -100).  Shift-by-one CE:
    logits[t] predicts label[t+1]; masked mean."""
    shift_logits = logits[:, :-1]
    shift_labels = label_ids[:, 1:].long()
    shift_mask = label_mask[:, 1:].float()
    logp = torch.log_softmax(shift_logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, shift_labels[..., None])[..., 0]
    return (nll * shift_mask).sum() / shift_mask.sum().clamp(min=1.0)


def recall_at_k(pred: torch.Tensor, target: torch.Tensor, k: int = 20) -> torch.Tensor:
    """pred [B, R, N, N] scores, target [B, R, N, N] {0,1} → in-training
    recall@k over flattened (rel, sub, obj) triplets: the share of the top-k
    target triplets found in the top-k predictions, in percent.  Ties pick
    the lower index, as ``jax.lax.top_k`` does."""
    B = pred.shape[0]
    flat_p, flat_t = pred.reshape(B, -1), target.reshape(B, -1)
    p_idx = torch.sort(flat_p, dim=-1, descending=True, stable=True).indices[:, :k]
    t_val, t_idx = torch.sort(flat_t, dim=-1, descending=True, stable=True)
    t_val, t_idx = t_val[:, :k], t_idx[:, :k]
    t_valid = t_val > 0
    hit = (p_idx[:, :, None] == t_idx[:, None, :]) & t_valid[:, None, :]
    n_hit = hit.any(dim=1).sum(-1)
    n_true = t_valid.sum(-1)
    return (n_hit / (n_true + 1e-8)).mean() * 100.0
