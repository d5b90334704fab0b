"""Panoptic segmenter training: Hungarian matching, then mask and class
losses (counterpart of ``openpsg_tpu/train/segmenter_trainer.py``).

The reference never trains its segmenters (every config freezes them and
loads a checkpoint); the JAX package adds the MaskFormer-family recipe so
that a model can be trained from scratch, and this module ports it:

* per image, the assignment cost of every (query, ground-truth object):
  class NLL, mask BCE and dice on the stride-4 grid, computed without
  autograd and without the [Q, M, P] tensor of per-pixel terms (the BCE
  cost is ``mean(softplus(x)) - x·tᵀ / P``, the dice cost comes from
  ``sigmoid(x)·tᵀ`` and the row sums);
* exact Hungarian assignment on the host (``scipy``'s
  ``linear_sum_assignment``, as mmdet's ``MaskHungarianAssigner``);
* the loss under autograd with the assignment as index arrays: a softmax
  CE with a void class for unmatched queries (``softmax_void``, for
  Mask2Former) or a sigmoid multi-label CE with unmatched queries toward
  all-zero labels (``sigmoid``, for the open-vocabulary OpenSeeD
  segmenter), and mask BCE plus dice over the matched queries.

A step runs the forward once, under autograd, and takes the costs from its
outputs without autograd; the JAX step runs it twice on the same
parameters.

The segmenter module is called directly, under autograd (the detectors'
``segment`` runs without it).  Its parameters train as float32 masters
(:class:`~openpsg_tpu_torch.train.trainer.MasterTrainer`), so a bf16
segmenter trains as the JAX package's float32 parameters cast at use.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from openpsg_tpu_torch.models.segmenter.openseed import normalize_image
from openpsg_tpu_torch.train.trainer import AdamW, MasterTrainer
from openpsg_tpu_torch.utils.profiling import span


class SegTrainBatch(NamedTuple):
    image: torch.Tensor         # [B, H, W, 3] RGB 0-255
    gt_masks: torch.Tensor      # [B, M, H4, W4] bool (stride-4 grid)
    gt_labels: torch.Tensor     # [B, M] int32
    gt_valid: torch.Tensor      # [B, M] bool

    @staticmethod
    def from_numpy(arrays: Dict[str, np.ndarray], device) -> "SegTrainBatch":
        return SegTrainBatch(**{k: torch.as_tensor(np.asarray(arrays[k]), device=device)
                                for k in SegTrainBatch._fields})


def dice_loss(pred_logits: torch.Tensor, target: torch.Tensor, eps: float = 1.0) -> torch.Tensor:
    """pred_logits / target [..., P] → [...] dice loss."""
    p = torch.sigmoid(pred_logits)
    num = 2.0 * (p * target).sum(-1)
    den = p.sum(-1) + target.sum(-1)
    return 1.0 - (num + eps) / (den + eps)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0) + log1p(exp(-|x|))``, the JAX package's stable form."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def _mask_bce(pred_logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean BCE-with-logits over the last axis."""
    return (_softplus(pred_logits) - pred_logits * target).mean(-1)


class SegmenterTrainer(MasterTrainer):
    """``cls_mode="softmax_void"`` for Mask2Former outputs (a void column);
    ``"sigmoid"`` for OpenSeeD / MaskDINO open-vocabulary logits (no void:
    unmatched queries train toward all-zero labels).

    ``segmenter``: the module, called on the normalized image unless
    ``apply_fn`` (e.g. closing over class embeddings) replaces it; it
    returns ``cls_logits`` [Q, K(+1)] and ``masks`` [Q, H4, W4].
    ``params``: the tensors to train, by name (default the segmenter's
    parameters; add e.g. the class embeddings that ``apply_fn`` uses).
    One step (:meth:`train_step`): the forward, the costs, the assignment
    on the host, the losses and their backward, one optimizer update."""

    def __init__(self, segmenter: torch.nn.Module, num_classes: int, cls_weight: float = 2.0,
                 mask_weight: float = 5.0, dice_weight: float = 5.0, void_coef: float = 0.1,
                 cls_mode: str = "softmax_void",
                 apply_fn: Optional[Callable[[torch.Tensor], Dict[str, torch.Tensor]]] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None):
        if cls_mode not in ("softmax_void", "sigmoid"):
            raise ValueError(cls_mode)
        self.segmenter, self.num_classes = segmenter, num_classes
        self.cls_weight, self.mask_weight, self.dice_weight = cls_weight, mask_weight, dice_weight
        self.void_coef, self.cls_mode, self.apply_fn = void_coef, cls_mode, apply_fn
        self.device = next(segmenter.parameters()).device
        self._init_masters(dict(segmenter.named_parameters()) if params is None else params)

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = normalize_image(image)
        return self.apply_fn(x) if self.apply_fn is not None else self.segmenter(x)

    # ------------------------------------------------------------- cost
    def _cost(self, out, gt_masks, gt_labels, gt_valid) -> torch.Tensor:
        """One image's [Q, M] assignment costs from the segmenter's
        outputs, 1e9 at invalid objects."""
        logits = out["cls_logits"].float()
        logp = (torch.log_softmax(logits, -1) if self.cls_mode == "softmax_void"
                else F.logsigmoid(logits))
        cost_cls = -logp[:, gt_labels.long()]                              # [Q, M]
        pm = out["masks"].reshape(out["masks"].shape[0], -1).float()      # [Q, P]
        gm = gt_masks.reshape(gt_masks.shape[0], -1).float()              # [M, P]
        P = pm.shape[1]
        cost_mask = _softplus(pm).mean(-1)[:, None] - (pm @ gm.T) / P
        sig = torch.sigmoid(pm)
        num = 2.0 * (sig @ gm.T)
        den = sig.sum(-1)[:, None] + gm.sum(-1)[None, :]
        cost_dice = 1.0 - (num + 1.0) / (den + 1.0)
        cost = (self.cls_weight * cost_cls + self.mask_weight * cost_mask
                + self.dice_weight * cost_dice)
        return torch.where(gt_valid[None, :], cost, torch.full_like(cost, 1e9))

    @torch.no_grad()
    def cost_matrices(self, batch: SegTrainBatch) -> torch.Tensor:
        """[B, Q, M] assignment costs, 1e9 at invalid objects."""
        return torch.stack([self._cost(self.forward(image), *gt)
                            for image, *gt in zip(*batch)])

    @staticmethod
    def assign(costs: np.ndarray, gt_valid: np.ndarray) -> np.ndarray:
        """Host: exact Hungarian per image → match [B, Q] int32, the
        ground-truth index each query owns, -1 for unmatched."""
        from scipy.optimize import linear_sum_assignment

        B, Q, _ = costs.shape
        match = np.full((B, Q), -1, np.int32)
        for b in range(B):
            n = int(gt_valid[b].sum())
            if n == 0:
                continue
            rows, cols = linear_sum_assignment(costs[b][:, :n])
            match[b, rows] = cols
        return match

    # ------------------------------------------------------------- loss
    def _losses(self, out, gt_masks, gt_labels, gt_valid, m) -> Dict[str, torch.Tensor]:
        """One image's losses from the segmenter's outputs, given its
        assignment ``m`` [Q]."""
        logits = out["cls_logits"].float()
        Q = logits.shape[0]
        matched = m >= 0
        labels = gt_labels.long()[m.clamp(min=0).long()]                      # [Q]
        if self.cls_mode == "softmax_void":
            tgt = torch.where(matched, labels, torch.full_like(labels, self.num_classes))
            nll = -torch.log_softmax(logits, -1).gather(1, tgt[:, None])[:, 0]
            w = torch.where(matched, 1.0, self.void_coef)
            loss_cls = (nll * w).sum() / w.sum()
        else:
            # matched → one-hot(gt), unmatched → 0; the positive entry is 1
            # of K and is weighted up by K/2 so that the matched class
            # crosses fusion's keep threshold
            K = logits.shape[-1]
            onehot = F.one_hot(labels, K).float() * matched[:, None]
            per = _softplus(logits) - logits * onehot
            elem_w = torch.where(onehot > 0, float(K) / 2.0, 1.0)
            w = torch.where(matched, 1.0, self.void_coef)[:, None]
            loss_cls = (per * elem_w * w).sum() / w.sum() / K * 20.0
        pm = out["masks"].reshape(Q, -1).float()
        gm = gt_masks.reshape(gt_masks.shape[0], -1)[m.clamp(min=0).long()].float()
        mw = matched.float()
        n = mw.sum().clamp(min=1.0)
        return {"loss_cls": self.cls_weight * loss_cls,
                "loss_mask": self.mask_weight * (_mask_bce(pm, gm) * mw).sum() / n,
                "loss_dice": self.dice_weight * (dice_loss(pm, gm) * mw).sum() / n}

    def gradients(self, batch: SegTrainBatch, match: torch.Tensor,
                  stage_times: Optional[Dict[str, float]] = None):
        """The loss means over the batch and their total's gradient given
        the assignment ``match`` [B, Q] → (loss dict plus ``loss``, {name:
        float32 gradient})."""
        return self._backprop([
            lambda i=i: self._losses(self.forward(batch.image[i]),
                                     *(t[i] for t in batch[1:]), match[i])
            for i in range(batch.image.shape[0])], "loss_backward", stage_times, self.device)

    def train_step(self, batch: SegTrainBatch, optimizer: AdamW, opt_state: Dict[str, Any],
                   stage_times: Optional[Dict[str, float]] = None) -> Dict[str, torch.Tensor]:
        """The forward under autograd, the costs from its outputs (without
        autograd), the assignment on the host, the losses from the same
        outputs, their backward and one optimizer step → the loss dict plus
        ``loss`` and ``grad_norm``.  ``stage_times``: wall ms of
        ``forward``, ``cost``, ``assign``, ``loss_backward`` and
        ``optimizer``, the card synchronized around each."""
        with span("forward", stage_times, self.device):
            outs = [self.forward(image) for image in batch.image]
        with span("cost", stage_times, self.device), torch.no_grad():
            costs = torch.stack([self._cost(out, *gt)
                                 for out, *gt in zip(outs, *batch[1:])]).cpu().numpy()
        with span("assign", stage_times, self.device):
            match = torch.from_numpy(self.assign(costs, batch.gt_valid.cpu().numpy()))
            match = match.to(self.device)

        def losses(i):
            with span("loss_backward", stage_times, self.device):
                return self._losses(outs[i], *(t[i] for t in batch[1:]), match[i])

        d, grads = self._backprop([lambda i=i: losses(i) for i in range(len(outs))],
                                  "loss_backward", stage_times, self.device)
        d["grad_norm"] = self._update(optimizer, grads, opt_state, stage_times, self.device)
        return d
