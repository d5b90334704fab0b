"""The training steps (counterpart of ``openpsg_tpu/train/trainer.py``):
:class:`V4Trainer` for PSG v4, :class:`M2FTrainer` for the closed-set
v1 / v2 / v3 family, both on :class:`MasterTrainer`'s float32 masters and
the JAX package's optimizer chain (:class:`AdamW`).

PSG v4's reference recipe (configs/psg/baseline_v4_ov.py): AdamW lr 1e-4, weight
decay 0.05, eps 1e-8, betas (0.9, 0.999), gradient clip 0.01, linear warmup
over 500 iterations from ratio 0.001, lr ×0.1 at epochs 6 and 10.  Frozen:
the segmenter, the text encoder, the class embeddings and the LLM; the
relation head trains, its gradient taken through the LLM's teacher-forcing
loss.

One step, per image: the frozen segmenter runs without autograd; the head
runs on the sampled pairs (``pair_select``); the LLM runs teacher forcing on
at most ``max_llm_forward_num`` positive pairs, each block under activation
checkpointing; each image's losses are backpropagated as they come, scaled
by 1/B, which sums to the gradient of the per-loss means over the batch
(the JAX step's vmap then mean).  Then one update of the optax chain the
JAX package builds (:class:`AdamW`).

Trainable parameters are optimized as float32 values.  Where a module runs
in bf16 (the head at full width), the optimizer holds float32 master copies
and writes them, rounded, into the module after each update; the gradient
is the bf16 cotangent widened to float32, as flax gives it for float32
parameters cast to bf16 at use.

GT-dependent sampling (32 Q-Former pairs at 3:1 negatives to positives, up
to 4 positive LLM pairs) runs on the host: :func:`sample_training_pairs`.

Parallel (a trainer built with ``mesh=``): each dp rank steps on its own
rows of the global batch; the gradients and losses are averaged over dp
(one all-reduce) BEFORE the global-norm clip and AdamW, so every rank
takes the same update.  A tp-sharded LLM (``parallel.sharding.shard_params``)
keeps its masters and AdamW moments per shard, and the global norm sums
the squares of split tensors over tp (and of pipeline-stage layers over
pp) while counting replicated ones once.
:meth:`V4Trainer.make_pipelined_train_step` runs the LLM's teacher forcing
as one GPipe call over a ("dp", "pp"[, "tp"]) mesh (JAX
``make_pipelined_train_step``, trainer.py:396-462).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from openpsg_tpu_torch.bridge import jax_paths, scan_prefixes
from openpsg_tpu_torch.models.detectors import mask2former_relation as m2f
from openpsg_tpu_torch.models.llm.llama import require_llama
from openpsg_tpu_torch.models.relation.head_v2 import RelationHeadV2
from openpsg_tpu_torch.models.relation.head_v4 import assemble_pair_instructions, right_align
from openpsg_tpu_torch.models.segmenter.openseed import normalize_image
from openpsg_tpu_torch.parallel.comm import all_reduce
from openpsg_tpu_torch.parallel.mesh import axis_group
from openpsg_tpu_torch.train import losses
from openpsg_tpu_torch.utils.profiling import span


class TrainBatch(NamedTuple):
    """Static-shape training examples, batched on axis 0."""

    image: torch.Tensor            # [B, H, W, 3] float32 RGB 0-255, padded
    object_masks: torch.Tensor     # [B, M, H4, W4] bool, stride 4
    object_labels: torch.Tensor    # [B, M] int32 class ids
    object_valid: torch.Tensor     # [B, M] bool
    relation_target: torch.Tensor  # [B, M, M, R] float32 {0, 1}
    qf_sel_idx: torch.Tensor       # [B, S] int32 pair indices (i * M + j)
    qf_sel_weight: torch.Tensor    # [B, S] float32 (0 = padding slot)
    llm_sel_idx: torch.Tensor      # [B, T] int32
    llm_valid: torch.Tensor        # [B, T] bool
    llm_label_ids: torch.Tensor    # [B, T, L] int32 (' {rel} </s>' sequences)
    llm_label_mask: torch.Tensor   # [B, T, L] bool

    @staticmethod
    def from_numpy(arrays: Dict[str, np.ndarray], device) -> "TrainBatch":
        return TrainBatch(**{k: torch.as_tensor(np.asarray(arrays[k]), device=device)
                             for k in TrainBatch._fields})


def make_lr_schedule(base_lr: float = 1e-4, warmup_iters: int = 500,
                     warmup_ratio: float = 1e-3, step_epochs: Tuple[int, ...] = (6, 10),
                     steps_per_epoch: int = 1000, gamma: float = 0.1) -> Callable[[int], float]:
    """mmcv's 'step' policy with linear warmup → ``schedule(count)``, in
    float32 arithmetic as the JAX schedule computes it."""
    f32 = np.float32

    def schedule(count: int) -> float:
        frac = f32(min(count, warmup_iters)) / f32(warmup_iters)
        warm = f32(base_lr) * (f32(warmup_ratio) + f32(1.0 - warmup_ratio) * frac)
        epoch = count // steps_per_epoch
        decay = f32(gamma) ** f32(sum(epoch >= e for e in step_epochs))
        return float((warm if count < warmup_iters else f32(base_lr)) * decay)

    return schedule


def make_cosine_schedule(init_value: float, decay_steps: int, alpha: float = 0.0
                         ) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule`` in float32: ``init_value`` times
    ``(1 - alpha) * 0.5 * (1 + cos(pi * min(count, decay_steps) /
    decay_steps)) + alpha``."""
    f32 = np.float32

    def schedule(count: int) -> float:
        frac = f32(min(count, decay_steps)) / f32(decay_steps)
        cosine = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * frac, dtype=f32))
        return float(f32(init_value) * (f32(1.0 - alpha) * cosine + f32(alpha)))

    return schedule


_NORM_PART = re.compile(r"(?:.*_)?ln\d*")

# the groups a v4 config can train: the JAX package always freezes the
# segmenter, the text encoder and the class embeddings
TRAINABLE_GROUPS = ("head", "llm")

# Adam's constants in the JAX package's chain (the config's betas and eps
# are these values)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def paramwise_multipliers(paths: Dict[str, str], custom_keys: Optional[Dict[str, Dict]],
                          norm_decay_mult: Optional[float] = None):
    """mmcv ``paramwise_cfg`` over the trainable parameters → ({name:
    lr_mult}, {name: decay_mult}).  ``paths`` maps each parameter to its
    JAX leaf path (:meth:`V4Trainer.jax_paths`), which is what the keys are
    matched against, so each parameter gets its JAX leaf's multipliers.

    ``custom_keys``: {substring: {lr_mult, decay_mult}}; the longest
    matching key wins.  ``norm_decay_mult`` applies to leaves under a norm
    (a path component containing 'norm', or 'ln' with an optional prefix
    ending in '_' and an optional layer index) when no key set a
    decay_mult."""
    lr_mult, decay_mult = {}, {}
    for name, path in paths.items():
        parts = path.split("/")
        lr, dec, best = 1.0, None, -1
        for key, d in (custom_keys or {}).items():
            if key in path and len(key) > best:
                best = len(key)
                lr = float(d.get("lr_mult", 1.0))
                dec = d.get("decay_mult", None)
                dec = None if dec is None else float(dec)
        if dec is None:
            is_norm = any("norm" in p.lower() or _NORM_PART.fullmatch(p.lower()) is not None
                          for p in parts[:-1])
            dec = float(norm_decay_mult) if norm_decay_mult is not None and is_norm else 1.0
        lr_mult[name], decay_mult[name] = lr, dec
    return lr_mult, decay_mult


class AdamW:
    """The JAX package's optimizer, optax's chain written out over a dict of
    float32 parameters (train/trainer.py:173-201), in its order:

    1. clip by global norm: ``(g / norm) * max_norm`` unless norm < max_norm;
    2. Adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) with bias correction;
    3. weight decay ``+ weight_decay * decay_mult * p`` (a fractional
       ``decay_mult`` scales the decay);
    4. ``* -schedule(count)``, count 0 at the first update;
    5. ``* lr_mult``.

    ``lr_mult`` / ``decay_mult``: {name: multiplier} from
    :func:`paramwise_multipliers`, or None."""

    def __init__(self, schedule: Callable[[int], float], max_norm: float = 0.01,
                 weight_decay: float = 0.05, lr_mult: Optional[Dict[str, float]] = None,
                 decay_mult: Optional[Dict[str, float]] = None):
        self.schedule, self.max_norm, self.weight_decay = schedule, max_norm, weight_decay
        self.lr_mult, self.decay_mult = lr_mult, decay_mult

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             state: Dict[str, Any], norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Update ``params`` and ``state`` in place → the global norm of
        ``grads`` (before clipping); ``norm``, where given, is that norm
        (a sharded trainer sums it over its ranks)."""
        if norm is None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        clip = not bool(norm < self.max_norm)
        count = int(state["count"])
        t = count + 1
        # the step's scalars as float32 tensors on each parameter's device,
        # copied there once per step: CUDA divides by a host scalar through
        # its reciprocal, which optax does not
        host = torch.tensor([1.0 - ADAM_B1 ** t, 1.0 - ADAM_B2 ** t, -self.schedule(count)],
                            dtype=torch.float32)
        scalars = {}
        for name, p in params.items():
            if p.device not in scalars:
                scalars[p.device] = host.to(p.device).unbind()
            bc1, bc2, step_size = scalars[p.device]
            g = grads[name]
            if clip:
                g = (g / norm) * self.max_norm
            mu, nu = state["mu"][name], state["nu"][name]
            mu.copy_((1 - ADAM_B1) * g + ADAM_B1 * mu)
            nu.copy_((1 - ADAM_B2) * (g * g) + ADAM_B2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
            wd = self.weight_decay * (1.0 if self.decay_mult is None else self.decay_mult[name])
            u = u + wd * p
            u = step_size * u
            if self.lr_mult is not None:
                u = u * self.lr_mult[name]
            p.add_(u)
        state["count"] = t
        return norm


def make_optimizer(schedule, max_norm: float = 0.01, weight_decay: float = 0.05,
                   lr_mult=None, decay_mult=None) -> AdamW:
    """AdamW with the global-norm clip (baseline_v4_ov.py:150-156)."""
    return AdamW(schedule, max_norm=max_norm, weight_decay=weight_decay,
                 lr_mult=lr_mult, decay_mult=decay_mult)


class MasterTrainer:
    """Float32 master values of a set of trainable tensors.

    Each tensor is optimized as a float32 value: a float32 tensor is its
    own master; a bf16 one gets a float32 copy, and the optimizer's result
    is written into it rounded (:meth:`_sync_modules`).  Its gradient is
    the cotangent widened to float32, as flax gives it for float32
    parameters cast to bf16 at use."""

    def _init_masters(self, params: Dict[str, torch.Tensor]) -> None:
        self.params: Dict[str, torch.Tensor] = {}   # name → module tensor
        self.master: Dict[str, torch.Tensor] = {}   # name → float32 value
        for n, p in params.items():
            p.requires_grad_(True)
            self.params[n] = p
            self.master[n] = p if p.dtype == torch.float32 else p.detach().float()

    @torch.no_grad()
    def load_master(self, values: Dict[str, torch.Tensor]) -> None:
        """Set the trainable values (float32, e.g. from a checkpoint) and
        write them into the modules."""
        if set(values) != set(self.master):
            raise KeyError(f"checkpoint holds {len(values)} tensors, the trainable "
                           f"groups {len(self.master)}; differing names: "
                           f"{sorted(set(values) ^ set(self.master))[:5]}")
        for n, v in values.items():
            self.master[n].copy_(v)
        self._sync_modules()

    @torch.no_grad()
    def _sync_modules(self) -> None:
        for n, p in self.params.items():
            if self.master[n] is not p:
                p.copy_(self.master[n])

    def _zero_grads(self) -> None:
        for prm in self.params.values():
            prm.grad = None

    def _fold_grads(self, acc: Dict[str, torch.Tensor]) -> None:
        """Move the gradients of tensors narrower than float32 into float32
        sums ``acc`` and clear them, so that per-image gradients add in
        float32 (as the dp all-reduce adds the ranks'), not in the
        tensor's own dtype."""
        for n, prm in self.params.items():
            if prm.grad is not None and prm.dtype != torch.float32:
                g = prm.grad.float()
                acc[n] = acc[n].add_(g) if n in acc else g
                prm.grad = None

    def _take_grads(self, acc: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
        """The accumulated gradients (``acc``'s float32 sums, else each
        tensor's ``grad``), widened to float32 (zeros where none reached a
        tensor), and the tensors' ``grad`` cleared."""
        acc = acc or {}
        grads = {}
        for n, prm in self.params.items():
            g = acc.get(n, prm.grad)
            grads[n] = torch.zeros_like(self.master[n]) if g is None else g.float()
            prm.grad = None
        return grads

    def _backprop(self, per_image, stage: str, stage_times, device,
                  is_loss: Callable[[str], bool] = lambda key: True):
        """Per-image loss thunks (each → a dict of scalars) → each image's
        total over the ``is_loss`` keys backpropagated as it comes, scaled
        by 1/B, which sums to the gradient of the per-loss means over the
        batch (the JAX step's vmap then mean; the images' gradients add in
        float32) → (the means plus ``loss``, their total; {name: float32
        gradient}).  The backward's wall time is added to ``stage``."""
        self._zero_grads()
        B = len(per_image)
        sums: Dict[str, torch.Tensor] = {}
        acc: Dict[str, torch.Tensor] = {}
        for losses in per_image:
            out = losses()
            with span(stage, stage_times, device):
                (sum(v for k, v in out.items() if is_loss(k)) / B).backward()
                if B > 1:
                    self._fold_grads(acc)
            for k, v in out.items():
                sums[k] = sums.get(k, 0.0) + v.detach().float() / B
        sums["loss"] = sum(v for k, v in sums.items() if is_loss(k))
        return sums, self._take_grads(acc)

    def _update(self, optimizer: AdamW, grads, opt_state, stage_times, device) -> torch.Tensor:
        """One optimizer step on the masters, written into the modules →
        the gradients' global norm."""
        with span("optimizer", stage_times, device):
            norm = optimizer.step(self.master, grads, opt_state, norm=self._global_norm(grads))
            self._sync_modules()
        return norm

    # ------------------------------------------------------------ parallel
    mesh = None

    def _split_of(self, name: str) -> Tuple[bool, bool]:
        """(split over tp, a pipeline stage's layer) for a trainable name."""
        return False, False

    def whole(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole tensors from this rank's parts of {trainable name: tensor}
        (masters or AdamW moments), for a checkpoint.  Every rank calls it."""
        return tensors

    def localize(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's parts of whole {trainable name: tensor} (a restored
        checkpoint)."""
        return tensors

    def _reduce_dp(self, loss_dict, grads):
        """Mean of the losses and the gradients over the mesh's dp ranks
        (one flat all-reduce each); unchanged without a mesh."""
        g = axis_group(self.mesh, "dp")
        if g is None:
            return loss_dict, grads
        group, _, n = g
        names = list(grads)
        flat = all_reduce(torch.cat([grads[k].reshape(-1) for k in names]), "sum", group) / n
        out, i = {}, 0
        for k in names:
            out[k] = flat[i:i + grads[k].numel()].view_as(grads[k])
            i += grads[k].numel()
        keys = list(loss_dict)
        vals = all_reduce(torch.stack([torch.as_tensor(loss_dict[k], dtype=torch.float32,
                                                       device=flat.device) for k in keys]),
                          "sum", group) / n
        return dict(zip(keys, vals.unbind())), out

    def _global_norm(self, grads) -> Optional[torch.Tensor]:
        """The norm over the whole model's gradients: squares of tp-split
        tensors summed over tp, of stage layers over pp, replicated tensors
        counted once.  None (the optimizer's own) without a mesh."""
        if self.mesh is None:
            return None
        dev = next(iter(grads.values())).device
        parts = [torch.zeros((), device=dev) for _ in range(4)]
        for name, g in grads.items():
            tp_split, layer = self._split_of(name)
            parts[2 * layer + tp_split] = parts[2 * layer + tp_split] + (g * g).sum()
        rep, tp_only, layer_rep, layer_tp = parts
        tpg, ppg = axis_group(self.mesh, "tp"), axis_group(self.mesh, "pp")
        if tpg is not None:
            tp_only, layer_tp = all_reduce(torch.stack([tp_only, layer_tp]), "sum", tpg[0])
        layer_sum = layer_rep + layer_tp
        if ppg is not None:
            layer_sum = all_reduce(layer_sum, "sum", ppg[0])
        return torch.sqrt(rep + tp_only + layer_sum)


class _GroupTrainer(MasterTrainer):
    """The training step of a detector: its trainable parameter groups
    (``pipeline.param_groups()``), per-image losses (:meth:`loss_single`)
    backpropagated as they come, then one optimizer update."""

    GROUPS: Tuple[str, ...] = ()
    BACKWARD_STAGE = "head"     # the stage the backward's time is added to

    def __init__(self, pipeline, trainable: Sequence[str], mesh=None):
        unknown = set(trainable) - set(self.GROUPS)
        if unknown:
            raise ValueError(f"cannot train {sorted(unknown)}: trainable groups are "
                             f"{self.GROUPS}")
        self.pipeline = pipeline
        self.trainable = tuple(trainable)
        self.mesh = mesh
        groups = pipeline.param_groups()
        self._init_masters({f"{g}.{n}": p for g in self.trainable for n, p in groups[g].items()})

    def jax_paths(self) -> Dict[str, str]:
        """{trainable parameter: its JAX leaf path} (for ``paramwise_cfg``);
        a group that is one tensor is its own path."""
        out = {}
        for g in self.trainable:
            module = getattr(self.pipeline, g)
            if not isinstance(module, torch.nn.Module):
                out[f"{g}.{g}"] = g
                continue
            out.update({f"{g}.{n}": path for n, path in
                        jax_paths(module, g, scan_prefixes(module, g)).items()})
        return out

    @staticmethod
    def is_loss(key: str) -> bool:
        """Whether a key of :meth:`loss_single`'s dict enters the total."""
        return True

    def gradients(self, batch, stage_times: Optional[Dict[str, float]] = None):
        """Loss means over the batch and their total's gradient → (loss dict
        of float32 scalars plus ``loss``, the total; {name: float32
        gradient})."""
        return self._backprop(
            [lambda i=i: self.loss_single(type(batch)(*(t[i] for t in batch)), stage_times)
             for i in range(batch.image.shape[0])],
            self.BACKWARD_STAGE, stage_times, self.pipeline.device, self.is_loss)

    def train_step(self, batch, optimizer: AdamW, opt_state: Dict[str, Any],
                   stage_times: Optional[Dict[str, float]] = None) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` → the loss dict plus ``loss``
        (the total) and ``grad_norm``.  ``stage_times``: wall ms per stage
        (:meth:`loss_single`'s, and ``optimizer``), the card synchronized
        around each."""
        loss_dict, grads = self._reduce_dp(*self.gradients(batch, stage_times))
        loss_dict["grad_norm"] = self._update(optimizer, grads, opt_state, stage_times,
                                              self.pipeline.device)
        return loss_dict


class V4Trainer(_GroupTrainer):
    """The training step of a :class:`~openpsg_tpu_torch.models.detectors.psg_v4.PSGv4`.

    ``trainable``: the groups to optimize, of :data:`TRAINABLE_GROUPS`;
    the reference freezes the segmenter and the LLM, so ``("head",)``; add
    ``"llm"`` to fine-tune the language model too (the scratch recipe).
    The frozen segmenter runs without autograd.  :attr:`master` holds the
    float32 values the optimizer updates.  Stages: ``segmenter``,
    ``head``, ``llm_fwd_bwd`` (the LLM forward and the whole backward) and
    ``optimizer``."""

    GROUPS = TRAINABLE_GROUPS
    BACKWARD_STAGE = "llm_fwd_bwd"

    def __init__(self, pipeline, trainable: Sequence[str] = ("head",),
                 rel_cls_loss_weight: float = 50.0, mesh=None):
        """``mesh``: average over its dp ranks (each passes its own rows
        to :meth:`train_step`); build the trainer after sharding the LLM.
        Only a Llama LLM: another family is refused by name."""
        require_llama(pipeline.cfg.llm, "V4Trainer")
        super().__init__(pipeline, trainable, mesh)
        self.rel_cls_loss_weight = rel_cls_loss_weight

    def _split_of(self, name: str) -> Tuple[bool, bool]:
        llm = self.pipeline.llm
        if not name.startswith("llm."):
            return False, False
        inner = name[4:]
        return (inner in getattr(llm, "_tp_specs", {}),
                llm.core.stage_range is not None and inner.startswith("core.layers."))

    def _llm_split(self) -> bool:
        llm = self.pipeline.llm
        return "llm" in self.trainable and bool(
            getattr(llm, "_tp_specs", None) or llm.core.stage_range is not None)

    def whole(self, tensors):
        if not self._llm_split():
            return tensors
        from openpsg_tpu_torch.parallel.sharding import full_tensors

        return full_tensors(self.pipeline.llm, tensors, prefix="llm.")

    def localize(self, tensors):
        if not self._llm_split():
            return tensors
        from openpsg_tpu_torch.parallel.sharding import local_part

        llm = self.pipeline.llm
        return {k: local_part(llm, k[4:], v) if k.startswith("llm.") else v
                for k, v in tensors.items() if k in self.master}

    # ------------------------------------------------------------ one image
    def loss_single(self, b: TrainBatch, stage_times: Optional[Dict[str, float]] = None
                    ) -> Dict[str, torch.Tensor]:
        """Losses of ONE image (``b``'s fields without the batch axis).
        ``stage_times`` (a dict) receives wall ms of ``segmenter``,
        ``head`` and the LLM forward (``llm_fwd_bwd``), synchronizing the
        card around each."""
        out, emb, mask, pos, lab_ids, lab_mask = self.pre_llm(b, stage_times)
        with span("llm_fwd_bwd", stage_times, self.pipeline.device):
            logits, _ = self.pipeline.llm(input_embeds=emb, attention_mask=mask,
                                          positions=pos, remat=True)
            out["rel_llm_loss"] = self.rel_llm_loss(logits, lab_ids, lab_mask, b.llm_valid)
        return out

    @classmethod
    def rel_llm_loss(cls, logits, lab_ids, lab_mask, llm_valid):
        """Mean of the per-pair CE over the image's valid LLM pairs."""
        per_pair = cls.llm_pair_ce(logits, lab_ids, lab_mask)
        lv = llm_valid.float()
        return (per_pair * lv).sum(-1) / lv.sum(-1).clamp(min=1.0)

    def pre_llm(self, b: TrainBatch, stage_times: Optional[Dict[str, float]] = None):
        """One image up to the LLM: segmenter, head, the relation-cls losses
        and the teacher-forcing inputs → (losses, embeds [T, Lf, D], mask
        [T, Lf], positions [T, Lf], label ids, label mask)."""
        p = self.pipeline
        c = p.cfg
        M, R = c.head.max_objects_padded, c.head.num_relation_classes
        dev = p.device

        with span("segmenter", stage_times, dev), torch.no_grad():
            mask_features = p.segmenter(normalize_image(b.image), p.class_embeds)["mask_features"]

        with span("head", stage_times, dev):
            labels = b.object_labels.long()
            pair_idx = torch.arange(M * M, device=dev)
            sub_lab, obj_lab = labels[pair_idx // M], labels[pair_idx % M]
            text_ids, text_mask = assemble_pair_instructions(p.qf_parts, sub_lab, obj_lab)
            head_out = p.head(mask_features, b.object_masks, b.object_valid, text_ids,
                              text_mask, pair_select=b.qf_sel_idx)

            out: Dict[str, torch.Tensor] = {}
            sel = b.qf_sel_idx.long()
            sel_target = b.relation_target.reshape(M * M, R)[sel]        # [S, R]
            w = b.qf_sel_weight
            if "binary_logits" in head_out:
                binary_label = (sel_target.sum(-1) > 0).float()
                out["binary_rel_cls_loss"] = losses.binary_existence_loss(
                    head_out["binary_logits"], binary_label, w) * self.rel_cls_loss_weight
            if "multiclass_logits" in head_out:
                out["multiclass_rel_cls_loss"] = losses.reweighted_mcce(
                    sel_target, head_out["multiclass_logits"],
                    sample_weight=w) * self.rel_cls_loss_weight

            # LLM teacher forcing on the selected pairs.  A pair's features
            # come from the Q-Former sample: zero when the LLM pair was not
            # sampled (the reference's buffer), averaged over duplicates
            # (sampling with replacement), padding slots never matched.
            vis_tokens = head_out["llm_visual_tokens"]                    # [S, Rq, D]
            llm_sel = b.llm_sel_idx.long()
            match = ((llm_sel[:, None] == sel[None, :])
                     & (w[None, :] > 0)).to(vis_tokens.dtype)             # [T, S]
            match = match / match.sum(-1, keepdim=True).clamp(min=1.0)
            vis = torch.einsum("ts,srd->trd", match, vis_tokens)          # [T, Rq, D]
            p_ids, p_mask = assemble_pair_instructions(p.llm_parts, sub_lab[llm_sel],
                                                       obj_lab[llm_sel])
            p_ids, p_mask = right_align(p_ids, p_mask)
            lab_ids, lab_mask = b.llm_label_ids.long(), b.llm_label_mask
            with torch.set_grad_enabled(torch.is_grad_enabled() and "llm" in self.trainable):
                emb = p.llm.embed(torch.cat([p_ids, lab_ids], dim=1))
            T, Rq = vis.shape[:2]
            full_embeds = torch.cat([vis.to(emb.dtype), emb], dim=1)
            full_mask = torch.cat([torch.ones(T, Rq, dtype=torch.bool, device=dev),
                                   p_mask, lab_mask], dim=1)
            positions = (torch.cumsum(full_mask.to(torch.int32), dim=1) - 1).clamp(min=0)
        return out, full_embeds, full_mask, positions, lab_ids, lab_mask

    def make_pipelined_train_step(self, optimizer: AdamW, mesh, n_micro: Optional[int] = None):
        """The train step whose LLM teacher forcing runs as ONE GPipe call
        (``parallel.pipeline.pipelined_llama_logits``) over a ("dp", "pp"[,
        "tp"]) mesh, the LLM cut by ``shard_pipeline`` before the trainer
        was built.  The per-image pre-LLM part runs as in :meth:`train_step`;
        the B·T sequences of this rank's images go through the pipeline
        together, then one backward (pipelined backprop) and the dp-mean
        update.  Numerically equal to :meth:`train_step`.  ``n_micro``
        defaults to pp where it divides the rank's B·T, else 1.

        → ``step(batch, opt_state, stage_times=None)`` → the metrics of
        :meth:`train_step`."""
        from openpsg_tpu_torch.parallel.pipeline import pipelined_llama_logits

        self.mesh = mesh
        pp = axis_group(mesh, "pp")[2]

        def step(batch, opt_state, stage_times=None):
            p = self.pipeline
            self._zero_grads()
            B = batch.image.shape[0]
            pres = [self.pre_llm(type(batch)(*(t[i] for t in batch)), stage_times)
                    for i in range(B)]
            outs, emb, mask, pos, lab_ids, lab_mask = zip(*pres)
            T, Lf = mask[0].shape
            nm = n_micro or (pp if (B * T) % pp == 0 else 1)
            with span("llm_fwd_bwd", stage_times, p.device):
                logits = pipelined_llama_logits(p.llm, torch.cat(emb), torch.cat(mask),
                                                torch.cat(pos), mesh, nm, remat=True)
                rel_llm = self.rel_llm_loss(logits.reshape(B, T, Lf, -1), torch.stack(lab_ids),
                                            torch.stack(lab_mask), batch.llm_valid)
                loss_dict = {k: sum(o[k] for o in outs) / B for k in outs[0]}
                loss_dict["rel_llm_loss"] = rel_llm.mean()
                total = sum(loss_dict.values())
                total.backward()
            loss_dict = {k: v.detach().float() for k, v in loss_dict.items()}
            loss_dict["loss"] = total.detach().float()
            loss_dict, grads = self._reduce_dp(loss_dict, self._take_grads())
            loss_dict["grad_norm"] = self._update(optimizer, grads, opt_state, stage_times,
                                                  p.device)
            return loss_dict

        return step

    @staticmethod
    def llm_pair_ce(logits, lab_ids, lab_mask):
        """Per-pair mean CE over the label region of teacher-forced logits
        [T, Rq+Lp+L, V].  The boundary-inclusive shift: logits at positions
        -(L+1) .. -2 predict label tokens 0 .. L-1, so the first label token
        (the prompt → label boundary) is trained too."""
        L = lab_ids.shape[-1]
        shift_logits = logits[..., -(L + 1):-1, :]
        mask = lab_mask.float()
        logp = torch.log_softmax(shift_logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, lab_ids.long()[..., None])[..., 0]
        return (nll * mask).sum(-1) / mask.sum(-1).clamp(min=1.0)

# ------------------------------------------------------ the closed-set family
class M2FTrainBatch(NamedTuple):
    """Static-shape training examples of the closed-set family, batched on
    axis 0."""

    image: torch.Tensor            # [B, H, W, 3] float32 RGB 0-255, padded
    object_masks: torch.Tensor     # [B, M, H4, W4] bool, stride 4
    object_labels: torch.Tensor    # [B, M] int32 class ids
    object_valid: torch.Tensor     # [B, M] bool
    relation_target: torch.Tensor  # [B, M, M, R] float32 {0, 1}

    @staticmethod
    def from_numpy(arrays: Dict[str, np.ndarray], device) -> "M2FTrainBatch":
        return M2FTrainBatch(**{k: torch.as_tensor(np.asarray(arrays[k]), device=device)
                                for k in M2FTrainBatch._fields})


class M2FTrainer(_GroupTrainer):
    """The training step of the closed-set v1 / v2 / v3 family
    (:class:`~openpsg_tpu_torch.models.detectors.mask2former_relation.PSGMask2FormerRelation`;
    JAX ``train/trainer.py`` ``M2FTrainer``).

    The reference recipe: the segmenter frozen (it runs without autograd),
    the relation head and the object class embeddings trained
    (:data:`~openpsg_tpu_torch.models.detectors.mask2former_relation.TRAINABLE_GROUPS`);
    ground-truth masks pool the object tokens (``object_token_size``
    chunks per object), and the dense [R, N, N] scores train against the
    v1 loss family: head v1's own ``loss``, one multilabel CCE per v2
    expert and for the gate, the same CCE for v3.  The total is the sum of
    the ``loss_relation*`` keys.  Stages: ``segmenter``, ``head`` (tokens,
    head, losses and the backward) and ``optimizer``."""

    GROUPS = m2f.TRAINABLE_GROUPS

    def __init__(self, pipeline, trainable: Sequence[str] = m2f.TRAINABLE_GROUPS, mesh=None):
        """``mesh``: average over its dp ranks (each passes its own rows)."""
        super().__init__(pipeline, trainable, mesh)

    @staticmethod
    def is_loss(key: str) -> bool:
        return key.startswith("loss_relation")

    def loss_single(self, b: M2FTrainBatch, stage_times: Optional[Dict[str, float]] = None
                    ) -> Dict[str, torch.Tensor]:
        """Losses (and ``relation.recall@20``) of ONE image (``b``'s fields
        without the batch axis)."""
        p = self.pipeline
        c = p.cfg
        dev = p.device
        with span("segmenter", stage_times, dev):
            mf = p.segment(b.image)["mask_features"]

        with span("head", stage_times, dev):
            labels = b.object_labels.long()
            tokens = p.object_tokens(mf, b.object_masks, labels, chunked=True)
            S = c.object_token_size
            obj_valid, rel_target = b.object_valid, b.relation_target
            if S > 1:
                # tokens are object-major [M·S]; the targets stay object
                # indices, the top-left [M, M] block of the [M·S, M·S] grid
                M = obj_valid.shape[0]
                obj_valid = obj_valid.repeat_interleave(S)
                grid = rel_target.new_zeros((M * S, M * S) + rel_target.shape[2:])
                grid[:M, :M] = rel_target
                rel_target = grid
            extra = p._zero_extra(c.max_objects_padded)
            if p.pair_text_matrix is not None:
                extra["pair_text"] = p.pair_text_matrix[labels[:, None], labels[None, :]][None]
            if p.triplet_lookup is not None:
                idx = p.triplet_lookup[labels[:, None], labels[None, :]]       # [M, M, R]
                extra["triplet_text"] = p.triplet_table[idx][None]             # [1, M, M, R, T]
            target = rel_target.permute(2, 0, 1)                             # [R, M·S, M·S]
            pair = obj_valid[:, None] & obj_valid[None, :]

            def mcce(scores):   # the v1 loss family on one [R, N, N] map
                masked = torch.where(pair[None], scores,
                                     torch.full_like(scores, losses.NEG_INF))
                R = scores.shape[0]
                per = losses.multilabel_categorical_crossentropy(target.reshape(R, -1),
                                                                 masked.reshape(R, -1))
                w = per / (per.max() + 1e-12)
                return (per * w).mean() * 50.0, masked

            if c.head_version == "v1":
                scores = p._head_apply(tokens, obj_valid, extra)
                return p.head.loss(scores[None], target[None], obj_valid[None])
            if c.head_version == "v2":
                cast = lambda t: None if t is None else t.to(p.head_dtype)
                maps = p.head(tokens.to(p.head_dtype)[None], obj_valid[None],
                              pair_text_embeds=cast(extra.get("pair_text")),
                              triplet_text_embeds=cast(extra.get("triplet_text")))
                out = {f"loss_relation_{name}": mcce(m[0])[0] for name, m in maps.items()}
                _, masked = mcce(RelationHeadV2.primary(maps)[0])
            else:
                loss, masked = mcce(p._head_apply(tokens, obj_valid, extra))
                out = {"loss_relation": loss}
            out["relation.recall@20"] = losses.recall_at_k(masked[None], target[None], k=20)
            return out


def m2f_host_batch(examples) -> Dict[str, np.ndarray]:
    """Dataset examples (``PSGDataset.load_example`` dicts) → the numpy
    arrays of an :class:`M2FTrainBatch`."""
    arrays = {k: np.stack([e[k] for e in examples]) for k in M2FTrainBatch._fields}
    arrays["object_labels"] = arrays["object_labels"].astype(np.int32)
    return arrays


# ------------------------------------------------------------- host sampling
def sample_training_pairs(rng: np.random.Generator, relation_target: np.ndarray,
                          pair_valid: np.ndarray, sample_size: int = 32,
                          neg_over_pos: int = 3, llm_pairs: int = 4):
    """The reference's Q-Former sampler and LLM pair pick, as static-size
    arrays: relation_target [M, M, R], pair_valid [M*M] → (qf_idx [S],
    qf_weight [S], llm_idx [T], llm_valid [T]).  Draws from ``rng`` in the
    JAX package's order, so equal generators give equal indices."""
    pos = np.nonzero((relation_target.sum(-1).reshape(-1) > 0) & pair_valid)[0]
    neg = np.nonzero((relation_target.sum(-1).reshape(-1) == 0) & pair_valid)[0]
    n_pos, n_neg = len(pos), len(neg)

    if n_pos < sample_size:
        take_pos = pos
        n_neg_take = min(sample_size - n_pos, max(n_pos, 1) * neg_over_pos)
        take_neg = neg[rng.integers(0, n_neg, n_neg_take)] if n_neg else np.zeros(0, np.int64)
    else:
        take_pos = pos[rng.integers(0, n_pos, sample_size // (neg_over_pos + 1))]
        n_neg_take = sample_size * neg_over_pos // (neg_over_pos + 1)
        take_neg = neg[rng.integers(0, n_neg, n_neg_take)] if n_neg else np.zeros(0, np.int64)
    sel = np.concatenate([take_pos, take_neg]).astype(np.int32)
    qf_idx = np.zeros(sample_size, np.int32)
    qf_w = np.zeros(sample_size, np.float32)
    n = min(len(sel), sample_size)
    qf_idx[:n] = sel[:n]
    qf_w[:n] = 1.0

    if n_pos > 0:
        chosen = rng.permutation(pos)[:llm_pairs]
    else:
        cand = np.nonzero(pair_valid)[0]
        chosen = rng.permutation(cand)[:llm_pairs] if len(cand) else np.zeros(0, np.int64)
    llm_idx = np.zeros(llm_pairs, np.int32)
    llm_valid = np.zeros(llm_pairs, bool)
    llm_idx[: len(chosen)] = chosen
    llm_valid[: len(chosen)] = True
    return qf_idx, qf_w, llm_idx, llm_valid


def build_llm_labels(tokenizer, relation_names, relation_target: np.ndarray,
                     llm_idx: np.ndarray, max_len: int):
    """' {rel} </s>' per positive relation of each selected pair, tokenized
    and right-padded → (ids [T, max_len] int32, mask [T, max_len] bool)."""
    M = relation_target.shape[0]
    texts = []
    for si in llm_idx:
        rels = np.nonzero(relation_target.reshape(M * M, -1)[int(si)])[0]
        texts.append("".join(f" {relation_names[r]} </s>" for r in rels))
    ids = np.zeros((len(llm_idx), max_len), np.int32)
    mask = np.zeros((len(llm_idx), max_len), bool)
    for i, t in enumerate(texts):
        e = []
        for piece in t.split("</s>"):
            piece = piece.strip()
            if piece:
                e.extend(tokenizer.encode(piece))
                e.append(tokenizer.eos_id)
        e = e[:max_len]
        ids[i, : len(e)] = e
        mask[i, : len(e)] = True
    return ids, mask


def host_batch(examples, tokenizer, relation_names, rng: np.random.Generator,
               sample_size: int, llm_pairs: int, label_len: int) -> Dict[str, np.ndarray]:
    """Dataset examples (``PSGDataset.load_example`` dicts) → the numpy
    arrays of a :class:`TrainBatch`, pairs sampled per example in order
    (3 negatives per positive, as the JAX train tool samples them)."""
    arrays = m2f_host_batch(examples)
    cols = {k: [] for k in ("qf_sel_idx", "qf_sel_weight", "llm_sel_idx", "llm_valid",
                            "llm_label_ids", "llm_label_mask")}
    for e in examples:
        v = e["object_valid"]
        M = v.shape[0]
        pv = np.repeat(v, M) & np.tile(v, M)
        qi, qw, li, lv = sample_training_pairs(rng, e["relation_target"], pv,
                                               sample_size=sample_size, llm_pairs=llm_pairs)
        ids, msk = build_llm_labels(tokenizer, relation_names, e["relation_target"], li,
                                    label_len)
        for k, a in zip(cols, (qi, qw, li, lv, ids, msk)):
            cols[k].append(a)
    arrays.update({k: np.stack(v) for k, v in cols.items()})
    return arrays
