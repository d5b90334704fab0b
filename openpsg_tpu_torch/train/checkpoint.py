"""Part checkpoints: only the trainable groups reach disk (counterpart of
``openpsg_tpu/train/checkpoint.py``, the reference's part-checkpoint hook).

The LLM and the segmenter never hit disk; frozen weights come from their
own sources at load time.  Layout, one directory per step::

    <dir>/step_<N>/params.pt     {"group.name": float32 tensor} (trainable)
    <dir>/step_<N>/opt_state.pt  {"count": int, "mu": {...}, "nu": {...}}
    <dir>/step_<N>/meta.json     epoch, classes, version, ...

written into a temporary directory and renamed, so a step directory is
complete or absent.  The ``max_keep`` newest steps are kept.  Files load
with ``torch.load(weights_only=True)``.  The JAX package's orbax
checkpoints are a format of their own, which this module does not read.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Set, Tuple

import torch

from openpsg_tpu_torch.models.detectors.psg_v4 import GROUPS

_STEP_DIR = re.compile(r"step_(\d+)")


class PartCheckpointer:
    def __init__(self, directory: str, max_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_keep = max_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_DIR.fullmatch(name)
            if m and os.path.isdir(os.path.join(self.directory, name)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def save(self, step: int, trainable_params: Dict[str, torch.Tensor],
             opt_state: Dict[str, Any], meta: Optional[Dict[str, Any]] = None) -> str:
        """Write step ``step`` (params and optimizer state moved to the CPU)
        and drop the oldest steps beyond ``max_keep`` → its directory."""
        cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
        tmp = self._path(step) + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(cpu(trainable_params), os.path.join(tmp, "params.pt"))
        torch.save({"count": int(opt_state["count"]), "mu": cpu(opt_state["mu"]),
                    "nu": cpu(opt_state["nu"])}, os.path.join(tmp, "opt_state.pt"))
        with open(os.path.join(tmp, "meta.json"), "w", encoding="utf-8") as f:
            json.dump(meta or {}, f)
        final = self._path(step)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        for old in self.all_steps()[: -self.max_keep or None]:
            shutil.rmtree(self._path(old))
        return final

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def meta(self, step: int) -> Dict[str, Any]:
        with open(os.path.join(self._path(step), "meta.json"), encoding="utf-8") as f:
            return json.load(f)

    def step_for_epoch(self, epoch: int) -> Optional[int]:
        """The step saved with ``meta['epoch'] == epoch`` (1-indexed), which
        gives the reference's ``epoch_N.pth`` addressing."""
        for step in self.all_steps():
            if self.meta(step).get("epoch") == epoch:
                return step
        return None

    def restore(self, step: Optional[int] = None, device=None
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any], Dict[str, Any], int]:
        """→ (params, opt_state, meta, step) of ``step`` (default the
        latest), tensors on ``device`` (default the CPU)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = self._path(step)
        load = lambda name: torch.load(os.path.join(d, name), map_location=device,
                                       weights_only=True)
        return load("params.pt"), load("opt_state.pt"), self.meta(step), step

    def close(self) -> None:
        """Nothing is held open between calls; kept for the JAX surface."""


def freeze_keys_from_config(cfg) -> Set[str]:
    """The reference's ``train_cfg.freeze_layers`` names (prefix match) →
    the frozen top-level groups of the v4 model.  The segmenter, the text
    encoder and the class embeddings always freeze; the LLM freezes when a
    name mentions the language model or when no names are given."""
    model_cfg = cfg.model if hasattr(cfg, "model") else cfg.get("model", {})
    train_cfg = model_cfg.get("train_cfg") or {}
    freeze_names = set(train_cfg.get("freeze_layers", []))
    freeze = {"segmenter", "text", "class_embeds"}
    if not freeze_names or any("language_model" in f or "llama" in f for f in freeze_names):
        freeze.add("llm")
    return freeze


def split_trainable(params: Dict[str, Any], freeze_keys) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Split a top-level {group: ...} dict into (trainable, frozen)."""
    trainable = {k: v for k, v in params.items() if k not in freeze_keys}
    frozen = {k: v for k, v in params.items() if k in freeze_keys}
    return trainable, frozen


def trainable_groups(cfg) -> Tuple[str, ...]:
    """The groups a config trains, in :data:`GROUPS` order."""
    trainable, _ = split_trainable(dict.fromkeys(GROUPS), freeze_keys_from_config(cfg))
    return tuple(trainable)


@torch.no_grad()
def restore_trainable_for_inference(model, cfg, ckpt_dir: str, epoch: Optional[int] = None):
    """Load a part checkpoint's trainable groups into ``model`` in place,
    each tensor cast to its module's working dtype.  ``epoch`` (1-indexed)
    is mapped to its step through the saved meta; default the latest
    step.  → (step, meta)."""
    ckpt = PartCheckpointer(ckpt_dir)
    step = None
    if epoch is not None:
        step = ckpt.step_for_epoch(epoch)
        if step is None:
            raise FileNotFoundError(f"no checkpoint for epoch {epoch} in {ckpt_dir}")
    params, _, meta, step = ckpt.restore(step=step)
    groups = model.param_groups()
    want = {f"{g}.{n}" for g in trainable_groups(cfg) for n in groups[g]}
    if set(params) != want:
        raise KeyError(f"{ckpt_dir} step {step} does not hold exactly the trainable groups "
                       f"{trainable_groups(cfg)}: differing names "
                       f"{sorted(set(params) ^ want)[:5]}")
    for name, value in params.items():
        g, n = name.split(".", 1)
        groups[g][n].copy_(value)
    return step, meta
