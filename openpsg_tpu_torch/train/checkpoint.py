"""Part checkpoints: only the trainable groups reach disk (counterpart of
``openpsg_tpu/train/checkpoint.py``, the reference's part-checkpoint hook).

The LLM and the segmenter never hit disk; frozen weights come from their
own sources at load time.  Layout, one directory per step::

    <dir>/step_<N>/params.pt     {"group.name": float32 tensor} (trainable)
    <dir>/step_<N>/opt_state.pt  {"count": int, "mu": {...}, "nu": {...}}
    <dir>/step_<N>/meta.json     epoch, classes, version, ...

written into a temporary directory and renamed, so a step directory is
complete or absent.  The ``max_keep`` newest steps are kept.  Files load
with ``torch.load(weights_only=True)``.

The JAX package's part checkpoints (orbax: ``<dir>/<N>/params/`` holding
the trainable groups' flax trees, ``<dir>/<N>/opt_state/`` the state of
its ``make_optimizer`` chain, ``<dir>/<N>/meta/metadata`` JSON) are read
too, without JAX (:class:`OrbaxPartReader`, through ``tensorstore``).
:func:`open_checkpoint` tells the two layouts apart.  For inference,
:func:`read_trainable` gives either's trainable groups under the port's
parameter names, so every tool's ``--checkpoint`` takes both.  For
training, :func:`read_training_state` gives either's values and AdamW
state (count and both moments, the JAX moments mapped as their
parameters are), so the train tool's ``--resume-from`` and
``--auto-resume`` continue a run of either package; the port then writes
its own layout.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Set, Tuple

import torch

from openpsg_tpu_torch.models.detectors import mask2former_relation as m2f
from openpsg_tpu_torch.models.detectors.psg_v4 import GROUPS

_STEP_DIR = re.compile(r"step_(\d+)")
_ORBAX_STEP = re.compile(r"\d+")


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


class OrbaxPartReader:
    """Read-only view of a JAX ``PartCheckpointer`` directory (orbax):
    steps, their meta and their ``params`` trees (numpy leaves)."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory) if _ORBAX_STEP.fullmatch(n)
                      and os.path.isfile(os.path.join(self.directory, n, "params", "_METADATA")))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def meta(self, step: int) -> Dict[str, Any]:
        path = os.path.join(self._path(step), "meta", "metadata")
        if not os.path.isfile(path):
            return {}
        with open(path, encoding="utf-8") as f:
            return json.load(f)

    def step_for_epoch(self, epoch: int) -> Optional[int]:
        """As :meth:`PartCheckpointer.step_for_epoch` (the JAX ``step_for_epoch``)."""
        for step in self.all_steps():
            if self.meta(step).get("epoch") == epoch:
                return step
        return None

    def params(self, step: int) -> Dict[str, Any]:
        """The ``params`` item of ``step``: {group: flax tree}."""
        from openpsg_tpu_torch.utils.jax_files import read_orbax_tree

        return read_orbax_tree(os.path.join(self._path(step), "params"))

    def opt_state(self, step: int, model) -> Dict[str, Any]:
        """The ``opt_state`` item of ``step``, the state of the JAX
        ``make_optimizer`` chain, → the port's AdamW state ``{"count": int,
        "mu": {...}, "nu": {...}}``, the moments under the port's parameter
        names (:func:`port_params`: transposed and unstacked as their
        parameters are).  Refuses another chain, and a state whose Adam and
        schedule counts differ."""
        from openpsg_tpu_torch.utils.jax_files import read_orbax_tree

        where = os.path.join(self._path(step), "opt_state")
        count, mu, nu = _adamw_state(read_orbax_tree(where), where)
        return {"count": count, "mu": port_params(model, mu), "nu": port_params(model, nu)}


# The JAX make_optimizer chain (openpsg_tpu/train/trainer.py:173-201), its
# members in order, with the state orbax saves for each: None for an empty
# state, else the state's fields.  The last member exists only with
# paramwise lr multipliers.
_JAX_CHAIN = (("clip_by_global_norm", None), ("scale_by_adam", {"count", "mu", "nu"}),
              ("add_decayed_weights", None), ("scale_by_learning_rate", {"count"}),
              ("lr_mult scaling", None))


def _adamw_state(chain, where: str) -> Tuple[int, Dict[str, Any], Dict[str, Any]]:
    """The saved state of the JAX ``make_optimizer`` chain (as
    :func:`~openpsg_tpu_torch.utils.jax_files.read_orbax_tree` gives it) →
    (count, first-moment tree, second-moment tree).  Refuses, by name,
    another chain and a state whose Adam and schedule counts differ (the
    port's AdamW keeps one count for both)."""
    def shape(node):
        return "empty" if node is None else (sorted(node) if isinstance(node, dict)
                                             else type(node).__name__)

    members = (sorted(chain, key=lambda k: (len(k), k)) if isinstance(chain, dict)
               else None)
    ok = members in ([str(i) for i in range(4)], [str(i) for i in range(5)]) and all(
        (chain[str(i)] is None) if fields is None
        else isinstance(chain[str(i)], dict) and set(chain[str(i)]) == fields
        for i, (_, fields) in enumerate(_JAX_CHAIN[:len(members)]))
    if not ok:
        want = " -> ".join(n for n, _ in _JAX_CHAIN[:4]) + f" [-> {_JAX_CHAIN[4][0]}]"
        got = ({k: shape(chain[k]) for k in members} if members is not None
               else shape(chain))
        raise ValueError(f"{where}: not the state of the JAX make_optimizer chain that the "
                         f"port's AdamW implements ({want}); its members: {got}")
    adam, sched = int(chain["1"]["count"]), int(chain["3"]["count"])
    if adam != sched:
        raise ValueError(f"{where}: scale_by_adam's count {adam} differs from "
                         f"scale_by_learning_rate's count {sched}; the port's AdamW keeps "
                         "one count for both")
    return adam, chain["1"]["mu"], chain["1"]["nu"]


def open_checkpoint(ckpt_dir: str):
    """The reader of a checkpoint directory, told by its layout: an
    :class:`OrbaxPartReader` where it holds JAX orbax steps and no
    ``step_<N>`` directory, else a :class:`PartCheckpointer`."""
    orbax = OrbaxPartReader(ckpt_dir)
    if orbax.all_steps() and not PartCheckpointer(ckpt_dir).all_steps():
        return orbax
    return PartCheckpointer(ckpt_dir)


def port_params(model, tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX part checkpoint's {group: tree} → {"group.name": tensor}, the
    port's names (:mod:`openpsg_tpu_torch.bridge`): a module group's flax
    ``{"params": ...}`` tree mapped as ``bridge.load_part`` maps it, an
    array group (``class_embeds``, ``object_cls_embed``) taken whole."""
    import numpy as np

    from openpsg_tpu_torch.bridge import part_state_dict, scan_prefixes

    groups = model.param_groups()
    unknown = sorted(set(tree) - set(groups))
    if unknown:
        raise KeyError(f"the checkpoint holds groups {unknown} that the model lacks")
    family = isinstance(model, m2f.PSGMask2FormerRelation)
    out = {}
    for g, sub in tree.items():
        if isinstance(sub, dict):
            module = getattr(model, g)
            scanned = scan_prefixes(module, g) if family else None
            for n, arr in part_state_dict(g, sub, scanned).items():
                out[f"{g}.{n}"] = torch.from_numpy(arr)
        else:
            out[f"{g}.{g}"] = torch.from_numpy(np.array(sub, np.float32))
    return out


def read_trainable(model, ckpt_dir: str, epoch: Optional[int] = None
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any], int]:
    """The trainable groups of a part checkpoint, the port's or the JAX
    package's → ({"group.name": tensor on the CPU}, meta, step).  ``epoch``
    (1-indexed) is mapped to its step through each step's meta; default the
    latest step."""
    ckpt = open_checkpoint(ckpt_dir)
    step = None
    if epoch is not None:
        step = ckpt.step_for_epoch(epoch)
        if step is None:
            raise FileNotFoundError(f"no checkpoint for epoch {epoch} in {ckpt_dir}")
    if isinstance(ckpt, PartCheckpointer):
        params, _, meta, step = ckpt.restore(step=step)
        return params, meta, step
    step = ckpt.latest_step() if step is None else step
    return port_params(model, ckpt.params(step)), ckpt.meta(step), step


def read_training_state(model, ckpt_dir: str, names, device=None
                        ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any], Dict[str, Any], int]:
    """The latest step of a part checkpoint, the port's or the JAX
    package's, for resuming training → (values, AdamW state ``{"count",
    "mu", "nu"}``, meta, step), tensors on ``device`` (default the CPU),
    all under the port's parameter names.  Refuses, naming the difference,
    a checkpoint whose values or moments do not cover exactly ``names``
    (the trainable tensors), or whose moments' shapes differ from their
    values'."""
    ckpt = open_checkpoint(ckpt_dir)
    if isinstance(ckpt, PartCheckpointer):
        params, opt_state, meta, step = ckpt.restore(device=device)
    else:
        step = ckpt.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
        params, opt_state = port_params(model, ckpt.params(step)), ckpt.opt_state(step, model)
        meta = ckpt.meta(step)
        to = lambda d: {k: v.to(device) for k, v in d.items()} if device is not None else d
        params = to(params)
        opt_state.update(mu=to(opt_state["mu"]), nu=to(opt_state["nu"]))
    names = set(names)
    for what, tensors in (("values", params), ("first moments", opt_state["mu"]),
                          ("second moments", opt_state["nu"])):
        if set(tensors) != names:
            raise KeyError(f"{ckpt_dir} step {step}: its {what} do not cover exactly the "
                           f"trainable tensors: missing {sorted(names - set(tensors))[:5]}, "
                           f"not trained {sorted(set(tensors) - names)[:5]}")
        bad = [k for k, v in tensors.items() if v.shape != params[k].shape]
        if bad:
            raise ValueError(f"{ckpt_dir} step {step}: its {what} of {bad[:5]} differ in shape "
                             "from the values")
    return params, opt_state, meta, step


def _model_cfg(cfg):
    return cfg.model if hasattr(cfg, "model") else cfg.get("model", {})


def _is_family(cfg) -> bool:
    return _model_cfg(cfg).get("type") in m2f.DETECTOR_TYPES


def freeze_keys_from_config(cfg) -> Set[str]:
    """The reference's ``train_cfg.freeze_layers`` names (prefix match) →
    the frozen top-level groups.  PSG v4: the segmenter, the text encoder
    and the class embeddings always freeze; the LLM freezes when a name
    mentions the language model or when no names are given.  The closed-set
    family trains its head and object class embeddings only."""
    model_cfg = _model_cfg(cfg)
    if _is_family(cfg):
        return set(m2f.GROUPS) - set(m2f.TRAINABLE_GROUPS)
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
    """The groups a config trains, in its model's group order."""
    groups = m2f.GROUPS if _is_family(cfg) else GROUPS
    trainable, _ = split_trainable(dict.fromkeys(groups), freeze_keys_from_config(cfg))
    return tuple(trainable)


@torch.no_grad()
def restore_trainable_for_inference(model, cfg, ckpt_dir: str, epoch: Optional[int] = None):
    """Load a part checkpoint's trainable groups, the port's or the JAX
    package's (:func:`read_trainable`), into ``model`` in place, each tensor
    cast to its module's working dtype.  ``epoch`` (1-indexed) is mapped to
    its step through the saved meta; default the latest step.
    → (step, meta)."""
    params, meta, step = read_trainable(model, ckpt_dir, epoch)
    groups = model.param_groups()
    want = {f"{g}.{n}" for g in trainable_groups(cfg) for n in groups[g]}
    if set(params) != want:
        raise KeyError(f"{ckpt_dir} step {step} does not hold exactly the trainable groups "
                       f"{trainable_groups(cfg)}: differing names "
                       f"{sorted(set(params) ^ want)[:5]}")
    for name, value in params.items():
        g, n = name.split(".", 1)
        if tuple(value.shape) != tuple(groups[g][n].shape):
            raise ValueError(f"{name}: checkpoint {tuple(value.shape)} vs model "
                             f"{tuple(groups[g][n].shape)}")
        groups[g][n].copy_(value)
    return step, meta
