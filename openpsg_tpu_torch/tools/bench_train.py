#!/usr/bin/env python
"""Train-step time of the PSG v4 recipe at real widths on the card
(counterpart of ``tools/bench_train.py``).

The reference recipe: the segmenter and the LLM frozen, the relation head
trained (the reference's ``freeze_layers``), 32 sampled Q-Former pairs at
3 negatives per positive and at most 4 teacher-forced LLM pairs, B = 1, at
1344² with the 32-layer Llama-2-7B in int8 (its deployment form; a frozen
LLM needs no bf16 weights).  The step is :class:`~openpsg_tpu_torch.train.
trainer.V4Trainer`'s ``train_step`` with the AdamW chain and learning-rate
schedule ``tools/train.py`` builds for ``baseline_v4_ov.py``, on the JAX
tool's synthetic batch (8 rectangle objects, 4 relations).

``BENCH_TRAIN_LLM=1`` is the scratch recipe: a bf16 LLM trained too, with
float32 masters and AdamW moments.  At 32 layers that needs about 135 GB
(:func:`train_llm_bytes`), more than one card has, so the tool refuses it
up front; it runs at a reduced ``BENCH_LLM_LAYERS``.

Timing: one warm-up step, then ``BENCH_ITERS`` steps, each a host clock
around a step that ends in ``torch.cuda.synchronize()``; median and IQR of
the seconds per step, peak memory, and the shared-KV kernel's launches (0:
a train step runs the plain attention, as the JAX package's ``custom_vjp``
does).

Env knobs (the JAX tool's): ``BENCH_IMAGE`` (1344, "HxW" too),
``BENCH_LLM_LAYERS`` (32), ``BENCH_TRAIN_LLM`` (0), ``BENCH_ITERS`` (4).
Prints one JSON line.

    python -m openpsg_tpu_torch.tools.bench_train [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from openpsg_tpu_torch.utils.profiling import device_record, time_samples

# the bytes a trained bf16 parameter takes: the bf16 value and its bf16
# gradient, the float32 master, its float32 gradient sum and two float32
# AdamW moments
TRAIN_BYTES_PER_PARAM = 2 + 2 + 4 + 4 + 4 + 4
LABEL_LEN = 12


def parse_spec(spec: str):
    """``"1344"`` or ``"HxW"`` → (H, W)."""
    if "x" in spec:
        h, w = (int(t) for t in spec.split("x"))
        return h, w
    return int(spec), int(spec)


def train_llm_bytes(llm_cfg) -> int:
    """Bytes of the trained LLM's parameters, gradients, masters and moments
    (activations not counted)."""
    D, F, V, n = llm_cfg.dim, llm_cfg.ffn_hidden, llm_cfg.vocab_size, llm_cfg.n_layers
    hd = D // llm_cfg.n_heads
    per_layer = (D * D * 2 + 2 * D * llm_cfg.n_kv_heads * hd + 3 * D * F + 2 * D)
    return (n * per_layer + 2 * V * D + D) * TRAIN_BYTES_PER_PARAM


def make_batch(model, seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX tool's synthetic batch at the model's bucket (B = 1): 8
    rectangle objects on a 2 × 4 grid with seeded labels, relations (0, 1,
    4), (2, 3, 23), (4, 5, 7), (6, 7, 0), the pairs sampled as the trainer's
    host sampler does → the numpy arrays of a ``TrainBatch``."""
    from openpsg_tpu_torch.train.trainer import build_llm_labels, sample_training_pairs

    c = model.cfg.head
    M, S, T, R = (c.max_objects_padded, c.sampled_qformer_batch_size, c.max_llm_forward_num,
                  c.num_relation_classes)
    H, W = model._model_hw()
    H4, W4 = H // 4, W // 4
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (1, H, W, 3)).astype(np.float32)
    masks = np.zeros((1, M, H4, W4), bool)
    for i in range(8):
        y, x = (i // 4) * (H4 // 2), (i % 4) * (W4 // 4)
        masks[0, i, y: y + H4 // 2, x: x + W4 // 4] = True
    labels = np.zeros((1, M), np.int32)
    labels[0, :8] = rng.integers(0, 133, 8)
    valid = np.zeros((1, M), bool)
    valid[0, :8] = True
    target = np.zeros((1, M, M, R), np.float32)
    for s, o, r in [(0, 1, 4), (2, 3, 23), (4, 5, 7), (6, 7, 0)]:
        target[0, s, o, r] = 1.0
    pv = np.repeat(valid[0], M) & np.tile(valid[0], M)
    qi, qw, li, lv = sample_training_pairs(rng, target[0], pv, sample_size=S, llm_pairs=T)
    ids, msk = build_llm_labels(model.tokenizer, model.relation_names, target[0], li,
                                LABEL_LEN)
    arrays = dict(image=img, object_masks=masks, object_labels=labels, object_valid=valid,
                  relation_target=target, qf_sel_idx=qi[None], qf_sel_weight=qw[None],
                  llm_sel_idx=li[None], llm_valid=lv[None], llm_label_ids=ids[None],
                  llm_label_mask=msk[None])
    return arrays


def make_trainer(model, train_llm: bool = False):
    """The trainer, optimizer and its state as ``tools/train.py`` builds them
    for ``baseline_v4_ov.py`` (AdamW lr 1e-4, weight decay 0.05, clip 0.01,
    linear warmup over 500 steps from 0.001) → (trainer, optimizer, state)."""
    from openpsg_tpu_torch.train.trainer import V4Trainer, make_lr_schedule, make_optimizer

    trainer = V4Trainer(model, trainable=("head", "llm") if train_llm else ("head",))
    opt = make_optimizer(make_lr_schedule(), max_norm=0.01, weight_decay=0.05)
    return trainer, opt, opt.init(trainer.master)


def run(model, iters: int = 4, train_llm: bool = False, spec: Optional[str] = None,
        device_label: Optional[str] = None, emit: bool = True) -> Dict:
    """One warm-up step and ``iters`` timed steps of ``model``'s trainer on
    :func:`make_batch` → the JSON record (also printed with ``emit``); its
    ``losses`` are every step's total loss, the warm-up's first."""
    from openpsg_tpu_torch.ops import flash_cross_attn as fca
    from openpsg_tpu_torch.train.trainer import TrainBatch

    dev = model.device
    H, W = model._model_hw()
    spec = spec or (f"{H}" if H == W else f"{H}x{W}")
    batch = TrainBatch.from_numpy(make_batch(model), dev)
    trainer, opt, state = make_trainer(model, train_llm)
    launches0 = fca.flash_shared_kv_cross_attn.launches
    losses = []

    def step():
        losses.append(float(trainer.train_step(batch, opt, state)["loss"]))

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    stats = time_samples(step, iters, dev)
    n_layers = model.cfg.llm.n_layers
    record = {
        "tool": "bench_train",
        "metric": f"psg_v4_train_step_s@{spec}px_llm{n_layers}L"
                  + ("_trainllm" if train_llm else "_frozenllm"),
        "value": stats["median_ms"] / 1e3, "unit": "s/step",
        "q1_s": stats["q1_ms"] / 1e3, "q3_s": stats["q3_ms"] / 1e3,
        "iqr_s": stats["iqr_ms"] / 1e3,
        "steps_s": [s / 1e3 for s in stats["samples_ms"]],
        "img_per_s": 1e3 / stats["median_ms"],
        "losses": losses,
        "llm": {"layers": n_layers, "int8": model.cfg.llm.quant, "trained": train_llm},
        "flash_shared_kv_cross_attn_launches": fca.flash_shared_kv_cross_attn.launches
        - launches0,
    }
    if dev.type == "cuda":
        record["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    record["device"] = device_label or device_record(dev)
    if emit:
        print(json.dumps(record), flush=True)
    return record


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card; cpu runs the plain versions)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from openpsg_tpu_torch import resolve_device
    from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4
    from openpsg_tpu_torch.tools.bench_stages import model_config

    device = resolve_device(args.device)
    spec = os.environ.get("BENCH_IMAGE", "1344")
    H, W = parse_spec(spec)
    train_llm = bool(int(os.environ.get("BENCH_TRAIN_LLM", 0)))
    cfg = model_config(H, llm_layers=int(os.environ.get("BENCH_LLM_LAYERS", 32)),
                       llm_int8=not train_llm)
    cfg = dataclasses.replace(cfg, input_hw=(H, W))
    if train_llm and device.type == "cuda":
        need = train_llm_bytes(cfg.llm)
        have = torch.cuda.get_device_properties(device).total_memory
        if need > have:
            raise SystemExit(
                f"BENCH_TRAIN_LLM=1 at {cfg.llm.n_layers} layers needs about "
                f"{need / 1e9:.0f} GB for the LLM's bf16 values and gradients, float32 "
                f"masters, gradient sums and AdamW moments, more than the card's "
                f"{have / 1e9:.0f} GB; set BENCH_LLM_LAYERS lower")
    model = PSGv4(cfg, seed=0, device=device)
    return run(model, iters=int(os.environ.get("BENCH_ITERS", 4)), train_llm=train_llm,
               spec=spec)


if __name__ == "__main__":
    main()
