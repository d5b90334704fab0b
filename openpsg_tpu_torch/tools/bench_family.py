#!/usr/bin/env python
"""End-to-end inference images per second of the closed-set v1 / v2 / v3
generations on the card (counterpart of ``tools/bench_family.py``), each
built from the port's copy of its shipped config
(``openpsg_tpu_torch/configs/psg/``) through the port's builder:

  v1  Mask2FormerRelation      R50 Mask2Former + 2-layer BERT-style head
  v2  Mask2FormerRelationV2    + 5-expert MoE head on offline text features
  v3  OpenSeeDRelation         + truncated-LLaMA head (6 layers)

(``v3_ov`` and ``v1_swinb`` too.)  Weights are seeded random (no published
checkpoints here); the time does not depend on their values, except through
how many objects fusion keeps.

Timing: one warm-up ``infer``, then ``BENCH_ITERS`` samples of a host clock
around ``infer`` on one seeded image (whose result ends on the host, so
every sample ends with the card synchronized); img/s is 1000 over the
median ms.

Env knobs (the JAX tool's): ``BENCH_FAMILY`` (v1,v2,v3), ``BENCH_IMAGE``
(1344, "HxW" too), ``BENCH_ITERS`` (4), ``BENCH_TINY=1`` (the tiny presets
at 64², the CPU path the tests run).  Prints one JSON line per family.

    python -m openpsg_tpu_torch.tools.bench_family [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from openpsg_tpu_torch.utils.profiling import device_record, time_samples

CONFIGS = {
    "v1": "baseline_r50.py",
    "v1_swinb": "baseline_swin_b.py",
    "v2": "baseline_v2_r50.py",
    "v3": "baseline_v3_r50.py",
    "v3_ov": "baseline_v3_ov.py",
}
TINY = {"tpu.segmenter_preset": "tiny", "tpu.head_preset": "tiny",
        "tpu.llm_preset": "tiny", "tpu.bf16": False}
CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs", "psg")


def build(fam: str, device, tiny: bool = False, seed: int = 0):
    """The family's model from the port's copy of its shipped config (the
    tiny presets with ``tiny``) → (model, build seconds)."""
    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config

    cfg = Config.fromfile(os.path.join(CONFIG_DIR, CONFIGS[fam]))
    if tiny:
        cfg.merge_from_dict(dict(TINY))
    t0 = time.perf_counter()
    model = build_detector_from_config(cfg, seed=seed, device=device)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    return model, time.perf_counter() - t0


def run(model, fam: str, spec: str, iters: int = 4, hw=None, build_s: Optional[float] = None,
        device_label: Optional[str] = None, emit: bool = True) -> Dict:
    """Time ``model.infer`` on one seeded image of ``hw`` (default the
    model's bucket; valid region 8 columns narrower, as the JAX tool's) →
    the JSON record (also printed with ``emit``)."""
    dev = model.device
    H, W = hw or model._model_hw()
    img = np.random.default_rng(0).integers(0, 255, (H, W, 3)).astype(np.float32)
    img_hw = (H, W - 8)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    res = {}

    def infer():
        res.update(model.infer(img, img_hw))

    stats = time_samples(infer, iters, dev)
    record = {
        "tool": "bench_family",
        "metric": f"psg_{fam}_e2e_infer_img_per_s@{spec}px",
        "value": 1e3 / stats["median_ms"],
        "unit": "images/s",
        "detail": {
            "config": CONFIGS[fam],
            "ms_per_image": stats["median_ms"], "q1_ms": stats["q1_ms"],
            "q3_ms": stats["q3_ms"], "iqr_ms": stats["iqr_ms"],
            "img_per_s_q1_q3": [1e3 / stats["q3_ms"], 1e3 / stats["q1_ms"]],
            "iters": iters, "build_s": build_s,
            "objects": len(res["rel_results"]["object_id_list"]),
            "relations": len(res["rel_results"]["relation"]),
        },
    }
    if dev.type == "cuda":
        record["detail"]["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
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
    from openpsg_tpu_torch.tools.bench_train import parse_spec

    device = resolve_device(args.device)
    spec = os.environ.get("BENCH_IMAGE", "1344")
    hw = parse_spec(spec)
    iters = int(os.environ.get("BENCH_ITERS", 4))
    fams = [f for f in os.environ.get("BENCH_FAMILY", "v1,v2,v3").split(",") if f]
    tiny = bool(int(os.environ.get("BENCH_TINY", 0)))
    if tiny:
        hw, spec = (64, 64), "tiny64"
    label = device_record(device)
    records = []
    for fam in fams:
        model, build_s = build(fam, device, tiny)
        records.append(run(model, fam, spec, iters, hw, build_s, label))
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return records


if __name__ == "__main__":
    main()
