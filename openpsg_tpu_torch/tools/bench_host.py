#!/usr/bin/env python
"""Host work per image at full output resolution (counterpart of
``tools/bench_host.py``): ``PSGv4.postprocess`` (token → predicate matching
over the top-K pairs), the submission paint (``paint_panoptic_indexed`` and
the BGR ``paint_panoptic``), the PNG encode (``utils/image_io.
encode_palette_png``, the port's numpy/zlib stand-in for the JAX package's
C++ codec ``native/pan_codec.cpp``), the server's base64 wrap, and the infer
tool's whole ``SubmissionWriter.add``.  No cv2: the card's machine has none,
and the port needs none.

It runs on the host CPU by design, as the JAX tool does: the ``device``
argument places only the tiny model whose configuration and tokenizer shape
the synthetic device output (:func:`make_dev`, the JAX tool's geometry).
Each stage: one warm-up call and ``--iters`` samples of a host clock,
median and IQR.

    python -m openpsg_tpu_torch.tools.bench_host [--size 1344] [--iters 30]
        [--objects 20] [--top-k 20] [--device cuda]
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import platform
import tempfile
from typing import Dict, Optional

import numpy as np

from openpsg_tpu_torch.utils.profiling import device_record, time_samples


def make_dev(size: int, n_obj: int, top_k: int, pipe) -> dict:
    """Realistic-shape PSG v4 device output (what ``PSGv4.postprocess``
    takes): a full-resolution panoptic map of ``n_obj`` random rectangles
    over background, the first M of them selected, ``top_k`` decoded pairs
    whose tokens spell real predicate names through the model's tokenizer,
    EOS-terminated, and a multiclass top-100 (the JAX tool's ``make_dev``,
    draw for draw).  ``pipe`` needs ``cfg`` and ``tokenizer`` and
    ``relation_names``."""
    rng = np.random.default_rng(0)
    M = pipe.cfg.head.max_objects_padded
    tok = pipe.tokenizer
    oids = (rng.integers(0, 80, n_obj) + 1000 * np.arange(n_obj)).astype(np.int64)
    pan = np.full((size, size), 133, np.int64)
    for oid in oids:
        y, x = rng.integers(0, size // 2, 2)
        h, w = rng.integers(size // 8, size // 2, 2)
        pan[y: y + h, x: x + w] = oid
    n_obj = min(n_obj, M)
    valid = np.zeros(M, bool)
    valid[:n_obj] = True
    object_ids = np.zeros(M, np.int64)
    object_ids[:n_obj] = oids[:n_obj]
    T = pipe.cfg.max_new_tokens
    gen = np.full((top_k, T), tok.pad_id, np.int32)
    names = pipe.relation_names
    for k in range(top_k):
        ids = tok.encode(" " + names[k % len(names)])[:T - 1]
        gen[k, : len(ids)] = ids
        gen[k, len(ids)] = tok.eos_id
    pairs = rng.choice(n_obj * n_obj, top_k, replace=False)
    sub, obj = pairs // n_obj, pairs % n_obj
    return {
        "paint_oids": [int(x) for x in oids],
        "pan_seg": pan,
        "object_valid": valid,
        "object_ids": object_ids,
        "top_pair_idx": (sub * M + obj).astype(np.int32),
        "top_pair_scores": rng.uniform(0.1, 1.0, top_k).astype(np.float32),
        "gen_tokens": gen,
        "mc_triplets": rng.integers(0, n_obj, (100, 3)).astype(np.int32),
        "mc_scores": rng.uniform(0, 1, 100).astype(np.float32),
        "fusion_pass_count": np.int32(n_obj),
    }


def run(pipe, size: int = 1344, iters: int = 30, objects: int = 20, top_k: int = 20,
        device_label: Optional[str] = None, emit: bool = True) -> Dict:
    """Time each host stage on :func:`make_dev`'s output → the JSON record
    (also printed with ``emit``): per stage the median and IQR in ms, the
    infer tool's and the server's host ms per image."""
    from openpsg_tpu_torch.utils.image_io import encode_palette_png
    from openpsg_tpu_torch.utils.submission import (
        SubmissionWriter,
        paint_panoptic,
        paint_panoptic_indexed,
    )

    dev = make_dev(size, objects, top_k, pipe)
    paint_oids = dev.pop("paint_oids")
    res = pipe.postprocess(dev)
    idx, palette, _, _, _ = paint_panoptic_indexed(dev["pan_seg"], paint_oids)
    png = encode_palette_png(idx, palette)
    cpu = "cpu"
    stats = {
        "postprocess": time_samples(lambda: pipe.postprocess(dev), iters, cpu),
        "paint_indexed": time_samples(
            lambda: paint_panoptic_indexed(dev["pan_seg"], paint_oids), iters, cpu),
        "paint_bgr": time_samples(lambda: paint_panoptic(dev["pan_seg"], paint_oids), iters,
                                  cpu),
        "png_palette": time_samples(lambda: encode_palette_png(idx, palette), iters, cpu),
        "serve_b64": time_samples(lambda: base64.b64encode(png), iters, cpu),
    }
    with tempfile.TemporaryDirectory() as td:
        w = SubmissionWriter(td)
        stats["writer_add"] = time_samples(
            lambda: w.add(dev["pan_seg"], paint_oids, res["rel_results"]["relation"],
                          test_idx=0), max(iters // 3, 5), cpu)
    med = {k: s["median_ms"] for k, s in stats.items()}
    infer_ms = med["postprocess"] + med["writer_add"]          # the infer tool's host path
    serve_ms = med["postprocess"] + med["paint_indexed"] + med["png_palette"] + med["serve_b64"]
    record = {
        "tool": "bench_host",
        "runs_on": "host CPU (by design; the model's device only shapes the inputs)",
        "size": size, "objects": objects, "top_k": top_k,
        **{f"{k}_ms": v for k, v in med.items()},
        "stages": {k: {kk: vv for kk, vv in s.items() if kk != "samples_ms"}
                   for k, s in stats.items()},
        "infer_host_ms_per_image": infer_ms, "infer_host_img_per_s": 1e3 / infer_ms,
        "serve_host_ms_per_image": serve_ms, "serve_host_img_per_s": 1e3 / serve_ms,
        "png_bytes": len(png),
        "codec": "numpy + zlib (utils/image_io.encode_palette_png)",
        "host": f"{platform.machine()}, {os.cpu_count()} cores",
        "device": device_label or device_record(pipe.device),
    }
    if emit:
        print(json.dumps(record), flush=True)
    return record


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=1344)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--objects", type=int, default=20)
    ap.add_argument("--top-k", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the tiny model (default the card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config

    pipe = PSGv4(PSGv4Config.tiny_test(), seed=0, device=args.device)
    return run(pipe, args.size, args.iters, args.objects, args.top_k)


if __name__ == "__main__":
    main()
