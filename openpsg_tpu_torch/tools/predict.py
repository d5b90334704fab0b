"""Batch prediction over any PSG-style json (counterpart of
``tools/predict.py``, the reference's generic prediction surface).

    python -m openpsg_tpu_torch.tools.predict --config C --input-json J
        [--data-dir D] [--output-dir O] [--checkpoint DIR] [--limit N]
        [--device cpu]

Each record of the json (a list, or a dict with ``data``) runs through
``infer`` at the model's square bucket and comes back with its own fields
plus ``relations`` (1-indexed predicates), ``relation_scores``,
``segments_info`` and ``pan_seg_file_name``; the panoptic PNG is
``O/panseg/{source stem}.png`` (segment ids in rgb2id colours from seed +
record index; id 133 is not painted); the records go to
``O/predictions.json``.

``--checkpoint`` restores as the JAX tool does, with the head group alone
as the target (:func:`restore_head`): a part checkpoint holding any other
group (the family's ``object_cls_embed``, a trained LLM) is refused.

Runs on the card unless ``--device cpu`` is given, and raises when asked
for the card without one.  ``main(argv, model=...)`` takes a ready model in
place of building one.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m openpsg_tpu_torch.tools.predict")
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--input-json", required=True)
    ap.add_argument("--data-dir", default="")
    ap.add_argument("--output-dir", default="./predict_out")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; pass cpu for the CPU path)")
    return ap.parse_args(argv)


def restore_head(model, ckpt_dir: str) -> int:
    """Load a part checkpoint (the port's or the JAX package's) into
    ``model`` with its ``head`` group as the only target, as the JAX
    ``predict.py`` and ``pvsg/infer_video.py`` do (orbax
    ``StandardRestore({"head": ...})``): the checkpoint must hold exactly
    the head; orbax refuses a checkpoint with any other group, and so does
    this → the restored step."""
    import torch

    from openpsg_tpu_torch.train.checkpoint import read_trainable

    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"--checkpoint {ckpt_dir}: no such directory")
    params, _, step = read_trainable(model, ckpt_dir)
    head = model.param_groups()["head"]
    want = {f"head.{n}" for n in head}
    if set(params) != want:
        raise ValueError(
            f"{ckpt_dir} step {step}: the restore target is the head group alone and the "
            "checkpoint's tree does not match it: "
            + ", ".join(f"{k} ({'missing on disk' if k in want else 'not in the target'})"
                        for k in sorted(set(params) ^ want)[:5]))
    with torch.no_grad():
        for name, value in params.items():
            head[name.split(".", 1)[1]].copy_(value)
    return step


def main(argv=None, model=None):
    """Run the tool → the path of ``predictions.json``."""
    args = parse_args(argv)

    from openpsg_tpu_torch import resolve_device
    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config
    from openpsg_tpu_torch.data.preprocess import Preprocessor, load_image_rgb, resize_nearest
    from openpsg_tpu_torch.utils.image_io import encode_palette_png, write_png
    from openpsg_tpu_torch.utils.submission import paint_panoptic_indexed, relations_1indexed

    if model is None:
        model = build_detector_from_config(Config.fromfile(args.config), seed=args.seed,
                                           device=resolve_device(args.device))
    if args.checkpoint:
        print(f"restored the head from step {restore_head(model, args.checkpoint)}")

    with open(args.input_json, "r", encoding="utf-8") as f:
        raw = json.load(f)
    records = raw["data"] if isinstance(raw, dict) and "data" in raw else raw
    if args.limit:
        records = records[: args.limit]

    panseg_dir = os.path.join(args.output_dir, "panseg")
    os.makedirs(panseg_dir, exist_ok=True)

    H, _ = model._model_hw()
    preproc = Preprocessor(scale=(H, H))
    out_records = []
    for i, d in enumerate(records):
        img = load_image_rgb(os.path.join(args.data_dir, d["file_name"]))
        ex = preproc(img)
        res = model.infer(ex["image"].astype(np.float32), ex["img_shape"])
        # crop the padding off before resizing back (nearest keeps ids)
        nh, nw = ex["img_shape"]
        pan_ori = resize_nearest(res["pan_results"][:nh, :nw], img.shape[:2]).astype(np.int64)

        stem = os.path.splitext(os.path.basename(d["file_name"]))[0]
        idx, palette, segments_info, _, _ = paint_panoptic_indexed(
            pan_ori, res["rel_results"]["object_id_list"], seed=args.seed + i)
        write_png(os.path.join(panseg_dir, f"{stem}.png"), encode_palette_png(idx, palette))

        rec = dict(d)
        rec.update(
            relations=relations_1indexed(res["rel_results"]["relation"]),
            relation_scores=[float(s) for s in res["rel_scores"]],
            segments_info=segments_info,
            pan_seg_file_name=f"{stem}.png",
        )
        out_records.append(rec)

    out_path = os.path.join(args.output_dir, "predictions.json")
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(out_records, f, default=str)
    print(f"wrote {len(out_records)} predictions to {out_path}")
    return out_path


if __name__ == "__main__":
    main()
