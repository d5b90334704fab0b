"""PVSG video scene graphs: per-frame PSG inference at batch > 1
(counterpart of ``tools/pvsg/infer_video.py``).

    python -m openpsg_tpu_torch.tools.pvsg.infer_video --config C --frames-dir F
        [--output O] [--batch-size 4] [--limit-frames N] [--checkpoint DIR]
        [--device cpu]

``F`` holds one directory of PNG frames per video (``pvsg.extractor``'s
output).  Frames go through the model's square bucket in chunks of
``--batch-size``: a chunk is padded with copies of its last frame and runs
``infer_batch``; at batch size 1 each frame runs ``infer``.  One record per
frame (``frame``, ``object_id_list``, ``relations`` as the model gives them,
0-indexed, and ``relation_scores``), grouped by video, goes to ``O``.

``--checkpoint`` restores the head alone, as ``tools.predict`` does
(:func:`~openpsg_tpu_torch.tools.predict.restore_head`).  Runs on the card
unless ``--device cpu`` is given, and raises when asked for the card
without one.  ``main(argv, model=...)`` takes a ready model.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m openpsg_tpu_torch.tools.pvsg.infer_video")
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--frames-dir", required=True,
                    help="directory of per-video frame directories (the extractor's output)")
    ap.add_argument("--output", default="./pvsg_scene_graphs.json")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--limit-frames", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; pass cpu for the CPU path)")
    return ap.parse_args(argv)


def main(argv=None, model=None):
    """Run the tool → {video: [frame record, ...]}."""
    args = parse_args(argv)

    from openpsg_tpu_torch import resolve_device
    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config
    from openpsg_tpu_torch.data.preprocess import Preprocessor, load_image_rgb
    from openpsg_tpu_torch.tools.predict import restore_head

    if model is None:
        model = build_detector_from_config(Config.fromfile(args.config), seed=args.seed,
                                           device=resolve_device(args.device))
    if args.checkpoint:
        print(f"restored the head from step {restore_head(model, args.checkpoint)}")

    H, _ = model._model_hw()
    preproc = Preprocessor(scale=(H, H))
    B = args.batch_size

    videos = {}
    for vdir in sorted(glob.glob(os.path.join(args.frames_dir, "*"))):
        if not os.path.isdir(vdir):
            continue
        frames = sorted(glob.glob(os.path.join(vdir, "*.png")))
        if args.limit_frames:
            frames = frames[: args.limit_frames]
        records = []
        for start in range(0, len(frames), B):
            chunk = frames[start:start + B]
            exs = [preproc(load_image_rgb(f)) for f in chunk]
            pads = B - len(exs)
            imgs = np.stack([e["image"].astype(np.float32) for e in exs]
                            + [exs[-1]["image"].astype(np.float32)] * pads)
            hws = np.asarray([e["img_shape"] for e in exs]
                             + [exs[-1]["img_shape"]] * pads, np.int32)
            if B > 1:
                results = model.infer_batch(imgs, hws)[: len(exs)]
            else:
                results = [model.infer(imgs[i], tuple(hws[i])) for i in range(len(exs))]
            for f, res in zip(chunk, results):
                records.append(dict(
                    frame=os.path.basename(f),
                    object_id_list=res["rel_results"]["object_id_list"],
                    relations=res["rel_results"]["relation"],
                    relation_scores=[float(s) for s in res["rel_scores"]],
                ))
        videos[os.path.basename(vdir)] = records
        print(f"{os.path.basename(vdir)}: {len(records)} frames")

    with open(args.output, "w", encoding="utf-8") as f:
        json.dump(videos, f)
    print(f"wrote {args.output}")
    return videos


if __name__ == "__main__":
    main()
