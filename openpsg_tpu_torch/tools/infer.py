"""Validation inference → HiLo submission (counterpart of ``tools/infer.py``).

    python -m openpsg_tpu_torch.tools.infer --config C [--checkpoint DIR [--epoch N]]
        [--device cpu] ...
    python -m openpsg_tpu_torch.tools.infer <exp_tag> <epoch> ...

A trained model: ``--checkpoint`` names a part-checkpoint directory (the
train tool's ``<work_dir>/ckpts``) whose trainable groups replace the
built model's (the latest step, or the one saved for ``epoch``).  The
positional form reads the config ``./work_dirs/ov_psg_<tag>/<tag>.py`` and,
given an epoch, the checkpoints beside it in ``ckpts``.

Flow: filter the PSG json to the test images with ≥ 1 relation, resize
each image keep-ratio into an aspect bucket (square, landscape, portrait;
``--single-bucket`` pads everything to the square cap), run the model, and
write the panoptic PNGs and ``relation.json``.  Images are grouped by
bucket, largest bucket first, and the submission is put back in test order
at the end.  A worker thread prepares the next chunk while the model runs
the current one.

Models: PSG v4 (``OpenSeeDRelationV2``) and the closed-set v1 / v2 / v3
family (``Mask2FormerRelation``, ``Mask2FormerRelationV2``,
``OpenSeeDRelation``: ``PSGMask2FormerRelation``, per image or
``--batch-size``, ``--gt-masks``; its part checkpoints hold the head and
the object class embeddings).

Model paths: per image (``PSGv4.infer``); ``--micro-batch N`` runs the
deployment program on N images at a time (``infer_microbatch``: one
flattened LLM prefill and decode); ``--batch-size N`` runs ``infer_batch``
on N at a time; ``--gt-masks`` replaces fusion with the ground-truth
masks.  With no flag the tool selects the micro-batch program outright for
an int8-activation LLM or a pinned decode (``decode_early_exit=False``),
and otherwise switches between the two on the rolling median of realized
decode steps (:class:`AutoMBController`); ``--no-auto-micro-batch`` pins
per-image.  A tail chunk is padded with copies of its last image, so every
chunk has the same size.

``--vis DIR`` writes each image's panoptic overlay as
``DIR/{stem}_pan_seg.jpg`` and prints its top-20 triplet table (cv2 draws
the overlay, as in the JAX tool).

Runs on the card unless ``--device cpu`` is given, and raises when asked
for the card without one.  ``main(argv, model=...)`` takes a ready model
(e.g. one whose weights came over the bridge) in place of building one.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class AutoMBController:
    """Rolling-median auto micro-batch selection (the flag-free v4 path).

    :meth:`observe` records each image's realized decode trip count;
    :meth:`decide` returns the new chunk size (``mb`` or ``1``) when the
    MEDIAN of the last ``k`` observations crosses the threshold, else
    ``None``.  Switch up at ``median >= threshold``, back down only at
    ``median <= threshold - hysteresis`` (the micro-batch reports the
    chunk-joint trip count, the max over its images, which biases its
    samples upward).  The window clears on every switch."""

    def __init__(self, threshold: int, k: int, hysteresis: int, mb: int):
        self.threshold, self.k, self.hyst, self.mb = threshold, k, hysteresis, mb
        self.window: collections.deque = collections.deque(maxlen=k)
        self.mode = 1
        self.switches: list = []   # (n_observed_so_far, new_mode)
        self._seen = 0

    def observe(self, decode_steps) -> None:
        if decode_steps is not None:
            self.window.append(int(decode_steps))
            self._seen += 1

    def decide(self):
        if len(self.window) < self.k:
            return None
        med = statistics.median(self.window)
        new = None
        if self.mode == 1 and med >= self.threshold:
            new = self.mb
        elif self.mode > 1 and med <= self.threshold - self.hyst:
            new = 1
        if new is not None:
            self.mode = new
            self.window.clear()
            self.switches.append((self._seen, new))
        return new


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m openpsg_tpu_torch.tools.infer")
    ap.add_argument("exp_tag", nargs="?", default=None)
    ap.add_argument("epoch", nargs="?", type=int, default=None)
    ap.add_argument("--config", default=None)
    ap.add_argument("--checkpoint", default=None, metavar="DIR",
                    help="part-checkpoint directory whose trainable groups to load")
    ap.add_argument("--test-file", default=None)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--output-dir", default="./")
    ap.add_argument("--img-scale", type=int, nargs=2, default=(1333, 1333))
    ap.add_argument("--limit", type=int, default=0, help="cap image count (0 = all)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; pass cpu for the CPU path)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace to DIR/trace.json")
    ap.add_argument("--batch-size", type=int, default=1,
                    help="images per step through infer_batch")
    ap.add_argument("--micro-batch", type=int, default=0,
                    help="images per step through the micro-batch program: one "
                         "flattened LLM prefill and decode for the chunk")
    ap.add_argument("--single-bucket", action="store_true",
                    help="pad every image to the square cap (default: aspect buckets)")
    ap.add_argument("--no-auto-micro-batch", action="store_true",
                    help="pin the flag-free path to per-image inference")
    ap.add_argument("--vis", default=None, metavar="DIR",
                    help="write {stem}_pan_seg.jpg overlays to DIR and print each "
                         "image's top-20 triplet table (needs cv2)")
    ap.add_argument("--gt-masks", action="store_true",
                    help="replace the predicted panoptic masks with the ground "
                         "truth (relation-head upper bound)")
    args = ap.parse_args(argv)
    if args.config is None:
        if not args.exp_tag:
            ap.error("need an exp_tag or --config")
        args.config = f"./work_dirs/ov_psg_{args.exp_tag}/{args.exp_tag}.py"
        if args.checkpoint is None and args.epoch is not None:
            args.checkpoint = f"./work_dirs/ov_psg_{args.exp_tag}/ckpts"
    if args.micro_batch and args.micro_batch < 2:
        ap.error("--micro-batch must be ≥ 2 (1 is the plain per-image path; "
                 "use no flag instead)")
    if args.micro_batch and args.batch_size > 1:
        ap.error("--micro-batch replaces --batch-size")
    if args.gt_masks and (args.micro_batch or args.batch_size > 1):
        ap.error("--gt-masks runs per image: drop --batch-size/--micro-batch")
    return args


def main(argv=None, model=None):
    """Run the tool; returns run stats (images, micro-batch, switches,
    submission path, seconds, each section's per-call seconds, prefetch
    time; with ``--profile`` on the card, the kernels' busy seconds in the
    model sections)."""
    args = parse_args(argv)

    from openpsg_tpu_torch import resolve_device
    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config
    from openpsg_tpu_torch.data.preprocess import (
        Preprocessor,
        aspect_buckets,
        load_image_rgb,
        resize_nearest,
    )
    from openpsg_tpu_torch.data.vocab import INSTANCE_OFFSET
    from openpsg_tpu_torch.models.detectors.psg_v4 import (
        AUTO_MB_CALIB_K,
        AUTO_MB_DECODE_STEPS,
        AUTO_MB_HYSTERESIS,
        AUTO_MB_SIZE,
        PSGv4,
    )
    from openpsg_tpu_torch.utils.image_io import image_decoder
    from openpsg_tpu_torch.utils.panoptic import rgb2id
    from openpsg_tpu_torch.utils.profiling import (
        SectionTimer,
        device_busy,
        profile_trace,
    )
    from openpsg_tpu_torch.utils.submission import SubmissionWriter, submission_records

    cfg = Config.fromfile(args.config)
    test_file = args.test_file or cfg.data.test.ann_file
    data_dir = args.data_dir or cfg.data.test.img_prefix
    if model is None:
        model = build_detector_from_config(cfg, seed=args.seed,
                                           device=resolve_device(args.device))
    print(f"device: {model.device}; image decoder: {image_decoder()}")
    is_v4 = isinstance(model, PSGv4)
    if args.micro_batch and not is_v4:
        raise SystemExit("--micro-batch is a PSG v4 path; the closed-set family runs "
                         "per image or with --batch-size")
    if args.checkpoint:
        from openpsg_tpu_torch.train.checkpoint import restore_trainable_for_inference

        if not os.path.isdir(args.checkpoint):
            raise FileNotFoundError(f"--checkpoint {args.checkpoint}: no such directory")

        step, meta = restore_trainable_for_inference(model, cfg, args.checkpoint,
                                                     epoch=args.epoch)
        print(f"restored trainable params from step {step} (epoch {meta.get('epoch')})")

    with open(test_file, "r", encoding="utf-8") as f:
        records = submission_records(json.load(f))
    if args.limit:
        records = records[: args.limit]

    H, _ = model._model_hw()
    scale = (min(args.img_scale), min(args.img_scale))
    if Preprocessor(scale=scale).bucket_hw[0] > H:
        scale = (H, H)   # tiny test models cap the bucket
    preproc = Preprocessor(scale=scale,
                           buckets=None if args.single_bucket else aspect_buckets(scale))

    writer = SubmissionWriter(args.output_dir, seed=args.seed)
    timer = SectionTimer()
    t0 = time.time()
    B = max(args.micro_batch or args.batch_size, 1)

    auto_mb = (is_v4 and not args.micro_batch and args.batch_size <= 1 and not args.gt_masks
               and not args.no_auto_micro_batch and len(records) > 1)
    ctrl = None
    if auto_mb and not model.cfg.decode_early_exit:
        print(f"[auto] decode_early_exit=False pins {model.cfg.max_new_tokens} decode "
              f"steps: using micro-batch {AUTO_MB_SIZE} (disable with "
              "--no-auto-micro-batch)")
        args.micro_batch = B = AUTO_MB_SIZE
    elif auto_mb and model.cfg.llm.act_int8:
        print(f"[auto] act_int8 program: micro-batch {AUTO_MB_SIZE} wins at every "
              "decode length — selecting it (disable with --no-auto-micro-batch)")
        args.micro_batch = B = AUTO_MB_SIZE
    elif auto_mb:
        ctrl = AutoMBController(threshold=AUTO_MB_DECODE_STEPS, k=AUTO_MB_CALIB_K,
                                hysteresis=AUTO_MB_HYSTERESIS, mb=AUTO_MB_SIZE)

    # group records by bucket (from the annotation's height/width; records
    # without them take the largest bucket), largest bucket first
    def rec_bucket(d):
        h, w = int(d.get("height") or 0), int(d.get("width") or 0)
        return preproc.bucket_for(h, w) if h and w else preproc.bucket_hw

    def build_chunks(item_list, chunk_b):
        groups = {}
        for idx, d in item_list:
            groups.setdefault(rec_bucket(d), []).append((idx, d))
        out = []   # (bucket, [(orig_idx, record), ... of ≤ chunk_b])
        for bucket in sorted(groups, key=lambda b: -b[0] * b[1]):
            items = groups[bucket]
            out += [(bucket, items[s:s + chunk_b]) for s in range(0, len(items), chunk_b)]
        return groups, out

    groups, chunks = build_chunks(list(enumerate(records)), B)
    if len(groups) > 1:
        print("buckets: " + ", ".join(f"{b[0]}x{b[1]}:{len(v)}"
                                      for b, v in sorted(groups.items())))

    def _prep_chunk(chunk):
        """→ (the chunk's preprocessed images, seconds spent)."""
        t = time.perf_counter()
        bucket, items = chunk
        exs = []
        for _, d in items:
            img = load_image_rgb(os.path.join(data_dir, d["file_name"]))
            ex = preproc(img, bucket=bucket)
            ex["ori"] = img.shape[:2]
            if args.vis:
                ex["rgb"] = img
            exs.append(ex)
        return exs, time.perf_counter() - t

    def _load_gt_objects(rec, ex):
        """GT panoptic PNG → padded bucket-size masks and mmdet-scheme ids
        (per-class instance counters from 0)."""
        # PSGv4Config nests it under the head; M2FRelationConfig at top level
        M = getattr(model.cfg, "head", model.cfg).max_objects_padded
        pan_id = rgb2id(load_image_rgb(os.path.join(data_dir, rec["pan_seg_file_name"])))
        nh, nw = ex["img_shape"]
        Hb, Wb = ex["image"].shape[:2]
        pan_pad = np.full((Hb, Wb), -1, np.int64)
        pan_pad[:nh, :nw] = resize_nearest(pan_id, (nh, nw))
        masks = np.zeros((M, Hb, Wb), bool)
        oids = np.zeros((M,), np.int64)
        valid = np.zeros((M,), bool)
        counters = {}
        for i, seg in enumerate(rec["segments_info"][:M]):
            cat = int(seg.get("category_id", seg.get("category", 0)))
            if bool(seg.get("isthing", 1)):
                occ = counters.get(cat, 0)
                counters[cat] = occ + 1
                oids[i] = cat + INSTANCE_OFFSET * occ
            else:
                oids[i] = cat
            masks[i] = pan_pad == seg["id"]
            valid[i] = masks[i].any()
        return masks, oids, valid

    # the worker prepares chunk i + 1 while the model runs chunk i
    with profile_trace(args.profile) as tracer, ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(_prep_chunk, chunks[0]) if chunks else None
        done = 0
        ci = 0
        prep_seconds = 0.0
        while ci < len(chunks):
            _, items = chunks[ci]
            with timer.section("load+preprocess"):
                exs, spent = pending.result()
                prep_seconds += spent
                # prefetch optimistically; an auto-mb switch rebuilds the
                # remaining chunks and resubmits below
                pending = pool.submit(_prep_chunk, chunks[ci + 1]) if ci + 1 < len(chunks) else None
            with timer.section("model"):
                if args.gt_masks:
                    gm, go, gv = _load_gt_objects(items[0][1], exs[0])
                    results = [model.infer_gt(exs[0]["image"], gm, go, gv)]
                elif B == 1:
                    results = [model.infer(exs[0]["image"], exs[0]["img_shape"])]
                else:
                    pads = B - len(exs)   # pad the tail chunk to the chunk size
                    imgs = np.stack([e["image"] for e in exs] + [exs[-1]["image"]] * pads)
                    hws = np.asarray([e["img_shape"] for e in exs]
                                     + [exs[-1]["img_shape"]] * pads, np.int32)
                    if args.micro_batch:
                        results = model.infer_microbatch(imgs, hws)[: len(exs)]
                    else:
                        results = model.infer_batch(imgs, hws)[: len(exs)]
            with timer.section("write"):
                for j, (ex, res) in enumerate(zip(exs, results)):
                    orig_idx, _ = items[j]
                    # crop the padding off BEFORE resizing back to the original
                    # size (nearest keeps ids intact)
                    nh, nw = ex["img_shape"]
                    pan_ori = resize_nearest(res["pan_results"][:nh, :nw],
                                             ex["ori"]).astype(np.int64)
                    writer.add(pan_ori, res["rel_results"]["object_id_list"],
                               res["rel_results"]["relation"], test_idx=orig_idx)
                    if args.vis:
                        from openpsg_tpu_torch.utils.visualize import vis

                        file_name = items[j][1]["file_name"]
                        _, table = vis(ex["rgb"], pan_ori, res["rel_results"]["object_id_list"],
                                       res["rel_results"]["relation"], model.class_names,
                                       model.relation_names, args.vis, file_name)
                        print(file_name)
                        print(table)
            if ctrl is not None:
                for res in results:
                    ctrl.observe(res.get("decode_steps"))
                new_b = ctrl.decide()
                if new_b is not None:
                    args.micro_batch = 0 if new_b == 1 else new_b
                    print(f"[auto] median decode steps crossed {AUTO_MB_DECODE_STEPS}"
                          f"{'' if new_b > 1 else f'−{AUTO_MB_HYSTERESIS}'}: switching to "
                          f"{'micro-batch %d' % new_b if new_b > 1 else 'per-image'}"
                          " (disable with --no-auto-micro-batch)")
                    if ci + 1 < len(chunks):
                        remaining = [it for _, its in chunks[ci + 1:] for it in its]
                        _, tail = build_chunks(remaining, new_b)
                        chunks = chunks[: ci + 1] + tail
                        B = new_b
                        pending.result()   # the old chunking's prefetch, discarded
                        pending = pool.submit(_prep_chunk, chunks[ci + 1])
            done += len(items)
            if done % 50 < B:
                print(f"[{done}/{len(records)}] {done / (time.time() - t0):.2f} img/s")
            ci += 1

    path = writer.finalize()
    dt = time.time() - t0
    n = len(records)
    print(f"Inference finished: {n} images in {dt:.1f}s "
          f"({n / max(dt, 1e-9):.2f} img/s). Results: {path}")
    print(f"sections: {timer.report()}")
    waited = timer.total("load+preprocess")
    print(f"prefetch: {prep_seconds:.2f}s preparing on the worker thread, "
          f"{waited:.2f}s waited for it on the main thread")
    stats = {
        "n_images": n,
        "micro_batch": int(args.micro_batch or 0),
        "mb_switches": list(ctrl.switches) if ctrl is not None else [],
        "submission": path,
        "seconds": dt,
        "sections": timer.calls,
        "prep_seconds": prep_seconds,
    }
    if tracer is not None and model.device.type == "cuda":
        busy, window = device_busy(os.path.join(args.profile, "trace.json"), "model")
        stats["busy_seconds"], stats["model_trace_seconds"] = busy, window
        print(f"profile: a CUDA kernel ran in {busy:.3f} s of the {window:.3f} s of model "
              f"sections ({busy / max(window, 1e-9):.1%})")
    return stats


if __name__ == "__main__":
    main()
