"""Training tool (counterpart of ``tools/train.py``).

    python -m openpsg_tpu_torch.tools.train <config> [--work-dir D] [--max-steps N]
        [--validate] [--device cpu] [--resume-from DIR | --auto-resume] ...

Flow: load the config (``replace_cfg_vals``, the ``MMDET_DATASETS``
override, ``--cfg-options``), dump it into the work directory beside a
timestamped log, build the model (seeded random weights), read the train
split, then train: per step a host batch (``PSGDataset.iter_train``; for
PSG v4 pairs sampled by ``sample_training_pairs``), one step of the
model's trainer (:class:`V4Trainer` for PSG v4, :class:`M2FTrainer` for the
closed-set v1-v3 family, as the JAX tool chooses), a log line every
``log_config.interval`` steps in the reference's format; a part
checkpoint (the trainable groups and the optimizer state only) after each
epoch under ``<work_dir>/ckpts``; with ``--validate`` (or a ``('val', n)``
workflow phase) panoptic PQ on the val split after each epoch.

The groups ``train_cfg.freeze_layers`` leaves trainable are optimized
(the reference recipe: the relation head; for the family, the head and
the object class embeddings); ``optimizer.paramwise_cfg``,
the train ``Resize`` range (as scale jitter), ``--auto-scale-lr`` and the
schedule are applied as the JAX tool applies them.  The port trains on one
device: a ``tpu.mesh`` asking for more runs unsharded, and ``--launcher``
other than ``none`` is refused (both wait for the parallelism slice).

Runs on the card unless ``--device cpu`` is given.  ``--stage-times``
splits each step into data, segmenter, head, LLM forward and backward
(PSG v4; the family's backward is in ``head``), and optimizer,
synchronizing the card around each stage.  ``main(argv,
model=...)`` takes a ready model in place of building one and returns the
run's statistics.
"""

from __future__ import annotations

import argparse
import functools
import os
import subprocess
import sys
import time

import numpy as np

PARALLEL_SLICE = ("the dp/tp/pp meshes come with the port's parallelism slice "
                  "(ROADMAP 'Port: still to do')")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m openpsg_tpu_torch.tools.train")
    ap.add_argument("config")
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--resume-from", default=None, metavar="DIR",
                    help="resume from the latest step of this checkpoint directory")
    ap.add_argument("--auto-resume", action="store_true",
                    help="resume from <work_dir>/ckpts when it holds a step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--diff-seed", action="store_true",
                    help="accepted for compatibility (one process: no effect)")
    ap.add_argument("--max-steps", type=int, default=0, help="debug cap")
    ap.add_argument("--validate", action="store_true",
                    help="panoptic PQ on the val split after each epoch")
    ap.add_argument("--val-limit", type=int, default=50)
    ap.add_argument("--cfg-options", nargs="*", default=[],
                    help="k=v config overrides (mmcv DictAction semantics: int/float/"
                         "bool/None typing, a,b,c lists, nested [..] / (..) brackets)")
    ap.add_argument("--auto-scale-lr", action="store_true",
                    help="scale lr by global batch / auto_scale_lr.base_batch_size")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; pass cpu for the CPU path)")
    ap.add_argument("--stage-times", action="store_true",
                    help="time each step's stages, synchronizing the card around each")
    ap.add_argument("--launcher", default="none",
                    choices=["none", "jax", "pytorch", "slurm", "mpi"])
    ap.add_argument("--local_rank", "--local-rank", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--no-validate", action="store_true",
                    help="accepted for compatibility (validation is opt-in)")
    ap.add_argument("--deterministic", action="store_true",
                    help="accepted for compatibility")
    ap.add_argument("--gpus", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--gpu-ids", "--gpu_ids", type=int, nargs="+", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--gpu-id", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.gpus is not None or args.gpu_ids is not None or args.gpu_id is not None:
        print("WARNING: --gpus/--gpu-ids/--gpu-id are deprecated (reference semantics) "
              "and ignored: the tool trains on --device", file=sys.stderr)
    return args


def _parse_cfg_value(val: str):
    """mmcv ``DictAction`` value semantics without eval: int/float/bool/None
    typing, comma lists, nested ``[..]`` / ``(..)`` brackets."""
    def atom(s: str):
        s = s.strip()
        try:
            return int(s)
        except ValueError:
            pass
        try:
            return float(s)
        except ValueError:
            pass
        low = s.lower()
        if low in ("true", "false"):
            return low == "true"
        if low in ("none", "null"):
            return None
        if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
            return s[1:-1]
        return s

    def split_top(s: str):
        parts, depth, cur = [], 0, ""
        for ch in s:
            if ch in "[(":
                depth += 1
            elif ch in ")]":
                depth -= 1
            if ch == "," and depth == 0:
                parts.append(cur)
                cur = ""
            else:
                cur += ch
        parts.append(cur)
        return parts

    def outer_pair(s: str) -> bool:
        # True iff s is ONE bracket group: the bracket opened at s[0]
        # closes exactly at s[-1] ('(1,2),(3,4)' is not)
        depth = 0
        for i, ch in enumerate(s):
            if ch in "[(":
                depth += 1
            elif ch in ")]":
                depth -= 1
                if depth == 0:
                    return i == len(s) - 1
        return False

    def parse(s: str):
        s = s.strip()
        if s.startswith("[") and s.endswith("]") and outer_pair(s):
            inner = s[1:-1].strip()
            return [parse(p) for p in split_top(inner)] if inner else []
        if s.startswith("(") and s.endswith(")") and outer_pair(s):
            inner = s[1:-1].strip()
            return tuple(parse(p) for p in split_top(inner)) if inner else ()
        if "," in s:
            parts = split_top(s)
            if len(parts) > 1:
                return [parse(p) for p in parts]
        return atom(s)

    return parse(val)


@functools.lru_cache(maxsize=1)
def _git_hash() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ).stdout.strip()[:7] or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _ckpt_meta():
    """The version + git hash every checkpoint's meta carries."""
    import openpsg_tpu_torch

    return {"version": openpsg_tpu_torch.__version__ + "+" + _git_hash()}


def _scale_jitter(cfg):
    """The train pipeline's ``Resize`` range → (short lo, short hi) or None."""
    for t in cfg.data.train.get("pipeline", []) or []:
        if t.get("type") == "Resize" and t.get("multiscale_mode") == "range":
            scales = t.get("img_scale") or []
            if len(scales) == 2:
                shorts = sorted(min(s) for s in scales)
                return int(shorts[0]), int(shorts[1])
    return None


def main(argv=None, model=None):
    """Run the tool → stats: steps, per-step seconds, per-step stage ms
    (with ``--stage-times``), logged metrics, the steps saved, validation
    results, peak device memory (on the card)."""
    args = parse_args(argv)
    if args.launcher != "none":
        raise SystemExit(f"--launcher {args.launcher}: the port trains in one process on one "
                         f"device; {PARALLEL_SLICE}")
    import platform

    import torch

    from openpsg_tpu_torch import resolve_device
    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config, replace_cfg_vals, update_data_root
    from openpsg_tpu_torch.data.preprocess import Preprocessor
    from openpsg_tpu_torch.data.psg_dataset import PSGDataset
    from openpsg_tpu_torch.train.checkpoint import (
        PartCheckpointer,
        freeze_keys_from_config,
        trainable_groups,
    )
    from openpsg_tpu_torch.train.trainer import (
        M2FTrainBatch,
        M2FTrainer,
        TrainBatch,
        V4Trainer,
        host_batch,
        m2f_host_batch,
        make_lr_schedule,
        make_optimizer,
        paramwise_multipliers,
    )
    from openpsg_tpu_torch.utils.logging import param_table, setup_logger

    cfg = update_data_root(replace_cfg_vals(Config.fromfile(args.config)))
    if args.cfg_options:
        opts = dict(kv.split("=", 1) for kv in args.cfg_options)
        cfg.merge_from_dict({k: _parse_cfg_value(v) for k, v in opts.items()})

    from openpsg_tpu_torch.models.detectors.mask2former_relation import DETECTOR_TYPES

    is_family = cfg.model.get("type") in DETECTOR_TYPES
    device = resolve_device(args.device)
    work_dir = args.work_dir or cfg.get("work_dir", "./work_dirs/default")
    os.makedirs(work_dir, exist_ok=True)
    cfg.dump(os.path.join(work_dir, os.path.basename(args.config)))
    logger = setup_logger(work_dir)
    logger.info("Environment info:\n" + "\n".join(f"  {k}: {v}" for k, v in (
        ("python", sys.version.replace("\n", " ")),
        ("platform", platform.platform()),
        ("torch", torch.__version__),
        ("cuda", torch.version.cuda),
        ("numpy", np.__version__),
        ("device", f"{device}" + (f" ({torch.cuda.get_device_name(device)})"
                                  if device.type == "cuda" else "")),
    )))
    logger.info(f"config: {args.config} seed: {args.seed}")

    # mmcv workflow: a ('val', n) phase enables the per-epoch PQ pass
    workflow = cfg.get("workflow", [("train", 1)]) or [("train", 1)]
    phases = [str(p[0] if isinstance(p, (list, tuple)) else p) for p in workflow]
    if any(ph not in ("train", "val") for ph in phases):
        raise SystemExit(f"unsupported workflow phases: {workflow}")
    if "val" in phases and not args.no_validate:
        if not args.validate:
            logger.info(f"workflow {workflow}: enabling per-epoch validation")
        args.validate = True

    if model is None:
        model = build_detector_from_config(cfg, seed=args.seed, device=device)
    logger.info("\n" + param_table(model.param_groups()))

    data_cfg = cfg.data.train
    dataset = PSGDataset(ann_file=data_cfg.ann_file, img_prefix=data_cfg.img_prefix,
                         seg_prefix=data_cfg.seg_prefix, split="train")
    logger.info(f"train dataset: {len(dataset)} images")

    mesh_cfg = dict(cfg.get("tpu", {}) or {}).get("mesh") or {}
    wants = int(mesh_cfg.get("dp", 1)) * int(mesh_cfg.get("tp", 1)) * int(mesh_cfg.get("pp", 1))
    if wants > 1:
        logger.info(f"tpu.mesh {dict(mesh_cfg)} wants {wants} devices; the port runs "
                    f"unsharded on one device ({PARALLEL_SLICE})")
    batch_size = cfg.data.get("samples_per_gpu", 1)
    steps_per_epoch = max(len(dataset) // batch_size, 1)
    max_epochs = cfg.runner.get("max_epochs", 12)

    base_lr = cfg.optimizer.lr
    if args.auto_scale_lr:
        asl = dict(cfg.get("auto_scale_lr", {}) or {})
        base_batch = int(asl.get("base_batch_size", 8))  # 8 GPUs x 1 image
        scaled = base_lr * batch_size / base_batch
        logger.info(f"auto-scale-lr: {base_lr} -> {scaled} (batch {batch_size} / base {base_batch})")
        base_lr = scaled
    sched = make_lr_schedule(
        base_lr=base_lr,
        warmup_iters=cfg.lr_config.get("warmup_iters", 500),
        warmup_ratio=cfg.lr_config.get("warmup_ratio", 1e-3),
        step_epochs=tuple(cfg.lr_config.get("step", [6, 10])),
        steps_per_epoch=steps_per_epoch,
    )

    trainable = trainable_groups(cfg)
    logger.info(f"trainable groups: {list(trainable)} frozen: "
                f"{sorted(freeze_keys_from_config(cfg))}")
    trainer = (M2FTrainer if is_family else V4Trainer)(model, trainable=trainable)

    lr_mult = decay_mult = None
    pw = dict(cfg.optimizer.get("paramwise_cfg", {}) or {})
    if pw:
        lr_mult, decay_mult = paramwise_multipliers(
            trainer.jax_paths(), custom_keys=dict(pw.get("custom_keys", {}) or {}),
            norm_decay_mult=pw.get("norm_decay_mult"))
        logger.info(f"paramwise_cfg: {sum(m != 1.0 for m in lr_mult.values())} tensors "
                    f"lr-scaled, {sum(m == 0.0 for m in decay_mult.values())} tensors no-decay")
    opt = make_optimizer(sched, max_norm=cfg.optimizer_config.grad_clip.get("max_norm", 0.01),
                         weight_decay=cfg.optimizer.get("weight_decay", 0.05),
                         lr_mult=lr_mult, decay_mult=decay_mult)
    opt_state = opt.init(trainer.master)

    ckpt_dir = os.path.join(work_dir, "ckpts")
    ckpt = PartCheckpointer(ckpt_dir, max_keep=cfg.checkpoint_config.get("max_keep_ckpts", 3))
    start_step = 0
    resume = args.resume_from or (ckpt_dir if args.auto_resume and ckpt.latest_step()
                                  is not None else None)
    if resume:
        params, opt_state, _, start_step = PartCheckpointer(resume).restore(device=device)
        trainer.load_master(params)
        logger.info(f"resumed from {resume} step {start_step}")

    H, _ = model._model_hw()
    preproc = Preprocessor(scale=(H, H))
    if is_family:
        M = model.cfg.max_objects_padded
    else:
        hc = model.cfg.head
        M, S, T = hc.max_objects_padded, hc.sampled_qformer_batch_size, hc.max_llm_forward_num
    L_LAB = 16
    nprng = np.random.default_rng(args.seed)
    scale_jitter = _scale_jitter(cfg)
    if scale_jitter:
        logger.info(f"train scale jitter: short side in {scale_jitter}")

    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    interval = cfg.log_config.get("interval", 50)
    stats = {"step_seconds": [], "stage_ms": [], "metrics": [], "val": [], "saved_steps": []}
    global_step = start_step
    t_last = time.time()
    done = False
    for epoch in range(max_epochs):
        batches = dataset.iter_train(preproc, M, batch_size, seed=args.seed + epoch,
                                     scale_jitter=scale_jitter)
        while not done:
            t0 = time.perf_counter()
            examples = next(batches, None)
            if examples is None:
                break
            if is_family:
                batch = M2FTrainBatch.from_numpy(m2f_host_batch(examples), device)
            else:
                batch = TrainBatch.from_numpy(host_batch(
                    examples, model.tokenizer, model.relation_names, nprng, S, T, L_LAB),
                    device)
            times = {"data": (time.perf_counter() - t0) * 1e3} if args.stage_times else None
            metrics = trainer.train_step(batch, opt, opt_state, times)
            sync()
            stats["step_seconds"].append(time.perf_counter() - t0)
            if times is not None:
                stats["stage_ms"].append(times)
            global_step += 1
            if global_step % interval == 0:
                m = {k: float(v) for k, v in metrics.items()}
                stats["metrics"].append(m)
                dt = (time.time() - t_last) / interval
                t_last = time.time()
                in_epoch = (global_step - 1) % steps_per_epoch + 1
                split = "" if times is None else " " + " ".join(
                    f"{k}_ms: {v:.1f}" for k, v in times.items())
                logger.info(f"Epoch [{epoch + 1}][{in_epoch}/{steps_per_epoch}] time: {dt:.3f}s "
                            + " ".join(f"{k}: {v:.4f}" for k, v in sorted(m.items())) + split)
            done = bool(args.max_steps) and global_step >= args.max_steps
        ckpt.save(global_step, trainer.master, opt_state,
                  meta={"epoch": epoch + 1, "classes": model.class_names, **_ckpt_meta()})
        stats["saved_steps"].append(global_step)
        if args.validate:
            with torch.no_grad():
                pq = _run_pq_validation(cfg, model, preproc, args.val_limit)
            stats["val"].append(pq)
            logger.info(f"Epoch [{epoch + 1}] val " + " ".join(f"{k}: {v:.2f}" for k, v in pq.items()))
        if done:
            break
    ckpt.close()
    stats["steps"] = global_step - start_step
    if device.type == "cuda":
        stats["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    logger.info("training done")
    return stats


def _run_pq_validation(cfg, model, preproc, limit):
    """Panoptic PQ over up to ``limit`` val images (the reference's
    ``evaluation=dict(metric=['PQ'])``): each prediction resized nearest to
    the original image, GT ids numbered per class in segment order."""
    from openpsg_tpu_torch.data.preprocess import load_image_rgb, resize_nearest
    from openpsg_tpu_torch.data.psg_dataset import PSGDataset
    from openpsg_tpu_torch.data.vocab import INSTANCE_OFFSET
    from openpsg_tpu_torch.eval.pq import VOID, panoptic_quality
    from openpsg_tpu_torch.utils.panoptic import rgb2id

    val_cfg = cfg.data.val if "val" in cfg.data else cfg.data.test
    ds = PSGDataset(ann_file=val_cfg.ann_file, img_prefix=val_cfg.img_prefix,
                    seg_prefix=val_cfg.seg_prefix, split="val")

    def pairs():
        for rec in ds.records[:limit]:
            if not rec.pan_seg_file_name:
                continue
            img = load_image_rgb(os.path.join(ds.img_prefix, rec.file_name))
            ex = preproc(img)
            res = model.infer(ex["image"].astype(np.float32), ex["img_shape"])
            pred = resize_nearest(res["pan_results"], img.shape[:2]).astype(np.int64)
            gt_ids = rgb2id(load_image_rgb(os.path.join(ds.seg_prefix, rec.pan_seg_file_name)))
            gt = np.full(gt_ids.shape, VOID, np.int64)
            counters = {}
            for seg in rec.segments_info:
                c = int(seg["category"])
                k = counters.get(c, 0)
                counters[c] = k + 1
                gt[gt_ids == seg["id"]] = c + INSTANCE_OFFSET * k
            yield pred, gt

    res = panoptic_quality(pairs())
    return {k: float(v) for k, v in res.items() if not k.startswith("per_class")}


if __name__ == "__main__":
    main()
