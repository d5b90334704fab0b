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
epoch under ``<work_dir>/ckpts``; ``--resume-from DIR`` (that directory,
not ``<work_dir>/ckpts``) or ``--auto-resume`` continue from the latest
step of the port's layout or of a JAX run's orbax checkpoint (values,
AdamW count and moments: ``train/checkpoint.read_training_state``); with
``--validate`` (or a ``('val', n)`` workflow phase) panoptic PQ on the val
split after each epoch.

The groups ``train_cfg.freeze_layers`` leaves trainable are optimized
(the reference recipe: the relation head; for the family, the head and
the object class embeddings); ``optimizer.paramwise_cfg``,
the train ``Resize`` range (as scale jitter), ``--auto-scale-lr`` and the
schedule are applied as the JAX tool applies them.

Parallel runs start under ``torch.distributed.run`` with ``--launcher
pytorch`` (the reference's torchrun recipe), one rank per process:

    python -m torch.distributed.run --standalone --nproc_per_node 8 \
        -m openpsg_tpu_torch.tools.train CFG --launcher pytorch

The ranks form the config's ``tpu.mesh``: ``dp`` × ``tp`` (Megatron tp of
the LLM, ``parallel.sharding``), or with ``pp > 1`` ``dp`` × ``pp`` [×
``tp``] (GPipe stages of the LLM, ``parallel.pipeline``, and the pipelined
train step).  The global batch is ``samples_per_gpu × dp`` (which
``--auto-scale-lr`` reads); every rank draws the same host batch from the
same seeded generator and keeps its rows, so the sampling is the one
process's.  Rank 0 logs and saves; checkpoints hold whole tensors (tp and
pp parts gathered), so the infer tool restores them unchanged.  A mesh
that wants more ranks than were launched runs unsharded (dp over the
launched ranks; on one device without a launcher), as the JAX tool does.

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

class _Quiet:
    """The logger of a rank other than 0: it writes nothing."""

    def info(self, *a, **k):
        pass


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m openpsg_tpu_torch.tools.train")
    ap.add_argument("config")
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--resume-from", default=None, metavar="DIR",
                    help="resume from the latest step of this checkpoint directory: the "
                         "port's step_<N> layout (values, AdamW count and moments) or a JAX "
                         "run's orbax steps (params and the make_optimizer state, read "
                         "without JAX; needs tensorstore); later steps are saved in the "
                         "port's layout under <work_dir>/ckpts")
    ap.add_argument("--auto-resume", action="store_true",
                    help="resume from <work_dir>/ckpts when it holds a step of either layout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--diff-seed", action="store_true",
                    help="accepted for compatibility (every rank draws the same host batch)")
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
    if args.launcher not in ("none", "pytorch"):
        raise SystemExit(f"--launcher {args.launcher}: the port's parallelism runs under "
                         "python -m torch.distributed.run with --launcher pytorch "
                         "(or none for one process)")
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
        open_checkpoint,
        read_training_state,
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
    rank, world = 0, 1
    if args.launcher == "pytorch":
        from openpsg_tpu_torch.parallel.mesh import init_distributed

        rank, world, device = init_distributed("pytorch", device=args.device)
    else:
        device = resolve_device(args.device)
    work_dir = args.work_dir or cfg.get("work_dir", "./work_dirs/default")
    if rank == 0:
        os.makedirs(work_dir, exist_ok=True)
        cfg.dump(os.path.join(work_dir, os.path.basename(args.config)))
        logger = setup_logger(work_dir)
    else:
        logger = _Quiet()
    logger.info("Environment info:\n" + "\n".join(f"  {k}: {v}" for k, v in (
        ("python", sys.version.replace("\n", " ")),
        ("platform", platform.platform()),
        ("torch", torch.__version__),
        ("cuda", torch.version.cuda),
        ("numpy", np.__version__),
        ("device", f"{device}" + (f" ({torch.cuda.get_device_name(device)})"
                                  if device.type == "cuda" else "")),
    )))
    logger.info(f"config: {args.config} seed: {args.seed} launcher: {args.launcher} "
                f"ranks: {world}")

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
    mesh, dp_rank, dp_n, tp_n, pp_n = _make_mesh(mesh_cfg, args.launcher, world, is_family,
                                                 logger)
    if mesh is not None and not is_family and (tp_n > 1 or pp_n > 1):
        from openpsg_tpu_torch.parallel.pipeline import shard_pipeline
        from openpsg_tpu_torch.parallel.sharding import assert_llm_sharded, shard_params

        (shard_pipeline if pp_n > 1 else shard_params)(model.llm, mesh)
        if tp_n > 1:
            logger.info(f"LLM tensor-sharded tensors on tp={tp_n}: "
                        f"{assert_llm_sharded(model.llm, mesh)}")
        if pp_n > 1:
            logger.info(f"LLM pipeline stage layers: {model.llm.core.stage_range} of "
                        f"{model.cfg.llm.n_layers}")
    spg = cfg.data.get("samples_per_gpu", 1)
    batch_size = spg * dp_n
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
    trainer = (M2FTrainer if is_family else V4Trainer)(model, trainable=trainable, mesh=mesh)

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
    step_fn = functools.partial(trainer.train_step, optimizer=opt)
    if pp_n > 1 and mesh is not None:
        step_fn = trainer.make_pipelined_train_step(opt, mesh, n_micro=mesh_cfg.get("pp_micro"))

    ckpt_dir = os.path.join(work_dir, "ckpts")
    ckpt = PartCheckpointer(ckpt_dir, max_keep=cfg.checkpoint_config.get("max_keep_ckpts", 3))
    start_step = 0
    # --resume-from reads the directory it names (the JAX tool reads
    # <work_dir>/ckpts whatever it is given: F11)
    resume = args.resume_from or (ckpt_dir if args.auto_resume and open_checkpoint(ckpt_dir)
                                  .latest_step() is not None else None)
    if resume:
        params, state, _, start_step = read_training_state(model, resume, trainer.master,
                                                           device=device)
        trainer.load_master(trainer.localize(params))
        opt_state.update(count=state["count"], mu=trainer.localize(state["mu"]),
                         nu=trainer.localize(state["nu"]))
        logger.info(f"resumed from {resume} step {start_step} (AdamW count {state['count']})")

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
            if dp_n > 1:
                # the global batch's pair sampling, then this dp rank's rows
                arrays = (m2f_host_batch(examples) if is_family else host_batch(
                    examples, model.tokenizer, model.relation_names, nprng, S, T, L_LAB))
                rows = slice(dp_rank * spg, (dp_rank + 1) * spg)
                cls = M2FTrainBatch if is_family else TrainBatch
                batch = cls.from_numpy({k: v[rows] for k, v in arrays.items()}, device)
            elif is_family:
                batch = M2FTrainBatch.from_numpy(m2f_host_batch(examples), device)
            else:
                batch = TrainBatch.from_numpy(host_batch(
                    examples, model.tokenizer, model.relation_names, nprng, S, T, L_LAB),
                    device)
            times = {"data": (time.perf_counter() - t0) * 1e3} if args.stage_times else None
            metrics = step_fn(batch, opt_state=opt_state, stage_times=times)
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
        # whole tensors: every rank takes part in the gather, rank 0 writes
        master = trainer.whole(trainer.master)
        state = dict(opt_state, mu=trainer.whole(opt_state["mu"]),
                     nu=trainer.whole(opt_state["nu"]))
        if rank == 0:
            ckpt.save(global_step, master, state,
                      meta={"epoch": epoch + 1, "classes": model.class_names, **_ckpt_meta()})
        stats["saved_steps"].append(global_step)
        if args.validate and pp_n > 1 and mesh is not None:
            logger.info("validation skipped: a pipeline-cut LLM does not decode")
        elif args.validate and (rank == 0 or tp_n > 1):
            # a tp-sharded LLM decodes on all its ranks together
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
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()
    stats.update(rank=rank, world=world)
    return stats


def _make_mesh(mesh_cfg, launcher: str, world: int, is_family: bool, logger):
    """``tpu.mesh`` over the launched ranks → (mesh or None, this rank's dp
    index, dp, tp, pp).  A mesh that wants more ranks than were launched
    runs unsharded: dp over the launched ranks (JAX: the global batch over
    every device), on one device without a launcher."""
    dp, tp, pp = (int(mesh_cfg.get(k, 1) or 1) for k in ("dp", "tp", "pp"))
    wants = dp * tp * pp
    if launcher == "none":
        if wants > 1:
            logger.info(f"tpu.mesh {dict(mesh_cfg)} wants {wants} ranks, have 1 — runs "
                        "unsharded on one device (launch with torch.distributed.run and "
                        "--launcher pytorch for the mesh)")
        return None, 0, 1, 1, 1
    from openpsg_tpu_torch.parallel.mesh import axis_group, make_mesh

    if wants > world:
        logger.info(f"tpu.mesh {dict(mesh_cfg)} wants {wants} ranks, have {world} — runs "
                    f"unsharded: dp over the {world} ranks")
        dp, tp, pp = world, 1, 1
    elif wants < world:
        raise SystemExit(f"tpu.mesh {dict(mesh_cfg)} holds {wants} ranks but {world} were "
                         "launched: set --nproc_per_node to dp * tp * pp")
    if pp > 1:
        if is_family:
            raise SystemExit("tpu.mesh.pp applies to the v4 (LLM) recipe only")
        from openpsg_tpu_torch.parallel.pipeline import make_dp_pp_mesh

        mesh = make_dp_pp_mesh(pp=pp, dp=dp, tp=tp)
        logger.info(f"mesh: {{'dp': {dp}, 'pp': {pp}" + (f", 'tp': {tp}}}" if tp > 1 else "}")
                    + " (GPipe pp" + ("×tp" if tp > 1 else "") + ")")
    else:
        if is_family and tp > 1:
            raise SystemExit("tpu.mesh.tp applies to the v4 (LLM) recipe only")
        mesh = make_mesh(dp=dp, tp=tp)
        logger.info(f"mesh: {{'dp': {dp}, 'tp': {tp}}}")
    return mesh, axis_group(mesh, "dp")[1], dp, tp, pp


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
