"""End-to-end check from scratch (counterpart of ``tools/selfcheck_e2e.py``):
train the tiny PSG v4 model on a synthetic PSG dataset, run inference
through the tools a user runs, and grade the submission.

    python -m openpsg_tpu_torch.tools.selfcheck_e2e [--root DIR]
        [--seg-steps 900] [--rel-steps 400] [--device cuda]

Phases:
  A. the segmenter and the class embeddings train from scratch
     (:class:`~openpsg_tpu_torch.train.segmenter_trainer.SegmenterTrainer`,
     sigmoid mode, Hungarian matching; AdamW with a cosine schedule from
     2e-3);
  B. the relation head and the LLM train (:class:`V4Trainer` with
     ``("head", "llm")``, AdamW at 2e-3, clip 1.0) (A and B:
     :func:`train_from_scratch`, which ``selfcheck_knobs`` shares);
  C. the trained weights leave through the deployment files (the
     segmenter as ``segmenter.pt``, the class embeddings as
     ``class_embeds.npy``, head and LLM as a part checkpoint), a config
     names them, ``tools.infer --config ... --checkpoint`` writes the
     submission (predicted objects, and ``--gt-masks`` for the upper bound)
     and ``tools.grade`` scores it with the strict protocol (subject and
     object class equal and mask IoU > 0.5).

The dataset is 6 images of 64² (``utils/fixture.make_fixture``): 3 train,
3 held out.  Exit code 0 iff strict R@20 > 0 on the held-out images.  Runs
on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_CONFIG = os.path.join(PORT, "configs", "psg", "tiny_v4_ov.py")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m openpsg_tpu_torch.tools.selfcheck_e2e")
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "psg_selfcheck"),
                    help="directory for the dataset, the weights and the submissions")
    ap.add_argument("--seg-steps", type=int, default=900)
    ap.add_argument("--rel-steps", type=int, default=400)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; pass cpu for the CPU path)")
    return ap.parse_args(argv)


def run(root: str, seg_steps: int = 900, rel_steps: int = 400, device="cuda", log=print):
    """Phases A-C → dict: ``scores`` and ``gt_scores`` (the grader's
    results), the trained ``pipeline``, the dataset's ``ann`` path, the
    infer tool's stats (``infer_stats``, ``gt_infer_stats``), the losses
    of each phase's first and last step, and wall seconds per phase."""
    import torch

    from openpsg_tpu_torch import resolve_device
    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config
    from openpsg_tpu_torch.data.preprocess import Preprocessor
    from openpsg_tpu_torch.data.psg_dataset import PSGDataset
    from openpsg_tpu_torch.tools import grade, infer
    from openpsg_tpu_torch.train.checkpoint import PartCheckpointer
    from openpsg_tpu_torch.utils.fixture import make_fixture

    device = resolve_device(device)
    os.makedirs(root, exist_ok=True)
    ann = make_fixture(root, n_images=6, hw=(64, 64))
    # built from the config file, so the infer tool's rebuild in phase C
    # has the same parameter structure
    pipeline = build_detector_from_config(Config.fromfile(BASE_CONFIG), seed=0, device=device)
    H, _ = pipeline._model_hw()
    pre = Preprocessor(scale=(H, H))
    M = pipeline.cfg.head.max_objects_padded
    ds = PSGDataset(ann, img_prefix=root, seg_prefix=root, split="train")
    exs = [ds.load_example(i, pre, M) for i in range(len(ds))]
    out = {"ann": ann, "pipeline": pipeline, "seconds": {}}

    trainer, st2 = train_from_scratch(pipeline, exs, seg_steps, rel_steps, device, log, out)

    # ---------------- phase C: deployment files → infer tool → grader
    log("[C] export -> tools.infer -> tools.grade (strict protocol)")
    t0 = time.perf_counter()
    seg_path = os.path.join(root, "segmenter.pt")
    torch.save({k: v.detach().cpu() for k, v in pipeline.segmenter.state_dict().items()},
               seg_path)
    ce_path = os.path.join(root, "class_embeds.npy")
    np.save(ce_path, pipeline.class_embeds.detach().cpu().numpy())
    ckpt_dir = os.path.join(root, "ckpts")
    PartCheckpointer(ckpt_dir).save(rel_steps, trainer.master, st2, meta={"epoch": 1})
    cfg_path = os.path.join(root, "selfcheck_cfg.py")
    with open(cfg_path, "w", encoding="utf-8") as f:
        # the LLM trained in phase B: only the segmenter side is frozen, so
        # the part checkpoint holds {head, llm}
        f.write(f"_base_ = [{BASE_CONFIG!r}]\n"
                f"model = dict(openseed_pretrained_path={seg_path!r},\n"
                f"             precomputed_class_embeds={ce_path!r},\n"
                "             train_cfg=dict(freeze_layers=['openseed']))\n")
    common = ["--config", cfg_path, "--checkpoint", ckpt_dir, "--test-file", ann,
              "--data-dir", root, "--img-scale", str(H), str(H), "--seed", "0",
              "--device", str(device)]
    for key, sub, extra in (("", "out", []), ("gt_", "out_gt", ["--gt-masks"])):
        sub_dir = os.path.join(root, sub)
        out[f"{key}infer_stats"] = infer.main(common + ["--output-dir", sub_dir] + extra)
        out[f"{key}scores"] = grade.main(["--submission", sub_dir, "--gt-json", ann,
                                          "--data-dir", root, "--ks", "20"])
    out["seconds"]["C"] = time.perf_counter() - t0
    s, g = out["scores"], out["gt_scores"]
    log(f"  strict R@20={s['R@20']:.1f} mR@20={s['mR@20']:.1f} | GT-mask upper bound "
        f"R@20={g['R@20']:.1f}")
    return out


def train_from_scratch(pipeline, exs, seg_steps: int, rel_steps: int, device, log, out):
    """Phases A and B on the examples ``exs`` (``PSGDataset.load_example``):
    the segmenter and the class embeddings, then the relation head and the
    LLM, trained in place in ``pipeline``.  Records in ``out`` the losses of
    every 50th segmenter step and every 100th relation step, the last of
    each included (``seg_losses``, ``rel_losses``), and the phases' wall
    seconds (``seconds["A"]``, ``seconds["B"]``).  → (the relation
    trainer, its optimizer state)."""
    from openpsg_tpu_torch.train.segmenter_trainer import SegmenterTrainer, SegTrainBatch
    from openpsg_tpu_torch.train.trainer import (
        AdamW,
        TrainBatch,
        V4Trainer,
        host_batch,
        make_cosine_schedule,
        make_optimizer,
    )

    stack = lambda k: np.stack([e[k] for e in exs])
    out.setdefault("seconds", {})

    # ---------------- phase A: segmenter and class embeddings
    log(f"[A] segmenter training, {seg_steps} steps on {len(exs)} images")
    t0 = time.perf_counter()
    # the class embeddings train too: without a pretrained language tower
    # the initial class directions are nearly collinear, and sigmoid CE
    # does not separate them in a few hundred steps
    seg = pipeline.segmenter
    seg_params = {f"segmenter.{n}": p for n, p in seg.named_parameters()}
    seg_params["class_embeds"] = pipeline.class_embeds
    seg_trainer = SegmenterTrainer(
        seg, num_classes=len(pipeline.class_names), cls_mode="sigmoid",
        apply_fn=lambda img: seg(img, pipeline.class_embeds), params=seg_params)
    seg_batch = SegTrainBatch.from_numpy(dict(
        image=stack("image"), gt_masks=stack("object_masks"),
        gt_labels=stack("object_labels").astype(np.int32), gt_valid=stack("object_valid")),
        device)
    # optax.adamw's defaults: no clip, weight decay 1e-4
    opt = AdamW(make_cosine_schedule(2e-3, seg_steps, 0.05), max_norm=float("inf"),
                weight_decay=1e-4)
    st = opt.init(seg_trainer.master)
    for i in range(seg_steps):
        d = seg_trainer.train_step(seg_batch, opt, st)
        if i % 50 == 0 or i == seg_steps - 1:
            d = {k: float(v) for k, v in d.items()}
            out.setdefault("seg_losses", []).append(d)
            log(f"  step {i}: " + " ".join(f"{k}={v:.3f}" for k, v in d.items()))
    for p in seg_params.values():
        p.requires_grad_(False)
    out["seconds"]["A"] = time.perf_counter() - t0

    # ---------------- phase B: relation head and LLM
    log(f"[B] relation training (LLM trained too), {rel_steps} steps")
    t0 = time.perf_counter()
    hc = pipeline.cfg.head
    arrays = host_batch(exs, pipeline.tokenizer, pipeline.relation_names,
                        np.random.default_rng(0), hc.sampled_qformer_batch_size,
                        hc.max_llm_forward_num, 12)
    batch = TrainBatch.from_numpy(arrays, device)
    trainer = V4Trainer(pipeline, trainable=("head", "llm"))
    opt2 = make_optimizer(lambda count: 2e-3, max_norm=1.0)
    st2 = opt2.init(trainer.master)
    for i in range(rel_steps):
        m = trainer.train_step(batch, opt2, st2)
        if i % 100 == 0 or i == rel_steps - 1:
            m = {k: float(v) for k, v in m.items()}
            out.setdefault("rel_losses", []).append(m)
            log(f"  step {i}: loss={m['loss']:.3f} llm={m['rel_llm_loss']:.4f}")
    for p in trainer.params.values():
        p.requires_grad_(False)
    out["seconds"]["B"] = time.perf_counter() - t0
    return trainer, st2


def main(argv=None) -> int:
    args = parse_args(argv)
    res = run(args.root, args.seg_steps, args.rel_steps, args.device)
    ok = res["scores"]["R@20"] > 0
    print("SELFCHECK", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
