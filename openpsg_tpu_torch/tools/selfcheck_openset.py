"""Open-set (zero-shot predicate) check from scratch (counterpart of
``tools/selfcheck_openset.py``): the paper's headline claim, end to end.

    python -m openpsg_tpu_torch.tools.selfcheck_openset [--root DIR]
        [--rel-steps 400] [--device cuda]

The v3 open-vocabulary head embeds each predicate's text through its LLM
trunk and scores pairs against that dynamic classifier, so its parameters
do not depend on the predicate list.  Phases:

  A. the v3 OV head of ``tiny_v3_ov.py`` and the object class embeddings
     train (:class:`~openpsg_tpu_torch.train.trainer.M2FTrainer`; AdamW over
     a cosine schedule from 2e-3, optax.adamw's defaults) on a fixture
     whose training images use only ``TRAIN_NAMES``; the relation target is
     rebuilt at those 8 predicates;
  B. the weights leave through the deployment files: ``segmenter.pt``, a
     part checkpoint holding ``head`` and ``object_cls_embed``, and a config
     whose ``relation_classes`` appends two held-out names; the token
     overlap of each held-out name with the trained names is measured on
     the prompt tokenizer (the hard tier must share none);
  C. ``tools.infer --gt-masks`` on the extended config (the checkpoint
     restores unchanged);
  D. ``tools.grade --per-predicate``: each held-out triplet's rank on its
     ground-truth pair, its recall against chance, the tier contrast.

Two tiers: EASY ("standing on") shares the token "on" with a trained
predicate, so its classifier direction carries what "on" learned; HARD
("kissing") shares no token, and with a trunk trained from scratch it has
no meaning to transfer: a negative control.  Exit code 0 iff the easy
tier's R@10 and the closed-set predicate's R@10 beat chance and the easy
median rank is below half the hard median rank (the JAX tool's rule).
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_CONFIG = os.path.join(PORT, "configs", "psg", "tiny_v3_ov.py")

# the trained predicate subset (PSG names, so the prompt tokenizer covers
# them) and the two held-out names
TRAIN_NAMES = [
    "on", "in", "beside", "over",
    "hanging from", "attached to", "looking at", "walking on",
]
HELD_OUT = "standing on"
HELD_OUT_HARD = "kissing"   # no word in common with a trained name

# fixture objects: 0 person, 1 dog, 2 sky.  Training images label (person,
# sky) "on", (dog, person) "looking at" and (sky, dog) "over"; the held-out
# images relabel (person, sky) with the easy name and (sky, dog) with the
# hard one
TRAIN_RELS = [[0, 2, TRAIN_NAMES.index("on")],
              [1, 0, TRAIN_NAMES.index("looking at")],
              [2, 1, TRAIN_NAMES.index("over")]]
HELDOUT_ID = len(TRAIN_NAMES)              # indices in the extended list
HELDOUT_HARD_ID = len(TRAIN_NAMES) + 1
TEST_RELS = [[0, 2, HELDOUT_ID],
             [1, 0, TRAIN_NAMES.index("looking at")],
             [2, 1, HELDOUT_HARD_ID]]

LR, LR_ALPHA = 2e-3, 0.05   # optax.cosine_decay_schedule(2e-3, rel_steps, 0.05)


def lr_schedule(rel_steps: int):
    from openpsg_tpu_torch.train.trainer import make_cosine_schedule

    return make_cosine_schedule(LR, rel_steps, LR_ALPHA)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m openpsg_tpu_torch.tools.selfcheck_openset")
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "psg_openset"),
                    help="directory for the dataset, the weights and the submission")
    ap.add_argument("--rel-steps", type=int, default=400)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; pass cpu for the CPU path)")
    return ap.parse_args(argv)


def run(root: str, rel_steps: int = 400, device="cuda", log=print):
    """Phases A-D → dict: ``ok`` (the exit rule), ``summary`` (the printed
    report), ``scores`` (the grader's), ``held_ranks`` / ``hard_ranks``,
    ``overlap``, ``chance10``, the trained ``pipeline``, the paths (``ann``,
    ``ext_cfg``, ``ckpt_dir``, ``seg_path``, ``out_dir``), ``losses`` and
    wall ``seconds`` per phase."""
    import torch

    from openpsg_tpu_torch import resolve_device
    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config
    from openpsg_tpu_torch.data.preprocess import Preprocessor
    from openpsg_tpu_torch.data.psg_dataset import PSGDataset
    from openpsg_tpu_torch.models.relation.tokenizer import build_prompt_tokenizer
    from openpsg_tpu_torch.tools import grade, infer
    from openpsg_tpu_torch.train.checkpoint import PartCheckpointer
    from openpsg_tpu_torch.train.trainer import AdamW, M2FTrainBatch, M2FTrainer, m2f_host_batch
    from openpsg_tpu_torch.utils.fixture import make_fixture

    device = resolve_device(device)
    os.makedirs(root, exist_ok=True)
    n_images = 6                      # 3 train, 3 held out
    ann = make_fixture(root, n_images=n_images, hw=(64, 64),
                       relations=lambda i: TRAIN_RELS if i < n_images // 2 else TEST_RELS)
    out = {"ann": ann, "seconds": {}, "losses": []}

    # ---------------- phase A: train on the predicate subset
    log(f"[A] v3 OV relation training on {len(TRAIN_NAMES)} predicates "
        f"(held out: {HELD_OUT!r}, {HELD_OUT_HARD!r}), {rel_steps} steps")
    t0 = time.perf_counter()
    train_cfg = os.path.join(root, "train_cfg.py")
    with open(train_cfg, "w", encoding="utf-8") as f:
        f.write(f"_base_ = [{BASE_CONFIG!r}]\n"
                f"model = dict(relation_head=dict(relation_classes={TRAIN_NAMES!r}))\n")
    pipeline = build_detector_from_config(Config.fromfile(train_cfg), seed=0, device=device)
    assert pipeline.cfg.head_version == "v3" and pipeline.cfg.head_v3.ov_relation
    out["pipeline"] = pipeline
    H, _ = pipeline._model_hw()
    M = pipeline.cfg.max_objects_padded
    R = len(TRAIN_NAMES)
    pre = Preprocessor(scale=(H, H))
    ds = PSGDataset(ann, img_prefix=root, seg_prefix=root, split="train")
    exs = [ds.load_example(i, pre, M) for i in range(len(ds))]
    # the dataset pads the target to the 56 PSG predicates: training sees
    # the trained count only
    arrays = m2f_host_batch(exs)
    arrays["relation_target"] = np.zeros((len(exs), M, M, R), np.float32)
    for s, o, r in TRAIN_RELS:
        arrays["relation_target"][:, s, o, r] = 1.0
    batch = M2FTrainBatch.from_numpy(arrays, device)

    trainer = M2FTrainer(pipeline)
    # optax.adamw's defaults: no clip, weight decay 1e-4
    opt = AdamW(lr_schedule(rel_steps), max_norm=float("inf"), weight_decay=1e-4)
    st = opt.init(trainer.master)
    for i in range(rel_steps):
        m = trainer.train_step(batch, opt, st)
        if i % 100 == 0 or i == rel_steps - 1:
            m = {k: float(v) for k, v in m.items()}
            out["losses"].append(m)
            log(f"  step {i}: loss={m['loss']:.3f} recall@20={m['relation.recall@20']:.2f}")
    for p in trainer.params.values():
        p.requires_grad_(False)
    out["seconds"]["A"] = time.perf_counter() - t0

    # ---------------- phase B: export through the deployment files
    log("[B] export: segmenter.pt + part checkpoint + extended config")
    t0 = time.perf_counter()
    seg_path = os.path.join(root, "segmenter.pt")
    torch.save({k: v.detach().cpu() for k, v in pipeline.segmenter.state_dict().items()},
               seg_path)
    ckpt_dir = os.path.join(root, "ckpts")
    PartCheckpointer(ckpt_dir).save(rel_steps, trainer.master, st, meta={"epoch": 1})
    # the OV head's parameters do not depend on the predicate count: the
    # extended config restores the same checkpoint
    ext_cfg = os.path.join(root, "openset_cfg.py")
    with open(ext_cfg, "w", encoding="utf-8") as f:
        f.write(f"_base_ = [{BASE_CONFIG!r}]\n"
                "model = dict(\n"
                f"    relation_head=dict(relation_classes="
                f"{TRAIN_NAMES + [HELD_OUT, HELD_OUT_HARD]!r}),\n"
                f"    segmenter_pretrained_path={seg_path!r},\n"
                ")\n")
    out.update(seg_path=seg_path, ckpt_dir=ckpt_dir, ext_cfg=ext_cfg)

    # the tiers' lexical claims, measured on the prompt tokenizer
    ptok = build_prompt_tokenizer()
    train_tok = {t for n in TRAIN_NAMES for t in ptok.encode(n)}
    overlap = {name: sorted(set(ptok.encode(name)) & train_tok)
               for name in (HELD_OUT, HELD_OUT_HARD)}
    out["overlap"] = overlap
    log(f"  token overlap vs training predicates: easy {HELD_OUT!r} -> {overlap[HELD_OUT]}, "
        f"hard {HELD_OUT_HARD!r} -> {overlap[HELD_OUT_HARD]}")
    assert overlap[HELD_OUT_HARD] == [], (
        "hard tier must share NO token with training predicates", overlap)
    out["seconds"]["B"] = time.perf_counter() - t0

    # ---------------- phase C: the infer tool with the extended names
    log("[C] tools.infer --gt-masks with the extended predicate list")
    t0 = time.perf_counter()
    out_dir = os.path.join(root, "out")
    out["out_dir"] = out_dir
    out["infer_stats"] = infer.main([
        "--config", ext_cfg, "--checkpoint", ckpt_dir, "--test-file", ann,
        "--data-dir", root, "--output-dir", out_dir, "--img-scale", str(H), str(H),
        "--seed", "0", "--gt-masks", "--device", str(device)])
    out["seconds"]["C"] = time.perf_counter() - t0

    # ---------------- phase D: grade; the held-out ranks
    log("[D] tools.grade --per-predicate")
    t0 = time.perf_counter()
    scores = grade.main(["--submission", out_dir, "--gt-json", ann, "--data-dir", root,
                         "--ks", "10", "20", "--per-predicate"])
    out["scores"] = scores
    with open(os.path.join(out_dir, "submission", "relation.json"), encoding="utf-8") as f:
        sub = json.load(f)

    def ranks_of(pred_id, pair):
        ranks = []
        for rec in sub:
            r = [i for i, (s, o, p) in enumerate(rec["relations"])
                 if p - 1 == pred_id and (s, o) == pair]
            ranks.append(1 + (r[0] if r else len(rec["relations"])))
        return ranks

    held_ranks = ranks_of(HELDOUT_ID, tuple(TEST_RELS[0][:2]))
    hard_ranks = ranks_of(HELDOUT_HARD_ID, tuple(TEST_RELS[2][:2]))
    n_obj = 3
    n_cand = n_obj * (n_obj - 1) * (len(TRAIN_NAMES) + 2)
    chance10 = 100.0 * min(10 / n_cand, 1.0)
    held10 = scores["perR@10"].get(HELDOUT_ID, 0.0)
    hard10 = scores["perR@10"].get(HELDOUT_HARD_ID, 0.0)
    closed10 = scores["perR@10"].get(TRAIN_RELS[1][2], 0.0)
    easy_median = float(np.median(held_ranks))
    hard_median = float(np.median(hard_ranks))
    out["summary"] = {
        "easy_tier": {
            "held_out_predicate": HELD_OUT,
            "token_overlap": overlap[HELD_OUT],
            "zero_shot_R@10": held10,
            "zero_shot_R@20": scores["perR@20"].get(HELDOUT_ID, 0.0),
            "rank_per_image": held_ranks,
            "median_rank": easy_median,
        },
        "hard_tier": {
            "held_out_predicate": HELD_OUT_HARD,
            "token_overlap": overlap[HELD_OUT_HARD],
            "zero_shot_R@10": hard10,
            "zero_shot_R@20": scores["perR@20"].get(HELDOUT_HARD_ID, 0.0),
            "rank_per_image": hard_ranks,
            "median_rank": hard_median,
            "chance_median_rank": (n_cand + 1) / 2,
            "note": "negative control: a trunk trained from scratch gives an overlap-free "
                    "name no meaning to transfer (the semantic tier needs pretrained LLM "
                    "weights)",
        },
        "closed_set_R@10(looking at)": closed10,
        "chance_R@10_pct": round(chance10, 1),
        "candidates_per_image": n_cand,
    }
    out.update(held_ranks=held_ranks, hard_ranks=hard_ranks, chance10=chance10)
    # the easy tier beats chance, the closed-set predicate stays above it,
    # and the easy tier outranks the hard one decisively: the recall rides
    # the text path, not a pair-level prior (both tiers sit on equally
    # well-trained ground-truth pairs)
    out["ok"] = bool(held10 > chance10 and closed10 > chance10
                     and easy_median < hard_median / 2)
    out["seconds"]["D"] = time.perf_counter() - t0
    log(json.dumps(out["summary"]))
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    res = run(args.root, args.rel_steps, args.device)
    print("OPENSET", "PASS" if res["ok"] else "FAIL")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
