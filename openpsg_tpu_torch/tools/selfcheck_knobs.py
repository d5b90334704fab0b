"""What the deployment knobs cost in quality (counterpart of
``tools/selfcheck_knobs.py``): train the tiny PSG v4 model from scratch on
the rich fixture, then grade the same trained weights under each knob.

    python -m openpsg_tpu_torch.tools.selfcheck_knobs [--root DIR]
        [--seg-steps 700] [--rel-steps 400] [--device cuda]

The rich fixture (``utils/fixture.make_rich_fixture``: 16 images of 64²,
8 objects each on a 2×4 grid, 10 relations per image over 12 confusable
spatial predicates; 8 train, 8 held out) keeps a model trained from
scratch clearly below recall 100, so a knob's cost shows.  Phases:

  A. the segmenter and the class embeddings train from scratch, B. the
     relation head and the LLM (both as in ``selfcheck_e2e``,
     :func:`~openpsg_tpu_torch.tools.selfcheck_e2e.train_from_scratch`);
  C. the knob matrix over the trained weights (:data:`VARIANTS`): bf16
     (the weights as trained), int8 (``quantize_llama`` of the trained
     LLM), int8 with int8 prefill activations (``act_int8``), and encoder
     point pruning (the tiny 3-level analogue of the deployment's 2,2,2,4,
     and a deeper 1,1,4).  Each variant runs per-image ``infer`` on the
     held-out images that have relations, resizes the panoptic map back
     (nearest), writes a submission and grades it with ``tools.grade`` at
     R@20 and R@50.

Prints each phase's wall seconds, then one JSON object (the ``harness``
constants, R@20, mR@20 and R@50 per variant, each variant's R@20 less
int8's), then ``KNOBCHECK PASS`` or ``FAIL``.  Exit code 0 iff the harness
discriminates: five times chance < bf16 R@20 < 99.5.  The knobs' costs
are reported, not gated.  A 2-layer
64-wide LLM stands in for the 7B one, whose int8 error propagates over
32 layers: the matrix shows a knob's cost, not its size at full width.
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

# name: (output subdirectory, encoder points per level, int8 LLM weights,
# int8 prefill activations).  (2, 2, 4) is the tiny 3-level segmenter's
# analogue of the deployment's (2, 2, 2, 4); (1, 1, 4) prunes deeper.
VARIANTS = {
    "bf16": ("out_bf16", None, False, False),
    "int8": ("out_int8", None, True, False),
    "int8+act": ("out_int8_act", None, True, True),
    "int8+prune": ("out_int8_prune", (2, 2, 4), True, False),
    "int8+act+prune": ("out_int8_act_prune", (2, 2, 4), True, True),
    "int8+act+deep_prune": ("out_int8_act_deep_prune", (1, 1, 4), True, True),
}
N_IMAGES, OBJECTS, PREDICATES, GT_RELATIONS = 16, 8, 12, 10


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m openpsg_tpu_torch.tools.selfcheck_knobs")
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "psg_knobs"),
                    help="directory for the dataset and the submissions")
    ap.add_argument("--seg-steps", type=int, default=700)
    ap.add_argument("--rel-steps", type=int, default=400)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; pass cpu for the CPU path)")
    return ap.parse_args(argv)


def harness_config():
    """The tiny preset at the harness's geometry: 8 objects per image need
    the selection cap at 8, and 10 relations per image need enough decoded
    pairs (14), at 64²."""
    from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4Config
    from openpsg_tpu_torch.models.llm.llama import LlamaConfig
    from openpsg_tpu_torch.models.relation.head_v4 import HeadV4Config
    from openpsg_tpu_torch.models.segmenter.openseed import SegmenterConfig

    return PSGv4Config(
        segmenter=SegmenterConfig.tiny_test(),
        head=dataclasses.replace(HeadV4Config.tiny_test(), max_object_num=OBJECTS, top_pairs=14),
        llm=LlamaConfig.tiny_test(), input_hw=(64, 64))


def variant_model(trained, name: str, device):
    """A model of variant ``name`` holding ``trained``'s weights: the
    segmenter's points per level set, the LLM quantized from the trained
    one (``quantize_llama`` into the int8 model the config builds, its
    float32 scales kept) and ``act_int8`` set as the variant says."""
    import torch

    from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4
    from openpsg_tpu_torch.models.llm.llama import quantize_llama

    _, points, quant, act = VARIANTS[name]
    c = trained.cfg
    cfg = dataclasses.replace(
        c, segmenter=dataclasses.replace(c.segmenter, enc_points_per_level=points),
        llm=dataclasses.replace(c.llm, quant=quant, act_int8=act))
    m = PSGv4(cfg, seed=0, device=device)
    with torch.no_grad():
        for part in ("segmenter", "head", "text"):
            getattr(m, part).load_state_dict(getattr(trained, part).state_dict())
        llm = trained.llm.state_dict()
        m.llm.load_state_dict(quantize_llama(llm) if quant else llm)
        m.class_embeds = trained.class_embeds.detach().clone().to(m.device)
    return m


def held_out(ann: str):
    """The test split's records that have relations, in the json's order."""
    with open(ann, encoding="utf-8") as f:
        dataset = json.load(f)
    test_ids = set(dataset["test_image_ids"])
    return [d for d in dataset["data"] if d["image_id"] in test_ids and d["relations"]]


def qdense_routes(model):
    """Count, while the block runs, the ``QDense`` calls by route: "int8"
    (int8 × int8 products: ``act_int8`` and at least ``ACT_INT8_MIN_ROWS``
    rows) and "weight_only".  → (counts dict, a function that removes the
    hooks)."""
    from openpsg_tpu_torch.models.llm.llama import QDense

    counts = {"int8": 0, "weight_only": 0}

    def hook(mod, args):
        rows = args[0].numel() // args[0].shape[-1]
        counts["int8" if mod.act_int8 and rows >= QDense.ACT_INT8_MIN_ROWS
               else "weight_only"] += 1

    hooks = [m.register_forward_pre_hook(hook) for m in model.llm.modules()
             if isinstance(m, QDense)]
    return counts, lambda: [h.remove() for h in hooks]


def evaluate(model, root: str, ann: str, out_dir: str):
    """Per-image ``infer`` on the held-out images, a submission, the grader
    at R@20 and R@50 → (scores, per-image results)."""
    from openpsg_tpu_torch.data.preprocess import Preprocessor, load_image_rgb, resize_nearest
    from openpsg_tpu_torch.tools import grade
    from openpsg_tpu_torch.utils.submission import SubmissionWriter

    H, _ = model._model_hw()
    pre = Preprocessor(scale=(H, H))
    writer = SubmissionWriter(out_dir, seed=0)
    results = []
    for idx, d in enumerate(held_out(ann)):
        img = load_image_rgb(os.path.join(root, d["file_name"]))
        ex = pre(img)
        res = model.infer(ex["image"].astype(np.float32), ex["img_shape"])
        nh, nw = ex["img_shape"]
        pan_ori = resize_nearest(res["pan_results"][:nh, :nw], img.shape[:2]).astype(np.int64)
        writer.add(pan_ori, res["rel_results"]["object_id_list"],
                   res["rel_results"]["relation"], test_idx=idx)
        results.append(res)
    writer.finalize()
    scores = grade.main(["--submission", out_dir, "--gt-json", ann, "--data-dir", root,
                         "--ks", "20", "50"])
    return scores, results


def summarize(matrix):
    """The JAX harness's printed object → (summary dict, chance R@20 in %)."""
    n_cand = OBJECTS * (OBJECTS - 1) * 56
    # chance R@20: one given candidate inside a random top 20 of the grid
    chance20 = 100.0 * min(20 / n_cand, 1.0)
    base = matrix["int8"]["R@20"]   # int8 weights: the deployment's parity
    return {
        "harness": {
            "images": N_IMAGES, "objects_per_image": OBJECTS,
            "predicates": PREDICATES, "gt_relations_per_image": GT_RELATIONS,
            "candidates_per_image": n_cand, "chance_R@20_pct": round(chance20, 2),
        },
        "R@20": {k: v["R@20"] for k, v in matrix.items()},
        "mR@20": {k: v["mR@20"] for k, v in matrix.items()},
        "R@50": {k: v["R@50"] for k, v in matrix.items()},
        "delta_R@20_vs_int8": {k: round(v["R@20"] - base, 2) for k, v in matrix.items()},
    }, chance20


def run(root: str, seg_steps: int = 700, rel_steps: int = 400, device="cuda", log=print):
    """Phases A-C → dict: ``summary`` (the printed object), ``ok`` (the exit
    rule), ``scores`` and ``results`` (per-image ``infer`` results) and
    ``qdense`` (``QDense`` calls by route) per variant, the trained
    ``pipeline``, the dataset's ``ann`` path, ``held_out`` (the graded
    records), the losses (``seg_losses``, ``rel_losses``) and wall seconds
    per phase (C per variant too, ``variant_seconds``)."""
    from openpsg_tpu_torch import resolve_device
    from openpsg_tpu_torch.data.preprocess import Preprocessor
    from openpsg_tpu_torch.data.psg_dataset import PSGDataset
    from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4
    from openpsg_tpu_torch.tools.selfcheck_e2e import train_from_scratch
    from openpsg_tpu_torch.utils.fixture import make_rich_fixture

    device = resolve_device(device)
    os.makedirs(root, exist_ok=True)
    ann = make_rich_fixture(root, n_images=N_IMAGES, hw=(64, 64))
    pipeline = PSGv4(harness_config(), seed=0, device=device)
    H, _ = pipeline._model_hw()
    M = pipeline.cfg.head.max_objects_padded
    ds = PSGDataset(ann, img_prefix=root, seg_prefix=root, split="train")
    exs = [ds.load_example(i, Preprocessor(scale=(H, H)), M) for i in range(len(ds))]
    out = {"ann": ann, "pipeline": pipeline, "held_out": held_out(ann), "seconds": {},
           "scores": {}, "results": {}, "qdense": {}, "variant_seconds": {}}
    train_from_scratch(pipeline, exs, seg_steps, rel_steps, device, log, out)

    log("[C] knob matrix on the trained weights")
    t0 = time.perf_counter()
    for name, (sub, *_) in VARIANTS.items():
        t1 = time.perf_counter()
        model = variant_model(pipeline, name, device)
        counts, unhook = qdense_routes(model)
        try:
            scores, results = evaluate(model, root, ann, os.path.join(root, sub))
        finally:
            unhook()
        out["scores"][name], out["results"][name], out["qdense"][name] = scores, results, counts
        out["variant_seconds"][name] = time.perf_counter() - t1
        log(f"  {name}: R@20={scores['R@20']:.1f} mR@20={scores['mR@20']:.1f} "
            f"R@50={scores['R@50']:.1f} (QDense calls {counts})")
    out["seconds"]["C"] = time.perf_counter() - t0

    log("phase seconds: " + " ".join(f"{k}={v:.1f}" for k, v in out["seconds"].items())
        + " (C per variant: " + " ".join(f"{k}={v:.1f}" for k, v in
                                          out["variant_seconds"].items()) + ")")
    summary, chance20 = summarize(out["scores"])
    out["summary"] = summary
    bf16 = out["scores"]["bf16"]["R@20"]
    out["ok"] = chance20 * 5 < bf16 < 99.5
    log(json.dumps(summary))
    log("KNOBCHECK", "PASS" if out["ok"] else "FAIL",
        "(harness discriminative)" if out["ok"] else
        f"(bf16 R@20={bf16} not in ({chance20 * 5:.1f}, 99.5))")
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    return 0 if run(args.root, args.seg_steps, args.rel_steps, args.device)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
