"""Convert a published mmdet Mask2Former checkpoint for the port's segmenter
(counterpart of ``tools/convert_mask2former.py``).

    python -m openpsg_tpu_torch.tools.convert_mask2former \\
        mask2former_r50_lsj_8x2_50e_coco-panoptic_*.pth --out DIR \\
        [--config CFG | --backbone r50|swin_b --queries 100 --num-classes 133]

The reference's v1 / v2 / v3 generations start from mmdet's COCO-panoptic
Mask2Former checkpoints through ``load_from`` (configs/psg/baseline_r50.py:3
ResNet-50; baseline_swin_b.py Swin-B).  This tool converts one offline into
``DIR/segmenter.pt``: the segmenter's parameters under the port's names, in
float32, loadable with ``weights_only=True``, which
``PSGMask2FormerRelation.load_segmenter_weights`` (or a config's
``model.segmenter_pretrained_path``) takes.  The geometry comes from
``--config`` as the builder resolves it, or else from the published
geometry with the given backbone (default: read from the keys), query and
class counts.  The conversion is strict (an unmapped key raises), the names
and shapes are checked against the segmenter module, and a per-part report
(tensor count, parameters, root mean square) makes a wrong layout
assumption visible.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m openpsg_tpu_torch.tools.convert_mask2former",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("checkpoint", help="mmdet Mask2Former .pth")
    ap.add_argument("--out", required=True, help="directory to write")
    ap.add_argument("--config", default=None,
                    help="take the segmenter geometry from this config")
    ap.add_argument("--backbone", default=None,
                    help="r50 | swin_b (default: read from the keys)")
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--num-classes", type=int, default=133)
    args = ap.parse_args(argv)

    import torch

    from openpsg_tpu_torch.bridge import part_state_dict, scan_prefixes
    from openpsg_tpu_torch.models.llm.weight_convert import to_numpy, verify_structure
    from openpsg_tpu_torch.models.segmenter.mask2former import (
        Mask2FormerConfig,
        Mask2FormerSegmenter,
    )
    from openpsg_tpu_torch.models.segmenter.weight_convert import (
        _tree_leaves,
        convert_mask2former,
        load_checkpoint,
    )

    state = load_checkpoint(args.checkpoint)
    if isinstance(state, dict) and isinstance(state.get("state_dict"), dict):
        state = state["state_dict"]
    state = {k: to_numpy(v) for k, v in state.items() if hasattr(v, "shape")}
    if args.config:
        from openpsg_tpu_torch.core.builder import m2f_relation_config, model_kwargs_from
        from openpsg_tpu_torch.core.config import Config
        from openpsg_tpu_torch.data.vocab import OBJECT_CLASSES

        cfg = Config.fromfile(args.config)
        names = model_kwargs_from(cfg)["class_names"] or OBJECT_CLASSES
        seg = dataclasses.replace(m2f_relation_config(cfg).segmenter, num_classes=len(names))
    else:
        backbone = args.backbone or ("r50" if "backbone.conv1.weight" in state else "swin_b")
        seg = Mask2FormerConfig(backbone=backbone, num_queries=args.queries,
                                num_classes=args.num_classes, enc_ffn_hidden=1024)
    params = convert_mask2former(state, seg)
    for part, tree in params.items():
        leaves = [np.asarray(v) for v in _tree_leaves(tree)]
        n = sum(a.size for a in leaves)
        rms = float(np.sqrt(np.mean([float((a.astype(np.float64) ** 2).mean()) for a in leaves])))
        print(f"{part:>16}: {len(leaves):4d} tensors, {n / 1e6:7.2f} M params, rms {rms:.4f}")

    with torch.device("meta"):
        module = Mask2FormerSegmenter(seg)
    sd = part_state_dict("segmenter", {"params": params},
                         scanned=scan_prefixes(module, "segmenter"))
    verify_structure(sd, module.state_dict())
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "segmenter.pt")
    torch.save({k: torch.from_numpy(np.array(v, np.float32, order="C")) for k, v in sd.items()},
               path)
    print(f"converted ({seg.backbone}, {len(sd)} tensors) → {path}")
    return path


if __name__ == "__main__":
    main()
