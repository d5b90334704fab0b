"""Import a reference relation checkpoint (counterpart of
``tools/convert_relation.py``, its v4 branch).

    python -m openpsg_tpu_torch.tools.convert_relation epoch_12.pth \\
        --config CFG --out DIR [--epoch N] [--verify]

The reference trains with ``PartCheckpointHook``, which saves the model's
state dict minus the ``freeze_layers`` prefixes
(kings_sgg/utils/part_checkpoint_hook.py:96-115): for v4, the relation head
without its frozen ``language_model`` (baseline_v4_ov.py:65).  This tool
converts such a checkpoint into the port's part checkpoint
(``DIR/step_0/params.pt`` with the head's float32 values, an empty
optimizer state and ``meta.json``), which ``tools.infer --checkpoint DIR``
restores into the model the same config builds.  The head's geometry comes
from the config as that model resolves it (the Q-Former's text length and
vocabulary follow its tokenizer).  ``--verify`` checks every converted
name and shape against the head module before writing.  The v1-v3 heads
come with the closed-set slice.
"""

from __future__ import annotations

import argparse


def _strip(state, prefix):
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def convert_checkpoint(state, cfg):
    """state: flat {key: numpy array} (``relation_head.*`` keys and
    extras); cfg: the loaded Config → ({"head.<name>": float32 tensor},
    the resolved ``HeadV4Config``)."""
    import numpy as np
    import torch

    from openpsg_tpu_torch.bridge import part_state_dict
    from openpsg_tpu_torch.core.builder import resolved_config_from
    from openpsg_tpu_torch.models.relation.weight_convert import convert_relation_head_v4

    model_cfg = cfg["model"] if "model" in cfg else cfg
    head_type = dict(model_cfg.get("relation_head", {})).get("type", "RelationTransformerHead")
    if head_type != "RelationTransformerHeadV4":
        raise NotImplementedError(
            f"relation_head.type {head_type!r}: the v1-v3 heads' converters come with "
            "the PyTorch port's closed-set slice; only RelationTransformerHeadV4 is ported")
    pcfg = resolved_config_from(cfg)
    tree = convert_relation_head_v4(_strip(state, "relation_head."), pcfg.head)
    sd = part_state_dict("head", {"params": tree})
    params = {f"head.{k}": torch.from_numpy(np.array(v, np.float32, order="C"))
              for k, v in sd.items()}
    return params, pcfg


def verify(params, pcfg) -> None:
    """Raise unless ``params`` names and shapes exactly the head's
    parameters (built on the meta device: no memory)."""
    import torch

    from openpsg_tpu_torch.models.llm.weight_convert import verify_structure
    from openpsg_tpu_torch.models.relation.head_v4 import RelationHeadV4

    with torch.device("meta"):
        head = RelationHeadV4(pcfg.head, pcfg.segmenter.mask_dim)
    verify_structure({k[len("head."):]: v for k, v in params.items()}, head.state_dict())


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m openpsg_tpu_torch.tools.convert_relation",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("checkpoint", help="reference PartCheckpointHook .pth")
    ap.add_argument("--config", required=True, help="reference-style config file")
    ap.add_argument("--out", required=True, help="part-checkpoint directory to write")
    ap.add_argument("--epoch", type=int, default=None,
                    help="epoch recorded in meta (default: from the .pth meta, else 1)")
    ap.add_argument("--verify", action="store_true",
                    help="check the converted names and shapes against the head module")
    args = ap.parse_args(argv)

    import pickle

    import torch

    from openpsg_tpu_torch.core.config import Config
    from openpsg_tpu_torch.models.llm.weight_convert import to_numpy
    from openpsg_tpu_torch.train.checkpoint import PartCheckpointer

    cfg = Config.fromfile(args.config)
    try:
        raw = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # mmcv saves meta objects beside the tensors
        raw = torch.load(args.checkpoint, map_location="cpu", weights_only=False)
    meta = raw.get("meta", {}) if isinstance(raw, dict) else {}
    state = raw["state_dict"] if isinstance(raw.get("state_dict"), dict) else raw
    state = {k: to_numpy(v) for k, v in state.items() if hasattr(v, "shape")}

    params, pcfg = convert_checkpoint(state, cfg)
    leftovers = sorted({k.split(".")[0] for k in state if not k.startswith("relation_head.")})
    print(f"[convert_relation] head v4: {len(params)} converted tensors; unconsumed "
          f"top-level prefixes: {leftovers or 'none'}")
    if args.verify:
        verify(params, pcfg)
        print("[convert_relation] verify: converted names and shapes match the head module")

    epoch = args.epoch
    if epoch is None and isinstance(meta, dict):
        epoch = meta.get("epoch")
    ckpt = PartCheckpointer(args.out)
    ckpt.save(0, params, opt_state={"count": 0, "mu": {}, "nu": {}},
              meta={"epoch": epoch or 1, "imported_from": args.checkpoint})
    print(f"[convert_relation] wrote a part checkpoint to {args.out} (epoch {epoch or 1})")


if __name__ == "__main__":
    main()
