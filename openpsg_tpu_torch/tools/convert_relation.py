"""Import a reference relation checkpoint (counterpart of
``tools/convert_relation.py``).

    python -m openpsg_tpu_torch.tools.convert_relation epoch_12.pth \\
        --config CFG --out DIR [--epoch N] [--verify]

The reference trains with ``PartCheckpointHook``, which saves the model's
state dict minus the ``freeze_layers`` prefixes
(kings_sgg/utils/part_checkpoint_hook.py:96-115): for v4, the relation head
without its frozen ``language_model`` (baseline_v4_ov.py:65); for the
closed-set family, ``relation_head.*`` and ``object_cls_embed.weight``
(mask2former_relation.py:48-50).  The head version follows the config's
``relation_head.type``.  A v3 checkpoint also carries its trained
Meta-layout Llama trunk (``relation_head.llama_model.*``), converted to the
rotate-half layout into the head's ``llama``.

This tool converts such a checkpoint into the port's part checkpoint
(``DIR/step_0/params.pt`` with the trainable groups' float32 values, an
empty optimizer state and ``meta.json``), which ``tools.infer --checkpoint
DIR`` restores into the model the same config builds.  The head's geometry
comes from the config as that model resolves it (for v4, the Q-Former's
text length and vocabulary follow its tokenizer).  ``--verify`` checks
every converted name and shape against the head module before writing.
"""

from __future__ import annotations

import argparse


def _strip(state, prefix):
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def _f32(sd):
    import numpy as np
    import torch

    return {k: torch.from_numpy(np.array(v, np.float32, order="C")) for k, v in sd.items()}


def _family_head(state, cfg):
    """The closed-set family's branch: ({"head.<name>": tensor, and
    "object_cls_embed.object_cls_embed" when the checkpoint has it},
    the resolved ``M2FRelationConfig``)."""
    import torch

    from openpsg_tpu_torch.bridge import part_state_dict, scan_prefixes
    from openpsg_tpu_torch.core.builder import m2f_relation_config
    from openpsg_tpu_torch.models.detectors.mask2former_relation import make_head
    from openpsg_tpu_torch.models.relation import weight_convert as wc

    mcfg = m2f_relation_config(cfg)
    version = mcfg.head_version
    head_state = _strip(state, "relation_head.")
    hcfg = getattr(mcfg, f"head_{version}")
    convert = {"v1": wc.convert_relation_head_v1, "v2": wc.convert_relation_head_v2,
               "v3": wc.convert_relation_head_v3}[version]
    tree = convert(head_state, hcfg)
    module = make_head(mcfg, device="meta")
    sd = part_state_dict("head", {"params": tree}, scanned=scan_prefixes(module, "head"))
    llama_state = _strip(head_state, "llama_model.") if version == "v3" else {}
    if llama_state:
        # the trained Meta-layout trunk → rotate-half RoPE, the head's llama
        from openpsg_tpu_torch.models.llm.weight_convert import (
            convert_llama,
            meta_llama_to_hf_state,
        )

        hf = meta_llama_to_hf_state(llama_state, n_heads=hcfg.llm.n_heads,
                                    n_kv_heads=hcfg.llm.n_kv_heads)
        for name, v in convert_llama(hf, hcfg.llm, dtype=torch.float32).items():
            if name == "core.lm_head.weight":
                continue      # the trunk's callers take hidden states only
            if not hcfg.ov_relation:
                if not name.startswith("core."):
                    continue  # the closed trunk has no token table
                name = name[len("core."):]
            sd["llama." + name] = v.numpy()
    elif version == "v3":
        print("[convert_relation] no relation_head.llama_model.* keys: the head's Llama "
              "trunk is not in this checkpoint")
    params = {f"head.{k}": v for k, v in _f32(sd).items()}
    if "object_cls_embed.weight" in state:
        params.update({f"object_cls_embed.{k}": v for k, v in _f32(
            {"object_cls_embed": state["object_cls_embed.weight"]}).items()})
    return params, mcfg


def convert_checkpoint(state, cfg):
    """state: flat {key: numpy array} (``relation_head.*`` keys and
    extras); cfg: the loaded Config → ({"<group>.<name>": float32 tensor},
    the resolved model config: ``PSGv4Config`` for v4, else
    ``M2FRelationConfig``)."""
    from openpsg_tpu_torch.bridge import part_state_dict
    from openpsg_tpu_torch.core.builder import resolved_config_from
    from openpsg_tpu_torch.models.relation.weight_convert import convert_relation_head_v4

    model_cfg = cfg["model"] if "model" in cfg else cfg
    head_type = dict(model_cfg.get("relation_head", {})).get("type", "RelationTransformerHead")
    if head_type != "RelationTransformerHeadV4":
        return _family_head(state, cfg)
    pcfg = resolved_config_from(cfg)
    tree = convert_relation_head_v4(_strip(state, "relation_head."), pcfg.head)
    sd = part_state_dict("head", {"params": tree})
    return {f"head.{k}": v for k, v in _f32(sd).items()}, pcfg


def verify(params, pcfg) -> None:
    """Raise unless ``params`` names and shapes exactly the head's
    parameters (built on the meta device: no memory)."""
    import torch

    from openpsg_tpu_torch.models.detectors.mask2former_relation import (
        M2FRelationConfig,
        make_head,
    )
    from openpsg_tpu_torch.models.llm.weight_convert import verify_structure
    from openpsg_tpu_torch.models.relation.head_v4 import RelationHeadV4

    if isinstance(pcfg, M2FRelationConfig):
        head = make_head(pcfg, device="meta")
    else:
        with torch.device("meta"):
            head = RelationHeadV4(pcfg.head, pcfg.segmenter.mask_dim)
    verify_structure({k[len("head."):]: v for k, v in params.items() if k.startswith("head.")},
                     head.state_dict())


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
    version = getattr(pcfg, "head_version", "v4")
    consumed = ("relation_head.",) + (("object_cls_embed.",) if version != "v4" else ())
    leftovers = sorted({k.split(".")[0] for k in state if not k.startswith(consumed)})
    print(f"[convert_relation] head {version}: {len(params)} converted tensors; unconsumed "
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
