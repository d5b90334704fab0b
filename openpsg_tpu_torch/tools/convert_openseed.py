"""Convert a published OpenSeeD checkpoint for the port's segmenter
(counterpart of ``tools/convert_openseed.py``).

    python -m openpsg_tpu_torch.tools.convert_openseed model_state_dict_swint_51.2ap.pt \\
        --out DIR [--merges bpe_simple_vocab_16e6.txt.gz]

The reference loads the checkpoint through OpenSeeD's BaseModel
(openseed_relation_v2.py:37-41) and computes the class-name text
embeddings once (:59-60).  This tool does both offline and writes, in the
port's own format (``torch.save`` state dicts, loadable with
``weights_only=True``):

    DIR/segmenter.pt       the segmenter's parameters (float32)
    DIR/lang.pt            the CLIP text tower (``tower.*``), ``lang_proj``
                           and ``logit_scale``
    DIR/class_embeds.npy   [133, proj_dim] unit-norm class matrix (with
                           ``--merges``, the CLIP BPE merges file; the CLIP
                           tower runs on the card unless ``--device cpu``)

A config loads them with ``model.openseed_pretrained_path = DIR/segmenter.pt``
and ``model.precomputed_class_embeds = DIR/class_embeds.npy``.  The
conversion is strict (an unmapped checkpoint key raises) and prints a
per-level report that makes a wrong level-order assumption visible.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m openpsg_tpu_torch.tools.convert_openseed")
    ap.add_argument("checkpoint", help="reference OpenSeeD .pt state dict")
    ap.add_argument("--out", required=True, help="directory to write")
    ap.add_argument("--merges", default=None,
                    help="CLIP BPE merges file (txt or .gz) for class_embeds.npy")
    ap.add_argument("--queries", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="where the CLIP tower runs for class_embeds.npy (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    from openpsg_tpu_torch.bridge import part_state_dict
    from openpsg_tpu_torch.data.vocab import OBJECT_CLASSES, clean_name
    from openpsg_tpu_torch.models.commons.text_encoder import tower_state_dict
    from openpsg_tpu_torch.models.llm.weight_convert import to_numpy
    from openpsg_tpu_torch.models.segmenter.openseed import SegmenterConfig
    from openpsg_tpu_torch.models.segmenter.weight_convert import (
        conversion_report,
        convert_openseed,
        load_checkpoint,
    )

    t0 = time.perf_counter()
    state = {k: to_numpy(v) for k, v in load_checkpoint(args.checkpoint).items()}
    cfg = SegmenterConfig(num_queries=args.queries)
    params, lang = convert_openseed(state, cfg)
    print(conversion_report(params, cfg, state))
    os.makedirs(args.out, exist_ok=True)
    tensors = lambda d: {k: torch.from_numpy(np.array(v, order="C")) for k, v in d.items()}
    torch.save(tensors(part_state_dict("segmenter", {"params": params})),
               os.path.join(args.out, "segmenter.pt"))
    lang_sd = {f"tower.{k}": v for k, v in tower_state_dict(lang["tower"]).items()}
    lang_sd.update(lang_proj=lang["lang_proj"], logit_scale=lang["logit_scale"])
    torch.save(tensors(lang_sd), os.path.join(args.out, "lang.pt"))
    print(f"segmenter + lang converted → {args.out}")

    if args.merges:
        from openpsg_tpu_torch import resolve_device
        from openpsg_tpu_torch.models.commons.clip_bpe import CLIPBPETokenizer
        from openpsg_tpu_torch.models.segmenter.language import (
            clip_class_embeddings,
            clip_text_tower_config,
        )

        tok = CLIPBPETokenizer.from_files(args.merges)
        vocab, D = lang["tower"]["word_embed"]["embedding"].shape
        layers = lang["tower"]["layers"]["ffn_up"]["kernel"].shape[0]
        tcfg = clip_text_tower_config(width=D, layers=layers, vocab=vocab)
        emb = clip_class_embeddings(tcfg, lang["tower"], lang["lang_proj"], tok,
                                    [clean_name(n) for n in OBJECT_CLASSES],
                                    device=resolve_device(args.device))
        np.save(os.path.join(args.out, "class_embeds.npy"), emb)
        print(f"class_embeds.npy [{emb.shape[0]}, {emb.shape[1]}] written")
    print(f"converted in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
