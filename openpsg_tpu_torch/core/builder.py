"""Config dict → model (counterpart of ``openpsg_tpu/core/builder.py``).

    cfg = Config.fromfile("openpsg_tpu_torch/configs/psg/baseline_v4_ov.py")
    model = build_detector_from_config(cfg, seed=0)

``model.type`` picks the model as mmdet's registry does:
``OpenSeeDRelationV2`` → :class:`PSGv4`; ``Mask2FormerRelation``,
``Mask2FormerRelationV2`` and ``OpenSeeDRelation`` (the closed-set v1 / v2 /
v3 family, by ``relation_head.type``) → :class:`PSGMask2FormerRelation`.
:func:`psg_v4_config_from` and :func:`m2f_relation_config` resolve a config
without building weights.
mmdet-only fields are accepted and ignored; sizing lives under the optional
``cfg.tpu`` dict, as in the JAX package.  Published assets load when their
paths exist: ``relation_head.tokenizer_path`` / ``llm_model_name`` (the LLM
tokenizer) and ``qformer_tokenizer_path`` / ``qformer_model_name`` (the
Q-Former's): a ``.model`` file through the SentencePiece reader, any other
path through the HF adapter; ``openseed_pretrained_path`` (a reference
OpenSeeD ``.pt`` or the ``convert_openseed`` tool's ``segmenter.pt``) and
``precomputed_class_embeds`` (an ``.npy``).  For the family:
``segmenter_pretrained_path`` or ``load_from`` (a raw mmdet Mask2Former
``.pth`` or the ``convert_mask2former`` tool's ``segmenter.pt``) and
``text_embed_db_dir`` (the v2 text KV store ``<dir>/kv.db``; missing keys,
or a missing store, read as zero vectors).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

import torch

from openpsg_tpu_torch.data.vocab import OBJECT_CLASSES, RELATION_CLASSES
from openpsg_tpu_torch.models.commons.text_encoder import BertStyleConfig
from openpsg_tpu_torch.models.detectors.mask2former_relation import (
    DETECTOR_TYPES as CLOSED_SET_TYPES,
    M2FRelationConfig,
    PSGMask2FormerRelation,
)
from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config, resolve_vocabulary
from openpsg_tpu_torch.models.llm.llama import LlamaConfig
from openpsg_tpu_torch.models.relation.head_v1 import HeadV1Config
from openpsg_tpu_torch.models.relation.head_v2 import HeadV2Config
from openpsg_tpu_torch.models.relation.head_v3 import HeadV3Config
from openpsg_tpu_torch.models.segmenter.mask2former import Mask2FormerConfig
from openpsg_tpu_torch.models.relation.head_v4 import HeadV4Config
from openpsg_tpu_torch.models.relation.qformer import QFormerConfig
from openpsg_tpu_torch.models.segmenter.openseed import SegmenterConfig


def _dtype(tpu: Dict[str, Any]) -> torch.dtype:
    return torch.bfloat16 if tpu.get("bf16", True) else torch.float32


def _segmenter_cfg(tpu: Dict[str, Any]) -> SegmenterConfig:
    if tpu.get("segmenter_preset", "swin_t") == "tiny":
        seg = SegmenterConfig.tiny_test()
    else:
        seg = SegmenterConfig(dtype=_dtype(tpu))
    if tpu.get("enc_points_per_level"):
        seg = dataclasses.replace(seg, enc_points_per_level=tuple(tpu["enc_points_per_level"]))
    return seg


def _head_cfg(d: Dict[str, Any], tpu: Dict[str, Any]) -> HeadV4Config:
    """The JAX ``_head_cfg_from_dict`` (whose ``qformer_neg_over_pos``
    no JAX caller reads: pairs are sampled at 3 negatives per positive)."""
    if tpu.get("head_preset") == "tiny":
        return HeadV4Config.tiny_test()
    dtype = _dtype(tpu)
    qf = QFormerConfig(
        hidden_size=d.get("qformer_feature_size", 768),
        num_layers=d.get("qformer_layer_num", 2),
        encoder_hidden_size=d.get("object_feature_size", 256),
        dtype=dtype,
    )
    return HeadV4Config(
        qformer=qf,
        patch_size=d.get("patch_size", 16),
        object_feature_size=d.get("object_feature_size", 256),
        num_relation_classes=len(d.get("relation_classes", [])) or 56,
        max_object_num=d.get("max_object_num", 30),
        rel_cls_type=d.get("rel_cls_type", "binary+multiclass"),
        sampled_qformer_batch_size=d.get("sampled_qformer_batch_size", 32),
        max_llm_forward_num=d.get("max_llm_forward_num", 4),
        llm_feature_size=d.get("llm_feature_size", 4096),
        dtype=dtype,
    )


def _llm_cfg(d: Dict[str, Any], tpu: Dict[str, Any]) -> LlamaConfig:
    if tpu.get("llm_preset", "tiny") == "llama2_7b":
        cfg = LlamaConfig.llama2_7b()
    else:
        cfg = LlamaConfig.tiny_test()
        cfg = dataclasses.replace(cfg, n_layers=tpu.get("llm_layers", cfg.n_layers),
                                  dim=tpu.get("llm_dim", cfg.dim))
    trunc = d.get("llm_truncate_num", -1)
    if trunc and trunc > 0:
        cfg = dataclasses.replace(cfg, n_layers=min(trunc, cfg.n_layers))
    # deployment knobs: weight-only int8 and int8-activation prefill
    if tpu.get("llm_int8") is not None or tpu.get("act_int8") is not None:
        cfg = dataclasses.replace(cfg, quant=bool(tpu.get("llm_int8", cfg.quant)),
                                  act_int8=bool(tpu.get("act_int8", cfg.act_int8)))
    return cfg


def _parts(cfg):
    model_cfg = cfg["model"] if "model" in cfg else cfg
    tpu = dict(cfg.get("tpu", {}) or {})
    return model_cfg, tpu, dict(model_cfg.get("relation_head", {}) or {})


def psg_v4_config_from(cfg) -> PSGv4Config:
    """The :class:`PSGv4Config` a config (``Config`` or plain dict with the
    reference's ``model`` layout) resolves to; builds no weights."""
    model_cfg, tpu, head = _parts(cfg)
    mtype = model_cfg.get("type", "OpenSeeDRelationV2")
    if mtype in CLOSED_SET_TYPES:
        raise ValueError(f"detector {mtype!r} is of the closed-set family: resolve it "
                         "with m2f_relation_config")
    if mtype != "OpenSeeDRelationV2":
        raise NotImplementedError(f"detector {mtype!r} is not a known PSG model")
    pcfg = PSGv4Config(segmenter=_segmenter_cfg(tpu), head=_head_cfg(head, tpu),
                       llm=_llm_cfg(head, tpu))
    if tpu.get("input_hw"):
        pcfg = dataclasses.replace(pcfg, input_hw=tuple(tpu["input_hw"]))
    for knob in ("max_new_tokens", "decode_early_exit", "fusion_stride", "fusion_candidates"):
        if knob in tpu:
            pcfg = dataclasses.replace(pcfg, **{knob: tpu[knob]})
    return pcfg


def _tokenizer(head: Dict[str, Any], *keys):
    """The first of ``keys`` naming an existing path → its tokenizer (a
    ``.model`` file: the SentencePiece reader; else the HF adapter), or
    None (the closed-vocabulary word tokenizer)."""
    for key in keys:
        path = head.get(key)
        if path and os.path.exists(str(path)):
            if str(path).endswith(".model"):
                from openpsg_tpu_torch.models.relation.sp_tokenizer import (
                    SentencePieceTokenizer,
                )

                return SentencePieceTokenizer.from_file(str(path))
            from openpsg_tpu_torch.models.relation.hf_tokenizer import HFTokenizer

            return HFTokenizer.from_pretrained(str(path))
    return None


def model_kwargs_from(cfg) -> Dict[str, Any]:
    """The vocabulary (``thing_classes`` / ``stuff_classes`` /
    ``relation_classes``), the tokenizers and the precomputed class
    embeddings a config names: :class:`PSGv4`'s keyword arguments besides
    the config, seed and device."""
    model_cfg, _, head = _parts(cfg)
    thing = list(model_cfg.get("thing_classes", []) or cfg.get("thing_classes", []))
    stuff = list(model_cfg.get("stuff_classes", []) or cfg.get("stuff_classes", []))
    relations = _relations(cfg, head)
    return dict(
        class_names=(thing + stuff) or None,
        relation_names=relations or None,
        num_things=len(thing) if thing else None,
        precomputed_class_embeds=model_cfg.get("precomputed_class_embeds") or None,
        tokenizer=_tokenizer(head, "tokenizer_path", "llm_model_name"),
        qformer_tokenizer=_tokenizer(head, "qformer_tokenizer_path", "qformer_model_name"),
    )


def resolved_config_from(cfg) -> PSGv4Config:
    """The :class:`PSGv4Config` a model built from ``cfg`` holds: the
    widths its vocabulary and tokenizers set resolved too (what a
    converted checkpoint must match); builds no weights."""
    kw = model_kwargs_from(cfg)
    return resolve_vocabulary(psg_v4_config_from(cfg), kw["class_names"] or OBJECT_CLASSES,
                              kw["relation_names"] or RELATION_CLASSES, kw["tokenizer"],
                              kw["qformer_tokenizer"])[0]


def _backbone_preset(model_cfg: Dict[str, Any]) -> str:
    """The backbone preset of the reference's ``model.backbone`` dict: a
    SwinTransformer by its ``embed_dims`` (exact geometries only), else
    ResNet-50."""
    bb = dict(model_cfg.get("backbone", {}) or {})
    if bb.get("type") == "SwinTransformer":
        ed = int(bb.get("embed_dims", 96))
        if ed == 96:
            return "swin_t"
        if ed == 128:
            return "swin_b"
        raise ValueError(f"unsupported SwinTransformer embed_dims={ed}: known presets are "
                         "swin_t (96) and swin_b (128); set tpu.segmenter_preset explicitly "
                         "for other geometries")
    return "r50"


def _apply_panoptic_head_fields(seg: Mask2FormerConfig, ph: Dict[str, Any]) -> Mask2FormerConfig:
    """The reference's ``panoptic_head`` dict onto the segmenter geometry:
    num_queries, feat_channels → dim, out_channels → mask_dim, the pixel
    decoder's layers and FFN width, the transformer decoder's layers and
    FFN width."""
    if not ph:
        return seg
    upd: Dict[str, Any] = {}
    if "num_queries" in ph:
        upd["num_queries"] = int(ph["num_queries"])
    if "feat_channels" in ph:
        upd["dim"] = int(ph["feat_channels"])
    if "out_channels" in ph:
        upd["mask_dim"] = int(ph["out_channels"])
    enc = (ph.get("pixel_decoder") or {}).get("encoder") or {}
    if "num_layers" in enc:
        upd["enc_layers"] = int(enc["num_layers"])
    enc_ffn = ((enc.get("transformerlayers") or {}).get("ffn_cfgs") or {}).get(
        "feedforward_channels")
    if enc_ffn:
        upd["enc_ffn_hidden"] = int(enc_ffn)
    td = ph.get("transformer_decoder") or {}
    if "num_layers" in td:
        upd["dec_layers"] = int(td["num_layers"])
    tdl = td.get("transformerlayers") or {}
    dec_ffn = (tdl.get("ffn_cfgs") or {}).get("feedforward_channels") or tdl.get(
        "feedforward_channels")
    if dec_ffn:
        upd["ffn_hidden"] = int(dec_ffn)
    return dataclasses.replace(seg, **upd)


def _relations(cfg, head: Dict[str, Any]):
    return list(head.get("relation_classes", []) or cfg.get("relation_classes", []))


def m2f_relation_config(cfg) -> M2FRelationConfig:
    """The :class:`M2FRelationConfig` a closed-set family config resolves to
    (the JAX ``_m2f_config``); builds no weights."""
    model_cfg, tpu, head = _parts(cfg)
    relations = _relations(cfg, head)
    dtype = _dtype(tpu)
    version = {"RelationTransformerHead": "v1", "RelationTransformerHeadV2": "v2",
               "RelationTransformerHeadV3": "v3"}.get(head.get("type", "RelationTransformerHead"))
    if version is None:
        raise ValueError(f"relation_head.type {head.get('type')!r} is not a head of the "
                         "closed-set family (RelationTransformerHead, ...V2, ...V3)")
    R = len(relations) or 56
    preset = tpu.get("segmenter_preset") or _backbone_preset(model_cfg)
    tiny = preset in ("tiny", "tiny_r50")
    if tiny:
        # the test topology; the reference panoptic_head geometry is ignored
        seg = Mask2FormerConfig.tiny_test()
        if preset == "tiny_r50":
            seg = dataclasses.replace(seg, backbone="tiny_r50", num_queries=10,
                                      enc_layers=2, dec_layers=3)
        input_hw, max_obj, max_pad = (64, 64), 6, 8
        enc = BertStyleConfig.tiny_test()
    else:
        seg = Mask2FormerConfig(backbone={"r50": "r50", "swin_t": "swin_t",
                                          "swin_b": "swin_b"}[preset], dtype=dtype)
        seg = _apply_panoptic_head_fields(seg, dict(model_cfg.get("panoptic_head", {}) or {}))
        input_hw, max_obj, max_pad = tuple(tpu.get("input_hw", (1344, 1344))), 30, 32
        enc = BertStyleConfig(num_layers=head.get("num_transformer_layer", 2), dtype=dtype)

    if version == "v1":
        use_prompts = bool(head.get("use_relation_prompts", False))
        pred_type = head.get("pred_type", "attention")
        v1 = HeadV1Config(
            encoder=enc, input_feature_size=head.get("input_feature_size", seg.mask_dim),
            output_feature_size=32 if tiny else head.get("output_feature_size", 768),
            num_relation_classes=R,
            pred_type=pred_type if not use_prompts else "attention",
            use_relation_prompts=use_prompts,
            # on the prompt path pred_type selects the fusion module's mode
            fusion_pred_type=pred_type if use_prompts else "einsum",
            graph_transformer_type=head.get("graph_transformer_type"),
            use_learnable_prompts=head.get("use_learnable_prompts", False),
            learnable_prompts_size=head.get("learnable_prompts_size", 16),
            semantic_type=head.get("semantic_type", "relation_classes"),
            loss_type=head.get("loss_type", "v1"), loss_weight=head.get("loss_weight", 50.0),
            loss_alpha=head.get("loss_alpha", 1.0), dtype=dtype)
    else:
        v1 = HeadV1Config.tiny_test() if tiny else HeadV1Config()

    if version == "v2":
        experts = [name for flag, name in (
            ("use_object_vision_only", "object_vision_only"),
            ("use_pair_vision_only", "pair_vision_only"),
            ("use_pair_text_vision_cross", "pair_text2vision"),
            ("use_pair_vision_text_cross", "pair_vision2text"),
            ("use_triplet_vision_text_cross", "triplet_text_w_vision"),
        ) if head.get(flag, False)]
        v2 = HeadV2Config(
            encoder=enc, feature_size=head.get("output_feature_size", 768),
            num_relation_classes=R,
            text_embedding_size=head.get("text_embedding_size",
                                         model_cfg.get("text_embedding_size", 1536)),
            experts=tuple(experts) or ("object_vision_only",),
            use_moe_gate=head.get("use_moe", False),
            moe_weight_type=head.get("moe_weight_type", "v1"), dtype=dtype)
    else:
        v2 = HeadV2Config.tiny_test() if tiny else HeadV2Config()

    if version == "v3":
        llm_preset = tpu.get("llm_preset", "tiny" if tiny else "llama2_7b")
        base_llm = (LlamaConfig.llama2_7b(dtype) if llm_preset == "llama2_7b"
                    else LlamaConfig.tiny_test(vocab_size=512))
        if tpu.get("llm"):
            base_llm = dataclasses.replace(base_llm, **dict(tpu["llm"]))
        shave = head.get("shave_language_decoder_at", 6)
        v3 = HeadV3Config(
            llm=dataclasses.replace(base_llm.truncate(min(shave, base_llm.n_layers)),
                                    causal=head.get("causal_mask", True)),
            input_feature_size=head.get("input_feature_size", seg.mask_dim),
            former_feature_size=head.get("former_feature_size", 32 if tiny else 768),
            output_feature_size=head.get("output_feature_size", 16 if tiny else 512),
            former_heads=2 if tiny else 12, former_intermediate=64 if tiny else 3072,
            num_relation_classes=R, ov_relation=head.get("ov_relation", False),
            sub_obj_merge_type=head.get("sub_obj_merge_type", "concat"),
            num_object_in_layers=head.get("num_object_in_layers", 0),
            num_object_out_layers=head.get("num_object_out_layers", 0),
            num_relation_out_layers=head.get("num_relation_out_layers", 0), dtype=dtype)
    else:
        v3 = HeadV3Config.tiny_test() if tiny else HeadV3Config()

    test_cfg = model_cfg.get("test_cfg") or {}
    return M2FRelationConfig(
        segmenter=seg, head_version=version, head_v1=v1, head_v2=v2, head_v3=v3,
        max_objects=max_obj, max_objects_padded=max_pad,
        embedding_add_cls=head.get("embedding_add_cls", True),
        merge_cls_type=head.get("merge_cls_type", "add"),
        # a sine encoding has no parameters: the dict's presence is the switch
        use_positional_encoding=head.get("positional_encoding") is not None,
        use_background_feature=head.get("use_background_feature", False),
        object_token_size=int(head.get("object_token_size", 1)),
        object_mask_thr=test_cfg.get("object_mask_thr", 0.8), input_hw=input_hw)


def _build_m2f_family(cfg, seed: int, device) -> PSGMask2FormerRelation:
    model_cfg, _, head = _parts(cfg)
    kw = model_kwargs_from(cfg)
    text_kv = None
    db_dir = model_cfg.get("text_embed_db_dir")
    if db_dir:
        from openpsg_tpu_torch.data.text_kv import TextKVStore

        text_kv = TextKVStore(path=f"{db_dir}/kv.db",
                              embedding_size=model_cfg.get("text_embedding_size", 1536))
    model = PSGMask2FormerRelation(
        m2f_relation_config(cfg), seed=seed, device=device, class_names=kw["class_names"],
        relation_names=kw["relation_names"], num_things=kw["num_things"], text_kv=text_kv)
    seg_path = model_cfg.get("segmenter_pretrained_path") or cfg.get("load_from")
    if seg_path and os.path.exists(str(seg_path)):
        model.load_segmenter_weights(str(seg_path))
    elif seg_path:
        print(f"[builder] segmenter checkpoint {seg_path!r} not found — "
              "using random segmenter init")
    return model


def build_detector_from_config(cfg, seed: int = 0, device=None):
    """Build the model a config describes on ``device`` (default the card):
    seeded random weights, then the trunk the config names, when it exists
    (``openseed_pretrained_path`` for PSG v4, ``segmenter_pretrained_path``
    or ``load_from`` for the closed-set family)."""
    mtype = _parts(cfg)[0].get("type", "OpenSeeDRelationV2")
    if mtype in CLOSED_SET_TYPES:
        return _build_m2f_family(cfg, seed, device)
    model = PSGv4(psg_v4_config_from(cfg), seed=seed, device=device, **model_kwargs_from(cfg))
    seg_path = _parts(cfg)[0].get("openseed_pretrained_path")
    if seg_path and os.path.exists(str(seg_path)):
        model.load_segmenter_weights(str(seg_path))
    elif seg_path:
        print(f"[builder] openseed_pretrained_path {seg_path!r} not found — "
              "using random segmenter init")
    return model
