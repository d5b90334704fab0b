"""Config dict → PSG v4 model (counterpart of
``openpsg_tpu/core/builder.py:25-245``, the ``OpenSeeDRelationV2`` branch).

    cfg = Config.fromfile("openpsg_tpu_torch/configs/psg/baseline_v4_ov.py")
    model = build_detector_from_config(cfg, seed=0)

:func:`psg_v4_config_from` resolves the config without building weights.
mmdet-only fields are accepted and ignored; sizing lives under the optional
``cfg.tpu`` dict, as in the JAX package.  Published assets load when their
paths exist: ``relation_head.tokenizer_path`` / ``llm_model_name`` (the LLM
tokenizer) and ``qformer_tokenizer_path`` / ``qformer_model_name`` (the
Q-Former's): a ``.model`` file through the SentencePiece reader, any other
path through the HF adapter; ``openseed_pretrained_path`` (a reference
OpenSeeD ``.pt`` or the ``convert_openseed`` tool's ``segmenter.pt``) and
``precomputed_class_embeds`` (an ``.npy``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

import torch

from openpsg_tpu_torch.data.vocab import OBJECT_CLASSES, RELATION_CLASSES
from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config, resolve_vocabulary
from openpsg_tpu_torch.models.llm.llama import LlamaConfig
from openpsg_tpu_torch.models.relation.head_v4 import HeadV4Config
from openpsg_tpu_torch.models.relation.qformer import QFormerConfig
from openpsg_tpu_torch.models.segmenter.openseed import SegmenterConfig

CLOSED_SET_TYPES = ("Mask2FormerRelation", "Mask2FormerRelationV2", "OpenSeeDRelation")


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
        raise NotImplementedError(
            f"detector {mtype!r} belongs to the closed-set v1-v3 family, which the "
            "PyTorch port brings with its closed-set slice; only OpenSeeDRelationV2 "
            "(PSG v4) is ported")
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
    relations = list(head.get("relation_classes", []) or cfg.get("relation_classes", []))
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


def build_detector_from_config(cfg, seed: int = 0, device=None) -> PSGv4:
    """Build the PSG v4 model a config describes on ``device`` (default the
    card): seeded random weights, then the OpenSeeD trunk that
    ``openseed_pretrained_path`` names, when it exists."""
    model = PSGv4(psg_v4_config_from(cfg), seed=seed, device=device, **model_kwargs_from(cfg))
    seg_path = _parts(cfg)[0].get("openseed_pretrained_path")
    if seg_path and os.path.exists(str(seg_path)):
        model.load_segmenter_weights(str(seg_path))
    elif seg_path:
        print(f"[builder] openseed_pretrained_path {seg_path!r} not found — "
              "using random segmenter init")
    return model
