"""HF InstructBLIP Q-Former and reference relation-head checkpoints (v1 to
v4) → head parameter trees (counterpart of
``openpsg_tpu/models/relation/weight_convert.py``).

The converters return the flax-layout tree of numpy arrays the JAX
package's converters return, equal to theirs; ``bridge.load_part`` loads
it into the head module (``RelationHeadV1`` to ``RelationHeadV4``).

The reference builds its relation Q-Former from an
``InstructBlipQFormerModel`` config (tokenizer from
``Salesforce/instructblip-vicuna-7b``, relation_transformer_head_v4.py:
78-86) and trains it from scratch; HF-format Q-Former weights slot into the
batched module.  Schema (verified against the installed transformers
``modeling_instructblip``):

  embeddings.word_embeddings.weight / position_embeddings.weight
  embeddings.layernorm.{weight,bias}           (norms [queries ; text])
  encoder.layer.{i}.attention.attention.{query,key,value}.{weight,bias}
  encoder.layer.{i}.attention.output.{dense,LayerNorm}.*
  encoder.layer.{i}.crossattention.attention.{query,key,value}.*  (kv in
                                               encoder_hidden_size)
  encoder.layer.{i}.crossattention.output.{dense,LayerNorm}.*
  encoder.layer.{i}.intermediate_query / output_query.*   (query FFN)
  encoder.layer.{i}.intermediate / output.*               (text FFN)
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from openpsg_tpu_torch.models.relation.qformer import QFormerConfig


def _t(a):
    return np.asarray(a).T


def _dense(state, base):
    return {"kernel": _t(state[base + ".weight"]),
            "bias": np.asarray(state[base + ".bias"])}


def _ln(state, base):
    return {"scale": np.asarray(state[base + ".weight"]),
            "bias": np.asarray(state[base + ".bias"])}


def convert_qformer(
    state: Mapping[str, np.ndarray],
    cfg: QFormerConfig,
    prefix: str = "",
) -> Dict[str, Any]:
    """→ params dict matching ``RelationQFormer`` exactly."""
    g = lambda k: state[prefix + k]
    out: Dict[str, Any] = {
        "word_embed": {"embedding": np.asarray(g("embeddings.word_embeddings.weight"))},
        "pos_embed": np.asarray(
            g("embeddings.position_embeddings.weight")
        )[: cfg.max_text_len],
        "embed_ln": _ln(state, prefix + "embeddings.layernorm"),
    }
    for i in range(cfg.num_layers):
        L = prefix + f"encoder.layer.{i}."
        out[f"self_attn{i}"] = {
            "q": _dense(state, L + "attention.attention.query"),
            "k": _dense(state, L + "attention.attention.key"),
            "v": _dense(state, L + "attention.attention.value"),
            "o": _dense(state, L + "attention.output.dense"),
        }
        out[f"self_ln{i}"] = _ln(state, L + "attention.output.LayerNorm")
        out[f"cross_attn{i}"] = {
            "q": _dense(state, L + "crossattention.attention.query"),
            "k": _dense(state, L + "crossattention.attention.key"),
            "v": _dense(state, L + "crossattention.attention.value"),
            "o": _dense(state, L + "crossattention.output.dense"),
        }
        out[f"cross_ln{i}"] = _ln(state, L + "crossattention.output.LayerNorm")
        out[f"ffn_q_up{i}"] = _dense(state, L + "intermediate_query.dense")
        out[f"ffn_q_down{i}"] = _dense(state, L + "output_query.dense")
        out[f"ffn_q_ln{i}"] = _ln(state, L + "output_query.LayerNorm")
        out[f"ffn_t_up{i}"] = _dense(state, L + "intermediate.dense")
        out[f"ffn_t_down{i}"] = _dense(state, L + "output.dense")
        out[f"ffn_t_ln{i}"] = _ln(state, L + "output.LayerNorm")
    return out


def _dense_ln(state, base):
    """torch ``nn.Sequential(Linear, LayerNorm)`` (the reference's fc_*
    blocks) → our DenseLN {dense, ln} scopes."""
    return {"dense": _dense(state, base + ".0"),
            "ln": _ln(state, base + ".1")}


def convert_relation_head_v1(
    state: Mapping[str, np.ndarray],
    cfg,                       # HeadV1Config
    prefix: str = "",
) -> Dict[str, Any]:
    """Reference ``RelationTransformerHead`` state_dict → RelationHeadV1
    params (relation_transformer_head.py:82-191).

    Covers the bilinear (non-prompt) path: fc_input / fc_output Sequential
    blocks, the truncated BERT tower (``model.model.*``), and the
    per-relation cls_q/cls_k projections.  ``fc_input`` is emitted only
    when the checkpoint carries it AND the head applies it (size
    mismatch, ref :153-156)."""
    import dataclasses

    from openpsg_tpu_torch.models.commons.weight_convert import convert_bert

    g = lambda k: prefix + k
    out: Dict[str, Any] = {}
    if g("fc_input.0.weight") in state and (
        cfg.input_feature_size != cfg.output_feature_size
        or cfg.encoder.hidden_size != cfg.output_feature_size
    ):
        out["fc_input"] = _dense_ln(state, g("fc_input"))
    out["fc_output"] = _dense_ln(state, g("fc_output"))
    enc_cfg = dataclasses.replace(
        cfg.encoder, hidden_size=cfg.output_feature_size
    )
    out["encoder"] = convert_bert(state, enc_cfg, prefix=g("model.model."))
    if not cfg.use_relation_prompts:
        # the head feeds input_embeds only — word_embed is never created
        # by init, and typed orbax restore rejects extra leaves
        out["encoder"].pop("word_embed", None)
        out["cls_q"] = _dense(state, g("cls_q"))
        out["cls_k"] = _dense(state, g("cls_k"))
        return out

    # prompt path (ref :106-139): fusion module + optionally the learnable
    # in-head semantic tower (semantic_model.model.*)
    from openpsg_tpu_torch.models.commons.weight_convert import (
        convert_interactive_fusion,
    )

    out["fusion"] = convert_interactive_fusion(
        state, g("fusion."), pred_type=cfg.fusion_pred_type,
        output_size=cfg.cls_qk_size,
    )
    if g("semantic_model.model.embeddings.position_embeddings.weight") in state:
        sem_cfg = dataclasses.replace(
            cfg.encoder, hidden_size=cfg.output_feature_size
        )
        out["sem_encoder"] = convert_bert(
            state, sem_cfg, prefix=g("semantic_model.model.")
        )
    if g("learnable_prompts_embedding") in state:
        # per-relation prompt rows [R, P, D] (ref :117-122) — same name
        out["learnable_prompts_embedding"] = np.asarray(
            state[g("learnable_prompts_embedding")]
        )
    return out


def convert_relation_head_v2(
    state: Mapping[str, np.ndarray],
    cfg,                       # HeadV2Config
    prefix: str = "",
) -> Dict[str, Any]:
    """Reference ``RelationTransformerHeadV2`` state_dict → RelationHeadV2
    params (relation_transformer_head_v2.py:70-181).

    Expert presence is detected from the checkpoint keys; the shared
    cross-attention tower ``sub_obj_pair_level_model`` maps onto our
    single ``pair_encoder`` scope, ``object_level_model`` onto
    ``object_encoder``.  The per-relation ``triplet_vision_text_cross_pred``
    ModuleList of Linear(D,1) stacks into ``ttwv_cls_w``/``ttwv_cls_b``."""
    import dataclasses

    from openpsg_tpu_torch.models.commons.weight_convert import convert_bert

    D = cfg.feature_size
    R = cfg.num_relation_classes
    g = lambda k: prefix + k
    has = lambda k: g(k) in state
    out: Dict[str, Any] = {}

    if has("object_level_model.model.embeddings.position_embeddings.weight"):
        out["object_encoder"] = convert_bert(
            state, dataclasses.replace(cfg.encoder, hidden_size=D),
            prefix=g("object_level_model.model."),
        )
        # v2 towers only ever see input_embeds — no word_embed in init
        out["object_encoder"].pop("word_embed", None)
        out["fc_ovo_input"] = _dense_ln(state, g("fc_object_vision_only_input"))
        out["fc_ovo_output"] = _dense_ln(state, g("fc_object_vision_only_output"))
        out["ovo_sub"] = _dense(state, g("object_vision_only_sub_pred"))
        out["ovo_obj"] = _dense(state, g("object_vision_only_obj_pred"))

    if has("sub_obj_pair_level_model.model.embeddings.position_embeddings.weight"):
        out["pair_encoder"] = convert_bert(
            state,
            dataclasses.replace(
                cfg.encoder, hidden_size=D, add_cross_attention=True
            ),
            prefix=g("sub_obj_pair_level_model.model."),
        )
        out["pair_encoder"].pop("word_embed", None)

    if has("fc_pair_vision_only_input.0.weight"):
        out["fc_pvo_input"] = _dense_ln(state, g("fc_pair_vision_only_input"))
        out["fc_pvo_output"] = _dense_ln(state, g("fc_pair_vision_only_output"))
        out["pvo_cls"] = _dense(state, g("pair_vision_only_pred"))

    if has("fc_pair_text_vision_cross_input.0.weight"):
        out["fc_pt2v_text_input"] = _dense_ln(
            state, g("fc_pair_text_vision_cross_input"))
        out["fc_pt2v_vision_prompt"] = _dense_ln(
            state, g("fc_pair_vision_prompt_input"))
        out["fc_pt2v_output"] = _dense_ln(
            state, g("fc_pair_text_vision_cross_output"))
        out["pt2v_cls"] = _dense(state, g("pair_text_vision_cross_pred"))

    if has("fc_pair_vision_text_cross_input.0.weight"):
        out["fc_pv2t_vision_input"] = _dense_ln(
            state, g("fc_pair_vision_text_cross_input"))
        out["fc_pv2t_text_prompt"] = _dense_ln(
            state, g("fc_pair_text_prompt_input"))
        out["fc_pv2t_output"] = _dense_ln(
            state, g("fc_pair_vision_text_cross_output"))
        out["pv2t_cls"] = _dense(state, g("pair_vision_text_cross_pred"))

    if has("fc_triplet_vision_text_cross_input.0.weight"):
        out["fc_ttwv_vision_input"] = _dense_ln(
            state, g("fc_triplet_vision_text_cross_input"))
        out["fc_ttwv_text_prompt"] = _dense_ln(
            state, g("fc_triplet_text_prompt_input"))
        out["fc_ttwv_output"] = _dense_ln(
            state, g("fc_triplet_vision_text_cross_output"))
        out["ttwv_cls_w"] = np.stack(
            [np.asarray(state[g(f"triplet_vision_text_cross_pred.{r}.weight")])[0]
             for r in range(R)], 0)                                  # [R, D]
        out["ttwv_cls_b"] = np.stack(
            [np.asarray(state[g(f"triplet_vision_text_cross_pred.{r}.bias")])[0]
             for r in range(R)], 0)                                  # [R]

    if has("moe.0.weight"):
        out["moe_input_pair_vision"] = _dense_ln(state, g("moe_input_pair_vision"))
        out["moe_input_pair_text"] = _dense_ln(state, g("moe_input_pair_text"))
        out["moe_input_triplet_text"] = _dense_ln(state, g("moe_input_triplet_text"))
        # moe Sequential: Linear,LN,ReLU,Linear,LN,ReLU,Linear → 0,1,3,4,6
        out["moe_fc1"] = {"dense": _dense(state, g("moe.0")),
                          "ln": _ln(state, g("moe.1"))}
        out["moe_fc2"] = {"dense": _dense(state, g("moe.3")),
                          "ln": _ln(state, g("moe.4"))}
        out["moe_out"] = _dense(state, g("moe.6"))

    return out


def convert_relation_head_v3(
    state: Mapping[str, np.ndarray],
    cfg,                       # HeadV3Config
    prefix: str = "",
) -> Dict[str, Any]:
    """Reference ``RelationTransformerHeadV3`` state_dict → RelationHeadV3
    params (relation_transformer_head_v3.py:104-160).

    The LLaMA trunk is FROZEN in the reference (PartCheckpointHook saves
    trainable-only state), so relation-head checkpoints never carry
    ``llama_model.*`` keys — load the LLM separately via
    :func:`openpsg_tpu_torch.models.llm.weight_convert.convert_llama`.  The
    closed/open-vocab path is detected from the checkpoint keys.  The
    o_in/o_out/r_out BertEncoder stacks (0 layers in the published
    config, baseline_v3_ov.py:68-70) convert via
    :func:`convert_bert_encoder` when present."""
    from openpsg_tpu_torch.models.commons.weight_convert import (
        convert_bert_encoder,
    )

    g = lambda k: prefix + k
    has = lambda k: g(k) in state
    out: Dict[str, Any] = {}

    if has("fc_object_vision_only_input.0.weight"):     # closed vocab
        out["fc_input"] = _dense_ln(state, g("fc_object_vision_only_input"))
        out["fc_output"] = _dense_ln(state, g("fc_object_vision_only_output"))
        out["ovo_sub"] = _dense(state, g("object_vision_only_sub_pred"))
        out["ovo_obj"] = _dense(state, g("object_vision_only_obj_pred"))
        return out

    out["fc_in_former"] = _dense_ln(state, g("fc_object_in_former"))
    out["fc_former_to_llm"] = _dense_ln(state, g("fc_object_former_to_llm"))
    out["fc_llm_to_former"] = _dense_ln(state, g("fc_object_llm_to_former"))
    out["fc_out_former"] = _dense_ln(state, g("fc_object_out_former"))
    out["fc_rel_llm_to_former"] = _dense_ln(
        state, g("fc_relation_llm_to_former"))
    out["fc_rel_out_former"] = _dense_ln(
        state, g("fc_relation_out_former"))
    out["fc_sub_pred"] = _dense(state, g("fc_sub_pred"))
    out["fc_obj_pred"] = _dense(state, g("fc_obj_pred"))
    for name, layers in (
        ("o_in_former", cfg.num_object_in_layers),
        ("o_out_former", cfg.num_object_out_layers),
        ("r_out_former", cfg.num_relation_out_layers),
    ):
        if layers > 0:
            out[name] = convert_bert_encoder(
                state, cfg.former_cfg(layers), prefix=g(name) + "."
            )
    return out


def convert_relation_head_v4(
    state: Mapping[str, np.ndarray],
    cfg,                       # HeadV4Config
    prefix: str = "",
) -> Dict[str, Any]:
    """Reference ``RelationTransformerHeadV4`` state_dict → RelationHeadV4
    params (relation_transformer_head_v4.py:75-105).

    Trainable surface only — the ``language_model`` (HF vicuna/llama,
    :99-105) is frozen in the reference and absent from
    PartCheckpointHook checkpoints; load it via ``convert_llama``.
    Covers: timm PatchEmbed conv (OIHW → HWIO), the relation/cls query
    Parameters (leading broadcast dim dropped), the InstructBLIP
    Q-Former (via :func:`convert_qformer`), the binary/multiclass
    existence classifiers, and the LLM ``language_projection``."""
    g = lambda k: prefix + k
    has = lambda k: g(k) in state
    out: Dict[str, Any] = {
        "patch_embed": {
            "kernel": np.asarray(
                state[g("patch_embed.proj.weight")]
            ).transpose(2, 3, 1, 0),                        # OIHW → HWIO
            "bias": np.asarray(state[g("patch_embed.proj.bias")]),
        },
        "relation_query": np.asarray(state[g("relation_query")])[0],
        "rel_cls_query": np.asarray(state[g("rel_cls_query")])[0],
        "qformer": convert_qformer(
            state, cfg.qformer, prefix=g("relation_qformer.")
        ),
        "language_projection": _dense(state, g("language_projection")),
    }
    if has("binary_rel_cls_pred.weight"):
        out["binary_rel_cls"] = _dense(state, g("binary_rel_cls_pred"))
    if has("multiclass_rel_cls_pred.weight"):
        out["multiclass_rel_cls"] = _dense(
            state, g("multiclass_rel_cls_pred"))
    return out
