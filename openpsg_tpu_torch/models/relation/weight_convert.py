"""HF InstructBLIP Q-Former and reference v4 relation-head checkpoints →
head parameter trees (counterpart of
``openpsg_tpu/models/relation/weight_convert.py``, its v4 part).

The converters return the flax-layout tree of numpy arrays the JAX
package's converters return, equal to theirs; ``bridge.load_part`` loads
it into :class:`RelationHeadV4`.  The v1-v3 heads' converters come with
the closed-set slice.

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
