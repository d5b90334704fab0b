"""HF BERT / CLIP text checkpoints → :class:`BertStyleEncoder` parameters
(counterpart of ``openpsg_tpu/models/commons/weight_convert.py``).

The converters return the flax-layout tree the JAX package's converters
return (numpy arrays, equal to theirs); :func:`openpsg_tpu_torch.models.
commons.text_encoder.load_tree` loads it into the port's module.

  embeddings.word_embeddings.weight        → word_embed.embedding
  embeddings.position_embeddings.weight    → pos_embed
  embeddings.LayerNorm.{weight,bias}       → embed_ln.{scale,bias}
  encoder.layer.{i}.attention.self.q/k/v   → layers.self_attn.{query,key,value}
                                             (kernel [D, H, hd] reshaped)
  encoder.layer.{i}.attention.output.dense → layers.self_attn.out
  ...attention.output.LayerNorm            → layers.self_ln
  ...intermediate.dense / output.dense     → layers.ffn_up / ffn_down
  ...output.LayerNorm                      → layers.ffn_ln
  pooler.dense                             → pooler

Truncation = take the first ``num_layers`` stacked layers.
``convert_clip_text`` maps HF CLIPTextModel onto the pre-LN variant
(``BertStyleConfig(pre_ln=True, quick_gelu=True)``).
``convert_torch_decoder`` maps torch's ``nn.TransformerDecoder`` onto the
graph transformer's decoders, ``convert_interactive_fusion`` the
reference's InteractiveFusionModule.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from openpsg_tpu_torch.models.commons.text_encoder import BertStyleConfig


def _t(a):
    return np.asarray(a).T


def _bert_layer_stack(
    state: Mapping[str, np.ndarray],
    cfg: BertStyleConfig,
    layer_key,
) -> Dict[str, Any]:
    """Stack the per-layer tensors of an HF BERT layer list onto our
    ``nn.scan`` layout.  ``layer_key(i, k)`` returns the state-dict key of
    tensor ``k`` in layer ``i`` (BertModel: ``encoder.layer.{i}.{k}``; a
    raw BertEncoder: ``layer.{i}.{k}``)."""
    D = cfg.hidden_size
    H = cfg.num_heads
    hd = D // H

    layers: Dict[str, Any] = {}

    def stack(fn):
        return np.stack([fn(i) for i in range(cfg.num_layers)], 0)

    def lw(i, k):
        return np.asarray(state[layer_key(i, k)])

    layers["self_attn"] = {
        "query": {
            "kernel": stack(lambda i: _t(lw(i, "attention.self.query.weight")).reshape(D, H, hd)),
            "bias": stack(lambda i: lw(i, "attention.self.query.bias").reshape(H, hd)),
        },
        "key": {
            "kernel": stack(lambda i: _t(lw(i, "attention.self.key.weight")).reshape(D, H, hd)),
            "bias": stack(lambda i: lw(i, "attention.self.key.bias").reshape(H, hd)),
        },
        "value": {
            "kernel": stack(lambda i: _t(lw(i, "attention.self.value.weight")).reshape(D, H, hd)),
            "bias": stack(lambda i: lw(i, "attention.self.value.bias").reshape(H, hd)),
        },
        "out": {
            "kernel": stack(lambda i: _t(lw(i, "attention.output.dense.weight")).reshape(H, hd, D)),
            "bias": stack(lambda i: lw(i, "attention.output.dense.bias")),
        },
    }
    layers["self_ln"] = {
        "scale": stack(lambda i: lw(i, "attention.output.LayerNorm.weight")),
        "bias": stack(lambda i: lw(i, "attention.output.LayerNorm.bias")),
    }
    layers["ffn_up"] = {
        "kernel": stack(lambda i: _t(lw(i, "intermediate.dense.weight"))),
        "bias": stack(lambda i: lw(i, "intermediate.dense.bias")),
    }
    layers["ffn_down"] = {
        "kernel": stack(lambda i: _t(lw(i, "output.dense.weight"))),
        "bias": stack(lambda i: lw(i, "output.dense.bias")),
    }
    layers["ffn_ln"] = {
        "scale": stack(lambda i: lw(i, "output.LayerNorm.weight")),
        "bias": stack(lambda i: lw(i, "output.LayerNorm.bias")),
    }
    if cfg.add_cross_attention:
        # decoder-mode BERT (BertWrapper add_cross_attention=True,
        # bert_wrapper.py:28-30): HF inserts a crossattention block with
        # the same self/output split between self-attn and the FFN
        layers["cross_attn"] = {
            "query": {
                "kernel": stack(lambda i: _t(lw(i, "crossattention.self.query.weight")).reshape(D, H, hd)),
                "bias": stack(lambda i: lw(i, "crossattention.self.query.bias").reshape(H, hd)),
            },
            "key": {
                "kernel": stack(lambda i: _t(lw(i, "crossattention.self.key.weight")).reshape(D, H, hd)),
                "bias": stack(lambda i: lw(i, "crossattention.self.key.bias").reshape(H, hd)),
            },
            "value": {
                "kernel": stack(lambda i: _t(lw(i, "crossattention.self.value.weight")).reshape(D, H, hd)),
                "bias": stack(lambda i: lw(i, "crossattention.self.value.bias").reshape(H, hd)),
            },
            "out": {
                "kernel": stack(lambda i: _t(lw(i, "crossattention.output.dense.weight")).reshape(H, hd, D)),
                "bias": stack(lambda i: lw(i, "crossattention.output.dense.bias")),
            },
        }
        layers["cross_ln"] = {
            "scale": stack(lambda i: lw(i, "crossattention.output.LayerNorm.weight")),
            "bias": stack(lambda i: lw(i, "crossattention.output.LayerNorm.bias")),
        }
    return layers


def convert_bert_encoder(
    state: Mapping[str, np.ndarray],
    cfg: BertStyleConfig,
    prefix: str = "",
) -> Dict[str, Any]:
    """Raw HF ``BertEncoder`` (layer stack only, no embeddings/pooler) →
    params for ``BertStyleEncoder`` with ``bare=True`` — head v3's
    o_in/o_out/r_out formers (relation_transformer_head_v3.py:116-121)."""
    assert cfg.bare, "convert_bert_encoder targets bare=True configs"
    return {
        "layers": _bert_layer_stack(
            state, cfg, lambda i, k: f"{prefix}layer.{i}.{k}"
        )
    }


def convert_bert(
    state: Mapping[str, np.ndarray],
    cfg: BertStyleConfig,
    prefix: str = "",
) -> Dict[str, Any]:
    g = lambda k: np.asarray(state[prefix + k])
    layers = _bert_layer_stack(
        state, cfg, lambda i, k: f"{prefix}encoder.layer.{i}.{k}"
    )

    pos = g("embeddings.position_embeddings.weight")[: cfg.max_len]
    tt_key = prefix + "embeddings.token_type_embeddings.weight"
    if tt_key in state:
        # HF BERT adds token_type_embeddings[token_type_ids] alongside the
        # position table before the embedding LayerNorm.  The reference only
        # ever feeds single-segment input (token_type_ids = 0 throughout
        # bert_wrapper.py), so fold segment-0's row into the position table —
        # exactly equivalent there, and required for value parity: row 0 of a
        # trained BERT's token-type table is NOT zero.
        pos = pos + np.asarray(state[tt_key])[0][None]

    return {
        "word_embed": {"embedding": g("embeddings.word_embeddings.weight")},
        "pos_embed": pos,
        "embed_ln": {
            "scale": g("embeddings.LayerNorm.weight"),
            "bias": g("embeddings.LayerNorm.bias"),
        },
        "layers": layers,
        "pooler": {
            "kernel": _t(g("pooler.dense.weight")),
            "bias": g("pooler.dense.bias"),
        },
    }


def convert_clip_text(
    state: Mapping[str, np.ndarray],
    cfg: BertStyleConfig,
    prefix: str = "text_model.",
) -> Dict[str, Any]:
    """HF CLIPTextModel → BertStyleEncoder(pre_ln=True, quick_gelu=True).

    Layout: token/position embeddings (no embedding LN), per-layer
    layer_norm1 (pre-attn) / layer_norm2 (pre-mlp), q/k/v/out projections,
    mlp fc1/fc2, final_layer_norm."""
    assert cfg.pre_ln, "CLIP weights require pre_ln=True"
    D, H = cfg.hidden_size, cfg.num_heads
    hd = D // H
    g = lambda k: np.asarray(state[prefix + k])

    def lw(i, k):
        return np.asarray(state[prefix + f"encoder.layers.{i}.{k}"])

    def stack(fn):
        return np.stack([fn(i) for i in range(cfg.num_layers)], 0)

    layers = {
        "attn_pre_ln": {
            "scale": stack(lambda i: lw(i, "layer_norm1.weight")),
            "bias": stack(lambda i: lw(i, "layer_norm1.bias")),
        },
        "self_attn": {
            "query": {"kernel": stack(lambda i: _t(lw(i, "self_attn.q_proj.weight")).reshape(D, H, hd)),
                      "bias": stack(lambda i: lw(i, "self_attn.q_proj.bias").reshape(H, hd))},
            "key": {"kernel": stack(lambda i: _t(lw(i, "self_attn.k_proj.weight")).reshape(D, H, hd)),
                    "bias": stack(lambda i: lw(i, "self_attn.k_proj.bias").reshape(H, hd))},
            "value": {"kernel": stack(lambda i: _t(lw(i, "self_attn.v_proj.weight")).reshape(D, H, hd)),
                      "bias": stack(lambda i: lw(i, "self_attn.v_proj.bias").reshape(H, hd))},
            "out": {"kernel": stack(lambda i: _t(lw(i, "self_attn.out_proj.weight")).reshape(H, hd, D)),
                    "bias": stack(lambda i: lw(i, "self_attn.out_proj.bias"))},
        },
        "ffn_pre_ln": {
            "scale": stack(lambda i: lw(i, "layer_norm2.weight")),
            "bias": stack(lambda i: lw(i, "layer_norm2.bias")),
        },
        "ffn_up": {"kernel": stack(lambda i: _t(lw(i, "mlp.fc1.weight"))),
                   "bias": stack(lambda i: lw(i, "mlp.fc1.bias"))},
        "ffn_down": {"kernel": stack(lambda i: _t(lw(i, "mlp.fc2.weight"))),
                     "bias": stack(lambda i: lw(i, "mlp.fc2.bias"))},
    }
    return {
        "word_embed": {"embedding": g("embeddings.token_embedding.weight")},
        "pos_embed": g("embeddings.position_embedding.weight")[: cfg.max_len],
        "layers": layers,
        "final_ln": {
            "scale": g("final_layer_norm.weight"),
            "bias": g("final_layer_norm.bias"),
        },
    }


def convert_torch_decoder(
    state: Mapping[str, np.ndarray],
    prefix: str,
    num_layers: int,
    dim: int,
) -> Dict[str, Any]:
    """``nn.TransformerDecoder`` state → our TorchTransformerDecoder
    (graph_transformer.py).  Splits MultiheadAttention's packed
    ``in_proj_weight`` [3D, D] into q/k/v Dense kernels."""

    def lw(i, k):
        return np.asarray(state[f"{prefix}layers.{i}.{k}"])

    def stack(fn):
        return np.stack([fn(i) for i in range(num_layers)], 0)

    def mha(torch_name):
        def part(j, bias=False):
            if bias:
                return stack(
                    lambda i: lw(i, f"{torch_name}.in_proj_bias")[
                        j * dim:(j + 1) * dim]
                )
            return stack(
                lambda i: _t(
                    lw(i, f"{torch_name}.in_proj_weight")[
                        j * dim:(j + 1) * dim]
                )
            )

        return {
            "q": {"kernel": part(0), "bias": part(0, bias=True)},
            "k": {"kernel": part(1), "bias": part(1, bias=True)},
            "v": {"kernel": part(2), "bias": part(2, bias=True)},
            "out": {
                "kernel": stack(lambda i: _t(lw(i, f"{torch_name}.out_proj.weight"))),
                "bias": stack(lambda i: lw(i, f"{torch_name}.out_proj.bias")),
            },
        }

    def ln(torch_name):
        return {
            "scale": stack(lambda i: lw(i, f"{torch_name}.weight")),
            "bias": stack(lambda i: lw(i, f"{torch_name}.bias")),
        }

    return {
        "layers": {
            "self_attn": mha("self_attn"),
            "cross_attn": mha("multihead_attn"),
            "ln1": ln("norm1"),
            "ln2": ln("norm2"),
            "ln3": ln("norm3"),
            "ffn_up": {
                "kernel": stack(lambda i: _t(lw(i, "linear1.weight"))),
                "bias": stack(lambda i: lw(i, "linear1.bias")),
            },
            "ffn_down": {
                "kernel": stack(lambda i: _t(lw(i, "linear2.weight"))),
                "bias": stack(lambda i: lw(i, "linear2.bias")),
            },
        }
    }


def convert_interactive_fusion(
    state: Mapping[str, np.ndarray],
    prefix: str,
    pred_type: str,
    output_size: int,
    num_gt_layers: int = 3,
) -> Dict[str, Any]:
    """Reference ``InteractiveFusionModule`` state → our params
    (interactive_fusion_module.py:8-26).  Detects the graph-transformer
    variant from the checkpoint keys (cls_s is an MLP there, a plain
    Linear otherwise)."""

    def dense(base):
        return {"kernel": _t(np.asarray(state[base + ".weight"])),
                "bias": np.asarray(state[base + ".bias"])}

    def ref_mlp(base):
        return {
            "fc1": dense(base + ".fc1"),
            "act": {"scale": np.asarray(state[base + ".act.weight"]),
                    "bias": np.asarray(state[base + ".act.bias"])},
            "fc2": dense(base + ".fc2"),
        }

    g = lambda k: prefix + k
    has_graph = g("fc_node.weight") in state
    out: Dict[str, Any] = {}
    if has_graph:
        out["fc_node"] = dense(g("fc_node"))
        out["fc_edge"] = dense(g("fc_edge"))
        out["graph"] = {
            "edge2node": convert_torch_decoder(
                state, g("graph_transformer.edge2node_decoder."),
                num_gt_layers, output_size,
            ),
            "node2edge": convert_torch_decoder(
                state, g("graph_transformer.node2edge_decoder."),
                num_gt_layers, output_size,
            ),
        }
        out["cls_s"] = ref_mlp(g("cls_s"))
        out["cls_o"] = ref_mlp(g("cls_o"))
        out["cls_r"] = ref_mlp(g("cls_r"))
    else:
        out["cls_s"] = dense(g("cls_s"))
        out["cls_o"] = dense(g("cls_o"))
        out["cls_r"] = dense(g("cls_r"))
    if pred_type == "attention":
        out["fc_q"] = ref_mlp(g("fc_q"))
        out["fc_k"] = ref_mlp(g("fc_k"))
    return out
