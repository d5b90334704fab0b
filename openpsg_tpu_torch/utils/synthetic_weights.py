"""Seeded checkpoints in the published layouts, for tests and the smoke run.

No published weights are in the repository and none are downloaded, so the
converters are driven by state dicts with the canonical tensor names and
shapes, filled from a seeded ``numpy`` generator:

* :func:`synthetic_openseed_state`: an OpenSeeD checkpoint (Swin under
  ``backbone.``, the MaskDINO pixel decoder and query decoder under
  ``sem_seg_head.``, the X-Decoder CLIP language encoder and ``lang_proj``);
* :func:`synthetic_hf_state`: an HF ``LlamaForCausalLM``;
* :func:`synthetic_clip_state`: an HF ``CLIPTextModel``;
* :func:`synthetic_bert_state`: an HF ``BertModel``;
* :func:`synthetic_relation_v4_state`: the reference v4 relation head as a
  ``PartCheckpointHook`` saves it (``relation_head.*`` without the frozen
  ``language_model``);
* :func:`synthetic_mask2former_state`: an mmdet Mask2Former checkpoint
  (ResNet or mmdet-Swin under ``backbone.``, the MSDeformAttn pixel decoder
  and the masked-attention decoder under ``panoptic_head.``);
* :func:`synthetic_relation_v1_state`: the reference v1 relation head as
  ``PartCheckpointHook`` saves it (``relation_head.*`` and
  ``object_cls_embed.weight``);
* :func:`toy_clip_merges`: a CLIP BPE merges file over a word list.

With ``fan_in=False`` (the default) weights are N(0, 1), the values the JAX
package's test helpers (tests/test_weight_convert.py) draw in the same
order; ``fan_in=True`` scales each weight by 1/√(fan-in) from the same
draws, which keeps activations at full width in range.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple

import numpy as np

State = Dict[str, np.ndarray]


def _normal(rng, shape, fan_in=None):
    a = rng.normal(size=shape).astype(np.float32)
    return a / np.float32(np.sqrt(fan_in)) if fan_in else a


def synthetic_hf_state(cfg, seed: int = 0, fan_in: bool = False) -> State:
    """HF Llama state dict of ``cfg`` (a ``LlamaConfig``'s widths)."""
    rng = np.random.default_rng(seed)
    w = lambda o, i: _normal(rng, (o, i), i if fan_in else None)
    hd = cfg.dim // cfg.n_heads
    kv = cfg.n_kv_heads * hd
    s = {"model.embed_tokens.weight": _normal(rng, (cfg.vocab_size, cfg.dim))}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        s[p + "self_attn.q_proj.weight"] = w(cfg.dim, cfg.dim)
        s[p + "self_attn.k_proj.weight"] = w(kv, cfg.dim)
        s[p + "self_attn.v_proj.weight"] = w(kv, cfg.dim)
        s[p + "self_attn.o_proj.weight"] = w(cfg.dim, cfg.dim)
        s[p + "mlp.gate_proj.weight"] = w(cfg.ffn_hidden, cfg.dim)
        s[p + "mlp.up_proj.weight"] = w(cfg.ffn_hidden, cfg.dim)
        s[p + "mlp.down_proj.weight"] = w(cfg.dim, cfg.ffn_hidden)
        s[p + "input_layernorm.weight"] = np.ones(cfg.dim, np.float32)
        s[p + "post_attention_layernorm.weight"] = np.ones(cfg.dim, np.float32)
    s["model.norm.weight"] = np.ones(cfg.dim, np.float32)
    s["lm_head.weight"] = w(cfg.vocab_size, cfg.dim)
    return s


def synthetic_bert_state(cfg, seed: int = 0) -> State:
    """HF BERT state dict of ``cfg`` (a ``BertStyleConfig``'s widths)."""
    rng = np.random.default_rng(seed)
    D, I, V = cfg.hidden_size, cfg.intermediate, cfg.vocab_size
    ones, zeros = (lambda n: np.ones(n, np.float32)), (lambda n: np.zeros(n, np.float32))
    s = {
        "embeddings.word_embeddings.weight": _normal(rng, (V, D)),
        "embeddings.position_embeddings.weight": _normal(rng, (512, D)),
        "embeddings.LayerNorm.weight": ones(D),
        "embeddings.LayerNorm.bias": zeros(D),
        "pooler.dense.weight": _normal(rng, (D, D)),
        "pooler.dense.bias": zeros(D),
    }
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        for n in ("query", "key", "value"):
            s[p + f"attention.self.{n}.weight"] = _normal(rng, (D, D))
            s[p + f"attention.self.{n}.bias"] = zeros(D)
        s[p + "attention.output.dense.weight"] = _normal(rng, (D, D))
        s[p + "attention.output.dense.bias"] = zeros(D)
        s[p + "attention.output.LayerNorm.weight"] = ones(D)
        s[p + "attention.output.LayerNorm.bias"] = zeros(D)
        s[p + "intermediate.dense.weight"] = _normal(rng, (I, D))
        s[p + "intermediate.dense.bias"] = zeros(I)
        s[p + "output.dense.weight"] = _normal(rng, (D, I))
        s[p + "output.dense.bias"] = zeros(D)
        s[p + "output.LayerNorm.weight"] = ones(D)
        s[p + "output.LayerNorm.bias"] = zeros(D)
    return s


def synthetic_clip_state(cfg, seed: int = 0) -> State:
    """HF ``CLIPTextModel`` state dict of ``cfg`` (a ``BertStyleConfig``)."""
    rng = np.random.default_rng(seed)
    D, I, V = cfg.hidden_size, cfg.intermediate, cfg.vocab_size
    s = {
        "text_model.embeddings.token_embedding.weight": _normal(rng, (V, D)),
        "text_model.embeddings.position_embedding.weight": _normal(rng, (77, D)),
        "text_model.final_layer_norm.weight": np.ones(D, np.float32),
        "text_model.final_layer_norm.bias": np.zeros(D, np.float32),
    }
    for i in range(cfg.num_layers):
        p = f"text_model.encoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            s[p + f"self_attn.{n}.weight"] = _normal(rng, (D, D))
            s[p + f"self_attn.{n}.bias"] = np.zeros(D, np.float32)
        for n in ("layer_norm1", "layer_norm2"):
            s[p + f"{n}.weight"] = np.ones(D, np.float32)
            s[p + f"{n}.bias"] = np.zeros(D, np.float32)
        s[p + "mlp.fc1.weight"] = _normal(rng, (I, D))
        s[p + "mlp.fc1.bias"] = np.zeros(I, np.float32)
        s[p + "mlp.fc2.weight"] = _normal(rng, (D, I))
        s[p + "mlp.fc2.bias"] = np.zeros(D, np.float32)
    return s


def synthetic_openseed_state(cfg, num_lang_layers: int = 2, lang_dim: int = 32,
                             vocab: int = 64, seed: int = 0, fan_in: bool = False) -> State:
    """OpenSeeD checkpoint of a ``SegmenterConfig``'s geometry in the key
    schema ``convert_openseed`` documents; the CLIP language tower has
    ``num_lang_layers`` layers of width ``lang_dim`` over ``vocab`` tokens.
    Norm scales are 1 and biases 0, except where noted."""
    rng = np.random.default_rng(seed)
    C, K, L = cfg.dim, cfg.num_points, cfg.total_levels
    nH = 8
    s: State = {}

    def lin(o, i):
        return _normal(rng, (o, i), i if fan_in else None)

    def conv(o, i, k):
        return _normal(rng, (o, i, k, k), i * k * k if fan_in else None)

    def norm(base, d=None):
        s[base + ".weight"] = np.ones(d or C, np.float32)
        s[base + ".bias"] = np.zeros(d or C, np.float32)

    # ---- backbone (standard Swin names under 'backbone.') ----
    dims = [cfg.embed_dim * (2 ** i) for i in range(len(cfg.depths))]
    s["backbone.patch_embed.proj.weight"] = conv(cfg.embed_dim, 3, 4)
    s["backbone.patch_embed.proj.bias"] = np.zeros(cfg.embed_dim, np.float32)
    norm("backbone.patch_embed.norm", cfg.embed_dim)
    for st, depth in enumerate(cfg.depths):
        d = dims[st]
        for b in range(depth):
            p = f"backbone.layers.{st}.blocks.{b}."
            norm(p + "norm1", d)
            norm(p + "norm2", d)
            s[p + "attn.qkv.weight"] = lin(3 * d, d)
            s[p + "attn.qkv.bias"] = np.zeros(3 * d, np.float32)
            s[p + "attn.proj.weight"] = lin(d, d)
            s[p + "attn.proj.bias"] = np.zeros(d, np.float32)
            s[p + "attn.relative_position_bias_table"] = rng.normal(
                size=((2 * cfg.window - 1) ** 2, cfg.num_heads[st])).astype(np.float32)
            s[p + "mlp.fc1.weight"] = lin(4 * d, d)
            s[p + "mlp.fc1.bias"] = np.zeros(4 * d, np.float32)
            s[p + "mlp.fc2.weight"] = lin(d, 4 * d)
            s[p + "mlp.fc2.bias"] = np.zeros(d, np.float32)
        if st < len(cfg.depths) - 1:
            s[f"backbone.layers.{st}.downsample.reduction.weight"] = lin(2 * d, 4 * d)
            norm(f"backbone.layers.{st}.downsample.norm", 4 * d)
        norm(f"backbone.norm{st}", d)

    # ---- pixel decoder; input_proj order (32, 16, 8, 64) ----
    pd = "sem_seg_head.pixel_decoder."
    in_ch = {32: dims[3], 16: dims[2], 8: dims[1], 64: dims[3]}
    for j, stride in enumerate((32, 16, 8, 64)[:L]):
        k = 1 if stride <= 32 else 3
        s[pd + f"input_proj.{j}.0.weight"] = conv(C, in_ch[stride], k)
        s[pd + f"input_proj.{j}.0.bias"] = np.zeros(C, np.float32)
        norm(pd + f"input_proj.{j}.1")
    s[pd + "transformer.level_embed"] = rng.normal(size=(L, C)).astype(np.float32)

    def msda(base):
        s[base + ".sampling_offsets.weight"] = lin(nH * L * K * 2, C)
        s[base + ".sampling_offsets.bias"] = np.zeros(nH * L * K * 2, np.float32)
        s[base + ".attention_weights.weight"] = lin(nH * L * K, C)
        s[base + ".attention_weights.bias"] = np.zeros(nH * L * K, np.float32)
        s[base + ".value_proj.weight"] = lin(C, C)
        s[base + ".value_proj.bias"] = np.zeros(C, np.float32)
        s[base + ".output_proj.weight"] = lin(C, C)
        s[base + ".output_proj.bias"] = np.zeros(C, np.float32)

    for layer in range(cfg.enc_layers):
        base = pd + f"transformer.encoder.layers.{layer}"
        msda(base + ".self_attn")
        norm(base + ".norm1")
        s[base + ".linear1.weight"] = lin(cfg.ffn_hidden, C)
        s[base + ".linear1.bias"] = np.zeros(cfg.ffn_hidden, np.float32)
        s[base + ".linear2.weight"] = lin(C, cfg.ffn_hidden)
        s[base + ".linear2.bias"] = np.zeros(C, np.float32)
        norm(base + ".norm2")

    s[pd + "adapter_1.weight"] = conv(C, dims[0], 1)
    norm(pd + "adapter_1.norm")
    s[pd + "layer_1.weight"] = conv(C, C, 3)
    norm(pd + "layer_1.norm")
    s[pd + "mask_features.weight"] = conv(cfg.mask_dim, C, 1)
    s[pd + "mask_features.bias"] = np.zeros(cfg.mask_dim, np.float32)

    # ---- predictor (query decoder) ----
    pr = "sem_seg_head.predictor."
    s[pr + "class_embed"] = lin(C, cfg.proj_dim)
    s[pr + "enc_output.weight"] = lin(C, C)
    s[pr + "enc_output.bias"] = np.zeros(C, np.float32)
    norm(pr + "enc_output_norm")
    norm(pr + "decoder_norm")
    s[pr + "label_enc.weight"] = lin(134, C)  # denoising training only: dropped

    def mlp(base, widths):
        for j, (o, i) in enumerate(widths):
            s[base + f".layers.{j}.weight"] = lin(o, i)
            s[base + f".layers.{j}.bias"] = np.zeros(o, np.float32)

    mlp(pr + "mask_embed", [(C, C), (C, C), (cfg.mask_dim, C)])
    mlp(pr + "decoder.ref_point_head", [(C, 2 * C), (C, C)])
    for layer in range(cfg.dec_layers + 1):  # +1: the two-stage proposal head
        mlp(pr + f"bbox_embed.{layer}", [(C, C), (C, C), (4, C)])
    for layer in range(cfg.dec_layers):
        base = pr + f"decoder.layers.{layer}"
        msda(base + ".cross_attn")
        norm(base + ".norm1")
        s[base + ".self_attn.in_proj_weight"] = lin(3 * C, C)
        s[base + ".self_attn.in_proj_bias"] = np.zeros(3 * C, np.float32)
        s[base + ".self_attn.out_proj.weight"] = lin(C, C)
        s[base + ".self_attn.out_proj.bias"] = np.zeros(C, np.float32)
        norm(base + ".norm2")
        s[base + ".linear1.weight"] = lin(cfg.ffn_hidden, C)
        s[base + ".linear1.bias"] = np.zeros(cfg.ffn_hidden, np.float32)
        s[base + ".linear2.weight"] = lin(C, cfg.ffn_hidden)
        s[base + ".linear2.bias"] = np.zeros(C, np.float32)
        norm(base + ".norm3")

    # ---- language encoder (X-Decoder CLIP tower) ----
    le = pr + "lang_encoder."
    s[le + "logit_scale"] = np.asarray(2.659, np.float32)
    s[le + "lang_proj"] = lin(lang_dim, cfg.proj_dim)
    s[le + "lang_encoder.token_embedding.weight"] = _normal(rng, (vocab, lang_dim))
    s[le + "lang_encoder.positional_embedding"] = rng.normal(size=(77, lang_dim)).astype(np.float32)
    for i in range(num_lang_layers):
        base = le + f"lang_encoder.transformer.resblocks.{i}"
        s[base + ".attn.in_proj_weight"] = lin(3 * lang_dim, lang_dim)
        s[base + ".attn.in_proj_bias"] = np.zeros(3 * lang_dim, np.float32)
        s[base + ".attn.out_proj.weight"] = lin(lang_dim, lang_dim)
        s[base + ".attn.out_proj.bias"] = np.zeros(lang_dim, np.float32)
        norm(base + ".ln_1", lang_dim)
        norm(base + ".ln_2", lang_dim)
        s[base + ".mlp.c_fc.weight"] = lin(4 * lang_dim, lang_dim)
        s[base + ".mlp.c_fc.bias"] = np.zeros(4 * lang_dim, np.float32)
        s[base + ".mlp.c_proj.weight"] = lin(lang_dim, 4 * lang_dim)
        s[base + ".mlp.c_proj.bias"] = np.zeros(lang_dim, np.float32)
    norm(le + "lang_encoder.ln_final", lang_dim)
    return s


def synthetic_relation_v4_state(head_cfg, mask_dim: int, seed: int = 0,
                                fan_in: bool = False, prefix: str = "relation_head.") -> State:
    """The reference ``RelationTransformerHeadV4`` trainable state of a
    ``HeadV4Config`` (as ``PSGv4`` resolves it: Q-Former vocabulary and
    text length), keys under ``prefix``: timm PatchEmbed, the query
    parameters with their leading broadcast axis, the InstructBLIP Q-Former
    (HF names, a 512-row position table), the existence classifiers and
    the LLM projection.  Biases and LayerNorm shifts are drawn too, so a
    dropped bias shows."""
    rng = np.random.default_rng(seed)
    q = head_cfg.qformer
    D, De, I, V = q.hidden_size, q.encoder_hidden_size, q.intermediate, q.vocab_size
    s: State = {}

    def dense(base, o, i):
        s[base + ".weight"] = _normal(rng, (o, i), i if fan_in else None)
        s[base + ".bias"] = _normal(rng, (o,)) * np.float32(0.02)

    def ln(base, d):
        s[base + ".weight"] = 1.0 + _normal(rng, (d,)) * np.float32(0.02)
        s[base + ".bias"] = _normal(rng, (d,)) * np.float32(0.02)

    p = head_cfg.patch_size
    s["patch_embed.proj.weight"] = _normal(rng, (head_cfg.object_feature_size, mask_dim, p, p),
                                           mask_dim * p * p if fan_in else None)
    s["patch_embed.proj.bias"] = _normal(rng, (head_cfg.object_feature_size,)) * np.float32(0.02)
    s["relation_query"] = _normal(rng, (1, q.num_relation_queries, D))
    s["rel_cls_query"] = _normal(rng, (1, 1, D))
    qf = "relation_qformer."
    s[qf + "embeddings.word_embeddings.weight"] = _normal(rng, (V, D))
    s[qf + "embeddings.position_embeddings.weight"] = _normal(rng, (512, D))
    ln(qf + "embeddings.layernorm", D)
    for i in range(q.num_layers):
        b = qf + f"encoder.layer.{i}."
        for n in ("query", "key", "value"):
            dense(b + f"attention.attention.{n}", D, D)
        dense(b + "attention.output.dense", D, D)
        ln(b + "attention.output.LayerNorm", D)
        dense(b + "crossattention.attention.query", D, D)
        dense(b + "crossattention.attention.key", D, De)
        dense(b + "crossattention.attention.value", D, De)
        dense(b + "crossattention.output.dense", D, D)
        ln(b + "crossattention.output.LayerNorm", D)
        dense(b + "intermediate_query.dense", I, D)
        dense(b + "output_query.dense", D, I)
        ln(b + "output_query.LayerNorm", D)
        dense(b + "intermediate.dense", I, D)
        dense(b + "output.dense", D, I)
        ln(b + "output.LayerNorm", D)
    dense("language_projection", head_cfg.llm_feature_size, D)
    if "binary" in head_cfg.rel_cls_type:
        dense("binary_rel_cls_pred", 1, D)
    if "multiclass" in head_cfg.rel_cls_type:
        dense("multiclass_rel_cls_pred", head_cfg.num_relation_classes, D)
    return {prefix + k: v for k, v in s.items()}


def synthetic_mask2former_state(cfg, seed: int = 0, fan_in: bool = False,
                                enc_ffn: int = None) -> State:
    """mmdet Mask2Former checkpoint of a ``Mask2FormerConfig``'s geometry in
    the key schema ``convert_mask2former`` documents: a ResNet (``r50``,
    ``tiny_r50``) or mmdet SwinTransformer (``swin_t``, ``swin_b``,
    ``tiny``) backbone with BatchNorm running statistics, the pixel decoder's
    input convolutions coarse-first, ``enc_ffn`` (default the config's
    encoder width) the encoder FFN width, the decoder with
    ``query_feat`` / ``query_embed`` / ``level_embed``, ``cls_embed`` over
    ``num_classes + 1`` and the ``mask_embed`` MLP."""
    from openpsg_tpu_torch.models.segmenter.mask2former import BACKBONES, backbone_channels

    rng = np.random.default_rng(seed)
    dim, Q = cfg.dim, cfg.num_queries
    nH, L, K = 8, 3, 4
    enc_ffn = enc_ffn or cfg.enc_ffn_hidden or cfg.ffn_hidden
    s: State = {}
    w = lambda *shape: _normal(rng, shape, int(np.prod(shape[1:])) if fan_in else None)
    vec = lambda n, scale=0.02: _normal(rng, (n,)) * np.float32(scale)

    def bn(base, c):
        s[base + ".weight"] = (1.0 + vec(c, 0.1)).astype(np.float32)
        s[base + ".bias"] = vec(c, 0.1)
        s[base + ".running_mean"] = vec(c, 0.1)
        s[base + ".running_var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        s[base + ".num_batches_tracked"] = np.asarray(100, np.int64)

    def norm(base, c):
        s[base + ".weight"] = (1.0 + vec(c, 0.1)).astype(np.float32)
        s[base + ".bias"] = vec(c, 0.1)

    def lin(base, o, i, bias=True):
        s[base + ".weight"] = w(o, i)
        if bias:
            s[base + ".bias"] = vec(o)

    kind, kw = BACKBONES[cfg.backbone]
    if kind == "resnet":
        base = kw["base_ch"]
        s["backbone.conv1.weight"] = w(base, 3, 7, 7)
        bn("backbone.bn1", base)
        ch, inp = base, base
        for st, depth in enumerate(kw["depths"]):
            for b in range(depth):
                p = f"backbone.layer{st + 1}.{b}."
                s[p + "conv1.weight"] = w(ch, inp, 1, 1)
                bn(p + "bn1", ch)
                s[p + "conv2.weight"] = w(ch, ch, 3, 3)
                bn(p + "bn2", ch)
                s[p + "conv3.weight"] = w(4 * ch, ch, 1, 1)
                bn(p + "bn3", 4 * ch)
                if b == 0:
                    s[p + "downsample.0.weight"] = w(4 * ch, inp, 1, 1)
                    bn(p + "downsample.1", 4 * ch)
                inp = 4 * ch
            ch *= 2
    else:
        E, win = kw["embed_dim"], kw["window"]
        s["backbone.patch_embed.projection.weight"] = w(E, 3, 4, 4)
        s["backbone.patch_embed.projection.bias"] = vec(E)
        norm("backbone.patch_embed.norm", E)
        C = E
        for st, depth in enumerate(kw["depths"]):
            for b in range(depth):
                p = f"backbone.stages.{st}.blocks.{b}."
                norm(p + "norm1", C)
                norm(p + "norm2", C)
                s[p + "attn.w_msa.relative_position_bias_table"] = vec(
                    (2 * win - 1) ** 2 * kw["num_heads"][st]).reshape(
                    (2 * win - 1) ** 2, kw["num_heads"][st])
                s[p + "attn.w_msa.relative_position_index"] = np.zeros(
                    (win * win, win * win), np.int64)
                lin(p + "attn.w_msa.qkv", 3 * C, C)
                lin(p + "attn.w_msa.proj", C, C)
                lin(p + "ffn.layers.0.0", 4 * C, C)
                lin(p + "ffn.layers.1", C, 4 * C)
            norm(f"backbone.norm{st}", C)
            if st < 3:
                d = f"backbone.stages.{st}.downsample."
                norm(d + "norm", 4 * C)
                lin(d + "reduction", 2 * C, 4 * C, bias=False)
                C *= 2
    chans = backbone_channels(cfg.backbone)
    pd = "panoptic_head.pixel_decoder."
    for j, c_in in enumerate((chans[3], chans[2], chans[1])):     # strides 32, 16, 8
        s[pd + f"input_convs.{j}.conv.weight"] = w(dim, c_in, 1, 1)
        s[pd + f"input_convs.{j}.conv.bias"] = vec(dim)
        norm(pd + f"input_convs.{j}.gn", dim)
    for l in range(cfg.enc_layers):
        b = pd + f"encoder.layers.{l}."
        lin(b + "attentions.0.sampling_offsets", nH * L * K * 2, dim)
        s[b + "attentions.0.sampling_offsets.weight"] *= np.float32(0.1)
        lin(b + "attentions.0.attention_weights", nH * L * K, dim)
        lin(b + "attentions.0.value_proj", dim, dim)
        lin(b + "attentions.0.output_proj", dim, dim)
        lin(b + "ffns.0.layers.0.0", enc_ffn, dim)
        lin(b + "ffns.0.layers.1", dim, enc_ffn)
        norm(b + "norms.0", dim)
        norm(b + "norms.1", dim)
    s[pd + "level_encoding.weight"] = _normal(rng, (3, dim))
    s[pd + "lateral_convs.0.conv.weight"] = w(dim, chans[0], 1, 1)
    norm(pd + "lateral_convs.0.gn", dim)
    s[pd + "output_convs.0.conv.weight"] = w(dim, dim, 3, 3)
    norm(pd + "output_convs.0.gn", dim)
    s[pd + "mask_feature.weight"] = w(cfg.mask_dim, dim, 1, 1)
    s[pd + "mask_feature.bias"] = vec(cfg.mask_dim)
    ph = "panoptic_head."
    for l in range(cfg.dec_layers):
        b = ph + f"transformer_decoder.layers.{l}."
        for a in (0, 1):
            lin(b + f"attentions.{a}.attn.in_proj", 3 * dim, dim)
            s[b + f"attentions.{a}.attn.in_proj_weight"] = s.pop(
                b + f"attentions.{a}.attn.in_proj.weight")
            s[b + f"attentions.{a}.attn.in_proj_bias"] = s.pop(
                b + f"attentions.{a}.attn.in_proj.bias")
            lin(b + f"attentions.{a}.attn.out_proj", dim, dim)
        lin(b + "ffns.0.layers.0.0", cfg.ffn_hidden, dim)
        lin(b + "ffns.0.layers.1", dim, cfg.ffn_hidden)
        for n in (0, 1, 2):
            norm(b + f"norms.{n}", dim)
    norm(ph + "transformer_decoder.post_norm", dim)
    s[ph + "query_embed.weight"] = _normal(rng, (Q, dim))
    s[ph + "query_feat.weight"] = _normal(rng, (Q, dim))
    s[ph + "level_embed.weight"] = _normal(rng, (3, dim))
    lin(ph + "cls_embed", cfg.num_classes + 1, dim)
    for i, o in ((0, dim), (2, dim), (4, cfg.mask_dim)):
        lin(ph + f"mask_embed.{i}", o, dim)
    return s


def synthetic_relation_v1_state(head_cfg, token_dim: int, num_classes: int, vocab: int = 64,
                                seed: int = 0, fan_in: bool = False) -> State:
    """The reference v1 ``RelationTransformerHead`` (bilinear path) as
    ``PartCheckpointHook`` saves it: ``relation_head.*`` (``fc_input`` when
    the token width differs from the tower's, the BERT tower under
    ``model.model.*`` with a ``vocab``-row word table, ``fc_output``,
    ``cls_q`` / ``cls_k``) and ``object_cls_embed.weight``
    [num_classes, token width]."""
    rng = np.random.default_rng(seed)
    D, R, qk = head_cfg.output_feature_size, head_cfg.num_relation_classes, head_cfg.cls_qk_size
    s: State = {}

    def dense(base, o, i):
        s[base + ".weight"] = _normal(rng, (o, i), i if fan_in else None)
        s[base + ".bias"] = _normal(rng, (o,)) * np.float32(0.02)

    def dense_ln(base, o, i):
        dense(base + ".0", o, i)
        s[base + ".1.weight"] = 1.0 + _normal(rng, (o,)) * np.float32(0.02)
        s[base + ".1.bias"] = _normal(rng, (o,)) * np.float32(0.02)

    if token_dim != D:
        dense_ln("fc_input", D, token_dim)
    enc = dataclasses.replace(head_cfg.encoder, hidden_size=D, vocab_size=vocab)
    bert = synthetic_bert_state(enc, seed=seed + 1)
    if fan_in:
        bert = {k: (v / np.float32(np.sqrt(v.shape[1])) if v.ndim == 2 and "embeddings" not in k
                    else v) for k, v in bert.items()}
    s.update({f"model.model.{k}": v for k, v in bert.items()})
    dense_ln("fc_output", D, D)
    dense("cls_q", R * qk, D)
    dense("cls_k", R * qk, D)
    out = {f"relation_head.{k}": v for k, v in s.items()}
    out["object_cls_embed.weight"] = _normal(rng, (num_classes, token_dim)) * np.float32(0.02)
    return out


def toy_clip_merges(words: Iterable[str]) -> List[Tuple[str, str]]:
    """CLIP BPE merges that build each lower-cased word, left to right, as
    one ``word</w>`` token: for 'dog', ``d o``, ``do g</w>``."""
    from openpsg_tpu_torch.models.commons.clip_bpe import bytes_to_unicode

    enc = bytes_to_unicode()
    merges: List[Tuple[str, str]] = []
    seen = set()
    for word in words:
        for token in word.lower().split():
            chars = ["".join(enc[b] for b in ch.encode("utf-8")) for ch in token]
            if len(chars) < 2:
                continue
            chars[-1] += "</w>"
            left = chars[0]
            for ch in chars[1:]:
                if (left, ch) not in seen:
                    seen.add((left, ch))
                    merges.append((left, ch))
                left += ch
    return merges


def write_merges(path: str, merges: List[Tuple[str, str]]) -> str:
    """Write merges as CLIP's ``merges.txt`` (version header, one pair per
    line) → ``path``."""
    with open(path, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
    return path
