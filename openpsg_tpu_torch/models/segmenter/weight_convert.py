"""OpenSeeD checkpoints → segmenter parameter trees (counterpart of
``openpsg_tpu/models/segmenter/weight_convert.py``, its OpenSeeD part).

The converters return the flax-layout tree of numpy arrays the JAX
package's converters return, equal to theirs; ``bridge.load_part`` loads
it into the port's modules (``PSGv4.load_segmenter_weights``,
``PSGMask2FormerRelation.load_segmenter_weights``).  Besides OpenSeeD:
mmdet Mask2Former checkpoints (``convert_mask2former``, with their
ResNet or mmdet-Swin backbone).

Covers the full OpenSeeD trunk: Swin backbone (standard microsoft/Swin
layout, used by both OpenSeeD's Swin-T and mmdet's Swin-B), the MaskDINO
deformable-encoder pixel decoder, the MaskDINO two-stage query decoder,
and the X-Decoder-style CLIP language encoder.  The published OpenSeeD
checkpoint (``model_state_dict_swint_51.2ap.pt``,
configs/psg/baseline_v4_ov.py:55) is not in the repository; the
converters are tested on synthetic state dicts with the canonical tensor
names (tests/test_torch_weights.py) so real checkpoints slot in without
layout drift.

Swin name map (torch → ours):
  patch_embed.proj.{weight,bias}        → patch_embed kernel [k,k,in,out] (OIHW→HWIO) / bias
  patch_embed.norm.*                    → patch_norm
  layers.{s}.blocks.{b}.norm1/2         → stage{s}_block{b}.norm1/2
  ...attn.qkv / attn.proj               → ...attn.qkv / attn.proj ([out,in]→[in,out])
  ...attn.relative_position_bias_table  → ...attn.rel_pos_bias
  ...mlp.fc1/fc2                        → ...mlp_fc1 / mlp_fc2
  layers.{s}.downsample.reduction/norm  → merge{s}.reduction / norm
  norm{s} (out norms)                   → out_norm{s}

OpenSeeD trunk name map — see ``convert_openseed`` for the full schema.
Two layout facts could not be re-verified offline (the OpenSeeD repo is a
placeholder submodule in the reference, SURVEY.md §2.10) and are exposed
as converter knobs with documented defaults:

  * ``ckpt_level_strides`` — which image stride each checkpoint encoder
    level index corresponds to.  Default ``(32, 16, 8, 64)``: detectron2's
    MSDeformAttnPixelDecoder iterates transformer features reversed
    (res5→res3), and MaskDINO appends the extra stride-64 level last.
  * ``ckpt_input_proj_strides`` — stride per ``input_proj`` list index.
    Default ``(32, 16, 8, 64)`` (same construction order).

If a real checkpoint loads with systematically wrong per-level behavior,
flip these tuples — no code changes needed.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A ``.pt`` file → its state dict as saved, the ``"model"`` entry
    unwrapped when the keys sit under it (OpenSeeD's layout)."""
    import pickle

    import torch

    try:
        state = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # reference checkpoints may pickle more than tensors; load them as
        # the JAX package does
        state = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(state, dict) and "model" in state and not any(
            k.startswith(("backbone.", "sem_seg_head.")) for k in state):
        state = state["model"]
    return state


def _t(a):  # torch Linear [out, in] -> flax kernel [in, out]
    return np.asarray(a).T


def _conv(a):  # torch Conv OIHW -> flax HWIO
    return np.asarray(a).transpose(2, 3, 1, 0)


def convert_swin(
    state: Mapping[str, np.ndarray],
    prefix: str = "",
    depths=(2, 2, 6, 2),
) -> Dict[str, Any]:
    """→ params dict matching ``SwinTransformer`` (module 'backbone')."""
    g = lambda k: np.asarray(state[prefix + k])
    out: Dict[str, Any] = {
        "patch_embed": {
            "kernel": _conv(g("patch_embed.proj.weight")),
            "bias": g("patch_embed.proj.bias"),
        },
        "patch_norm": {
            "scale": g("patch_embed.norm.weight"),
            "bias": g("patch_embed.norm.bias"),
        },
    }
    for s, depth in enumerate(depths):
        for b in range(depth):
            p = f"layers.{s}.blocks.{b}."
            blk = {
                "norm1": {"scale": g(p + "norm1.weight"), "bias": g(p + "norm1.bias")},
                "norm2": {"scale": g(p + "norm2.weight"), "bias": g(p + "norm2.bias")},
                "attn": {
                    "qkv": {"kernel": _t(g(p + "attn.qkv.weight")),
                            "bias": g(p + "attn.qkv.bias")},
                    "proj": {"kernel": _t(g(p + "attn.proj.weight")),
                             "bias": g(p + "attn.proj.bias")},
                    "rel_pos_bias": g(p + "attn.relative_position_bias_table"),
                },
                "mlp_fc1": {"kernel": _t(g(p + "mlp.fc1.weight")),
                            "bias": g(p + "mlp.fc1.bias")},
                "mlp_fc2": {"kernel": _t(g(p + "mlp.fc2.weight")),
                            "bias": g(p + "mlp.fc2.bias")},
            }
            out[f"stage{s}_block{b}"] = blk
        if s < len(depths) - 1 and prefix + f"layers.{s}.downsample.reduction.weight" in state:
            out[f"merge{s}"] = {
                "reduction": {"kernel": _t(g(f"layers.{s}.downsample.reduction.weight"))},
                "norm": {"scale": g(f"layers.{s}.downsample.norm.weight"),
                         "bias": g(f"layers.{s}.downsample.norm.bias")},
            }
    # out norms: checkpoints name them norm0..norm3 or norm
    for s in range(len(depths)):
        for cand in (f"norm{s}.weight", "norm.weight" if s == len(depths) - 1 else None):
            if cand and prefix + cand in state:
                base = cand[: -len(".weight")]
                out[f"out_norm{s}"] = {
                    "scale": g(base + ".weight"), "bias": g(base + ".bias"),
                }
                break
    return out


def hf_swin_state_to_ms(state: Mapping[str, np.ndarray], prefix: str = "") -> Dict[str, np.ndarray]:
    """transformers ``SwinModel`` state dict → the microsoft/OpenSeeD
    layout ``convert_swin`` consumes (separate q/k/v fused to qkv,
    layernorm_before/after → norm1/2, embeddings/downsample renames).
    The final ``layernorm`` maps onto the last stage's out norm."""
    out: Dict[str, np.ndarray] = {}
    g = lambda k: np.asarray(state[prefix + k])
    out["patch_embed.proj.weight"] = g("embeddings.patch_embeddings.projection.weight")
    out["patch_embed.proj.bias"] = g("embeddings.patch_embeddings.projection.bias")
    out["patch_embed.norm.weight"] = g("embeddings.norm.weight")
    out["patch_embed.norm.bias"] = g("embeddings.norm.bias")
    last_stage = -1
    for k in state:
        m = re.match(re.escape(prefix) + r"encoder\.layers\.(\d+)\.blocks\.(\d+)\.", k)
        if m:
            last_stage = max(last_stage, int(m.group(1)))
    for k in list(state):
        if not k.startswith(prefix + "encoder.layers."):
            continue
        rest = k[len(prefix + "encoder.layers."):]
        m = re.match(r"(\d+)\.blocks\.(\d+)\.(.*)", rest)
        if m:
            s, b, tail = m.group(1), m.group(2), m.group(3)
            base = f"layers.{s}.blocks.{b}."
            ren = {
                "layernorm_before.weight": "norm1.weight",
                "layernorm_before.bias": "norm1.bias",
                "layernorm_after.weight": "norm2.weight",
                "layernorm_after.bias": "norm2.bias",
                "attention.self.relative_position_bias_table":
                    "attn.relative_position_bias_table",
                "attention.output.dense.weight": "attn.proj.weight",
                "attention.output.dense.bias": "attn.proj.bias",
                "intermediate.dense.weight": "mlp.fc1.weight",
                "intermediate.dense.bias": "mlp.fc1.bias",
                "output.dense.weight": "mlp.fc2.weight",
                "output.dense.bias": "mlp.fc2.bias",
            }
            if tail in ren:
                out[base + ren[tail]] = np.asarray(state[k])
            continue
        m = re.match(r"(\d+)\.downsample\.(reduction\.weight|norm\.weight|norm\.bias)", rest)
        if m:
            out[f"layers.{m.group(1)}.downsample.{m.group(2)}"] = np.asarray(state[k])
    # fuse separate q/k/v into the microsoft qkv tensors
    s = 0
    while prefix + f"encoder.layers.{s}.blocks.0.attention.self.query.weight" in state:
        b = 0
        while prefix + f"encoder.layers.{s}.blocks.{b}.attention.self.query.weight" in state:
            p = prefix + f"encoder.layers.{s}.blocks.{b}.attention.self."
            out[f"layers.{s}.blocks.{b}.attn.qkv.weight"] = np.concatenate(
                [g(f"encoder.layers.{s}.blocks.{b}.attention.self.{n}.weight")
                 for n in ("query", "key", "value")], axis=0
            )
            out[f"layers.{s}.blocks.{b}.attn.qkv.bias"] = np.concatenate(
                [g(f"encoder.layers.{s}.blocks.{b}.attention.self.{n}.bias")
                 for n in ("query", "key", "value")], axis=0
            )
            b += 1
        s += 1
    if prefix + "layernorm.weight" in state:
        out[f"norm{last_stage}.weight"] = g("layernorm.weight")
        out[f"norm{last_stage}.bias"] = g("layernorm.bias")
    return out


def detect_swin_prefix(state: Mapping[str, np.ndarray]) -> str:
    """Find the backbone prefix in a composite checkpoint."""
    for k in state:
        m = re.match(r"^(.*?)patch_embed\.proj\.weight$", k)
        if m:
            return m.group(1)
    raise KeyError("no swin patch_embed found in state dict")


# --------------------------------------------------------------------------
# Full OpenSeeD trunk (MaskDINO pixel decoder + query decoder + language
# encoder).  Checkpoint key schema (sem_seg_head.* as saved by the
# published model_state_dict_swint_51.2ap.pt; reconstructed from the
# MaskDINO / X-Decoder lineage — see module docstring for the two
# order knobs):
#
#   pixel_decoder.input_proj.{i}.0.{weight,bias}     conv (1x1 backbone /
#                                                    3x3-s2 extra levels)
#   pixel_decoder.input_proj.{i}.1.{weight,bias}     GroupNorm(32)
#   pixel_decoder.transformer.level_embed            [L, C]
#   pixel_decoder.transformer.encoder.layers.{l}.self_attn.
#       {sampling_offsets,attention_weights,value_proj,output_proj}.{weight,bias}
#   pixel_decoder.transformer.encoder.layers.{l}.{norm1,linear1,linear2,norm2}.*
#   pixel_decoder.adapter_1.{weight,norm.weight,norm.bias}   res2 lateral 1x1
#   pixel_decoder.layer_1.{weight,norm.weight,norm.bias}     stride-4 3x3 output
#   pixel_decoder.mask_features.{weight,bias}                1x1 → mask_dim
#
#   predictor.class_embed                            [C, proj_dim]
#   predictor.enc_output.{weight,bias} + enc_output_norm.*
#   predictor.mask_embed.layers.{0,1,2}.*            shared mask MLP
#   predictor.decoder_norm.*
#   predictor.label_enc.weight                       (denoise-train only → dropped)
#   predictor.decoder.layers.{l}.cross_attn.*        (deformable, as encoder)
#   predictor.decoder.layers.{l}.norm1.*             post-cross LN
#   predictor.decoder.layers.{l}.self_attn.{in_proj_weight,in_proj_bias,
#       out_proj.weight,out_proj.bias} + norm2.*
#   predictor.decoder.layers.{l}.{linear1,linear2,norm3}.*
#   predictor.decoder.ref_point_head.layers.{0,1}.*  (single module; tiled
#                                                    across our scan axis)
#   predictor.decoder.bbox_embed.{l}.layers.{0,1,2}.* per-layer box MLP;
#       entry [dec_layers] (when present) is the two-stage proposal head;
#       top-level predictor.bbox_embed.{l}.* aliases are consumed too
#   predictor.lang_encoder.logit_scale, .lang_proj   language head
#   predictor.lang_encoder.lang_encoder.*            CLIP text transformer
# --------------------------------------------------------------------------


class _Consumed:
    """Strict key accounting: every checkpoint tensor must be mapped or on
    the documented drop list; leftovers raise so layout drift is loud."""

    def __init__(self, state: Mapping[str, np.ndarray]):
        self.state = state
        self.used = set()

    def __call__(self, key: str) -> np.ndarray:
        self.used.add(key)
        return np.asarray(self.state[key])

    def opt(self, key: str) -> Optional[np.ndarray]:
        if key in self.state:
            return self(key)
        return None

    def has(self, key: str) -> bool:
        return key in self.state

    def leftovers(self, drop_patterns: Sequence[str]) -> list:
        out = []
        for k in self.state:
            if k in self.used:
                continue
            if any(re.search(p, k) for p in drop_patterns):
                continue
            out.append(k)
        return sorted(out)


def _gn(g, base: str) -> Dict[str, np.ndarray]:
    return {"scale": g(base + ".weight"), "bias": g(base + ".bias")}


def _dense(g, base: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _t(g(base + ".weight"))}
    if g.has(base + ".bias"):
        out["bias"] = g(base + ".bias")
    return out


def _mlp(g, base: str, n: int, fmt: str = "{}.layers.{}") -> Dict[str, Any]:
    return {
        f"fc{j}": _dense(g, fmt.format(base, j)) for j in range(n)
    }


def _perm_levels(kernel_or_bias: np.ndarray, nH: int, L: int, K: int,
                 tail: int, perm: Sequence[int]) -> np.ndarray:
    """Permute the level axis of a sampling_offsets / attention_weights
    projection.  Output axis layout is [nH, L, K, tail] flattened."""
    a = kernel_or_bias
    lead = a.shape[:-1]
    a = a.reshape(*lead, nH, L, K, tail)
    a = np.take(a, np.asarray(perm), axis=len(lead) + 1)
    return a.reshape(*lead, nH * L * K * tail)


def _msda(g, base: str, nH: int, L: int, K: int, perm: Sequence[int]) -> Dict[str, Any]:
    """torch MSDeformAttn → our MSDeformAttnLayer params (level-permuted)."""
    off = _dense(g, base + ".sampling_offsets")
    att = _dense(g, base + ".attention_weights")
    return {
        "sampling_offsets": {
            "kernel": _perm_levels(off["kernel"], nH, L, K, 2, perm),
            "bias": _perm_levels(off["bias"], nH, L, K, 2, perm),
        },
        "attention_weights": {
            "kernel": _perm_levels(att["kernel"], nH, L, K, 1, perm),
            "bias": _perm_levels(att["bias"], nH, L, K, 1, perm),
        },
        "value_proj": _dense(g, base + ".value_proj"),
        "output_proj": _dense(g, base + ".output_proj"),
    }


def _mha_from_inproj(w: np.ndarray, b: np.ndarray, ow: np.ndarray,
                     ob: np.ndarray, num_heads: int) -> Dict[str, Any]:
    """torch nn.MultiheadAttention in_proj/out_proj → flax MHA params."""
    D = w.shape[1]
    hd = D // num_heads
    qw, kw, vw = w[:D], w[D : 2 * D], w[2 * D :]
    qb, kb, vb = b[:D], b[D : 2 * D], b[2 * D :]
    mk = lambda wi, bi: {
        "kernel": _t(wi).reshape(D, num_heads, hd),
        "bias": bi.reshape(num_heads, hd),
    }
    return {
        "query": mk(qw, qb),
        "key": mk(kw, kb),
        "value": mk(vw, vb),
        "out": {"kernel": _t(ow).reshape(num_heads, hd, D), "bias": ob},
    }


def _stack_tree(trees: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """[per-layer param dicts] → one dict with a stacked leading axis
    (nn.scan layout)."""
    out: Dict[str, Any] = {}
    for k in trees[0]:
        if isinstance(trees[0][k], dict):
            out[k] = _stack_tree([t[k] for t in trees])
        else:
            out[k] = np.stack([t[k] for t in trees], 0)
    return out


# training-only tensors that have no inference equivalent in our model
OPENSEED_DROP_PATTERNS = (
    r"\.label_enc\.",          # denoising-training label embedding
    r"criterion\.",            # loss buffers (empty_weight etc.)
    r"pixel_mean$", r"pixel_std$",
)


def convert_openseed(
    state: Mapping[str, np.ndarray],
    cfg=None,
    prefix: str = "",
    ckpt_level_strides: Optional[Tuple[int, ...]] = None,
    ckpt_input_proj_strides: Tuple[int, ...] = (32, 16, 8, 64),
    strict: bool = True,
):
    """Full OpenSeeD checkpoint → ``OpenSeedSegmenter`` params (+ language
    encoder params via :func:`convert_openseed_lang`).

    Returns ``(params, lang)`` where params has {backbone, pixel_decoder,
    decoder} matching the flax module tree and lang is the converted
    language-encoder bundle (tower/lang_proj/logit_scale).  With
    ``strict=True`` raises if any checkpoint key is neither mapped nor on
    ``OPENSEED_DROP_PATTERNS``.
    """
    from openpsg_tpu_torch.models.segmenter.openseed import SegmenterConfig

    cfg = cfg or SegmenterConfig()
    if ckpt_level_strides is None:
        # default from the config so the weight permutation and the
        # model-side proposal anchors (decoder level_wh_exp) can't drift
        ckpt_level_strides = tuple(
            getattr(cfg, "ckpt_level_strides", (32, 16, 8, 64))
        )
    g = _Consumed({k[len(prefix):]: v for k, v in state.items()
                   if k.startswith(prefix)})
    nH, K = 8, cfg.num_points
    L = cfg.total_levels

    # internal level order is high-res→low-res: strides 8, 16, 32, 64, ...
    internal_strides = [8, 16, 32] + [64 * (2 ** i) for i in range(L - 3)]
    internal_strides = internal_strides[:L]
    perm = [ckpt_level_strides.index(s) for s in internal_strides]

    # ---- backbone ----
    swin_prefix = detect_swin_prefix(g.state)
    backbone = convert_swin(g.state, prefix=swin_prefix, depths=cfg.depths)
    for k in list(g.state):
        if k.startswith(swin_prefix):
            g.used.add(k)

    pd = "sem_seg_head.pixel_decoder."
    # ---- input projections (per internal level, via the stride map) ----
    pixel_decoder: Dict[str, Any] = {}
    for i, s in enumerate(internal_strides):
        j = ckpt_input_proj_strides.index(s)
        pixel_decoder[f"input_proj{i}"] = {
            "kernel": _conv(g(pd + f"input_proj.{j}.0.weight")),
            "bias": g(pd + f"input_proj.{j}.0.bias"),
        }
        pixel_decoder[f"input_norm{i}"] = _gn(g, pd + f"input_proj.{j}.1")
    le = g(pd + "transformer.level_embed")
    pixel_decoder["level_embed"] = le[np.asarray(perm)]

    enc_layers = []
    li = 0
    while g.has(pd + f"transformer.encoder.layers.{li}.norm1.weight"):
        base = pd + f"transformer.encoder.layers.{li}."
        enc_layers.append({
            "self_attn": _msda(g, base + "self_attn", nH, L, K, perm),
            "norm1": _gn(g, base + "norm1"),
            "ffn": {
                "fc1": _dense(g, base + "linear1"),
                "fc2": _dense(g, base + "linear2"),
                "norm": _gn(g, base + "norm2"),
            },
        })
        li += 1
    pixel_decoder["layers"] = {"layer": _stack_tree(enc_layers)}

    pixel_decoder["lateral4"] = {"kernel": _conv(g(pd + "adapter_1.weight"))}
    pixel_decoder["lateral4_norm"] = _gn(g, pd + "adapter_1.norm")
    pixel_decoder["output4"] = {"kernel": _conv(g(pd + "layer_1.weight"))}
    pixel_decoder["output4_norm"] = _gn(g, pd + "layer_1.norm")
    pixel_decoder["mask_feature_proj"] = {
        "kernel": _conv(g(pd + "mask_features.weight")),
        "bias": g(pd + "mask_features.bias"),
    }

    # ---- query decoder ----
    pr = "sem_seg_head.predictor."
    decoder: Dict[str, Any] = {
        "class_embed": g(pr + "class_embed"),
        "logit_scale": g(pr + "lang_encoder.logit_scale").reshape(()),
        "enc_proj": _dense(g, pr + "enc_output"),
        "enc_norm": _gn(g, pr + "enc_output_norm"),
        "mask_head": _mlp(g, pr + "mask_embed", 3),
        "decoder_norm": _gn(g, pr + "decoder_norm"),
    }

    dec_layers = []
    li = 0
    while g.has(pr + f"decoder.layers.{li}.norm1.weight"):
        base = pr + f"decoder.layers.{li}."
        dec_layers.append({
            "cross_attn": _msda(g, base + "cross_attn", nH, L, K, perm),
            "norm_cross": _gn(g, base + "norm1"),
            "self_attn": {
                "mha": _mha_from_inproj(
                    g(base + "self_attn.in_proj_weight"),
                    g(base + "self_attn.in_proj_bias"),
                    g(base + "self_attn.out_proj.weight"),
                    g(base + "self_attn.out_proj.bias"),
                    nH,
                ),
                "norm": _gn(g, base + "norm2"),
            },
            "ffn": {
                "fc1": _dense(g, base + "linear1"),
                "fc2": _dense(g, base + "linear2"),
                "norm": _gn(g, base + "norm3"),
            },
        })
        li += 1
    n_dec = li

    # per-layer box MLPs (prefer the top-level alias; consume both spellings)
    def box_mlp(idx: int) -> Optional[Dict[str, Any]]:
        for cand in (pr + f"bbox_embed.{idx}", pr + f"decoder.bbox_embed.{idx}"):
            if g.has(cand + ".layers.0.weight"):
                got = _mlp(g, cand, 3)
                other = (pr + f"decoder.bbox_embed.{idx}"
                         if cand.endswith(f"bbox_embed.{idx}") and "decoder" not in cand
                         else pr + f"bbox_embed.{idx}")
                for j in range(3):
                    g.opt(f"{other}.layers.{j}.weight")
                    g.opt(f"{other}.layers.{j}.bias")
                return got
        return None

    per_layer_boxes = [box_mlp(i) for i in range(n_dec)]
    if any(b is None for b in per_layer_boxes):
        raise KeyError("missing bbox_embed")
    enc_box = box_mlp(n_dec)  # two-stage proposal head (when saved)
    decoder["enc_box_head"] = enc_box if enc_box is not None else per_layer_boxes[-1]

    # ref_point_head: one torch module → tiled across the scan axis
    rph = _mlp(g, pr + "decoder.ref_point_head", 2)
    for i, lyr in enumerate(dec_layers):
        lyr["ref_point_head"] = rph
        lyr["box_head"] = per_layer_boxes[i]
    decoder["layers"] = _stack_tree(dec_layers)

    lang = convert_openseed_lang(g, prefix=pr + "lang_encoder.")

    if strict:
        left = g.leftovers(OPENSEED_DROP_PATTERNS)
        if left:
            raise ValueError(
                f"unmapped checkpoint keys ({len(left)}): {left[:20]} ..."
            )

    params = {
        "backbone": backbone,
        "pixel_decoder": pixel_decoder,
        "decoder": decoder,
    }
    return params, lang


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    else:
        yield tree


def conversion_report(
    params: Dict[str, Any], cfg, state: Optional[Mapping[str, np.ndarray]] = None
) -> str:
    """Human-readable load-time sanity report.

    Prints per-level statistics that make a WRONG level-order assumption
    visible at load time: level_embed row norms, input_proj kernel
    shapes/scales (each level has a distinct in_channels — a permuted
    assignment shows up as implausible shapes or scales), and the first
    encoder layer's per-level mean |sampling_offsets| bias.  Plus key
    coverage by checkpoint prefix when ``state`` is given."""
    L = cfg.total_levels
    strides = ([8, 16, 32] + [64 * (2 ** i) for i in range(max(L - 3, 0))])[:L]
    lines = ["OpenSeeD conversion report:"]

    if state is not None:
        by_prefix: Dict[str, int] = {}
        for k in state:
            top = k.split(".")[0] if not k.startswith("sem_seg_head") else (
                "sem_seg_head." + k.split(".")[1]
            )
            by_prefix[top] = by_prefix.get(top, 0) + 1
        lines.append(
            "  checkpoint keys: "
            + ", ".join(f"{k}={v}" for k, v in sorted(by_prefix.items()))
        )

    def _n(a):
        return float(np.linalg.norm(np.asarray(a, np.float32)))

    pdp = params["pixel_decoder"]
    le = np.asarray(pdp["level_embed"])
    off_bias = np.asarray(
        pdp["layers"]["layer"]["self_attn"]["sampling_offsets"]["bias"]
    )  # [enc_layers, nH*L*K*2]
    # derive the MSDA head count from the bias length and the config's
    # points-per-level (hardcoding nH=8 would mis-group the per-level
    # stats for any non-default geometry — the exact numbers this report
    # exists to make a wrong level-order assumption visible)
    K = cfg.num_points
    nH = off_bias.shape[-1] // (K * L * 2)
    off0 = np.abs(off_bias[0].reshape(nH, L, K, 2)).mean(axis=(0, 2, 3))
    for i, s in enumerate(strides):
        k = np.asarray(pdp[f"input_proj{i}"]["kernel"])
        lines.append(
            f"  level {i} (stride {s:>3}): level_embed |row|={_n(le[i]):8.3f}"
            f"  input_proj {tuple(k.shape)} std={float(k.std()):.4f}"
            f"  |offset_bias|={float(off0[i]):.4f}"
        )
    counts = {g: sum(int(np.prod(np.shape(x))) for x in _tree_leaves(params[g]))
              for g in params}
    lines.append(
        "  param counts: "
        + ", ".join(f"{k}={v:,}" for k, v in sorted(counts.items()))
    )
    lines.append(
        "  if per-level stats look permuted (e.g. the stride-64 level has "
        "the stride-8 input_proj shape), flip ckpt_level_strides / "
        "ckpt_input_proj_strides — see VALIDATION.md"
    )
    return "\n".join(lines)


def detect_clip_resblock_prefix(state: Mapping[str, np.ndarray], prefix: str) -> str:
    """The X-Decoder lang tower nests resblocks either directly
    (``lang_encoder.resblocks.0...``) or under ``transformer.`` — detect."""
    for k in state:
        m = re.match(
            re.escape(prefix) + r"lang_encoder\.(.*?)resblocks\.0\.attn\.in_proj_weight$", k
        )
        if m:
            return prefix + "lang_encoder." + m.group(1) + "resblocks."
    raise KeyError("no CLIP resblocks found under " + prefix)


def convert_openseed_lang(
    state_or_g,
    prefix: str = "sem_seg_head.predictor.lang_encoder.",
    num_heads: int = 8,
    max_len: int = 77,
):
    """OpenSeeD/X-Decoder language encoder → our pre-LN CLIP text tower
    (BertStyleEncoder(pre_ln=True, quick_gelu=True)) + lang_proj +
    logit_scale.  Returns {"tower": params, "lang_proj": [D, proj],
    "logit_scale": scalar}."""
    g = state_or_g if isinstance(state_or_g, _Consumed) else _Consumed(state_or_g)
    rb = detect_clip_resblock_prefix(g.state, prefix)
    te = g(prefix + "lang_encoder.token_embedding.weight")
    pe = g(prefix + "lang_encoder.positional_embedding")
    D = te.shape[1]
    hd = D // num_heads

    layers = []
    i = 0
    while g.has(rb + f"{i}.attn.in_proj_weight"):
        base = rb + str(i)
        mha = _mha_from_inproj(
            g(base + ".attn.in_proj_weight"),
            g(base + ".attn.in_proj_bias"),
            g(base + ".attn.out_proj.weight"),
            g(base + ".attn.out_proj.bias"),
            num_heads,
        )
        layers.append({
            "attn_pre_ln": _gn(g, base + ".ln_1"),
            "self_attn": mha,
            "ffn_pre_ln": _gn(g, base + ".ln_2"),
            "ffn_up": _dense(g, base + ".mlp.c_fc"),
            "ffn_down": _dense(g, base + ".mlp.c_proj"),
        })
        i += 1

    tower = {
        "word_embed": {"embedding": te},
        "pos_embed": pe[:max_len],
        "layers": _stack_tree(layers),
        "final_ln": _gn(g, prefix + "lang_encoder.ln_final"),
    }
    return {
        "tower": tower,
        "lang_proj": np.asarray(g(prefix + "lang_proj")),
        "logit_scale": np.asarray(g(prefix + "logit_scale")).reshape(()),
    }


# ---------------------------------------------------------------------------
# mmdet Mask2Former checkpoints (the v1/v2/v3 model generations)
#
# The reference's earlier generations start from mmdet's published COCO-
# panoptic Mask2Former checkpoints (configs/psg/baseline_r50.py:3 load_from
# mask2former_r50_lsj_8x2_50e_coco-panoptic_*.pth; baseline_swin_b.py Swin-B
# variant).  Layout facts the mapping encodes (mmdet 2.x
# mmdet/models/plugins/msdeformattn_pixel_decoder.py,
# mmdet/models/dense_heads/mask2former_head.py):
#   * encoder levels AND decoder level-embeds are ordered COARSE-first
#     (input_convs[0] takes the stride-32 map); ours are fine-first →
#     ckpt_level_strides=(32, 16, 8) permutation.
#   * the query decoder layer is ('cross_attn','norm','self_attn','norm',
#     'ffn','norm') post-norm; attentions.0 = cross, attentions.1 = self,
#     both mmcv MultiheadAttention wrapping torch (".attn." infix,
#     in_proj/out_proj → _mha_from_inproj).
#   * query_embed.weight is the (layer-shared) query POSITION embedding,
#     query_feat.weight the content init; the shared transformer_decoder.
#     post_norm + mask_embed pair computing each layer's attention gate is
#     broadcast into every scanned layer's gate_norm/mask_head.
#   * BatchNorms (backbone) fold into FrozenBN scale/shift (norm_eval /
#     frozen backbone semantics; eps 1e-5).
# ---------------------------------------------------------------------------

MASK2FORMER_DROP_PATTERNS = (
    r"num_batches_tracked$",
    r"panoptic_fusion_head",      # parameterless; guard against meta tensors
)


def _frozen_bn(g, base: str, eps: float = 1e-5) -> Dict[str, np.ndarray]:
    """Inference-mode BatchNorm → per-channel (scale, shift)."""
    w, b = g(base + ".weight"), g(base + ".bias")
    mean, var = g(base + ".running_mean"), g(base + ".running_var")
    scale = w / np.sqrt(var + eps)
    return {"scale": scale, "shift": b - mean * scale}


def convert_resnet(
    g, prefix: str = "backbone.", depths: Sequence[int] = (3, 4, 6, 3)
) -> Dict[str, Any]:
    """mmdet/torchvision ResNet state dict → our ``ResNet`` params."""
    out: Dict[str, Any] = {
        "stem": {"kernel": _conv(g(prefix + "conv1.weight"))},
        "stem_bn": _frozen_bn(g, prefix + "bn1"),
    }
    for s, depth in enumerate(depths):
        for b in range(depth):
            p = f"{prefix}layer{s + 1}.{b}."
            blk: Dict[str, Any] = {}
            for j in (1, 2, 3):
                blk[f"conv{j}"] = {"kernel": _conv(g(p + f"conv{j}.weight"))}
                blk[f"bn{j}"] = _frozen_bn(g, p + f"bn{j}")
            if g.has(p + "downsample.0.weight"):
                blk["downsample"] = {
                    "kernel": _conv(g(p + "downsample.0.weight"))
                }
                blk["downsample_bn"] = _frozen_bn(g, p + "downsample.1")
            out[f"stage{s}_block{b}"] = blk
    return out


def mmdet_swin_state_to_ms(
    state: Mapping[str, np.ndarray], prefix: str = "backbone."
) -> Dict[str, np.ndarray]:
    """mmdet SwinTransformer keys → the MS layout ``convert_swin`` consumes.

    Beyond renames, mmdet's PatchMerging gathers the 2×2 patch with
    nn.Unfold — channel-major, positions row-major (00, 01, 10, 11) — while
    MS Swin concatenates position-major in (00, 10, 01, 11) order; the
    downsample reduction/norm input columns are permuted accordingly."""
    out: Dict[str, np.ndarray] = {}
    ren = [
        ("patch_embed.projection.", "patch_embed.proj."),
        ("patch_embed.norm.", "patch_embed.norm."),
    ]
    for k, v in state.items():
        if not k.startswith(prefix):
            continue
        k = k[len(prefix):]
        v = np.asarray(v)
        if k.endswith("attn.w_msa.relative_position_index"):
            continue  # recomputed from geometry
        for a, b in ren:
            if k.startswith(a):
                k = b + k[len(a):]
                break
        k = k.replace("stages.", "layers.")
        k = k.replace(".attn.w_msa.", ".attn.")
        k = k.replace(".ffn.layers.0.0.", ".mlp.fc1.")
        k = k.replace(".ffn.layers.1.", ".mlp.fc2.")
        if ".downsample." in k:
            # permute the 4C concat axis: ms_col[pos_ms*C + c] =
            # mmdet_col[c*4 + pos_rowmajor(pos_ms)], pos_ms order (00,10,01,11)
            C = v.shape[-1] // 4
            rowmajor_of_ms = (0, 2, 1, 3)
            idx = np.concatenate(
                [np.arange(C) * 4 + rowmajor_of_ms[p] for p in range(4)]
            )
            if k.endswith("downsample.reduction.weight"):
                v = v[:, idx]
            elif k.endswith((".norm.weight", ".norm.bias")):
                v = v[idx]
        out[k] = v
    return out


def _seq_mlp(g, base: str, ids: Sequence[int] = (0, 2, 4)) -> Dict[str, Any]:
    """torch nn.Sequential(Linear, ReLU, ...) MLP → our MLP fc{j} params."""
    return {f"fc{j}": _dense(g, f"{base}.{i}") for j, i in enumerate(ids)}


def convert_mask2former(
    state: Mapping[str, np.ndarray],
    cfg=None,
    prefix: str = "",
    ckpt_level_strides: Tuple[int, ...] = (32, 16, 8),
    strict: bool = True,
) -> Dict[str, Any]:
    """mmdet Mask2Former checkpoint → ``Mask2FormerSegmenter`` params."""
    from openpsg_tpu_torch.models.segmenter.mask2former import Mask2FormerConfig

    cfg = cfg or Mask2FormerConfig()
    g = _Consumed({k[len(prefix):]: v for k, v in state.items()
                   if k.startswith(prefix)})
    nH, K = 8, 4
    internal_strides = (8, 16, 32)
    L = len(internal_strides)
    perm = [ckpt_level_strides.index(s) for s in internal_strides]

    # ---- backbone ----
    if g.has("backbone.conv1.weight"):
        depths = {"r50": (3, 4, 6, 3), "tiny_r50": (1, 1, 1, 1)}.get(
            cfg.backbone, (3, 4, 6, 3)
        )
        backbone = convert_resnet(g, "backbone.", depths)
    else:
        ms = mmdet_swin_state_to_ms(g.state, "backbone.")
        depths = {"swin_t": (2, 2, 6, 2), "swin_b": (2, 2, 18, 2),
                  "tiny": (1, 1, 1, 1)}.get(cfg.backbone, (2, 2, 18, 2))
        backbone = convert_swin(ms, depths=depths)
        for k in list(g.state):
            if k.startswith("backbone."):
                g.used.add(k)

    # ---- pixel decoder ----
    pd = "panoptic_head.pixel_decoder."
    pixel_decoder: Dict[str, Any] = {}
    for i, s in enumerate(internal_strides):
        j = ckpt_level_strides.index(s)
        kern = _conv(g(pd + f"input_convs.{j}.conv.weight"))
        # mmdet's input ConvModules set bias=True explicitly despite the
        # following GN, but guard against norm-implies-no-bias variants
        b = g.opt(pd + f"input_convs.{j}.conv.bias")
        pixel_decoder[f"input_proj{i}"] = {
            "kernel": kern,
            "bias": b if b is not None else np.zeros(kern.shape[-1], np.float32),
        }
        pixel_decoder[f"input_norm{i}"] = _gn(g, pd + f"input_convs.{j}.gn")
    pixel_decoder["level_embed"] = g(pd + "level_encoding.weight")[
        np.asarray(perm)
    ]

    enc_layers = []
    li = 0
    while g.has(pd + f"encoder.layers.{li}.norms.0.weight"):
        base = pd + f"encoder.layers.{li}."
        enc_layers.append({
            "self_attn": _msda(g, base + "attentions.0", nH, L, K, perm),
            "norm1": _gn(g, base + "norms.0"),
            "ffn": {
                "fc1": _dense(g, base + "ffns.0.layers.0.0"),
                "fc2": _dense(g, base + "ffns.0.layers.1"),
                "norm": _gn(g, base + "norms.1"),
            },
        })
        li += 1
    pixel_decoder["layers"] = {"layer": _stack_tree(enc_layers)}

    pixel_decoder["lateral4"] = {
        "kernel": _conv(g(pd + "lateral_convs.0.conv.weight"))
    }
    pixel_decoder["lateral4_norm"] = _gn(g, pd + "lateral_convs.0.gn")
    pixel_decoder["output4"] = {
        "kernel": _conv(g(pd + "output_convs.0.conv.weight"))
    }
    pixel_decoder["output4_norm"] = _gn(g, pd + "output_convs.0.gn")
    pixel_decoder["mask_feature_proj"] = {
        "kernel": _conv(g(pd + "mask_feature.weight")),
        "bias": g(pd + "mask_feature.bias"),
    }

    # ---- masked-attention query decoder ----
    ph = "panoptic_head."
    post_norm = _gn(g, ph + "transformer_decoder.post_norm")
    mask_embed = _seq_mlp(g, ph + "mask_embed")
    query_pos = g(ph + "query_embed.weight")

    decoder: Dict[str, Any] = {
        "query_embed": g(ph + "query_feat.weight"),
        "decoder_norm": dict(post_norm),
        "cls_head": _dense(g, ph + "cls_embed"),
        "final_mask_head": mask_embed,
    }
    dle = g(ph + "level_embed.weight")
    for lvl, s in enumerate(internal_strides):
        decoder[f"level_embed{lvl}"] = dle[ckpt_level_strides.index(s)]

    dec_layers = []
    li = 0
    while g.has(ph + f"transformer_decoder.layers.{li}.norms.0.weight"):
        base = ph + f"transformer_decoder.layers.{li}."

        def mha(idx):
            return _mha_from_inproj(
                g(base + f"attentions.{idx}.attn.in_proj_weight"),
                g(base + f"attentions.{idx}.attn.in_proj_bias"),
                g(base + f"attentions.{idx}.attn.out_proj.weight"),
                g(base + f"attentions.{idx}.attn.out_proj.bias"),
                nH,
            )

        dec_layers.append({
            "gate_norm": dict(post_norm),
            "mask_head": mask_embed,
            "query_pos": query_pos,
            "cross_attn": mha(0),
            "ln_cross": _gn(g, base + "norms.0"),
            "self_attn": mha(1),
            "ln_self": _gn(g, base + "norms.1"),
            "ffn_up": _dense(g, base + "ffns.0.layers.0.0"),
            "ffn_down": _dense(g, base + "ffns.0.layers.1"),
            "ln_ffn": _gn(g, base + "norms.2"),
        })
        li += 1
    decoder["layers"] = _stack_tree(dec_layers)

    if strict:
        left = g.leftovers(MASK2FORMER_DROP_PATTERNS)
        if left:
            raise ValueError(
                f"unmapped checkpoint keys ({len(left)}): {left[:20]} ..."
            )

    return {
        "backbone": backbone,
        "pixel_decoder": pixel_decoder,
        "decoder": decoder,
    }
