"""Plain float32 reference of PSG v1 (OpenPSG ``baseline_r50.py``):
ResNet-50 with frozen BatchNorm, the deformable pixel decoder (shared with
v4: :func:`psgbench.reference.openseed.pixel_decoder`), the Mask2Former
masked-attention decoder, softmax-with-void fusion with global instance
ids, and the v1 relation head (mask-pooled object tokens plus a class
embedding → a 2-layer post-LN BERT tower → per-predicate query and key
projections, scaled dot products)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from psgbench.reference import fusion
from psgbench.reference.openseed import Params, lin, ln, mlp, normalize, pixel_decoder, sine_pos
from psgbench.reference.prec import Prec


def _bn(p: Params, name: str, x_hwc):
    return x_hwc * p(name + ".weight") + p(name + ".shift")


def resnet(pr: Prec, p: Params, img, depths):
    """img [H, W, 3] normalized → maps at strides 4, 8, 16, 32."""
    x = torch.relu(_bn(p, "stem_bn", pr.conv(img, p("stem.weight"), stride=2, padding=3)))
    x = F.max_pool2d(x.permute(2, 0, 1)[None], 3, stride=2, padding=1)[0].permute(1, 2, 0)
    outs = []
    for s, depth in enumerate(depths):
        for b in range(depth):
            bp = p.sub(f"stage{s}_block{b}")
            stride = 2 if (b == 0 and s > 0) else 1
            h = torch.relu(_bn(bp, "bn1", pr.conv(x, bp("conv1.weight"))))
            h = torch.relu(_bn(bp, "bn2", pr.conv(h, bp("conv2.weight"), stride=stride, padding=1)))
            h = _bn(bp, "bn3", pr.conv(h, bp("conv3.weight")))
            if b == 0:
                x = _bn(bp, "downsample_bn", pr.conv(x, bp("downsample.weight"), stride=stride))
            x = torch.relu(h + x)
        outs.append(x)
    return outs


def backbone_pixel(pr: Prec, W, image_u8, cfg, prefix="segmenter."):
    """Image → (memory, shapes, mask_features)."""
    p = Params(W, prefix)
    feats = resnet(pr, p.sub("backbone"), normalize(image_u8), cfg["depths"])
    return pixel_decoder(pr, p.sub("pixel_decoder"), feats, cfg)


def _mha(pr, p, name, q_in, k_in, v_in, mask, heads):
    L, D = q_in.shape
    hd = D // heads
    q = lin(pr, p, f"{name}.query", q_in).reshape(L, heads, hd) / hd ** 0.5
    k = lin(pr, p, f"{name}.key", k_in).reshape(-1, heads, hd)
    v = lin(pr, p, f"{name}.value", v_in).reshape(-1, heads, hd)
    s = pr.einsum("qhd,khd->hqk", q, k)
    if mask is not None:
        s = s.masked_fill(~mask[None], torch.finfo(torch.float32).min)
    a = torch.softmax(s, -1)
    return lin(pr, p, f"{name}.out", pr.einsum("hqk,khd->qhd", a, v).reshape(L, D))


def decoder_levels(W, memory, shapes, mask_features, cfg, prefix="segmenter.decoder."):
    """Per level (fine-first): its keys, their position embedding, and the
    mask features resized to it."""
    p = Params(W, prefix)
    mem, mf = memory.float(), mask_features.float()
    levels, start = [], 0
    for lvl, (h, w) in enumerate(shapes):
        ys, xs = torch.meshgrid((torch.arange(h) + 1.0) / (h + 1e-6),
                                (torch.arange(w) + 1.0) / (w + 1e-6), indexing="ij")
        coords = torch.stack([xs, ys], -1).reshape(-1, 2).float().to(mem.device)
        pos = sine_pos(coords, cfg["dim"]) + p(f"level_embed{lvl}")[None]
        mfl = F.interpolate(mf.permute(2, 0, 1)[None], size=(h, w), mode="bilinear",
                            align_corners=False)[0].permute(1, 2, 0).reshape(h * w, -1)
        levels.append((mem[start:start + h * w], pos, mfl))
        start += h * w
    return levels


def gate_logits(pr: Prec, W, i: int, q, levels, prefix="segmenter.decoder."):
    """Layer ``i``'s mask logits [Q, P] on its level (``L - 1 - i % L``, the
    coarsest first), from its input queries; the layer attends where > 0."""
    lp = Params(W, f"{prefix}layers.{i}.")
    me = mlp(pr, lp, "mask_head", ln(lp, "gate_norm", q.float(), 1e-6), 3)
    return pr.einsum("qc,pc->qp", me, levels[len(levels) - 1 - (i % len(levels))][2])


def decoder_layer(pr: Prec, W, i: int, q, levels, gate=None, prefix="segmenter.decoder."):
    """Layer ``i``: masked cross-attention (``gate`` [Q, P] bool, True =
    attend; None: from :func:`gate_logits`), self-attention, FFN."""
    lp = Params(W, f"{prefix}layers.{i}.")
    eps, heads = 1e-6, 8
    keys, pos, mfl = levels[len(levels) - 1 - (i % len(levels))]
    q = q.float()
    if gate is None:
        gate = gate_logits(pr, W, i, q, levels, prefix) > 0
    gate = gate | ~gate.any(1, keepdim=True)
    qpos = lp("query_pos")
    q = ln(lp, "ln_cross", q + _mha(pr, lp, "cross_attn", q + qpos, keys + pos, keys, gate,
                                     heads), eps)
    sq = q + qpos
    q = ln(lp, "ln_self", q + _mha(pr, lp, "self_attn", sq, sq, q, None, heads), eps)
    return ln(lp, "ln_ffn", q + lin(pr, lp, "ffn_down", torch.relu(lin(pr, lp, "ffn_up", q))), eps)


def decoder_heads(pr: Prec, W, q, mask_features, prefix="segmenter.decoder."):
    """The last layer's queries → (cls_logits [Q, K+1], masks [Q, H4, W4])."""
    p = Params(W, prefix)
    dec = ln(p, "decoder_norm", q.float(), 1e-6)
    me = mlp(pr, p, "final_mask_head", dec, 3)
    return lin(pr, p, "cls_head", dec), pr.einsum("qc,hwc->qhw", me, mask_features.float())


def decoder(pr: Prec, W, memory, shapes, mask_features, cfg, prefix="segmenter.decoder."):
    """The masked-attention decoder → (cls_logits [Q, K+1], masks [Q, H4, W4])."""
    levels = decoder_levels(W, memory, shapes, mask_features, cfg, prefix)
    q = W[prefix + "query_embed"].float()
    for i in range(cfg["dec_layers"]):
        q = decoder_layer(pr, W, i, q, levels, prefix=prefix)
    return decoder_heads(pr, W, q, mask_features, prefix)


def fuse_select(cls_logits, masks, hw, img_hw, cfg, num_things: int):
    """Softmax-with-void fusion at the bucket's resolution and object
    selection → dict as the program's ``fuse_select`` returns."""
    H, W = hw
    up = F.interpolate(masks.float()[None], size=(H, W), mode="bilinear", align_corners=False)[0]
    dev = up.device
    region = (torch.arange(H, device=dev)[:, None] < int(img_hw[0])) & (
        torch.arange(W, device=dev)[None, :] < int(img_hw[1]))
    f = fusion.fuse(cls_logits, up, mode="softmax_void", thr=cfg["object_mask_thr"],
                    iou_thr=cfg["iou_thr"], num_things=num_things, region=region)
    M = cfg["max_objects_padded"]
    sel, oid, valid = fusion.select(f["survive"], f["ids"], M, cfg["max_objects"])
    qs = f["qscore"]
    if qs.shape[0] < M:
        qs = torch.cat([qs, qs.new_zeros(M - qs.shape[0])])
    pan4 = fusion.nearest(f["pan"], masks.shape[1:])
    obj = (pan4[None] == oid[:, None, None]) & valid[:, None, None]
    return {"object_masks": obj, "sel_oid": oid, "valid": valid,
            "labels": oid % fusion.INSTANCE_OFFSET,
            "obj_scores": torch.where(valid, qs[sel], 0.0), "pan_seg": f["pan"]}


def tokens(W, mask_features, object_masks, labels):
    """Mask-pooled object tokens plus each object's class embedding."""
    m = object_masks.float()
    num = torch.einsum("hwc,nhw->nc", mask_features.float(), m)
    pooled = num / torch.clamp(m.sum((1, 2))[:, None], min=1e-8)
    return pooled + W["object_cls_embed"].float()[labels.long()]


def head(pr: Prec, W, toks, valid, cfg, prefix="head."):
    """Object tokens [M, C] and validity → scores [R, M, M]."""
    p = Params(W, prefix)
    hc = cfg["head"]
    eps, heads = 1e-12, hc["num_heads"]
    x = toks.float()
    if prefix + "fc_input.dense.weight" in W:  # only where the token width differs
        x = ln(p, "fc_input.ln", lin(pr, p, "fc_input.dense", x), 1e-5)
    x = x[None]
    e = p.sub("encoder")
    x = ln(e, "embed_ln", x + e("pos_embed")[1][None, None], eps)
    mask = valid.bool()[None, None, :].expand(1, x.shape[1], -1)
    for i in range(hc["num_layers"]):
        lp = e.sub(f"layers.{i}")
        B, L, D = x.shape
        hd = D // heads
        q = lin(pr, lp, "self_attn.query", x).reshape(B, L, heads, hd) / hd ** 0.5
        k = lin(pr, lp, "self_attn.key", x).reshape(B, L, heads, hd)
        v = lin(pr, lp, "self_attn.value", x).reshape(B, L, heads, hd)
        s = pr.einsum("blhd,bshd->bhls", q, k).masked_fill(~mask[:, None],
                                                           torch.finfo(torch.float32).min)
        o = lin(pr, lp, "self_attn.out", pr.einsum("bhls,bshd->blhd", torch.softmax(s, -1), v)
                .reshape(B, L, D))
        x = ln(lp, "self_ln", x + o, eps)
        x = ln(lp, "ffn_ln", x + lin(pr, lp, "ffn_down", F.gelu(lin(pr, lp, "ffn_up", x))), eps)
    x = ln(p, "fc_output.ln", lin(pr, p, "fc_output.dense", x[0]), 1e-5)
    R, dq = hc["num_relation_classes"], hc["cls_qk_size"]
    M = x.shape[0]
    q = lin(pr, p, "cls_q", x).reshape(M, R, dq).permute(1, 0, 2)
    k = lin(pr, p, "cls_k", x).reshape(M, R, dq).permute(1, 0, 2)
    return pr.einsum("rnc,rmc->rnm", q, k) / dq ** 0.5


def triplet_probs(scores, valid, obj_scores):
    """Every triplet's probability (exp of the masked score times both
    objects' scores; 0 for an invalid pair) → [R, M, M]."""
    M = scores.shape[1]
    eye = torch.eye(M, dtype=torch.bool, device=scores.device)
    ok = valid[:, None] & valid[None, :] & ~eye
    probs = torch.exp(torch.where(ok[None], scores.float(), -9999.0))
    probs = probs * obj_scores[None, :, None] * obj_scores[None, None, :]
    return torch.where(ok[None], probs, 0.0)


def triplets(scores, valid, obj_scores, k: int = 100):
    """Scores → the top-k (subject, object, predicate), relation-major, ties
    to the lower index, with their probabilities."""
    R, M, _ = scores.shape
    probs = triplet_probs(scores, valid, obj_scores)
    top_scores, top = torch.sort(probs.reshape(-1), descending=True, stable=True)
    top_scores, top = top_scores[:k], top[:k]
    rel, rem = top // (M * M), top % (M * M)
    return torch.stack([rem // M, rem % M, rel], 1), top_scores
