"""Plain float32 reference of the PSG v4 stages after the segmenter: fusion
and object selection at the image's resolution, and the relation head (the
InstructBLIP-style Q-Former over every ordered object pair, its existence
logits and the LLM visual tokens)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from psgbench.reference import fusion
from psgbench.reference.openseed import Params, lin, ln
from psgbench.reference.prec import Prec


def fuse_select(cls_logits, masks, img_hw, psg, num_things: int):
    """The segmenter's outputs → (object_masks [M, H4, W4], valid, labels,
    oid, obj_scores, pan [H, W], pass_count), OpenSeeD's sigmoid fusion over
    the ``fusion_candidates`` best queries."""
    M, C = psg["max_objects_padded"], psg["fusion_candidates"]
    H4, W4 = masks.shape[1:]
    H, W = 4 * H4, 4 * W4
    score = torch.sigmoid(cls_logits.float()).max(-1).values
    pass_count = int((score > psg["object_mask_thr"]).sum())
    if C and C < cls_logits.shape[0]:
        cand = torch.sort(torch.sort(score, descending=True, stable=True).indices[:C]).values
        cls_logits, masks = cls_logits[cand], masks[cand]
    up = F.interpolate(masks.float()[None], size=(H, W), mode="bilinear", align_corners=False)[0]
    dev = up.device
    region = (torch.arange(H, device=dev)[:, None] < int(img_hw[0])) & (
        torch.arange(W, device=dev)[None, :] < int(img_hw[1]))
    f = fusion.fuse(cls_logits, up, mode="sigmoid", thr=psg["object_mask_thr"],
                    iou_thr=psg["iou_thr"], num_things=num_things, region=region)
    sel, oid, valid = fusion.select(f["survive"], f["ids"], M, psg["max_object_num"])
    qs = f["qscore"]
    if qs.shape[0] < M:
        qs = torch.cat([qs, qs.new_zeros(M - qs.shape[0])])
    pan4 = fusion.nearest(f["pan"], (H4, W4))
    obj_masks = (pan4[None] == oid[:, None, None]) & valid[:, None, None]
    return {"object_masks": obj_masks, "valid": valid, "labels": oid % fusion.INSTANCE_OFFSET,
            "sel_oid": oid, "obj_scores": qs[sel], "pan_seg": f["pan"], "pass_count": pass_count}


def _mha(pr, p, name, x, kv, mask, heads):
    B, L, D = x.shape
    hd = D // heads
    q = lin(pr, p, f"{name}.q", x).reshape(B, L, heads, hd)
    k = lin(pr, p, f"{name}.k", kv).reshape(B, -1, heads, hd)
    v = lin(pr, p, f"{name}.v", kv).reshape(B, -1, heads, hd)
    s = pr.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    a = torch.softmax(s.masked_fill(~mask[:, None], -1e9), -1)
    return lin(pr, p, f"{name}.o", pr.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, L, D))


def _cross(pr, p, name, x, patches, mask, heads):
    """Every pair's queries attend to the same patches under its own mask."""
    B, L, D = x.shape
    hd = D // heads
    q = lin(pr, p, f"{name}.q", x).reshape(B, L, heads, hd)
    k = lin(pr, p, f"{name}.k", patches).reshape(-1, heads, hd)
    v = lin(pr, p, f"{name}.v", patches).reshape(-1, heads, hd)
    mask = mask | ~mask.any(-1, keepdim=True)  # an empty pair attends everywhere
    s = pr.einsum("bqhd,phd->bhqp", q, k) * hd ** -0.5
    a = torch.softmax(s.masked_fill(~mask[:, None, None], -1e9), -1)
    return lin(pr, p, f"{name}.o", pr.einsum("bhqp,phd->bqhd", a, v).reshape(B, L, D))


def head(pr: Prec, W, mask_features, object_masks, valid, text_ids, text_mask, psg, picks,
         pair_block: int = 256, prefix="head."):
    """→ (binary [M²], multiclass [M², R], visual tokens [len(picks), Qr, Dllm]).
    Pairs run in blocks of ``pair_block`` rows."""
    p = Params(W, prefix)
    qf = psg["qformer"]
    heads, eps = qf["num_heads"], 1e-12
    M = object_masks.shape[0]
    ps = psg["patch_size"]
    patches = pr.conv(mask_features.float(), p("patch_embed.weight"), p("patch_embed.bias"),
                      stride=ps)
    hp, wp, Cf = patches.shape
    patches = patches.reshape(hp * wp, Cf)
    obj = F.interpolate(object_masks.float()[:, None], size=(hp, wp), mode="bilinear",
                        align_corners=False)[:, 0] > 0.5
    obj = (obj & valid[:, None, None]).reshape(M, hp * wp)
    pmask = (obj[:, None] | obj[None]).reshape(M * M, hp * wp)
    query = torch.cat([p("rel_cls_query"), p("relation_query")])
    Qn = query.shape[0]
    q = p.sub("qformer")
    outs = []
    for s in range(0, M * M, pair_block):
        ids, tm, pm = text_ids[s:s + pair_block], text_mask[s:s + pair_block], pmask[s:s + pair_block]
        B, T = ids.shape
        tok = q("word_embed.weight")[ids.long()] + q("pos_embed")[:T][None]
        x = ln(q, "embed_ln", torch.cat([query[None].expand(B, -1, -1), tok], 1), eps)
        seq = torch.cat([torch.ones(B, Qn, dtype=torch.bool, device=x.device), tm.bool()], 1)
        smask = seq[:, None, :] & seq[:, :, None]
        for i in range(qf["num_layers"]):
            x = ln(q, f"self_ln{i}", x + _mha(pr, q, f"self_attn{i}", x, x, smask, heads), eps)
            xq = x[:, :Qn]
            xq = ln(q, f"cross_ln{i}", xq + _cross(pr, q, f"cross_attn{i}", xq, patches, pm, heads), eps)

            def ffn(part, y):
                h = lin(pr, q, f"ffn_{part}_up{i}", y)
                return ln(q, f"ffn_{part}_ln{i}", y + lin(pr, q, f"ffn_{part}_down{i}", F.gelu(h)), eps)

            x = torch.cat([ffn("q", xq), ffn("t", x[:, Qn:])], 1)
        outs.append(x[:, :Qn])
    qf_out = torch.cat(outs)
    cls = qf_out[:, 0]
    binary = lin(pr, p, "binary_rel_cls", cls)[:, 0]
    multi = lin(pr, p, "multiclass_rel_cls", cls)
    vis = lin(pr, p, "language_projection", qf_out[picks.long(), 1:])
    return binary, multi, vis
