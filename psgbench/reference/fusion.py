"""Plain reference of panoptic fusion and object selection, in float32:
OpenSeeD's sigmoid / per-class-instance fusion (PSG v4) and mmdet
Mask2Former's softmax-with-void / global-instance fusion (PSG v1).

A pixel goes to the kept query with the largest ``score × mask
probability``; a query survives when it wins at least ``iou_thr`` of its
own binary mask.  Thing ids are ``label + 1000 × instance``; void is 133.
Objects are the surviving ids in ascending order, at most ``max_objects``,
padded to ``padded``.
"""

from __future__ import annotations

import torch

INSTANCE_OFFSET = 1000
VOID = 133
BIG = 2 ** 31 - 1


def nearest(idmap, out_hw):
    """Nearest resize of [..., H, W]: source ``floor((i + 0.5) · in / out)``."""
    H, W = idmap.shape[-2:]
    h, w = out_hw
    ys = torch.floor((torch.arange(h, device=idmap.device) + 0.5) * H / h).long()
    xs = torch.floor((torch.arange(w, device=idmap.device) + 0.5) * W / w).long()
    return idmap[..., ys, :][..., xs]


def fuse(cls_logits, mask_logits, *, mode: str, thr: float, iou_thr: float, num_things: int,
         region):
    """→ dict pan [H, W] ids, ids [Q], survive [Q], qscore [Q]."""
    Q, K = cls_logits.shape
    if mode == "sigmoid":
        probs = torch.sigmoid(cls_logits.float())
        scores, labels = probs.max(-1).values, probs.argmax(-1)
        keep = scores > thr
    else:  # softmax over the classes and a last void column
        probs = torch.softmax(cls_logits.float(), -1)
        scores, labels = probs.max(-1).values, probs.argmax(-1)
        keep = (labels != K - 1) & (scores > thr)
        labels = torch.clamp(labels, max=K - 2)
    mp = torch.sigmoid(mask_logits.float()) * region[None]
    wgt = torch.where(keep[:, None, None], scores[:, None, None] * mp, -1.0)
    wscore, win = wgt.max(0).values, wgt.argmax(0)  # ties to the first query
    wscore = wscore * keep.any()
    own = (win[None] == torch.arange(Q, device=win.device)[:, None, None]) & keep[:, None, None]
    own = own & region[None]
    binary = mp >= 0.5
    area, orig = own.sum((1, 2)), binary.sum((1, 2))
    survive = keep & (area > 0) & (orig > 0) & (area >= iou_thr * orig)
    thing = labels < num_things
    if mode == "sigmoid":  # per class: things count from 0 per class in query order
        inst = torch.zeros(Q, dtype=torch.long, device=labels.device)
        seen = {}
        for q, (lab, s, t) in enumerate(zip(labels.tolist(), survive.tolist(), thing.tolist())):
            inst[q] = seen.get(lab, 0)
            if s and t:
                seen[lab] = seen.get(lab, 0) + 1
    else:  # one counter over surviving things, from 1
        counted = (survive & thing).long()
        inst = torch.cumsum(counted, 0) * counted
    ids = torch.where(thing, labels + INSTANCE_OFFSET * inst, labels)
    pix = survive[win] & keep[win] & own.any(0)
    pan = torch.where(pix, ids[win], VOID)
    seg = own & pix[None]
    seg_area = seg.sum((1, 2))
    qscore = torch.where(seg, wscore[None], 0.0).sum((1, 2)) / torch.clamp(seg_area, min=1)
    return {"pan": pan, "ids": ids, "survive": survive & (seg_area > 0), "qscore": qscore}


def select(survive, ids, padded: int, max_objects: int):
    """Ascending surviving ids, one query per id (the first) → (sel [M],
    oid [M], valid [M]); the rest follow in query order."""
    key = torch.where(survive, ids.long(), BIG)
    if key.shape[0] < padded:
        key = torch.cat([key, torch.full((padded - key.shape[0],), BIG, device=key.device)])
    seen = set()
    for q, k in enumerate(key.tolist()):
        if k != BIG:
            if k in seen:
                key[q] = BIG
            seen.add(k)
    sel = torch.sort(key, stable=True).indices[:padded]
    oid = key[sel]
    valid = (oid != BIG) & (torch.arange(padded, device=key.device) < max_objects)
    return sel, torch.where(valid, oid, 0), valid
