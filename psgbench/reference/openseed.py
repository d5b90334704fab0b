"""Plain float32 reference of the OpenSeeD-style segmenter of PSG v4: Swin
backbone, deformable pixel decoder, two-stage query decoder with cosine
class logits.  One image, [H, W, C] layout.

It follows the published OpenSeeD / Mask DINO equations as the measured
program states them (Swin-T windows of 7 with shifted windows and a
relative position bias; multi-scale deformable attention over 4 levels
with learned offsets; 300 queries picked by the encoder's class score;
box refinement in each decoder layer).  Deformable sampling is
``grid_sample`` (bilinear, zero padding, half-pixel centres).  Weights are
read by the program's parameter names from a mapping ``W``; nothing of the
program is imported.
"""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F

from psgbench.reference.prec import Prec, group_norm32, layer_norm

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


class Params:
    """Names under a prefix of the weight mapping, read in float32."""

    def __init__(self, W, prefix: str):
        self.W, self.prefix = W, prefix

    def __call__(self, name: str) -> torch.Tensor:
        return self.W[self.prefix + name].float()

    def sub(self, name: str) -> "Params":
        return Params(self.W, self.prefix + name + ".")


def lin(pr: Prec, p: Params, name: str, x, bias: bool = True):
    return pr.linear(x, p(name + ".weight"), p(name + ".bias") if bias else None)


def ln(p: Params, name: str, x, eps: float = 1e-5):
    return layer_norm(x, p(name + ".weight"), p(name + ".bias"), eps)


def mlp(pr: Prec, p: Params, name: str, x, layers: int):
    for i in range(layers):
        x = lin(pr, p, f"{name}.fc{i}", x)
        if i < layers - 1:
            x = torch.relu(x)
    return x


# ---------------------------------------------------------------- Swin
def _rel_index(w: int, device) -> torch.Tensor:
    c = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij")).reshape(2, -1)
    rel = (c[:, :, None] - c[:, None, :]).permute(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).reshape(-1).to(device)


def _shift_mask(Hp: int, Wp: int, w: int, s: int, device) -> torch.Tensor:
    img = torch.zeros(Hp, Wp)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -s), slice(-s, None)):
        for ws in (slice(0, -w), slice(-w, -s), slice(-s, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(Hp // w, w, Wp // w, w).permute(0, 2, 1, 3).reshape(-1, w * w)
    return torch.where(win[:, None, :] != win[:, :, None], -100.0, 0.0).to(device)


def swin_block(pr, p, x, heads: int, w: int, shift: int):
    H, W_, C = x.shape
    Hp, Wp = H + (-H) % w, W_ + (-W_) % w
    h = F.pad(ln(p, "norm1", x), (0, 0, 0, Wp - W_, 0, Hp - H))
    if shift:
        h = torch.roll(h, (-shift, -shift), dims=(0, 1))
    win = h.reshape(Hp // w, w, Wp // w, w, C).permute(0, 2, 1, 3, 4).reshape(-1, w * w, C)
    nW, L = win.shape[:2]
    hd = C // heads
    qkv = lin(pr, p, "attn.qkv", win).reshape(nW, L, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
    a = pr.einsum("nhld,nhmd->nhlm", q, k)
    bias = p("attn.rel_pos_bias")[_rel_index(w, x.device)].reshape(L, L, heads)
    a = a + bias.permute(2, 0, 1)[None]
    if shift:
        a = a + _shift_mask(Hp, Wp, w, shift, x.device)[:, None]
    o = pr.einsum("nhlm,nhmd->nhld", torch.softmax(a, -1), v).permute(0, 2, 1, 3)
    o = lin(pr, p, "attn.proj", o.reshape(nW, L, C))
    o = o.reshape(Hp // w, Wp // w, w, w, C).permute(0, 2, 1, 3, 4).reshape(Hp, Wp, C)
    if shift:
        o = torch.roll(o, (shift, shift), dims=(0, 1))
    x = x + o[:H, :W_]
    m = lin(pr, p, "mlp_fc2", F.gelu(lin(pr, p, "mlp_fc1", ln(p, "norm2", x))))
    return x + m


def swin(pr, p, img, depths, heads, window):
    """img [H, W, 3] normalized → 4 maps at strides 4, 8, 16, 32."""
    x = pr.conv(img, p("patch_embed.weight"), p("patch_embed.bias"), stride=4)
    x = ln(p, "patch_norm", x)
    outs = []
    for s, depth in enumerate(depths):
        for b in range(depth):
            x = swin_block(pr, p.sub(f"stage{s}_block{b}"), x, heads[s], window,
                           0 if b % 2 == 0 else window // 2)
        outs.append(ln(p, f"out_norm{s}", x))
        if s < len(depths) - 1:
            H, W_, C = x.shape
            x = F.pad(x, (0, 0, 0, W_ % 2, 0, H % 2))
            x = torch.cat([x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2]], -1)
            x = pr.linear(ln(p, f"merge{s}.norm", x), p(f"merge{s}.reduction.weight"))
    return outs


# ------------------------------------------------------ deformable attention
def centers(shapes) -> torch.Tensor:
    """Pixel-centre (x, y) of every level, normalized: [Lv, 2]."""
    pts = []
    for h, w in shapes:
        ys, xs = torch.meshgrid((torch.arange(h) + 0.5) / h, (torch.arange(w) + 0.5) / w,
                                indexing="ij")
        pts.append(torch.stack([xs, ys], -1).reshape(-1, 2))
    return torch.cat(pts).float()


def sine_embed_1d(v, half: int):
    i = torch.arange(half, device=v.device)
    dim_t = 10000.0 ** (2.0 * torch.div(i, 2, rounding_mode="floor") / half)
    ang = v.float() * (2 * math.pi) / dim_t
    return torch.stack([torch.sin(ang[..., 0::2]), torch.cos(ang[..., 1::2])], -1).reshape(
        *ang.shape[:-1], half)


def sine_pos(coords, dim: int):
    half = dim // 2
    return torch.cat([sine_embed_1d(coords[..., 1:2], half), sine_embed_1d(coords[..., 0:1], half)], -1)


def msda(pr, p, query, value, shapes, ref, heads: int, levels: int, points: int,
         points_per_level=None):
    """Multi-scale deformable attention → [Lq, C]; ref [Lq, 2] centres or
    [Lq, 4] cxcywh boxes."""
    Lq, C = query.shape
    hd = C // heads
    v = lin(pr, p, "value_proj", value).reshape(-1, heads, hd)
    off = lin(pr, p, "sampling_offsets", query).reshape(Lq, heads, levels, points, 2)
    aw = torch.softmax(lin(pr, p, "attention_weights", query).reshape(Lq, heads, levels * points), -1)
    aw = aw.reshape(Lq, heads, levels, points)
    if points_per_level is not None:
        keep = torch.zeros(levels, points, device=aw.device)
        for lvl, k in enumerate(points_per_level):
            keep[lvl, :k] = 1.0
        aw = aw * keep
        aw = aw / torch.clamp(aw.sum(dim=(-2, -1), keepdim=True), min=1e-9)
    if ref.shape[-1] == 2:
        size = torch.tensor([(w, h) for h, w in shapes], dtype=torch.float32, device=ref.device)
        loc = ref[:, None, None, None, :] + off / size[None, None, :, None, :]
    else:
        loc = ref[:, None, None, None, :2] + off / points * ref[:, None, None, None, 2:] * 0.5
    out = torch.zeros(heads, hd, Lq, device=query.device)
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        vl = v[start:start + h * w].permute(1, 2, 0).reshape(heads, hd, h, w)
        start += h * w
        grid = (2.0 * loc[:, :, lvl] - 1.0).permute(1, 0, 2, 3)          # [heads, Lq, K, 2]
        s = F.grid_sample(vl, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
        out = out + (s * aw[:, :, lvl].permute(1, 0, 2)[:, None]).sum(-1)
    return lin(pr, p, "output_proj", out.permute(2, 0, 1).reshape(Lq, C))


def ffn(pr, p, x):
    return ln(p, "norm", x + lin(pr, p, "fc2", torch.relu(lin(pr, p, "fc1", x))))


# -------------------------------------------------------------- pixel decoder
def pixel_decoder(pr, p, feats, cfg):
    """→ (memory [Lv, dim] fine-first, shapes, mask_features [H/4, W/4, Dm])."""
    c2, c3, c4, c5 = feats
    dim = cfg["dim"]
    toks = [group_norm32(pr.conv(f, p(f"input_proj{i}.weight"), p(f"input_proj{i}.bias")),
                         p(f"input_norm{i}.weight"), p(f"input_norm{i}.bias"))
            for i, f in enumerate((c3, c4, c5))]
    prev = c5
    for i in range(3, cfg["total_levels"]):
        t = group_norm32(pr.conv(prev, p(f"input_proj{i}.weight"), p(f"input_proj{i}.bias"),
                                 stride=2, padding=1),
                         p(f"input_norm{i}.weight"), p(f"input_norm{i}.bias"))
        toks.append(t)
        prev = t
    shapes = [(t.shape[0], t.shape[1]) for t in toks]
    dev = c2.device
    pos = []
    for i, (h, w) in enumerate(shapes):
        ys, xs = torch.meshgrid((torch.arange(h) + 1.0) / (h + 1e-6),
                                (torch.arange(w) + 1.0) / (w + 1e-6), indexing="ij")
        coords = torch.stack([xs, ys], -1).reshape(-1, 2).float().to(dev)
        pos.append(sine_pos(coords, dim) + p("level_embed")[i][None])
    src = torch.cat([t.reshape(-1, dim) for t in toks])
    pos = torch.cat(pos)
    ref = centers(shapes).to(dev)
    ppl = cfg.get("enc_points_per_level")
    for i in range(cfg["enc_layers"]):
        lp = p.sub(f"layers.{i}")
        a = msda(pr, lp.sub("self_attn"), src + pos, src, shapes, ref, 8, cfg["total_levels"],
                 cfg["num_points"], ppl)
        src = ffn(pr, lp.sub("ffn"), ln(lp, "norm1", src + a))
    h8, w8 = shapes[0]
    lat = group_norm32(pr.conv(c2, p("lateral4.weight")), p("lateral4_norm.weight"),
                       p("lateral4_norm.bias"))
    up = F.interpolate(src[: h8 * w8].reshape(h8, w8, dim).permute(2, 0, 1)[None],
                       size=tuple(c2.shape[:2]), mode="bilinear", align_corners=False)
    fused = group_norm32(pr.conv(lat + up[0].permute(1, 2, 0), p("output4.weight"), padding=1),
                         p("output4_norm.weight"), p("output4_norm.bias"))
    mf = pr.conv(torch.relu(fused), p("mask_feature_proj.weight"), p("mask_feature_proj.bias"))
    return src, shapes, mf


# -------------------------------------------------------------- query decoder
def class_logits(pr, p, x, class_embeds):
    proj = pr.linear(x, p("class_embed").t())
    proj = proj / (torch.linalg.vector_norm(proj, dim=-1, keepdim=True) + 1e-6)
    return pr.linear(proj, class_embeds.float()) * torch.exp(p("logit_scale"))


def inverse_sigmoid(x, eps=1e-5):
    x = torch.clamp(x, eps, 1 - eps)
    return torch.log(x / (1 - x))


def box_sine(boxes, dim: int):
    half = dim // 2
    return torch.cat([sine_embed_1d(boxes[..., i:i + 1], half) for i in (1, 0, 2, 3)], -1)


def proposals(pr, p, memory, shapes, class_embeds, cfg):
    """Two-stage proposals: → (enc_out [Lv, C], enc_score [Lv],
    proposal boxes [Lv, 4])."""
    dev = memory.device
    strides = [8, 16, 32] + [64 * 2 ** i for i in range(len(shapes) - 3)]
    wh_exp = [list(cfg["ckpt_level_strides"]).index(s) for s in strides[: len(shapes)]]
    wh = torch.cat([torch.full((h * w, 2), 0.05 * 2.0 ** wh_exp[i]) for i, (h, w) in enumerate(shapes)])
    base = torch.cat([centers(shapes), wh], -1).to(dev)
    valid = ((base > 0.01) & (base < 0.99)).all(-1)
    enc_out = ln(p, "enc_norm", lin(pr, p, "enc_proj",
                                    torch.where(valid[:, None], memory.float(), 0.0)))
    score = class_logits(pr, p, enc_out, class_embeds).max(-1).values
    delta = mlp(pr, p, "enc_box_head", enc_out, 3)
    logit = torch.where(valid[:, None], inverse_sigmoid(base), torch.tensor(float("inf"), device=dev))
    return enc_out, score, torch.sigmoid(logit + delta)


def top_queries(score, k: int):
    """The k best rows, ties to the lower index."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


def decoder_layer(pr, lp, q, b, memory, shapes, cfg):
    """One decoder layer: self-attention with box position queries, box
    deformable cross-attention, FFN, box refinement → (queries, boxes)."""
    dim, heads = cfg["dim"], 8
    q, b = q.float(), b.float()
    qpos = mlp(pr, lp, "ref_point_head", box_sine(b, dim), 2)
    qk = q + qpos
    sp = lp.sub("self_attn")
    L, hd = q.shape[0], dim // heads
    qq = lin(pr, sp, "mha.query", qk).reshape(L, heads, hd) / hd ** 0.5
    kk = lin(pr, sp, "mha.key", qk).reshape(L, heads, hd)
    vv = lin(pr, sp, "mha.value", q).reshape(L, heads, hd)
    a = torch.softmax(pr.einsum("qhd,khd->hqk", qq, kk), -1)
    o = lin(pr, sp, "mha.out", pr.einsum("hqk,khd->qhd", a, vv).reshape(L, dim))
    q = ln(sp, "norm", q + o)
    cross = msda(pr, lp.sub("cross_attn"), q + qpos, memory.float(), shapes, b, heads,
                 cfg["total_levels"], cfg["num_points"])
    q = ffn(pr, lp.sub("ffn"), ln(lp, "norm_cross", q + cross))
    return q, torch.sigmoid(inverse_sigmoid(b) + mlp(pr, lp, "box_head", q, 3))


def decoder_heads(pr, p, q, mask_features, class_embeds):
    """The last layer's queries → (cls_logits [Q, K], masks [Q, H4, W4])."""
    dec = ln(p, "decoder_norm", q.float())
    me = mlp(pr, p, "mask_head", dec, 3)
    return class_logits(pr, p, dec, class_embeds), pr.einsum("qc,hwc->qhw", me, mask_features.float())


def decoder_layers(pr, p, queries, boxes, memory, shapes, mask_features, class_embeds, cfg):
    """The decoder layers from their first layer's input → (cls_logits
    [Q, K], masks [Q, H4, W4])."""
    q, b = queries, boxes
    for i in range(cfg["dec_layers"]):
        q, b = decoder_layer(pr, p.sub(f"layers.{i}"), q, b, memory, shapes, cfg)
    return decoder_heads(pr, p, q, mask_features, class_embeds)


def normalize(image_u8):
    mean = torch.tensor(PIXEL_MEAN, device=image_u8.device)
    std = torch.tensor(PIXEL_STD, device=image_u8.device)
    return (image_u8.float() - mean) / std


def backbone_pixel(pr, W, image_u8, cfg, prefix="segmenter."):
    """Image → (memory, shapes, mask_features)."""
    p = Params(W, prefix)
    feats = swin(pr, p.sub("backbone"), normalize(image_u8), cfg["depths"], cfg["num_heads"],
                 cfg["window"])
    return pixel_decoder(pr, p.sub("pixel_decoder"), feats, cfg)
