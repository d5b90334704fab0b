"""PSG v1 (the closed-set Mask2Former R50 detector of ``openpsg_tpu_torch``)
under the benchmark: the model built from a configuration file, the
benchmark's weights handed to it, one image at a time through
``PSGMask2FormerRelation.infer``, the taps on the sampled chunk, and the
comparison with the plain reference.

The taps wrap ``segment``, ``fuse_select`` and ``relation_tail`` and hook
``pixel_decoder`` and ``head``; they keep references to the program's own
outputs.  Each wrapper is also a profiler range."""

from __future__ import annotations

import gc
import sys
from typing import Dict, List, Optional

import torch

from psgbench import weights as wgen
from psgbench.reference import psg_v1 as ref
from psgbench.reference.prec import Prec, rel_err, strict_f32
from psgbench.systems.psg_v4 import DTYPES, _acc, mask_shift

MODULES = ("segmenter", "head")
# as in psg_v4: the residual branches ``init.branch_scale`` quiets, the mask
# offset's layers, and the class head that ``init.class_gain`` sharpens
BRANCHES = (("segmenter.pixel_decoder.layers.", "segmenter.decoder.layers."),
            ("self_attn.output_proj.", "ffn.fc2.", "cross_attn.out.", "self_attn.out.", "ffn_down."))
MASK_OFFSET = ("segmenter.pixel_decoder.mask_feature_proj", "segmenter.decoder.final_mask_head.fc2")
CLASS_HEAD = "segmenter.decoder.cls_head.weight"


def program_config(cfg: Dict):
    """The configuration file → ``M2FRelationConfig``."""
    from openpsg_tpu_torch.models.commons.text_encoder import BertStyleConfig
    from openpsg_tpu_torch.models.detectors.mask2former_relation import M2FRelationConfig
    from openpsg_tpu_torch.models.relation.head_v1 import HeadV1Config
    from openpsg_tpu_torch.models.segmenter.mask2former import Mask2FormerConfig

    m = cfg["model"]
    dt = DTYPES[m["dtype"]]
    seg = Mask2FormerConfig(backbone=m["backbone"], dim=m["dim"], mask_dim=m["mask_dim"],
                            num_queries=m["num_queries"], enc_layers=m["enc_layers"],
                            dec_layers=m["dec_layers"], ffn_hidden=m["ffn_hidden"],
                            enc_ffn_hidden=m["enc_ffn_hidden"], num_classes=m["num_classes"],
                            dtype=dt)
    h = m["head"]
    enc = BertStyleConfig(num_layers=h["num_layers"], num_heads=h["num_heads"],
                          intermediate=h["intermediate"], dtype=dt)
    v1 = HeadV1Config(encoder=enc, input_feature_size=m["mask_dim"],
                      output_feature_size=h["output_feature_size"],
                      num_relation_classes=h["num_relation_classes"],
                      cls_qk_size=h["cls_qk_size"], pred_type="attention", loss_type="v1",
                      dtype=dt)
    return M2FRelationConfig(segmenter=seg, head_version="v1", head_v1=v1,
                             max_objects=m["max_objects"],
                             max_objects_padded=m["max_objects_padded"],
                             object_mask_thr=m["object_mask_thr"], iou_thr=m["iou_thr"])


class System:
    """The model under test for one run."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        from openpsg_tpu_torch.models.detectors.mask2former_relation import (
            PSGMask2FormerRelation,
        )

        self.cfg, self.seed, self.device = cfg, int(seed), torch.device(device)
        self.traffic = traffic
        self.model = PSGMask2FormerRelation(program_config(cfg), seed=0, device=self.device)
        m = self.model
        self.num_things = m.num_things
        self.spec = wgen.spec_of({g: getattr(m, g) for g in MODULES})
        self.spec.append(("object_cls_embed", tuple(m.object_cls_embed.shape),
                          m.object_cls_embed.dtype))
        self.set_seed(seed)
        self.taps: Optional[List[Dict]] = None
        self._rec: Optional[Dict] = None
        self._install_taps()

    def set_seed(self, seed: int) -> None:
        """Hand the program this seed's weights (the mask offset read as in
        :func:`psg_v4.mask_shift`)."""
        self.seed = int(seed)
        m = self.model
        w = self.weights(0.0)
        self.mask_shift = mask_shift(self, w)
        wgen.offset_masks(w, *MASK_OFFSET, self.mask_shift)
        wgen.load({g: getattr(m, g) for g in MODULES}, w)
        m.object_cls_embed = w["object_cls_embed"]

    def weights(self, shift: float) -> Dict[str, torch.Tensor]:
        """This seed's weights, shaped by the configuration's ``init``."""
        init = self.cfg["init"]
        w = wgen.make(self.spec, self.seed, self.device)
        wgen.scale_matching(w, *BRANCHES, init["branch_scale"])
        w[CLASS_HEAD].mul_(init["class_gain"])
        wgen.offset_masks(w, *MASK_OFFSET, shift)
        return w

    def reference_masks(self, W, image) -> torch.Tensor:
        """The float32 reference's mask logits for one prepared image."""
        mc, pr = self.cfg["model"], Prec("f32")
        memory, shapes, mf = ref.backbone_pixel(pr, W, image, mc)
        return ref.decoder(pr, W, memory, shapes, mf, mc)[1]

    def preprocessor(self):
        from openpsg_tpu_torch.data.preprocess import Preprocessor, aspect_buckets

        scale = tuple(self.cfg["model"]["test_scale"])
        return Preprocessor(scale=scale, buckets=aspect_buckets(scale))

    def run_chunk(self, images, hws, stage_times=None):
        """Each image through ``PSGMask2FormerRelation.infer`` → host results."""
        out = []
        for im, hw in zip(images, hws):
            with torch.profiler.record_function("infer"):
                out.append(self.model.infer(im, hw, stage_times=stage_times))
        return out

    def rows(self, results) -> Dict:
        return {}

    def _install_taps(self):
        m = self.model
        rf = torch.profiler.record_function

        def wrap(name, fn, keep, start=False):
            def call(*a, **k):
                if start and self.taps is not None:
                    self._rec = {}
                    self.taps.append(self._rec)
                with rf(name):
                    out = fn(*a, **k)
                if self.taps is not None:
                    keep(a, out)
                return out
            return call

        m.segment = wrap("segment", m.segment, lambda a, out: self._rec.update(
            image=a[0], cls_logits=out["cls_logits"], masks=out["masks"],
            mask_features=out["mask_features"]), start=True)
        layers = m.segmenter.decoder.layers
        m.fuse_select = wrap("fuse_select", m.fuse_select,
                             lambda a, out: self._rec.update(sel=out, hw=a[1], img_hw=a[2]))
        m.relation_tail = wrap("relation_tail", m.relation_tail,
                               lambda a, out: self._rec.update(out=out))

        def hook(fn):
            return lambda mod, args, out=None: (fn(args, out) if self.taps is not None else None)

        m.segmenter.pixel_decoder.register_forward_hook(
            hook(lambda a, out: self._rec.update(memory=out[0], shapes=out[1], dec_in=[],
                                                 mf_lvl=[], gate_embed=[])))
        for layer in layers:
            layer.register_forward_pre_hook(hook(lambda a, out: self._rec["dec_in"].append(a[0])))
            layer.register_forward_pre_hook(hook(lambda a, out: self._rec["mf_lvl"].append(a[3])))
            layer.mask_head.register_forward_hook(
                hook(lambda a, out: self._rec["gate_embed"].append(out)))
        layers[-1].register_forward_hook(hook(lambda a, out: self._rec.update(dec_out=out)))
        m.head.register_forward_pre_hook(
            hook(lambda a, out: self._rec.update(tokens=a[0][0], valid=a[1][0])))
        m.head.register_forward_hook(hook(lambda a, out: self._rec.update(scores=out[0])))

    def release(self) -> None:
        self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, taps: List[Dict], modes=("f32",)) -> Dict[str, Dict[str, float]]:
        """→ {mode: {number: value}} as :meth:`psg_v4.System.check`."""
        W = self.weights(self.mask_shift)
        out = {m: {} for m in modes}
        self.detail = {"mask_shift": self.mask_shift}
        mc = self.cfg["model"]
        with torch.no_grad(), strict_f32():
            for t in taps:
                f32 = Prec("f32")
                mem_r, shapes, mf_r = ref.backbone_pixel(f32, W, t["image"], mc)
                levels = ref.decoder_levels(W, t["memory"], shapes, t["mask_features"], mc)
                steps = t["dec_in"][1:] + [t["dec_out"]]

                # each layer's mask gate as the program computed it (a sign)
                gates = [torch.einsum("qc,pc->qp", e.float(), m.float())
                         for e, m in zip(t["gate_embed"], t["mf_lvl"])]

                def dec(pr):
                    """Each layer's mask logits, and the layer under the
                    program's gate, from the program's input to it; then the
                    heads from its last layer → [(ref out, program out)]."""
                    pairs = []
                    for i, (q, nxt) in enumerate(zip(t["dec_in"], steps)):
                        pairs.append((ref.gate_logits(pr, W, i, q, levels), gates[i]))
                        pairs.append((ref.decoder_layer(pr, W, i, q, levels, gates[i] > 0), nxt))
                    cls, masks = ref.decoder_heads(pr, W, t["dec_out"], t["mask_features"])
                    return pairs + [(cls, t["cls_logits"]), (masks, t["masks"])]

                dec_r = dec(f32)
                fz = ref.fuse_select(t["cls_logits"], t["masks"], t["hw"], t["img_hw"], mc,
                                     self.num_things)
                o = t["sel"]
                toks = ref.tokens(W, t["mask_features"], o[0], o[3])
                head_r = ref.head(f32, W, toks, o[2], mc)
                self.detail.setdefault("objects", []).append(int(o[2].sum()))
                for mode in modes:
                    r = out[mode]
                    if mode == "f32":
                        pix = max(rel_err(t["memory"], mem_r), rel_err(t["mask_features"], mf_r))
                        dec_e = max(rel_err(prog, r_) for r_, prog in dec_r)
                        head = max(rel_err(t["tokens"], toks), rel_err(t["scores"], head_r))
                        trip = triplet_gap(t["out"]["triplets"], head_r, fz)
                        diff = self._fusion_diff(t, fz, head_r)
                        if any(diff.values()):
                            print(f"psgbench: fusion differs: {diff}", file=sys.stderr)
                        _acc(r, "fusion_diff", sum(diff.values()), sum)
                    else:
                        pr = Prec(mode)
                        mem_c, _, mf_c = ref.backbone_pixel(pr, W, t["image"], mc)
                        pix = max(rel_err(mem_c, mem_r), rel_err(mf_c, mf_r))
                        dec_e = max(rel_err(c[0], r_[0]) for c, r_ in zip(dec(pr), dec_r))
                        head_c = ref.head(pr, W, toks, o[2], mc)
                        head = rel_err(head_c, head_r)
                        trip = triplet_gap(ref.triplets(head_c, fz["valid"], fz["obj_scores"])[0],
                                           head_r, fz)
                    _acc(r, "pixdec_rel", pix, max)
                    _acc(r, "decoder_rel", dec_e, max)
                    _acc(r, "head_rel", head, max)
                    _acc(r, "triplet_gap", trip, max)
        return out

    @staticmethod
    def _fusion_diff(t, fz, scores_ref) -> Dict[str, int]:
        object_masks, oid, valid, labels, obj_scores, pan = t["sel"]
        d = {"object_masks": int((object_masks != fz["object_masks"]).sum()),
             "valid": int((valid != fz["valid"]).sum()),
             "labels": int((labels.long() != fz["labels"]).sum()),
             "oid": int((oid.long() != fz["sel_oid"]).sum()),
             "pan": int((pan.long() != fz["pan_seg"]).sum()),
             "obj_scores": int((~torch.isclose(obj_scores.float(), fz["obj_scores"].float(),
                                               rtol=1e-5, atol=1e-6)).sum())}
        if int(fz["valid"].sum()) < 2:  # every score ties at 0: the stable order decides
            trip, _ = ref.triplets(scores_ref, fz["valid"], fz["obj_scores"])
            d["triplets"] = int((t["out"]["triplets"].long() != trip).sum())
        return d

    def flops_per_image(self, bucket) -> float:
        """Model operations per image at ``bucket``, the reference's products
        counted from shapes on the ``meta`` device."""
        mc = self.cfg["model"]
        meta = torch.device("meta")
        e = lambda *s, dtype=torch.float32: torch.empty(tuple(s), dtype=dtype, device=meta)
        W = {n: e(*s, dtype=d) for n, s, d in self.spec}
        pr = Prec("f32")
        memory, shapes, mf = ref.backbone_pixel(pr, W, e(*bucket, 3), mc)
        ref.decoder(pr, W, memory, shapes, mf, mc)
        M = mc["max_objects_padded"]
        ref.head(pr, W, e(M, mc["mask_dim"]), e(M, dtype=torch.bool), mc)
        return pr.flops


def triplet_gap(picked, scores_ref, fz) -> float:
    """The triplet selection's widest gap: by how much a picked triplet's
    reference log-probability lies below the reference's k-th best, for k
    picks (0 where fewer than two objects are kept: every probability is 0
    and ``fusion_diff`` compares the order; inf where an invalid triplet is
    picked while valid ones are left)."""
    if int(fz["valid"].sum()) < 2:
        return 0.0
    probs = ref.triplet_probs(scores_ref, fz["valid"], fz["obj_scores"])
    p = picked.long()
    got = probs[p[:, 2], p[:, 0], p[:, 1]]
    n_valid = int((probs > 0).sum())
    if n_valid < p.shape[0]:
        return 0.0 if int((got > 0).sum()) == n_valid else float("inf")
    if bool((got <= 0).any()):
        return float("inf")
    kth = torch.sort(probs.reshape(-1), descending=True).values[p.shape[0] - 1]
    return float(torch.clamp(torch.log(kth) - torch.log(got), min=0).max())
