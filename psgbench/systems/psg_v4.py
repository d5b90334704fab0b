"""PSG v4 of ``openpsg_tpu_torch`` under the benchmark: the model built
from a configuration file, the benchmark's weights handed to it, the calls
the window drives, the taps that keep what the timed path produced for
the sampled chunk, and the comparison with the plain reference.

The taps wrap the model's stage methods (``segment``, ``fuse_select``,
``tail_pre``, ``tail_decode``) and hook its modules (``pixel_decoder``,
the decoder's layers, ``head``, the LLM's ``lm_head``); they keep
references to the program's own outputs and change nothing it computes.
Each wrapper is also a profiler range, which names the host's work in the
trace.
"""

from __future__ import annotations

import gc
import sys
from typing import Dict, List, Optional

import torch

from psgbench import weights as wgen
from psgbench.flops import llm as llm_flops
from psgbench.traffic import make_images
from psgbench.traffic import rng as traffic_rng
from psgbench.reference import llm as ref_llm
from psgbench.reference import openseed as ref_seg
from psgbench.reference import psg_v4 as ref_v4
from psgbench.reference.prec import Prec, rel_err, strict_f32

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
MODULES = ("segmenter", "head", "llm")
# the residual branches that ``init.branch_scale`` quiets, and the layers
# that carry the mask offset (``weights.offset_masks``)
BRANCHES = (("segmenter.pixel_decoder.layers.", "segmenter.decoder.layers."),
            ("self_attn.output_proj.", "ffn.fc2.", "self_attn.mha.out.", "cross_attn.output_proj."))
MASK_OFFSET = ("segmenter.pixel_decoder.mask_feature_proj", "segmenter.decoder.mask_head.fc2")


def program_config(cfg: Dict):
    """The configuration file → ``PSGv4Config``."""
    from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4Config
    from openpsg_tpu_torch.models.llm.llama import LlamaConfig
    from openpsg_tpu_torch.models.relation.head_v4 import HeadV4Config
    from openpsg_tpu_torch.models.relation.qformer import QFormerConfig
    from openpsg_tpu_torch.models.segmenter.openseed import SegmenterConfig

    psg, seg, llm = cfg["psg"], cfg["psg"]["segmenter"], cfg["llm"]
    dt = DTYPES[psg["dtype"]]
    segc = SegmenterConfig(
        embed_dim=seg["embed_dim"], depths=tuple(seg["depths"]), num_heads=tuple(seg["num_heads"]),
        window=seg["window"], dim=seg["dim"], mask_dim=seg["mask_dim"],
        num_queries=seg["num_queries"], enc_layers=seg["enc_layers"], dec_layers=seg["dec_layers"],
        num_points=seg["num_points"], ffn_hidden=seg["ffn_hidden"],
        total_levels=seg["total_levels"], proj_dim=seg["proj_dim"],
        ckpt_level_strides=tuple(seg["ckpt_level_strides"]),
        enc_points_per_level=(tuple(seg["enc_points_per_level"])
                              if seg.get("enc_points_per_level") else None), dtype=dt)
    qf = psg["qformer"]
    qfc = QFormerConfig(hidden_size=qf["hidden_size"], num_layers=qf["num_layers"],
                        num_heads=qf["num_heads"], intermediate=qf["intermediate"],
                        encoder_hidden_size=qf["encoder_hidden_size"],
                        num_relation_queries=qf["num_relation_queries"], dtype=dt)
    head = HeadV4Config(qformer=qfc, patch_size=psg["patch_size"],
                        object_feature_size=psg["object_feature_size"],
                        max_object_num=psg["max_object_num"],
                        max_objects_padded=psg["max_objects_padded"],
                        top_pairs=psg["top_pairs"], dtype=dt)
    llmc = LlamaConfig(vocab_size=llm["vocab_size"], dim=llm["hidden_size"],
                       n_layers=llm["num_hidden_layers"], n_heads=llm["num_attention_heads"],
                       n_kv_heads=llm["num_key_value_heads"], ffn_hidden=llm["intermediate_size"],
                       rope_theta=float(llm["rope_theta"]), norm_eps=float(llm["rms_norm_eps"]),
                       max_seq_len=psg["llm_max_seq_len"], dtype=DTYPES[llm["torch_dtype"]])
    return PSGv4Config(segmenter=segc, head=head, llm=llmc,
                       max_new_tokens=psg["max_new_tokens"],
                       object_mask_thr=psg["object_mask_thr"], iou_thr=psg["iou_thr"],
                       input_hw=tuple(psg["input_hw"]) if psg.get("input_hw") else None,
                       fusion_candidates=psg["fusion_candidates"])


class System:
    """The model under test for one run."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4

        self.cfg, self.seed, self.device = cfg, int(seed), torch.device(device)
        self.traffic = traffic
        self.trip_budget = traffic.get("trip_budget")
        self.model = PSGv4(program_config(cfg), seed=0, device=self.device)
        m = self.model
        self.num_things = m.num_things
        self.pad_id, self.eos_id = m.tokenizer.pad_id, m.tokenizer.eos_id
        self.text_len, self.prompt_len = m.qf_parts["max_len"], m.llm_parts["max_len"]
        self.spec = wgen.spec_of({g: getattr(m, g) for g in MODULES})
        self.n_classes = len(m.class_names)
        self.set_seed(seed)
        self.taps: Optional[List[Dict]] = None
        self.phase_taps: Optional[List[Dict]] = None
        self._rec: Optional[Dict] = None
        self._lm_rows: Optional[torch.Tensor] = None
        self._install_taps()

    # ----------------------------------------------------------- weights
    def set_seed(self, seed: int) -> None:
        """Hand the program this seed's weights and (unit) class embeddings;
        the mask offset is read from the reference's masks on one prepared
        image of the traffic (:func:`mask_shift`)."""
        self.seed = int(seed)
        m = self.model
        gen = torch.Generator(device=self.device).manual_seed(wgen.sub_seed(self.seed, 6))
        ce = torch.randn(self.n_classes, self.cfg["psg"]["segmenter"]["proj_dim"], generator=gen,
                         device=self.device)
        self.class_embeds = ce / ce.norm(dim=-1, keepdim=True)
        W = self.weights(0.0)
        self.mask_shift = mask_shift(self, W)
        wgen.offset_masks(W, *MASK_OFFSET, self.mask_shift)
        wgen.load({g: getattr(m, g) for g in MODULES}, W)
        m.class_embeds = self.class_embeds.clone()
        self._rows_rng = traffic_rng(self.seed, 8)

    def weights(self, shift: float) -> Dict[str, torch.Tensor]:
        """This seed's weights, shaped by the configuration's ``init``."""
        W = wgen.make(self.spec, self.seed, self.device)
        wgen.scale_matching(W, *BRANCHES, self.cfg["init"]["branch_scale"])
        wgen.offset_masks(W, *MASK_OFFSET, shift)
        return W

    def reference_masks(self, W, image) -> torch.Tensor:
        """The float32 reference's mask logits for one prepared image."""
        seg = self.cfg["psg"]["segmenter"]
        pr, ce = Prec("f32"), self.class_embeds
        memory, shapes, mf = ref_seg.backbone_pixel(pr, W, image, seg)
        dp = ref_seg.Params(W, "segmenter.decoder.")
        enc, score, boxes = ref_seg.proposals(pr, dp, memory, shapes, ce, seg)
        top = ref_seg.top_queries(score, seg["num_queries"])
        return ref_seg.decoder_layers(pr, dp, enc[top], boxes[top], memory, shapes, mf, ce, seg)[1]

    # -------------------------------------------------------------- calls
    def preprocessor(self):
        from openpsg_tpu_torch.data.preprocess import Preprocessor, aspect_buckets

        scale = tuple(self.cfg["psg"]["test_scale"])
        return Preprocessor(scale=scale, buckets=aspect_buckets(scale))

    def run_chunk(self, images, hws, stage_times=None):
        """One chunk through ``PSGv4.infer_microbatch`` → host results."""
        return self.model.infer_microbatch(images, hws, trip_budget=self.trip_budget,
                                           stage_times=stage_times)

    def rows(self, results) -> Dict:
        """What the per-chunk counters read: decode trips of the chunk."""
        return {"trips": int(results[0]["decode_steps"])}

    # --------------------------------------------------------------- taps
    def _install_taps(self):
        m = self.model
        rf = torch.profiler.record_function

        def wrap(name, fn, keep):
            def call(*a, **k):
                with rf(name):
                    out = fn(*a, **k)
                if self.taps is not None:
                    keep(a, out)
                return out
            return call

        seg_fn = m.segment

        def segment(*a, **k):
            if self.taps is not None:
                self._rec = {"dec_in": []}
                self.taps.append(self._rec)
            return wrap("segment", seg_fn, lambda a, out: self._rec.update(
                image=a[0], cls_logits=out["cls_logits"], masks=out["masks"],
                mask_features=out["mask_features"]))(*a, **k)

        m.segment = segment
        m.fuse_select = wrap("fuse_select", m.fuse_select,
                             lambda a, out: self._rec.update(sel=out, img_hw=a[1]))
        m.tail_pre = wrap("tail_pre", m.tail_pre,
                          lambda a, out: self._rec.update(out=out[0], prefix=out[1]))
        dec_fn = m.tail_decode

        def tail_decode(*a, **k):
            if self.phase_taps is not None:
                self._lm_rows = self._draw_rows(a[0].shape[0])
                self._lm_logits = []
            with rf("tail_decode"):
                out = dec_fn(*a, **k)
            if self.phase_taps is not None:
                rows = self._lm_rows
                self.phase_taps.append({
                    "prefix": a[0][rows], "pmask": a[1][rows], "toks": out[0][rows],
                    "trips": int(out[2]), "logits": self._lm_logits})
                self._lm_rows = None
            return out

        m.tail_decode = tail_decode
        # the logits every step picks its tokens from, for the sampled rows
        m.llm.core.lm_head.register_forward_hook(
            lambda mod, args, out: (self._lm_logits.append(out[self._lm_rows, -1])
                                    if self._lm_rows is not None else None))

        def hook(fn):
            return lambda mod, args, out=None: (fn(args, out) if self.taps is not None else None)

        m.segmenter.pixel_decoder.register_forward_hook(
            hook(lambda a, out: self._rec.update(memory=out[0], shapes=out[1])))
        layers = m.segmenter.decoder.layers
        for layer in layers:
            layer.register_forward_pre_hook(hook(lambda a, out: self._rec["dec_in"].append(a[:2])))
        layers[-1].register_forward_hook(hook(lambda a, out: self._rec.update(dec_out=out)))
        m.head.register_forward_pre_hook(
            hook(lambda a, out: self._rec.update(text_ids=a[3], text_mask=a[4])))
        m.head.register_forward_hook(
            hook(lambda a, out: self._rec.update(binary=out["binary_logits"],
                                                 multi=out["multiclass_logits"])))

    def _draw_rows(self, n_rows: int) -> torch.Tensor:
        """A chunk's sampled decode rows: one pair of each image and as many
        again from the whole chunk, drawn from the seed."""
        K = self.cfg["psg"]["top_pairs"]
        n = n_rows // K
        rows = [i * K + int(self._rows_rng.integers(0, K)) for i in range(n)]
        rows += self._rows_rng.choice(n * K, size=n, replace=False).tolist()
        return torch.tensor(rows, device=self.device)

    def release(self) -> None:
        """Drop the program and its device memory."""
        self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------- comparison
    def check(self, taps: List[Dict], modes=("f32",)) -> Dict[str, Dict[str, float]]:
        """→ {mode: {number: value}}: ``"f32"`` reads the program against
        the float32 reference; ``"fp8"`` reads the control (the reference in
        float8) against it.  ``taps``: the sampled chunk's image records and
        the phase's decode rows (``{"llm": [...]}``)."""
        W = self.weights(self.mask_shift)
        out = {m: {} for m in modes}
        self.detail = {"mask_shift": self.mask_shift}
        with torch.no_grad(), strict_f32():
            for t in taps:
                if "llm" in t:
                    self._check_llm(W, t["llm"], modes, out)
                else:
                    self._check_image(W, t, modes, out)
        return out

    def _check_image(self, W, t, modes, out):
        psg, seg = self.cfg["psg"], self.cfg["psg"]["segmenter"]
        ce = self.class_embeds
        f32 = Prec("f32")
        mem_r, shapes, mf_r = ref_seg.backbone_pixel(f32, W, t["image"], seg)
        dp = ref_seg.Params(W, "segmenter.decoder.")
        enc_r, score_r, _ = ref_seg.proposals(f32, dp, t["memory"], shapes, ce, seg)
        steps = t["dec_in"][1:] + [t["dec_out"]]

        def decoder(pr):
            """Each layer from the program's input to it, then the heads from
            the program's last layer → [(ref out, program out)]."""
            pairs = []
            for i, ((q, b), nxt) in enumerate(zip(t["dec_in"], steps)):
                rq, rb = ref_seg.decoder_layer(pr, dp.sub(f"layers.{i}"), q, b, t["memory"],
                                               shapes, seg)
                pairs += [(rq, nxt[0]), (rb, nxt[1])]
            cls, masks = ref_seg.decoder_heads(pr, dp, t["dec_out"][0], t["mask_features"], ce)
            return pairs + [(cls, t["cls_logits"]), (masks, t["masks"])]

        dec_r = decoder(f32)
        fz = ref_v4.fuse_select(t["cls_logits"], t["masks"], t["img_hw"], psg, self.num_things)
        o = t["sel"]
        picks = t["out"]["top_pair_idx"]
        head_r = ref_v4.head(f32, W, t["mask_features"], o[0], o[1], t["text_ids"],
                             t["text_mask"], psg, picks)
        M, Qr = psg["max_objects_padded"], psg["qformer"]["num_relation_queries"]
        pv = (o[1][:, None] & o[1][None, :]).reshape(M * M)
        self.detail.setdefault("objects", []).append(int(o[1].sum()))
        for mode in modes:
            r = out[mode]
            if mode == "f32":
                pix = max(rel_err(t["memory"], mem_r), rel_err(t["mask_features"], mf_r))
                sel = proposal_gap(t["dec_in"][0][0], enc_r, score_r, seg["num_queries"])
                pair = pick_gap(picks, head_r[0], pv)
                errs = [rel_err(prog, ref) for ref, prog in dec_r]
                self.detail.setdefault("decoder_rel", []).append([round(e, 5) for e in errs])
                dec = max(errs)
                head = max(rel_err(_logits(t["binary"], t["multi"]), _logits(*head_r[:2])),
                           rel_err(t["prefix"][:, :Qr], head_r[2]))
                diff = fusion_diff(o, fz)
                if any(diff.values()):
                    print(f"psgbench: fusion differs: {diff}", file=sys.stderr)
                _acc(r, "fusion_diff", sum(diff.values()), sum)
            else:
                pr = Prec(mode)
                mem_c, _, mf_c = ref_seg.backbone_pixel(pr, W, t["image"], seg)
                pix = max(rel_err(mem_c, mem_r), rel_err(mf_c, mf_r))
                enc_c, score_c, _ = ref_seg.proposals(pr, dp, t["memory"], shapes, ce, seg)
                top_c = ref_seg.top_queries(score_c, seg["num_queries"])
                head_c = ref_v4.head(pr, W, t["mask_features"], o[0], o[1], t["text_ids"],
                                     t["text_mask"], psg, picks)
                picks_c = torch.sort(torch.where(pv, head_c[0], float("-inf")), descending=True,
                                     stable=True).indices[:psg["top_pairs"]]
                sel = proposal_gap(enc_r[top_c], enc_r, score_r, seg["num_queries"])
                pair = pick_gap(picks_c, head_r[0], pv)
                dec = max(rel_err(c[0], ref[0]) for c, ref in zip(decoder(pr), dec_r))
                head = max(rel_err(_logits(*head_c[:2]), _logits(*head_r[:2])),
                           rel_err(head_c[2], head_r[2]))
            _acc(r, "pixdec_rel", pix, max)
            _acc(r, "proposal_gap", sel, max)
            _acc(r, "pair_gap", pair, max)
            _acc(r, "decoder_rel", dec, max)
            _acc(r, "head_rel", head, max)

    def _check_llm(self, W, chunks, modes, out, block: int = 64):
        """The sampled decode rows of every chunk: the logits each served
        token was picked from, and the token, against the reference's causal
        forward over the row's prefix and served tokens.  A row that stops
        (its first pad, where it picked EOS) is compared up to that pick: the
        program goes on computing the row from the EOS it fed back, and what
        it picks there is never served."""
        for T in sorted({c["trips"] for c in chunks}):
            cs = [c for c in chunks if c["trips"] == T]
            if T == 0:
                continue
            prefix = torch.cat([c["prefix"] for c in cs])
            pmask = torch.cat([c["pmask"] for c in cs])
            toks = torch.cat([c["toks"] for c in cs])[:, :T]
            logits = torch.cat([torch.stack(c["logits"][:T], 1) for c in cs])
            for s in range(0, prefix.shape[0], block):
                sl = slice(s, s + block)
                ref = ref_llm.served_logits(Prec("f32"), W, prefix[sl], pmask[sl], toks[sl],
                                            self.cfg["llm"])
                picked = served_positions(toks[sl], self.pad_id)
                self.detail["llm_stopped_rows"] = (self.detail.get("llm_stopped_rows", 0)
                                                   + int((~picked.all(1)).sum()))
                for mode in modes:
                    if mode == "f32":
                        got, served = logits[sl], toks[sl]
                    else:
                        got = ref_llm.served_logits(Prec(mode), W, prefix[sl], pmask[sl],
                                                    toks[sl], self.cfg["llm"])
                        served = got.argmax(-1)
                    _acc(out[mode], "llm_logits_rel", rel_err(got[picked], ref[picked]), max)
                    gaps = served_gaps(ref, served, self.pad_id, self.eos_id)
                    _acc(out[mode], "llm_gap", float(gaps.max()), max)

    # ------------------------------------------------------------- counts
    def flops_per_image(self, bucket) -> float:
        """Model operations per image at ``bucket``: the reference's products
        counted from shapes on the ``meta`` device (segmenter and head), and
        the image's share of its group's LLM prefill and trips."""
        psg, seg = self.cfg["psg"], self.cfg["psg"]["segmenter"]
        meta = torch.device("meta")
        e = lambda *s, dtype=torch.float32: torch.empty(tuple(s), dtype=dtype, device=meta)
        W = {n: e(*s, dtype=d) for n, s, d in self.spec}
        pr = Prec("f32")
        ce = e(*self.class_embeds.shape)
        memory, shapes, mf = ref_seg.backbone_pixel(pr, W, e(*bucket, 3), seg)
        dp = ref_seg.Params(W, "segmenter.decoder.")
        enc, score, boxes = ref_seg.proposals(pr, dp, memory, shapes, ce, seg)
        top = ref_seg.top_queries(score, seg["num_queries"])
        ref_seg.decoder_layers(pr, dp, enc[top], boxes[top], memory, shapes, mf, ce, seg)
        M, T = psg["max_objects_padded"], self.text_len
        ref_v4.head(pr, W, mf, e(M, *mf.shape[:2], dtype=torch.bool), e(M, dtype=torch.bool),
                    e(M * M, T, dtype=torch.long), e(M * M, T, dtype=torch.bool), psg,
                    e(psg["top_pairs"], dtype=torch.long))
        return pr.flops + self.llm_flops_per_image()

    def shared_kv_calls(self, bucket):
        """The shared-KV kernel's calls for one image at ``bucket``: one per
        Q-Former layer → [(NP, H, Lq, P, hd)]."""
        psg = self.cfg["psg"]
        qf = psg["qformer"]
        ps = psg["patch_size"]
        P = (bucket[0] // 4 // ps) * (bucket[1] // 4 // ps)
        call = (psg["max_objects_padded"] ** 2, qf["num_heads"], qf["num_relation_queries"] + 1,
                P, qf["hidden_size"] // qf["num_heads"])
        return [call] * qf["num_layers"]

    def decode_shape(self):
        """(rows per image, prefix length, max new tokens)."""
        psg = self.cfg["psg"]
        return (psg["top_pairs"], psg["qformer"]["num_relation_queries"] + self.prompt_len,
                psg["max_new_tokens"])

    def llm_flops_per_image(self) -> float:
        rows, Lp, _ = self.decode_shape()
        trips = int(self.trip_budget or self.cfg["psg"]["max_new_tokens"])
        f = llm_flops.prefill(self.cfg["llm"], rows, Lp)["flops"]
        f += sum(llm_flops.trip(self.cfg["llm"], rows, Lp + t + 1)["flops"] for t in range(trips))
        return f


def mask_shift(system, W) -> float:
    """The amount by which every mask logit is lowered so that the share
    ``init.mask_share`` of the reference's mask logits stays above 0, read on
    the traffic's first image size, prepared by the program's
    ``Preprocessor`` from a seeded image."""
    h, w = system.traffic["mix"][0]["hw"]
    raw = make_images([(h, w)], wgen.sub_seed(system.seed, 9))[0]
    image = system.preprocessor()(raw)["image"]
    with torch.no_grad(), strict_f32():
        masks = system.reference_masks(W, torch.as_tensor(image, device=system.device))
        shift = wgen.upper_tail(masks, system.cfg["init"]["mask_share"])
    del masks
    if system.device.type == "cuda":
        torch.cuda.empty_cache()
    return shift


def _logits(binary, multi):
    """A pair's existence and predicate logits, compared as one tensor (one
    logit alone may sit near 0)."""
    return torch.cat([binary.float()[:, None], multi.float()], 1)


def _acc(r: Dict, k: str, v: float, how) -> None:
    r[k] = v if k not in r else how([r[k], v])


def proposal_gap(q_prog, enc_ref, score_ref, k: int) -> float:
    """The proposal selection's widest gap: each selected query is matched
    to its nearest reference encoder row; → the largest amount by which a
    match scores below the reference's k-th best, or inf where a query has
    no row within 10% of that row's norm.  (Rows the encoder zeroed at the
    border are equal, so several queries may match one of them.)"""
    q = q_prog.float()
    d = torch.cdist(q, enc_ref.float())
    dist, j = d.min(-1)
    resid = dist / enc_ref.float()[j].norm(dim=-1).clamp(min=1e-30)
    if bool((resid > 0.1).any()):
        return float("inf")
    kth = torch.sort(score_ref, descending=True).values[k - 1]
    return float(torch.clamp(kth - score_ref[j], min=0).max())


def served_positions(toks, pad_id: int) -> torch.Tensor:
    """[B, T] bool: the positions whose logits picked a served token, the
    row's first pad (its EOS) included, and none after it."""
    stopped = torch.cumsum((toks == pad_id).long(), 1)
    return (stopped == 0) | ((stopped == 1) & (toks == pad_id))


def served_gaps(ref_logits, toks, pad_id: int, eos_id: int) -> torch.Tensor:
    """By how much each served token's reference logit lies below the
    reference's best, where a token was served: a row's first pad stands for
    the EOS (or pad) picked there, and what follows it was not picked."""
    best = ref_logits.max(-1).values
    stopped = torch.cumsum((toks == pad_id).long(), 1)
    first_pad = (toks == pad_id) & (stopped == 1)
    at = lambda i: ref_logits.gather(-1, i[..., None])[..., 0]
    g = best - at(toks.long())
    g_stop = torch.minimum(best - at(torch.full_like(toks, eos_id).long()),
                           best - at(torch.full_like(toks, pad_id).long()))
    g = torch.where(first_pad, g_stop, g)
    return torch.where(stopped - first_pad.long() > 0, torch.zeros_like(g), g)


def pick_gap(picks, logits_ref, valid) -> float:
    """The pair selection's widest gap: by how much a picked pair's reference
    logit lies below the reference's k-th best among valid pairs (inf where
    an invalid pair is picked while valid ones are left)."""
    scored = torch.where(valid, logits_ref.float(), float("-inf"))
    kth = torch.sort(scored, descending=True).values[picks.numel() - 1]
    got = scored[picks.long()]
    if bool(torch.isinf(kth)):
        # fewer valid pairs than picks: every valid pair must be picked
        return 0.0 if int((got > float("-inf")).sum()) == int(valid.sum()) else float("inf")
    return float(torch.clamp(kth - got, min=0).max())


def fusion_diff(sel, fz) -> Dict[str, int]:
    """Elements in which the program's fusion and object selection differ
    from the reference's on the program's segmenter outputs, by output."""
    object_masks, valid, labels, sel_oid, obj_scores, pan, pass_count = sel
    return {"object_masks": int((object_masks != fz["object_masks"]).sum()),
            "valid": int((valid != fz["valid"]).sum()),
            "labels": int((labels.long() != fz["labels"]).sum()),
            "oid": int((sel_oid.long() != fz["sel_oid"]).sum()),
            "pan": int((pan.long() != fz["pan_seg"]).sum()),
            "pass_count": int(int(pass_count) != fz["pass_count"]),
            "obj_scores": int((~torch.isclose(obj_scores.float(), fz["obj_scores"].float(),
                                              rtol=1e-5, atol=1e-6)).sum())}
