"""PSG v4 per-image inference (counterpart of
``openpsg_tpu/models/detectors/psg_v4.py``):

    image ─ segmenter ─ fusion ─ object select ─ pair instructions
          ─ Q-Former over all pairs ─ top-20 pairs / top-100 triplets
          ─ batched greedy LLM decode ─ postprocess (host)

Weights are seeded random at construction (``seed``); trained or JAX
weights load through :mod:`openpsg_tpu_torch.bridge`.  Class embeddings are
a tensor (``class_embeds``); the language encoder is a later slice.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from openpsg_tpu_torch import resolve_device
from openpsg_tpu_torch.data.vocab import (
    INSTANCE_OFFSET,
    OBJECT_CLASSES,
    RELATION_CLASSES,
)
from openpsg_tpu_torch.models.common import init_params
from openpsg_tpu_torch.models.llm.decode import greedy_decode
from openpsg_tpu_torch.models.llm.llama import LlamaConfig, LlamaWithEmbeddings
from openpsg_tpu_torch.models.relation.head_v4 import (
    HeadV4Config,
    RelationHeadV4,
    assemble_pair_instructions,
    build_instruction_table,
    multiclass_topk_triplets,
    right_align,
    select_topk_pairs,
    topk_stable,
)
from openpsg_tpu_torch.models.relation.qformer import QFormerConfig
from openpsg_tpu_torch.models.relation.tokenizer import build_prompt_tokenizer
from openpsg_tpu_torch.models.segmenter.fusion import panoptic_fusion
from openpsg_tpu_torch.models.segmenter.openseed import (
    OpenSeedSegmenter,
    SegmenterConfig,
    normalize_image,
)
from openpsg_tpu_torch.ops.mask_ops import downsample_nearest

_INT_SENTINEL = np.iinfo(np.int32).max

QFORMER_INSTRUCTION = "Is there a relation between {} and {}?"
LLM_INSTRUCTION = "What are the relations between {} and {}? Assistant: "
MAX_INSTR_LEN = 16
MAX_PROMPT_LEN = 20


@dataclasses.dataclass(frozen=True)
class PSGv4Config:
    segmenter: SegmenterConfig = SegmenterConfig()
    head: HeadV4Config = HeadV4Config()
    llm: LlamaConfig = LlamaConfig()
    max_new_tokens: int = 16
    object_mask_thr: float = 0.25
    iou_thr: float = 0.8
    fusion_candidates: int = 64

    @staticmethod
    def tiny_test(llm_vocab: int = 512) -> "PSGv4Config":
        return PSGv4Config(
            segmenter=SegmenterConfig.tiny_test(),
            head=HeadV4Config.tiny_test(),
            llm=LlamaConfig.tiny_test(vocab_size=llm_vocab),
            max_new_tokens=6,
        )

    @staticmethod
    def baseline_v4_ov() -> "PSGv4Config":
        """``configs/psg/baseline_v4_ov.py`` as the JAX builder resolves it
        (core/builder.py:181-197): Swin-T segmenter and v4 head in bf16,
        plain bf16 Llama-2-7B (no int8), 1344² bucket."""
        bf16 = torch.bfloat16
        return PSGv4Config(
            segmenter=SegmenterConfig(dtype=bf16),
            head=HeadV4Config(qformer=QFormerConfig(dtype=bf16), dtype=bf16),
            llm=LlamaConfig.llama2_7b(),
        )


def select_objects(survive, object_ids, max_objects_padded: int, max_object_num: int):
    """Pick ≤ max_object_num surviving queries, ascending oid, one per oid.
    → (sel [M] query indices, sel_oid [M], valid [M])."""
    M = max_objects_padded
    dev = object_ids.device
    key = torch.where(survive, object_ids.to(torch.int64),
                      torch.full_like(object_ids, _INT_SENTINEL, dtype=torch.int64))
    if key.shape[0] < M:
        key = torch.cat([key, torch.full((M - key.shape[0],), _INT_SENTINEL,
                                         dtype=torch.int64, device=dev)])
    qi = torch.arange(key.shape[0], device=dev)
    dup = ((key[None, :] == key[:, None]) & (qi[None, :] < qi[:, None])).any(dim=1)
    key = torch.where(dup, torch.full_like(key, _INT_SENTINEL), key)
    sel = torch.sort(key, stable=True).indices[:M]
    sel_oid = key[sel]
    valid = (sel_oid != _INT_SENTINEL) & (torch.arange(M, device=dev) < max_object_num)
    sel_oid = torch.where(valid, sel_oid, torch.zeros_like(sel_oid)).to(torch.int32)
    return sel, sel_oid, valid


@contextlib.contextmanager
def _stage(times: Optional[Dict[str, float]], name: str, device: torch.device):
    """Record the stage's wall time in ms (synchronizing the card) when
    ``times`` is a dict; otherwise do nothing."""
    if times is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times[name] = times.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


class PSGv4:
    """Holds the modules, tokenizer tables and the per-image program."""

    def __init__(self, cfg: PSGv4Config, seed: int = 0, device=None):
        """The PSG vocabulary (133 object, 56 relation classes) and its
        word-level prompt tokenizer, shared by the Q-Former and the LLM."""
        self.device = resolve_device(device)
        self.tokenizer = build_prompt_tokenizer(list(OBJECT_CLASSES) + list(RELATION_CLASSES))
        self.qf_parts = build_instruction_table(
            self.tokenizer, OBJECT_CLASSES, QFORMER_INSTRUCTION, MAX_INSTR_LEN)
        self.llm_parts = build_instruction_table(
            self.tokenizer, OBJECT_CLASSES, LLM_INSTRUCTION, MAX_PROMPT_LEN)
        head_cfg = dataclasses.replace(
            cfg.head, llm_feature_size=cfg.llm.dim,
            qformer=dataclasses.replace(
                cfg.head.qformer,
                vocab_size=max(cfg.head.qformer.vocab_size, self.tokenizer.vocab_size),
                max_text_len=self.qf_parts["max_len"],
            ),
        )
        llm_cfg = dataclasses.replace(
            cfg.llm, vocab_size=max(cfg.llm.vocab_size, self.tokenizer.vocab_size))
        self.cfg = dataclasses.replace(cfg, head=head_cfg, llm=llm_cfg)
        c = self.cfg

        gen = torch.Generator(device=self.device).manual_seed(int(seed))

        def build(make, dtype):
            # allocate straight on the device in the working dtype, then fill
            with torch.device("meta"):
                m = make()
            m = m.to(dtype).to_empty(device=self.device).eval()
            m.requires_grad_(False)
            init_params(m, gen)
            return m

        self.segmenter = build(lambda: OpenSeedSegmenter(c.segmenter), c.segmenter.dtype)
        self.head = build(lambda: RelationHeadV4(c.head, c.segmenter.mask_dim),
                          c.head.qformer.dtype)
        self.llm = build(lambda: LlamaWithEmbeddings(c.llm), c.llm.dtype)
        ce = torch.randn(len(OBJECT_CLASSES), c.segmenter.proj_dim,
                         generator=gen, device=self.device)
        self.class_embeds = ce / ce.norm(dim=-1, keepdim=True)

    # ------------------------------------------------------------ stages
    @torch.no_grad()
    def segment(self, image_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Segmenter forward on one [H, W, 3] 0-255 image on the device."""
        return self.segmenter(normalize_image(image_u8), self.class_embeds)

    @torch.no_grad()
    def fuse_select(self, seg_out, img_hw):
        """Fusion at full image resolution over the top-C candidates, object
        selection, stride-4 object masks.  → (object_masks, valid, labels,
        sel_oid, obj_scores, pan_seg, pass_count)."""
        c = self.cfg
        M = c.head.max_objects_padded
        H4, W4 = seg_out["mask_features"].shape[:2]
        H, W = H4 * 4, W4 * 4
        cls_logits, masks_small = seg_out["cls_logits"], seg_out["masks"]
        Qall = cls_logits.shape[0]
        C = int(c.fusion_candidates)
        all_scores = torch.sigmoid(cls_logits.float()).max(dim=-1).values
        pass_count = (all_scores > c.object_mask_thr).sum().to(torch.int32)
        if C and C < Qall:
            cand = torch.sort(topk_stable(all_scores, C)[1]).values
            cls_logits, masks_small = cls_logits[cand], masks_small[cand]
        masks = torch.nn.functional.interpolate(
            masks_small[None], size=(H, W), mode="bilinear", align_corners=False)[0]
        dev = masks.device
        inside = ((torch.arange(H, device=dev)[:, None] < int(img_hw[0]))
                  & (torch.arange(W, device=dev)[None, :] < int(img_hw[1])))
        fusion = panoptic_fusion(
            cls_logits, masks, object_mask_thr=c.object_mask_thr, iou_thr=c.iou_thr,
            region_mask=inside)
        sel, sel_oid, valid = select_objects(
            fusion.survive, fusion.object_ids, M, c.head.max_object_num)
        labels = (sel_oid % INSTANCE_OFFSET).to(torch.int32)
        qs = fusion.query_scores
        if qs.shape[0] < M:
            qs = torch.cat([qs, qs.new_zeros(M - qs.shape[0])])
        obj_scores = qs[sel]
        pan4 = downsample_nearest(fusion.pan_seg, (H4, W4))
        object_masks = (pan4[None] == sel_oid[:, None, None]) & valid[:, None, None]
        return object_masks, valid, labels, sel_oid, obj_scores, fusion.pan_seg, pass_count

    @torch.no_grad()
    def tail_pre(self, mask_features, object_masks, valid, labels, sel_oid,
                 obj_scores, pan_seg, pass_count=None, plain_attention: bool = False):
        """Pair instructions → Q-Former → existence heads → top-K prefix.
        ``plain_attention`` forces the plain cross-attention (tests only).
        → (out dict, prefix [K, R+Lp, D], prefix mask [K, R+Lp])."""
        c = self.cfg
        M = c.head.max_objects_padded
        dev = mask_features.device
        pair_idx = torch.arange(M * M, device=dev)
        sub_lab, obj_lab = labels[pair_idx // M], labels[pair_idx % M]
        text_ids, text_mask = assemble_pair_instructions(self.qf_parts, sub_lab, obj_lab)
        head_out = self.head(mask_features, object_masks, valid, text_ids, text_mask,
                             plain_attention=plain_attention)
        pair_valid = valid[pair_idx // M] & valid[pair_idx % M]
        out = {
            "pan_seg": pan_seg,
            "object_ids": torch.where(valid, sel_oid, torch.full_like(sel_oid, -1)),
            "object_valid": valid,
            "object_scores": obj_scores,
            "object_labels": labels,
        }
        if pass_count is not None:
            out["fusion_pass_count"] = pass_count
        if "binary_logits" in head_out:
            pair_score_logits = head_out["binary_logits"]
        else:
            pair_score_logits = head_out["multiclass_logits"].max(dim=-1).values
        top_idx, top_scores = select_topk_pairs(pair_score_logits, pair_valid, c.head.top_pairs)
        out["top_pair_idx"], out["top_pair_scores"] = top_idx, top_scores
        if "multiclass_logits" in head_out:
            out["mc_triplets"], out["mc_scores"] = multiclass_topk_triplets(
                head_out["multiclass_logits"], pair_valid, M, k=100)

        ti = top_idx.long()
        vis = head_out["llm_visual_tokens"][ti]
        p_ids, p_mask = assemble_pair_instructions(self.llm_parts, sub_lab[ti], obj_lab[ti])
        p_ids, p_mask = right_align(p_ids, p_mask)
        p_emb = self.llm.embed(p_ids)
        prefix = torch.cat([vis.to(p_emb.dtype), p_emb], dim=1)
        pmask = torch.cat([torch.ones(ti.shape[0], vis.shape[1], dtype=torch.bool,
                                      device=dev), p_mask], dim=1)
        return out, prefix, pmask

    def tail_decode(self, prefix, pmask, trip_budget: Optional[int] = None):
        """LLM prefill + greedy decode → (tokens, scores, trips)."""
        return greedy_decode(
            self.llm, prefix, pmask, self.cfg.max_new_tokens,
            eos_id=self.tokenizer.eos_id, pad_id=self.tokenizer.pad_id,
            early_exit=True, trip_budget=trip_budget)

    # ---------------------------------------------------------- entry point
    def infer(self, image_u8, img_hw, trip_budget: Optional[int] = None,
              stage_times: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
        """Host entry: image [H, W, 3] 0-255 (numpy or tensor, the padded
        bucket) and its valid (h, w) → the ``simple_test`` result surface
        (pan_results, rel_results, rel_scores, decode_steps).

        ``trip_budget``: runtime cap on decode steps (None = max_new_tokens).
        ``stage_times``: if a dict, receives per-stage wall ms (segmenter,
        fusion_select, head, decode), synchronizing the card around each."""
        dev = self.device
        image = torch.as_tensor(np.asarray(image_u8) if not torch.is_tensor(image_u8)
                                else image_u8).to(dev)
        with _stage(stage_times, "segmenter", dev):
            seg = self.segment(image)
        with _stage(stage_times, "fusion_select", dev):
            sel = self.fuse_select(seg, img_hw)
        with _stage(stage_times, "head", dev):
            out, prefix, pmask = self.tail_pre(seg["mask_features"], *sel)
        with _stage(stage_times, "decode", dev):
            toks, scores, trips = self.tail_decode(prefix, pmask, trip_budget)
        out["gen_tokens"], out["gen_scores"] = toks, scores
        host = {k: v.cpu().numpy() for k, v in out.items()}
        host["decode_trips"] = np.int32(trips)
        return self.postprocess(host)

    # ---------------------------------------------------------- postprocess
    def postprocess(self, dev: Dict[str, np.ndarray]) -> Dict[str, Any]:
        M = self.cfg.head.max_objects_padded
        valid = dev["object_valid"]
        object_id_list = [int(x) for x in dev["object_ids"][valid]]
        C = int(self.cfg.fusion_candidates)
        if C and "fusion_pass_count" in dev:
            pc = int(dev["fusion_pass_count"])
            if pc > C:
                import warnings

                warnings.warn(
                    f"panoptic fusion saw {pc} threshold-passing queries but "
                    f"fusion_candidates={C}: candidate pre-selection may "
                    "diverge from unrestricted fusion on this image — raise "
                    "fusion_candidates (0 disables the cap)",
                    RuntimeWarning,
                )
        pad_id, eos_id = self.tokenizer.pad_id, self.tokenizer.eos_id
        rel_pred: List[List[int]] = []
        rel_scores: List[float] = []
        rel_set = set()

        def add(sub, obj, text):
            # a glued multi-predicate emission reads 'rel1  rel2'
            for name in text.split("  "):
                name = name.strip()
                if name in RELATION_CLASSES:
                    trip = (sub, obj, RELATION_CLASSES.index(name))
                    if trip not in rel_set:
                        rel_set.add(trip)
                        rel_pred.append(list(trip))
                        rel_scores.append(1.0)

        for k, si in enumerate(dev["top_pair_idx"]):
            if dev["top_pair_scores"][k] <= 0.0:
                continue
            sub, obj = int(si) // M, int(si) % M
            segment: List[int] = []
            for t in dev["gen_tokens"][k]:
                t = int(t)
                if t in (eos_id, pad_id):
                    if segment:
                        add(sub, obj, self.tokenizer.decode(segment).strip())
                        segment = []
                    continue
                segment.append(t)
            if segment:
                add(sub, obj, self.tokenizer.decode(segment).strip())

        if "mc_triplets" in dev:
            for (s, o, r), sc in zip(dev["mc_triplets"], dev["mc_scores"]):
                if sc <= 0:
                    continue
                trip = (int(s), int(o), int(r))
                if trip not in rel_set:
                    rel_set.add(trip)
                    rel_pred.append(list(trip))
                    rel_scores.append(float(sc))

        trips = dev.get("decode_trips")
        decode_steps = int(trips) if trips is not None else int(self.cfg.max_new_tokens)
        return {
            "pan_results": dev["pan_seg"],
            "rel_results": {"object_id_list": object_id_list, "relation": rel_pred},
            "rel_scores": rel_scores,
            "decode_steps": decode_steps,
        }
