"""The closed-set v1 / v2 / v3 relation detectors (counterpart of
``openpsg_tpu/models/detectors/mask2former_relation.py``): the reference's
``Mask2FormerRelation`` (v1), ``Mask2FormerRelationV2`` (v2, with pair and
triplet text features from offline KV stores) and ``OpenSeeDRelation``
(v3, a Llama-trunk head) as one class.

    image ─ Mask2Former segmenter ─ softmax-void fusion (global thing ids)
          ─ object select ─ mask-pooled object tokens + class embedding
          ─ relation head (v1 | v2 | v3) ─ diagonal and pads at -9999, the
            loss type's transform (softmax / sigmoid / exp for v1),
            × subject and object scores ─ top-100 triplets, relation-major

Entry points: :meth:`PSGMask2FormerRelation.infer` (one image),
:meth:`~PSGMask2FormerRelation.infer_gt` (ground-truth masks in place of
fusion), :meth:`~PSGMask2FormerRelation.infer_batch` (a loop over
``infer``).  Weights are seeded random at construction; JAX weights load
through :mod:`openpsg_tpu_torch.bridge`, a Mask2Former trunk through
:meth:`~PSGMask2FormerRelation.load_segmenter_weights`.

The v2 text features are read from the store once at construction: the
[K, K, T] pair matrix, and the triplet store compacted to a [K, K, R]
lookup into a [rows + 1, T] table (the dense [K, K, R, T] matrix would be
about 6 GB at ada-002 width); rows are gathered by class label per image.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from openpsg_tpu_torch import resolve_device
from openpsg_tpu_torch.data.vocab import (
    INSTANCE_OFFSET,
    NUM_THING_CLASSES,
    OBJECT_CLASSES,
    RELATION_CLASSES,
)
from openpsg_tpu_torch.models.common import init_params
from openpsg_tpu_torch.models.detectors.psg_v4 import select_objects
from openpsg_tpu_torch.models.relation.head_v1 import HeadV1Config, RelationHeadV1
from openpsg_tpu_torch.models.relation.head_v2 import HeadV2Config, RelationHeadV2
from openpsg_tpu_torch.models.relation.head_v3 import (
    HeadV3Config,
    RelationHeadV3,
    build_relation_token_layout,
)
from openpsg_tpu_torch.models.relation.head_v4 import topk_stable
from openpsg_tpu_torch.models.relation.tokenizer import build_prompt_tokenizer
from openpsg_tpu_torch.models.segmenter.fusion import panoptic_fusion
from openpsg_tpu_torch.models.segmenter.mask2former import (
    Mask2FormerConfig,
    Mask2FormerSegmenter,
)
from openpsg_tpu_torch.models.segmenter.openseed import normalize_image
from openpsg_tpu_torch.ops.mask_ops import (
    downsample_nearest,
    mask_pool_chunked,
    masks_from_idmap,
)
from openpsg_tpu_torch.parallel.comm import dp_map
from openpsg_tpu_torch.utils.profiling import span

# the config ``model.type`` names this class serves (mmdet's registry names)
DETECTOR_TYPES = ("Mask2FormerRelation", "Mask2FormerRelationV2", "OpenSeeDRelation")
# the parameter groups, as the JAX ``params`` splits them; the reference
# trains the head and the class embeddings (PartCheckpointHook saves them)
TRAINABLE_GROUPS = ("head", "object_cls_embed")
MODULE_GROUPS = ("segmenter", "head")
GROUPS = MODULE_GROUPS + ("object_cls_embed",)
TOP_K = 100


@dataclasses.dataclass(frozen=True)
class M2FRelationConfig:
    segmenter: Mask2FormerConfig = Mask2FormerConfig()
    head_version: str = "v1"            # v1 | v2 | v3
    head_v1: HeadV1Config = HeadV1Config()
    head_v2: HeadV2Config = HeadV2Config()
    head_v3: HeadV3Config = HeadV3Config()
    max_objects: int = 30
    max_objects_padded: int = 32
    merge_cls_type: str = "add"         # cat | add
    # the reference's optional v1 token embellishments (every shipped
    # config disables them)
    embedding_add_cls: bool = True
    use_positional_encoding: bool = False   # mask-pooled sine positional encoding
    use_background_feature: bool = False    # inverse-mask pooled feature added
    # tokens per object on the ground-truth training path (inference pools one)
    object_token_size: int = 1
    object_mask_thr: float = 0.8
    iou_thr: float = 0.8
    input_hw: Optional[Tuple[int, int]] = None

    @staticmethod
    def tiny_test(head_version: str = "v1") -> "M2FRelationConfig":
        return M2FRelationConfig(
            segmenter=Mask2FormerConfig.tiny_test(), head_version=head_version,
            head_v1=HeadV1Config.tiny_test(), head_v2=HeadV2Config.tiny_test(),
            head_v3=HeadV3Config.tiny_test(), max_objects=6, max_objects_padded=8,
            input_hw=(64, 64),
        )


def make_head(cfg: M2FRelationConfig, device=None) -> torch.nn.Module:
    """The relation head module of ``cfg`` (not initialized), on ``device``
    (``"meta"``: shapes only)."""
    d = cfg.segmenter.mask_dim
    token_dim = 2 * d if cfg.merge_cls_type == "cat" else d
    with torch.device(device or "cpu"):
        if cfg.head_version == "v1":
            return RelationHeadV1(cfg.head_v1, token_dim)
        if cfg.head_version == "v2":
            return RelationHeadV2(cfg.head_v2, token_dim, cfg.max_objects_padded)
        if cfg.head_version == "v3":
            return RelationHeadV3(cfg.head_v3, token_dim)
    raise ValueError(cfg.head_version)


class PSGMask2FormerRelation:
    """The segmenter, the relation head and the class-embedding table, and
    the inference programs."""

    def __init__(self, cfg: M2FRelationConfig, seed: int = 0, device=None,
                 class_names: Optional[List[str]] = None,
                 relation_names: Optional[List[str]] = None,
                 num_things: Optional[int] = None, text_kv=None):
        """``class_names`` / ``relation_names``: the vocabulary (default
        PSG's 133 object and 56 relation classes); the first ``num_things``
        classes are things (default 80).  ``text_kv``: a
        :class:`~openpsg_tpu_torch.data.text_kv.TextKVStore` for the v2
        text experts and gate (zeros without one).  Raises ``ValueError``
        on the option combinations the reference cannot run."""
        self.device = resolve_device(device)
        self.class_names = list(class_names or OBJECT_CLASSES)
        self.relation_names = list(relation_names or RELATION_CLASSES)
        self.num_things = num_things if num_things is not None else NUM_THING_CLASSES
        self.text_kv = text_kv
        if (cfg.use_positional_encoding or cfg.use_background_feature) and (
                cfg.embedding_add_cls and cfg.merge_cls_type == "cat"):
            # the reference adds the D-wide vector after the class merge,
            # which 'cat' makes 2D wide (mask2former_relation.py:297-315)
            raise ValueError("positional_encoding/use_background_feature require "
                             "merge_cls_type='add' (or embedding_add_cls=False)")
        if cfg.object_token_size > 1 and cfg.head_version != "v1":
            raise ValueError("object_token_size > 1 is a v1 GT-train surface "
                             "(reference hardcodes 1, mask2former_relation.py:47)")
        if cfg.head_version not in ("v1", "v2", "v3"):
            raise ValueError(cfg.head_version)
        dev = self.device
        h2 = cfg.head_v2
        self.pair_text_matrix = None
        self.triplet_lookup = self.triplet_table = None
        if text_kv is not None and cfg.head_version == "v2":
            if h2.use_moe_gate or {"pair_text2vision", "pair_vision2text"} & set(h2.experts):
                self.pair_text_matrix = torch.from_numpy(
                    text_kv.pair_matrix(self.class_names)).to(dev)          # [K, K, T]
            if h2.use_moe_gate or "triplet_text_w_vision" in h2.experts:
                lut, tab = text_kv.triplet_index(self.class_names, self.relation_names)
                self.triplet_lookup = torch.from_numpy(lut).long().to(dev)   # [K, K, R]
                self.triplet_table = torch.from_numpy(tab).to(dev)           # [rows + 1, T]

        self.sem_token_ids = self.sem_token_mask = None
        if cfg.head_version == "v1" and cfg.head_v1.use_relation_prompts:
            # predicate descriptions → tokens once; the head's sem_encoder
            # encodes them every forward
            from openpsg_tpu_torch.data.predicate_descriptions import get_descriptions
            from openpsg_tpu_torch.models.relation.tokenizer import WordTokenizer

            texts = get_descriptions(cfg.head_v1.semantic_type, self.relation_names)
            sem_tok = WordTokenizer(texts)
            ids, msk = sem_tok.encode_batch(texts, max_len=cfg.head_v1.encoder.max_len)
            self.sem_token_ids = torch.from_numpy(ids).to(dev)
            self.sem_token_mask = torch.from_numpy(msk).to(dev)
            enc = dataclasses.replace(cfg.head_v1.encoder, vocab_size=max(
                cfg.head_v1.encoder.vocab_size, sem_tok.vocab_size))
            cfg = dataclasses.replace(cfg, head_v1=dataclasses.replace(cfg.head_v1, encoder=enc))
        if cfg.head_version == "v3":
            self.tokenizer = build_prompt_tokenizer()
            ids, spans = build_relation_token_layout(self.tokenizer, self.relation_names)
            self.rel_token_ids = torch.from_numpy(ids).to(dev)
            self.rel_spans = torch.from_numpy(spans).to(dev)
        cfg = dataclasses.replace(cfg, segmenter=dataclasses.replace(
            cfg.segmenter, num_classes=len(self.class_names)))
        self.cfg = c = cfg

        gen = torch.Generator(device=dev).manual_seed(int(seed))

        def build(make, dtype):
            # allocate straight on the device in the working dtype, then fill
            with torch.device("meta"):
                m = make()
            m = m.to(dtype).to_empty(device=dev).eval()
            m.requires_grad_(False)
            init_params(m, gen)
            return m

        self.segmenter = build(lambda: Mask2FormerSegmenter(c.segmenter), c.segmenter.dtype)
        self.head = build(lambda: make_head(c, "meta"), self.head_dtype)
        self.object_cls_embed = torch.randn(
            len(self.class_names), c.segmenter.mask_dim, generator=gen, device=dev) * 0.02

    @property
    def head_dtype(self) -> torch.dtype:
        return getattr(self.cfg, f"head_{self.cfg.head_version}").dtype

    def _model_hw(self) -> Tuple[int, int]:
        return tuple(self.cfg.input_hw) if self.cfg.input_hw else (1344, 1344)

    def param_groups(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{group: {parameter name: tensor}} over :data:`GROUPS`."""
        groups = {g: dict(getattr(self, g).named_parameters()) for g in MODULE_GROUPS}
        groups["object_cls_embed"] = {"object_cls_embed": self.object_cls_embed}
        return groups

    @torch.no_grad()
    def load_segmenter_weights(self, path: str) -> None:
        """Load a Mask2Former trunk into the segmenter (the reference's
        ``load_from``, configs/psg/baseline_r50.py:3), each tensor cast to
        the module's dtype: a raw mmdet checkpoint (``backbone.*`` and
        ``panoptic_head.*`` keys, or those under ``"state_dict"``),
        converted on the fly; the ``segmenter.pt`` the
        ``convert_mask2former`` tool writes (the port's parameter names); or
        the ``segmenter.msgpack`` the JAX package's
        ``tools/convert_mask2former.py`` writes (a flax ``{"params": ...}``
        tree, read without JAX)."""
        from openpsg_tpu_torch.bridge import load_part, scan_prefixes
        from openpsg_tpu_torch.models.llm.weight_convert import to_numpy
        from openpsg_tpu_torch.models.segmenter.weight_convert import (
            convert_mask2former,
            load_checkpoint,
        )

        scanned = scan_prefixes(self.segmenter, "segmenter")
        if path.endswith(".msgpack"):
            from openpsg_tpu_torch.utils.jax_files import read_flax_msgpack

            load_part(self.segmenter, "segmenter", read_flax_msgpack(path), scanned=scanned)
            return
        state = load_checkpoint(path)
        if isinstance(state, dict) and isinstance(state.get("state_dict"), dict):
            state = state["state_dict"]
        if not any(k.startswith("panoptic_head.") for k in state):
            self.segmenter.load_state_dict(state, strict=True)
            return
        state = {k: to_numpy(v) for k, v in state.items() if hasattr(v, "shape")}
        params = convert_mask2former(state, self.cfg.segmenter)
        load_part(self.segmenter, "segmenter", {"params": params}, scanned=scanned)

    # ------------------------------------------------------------ stages
    @torch.no_grad()
    def segment(self, image_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Segmenter forward on one [H, W, 3] 0-255 image on the device."""
        return self.segmenter(normalize_image(image_u8))

    @torch.no_grad()
    def fuse_select(self, seg_out, hw, img_hw):
        """The query masks upsampled to the bucket ``hw`` (bilinear), fused
        with a softmax over the classes and void and global thing ids;
        object selection; the stride-4 object masks.  → (object_masks,
        sel_oid, valid, labels, obj_scores, pan_seg)."""
        c = self.cfg
        M = c.max_objects_padded
        H, W = hw
        masks = F.interpolate(seg_out["masks"][None], size=(H, W), mode="bilinear",
                              align_corners=False)[0]
        dev = masks.device
        inside = ((torch.arange(H, device=dev)[:, None] < int(img_hw[0]))
                  & (torch.arange(W, device=dev)[None, :] < int(img_hw[1])))
        fusion = panoptic_fusion(
            seg_out["cls_logits"], masks, cls_mode="softmax_void",
            object_mask_thr=c.object_mask_thr, iou_thr=c.iou_thr, instance_mode="global",
            num_things=self.num_things, region_mask=inside)
        del masks
        sel, sel_oid, valid = select_objects(fusion.survive, fusion.object_ids, M,
                                             c.max_objects)
        labels = (sel_oid % INSTANCE_OFFSET).to(torch.int32)
        qs = fusion.query_scores
        if qs.shape[0] < M:   # the JAX take fills NaN past Q (never selected)
            qs = torch.cat([qs, qs.new_zeros(M - qs.shape[0])])
        obj_scores = torch.where(valid, qs[sel], torch.zeros_like(qs[sel]))
        mf = seg_out["mask_features"]
        pan4 = downsample_nearest(fusion.pan_seg, mf.shape[:2])
        object_masks = masks_from_idmap(pan4, sel_oid) & valid[:, None, None]
        return object_masks, sel_oid, valid, labels, obj_scores, fusion.pan_seg

    def object_tokens(self, mf, obj_masks, labels, chunked: bool = False):
        """The reference's object token assembly (``_get_input``,
        mask2former_relation.py:250-316, and the ground-truth training
        path's ``_thing/_stuff_embedding``, :111-199): mask pooling on the
        stride-4 grid (``object_token_size`` chunks per object when
        ``chunked``), the class embedding added or concatenated, and the
        optional pooled sine positional encoding and inverse-mask
        background feature.  → [M·S, token_dim], object-major."""
        c = self.cfg
        feat = mf.permute(2, 0, 1)                            # [D, H4, W4]
        S = c.object_token_size if chunked else 1
        pooled = mask_pool_chunked(feat, obj_masks, S)        # [M, S, D]
        cls_emb = self.object_cls_embed[labels.long()][:, None, :]
        if not c.embedding_add_cls:
            tokens = pooled
        elif c.merge_cls_type == "cat":
            tokens = torch.cat([pooled.float(), cls_emb.expand(pooled.shape)], dim=-1)
        else:
            tokens = pooled + cls_emb
        if c.use_positional_encoding:
            from openpsg_tpu_torch.models.segmenter.deform_layers import (
                make_cumsum_points,
                sine_pos_embed,
            )

            H4, W4 = mf.shape[:2]
            coords = torch.from_numpy(np.asarray(make_cumsum_points([(H4, W4)]))).to(mf.device)
            pe = sine_pos_embed(coords, mf.shape[-1]).reshape(H4, W4, -1).to(mf.dtype)
            tokens = tokens + mask_pool_chunked(pe.permute(2, 0, 1), obj_masks, S)
        if c.use_background_feature:
            inv = 1.0 - obj_masks.to(mf.dtype)
            tokens = tokens + mask_pool_chunked(feat, inv, S)
        return tokens.reshape(obj_masks.shape[0] * S, -1)

    def _zero_extra(self, M):
        c = self.cfg
        extra = {}
        if c.head_version == "v2":
            h2 = c.head_v2
            T = h2.text_embedding_size
            z = lambda *s: torch.zeros(s, dtype=torch.float32, device=self.device)
            if h2.use_moe_gate or {"pair_text2vision", "pair_vision2text"} & set(h2.experts):
                extra["pair_text"] = z(1, M, M, T)
            if "triplet_text_w_vision" in h2.experts:
                extra["triplet_text"] = z(1, M, M, h2.num_relation_classes, T)
            elif h2.use_moe_gate:
                extra["triplet_text"] = z(1, M, M, T)
        return extra

    def _head_apply(self, tokens, valid, extra):
        c = self.cfg
        tokens = tokens.to(self.head_dtype)[None]
        if c.head_version == "v1":
            return self.head(tokens, valid[None], semantic_token_ids=self.sem_token_ids,
                             semantic_token_mask=self.sem_token_mask)[0]
        if c.head_version == "v2":
            cast = lambda t: None if t is None else t.to(self.head_dtype)
            out = self.head(tokens, valid[None], pair_text_embeds=cast(extra.get("pair_text")),
                            triplet_text_embeds=cast(extra.get("triplet_text")))
            # inference: the last enabled expert, the gate over all
            return RelationHeadV2.primary(out)[0]
        return self.head(tokens, valid[None], relation_token_ids=self.rel_token_ids,
                         relation_spans=self.rel_spans)[0]

    def _loss_type(self) -> str:
        return self.cfg.head_v1.loss_type if self.cfg.head_version == "v1" else "v1"

    @torch.no_grad()
    def triplet_probs(self, mf, obj_masks, valid, labels, obj_scores):
        """Object tokens → head → every triplet's score [R', M, M]: the
        diagonal and the pads at -9999, the loss type's transform, times
        the subject's and the object's scores, 0 off the valid pairs."""
        c = self.cfg
        M = c.max_objects_padded
        tokens = self.object_tokens(mf, obj_masks, labels)
        extra = self._zero_extra(M)
        lab = labels.long()
        if self.pair_text_matrix is not None:
            extra["pair_text"] = self.pair_text_matrix[lab[:, None], lab[None, :]][None]
        if self.triplet_lookup is not None:
            idx = self.triplet_lookup[lab[:, None], lab[None, :]]          # [M, M, R]
            extra["triplet_text"] = self.triplet_table[idx][None]          # [1, M, M, R, T]
        scores = self._head_apply(tokens, valid, extra).float()           # [R, M, M]
        R = scores.shape[0]
        eye = torch.eye(M, dtype=torch.bool, device=scores.device)
        pair_ok = valid[:, None] & valid[None, :] & ~eye
        scores = torch.where(pair_ok[None], scores, torch.full_like(scores, -9999.0))
        loss_type = self._loss_type()
        if loss_type == "v0_softmax":
            probs = torch.softmax(scores, dim=0)[: R - 1]
        elif loss_type == "v0_sigmoid":
            probs = torch.sigmoid(scores)
        else:   # the v1 family: exp, not sigmoid (reference :477-478)
            probs = torch.exp(scores)
        probs = probs * obj_scores[None, :, None] * obj_scores[None, None, :]
        return torch.where(pair_ok[None], probs, torch.zeros_like(probs))

    @torch.no_grad()
    def relation_tail(self, mf, obj_masks, sel_oid, valid, labels, obj_scores, pan_seg):
        """:meth:`triplet_probs` → the top 100 (relation-major flattening,
        ties to the lower index).  → dict of device tensors."""
        M = self.cfg.max_objects_padded
        probs = self.triplet_probs(mf, obj_masks, valid, labels, obj_scores)
        top_scores, top_idx = topk_stable(probs.reshape(-1), TOP_K)
        rel, rem = top_idx // (M * M), top_idx % (M * M)
        triplets = torch.stack([rem // M, rem % M, rel], dim=1).to(torch.int32)
        return {
            "pan_seg": pan_seg,
            "object_ids": torch.where(valid, sel_oid, torch.full_like(sel_oid, -1)),
            "object_valid": valid,
            "object_scores": obj_scores,
            "triplets": triplets,
            "triplet_scores": top_scores,
        }

    # --------------------------------------------------------- entry points
    def infer(self, image_u8, img_hw,
              stage_times: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
        """Host entry: image [H, W, 3] 0-255 (numpy or tensor, the padded
        bucket) and its valid (h, w) → pan_results, rel_results,
        rel_scores.  ``stage_times``: if a dict, receives per-stage wall ms
        (segmenter, fusion_select, head), synchronizing the card around
        each.  The call is the span ``psg.infer``, each stage a span inside
        it (:func:`span`)."""
        dev = self.device
        with span("infer"):
            image = torch.as_tensor(image_u8, device=dev)
            with span("segmenter", stage_times, dev):
                seg = self.segment(image)
            with span("fusion_select", stage_times, dev):
                sel = self.fuse_select(seg, image.shape[:2], img_hw)
            with span("head", stage_times, dev):
                out = self.relation_tail(seg["mask_features"], *sel)
            return self.postprocess({k: v.cpu().numpy() for k, v in out.items()})

    def infer_gt(self, image_u8, gt_masks, gt_oids, gt_valid) -> Dict[str, Any]:
        """Ground-truth-mask ablation (``_infer_gt_jit``): the segmenter runs
        for its ``mask_features``; the GT masks [M, H, W] (the bucket's
        resolution), ids [M] and validity [M] replace fusion and selection
        (:meth:`gt_select`)."""
        seg = self.segment(torch.as_tensor(image_u8, device=self.device))
        out = self.relation_tail(seg["mask_features"],
                                 *self.gt_select(seg, gt_masks, gt_oids, gt_valid))
        return self.postprocess({k: v.cpu().numpy() for k, v in out.items()})

    @torch.no_grad()
    def gt_select(self, seg_out, gt_masks, gt_oids, gt_valid):
        """Ground-truth objects in :meth:`fuse_select`'s place: the masks at
        stride 4 (nearest), the ids, labels and validity, scores of 1, and
        the pan map painting each pixel with the first valid mask covering
        it, 133 where none does."""
        dev = self.device
        masks = torch.as_tensor(gt_masks, device=dev).bool()
        oids = torch.as_tensor(gt_oids, device=dev).to(torch.int32)
        valid = torch.as_tensor(gt_valid, device=dev).bool()
        masks4 = downsample_nearest(masks, seg_out["mask_features"].shape[:2])
        owned = masks & valid[:, None, None]
        first = torch.argmax(owned.to(torch.uint8), dim=0)
        pan = torch.where(owned.any(dim=0), oids[first], torch.full_like(oids[first], 133))
        labels = (oids % INSTANCE_OFFSET).to(torch.int32)
        return (masks4 & valid[:, None, None], torch.where(valid, oids, torch.zeros_like(oids)),
                valid, labels, valid.float(), pan)

    def infer_batch(self, images, img_hws, mesh=None) -> List[Dict[str, Any]]:
        """Per-image :meth:`infer` over a batch, in image order (the JAX
        package vmaps the per-image program, whose results equal per-image
        inference).  ``mesh``: data parallel over its ``dp`` ranks, each
        running its contiguous block of the images (JAX
        mask2former_relation.py:571-605); every rank gets all results."""
        return dp_map(lambda i: self.infer(images[i], img_hws[i]), len(images), mesh)

    def postprocess(self, dev: Dict[str, np.ndarray]) -> Dict[str, Any]:
        valid = dev["object_valid"]
        object_id_list = [int(x) for x in dev["object_ids"][valid]]
        rel, scores = [], []
        for (s, o, r), sc in zip(dev["triplets"], dev["triplet_scores"]):
            if sc <= 0:
                continue
            rel.append([int(s), int(o), int(r)])
            scores.append(float(sc))
        return {
            "pan_results": dev["pan_seg"],
            "rel_results": {"object_id_list": object_id_list, "relation": rel},
            "rel_scores": scores,
        }
