"""PSG v4 inference (counterpart of
``openpsg_tpu/models/detectors/psg_v4.py``):

    image ─ segmenter ─ fusion ─ object select ─ pair instructions
          ─ Q-Former over all pairs ─ top-20 pairs / top-100 triplets
          ─ batched greedy LLM decode ─ postprocess (host)

Entry points: :meth:`PSGv4.infer` (one image), :meth:`PSGv4.infer_microbatch`
(the deployment program: everything up to the LLM one image at a time, then
one prefill and decode over all images' pairs), :meth:`PSGv4.infer_batch`
(data parallel over a mesh's ``dp`` ranks), :meth:`PSGv4.make_pair_sharded_infer`
(one image, its pairs split over the ranks) and :meth:`PSGv4.infer_gt`
(ground-truth masks in place of fusion).

The LLM is a Llama or a DeepSeek-V3 decoder, built by the type of
``PSGv4Config.llm``.  Weights are seeded random at construction
(``seed``); with ``llm.quant`` (Llama only) the seeded dense LLM is
quantized by :func:`quantize_llama`.
Trained or JAX weights load through :mod:`openpsg_tpu_torch.bridge`.  The
class embeddings (``class_embeds``) are the language encoder's output for
the class names, or a precomputed ``.npy`` matrix.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from openpsg_tpu_torch import resolve_device
from openpsg_tpu_torch.parallel.comm import all_gather, dp_map
from openpsg_tpu_torch.parallel.mesh import axis_group
from openpsg_tpu_torch.parallel.sharding import pair_sharded_range
from openpsg_tpu_torch.data.vocab import (
    INSTANCE_OFFSET,
    NUM_THING_CLASSES,
    OBJECT_CLASSES,
    RELATION_CLASSES,
)
from openpsg_tpu_torch.models.common import init_params
from openpsg_tpu_torch.models.llm.decode import greedy_decode
from openpsg_tpu_torch.models.llm.deepseek_v3 import DeepseekV3Config, DeepseekV3WithEmbeddings
from openpsg_tpu_torch.models.llm.llama import (
    LlamaConfig,
    LlamaWithEmbeddings,
    quantize_llama,
    require_llama,
)
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
from openpsg_tpu_torch.models.segmenter.language import TextEncoder, encode_names
from openpsg_tpu_torch.models.segmenter.openseed import (
    OpenSeedSegmenter,
    SegmenterConfig,
    normalize_image,
)
from openpsg_tpu_torch.ops.mask_ops import downsample_nearest
from openpsg_tpu_torch.utils.profiling import span

_INT_SENTINEL = np.iinfo(np.int32).max

QFORMER_INSTRUCTION = "Is there a relation between {} and {}?"
LLM_INSTRUCTION = "What are the relations between {} and {}? Assistant: "
MAX_INSTR_LEN = 16
MAX_PROMPT_LEN = 20

# Auto micro-batch selection in tools/infer.py (the JAX package's values,
# psg_v4.py:72-81): the micro-batch size, the median realized decode length
# at which the controller switches to it, the window of images that median
# is taken over, and the margin below the threshold for switching back.
AUTO_MB_DECODE_STEPS = 10
AUTO_MB_SIZE = 4
AUTO_MB_CALIB_K = 4
AUTO_MB_HYSTERESIS = 2

# the top-level parameter groups, as the JAX ``PSGv4.params`` splits them
# (psg_v4.py:282-288): four modules and the class-embedding matrix
MODULE_GROUPS = ("segmenter", "head", "llm", "text")
GROUPS = MODULE_GROUPS + ("class_embeds",)


@dataclasses.dataclass(frozen=True)
class PSGv4Config:
    segmenter: SegmenterConfig = SegmenterConfig()
    head: HeadV4Config = HeadV4Config()
    # the LLM is built by its config's type: a Llama or a DeepSeek-V3 decoder
    llm: Union[LlamaConfig, DeepseekV3Config] = LlamaConfig()
    max_new_tokens: int = 16
    # stop decoding once every sequence hit EOS (False: always
    # max_new_tokens trips)
    decode_early_exit: bool = True
    object_mask_thr: float = 0.25
    iou_thr: float = 0.8
    input_hw: Optional[Tuple[int, int]] = None  # model bucket override
    # 1: fuse at full image resolution; s > 1: fuse on the stride-s grid and
    # upsample the id map nearest
    fusion_stride: int = 1
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

    @staticmethod
    def baseline_v4_ov_w8a8() -> "PSGv4Config":
        """The deployment program's model: :meth:`baseline_v4_ov` with int8
        Llama-2-7B weights (``quant``), int8-activation prefill
        (``act_int8``) and encoder sample points (2, 2, 2, 4) per level —
        what bench.py:176-238 runs by default and core/builder.py:68-77,
        152-158 builds from ``tpu.llm_int8 / act_int8 /
        enc_points_per_level``."""
        c = PSGv4Config.baseline_v4_ov()
        return dataclasses.replace(
            c,
            segmenter=dataclasses.replace(c.segmenter, enc_points_per_level=(2, 2, 2, 4)),
            llm=dataclasses.replace(c.llm, quant=True, act_int8=True),
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


def resolve_vocabulary(cfg: PSGv4Config, class_names: List[str], relation_names: List[str],
                       tokenizer=None, qformer_tokenizer=None):
    """The tokenizers (default one word-level prompt tokenizer over the
    vocabulary for both), their instruction tables, and ``cfg`` with the
    widths they set: the Q-Former's vocabulary and text length, the LLM's
    vocabulary, the head's projection width.  → (cfg, tokenizer,
    qformer tokenizer, Q-Former instruction table, LLM instruction table)."""
    tokenizer = tokenizer or build_prompt_tokenizer(list(class_names) + list(relation_names))
    qf_tokenizer = qformer_tokenizer or tokenizer
    qf_parts = build_instruction_table(qf_tokenizer, class_names, QFORMER_INSTRUCTION,
                                       MAX_INSTR_LEN)
    llm_parts = build_instruction_table(tokenizer, class_names, LLM_INSTRUCTION, MAX_PROMPT_LEN)
    head_cfg = dataclasses.replace(
        cfg.head, llm_feature_size=cfg.llm.dim,
        qformer=dataclasses.replace(
            cfg.head.qformer,
            vocab_size=max(cfg.head.qformer.vocab_size, qf_tokenizer.vocab_size),
            max_text_len=qf_parts["max_len"],
        ),
    )
    llm_cfg = dataclasses.replace(cfg.llm, vocab_size=max(cfg.llm.vocab_size,
                                                          tokenizer.vocab_size))
    cfg = dataclasses.replace(cfg, head=head_cfg, llm=llm_cfg)
    return cfg, tokenizer, qf_tokenizer, qf_parts, llm_parts


class PSGv4:
    """Holds the modules, tokenizer tables and the inference programs."""

    def __init__(self, cfg: PSGv4Config, seed: int = 0, device=None,
                 class_names: Optional[List[str]] = None,
                 relation_names: Optional[List[str]] = None,
                 num_things: Optional[int] = None,
                 precomputed_class_embeds: Optional[str] = None,
                 tokenizer=None, qformer_tokenizer=None):
        """``class_names`` / ``relation_names``: the vocabulary (default the
        PSG one, 133 object and 56 relation classes); the first
        ``num_things`` classes are things (default 80 for the PSG
        vocabulary, all of a custom one).
        ``precomputed_class_embeds``: an ``.npy`` [classes, proj_dim] used as
        the class embeddings as it is, in place of the language encoder's.
        ``tokenizer`` / ``qformer_tokenizer``: anything with the
        WordTokenizer interface (``vocab_size``, pad/bos/eos ids,
        ``encode``, ``decode``), e.g. a SentencePiece ``.model``
        (:mod:`~openpsg_tpu_torch.models.relation.sp_tokenizer`) or an HF
        tokenizer (:mod:`~openpsg_tpu_torch.models.relation.hf_tokenizer`);
        default one word-level prompt tokenizer over the vocabulary for
        both.  Instruction widths, vocabulary sizes and the decode's EOS and
        pad ids follow them; the LLM ``tokenizer`` drives prompts, labels
        and the postprocess decode."""
        self.device = resolve_device(device)
        self.class_names = list(class_names or OBJECT_CLASSES)
        self.relation_names = list(relation_names or RELATION_CLASSES)
        if num_things is not None:
            self.num_things = num_things
        else:
            self.num_things = NUM_THING_CLASSES if class_names is None else len(self.class_names)
        (self.cfg, self.tokenizer, self.qf_tokenizer, self.qf_parts,
         self.llm_parts) = resolve_vocabulary(cfg, self.class_names, self.relation_names,
                                              tokenizer, qformer_tokenizer)
        # each predicate's token ids under the LLM tokenizer
        self.relation_token_ids = [self.tokenizer.encode(r) for r in self.relation_names]
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
        if c.llm.quant:
            require_llama(c.llm, "an int8 LLM (llm.quant, quantize_llama)")
        if isinstance(c.llm, DeepseekV3Config):
            self.llm = build(lambda: DeepseekV3WithEmbeddings(c.llm), c.llm.dtype)
        else:
            dense = dataclasses.replace(c.llm, quant=False, act_int8=False)
            self.llm = build(lambda: LlamaWithEmbeddings(dense), c.llm.dtype)
        if c.llm.quant:
            state = quantize_llama(self.llm.state_dict())
            with torch.device("meta"):
                self.llm = LlamaWithEmbeddings(c.llm)
            self.llm.load_state_dict(state, assign=True)
            self.llm.eval().requires_grad_(False)
            del state
        self.text = build(lambda: TextEncoder(dim=c.segmenter.proj_dim), torch.float32)
        if precomputed_class_embeds:
            ce = torch.from_numpy(np.load(precomputed_class_embeds)).float()
            self.class_embeds = ce.to(self.device)
        else:
            with torch.no_grad():
                self.class_embeds = self.text(torch.from_numpy(
                    encode_names(self.class_names)).to(self.device))

    @torch.no_grad()
    def load_segmenter_weights(self, path: str) -> None:
        """Load an OpenSeeD trunk into the segmenter (the reference loads
        the published ``model_state_dict_swint_51.2ap.pt``,
        openseed_relation_v2.py:37-41), each tensor cast to the module's
        dtype.  ``path`` is a raw reference checkpoint (``backbone.*`` and
        ``sem_seg_head.*`` keys, or those under ``"model"``), converted on
        the fly with the conversion report printed; the ``segmenter.pt``
        the ``convert_openseed`` tool writes (the port's own parameter
        names); or the ``segmenter.msgpack`` the JAX package's
        ``tools/convert_openseed.py`` writes (a flax ``{"params": ...}``
        tree, read without JAX)."""
        from openpsg_tpu_torch.bridge import load_part
        from openpsg_tpu_torch.models.llm.weight_convert import to_numpy
        from openpsg_tpu_torch.models.segmenter.weight_convert import (
            conversion_report,
            convert_openseed,
            load_checkpoint,
        )

        if path.endswith(".msgpack"):
            from openpsg_tpu_torch.utils.jax_files import read_flax_msgpack

            load_part(self.segmenter, "segmenter", read_flax_msgpack(path))
            return
        state = load_checkpoint(path)
        if not any(k.startswith("sem_seg_head.") for k in state):
            self.segmenter.load_state_dict(state, strict=True)
            return
        state = {k: to_numpy(v) for k, v in state.items()}
        params, _ = convert_openseed(state, self.cfg.segmenter)
        print(conversion_report(params, self.cfg.segmenter, state))
        load_part(self.segmenter, "segmenter", {"params": params})

    def param_groups(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{group: {parameter name: tensor}} over :data:`GROUPS`: each
        module's named parameters, and ``class_embeds`` as its one tensor.
        The trainer optimizes and the checkpoint saves whole groups."""
        groups = {g: dict(getattr(self, g).named_parameters()) for g in MODULE_GROUPS}
        groups["class_embeds"] = {"class_embeds": self.class_embeds}
        return groups

    def _model_hw(self) -> Tuple[int, int]:
        """The model's input bucket: ``input_hw``, else 64² for the tiny
        segmenter and 1344² (the 1333 test scale padded to ÷32) otherwise."""
        if self.cfg.input_hw is not None:
            return tuple(self.cfg.input_hw)
        return (64, 64) if self.cfg.segmenter.embed_dim <= 32 else (1344, 1344)

    # ------------------------------------------------------------ stages
    @torch.no_grad()
    def segment(self, image_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Segmenter forward on one [H, W, 3] 0-255 image on the device."""
        return self.segmenter(normalize_image(image_u8), self.class_embeds)

    @torch.no_grad()
    def fuse_select(self, seg_out, img_hw):
        """Fusion over the top-C candidates on the stride-``fusion_stride``
        grid, object selection, stride-4 object masks.  → (object_masks,
        valid, labels, sel_oid, obj_scores, pan_seg at the image's
        resolution, pass_count)."""
        c = self.cfg
        M = c.head.max_objects_padded
        H4, W4 = seg_out["mask_features"].shape[:2]
        H, W = H4 * 4, W4 * 4
        s = max(int(c.fusion_stride), 1)
        Hf, Wf = H // s, W // s
        cls_logits, masks_small = seg_out["cls_logits"], seg_out["masks"]
        Qall = cls_logits.shape[0]
        C = int(c.fusion_candidates)
        all_scores = torch.sigmoid(cls_logits.float()).max(dim=-1).values
        pass_count = (all_scores > c.object_mask_thr).sum().to(torch.int32)
        if C and C < Qall:
            cand = torch.sort(topk_stable(all_scores, C)[1]).values
            cls_logits, masks_small = cls_logits[cand], masks_small[cand]
        # jax.image.resize: plain bilinear up to the stride-4 grid; past it
        # (stride > 4) a shrink, which it antialiases with the triangle
        # kernel widened by the factor, as torch's antialias does
        masks = torch.nn.functional.interpolate(
            masks_small[None], size=(Hf, Wf), mode="bilinear", align_corners=False,
            antialias=Hf < H4 or Wf < W4)[0]
        dev = masks.device
        inside = ((torch.arange(Hf, device=dev)[:, None] * s < int(img_hw[0]))
                  & (torch.arange(Wf, device=dev)[None, :] * s < int(img_hw[1])))
        fusion = panoptic_fusion(
            cls_logits, masks, object_mask_thr=c.object_mask_thr, iou_thr=c.iou_thr,
            num_things=self.num_things, region_mask=inside)
        sel, sel_oid, valid = select_objects(
            fusion.survive, fusion.object_ids, M, c.head.max_object_num)
        labels = (sel_oid % INSTANCE_OFFSET).to(torch.int32)
        qs = fusion.query_scores
        if qs.shape[0] < M:
            qs = torch.cat([qs, qs.new_zeros(M - qs.shape[0])])
        obj_scores = qs[sel]
        pan4 = downsample_nearest(fusion.pan_seg, (H4, W4))
        object_masks = (pan4[None] == sel_oid[:, None, None]) & valid[:, None, None]
        pan_seg = downsample_nearest(fusion.pan_seg, (H, W))  # nearest upsample for s > 1
        return object_masks, valid, labels, sel_oid, obj_scores, pan_seg, pass_count

    @torch.no_grad()
    def tail_pre(self, mask_features, object_masks, valid, labels, sel_oid,
                 obj_scores, pan_seg, pass_count=None, plain_attention: bool = False,
                 pair_shard=None):
        """Pair instructions → Q-Former → existence heads → top-K prefix.
        ``plain_attention`` forces the plain cross-attention (tests only).
        ``pair_shard`` ``(lo, hi, group)``: the Q-Former runs on pairs
        ``[lo, hi)`` only and the head outputs are all-gathered over
        ``group`` back to every pair.
        → (out dict, prefix [K, R+Lp, D], prefix mask [K, R+Lp])."""
        c = self.cfg
        M = c.head.max_objects_padded
        dev = mask_features.device
        pair_idx = torch.arange(M * M, device=dev)
        sub_lab, obj_lab = labels[pair_idx // M], labels[pair_idx % M]
        text_ids, text_mask = assemble_pair_instructions(self.qf_parts, sub_lab, obj_lab)
        if pair_shard is None:
            head_out = self.head(mask_features, object_masks, valid, text_ids, text_mask,
                                 plain_attention=plain_attention)
        else:
            lo, hi, group = pair_shard
            part = self.head(mask_features, object_masks, valid, text_ids, text_mask,
                             pair_select=torch.arange(lo, hi, device=dev),
                             plain_attention=plain_attention)
            head_out = {k: all_gather(part[k].contiguous(), 0, group) for k in
                        ("binary_logits", "multiclass_logits", "llm_visual_tokens")
                        if k in part}
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
            early_exit=self.cfg.decode_early_exit, trip_budget=trip_budget)

    # --------------------------------------------------------- entry points
    def infer(self, image_u8, img_hw, trip_budget: Optional[int] = None,
              stage_times: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
        """Host entry: image [H, W, 3] 0-255 (numpy or tensor, the padded
        bucket) and its valid (h, w) → the ``simple_test`` result surface
        (pan_results, rel_results, rel_scores, decode_steps).

        ``trip_budget``: runtime cap on decode steps (None = max_new_tokens).
        ``stage_times``: if a dict, receives per-stage wall ms (segmenter,
        fusion_select, head, decode), synchronizing the card around each."""
        return self.infer_microbatch([image_u8], [img_hw], trip_budget, stage_times)[0]

    def infer_microbatch(self, images, img_hws, trip_budget: Optional[int] = None,
                         stage_times: Optional[Dict[str, float]] = None) -> List[Dict[str, Any]]:
        """The deployment program (``_pipelined_impl``, psg_v4.py:707-729):
        images [N, H, W, 3] and their valid (h, w) [N, 2] → one result dict
        per image, as :meth:`infer` gives.

        Segmenter, fusion/selection and the relation head run one image at a
        time, so peak activation memory stays at one image's; the N images'
        top-K prefixes then go through ONE prefill and greedy decode as a
        flat [N·K] batch, which exits early only when all N·K sequences hit
        EOS.  Every image's ``decode_steps`` is that joint trip count.
        ``stage_times`` sums each stage over the images.  The call is the
        span ``psg.infer``, each stage a span inside it (:func:`span`)."""
        dev = self.device
        with span("infer"):
            pre = []
            for image_u8, img_hw in zip(images, img_hws):
                image = torch.as_tensor(image_u8, device=dev)
                with span("segmenter", stage_times, dev):
                    seg = self.segment(image)
                with span("fusion_select", stage_times, dev):
                    sel = self.fuse_select(seg, img_hw)
                with span("head", stage_times, dev):
                    pre.append(self.tail_pre(seg["mask_features"], *sel))
                del seg, sel
            return self._decode_postprocess(pre, trip_budget, stage_times)

    def infer_batch(self, images, img_hws, trip_budget: Optional[int] = None,
                    mesh=None) -> List[Dict[str, Any]]:
        """Per-image :meth:`infer` over a batch → one result dict per image,
        in image order (the JAX package vmaps the per-image program,
        psg_v4.py:659-686, whose results equal per-image inference).

        ``mesh``: data parallel over its ``dp`` ranks.  Each dp rank runs
        its contiguous block of the images (JAX's ``P("dp")`` split; the
        batch must divide dp), and every rank gets all results back
        (``all_gather_object``).  A tp-sharded LLM decodes within each dp
        rank's tp group."""
        return dp_map(lambda i: self.infer(images[i], img_hws[i], trip_budget),
                      len(images), mesh)

    def make_pair_sharded_infer(self, mesh, axis: str = "dp"):
        """Latency-oriented single-image inference with the PAIR axis split
        over the mesh ``axis`` (JAX psg_v4.py:629-657, the sequence-parallel
        analogue): the segmenter and fusion run on every rank, the Q-Former
        on this rank's ``M*M / n`` pairs (the shared-KV kernel launches with
        that many), the head outputs are all-gathered back to every pair,
        then top-k, decode and postprocess give the single-device result.
        Where the pair count does not divide the axis it runs unsplit.

        → ``fn(image_u8, img_hw, trip_budget=None)`` → the result dict of
        :meth:`infer` (the JAX function returns the device tree that its
        ``postprocess`` takes)."""
        M = self.cfg.head.max_objects_padded
        rng = pair_sharded_range(mesh, M * M, axis)
        g = axis_group(mesh, axis)
        shard = None if rng is None or g is None else (rng[0], rng[1], g[0])

        def fn(image_u8, img_hw, trip_budget: Optional[int] = None) -> Dict[str, Any]:
            seg = self.segment(torch.as_tensor(image_u8, device=self.device))
            sel = self.fuse_select(seg, img_hw)
            pre = self.tail_pre(seg["mask_features"], *sel, pair_shard=shard)
            return self._decode_postprocess([pre], trip_budget, None)[0]

        return fn

    def infer_gt(self, image_u8, gt_masks, gt_oids, gt_valid) -> Dict[str, Any]:
        """Ground-truth-mask ablation (``_infer_gt_jit``, psg_v4.py:558-605):
        the segmenter still runs (its ``mask_features`` feed the Q-Former)
        but the GT masks replace fusion and selection.  gt_masks [M, H, W]
        bool at the bucket's resolution; gt_oids [M] panoptic ids; gt_valid
        [M] bool.  The pan map paints each pixel with the first valid mask
        that covers it, 133 where none does."""
        dev = self.device
        seg = self.segment(torch.as_tensor(image_u8, device=dev))
        masks = torch.as_tensor(gt_masks, device=dev).bool()
        oids = torch.as_tensor(gt_oids, device=dev).to(torch.int32)
        valid = torch.as_tensor(gt_valid, device=dev).bool()
        masks4 = downsample_nearest(masks, seg["mask_features"].shape[:2]) & valid[:, None, None]
        owned = masks & valid[:, None, None]
        first = torch.argmax(owned.to(torch.uint8), dim=0)
        pan = torch.where(owned.any(dim=0), oids[first], 133)
        labels = (oids % INSTANCE_OFFSET).to(torch.int32)
        pre = self.tail_pre(seg["mask_features"], masks4, valid, labels,
                            torch.where(valid, oids, 0), valid.float(), pan)
        return self._decode_postprocess([pre], None, None)[0]

    def _decode_postprocess(self, pre, trip_budget, stage_times):
        """``tail_pre`` results of N images → one prefill + decode over their
        flattened [N·K] prefixes → N postprocessed result dicts."""
        outs, prefixes, pmasks = zip(*pre)
        K = prefixes[0].shape[0]
        with span("decode", stage_times, self.device):
            toks, scores, trips = self.tail_decode(torch.cat(prefixes), torch.cat(pmasks),
                                                   trip_budget)
        results = []
        for i, out in enumerate(outs):
            out["gen_tokens"], out["gen_scores"] = toks[i * K:(i + 1) * K], scores[i * K:(i + 1) * K]
            host = {k: v.cpu().numpy() for k, v in out.items()}
            host["decode_trips"] = np.int32(trips)
            results.append(self.postprocess(host))
        return results

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
                if name in self.relation_names:
                    trip = (sub, obj, self.relation_names.index(name))
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
