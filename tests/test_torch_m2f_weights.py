"""The closed-set family's weight converters and convert tools against the
JAX package's.

Every converter runs on a seeded state dict in the reference layout (mmdet
Mask2Former with a ResNet or mmdet-Swin backbone; torch
``nn.TransformerDecoder``; the reference InteractiveFusionModule; relation
heads v1, v2, v3 with a Meta-layout Llama trunk) and must return the JAX
converter's tree array for array.  The tools: ``convert_mask2former`` writes
a ``segmenter.pt`` that a config's ``segmenter_pretrained_path`` loads, equal
to the JAX converter's tree through the bridge (a raw ``.pth`` loads the
same); ``convert_relation`` turns a reference v1 ``PartCheckpointHook`` file
into a part checkpoint, after which the port's infer tool (``--checkpoint``)
writes the submission the JAX convert and infer tools write; a v3 file's
Meta trunk lands in the head's ``llama``.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from openpsg_tpu_torch.bridge import part_state_dict, scan_prefixes
from openpsg_tpu_torch.core import builder
from openpsg_tpu_torch.core.config import Config
from openpsg_tpu_torch.models.segmenter.mask2former import (
    Mask2FormerConfig,
    Mask2FormerSegmenter,
)
from openpsg_tpu_torch.utils.synthetic_weights import (
    synthetic_bert_state,
    synthetic_mask2former_state,
    synthetic_relation_v1_state,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CFGS = os.path.join(REPO, "openpsg_tpu_torch", "configs", "psg")
R = 56


def same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            same_tree(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


class _State(dict):
    """A reference state dict being drawn: ``dense`` / ``dense_ln`` /
    ``ln`` add torch-layout tensors from one seeded generator."""

    def __init__(self, seed):
        super().__init__()
        self.rng = np.random.default_rng(seed)

    def arr(self, *shape):
        return self.rng.normal(size=shape).astype(np.float32) * np.float32(0.1)

    def dense(self, base, o, i):
        self[base + ".weight"], self[base + ".bias"] = self.arr(o, i), self.arr(o)

    def ln(self, base, d):
        self[base + ".weight"], self[base + ".bias"] = 1 + self.arr(d), self.arr(d)

    def dense_ln(self, base, o, i):
        self.dense(base + ".0", o, i)
        self.ln(base + ".1", o)

    def bert(self, prefix, D, layers, cross=False, bare=False):
        from openpsg_tpu_torch.models.commons.text_encoder import BertStyleConfig

        cfg = BertStyleConfig.tiny_test(hidden_size=D, num_layers=layers)
        st = synthetic_bert_state(cfg, seed=int(self.rng.integers(1 << 30)))
        for k, v in st.items():
            if bare and not k.startswith("encoder."):
                continue
            self[prefix + (k[len("encoder."):] if bare else k)] = v
        if cross:
            for i in range(layers):
                b = f"{prefix}encoder.layer.{i}.crossattention."
                for n in ("query", "key", "value"):
                    self.dense(b + f"self.{n}", D, D)
                self.dense(b + "output.dense", D, D)
                self.ln(b + "output.LayerNorm", D)


def torch_decoder_state(s, prefix, layers, D, ffn):
    for i in range(layers):
        b = f"{prefix}layers.{i}."
        for a in ("self_attn", "multihead_attn"):
            s[b + f"{a}.in_proj_weight"], s[b + f"{a}.in_proj_bias"] = s.arr(3 * D, D), s.arr(3 * D)
            s.dense(b + f"{a}.out_proj", D, D)
        s.dense(b + "linear1", ffn, D)
        s.dense(b + "linear2", D, ffn)
        for n in (1, 2, 3):
            s.ln(b + f"norm{n}", D)


def fusion_state(s, prefix, node, edge, D, graph, attention):
    ref_mlp = lambda b, i: (s.dense(b + ".fc1", 2 * D, i), s.ln(b + ".act", 2 * D),
                            s.dense(b + ".fc2", D, 2 * D))
    if graph:
        s.dense(prefix + "fc_node", D, node)
        s.dense(prefix + "fc_edge", D, edge)
        for d in ("edge2node_decoder.", "node2edge_decoder."):
            torch_decoder_state(s, prefix + "graph_transformer." + d, 3, D, 2048)
        for n in ("cls_s", "cls_o", "cls_r"):
            ref_mlp(prefix + n, D)
    else:
        s.dense(prefix + "cls_s", D, node)
        s.dense(prefix + "cls_o", D, node)
        s.dense(prefix + "cls_r", D, edge)
    if attention:
        ref_mlp(prefix + "fc_q", D)
        ref_mlp(prefix + "fc_k", D)


# ---------------------------------------------------------------- segmenter
@pytest.mark.parametrize("backbone", ["tiny_r50", "tiny"])
def test_convert_mask2former_equal(backbone):
    from openpsg_tpu.models.segmenter.mask2former import Mask2FormerConfig as JaxCfg
    from openpsg_tpu.models.segmenter.weight_convert import convert_mask2former as jax_convert

    from openpsg_tpu_torch.models.segmenter.weight_convert import convert_mask2former

    kw = dict(backbone=backbone, num_queries=10, enc_layers=2)
    cfg = dataclasses.replace(Mask2FormerConfig.tiny_test(), **kw)
    state = synthetic_mask2former_state(cfg)
    got = convert_mask2former(state, cfg)
    same_tree(got, jax_convert(state, dataclasses.replace(JaxCfg.tiny_test(), **kw)))
    with torch.device("meta"):
        module = Mask2FormerSegmenter(cfg)
    sd = part_state_dict("segmenter", {"params": got}, scanned=scan_prefixes(module, "segmenter"))
    assert {k: v.shape for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in module.state_dict().items()}


def test_convert_mask2former_strict_and_swin_map():
    from openpsg_tpu.models.segmenter.weight_convert import (
        mmdet_swin_state_to_ms as jax_swin_map,
    )

    from openpsg_tpu_torch.models.segmenter.weight_convert import (
        convert_mask2former,
        convert_resnet,
        mmdet_swin_state_to_ms,
    )

    cfg = dataclasses.replace(Mask2FormerConfig.tiny_test(), backbone="tiny")
    state = synthetic_mask2former_state(cfg, seed=1)
    got, want = mmdet_swin_state_to_ms(state), jax_swin_map(state)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    state["panoptic_head.mystery.weight"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unmapped"):
        convert_mask2former(state, cfg)
    assert callable(convert_resnet)


# ---------------------------------------------------------------- commons
@pytest.mark.parametrize("graph", [False, True])
def test_convert_interactive_fusion_equal(graph):
    from openpsg_tpu.models.commons.weight_convert import (
        convert_interactive_fusion as jax_convert,
    )

    from openpsg_tpu_torch.models.commons.weight_convert import convert_interactive_fusion

    s = _State(2)
    fusion_state(s, "fusion.", 24, 12, 16, graph, attention=True)
    same_tree(convert_interactive_fusion(s, "fusion.", "attention", 16),
              jax_convert(s, "fusion.", "attention", 16))


# ---------------------------------------------------------------- heads
@pytest.mark.parametrize("path", ["bilinear", "prompt"])
def test_convert_relation_head_v1_equal(path):
    from openpsg_tpu.models.relation.head_v1 import HeadV1Config as JC
    from openpsg_tpu.models.relation.weight_convert import convert_relation_head_v1 as jax_conv

    from openpsg_tpu_torch.models.relation.head_v1 import HeadV1Config
    from openpsg_tpu_torch.models.relation.weight_convert import convert_relation_head_v1

    D = 32
    s = _State(3)
    s.dense_ln("fc_input", D, 16)
    s.dense_ln("fc_output", D, D)
    s.bert("model.model.", D, 2)
    if path == "bilinear":
        kw = {}
        s.dense("cls_q", R * 8, D)
        s.dense("cls_k", R * 8, D)
    else:
        kw = dict(use_relation_prompts=True, fusion_pred_type="einsum_v2",
                  graph_transformer_type="base", use_learnable_prompts=True)
        fusion_state(s, "fusion.", D, D, 8, graph=True, attention=False)
        s.bert("semantic_model.model.", D, 2)
        s["learnable_prompts_embedding"] = s.arr(R, 16, D)
    same_tree(convert_relation_head_v1(s, HeadV1Config.tiny_test(**kw)),
              jax_conv(s, JC.tiny_test(**kw)))


def test_convert_relation_head_v2_equal():
    from openpsg_tpu.models.relation.head_v2 import HeadV2Config as JC
    from openpsg_tpu.models.relation.weight_convert import convert_relation_head_v2 as jax_conv

    from openpsg_tpu_torch.models.relation.head_v2 import EXPERT_ORDER, HeadV2Config
    from openpsg_tpu_torch.models.relation.weight_convert import convert_relation_head_v2

    D, D0, T = 32, 16, 16
    s = _State(4)
    s.bert("object_level_model.model.", D, 2)
    s.bert("sub_obj_pair_level_model.model.", D, 2, cross=True)
    s.dense_ln("fc_object_vision_only_input", D, D0)
    s.dense_ln("fc_object_vision_only_output", D, D)
    s.dense("object_vision_only_sub_pred", R * D, D)
    s.dense("object_vision_only_obj_pred", R * D, D)
    for name, i in (("fc_pair_vision_only_input", 2 * D0), ("fc_pair_vision_only_output", D),
                    ("fc_pair_text_vision_cross_input", T), ("fc_pair_vision_prompt_input", 2 * D0),
                    ("fc_pair_text_vision_cross_output", D),
                    ("fc_pair_vision_text_cross_input", 2 * D0), ("fc_pair_text_prompt_input", T),
                    ("fc_pair_vision_text_cross_output", D),
                    ("fc_triplet_vision_text_cross_input", 2 * D0),
                    ("fc_triplet_text_prompt_input", T),
                    ("fc_triplet_vision_text_cross_output", D),
                    ("moe_input_pair_vision", 2 * D0), ("moe_input_pair_text", T),
                    ("moe_input_triplet_text", T)):
        s.dense_ln(name, D, i)
    for name in ("pair_vision_only_pred", "pair_text_vision_cross_pred",
                 "pair_vision_text_cross_pred"):
        s.dense(name, R, D)
    for r in range(R):
        s.dense(f"triplet_vision_text_cross_pred.{r}", 1, D)
    s.dense("moe.0", D, D)
    s.ln("moe.1", D)
    s.dense("moe.3", D, D)
    s.ln("moe.4", D)
    s.dense("moe.6", 5, D)
    kw = dict(experts=EXPERT_ORDER, use_moe_gate=True)
    same_tree(convert_relation_head_v2(s, HeadV2Config.tiny_test(**kw)),
              jax_conv(s, JC.tiny_test(**kw)))


@pytest.mark.parametrize("vocab", ["closed", "open"])
def test_convert_relation_head_v3_equal(vocab):
    from openpsg_tpu.models.relation.head_v3 import HeadV3Config as JC
    from openpsg_tpu.models.relation.weight_convert import convert_relation_head_v3 as jax_conv

    from openpsg_tpu_torch.models.relation.head_v3 import HeadV3Config
    from openpsg_tpu_torch.models.relation.weight_convert import convert_relation_head_v3

    s = _State(5)
    L, F, D = 64, 32, 16
    if vocab == "closed":
        kw = {}
        s.dense_ln("fc_object_vision_only_input", L, 16)
        s.dense_ln("fc_object_vision_only_output", D, L)
        s.dense("object_vision_only_sub_pred", R * D, D)
        s.dense("object_vision_only_obj_pred", R * D, D)
    else:
        kw = dict(ov_relation=True, num_object_in_layers=1, num_relation_out_layers=2)
        for name, o, i in (("fc_object_in_former", F, 16), ("fc_object_former_to_llm", L, F),
                           ("fc_object_llm_to_former", F, L), ("fc_object_out_former", D, F),
                           ("fc_relation_llm_to_former", F, L),
                           ("fc_relation_out_former", 2 * D + 1, F)):
            s.dense_ln(name, o, i)
        s.dense("fc_sub_pred", D, D)
        s.dense("fc_obj_pred", D, D)
        s.bert("o_in_former.", F, 1, bare=True)
        s.bert("r_out_former.", F, 2, bare=True)
    same_tree(convert_relation_head_v3(s, HeadV3Config.tiny_test(**kw)),
              jax_conv(s, JC.tiny_test(**kw)))


# ---------------------------------------------------------------- tools
def test_convert_mask2former_tool_roundtrip(tmp_path):
    """A seeded mmdet checkpoint → the tool → ``segmenter.pt`` → the builder's
    ``segmenter_pretrained_path``: every segmenter tensor equals the JAX
    converter's tree through the bridge; the raw ``.pth`` loads the same."""
    from openpsg_tpu.models.segmenter.mask2former import Mask2FormerConfig as JaxCfg
    from openpsg_tpu.models.segmenter.weight_convert import convert_mask2former as jax_convert

    from openpsg_tpu_torch.tools import convert_mask2former

    cfg_path = os.path.join(PORT_CFGS, "tiny_r50.py")
    seg = dataclasses.replace(builder.m2f_relation_config(Config.fromfile(cfg_path)).segmenter,
                              num_classes=133)
    state = synthetic_mask2former_state(seg, seed=6)
    pth = tmp_path / "m2f.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in state.items()},
                "meta": {"epoch": 50}}, pth)
    out = convert_mask2former.main([str(pth), "--out", str(tmp_path / "conv"),
                                    "--config", cfg_path])
    with torch.device("meta"):
        module = Mask2FormerSegmenter(seg)
    want = part_state_dict(
        "segmenter", {"params": jax_convert(state, dataclasses.replace(JaxCfg.tiny_test()))},
        scanned=scan_prefixes(module, "segmenter"))
    for source in (out, str(pth)):
        c = tmp_path / "cfg.py"
        c.write_text(f"_base_ = ['{cfg_path}']\nmodel = dict(segmenter_pretrained_path={source!r})\n")
        model = builder.build_detector_from_config(Config.fromfile(str(c)), device="cpu")
        got = model.segmenter.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def _jax_tool(name):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def test_convert_relation_v1_and_infer_like_jax(tmp_path):
    """A seeded reference v1 ``PartCheckpointHook`` file through both
    packages' convert_relation and infer (``--checkpoint``, ``--gt-masks``)
    tools, both models' trunks from one seeded mmdet file (``load_from``):
    the port's part checkpoint holds the file's values and the submissions
    are identical."""
    from openpsg_tpu.core.builder import m2f_relation_config as jax_resolve
    from openpsg_tpu.core.config import Config as JaxConfig
    from tests.fixtures import make_fixture

    from openpsg_tpu_torch.tools import convert_relation, infer

    root = str(tmp_path / "fx")
    ann = make_fixture(root, n_images=4, hw=(64, 64))
    # both packages load the same seeded mmdet trunk through load_from
    seg = dataclasses.replace(builder.m2f_relation_config(
        Config.fromfile(os.path.join(PORT_CFGS, "tiny_r50.py"))).segmenter, num_classes=133)
    trunk = tmp_path / "m2f.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                               synthetic_mask2former_state(seg, seed=8).items()}}, trunk)
    cfg_file = tmp_path / "cfg.py"
    cfg_file.write_text(f"_base_ = ['{REPO}/configs/psg/tiny_r50.py']\n"
                        f"data = dict(test=dict(ann_file={ann!r}, img_prefix={root!r}))\n"
                        f"load_from = {str(trunk)!r}\n")
    port_cfg = tmp_path / "port_cfg.py"
    port_cfg.write_text(cfg_file.read_text().replace("configs/psg", "openpsg_tpu_torch/configs/psg"))
    mcfg = builder.m2f_relation_config(Config.fromfile(str(port_cfg)))
    state = synthetic_relation_v1_state(mcfg.head_v1, mcfg.segmenter.mask_dim, 133, fan_in=True)
    pth = tmp_path / "epoch_3.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in state.items()},
                "meta": {"epoch": 3}}, pth)
    assert jax_resolve(JaxConfig.fromfile(str(cfg_file))).head_version == "v1"

    out = {}
    for side in ("jax", "port"):
        ck, o = str(tmp_path / f"{side}_ckpts"), str(tmp_path / f"{side}_out")
        # the JAX tool's --verify sizes the head's input from
        # relation_head.input_feature_size (256 from the base config), not
        # the 32-wide tokens the model pools, and expects an fc_input the
        # model never builds; the port's verifies against the built head
        argv = [str(pth), "--config", str(cfg_file if side == "jax" else port_cfg),
                "--out", ck] + (["--verify"] if side == "port" else [])
        infer_argv = ["--config", str(cfg_file if side == "jax" else port_cfg),
                      "--checkpoint", ck, "--output-dir", o, "--img-scale", "64", "64",
                      "--gt-masks"]
        if side == "jax":
            _jax_tool("convert_relation").main(argv)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(sys, "argv", ["infer.py"] + infer_argv)
                _jax_tool("infer").main()
        else:
            convert_relation.main(argv)
            infer.main(infer_argv + ["--device", "cpu"])
        out[side] = o
    rel = {side: json.load(open(os.path.join(o, "submission", "relation.json")))
           for side, o in out.items()}
    assert rel["port"] == rel["jax"] and len(rel["port"]) == 2
    assert sum(len(r["relations"]) for r in rel["port"]) >= 2
    params = torch.load(tmp_path / "port_ckpts" / "step_0" / "params.pt", weights_only=True)
    np.testing.assert_array_equal(params["object_cls_embed.object_cls_embed"].numpy(),
                                  state["object_cls_embed.weight"])
    np.testing.assert_array_equal(params["head.cls_q.weight"].numpy(),
                                  state["relation_head.cls_q.weight"])


def test_convert_relation_v3_meta_trunk(tmp_path):
    """A v3 file carries its trained Meta-layout trunk: the closed head's
    ``llama`` gets the rotate-half layers and final norm, no token table
    and no lm_head; ``--verify`` holds the names and shapes."""
    from openpsg_tpu_torch.models.llm.weight_convert import convert_llama, meta_llama_to_hf_state
    from openpsg_tpu_torch.tools import convert_relation

    relations = [f"rel{i}" for i in range(7)]
    cfg_file = tmp_path / "cfg.py"
    cfg_file.write_text(
        "model = dict(type='Mask2FormerRelationV2', relation_head=dict(\n"
        "    type='RelationTransformerHeadV3', input_feature_size=16,\n"
        "    output_feature_size=16, shave_language_decoder_at=2, causal_mask=True,\n"
        f"    relation_classes={relations!r}))\n"
        "tpu = dict(segmenter_preset='tiny', llm=dict(vocab_size=97, dim=32, n_heads=4,\n"
        "           n_kv_heads=4, ffn_hidden=96, max_seq_len=64))\n")
    s = _State(7)
    s.dense_ln("relation_head.fc_object_vision_only_input", 32, 32)
    s.dense_ln("relation_head.fc_object_vision_only_output", 16, 32)
    s.dense("relation_head.object_vision_only_sub_pred", 7 * 16, 16)
    s.dense("relation_head.object_vision_only_obj_pred", 7 * 16, 16)
    meta = {"tok_embeddings.weight": s.arr(97, 32), "norm.weight": 1 + s.arr(32),
            "output.weight": s.arr(97, 32)}
    for i in range(2):
        p = f"layers.{i}."
        for n in ("wq", "wk", "wv", "wo"):
            meta[p + f"attention.{n}.weight"] = s.arr(32, 32)
        meta[p + "feed_forward.w1.weight"] = s.arr(96, 32)
        meta[p + "feed_forward.w3.weight"] = s.arr(96, 32)
        meta[p + "feed_forward.w2.weight"] = s.arr(32, 96)
        meta[p + "attention_norm.weight"] = 1 + s.arr(32)
        meta[p + "ffn_norm.weight"] = 1 + s.arr(32)
    s.update({f"relation_head.llama_model.{k}": v for k, v in meta.items()})
    s["object_cls_embed.weight"] = s.arr(133, 32)
    pth = tmp_path / "epoch_5.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in s.items()},
                "meta": {"epoch": 5}}, pth)
    convert_relation.main([str(pth), "--config", str(cfg_file), "--out", str(tmp_path / "ck"),
                           "--verify"])
    params = torch.load(tmp_path / "ck" / "step_0" / "params.pt", weights_only=True)
    mcfg = builder.m2f_relation_config(Config.fromfile(str(cfg_file)))
    hf = convert_llama(meta_llama_to_hf_state(meta, n_heads=4, n_kv_heads=4), mcfg.head_v3.llm,
                       dtype=torch.float32)
    llama = {k[len("head.llama."):]: v for k, v in params.items() if k.startswith("head.llama.")}
    assert set(llama) == {k[len("core."):] for k in hf if k.startswith("core.")} - {"lm_head.weight"}
    for k, v in llama.items():
        torch.testing.assert_close(v, hf["core." + k], rtol=0, atol=0)
    assert json.load(open(tmp_path / "ck" / "step_0" / "meta.json"))["epoch"] == 5
