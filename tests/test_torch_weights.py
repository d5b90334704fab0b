"""The port's weight converters and checkpoint loaders against the JAX
package's, on synthetic state dicts in the published layouts (no weights
are in the repository and none are downloaded).

* Every converter returns arrays exactly equal to the JAX converter's on
  the same state dict; the port's synthetic-state helpers draw the JAX
  test helpers' values (tests/test_weight_convert.py).
* The OpenSeeD converter's strict key check, level permutation and report.
* ``PSGv4.load_segmenter_weights`` on a raw reference ``.pt`` and on the
  ``convert_openseed`` tool's file, then ``infer`` on the tiny config,
  against the JAX ``load_segmenter_weights`` then ``infer``: integers
  exact, floats within 1e-5.
* A reference v4 ``.pth`` through the port's ``convert_relation`` and
  ``tools.infer --checkpoint --vis`` against the JAX pair: the same
  submission, overlay pixels and printed tables.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

from openpsg_tpu.models.commons import weight_convert as jcw
from openpsg_tpu.models.llm import weight_convert as jlw
from openpsg_tpu.models.relation import weight_convert as jrw
from openpsg_tpu.models.segmenter import weight_convert as jsw
from openpsg_tpu_torch.bridge import load_jax_params, part_state_dict
from openpsg_tpu_torch.models.commons import weight_convert as pcw
from openpsg_tpu_torch.models.commons.text_encoder import BertStyleConfig
from openpsg_tpu_torch.models.llm import weight_convert as plw
from openpsg_tpu_torch.models.relation import weight_convert as prw
from openpsg_tpu_torch.models.segmenter import weight_convert as psw
from openpsg_tpu_torch.utils import synthetic_weights as syn
from tests import test_weight_convert as jtw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
_np = lambda tree: jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def assert_tree_equal(got, want, path="") -> int:
    """Nested dicts of arrays: the same keys, and leaves with the same
    dtype and values → the number of leaves."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(got), sorted(want))
        return sum(assert_tree_equal(got[k], want[k], f"{path}/{k}") for k in want)
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype, g.shape, w.shape)
    np.testing.assert_array_equal(g, w, err_msg=path)
    return 1


def assert_states_equal(got, want):
    """Flat {name: array or tensor}: the same names, shapes and values."""
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=k)


def _seg_cfgs():
    from openpsg_tpu.models.segmenter.openseed import SegmenterConfig as JaxSegmenterConfig
    from openpsg_tpu_torch.models.segmenter.openseed import SegmenterConfig

    return (dataclasses.replace(SegmenterConfig.tiny_test(), total_levels=4, proj_dim=32),
            dataclasses.replace(JaxSegmenterConfig.tiny_test(), total_levels=4, proj_dim=32))


def _hf_swin_state(ms):
    """A transformers ``SwinModel`` state dict holding the values of a
    microsoft-layout one: qkv split, renames, the last out norm as
    ``layernorm``."""
    ren = {"norm1": "layernorm_before", "norm2": "layernorm_after",
           "attn.relative_position_bias_table": "attention.self.relative_position_bias_table",
           "attn.proj": "attention.output.dense", "mlp.fc1": "intermediate.dense",
           "mlp.fc2": "output.dense"}
    out = {"embeddings.patch_embeddings.projection.weight": ms["patch_embed.proj.weight"],
           "embeddings.patch_embeddings.projection.bias": ms["patch_embed.proj.bias"],
           "embeddings.norm.weight": ms["patch_embed.norm.weight"],
           "embeddings.norm.bias": ms["patch_embed.norm.bias"]}
    last = max(int(m.group(1)) for k in ms if (m := re.match(r"norm(\d+)\.weight", k)))
    for k, v in ms.items():
        m = re.match(r"(layers\.\d+\.blocks\.\d+\.)(.*)$", k)
        if m and m.group(2).startswith("attn.qkv."):
            for part, name in zip(np.split(v, 3, axis=0), ("query", "key", "value")):
                out[f"encoder.{m.group(1)}attention.self.{name}.{m.group(2)[9:]}"] = part
        elif m:
            key = next(k2 for k2 in ren if m.group(2).startswith(k2))
            out[f"encoder.{m.group(1)}{ren[key]}{m.group(2)[len(key):]}"] = v
        elif ".downsample." in k:
            out["encoder." + k] = v
        elif k == f"norm{last}.weight":
            out["layernorm.weight"] = v
        elif k == f"norm{last}.bias":
            out["layernorm.bias"] = v
    return out


def _case_swin():
    ms = jtw.synthetic_swin_state(embed_dim=16, depths=(1, 2), num_heads=(1, 2))
    assert_tree_equal(psw.convert_swin(ms, depths=(1, 2)), jsw.convert_swin(ms, depths=(1, 2)))
    hf = {"backbone." + k: v for k, v in _hf_swin_state(ms).items()}
    got = psw.hf_swin_state_to_ms(hf, prefix="backbone.")
    assert_states_equal(got, jsw.hf_swin_state_to_ms(hf, prefix="backbone."))
    assert_states_equal(got, {k: v for k, v in ms.items() if k not in ("norm0.weight", "norm0.bias")})
    composite = {"model.backbone." + k: v for k, v in ms.items()}
    assert psw.detect_swin_prefix(composite) == jsw.detect_swin_prefix(composite) == "model.backbone."


def _case_openseed():
    cfg, jcfg = _seg_cfgs()
    state = syn.synthetic_openseed_state(cfg)
    assert_states_equal(state, jtw.synthetic_openseed_state(jcfg))
    params, lang = psw.convert_openseed(state, cfg)
    jparams, jlang = jsw.convert_openseed(state, jcfg)
    assert assert_tree_equal(params, jparams) > 100
    assert_tree_equal(lang, jlang)
    # the language tower alone, resblocks nested under ``transformer.`` or not
    flat = {k.replace("transformer.resblocks", "resblocks"): v for k, v in state.items()}
    for s in (state, flat):
        prefix = "sem_seg_head.predictor.lang_encoder."
        assert psw.detect_clip_resblock_prefix(s, prefix) == jsw.detect_clip_resblock_prefix(s, prefix)
        assert_tree_equal(psw.convert_openseed_lang(s), jsw.convert_openseed_lang(s))


def _case_text():
    bert = BertStyleConfig.tiny_test()
    from openpsg_tpu.models.commons.text_encoder import BertStyleConfig as JaxBertStyleConfig

    jbert = JaxBertStyleConfig.tiny_test()
    state = syn.synthetic_bert_state(bert, seed=2)
    assert_states_equal(state, jtw.synthetic_bert_state(jbert, seed=2))
    state["embeddings.token_type_embeddings.weight"] = np.random.default_rng(1).normal(
        size=(2, bert.hidden_size)).astype(np.float32)
    assert_tree_equal(pcw.convert_bert(state, bert), jcw.convert_bert(state, jbert))
    bare = {k[len("encoder."):]: v for k, v in state.items() if k.startswith("encoder.")}
    assert_tree_equal(pcw.convert_bert_encoder(bare, dataclasses.replace(bert, bare=True)),
                      jcw.convert_bert_encoder(bare, dataclasses.replace(jbert, bare=True)))
    clip = BertStyleConfig.tiny_test(pre_ln=True, quick_gelu=True, causal=True)
    jclip = JaxBertStyleConfig.tiny_test(pre_ln=True, quick_gelu=True, causal=True)
    state = syn.synthetic_clip_state(clip, seed=3)
    assert_states_equal(state, jtw.synthetic_clip_state(jclip, seed=3))
    assert_tree_equal(pcw.convert_clip_text(state, clip), jcw.convert_clip_text(state, jclip))


def _case_llama():
    from openpsg_tpu.models.llm.llama import LlamaConfig as JaxLlamaConfig
    from openpsg_tpu.models.llm.llama import quantize_llama as jax_quantize
    from openpsg_tpu_torch.models.llm.llama import LlamaConfig, LlamaWithEmbeddings

    cfg, jcfg = LlamaConfig.tiny_test(vocab_size=64), JaxLlamaConfig.tiny_test(vocab_size=64)
    state = syn.synthetic_hf_state(cfg)
    assert_states_equal(state, jtw.synthetic_hf_state(jcfg))
    for n_layers in (cfg.n_layers, 1):        # 1: llm_truncate_num
        c = dataclasses.replace(cfg, n_layers=n_layers, dtype=torch.float32)
        want = _np(jlw.convert_llama(state, dataclasses.replace(jcfg, n_layers=n_layers),
                                     dtype=np.float32))
        got = plw.convert_llama(state, c)
        assert_states_equal(got, part_state_dict("llm", want))
        with torch.device("meta"):
            ref = LlamaWithEmbeddings(c).state_dict()
        plw.verify_structure(got, ref)
        q = plw.convert_llama({k: torch.from_numpy(v) for k, v in state.items()},
                              dataclasses.replace(c, quant=True))
        assert q[f"core.layers.0.wq.weight_q"].dtype == torch.int8
        assert_states_equal(q, part_state_dict("llm", {"params": jax_quantize(want["params"])}))
    meta = {}
    rng = np.random.default_rng(4)
    for key, v in state.items():
        key = key.replace("model.", "")
        for hf, m in ((v2, k2) for k2, v2 in plw._META_LAYER_MAP.items()):
            key = key.replace(hf, m)
        key = {"embed_tokens.weight": "tok_embeddings.weight", "lm_head.weight": "output.weight"}.get(key, key)
        meta["trunk." + key] = v
    meta["trunk.freqs_cis"] = rng.normal(size=(8, 2)).astype(np.float32)
    got = plw.meta_llama_to_hf_state(meta, cfg.n_heads, cfg.n_kv_heads, prefix="trunk.")
    want = jlw.meta_llama_to_hf_state(meta, cfg.n_heads, cfg.n_kv_heads, prefix="trunk.")
    assert_states_equal(got, want)
    assert set(got) == set(state)


def _case_relation_v4():
    from openpsg_tpu.models.relation.head_v4 import HeadV4Config as JaxHeadV4Config
    from openpsg_tpu_torch.models.relation.head_v4 import HeadV4Config

    cfg, jcfg = HeadV4Config.tiny_test(), JaxHeadV4Config.tiny_test()
    state = syn.synthetic_relation_v4_state(cfg, mask_dim=16, prefix="")
    assert_tree_equal(prw.convert_relation_head_v4(state, cfg),
                      jrw.convert_relation_head_v4(state, jcfg))
    qf = {k[len("relation_qformer."):]: v for k, v in state.items()
          if k.startswith("relation_qformer.")}
    assert_tree_equal(prw.convert_qformer(qf, cfg.qformer), jrw.convert_qformer(qf, jcfg.qformer))


CONVERTERS = {"swin": _case_swin, "openseed": _case_openseed, "bert_clip": _case_text,
              "llama": _case_llama, "relation_v4": _case_relation_v4}


@pytest.mark.parametrize("case", list(CONVERTERS))
def test_converter_matches_jax(case):
    CONVERTERS[case]()


def test_strict_unmapped_key_raises():
    cfg, _ = _seg_cfgs()
    state = syn.synthetic_openseed_state(cfg)
    state["sem_seg_head.predictor.some_new_tensor"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unmapped"):
        psw.convert_openseed(state, cfg)
    psw.convert_openseed(state, cfg, strict=False)
    # the documented drop list is not "unmapped"
    del state["sem_seg_head.predictor.some_new_tensor"]
    state["criterion.empty_weight"] = np.ones(134, np.float32)
    psw.convert_openseed(state, cfg)


def test_level_permutation_applied():
    """Internal level i (strides 8, 16, 32, 64) takes checkpoint level
    (32, 16, 8, 64).index(stride): the level embedding rows, each level's
    input projection, and the level axis of every sampling-offset and
    attention-weight projection; declaring another storage order undoes
    a permuted checkpoint exactly."""
    cfg, _ = _seg_cfgs()
    state = syn.synthetic_openseed_state(cfg)
    params, _ = psw.convert_openseed(state, cfg)
    pd = "sem_seg_head.pixel_decoder."
    le = state[pd + "transformer.level_embed"]
    for i, j in enumerate((2, 1, 0, 3)):
        np.testing.assert_array_equal(params["pixel_decoder"]["level_embed"][i], le[j])
        np.testing.assert_array_equal(params["pixel_decoder"][f"input_proj{i}"]["bias"],
                                      state[pd + f"input_proj.{j}.0.bias"])
    nH, L, K = 8, cfg.total_levels, cfg.num_points
    w = state[pd + "transformer.encoder.layers.0.self_attn.sampling_offsets.weight"]
    got = params["pixel_decoder"]["layers"]["layer"]["self_attn"]["sampling_offsets"]["kernel"][0]
    np.testing.assert_array_equal(got.reshape(-1, nH, L, K, 2)[:, :, 0],
                                  w.T.reshape(-1, nH, L, K, 2)[:, :, 2])
    order = (8, 16, 32, 64)
    perm = [(32, 16, 8, 64).index(s) for s in order]

    def relevel(a, tail):
        return np.take(a.reshape(nH, L, K, tail, *a.shape[1:]), perm, axis=1).reshape(a.shape)

    stored = {}
    for k, v in state.items():
        m = re.match(r"(.*input_proj\.)(\d)(\..*)", k)
        if m:
            stored[m.group(1) + str(order.index((32, 16, 8, 64)[int(m.group(2))])) + m.group(3)] = v
        elif k.endswith("level_embed"):
            stored[k] = v[perm]
        elif ".sampling_offsets." in k or ".attention_weights." in k:
            stored[k] = relevel(v, 2 if "offsets" in k else 1)
        else:
            stored[k] = v
    again, _ = psw.convert_openseed(stored, cfg, ckpt_level_strides=order,
                                    ckpt_input_proj_strides=order)
    assert_tree_equal(again, params)


def test_conversion_report_matches_jax():
    cfg, jcfg = _seg_cfgs()
    state = syn.synthetic_openseed_state(cfg)
    params, _ = psw.convert_openseed(state, cfg)
    for s in (state, None):
        got = psw.conversion_report(params, cfg, s)
        assert got == jsw.conversion_report(params, jcfg, s)
    for stride in (8, 16, 32, 64):
        assert f"stride {stride:>3}" in got


def test_llm_checkpoint_files(tmp_path):
    """``load_state_dict`` reads ``.pt`` (``state_dict`` unwrapped),
    ``.bin`` and ``.safetensors`` into numpy as the JAX loader does (bf16
    widened to float32); ``verify_structure`` names layout drift."""
    from openpsg_tpu_torch.models.llm.llama import LlamaConfig, LlamaWithEmbeddings

    cfg = dataclasses.replace(LlamaConfig.tiny_test(vocab_size=64), dtype=torch.float32)
    state = syn.synthetic_hf_state(cfg, seed=5)
    tensors = {k: torch.from_numpy(v) for k, v in state.items()}
    torch.save({"state_dict": tensors}, tmp_path / "a.pt")
    torch.save({k: v.bfloat16() for k, v in tensors.items()}, tmp_path / "b.bin")
    from safetensors.torch import save_file

    save_file(tensors, str(tmp_path / "c.safetensors"))
    for name in ("a.pt", "c.safetensors"):
        got = plw.load_state_dict(str(tmp_path / name))
        assert_states_equal(got, jlw.load_state_dict(str(tmp_path / name)))
        assert_states_equal(got, state)
    got = plw.load_state_dict(str(tmp_path / "b.bin"))
    assert got["lm_head.weight"].dtype == np.float32
    assert_states_equal(got, {k: v.bfloat16().float().numpy() for k, v in tensors.items()})
    conv = plw.convert_llama(got, cfg)
    with torch.device("meta"):
        ref = LlamaWithEmbeddings(cfg).state_dict()
    plw.verify_structure(conv, ref)
    del conv["core.final_norm.weight"]
    conv["core.lm_head.weight"] = conv["core.lm_head.weight"][:, :3]
    with pytest.raises(ValueError, match="drift.*final_norm.*lm_head"):
        plw.verify_structure(conv, ref)


# ------------------------------------------------- segmenter end to end


@pytest.fixture(scope="module")
def segmenter_pair(tmp_path_factory):
    """One reference OpenSeeD ``.pt`` (weights scaled by 1/√fan-in, so the
    tiny trunk's activations stay in range), loaded by both packages'
    ``load_segmenter_weights`` into the tiny config; every other part of
    the port model is the JAX model's over the bridge."""
    from openpsg_tpu.models.detectors.psg_v4 import PSGv4 as JaxPSGv4
    from openpsg_tpu.models.detectors.psg_v4 import PSGv4Config as JaxPSGv4Config
    from openpsg_tpu_torch.data.vocab import OBJECT_CLASSES
    from openpsg_tpu_torch.models.commons.clip_bpe import CLIPBPETokenizer
    from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config

    tmp = tmp_path_factory.mktemp("openseed")
    merges = syn.toy_clip_merges(OBJECT_CLASSES)
    vocab = CLIPBPETokenizer(merges).vocab_size
    opts = lambda c: dataclasses.replace(c, iou_thr=0.1)
    model = PSGv4(opts(PSGv4Config.tiny_test()), seed=0, device="cpu")
    state = syn.synthetic_openseed_state(model.cfg.segmenter, lang_dim=16, vocab=vocab,
                                         seed=6, fan_in=True)
    raw = tmp / "model_state_dict.pt"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}}, raw)
    jp = JaxPSGv4(opts(JaxPSGv4Config.tiny_test()), jax.random.PRNGKey(2))
    jp.load_segmenter_weights(str(raw))
    load_jax_params(model, _np(jp.params))
    bridged = {k: v.clone() for k, v in model.segmenter.state_dict().items()}
    with torch.no_grad():
        for p in model.segmenter.parameters():
            p.zero_()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model.load_segmenter_weights(str(raw))
    return dict(tmp=tmp, raw=raw, state=state, merges=merges, jp=jp, model=model,
                bridged=bridged, printed=out.getvalue())


def test_load_segmenter_weights_matches_jax(segmenter_pair):
    s = segmenter_pair
    got = s["model"].segmenter.state_dict()
    assert_states_equal(got, s["bridged"])
    assert s["printed"].startswith("OpenSeeD conversion report:")
    # integers exact, floats within TOL, on the fixture's images
    from tests.fixtures import make_fixture

    root = str(s["tmp"] / "fx")
    make_fixture(root, n_images=2, hw=[(64, 64), (48, 64)])
    objects = 0
    for i, hw in enumerate([(64, 64), (48, 64)]):
        img = np.zeros((64, 64, 3), np.uint8)
        img[: hw[0], : hw[1]] = cv2.imread(os.path.join(root, "images", f"{i}.jpg"))[..., ::-1]
        want, res = s["jp"].infer(img, hw), s["model"].infer(img, hw)
        np.testing.assert_array_equal(res["pan_results"], want["pan_results"])
        assert res["rel_results"] == want["rel_results"]
        np.testing.assert_allclose(res["rel_scores"], want["rel_scores"], atol=TOL, rtol=0)
        assert res["decode_steps"] == want["decode_steps"]
        objects += len(res["rel_results"]["object_id_list"])
    assert objects >= 1


def test_convert_openseed_tool_matches_jax(segmenter_pair, monkeypatch, capsys):
    """The tool's ``segmenter.pt`` loads the tensors the raw ``.pt`` does;
    ``lang.pt`` holds the JAX converter's language tower; ``class_embeds
    .npy`` is the JAX ``clip_class_embeddings`` on it within 1e-5."""
    from openpsg_tpu.models.commons.clip_bpe import CLIPBPETokenizer as JaxCLIPBPETokenizer
    from openpsg_tpu.models.segmenter.language import clip_class_embeddings as jax_embeddings
    from openpsg_tpu.models.segmenter.language import clip_text_tower_config as jax_tower_cfg
    from openpsg_tpu_torch.data.vocab import OBJECT_CLASSES, clean_name
    from openpsg_tpu_torch.models.commons.text_encoder import tower_state_dict
    from openpsg_tpu_torch.models.segmenter import openseed
    from openpsg_tpu_torch.tools import convert_openseed

    s = segmenter_pair
    out = s["tmp"] / "converted"
    merges = syn.write_merges(str(s["tmp"] / "merges.txt"), s["merges"])
    # the tool converts at the published geometry; here, the tiny one
    monkeypatch.setattr(openseed, "SegmenterConfig", lambda **kw: s["model"].cfg.segmenter)
    convert_openseed.main([str(s["raw"]), "--out", str(out), "--merges", merges,
                           "--device", "cpu"])
    assert "OpenSeeD conversion report:" in capsys.readouterr().out
    sd = torch.load(out / "segmenter.pt", weights_only=True)
    assert_states_equal(sd, s["bridged"])
    _, jlang = jsw.convert_openseed(s["state"], s["jp"].cfg.segmenter)
    lang = torch.load(out / "lang.pt", weights_only=True)
    want = {f"tower.{k}": v for k, v in tower_state_dict(jlang["tower"]).items()}
    want.update(lang_proj=jlang["lang_proj"], logit_scale=jlang["logit_scale"])
    assert_states_equal(lang, want)
    emb = np.load(out / "class_embeds.npy")
    tower = jlang["tower"]
    tcfg = jax_tower_cfg(width=16, layers=tower["layers"]["ffn_up"]["kernel"].shape[0],
                         vocab=tower["word_embed"]["embedding"].shape[0])
    ref = jax_embeddings(tcfg, tower, jlang["lang_proj"], JaxCLIPBPETokenizer(s["merges"]),
                         [clean_name(n) for n in OBJECT_CLASSES])
    assert emb.shape == (133, s["model"].cfg.segmenter.proj_dim) and emb.dtype == np.float32
    np.testing.assert_allclose(emb, ref, atol=TOL, rtol=0)


# ------------------------------------------- relation checkpoint end to end


def _jax_tool(name):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def _tables(text):
    """The file names and triplet tables a ``--vis`` run printed."""
    return [ln for ln in text.splitlines() if ln.startswith(("+-", "| ")) or ln.endswith(".jpg")]


def test_convert_relation_then_infer_with_vis_matches_jax(tmp_path, monkeypatch, capsys):
    """A reference v4 ``PartCheckpointHook`` .pth (``relation_head.*``, no
    ``language_model``) through each package's ``convert_relation`` and
    infer tool (``--checkpoint``, ``--vis``, on the fixture's GT masks so
    that every image has objects, relations and table rows; the random
    tiny segmenter keeps few).  The JAX converter sizes the
    Q-Former's position table from the config before the tokenizer widens
    it, which its own model then refuses to restore (ROADMAP Queue 3, F4);
    the JAX side is given the resolved head geometry, the port takes it
    from the model the config builds."""
    import openpsg_tpu.core.builder as jax_builder
    from openpsg_tpu.core.config import Config as JaxConfig
    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config
    from openpsg_tpu_torch.tools import convert_relation, infer
    from tests.fixtures import make_fixture
    from tools.convert_relation import main as jax_convert

    root = str(tmp_path / "fx")
    ann = make_fixture(root, n_images=6, hw=[(64, 64), (48, 64), (64, 48)])
    cfgs = {}
    for side, base in (("jax", "configs/psg"), ("port", "openpsg_tpu_torch/configs/psg")):
        cfgs[side] = str(tmp_path / f"{side}_cfg.py")
        with open(cfgs[side], "w") as f:
            f.write(f"_base_ = ['{REPO}/{base}/tiny_v4_ov.py']\n"
                    f"data = dict(test=dict(ann_file={ann!r}, img_prefix={root!r}))\n")
    jp = jax_builder.build_detector_from_config(JaxConfig.fromfile(cfgs["jax"]),
                                                jax.random.PRNGKey(0))
    model = build_detector_from_config(Config.fromfile(cfgs["port"]), seed=0, device="cpu")
    load_jax_params(model, _np(jp.params))
    assert model.cfg.head.qformer.max_text_len == jp.cfg.head.qformer.max_text_len
    state = syn.synthetic_relation_v4_state(model.cfg.head, model.cfg.segmenter.mask_dim,
                                            seed=7, fan_in=True)
    state["object_cls_embed.weight"] = np.zeros((4, 4), np.float32)   # not v4's: left over
    pth = str(tmp_path / "epoch_3.pth")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in state.items()},
                "meta": {"epoch": 3}}, pth)

    monkeypatch.setattr(jax_builder, "_head_cfg_from_dict", lambda d, tpu: jp.cfg.head)
    jax_convert([pth, "--config", cfgs["jax"], "--out", str(tmp_path / "jax_ckpt")])
    convert_relation.main([pth, "--config", cfgs["port"], "--out", str(tmp_path / "port_ckpt"),
                           "--verify"])
    printed = capsys.readouterr().out
    assert "verify: converted names and shapes match" in printed and "object_cls_embed" in printed
    common = ["--output-dir", None, "--img-scale", "64", "64", "--gt-masks", "--single-bucket",
              "--vis", None]

    def args(side):
        a = ["--config", cfgs[side], "--checkpoint", str(tmp_path / f"{side}_ckpt")] + common
        a[a.index("--output-dir") + 1] = str(tmp_path / f"{side}_out")
        a[a.index("--vis") + 1] = str(tmp_path / f"{side}_vis")
        return a

    monkeypatch.setattr(jax_builder, "build_detector_from_config", lambda cfg, rng: jp)
    monkeypatch.setattr(sys, "argv", ["infer.py"] + args("jax"))
    _jax_tool("infer").main()
    want_text = capsys.readouterr().out
    infer.main(args("port") + ["--device", "cpu"], model=model)
    got_text = capsys.readouterr().out
    assert "restored trainable params from step 0 (epoch 3)" in got_text
    assert_states_equal({k: v.numpy() for k, v in model.head.state_dict().items()},
                        part_state_dict("head", _np(jp.params["head"])))

    rel = [json.load(open(tmp_path / f"{side}_out" / "submission" / "relation.json"))
           for side in ("jax", "port")]
    assert rel[1] == rel[0] and len(rel[1]) == 3
    assert sum(len(r["relations"]) for r in rel[1]) >= 1
    for r in rel[1]:
        a, b = (cv2.imread(str(tmp_path / f"{side}_out" / "submission" / "panseg"
                               / r["pan_seg_file_name"])) for side in ("jax", "port"))
        np.testing.assert_array_equal(b, a)
    jpgs = sorted(os.listdir(tmp_path / "jax_vis"))
    assert jpgs == sorted(os.listdir(tmp_path / "port_vis")) and len(jpgs) == 3
    assert all(j.endswith("_pan_seg.jpg") for j in jpgs)
    for j in jpgs:
        a, b = (cv2.imread(str(tmp_path / f"{side}_vis" / j)) for side in ("jax", "port"))
        np.testing.assert_array_equal(b, a)
    tables = _tables(got_text)
    assert tables == _tables(want_text)
    assert sum(ln.startswith("| ") for ln in tables) > 3          # headers and rows
