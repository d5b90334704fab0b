"""The port's closed-set v1 detector, its builder and its tool path against
the JAX package at the tiny config.

One model pair: the JAX builder's model from ``configs/psg/tiny_r50.py`` and
the port builder's from its copy, the JAX weights bridged; both with
``object_mask_thr=0`` and ``iou_thr=0.1`` so the tiny random model keeps
several objects.  Integer outputs
(pan maps, object ids, triplets) are compared exactly, triplet scores at
atol = rtol = 1e-4.  The infer tools run on ``tests/fixtures.make_fixture``
(64² images: one bucket, resized as they are) and must write identical
``relation.json`` files and panoptic PNGs.
"""

import dataclasses
import json
import os
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

from openpsg_tpu_torch.bridge import load_jax_params
from openpsg_tpu_torch.core import builder
from openpsg_tpu_torch.core.config import Config
from openpsg_tpu_torch.models.detectors.mask2former_relation import PSGMask2FormerRelation
from openpsg_tpu_torch.tools import infer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CFGS = os.path.join(REPO, "openpsg_tpu_torch", "configs", "psg")
FAMILY_CFGS = ["baseline_r50.py", "baseline_r50_prompt.py", "baseline_swin_b.py",
               "baseline_v2_r50.py", "baseline_v3_ov.py", "baseline_v3_r50.py",
               "tiny_r50.py", "tiny_r50_prompt.py", "tiny_v3_ov.py"]
# the tiny random segmenter keeps no object at the shipped 0.8 threshold
KEEP_ALL = "model = dict(test_cfg=dict(object_mask_thr=0.0))\n"
TOL = dict(atol=1e-4, rtol=1e-4)
CASES = {"per_image": [], "gt_masks": ["--gt-masks"]}


def _jax_tool(name):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def _tree(jp):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(jp.params))


def gt_objects(M=8, n=6, hw=(64, 64)):
    """n tie-free ground-truth objects on a grid (things of two classes, one
    repeated, and stuff), padded to M."""
    H, W = hw
    cell = (np.arange(H)[:, None] * 2 // H) * 3 + np.arange(W)[None, :] * 3 // W
    masks = np.zeros((M, H, W), bool)
    masks[:n] = cell[None] == np.arange(n)[:, None, None]
    oids = np.zeros(M, np.int64)
    oids[:n] = [0, 1000, 16, 1016, 119, 125]   # person ×2, dog ×2, two stuff
    return masks, oids, np.arange(M) < n


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from openpsg_tpu.core.builder import build_detector_from_config as jax_build
    from openpsg_tpu.core.config import Config as JaxConfig
    from tests.fixtures import make_fixture

    tmp = tmp_path_factory.mktemp("m2f")
    root = tmp / "psg"
    ann = make_fixture(str(root), n_images=4, hw=(64, 64))
    cfgs = {}
    for side, base in (("jax", "configs/psg"), ("port", "openpsg_tpu_torch/configs/psg")):
        cfgs[side] = tmp / f"{side}_cfg.py"
        cfgs[side].write_text(f"_base_ = ['{REPO}/{base}/tiny_r50.py']\n" + KEEP_ALL)
    jp = jax_build(JaxConfig.fromfile(str(cfgs["jax"])), jax.random.PRNGKey(0))
    model = builder.build_detector_from_config(Config.fromfile(str(cfgs["port"])), seed=0,
                                               device="cpu")
    load_jax_params(model, _tree(jp))
    # the configs leave iou_thr at 0.8; 0.1 keeps several objects of the
    # tiny random model (set before the JAX program is first traced)
    jp.cfg = dataclasses.replace(jp.cfg, iou_thr=0.1)
    model.cfg = dataclasses.replace(model.cfg, iou_thr=0.1)
    img = np.random.default_rng(0).integers(0, 256, (64, 64, 3)).astype(np.float32)
    return dict(tmp=tmp, root=str(root), ann=ann, cfgs=cfgs, jp=jp, model=model, img=img,
                runs={})


def assert_same_result(got, want):
    assert got["rel_results"] == want["rel_results"]
    np.testing.assert_array_equal(got["pan_results"], want["pan_results"])
    np.testing.assert_allclose(got["rel_scores"], want["rel_scores"], **TOL)


@pytest.mark.parametrize("hw", [(64, 64), (56, 60)])
def test_infer_identical(setup, hw):
    jp, model, img = setup["jp"], setup["model"], setup["img"]
    want = jp.infer(img, hw)
    got = model.infer(img, hw)
    assert_same_result(got, want)
    if hw == (64, 64):
        assert len(want["rel_results"]["object_id_list"]) >= 2
        assert len(want["rel_results"]["relation"]) == 100


def test_infer_gt_identical(setup):
    jp, model, img = setup["jp"], setup["model"], setup["img"]
    masks, oids, valid = gt_objects()
    want = jp.infer_gt(img, masks, oids, valid)
    got = model.infer_gt(img, masks, oids, valid)
    assert_same_result(got, want)
    assert got["rel_results"]["object_id_list"] == [0, 1000, 16, 1016, 119, 125]
    assert len(got["rel_results"]["relation"]) == 100


def test_infer_batch_is_the_per_image_program(setup):
    """The batch loop gives what per-image inference gives (the JAX package
    holds its vmapped batch to the same)."""
    jp, model, img = setup["jp"], setup["model"], setup["img"]
    hws = [(64, 64), (56, 60)]
    got = model.infer_batch(np.stack([img, img[::-1].copy()]), np.asarray(hws))
    for g, im, hw in zip(got, [img, img[::-1].copy()], hws):
        assert_same_result(g, jp.infer(im, hw))


def run_case(s, case):
    """Both tools on one case, once per module → (jax output dir, port
    output dir, port stats)."""
    if case not in s["runs"]:
        import openpsg_tpu.core.builder as jax_builder

        out = {side: s["tmp"] / f"{side}_{case}" for side in ("jax", "port")}
        args = lambda side: (["--config", str(s["cfgs"][side]), "--test-file", s["ann"],
                              "--data-dir", s["root"], "--output-dir", str(out[side]),
                              "--img-scale", "64", "64"] + CASES[case])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_builder, "build_detector_from_config", lambda cfg, rng: s["jp"])
            mp.setattr(sys, "argv", ["infer.py"] + args("jax"))
            _jax_tool("infer").main()
        stats = infer.main(args("port") + ["--device", "cpu"], model=s["model"])
        s["runs"][case] = (out["jax"], out["port"], stats)
    return s["runs"][case]


def assert_same_submission(out_j, out_p, n):
    rel_j = json.load(open(out_j / "submission" / "relation.json"))
    rel_p = json.load(open(out_p / "submission" / "relation.json"))
    assert rel_p == rel_j and len(rel_p) == n
    for rec in rel_p:
        a = cv2.imread(str(out_j / "submission" / "panseg" / rec["pan_seg_file_name"]))
        b = cv2.imread(str(out_p / "submission" / "panseg" / rec["pan_seg_file_name"]))
        np.testing.assert_array_equal(b, a)
    return rel_p


@pytest.mark.parametrize("case", list(CASES))
def test_tool_submission_identical(setup, case):
    out_j, out_p, stats = run_case(setup, case)
    recs = assert_same_submission(out_j, out_p, stats["n_images"])
    assert stats["n_images"] == 2 and stats["micro_batch"] == 0
    if case == "gt_masks":
        assert all(len(r["segments_info"]) == 3 for r in recs)
    else:
        assert sum(len(r["relations"]) for r in recs) >= 2


def test_tool_refuses_micro_batch_for_the_family(setup):
    with pytest.raises(SystemExit, match="micro-batch"):
        infer.main(["--config", str(setup["cfgs"]["port"]), "--test-file", setup["ann"],
                    "--micro-batch", "2", "--device", "cpu"], model=setup["model"])


def test_checkpoint_restore(setup, tmp_path):
    """A part checkpoint of the family holds the head and the object class
    embeddings; the tool's ``--checkpoint`` restores them bitwise
    into a fresh model, which then runs the images."""
    from openpsg_tpu_torch.train.checkpoint import PartCheckpointer, trainable_groups

    cfg = Config.fromfile(str(setup["cfgs"]["port"]))
    assert trainable_groups(cfg) == ("head", "object_cls_embed")
    model = builder.build_detector_from_config(cfg, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(3)
    groups = model.param_groups()
    params = {f"{g}.{n}": torch.randn(t.shape, generator=gen)
              for g in ("head", "object_cls_embed") for n, t in groups[g].items()}
    PartCheckpointer(str(tmp_path / "ckpts")).save(
        7, params, {"count": 0, "mu": {}, "nu": {}}, meta={"epoch": 2})
    before = model.infer_gt(setup["img"], *gt_objects())
    stats = infer.main(["--config", str(setup["cfgs"]["port"]), "--test-file", setup["ann"],
                        "--data-dir", setup["root"], "--output-dir", str(tmp_path / "out"),
                        "--img-scale", "64", "64", "--device", "cpu",
                        "--checkpoint", str(tmp_path / "ckpts")], model=model)
    assert stats["n_images"] == 2
    groups = model.param_groups()
    for name, value in params.items():
        g, n = name.split(".", 1)
        torch.testing.assert_close(groups[g][n], value, rtol=0, atol=0)
    after = model.infer_gt(setup["img"], *gt_objects())
    assert after["rel_scores"] != before["rel_scores"]


@pytest.mark.parametrize("name", FAMILY_CFGS)
def test_builder_resolution_matches_jax_builder(name):
    """Every closed-set config resolves to the JAX builder's
    ``M2FRelationConfig``, field by field (dtypes by name)."""
    from openpsg_tpu.core.builder import m2f_relation_config as jax_resolve
    from openpsg_tpu.core.config import Config as JaxConfig

    want = jax_resolve(JaxConfig.fromfile(os.path.join(REPO, "configs", "psg", name),
                                          import_custom_modules=False))
    got = builder.m2f_relation_config(Config.fromfile(os.path.join(PORT_CFGS, name)))
    _same_fields(got, want)
    kw = builder.model_kwargs_from(Config.fromfile(os.path.join(PORT_CFGS, name)))
    assert len(kw["class_names"]) == 133 and kw["num_things"] == 80
    assert kw["relation_names"] is None or len(kw["relation_names"]) == 56


def _same_fields(port, ref, path="cfg"):
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        where = f"{path}.{f.name}"
        if dataclasses.is_dataclass(a):
            _same_fields(a, b, where)
        elif isinstance(a, torch.dtype):
            assert str(a).split(".")[-1] == np.dtype(b).name, where
        elif isinstance(a, (list, tuple)):
            assert tuple(a) == tuple(b), where
        else:
            assert a == b, where


FIELD_CASES = {
    # the optional v1 token fields (a sine positional-encoding dict's
    # presence is the switch)
    "v1_embellishments": ("baseline_r50.py", "model = dict(relation_head=dict("
                          "positional_encoding=dict(type='SinePositionalEncoding'), "
                          "use_background_feature=True, object_token_size=3, "
                          "embedding_add_cls=False, merge_cls_type='cat'))\n"),
    # the panoptic_head geometry, field by field; the published mmdet R50
    # checkpoint's pixel-decoder FFN is 1024 where baseline_r50.py leaves
    # 2048 (ROADMAP Queue 3, F5)
    "panoptic_head_fields": ("baseline_r50.py", "model = dict(panoptic_head=dict("
                             "num_queries=50, feat_channels=128, out_channels=64, "
                             "pixel_decoder=dict(encoder=dict(num_layers=3, transformerlayers="
                             "dict(ffn_cfgs=dict(feedforward_channels=1024)))), "
                             "transformer_decoder=dict(num_layers=4, transformerlayers=dict("
                             "feedforward_channels=512))))\n"),
    "v2_experts_and_gate": ("baseline_v2_r50.py", "model = dict(relation_head=dict("
                            "use_pair_vision_only=True, use_triplet_vision_text_cross=True, "
                            "use_moe=True, moe_weight_type='v2'))\ntpu = dict(bf16=False)\n"),
    "v3_llm_override": ("tiny_v3_ov.py", "model = dict(relation_head=dict("
                        "shave_language_decoder_at=1, sub_obj_merge_type='multiply', "
                        "num_object_in_layers=2))\ntpu = dict(llm=dict(dim=32, n_heads=2))\n"),
}


@pytest.mark.parametrize("case", list(FIELD_CASES))
def test_builder_maps_reference_fields(tmp_path, case):
    """Reference fields beyond the shipped configs resolve as the JAX
    builder resolves them."""
    from openpsg_tpu.core.builder import m2f_relation_config as jax_resolve
    from openpsg_tpu.core.config import Config as JaxConfig

    base, extra = FIELD_CASES[case]
    files = {}
    for side, d in (("jax", "configs/psg"), ("port", "openpsg_tpu_torch/configs/psg")):
        files[side] = tmp_path / f"{side}.py"
        files[side].write_text(f"_base_ = ['{REPO}/{d}/{base}']\n{extra}")
    want = jax_resolve(JaxConfig.fromfile(str(files["jax"]), import_custom_modules=False))
    got = builder.m2f_relation_config(Config.fromfile(str(files["port"])))
    _same_fields(got, want)
    if case == "panoptic_head_fields":
        assert got.segmenter.enc_ffn_hidden == 1024 and got.segmenter.num_queries == 50
        shipped = builder.m2f_relation_config(
            Config.fromfile(os.path.join(PORT_CFGS, "baseline_r50.py"))).segmenter
        assert shipped.enc_ffn_hidden is None and shipped.ffn_hidden == 2048


@pytest.mark.parametrize("name", ["tiny_r50.py", "tiny_r50_prompt.py", "tiny_v3_ov.py"])
def test_builder_builds_the_tiny_family(name):
    model = builder.build_detector_from_config(Config.fromfile(os.path.join(PORT_CFGS, name)),
                                               device="cpu")
    assert isinstance(model, PSGMask2FormerRelation)
    assert model.cfg.head_version == ("v3" if "v3" in name else "v1")
    assert tuple(model.object_cls_embed.shape) == (133, 32)


def test_builder_loads_a_segmenter_checkpoint(tmp_path):
    """``segmenter_pretrained_path`` (or ``load_from``) names an mmdet
    checkpoint: the built model's segmenter holds its converted values."""
    from openpsg_tpu_torch.utils.synthetic_weights import synthetic_mask2former_state

    seg_cfg = builder.m2f_relation_config(
        Config.fromfile(os.path.join(PORT_CFGS, "tiny_r50.py"))).segmenter
    state = synthetic_mask2former_state(dataclasses.replace(seg_cfg, num_classes=133))
    path = tmp_path / "m2f.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in state.items()}}, path)
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"_base_ = ['{PORT_CFGS}/tiny_r50.py']\nload_from = {str(path)!r}\n")
    model = builder.build_detector_from_config(Config.fromfile(str(cfg)), device="cpu")
    np.testing.assert_array_equal(model.segmenter.decoder.query_embed.numpy(),
                                  state["panoptic_head.query_feat.weight"])


def test_train_tool_refuses_the_family(tmp_path):
    from openpsg_tpu_torch.tools import train

    with pytest.raises(SystemExit, match="closed-set"):
        train.main([os.path.join(PORT_CFGS, "tiny_r50.py"), "--work-dir", str(tmp_path),
                    "--device", "cpu"])
