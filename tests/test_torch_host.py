"""The port's host runtime against the JAX package's: config loading and
builder resolution, preprocessing buckets and resizes (against cv2, the
reference's resizer), panoptic id helpers, the PNG codec (against cv2 both
ways), the submission writer, the numpy scorers, the auto micro-batch
controller and the trace reading.  Integer and pixel outputs are compared
exactly; scorer floats with ``==``."""

import dataclasses
import json
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from openpsg_tpu.core.config import Config as JaxConfig
from openpsg_tpu.core.config import replace_cfg_vals as jax_replace_cfg_vals
from openpsg_tpu_torch.core import builder
from openpsg_tpu_torch.core.config import Config, replace_cfg_vals
from openpsg_tpu_torch.data import preprocess
from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4Config
from openpsg_tpu_torch.utils import image_io, panoptic, profiling, submission

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CFGS = os.path.join(REPO, "openpsg_tpu_torch", "configs", "psg")
INT8_TPU = "tpu = dict(llm_int8=True, act_int8=True, enc_points_per_level=[2, 2, 2, 4])\n"


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("name", ["baseline_v4_ov.py", "tiny_v4_ov.py"])
def test_port_configs_equal_jax_but_imports(name):
    want = JaxConfig.fromfile(os.path.join(REPO, "configs", "psg", name),
                              import_custom_modules=False).to_dict()
    cfg = Config.fromfile(os.path.join(PORT_CFGS, name))     # runs custom_imports
    got = cfg.to_dict()
    imports = got.pop("custom_imports")["imports"]
    want.pop("custom_imports")
    assert got == want
    assert imports and all(m.startswith("openpsg_tpu_torch.") for m in imports)
    assert all(m in sys.modules for m in imports)


def test_config_merge_semantics_match_jax(tmp_path):
    (tmp_path / "base.py").write_text(
        "a = dict(x=1, y=dict(p=2, q=3), z=[1, 2])\nb = 'root'\nname = '${b}-x'\n"
        "ref = '${a.x}'\n")
    (tmp_path / "child.py").write_text(
        "_base_ = 'base.py'\na = dict(y=dict(_delete_=True, r=4), w=5)\nc = (1, 2)\n")
    results = []
    for cls, rep in ((JaxConfig, jax_replace_cfg_vals), (Config, replace_cfg_vals)):
        cfg = cls.fromfile(str(tmp_path / "child.py"))
        cfg.merge_from_dict({"a.y.s": 6, "d.e": 7})
        cfg = rep(cfg)
        results.append((cfg.to_dict(), cfg.a.y.r, cfg.get("nope", 9), "d" in cfg))
    assert results[1] == results[0]
    assert results[1][0]["a"]["y"] == {"r": 4, "s": 6} and results[1][0]["ref"] == 1
    assert results[1][0]["name"] == "root-x"


def _same_fields(port, ref, path="cfg"):
    """Every field of a port config dataclass equals the JAX one's of the
    same name (dtypes by name, sequences as tuples)."""
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


@pytest.mark.parametrize("name,extra", [
    ("baseline_v4_ov.py", ""),
    ("baseline_v4_ov.py", INT8_TPU),
    ("tiny_v4_ov.py", "tpu = dict(input_hw=(128, 96), max_new_tokens=5, "
                      "decode_early_exit=False, fusion_stride=4, fusion_candidates=8, "
                      "llm_layers=1)\n"),
])
def test_builder_resolution_matches_jax_builder(tmp_path, name, extra):
    """The port's resolution against the JAX builder's ``PSGv4Config``
    (captured without building weights)."""
    import openpsg_tpu.models.detectors.psg_v4 as jax_psg

    files = {"port": PORT_CFGS, "jax": os.path.join(REPO, "configs", "psg")}
    cfgs = {}
    for side, d in files.items():
        p = tmp_path / f"{side}.py"
        p.write_text(f"_base_ = ['{d}/{name}']\n{extra}")
        cfgs[side] = p
    seen = {}

    class Capture(Exception):
        pass

    def capture(pcfg, rng, **kw):
        seen["cfg"], seen["kw"] = pcfg, kw
        raise Capture

    from openpsg_tpu.core.builder import build_detector_from_config as jax_build

    orig = jax_psg.PSGv4
    jax_psg.PSGv4 = capture
    try:
        with pytest.raises(Capture):
            jax_build(JaxConfig.fromfile(str(cfgs["jax"]), import_custom_modules=False))
    finally:
        jax_psg.PSGv4 = orig
    got = builder.psg_v4_config_from(Config.fromfile(str(cfgs["port"])))
    _same_fields(got, seen["cfg"])
    assert seen["kw"]["num_things"] == 80 and len(seen["kw"]["class_names"]) == 133


def test_builder_full_width_resolutions(tmp_path):
    base = Config.fromfile(os.path.join(PORT_CFGS, "baseline_v4_ov.py"))
    assert builder.psg_v4_config_from(base) == PSGv4Config.baseline_v4_ov()
    p = tmp_path / "w8a8.py"
    p.write_text(f"_base_ = ['{PORT_CFGS}/baseline_v4_ov.py']\n{INT8_TPU}")
    assert builder.psg_v4_config_from(Config.fromfile(str(p))) == PSGv4Config.baseline_v4_ov_w8a8()


@pytest.mark.parametrize("field", ["llm_model_name", "qformer_tokenizer_path",
                                   "openseed_pretrained_path", "type"])
def test_builder_refuses_what_waits(tmp_path, field):
    """What once waited for a later slice now builds: a closed-set detector
    type (with a closed-set head) gives the closed-set family's model, a
    closed-set type under the v4 head is refused by name; the asset fields
    load what they name: a SentencePiece ``.model`` as the LLM or Q-Former
    tokenizer, and a reference OpenSeeD ``.pt`` into the segmenter."""
    from openpsg_tpu_torch.models.relation.sp_tokenizer import (
        SentencePieceTokenizer,
        build_sp_model_bytes,
        build_toy_llama_tokenizer,
    )
    from openpsg_tpu_torch.utils.synthetic_weights import synthetic_openseed_state

    on_disk = tmp_path / "weights.model"
    if field == "openseed_pretrained_path":
        on_disk = tmp_path / "openseed.pt"
        seg_cfg = builder.psg_v4_config_from(
            Config.fromfile(os.path.join(PORT_CFGS, "tiny_v4_ov.py"))).segmenter
        state = synthetic_openseed_state(seg_cfg, lang_dim=16)
        torch.save({k: torch.from_numpy(v) for k, v in state.items()}, on_disk)
        extra = f"model = dict(openseed_pretrained_path={str(on_disk)!r})\n"
    elif field == "type":
        extra = "model = dict(type='Mask2FormerRelation')\n"
    else:
        toy = build_toy_llama_tokenizer(["person", "dog", "on"])
        on_disk.write_bytes(build_sp_model_bytes(toy.pieces))
        extra = f"model = dict(relation_head=dict({field}={str(on_disk)!r}))\n"
    p = tmp_path / "cfg.py"
    p.write_text(f"_base_ = ['{PORT_CFGS}/tiny_v4_ov.py']\n{extra}")
    if field == "type":
        with pytest.raises(ValueError, match="RelationTransformerHeadV4"):
            builder.build_detector_from_config(Config.fromfile(str(p)), device="cpu")
        p.write_text(f"_base_ = ['{PORT_CFGS}/tiny_v4_ov.py']\nmodel = dict(type='Mask2FormerRelation', "
                     "relation_head=dict(_delete_=True, type='RelationTransformerHead'))\n")
        model = builder.build_detector_from_config(Config.fromfile(str(p)), device="cpu")
        assert type(model).__name__ == "PSGMask2FormerRelation"
        assert model.cfg.head_version == "v1"
        return
    model = builder.build_detector_from_config(Config.fromfile(str(p)), device="cpu")
    if field == "openseed_pretrained_path":
        w = model.segmenter.backbone.patch_embed.weight
        np.testing.assert_array_equal(w.numpy(), state["backbone.patch_embed.proj.weight"])
    elif field == "llm_model_name":
        assert isinstance(model.tokenizer, SentencePieceTokenizer)
        assert model.qf_tokenizer is model.tokenizer
    else:
        assert isinstance(model.qf_tokenizer, SentencePieceTokenizer)
        assert not isinstance(model.tokenizer, SentencePieceTokenizer)


# ---------------------------------------------------------- preprocessing
@pytest.mark.parametrize("scale", [(1333, 1333), (1333, 800), (128, 128), (64, 64), (500, 700)])
def test_aspect_buckets_match_jax(scale):
    from openpsg_tpu.data.preprocess import aspect_buckets

    assert preprocess.aspect_buckets(scale) == aspect_buckets(scale)


@pytest.mark.parametrize("hw,bucket", [
    ((480, 640), None), ((375, 500), None), ((96, 64), None), ((2000, 1500), None),
    ((640, 480), None), ((640, 640), None),
    ((2666, 2000), None),            # exact 2x downscale (cv2 takes INTER_AREA)
    ((500, 375), (1024, 1344)),      # pinned bucket the resize does not fit: shrink
])
def test_preprocessor_matches_jax(hw, bucket):
    from openpsg_tpu.data.preprocess import Preprocessor as JaxPreprocessor
    from openpsg_tpu.data.preprocess import aspect_buckets

    img = np.random.default_rng(hw[0] * 7 + hw[1]).integers(0, 256, hw + (3,)).astype(np.uint8)
    buckets = aspect_buckets((1333, 1333))
    want_p = JaxPreprocessor(scale=(1333, 1333), buckets=buckets)
    got_p = preprocess.Preprocessor(scale=(1333, 1333), buckets=buckets)
    assert got_p.bucket_for(*hw) == want_p.bucket_for(*hw)
    assert got_p.rescale_size(*hw) == want_p.rescale_size(*hw)
    want, got = want_p(img, bucket=bucket), got_p(img, bucket=bucket)
    assert got["img_shape"] == want["img_shape"] and got["ori_shape"] == want["ori_shape"]
    np.testing.assert_array_equal(got["scale_factor"], want["scale_factor"])
    np.testing.assert_array_equal(got["image"], want["image"])
    if hw == (2666, 2000):
        assert tuple(2 * s for s in got["img_shape"]) == hw


def test_resize_linear_matches_cv2_on_random_sizes():
    rng = np.random.default_rng(0)
    for _ in range(60):
        h, w = (int(x) for x in rng.integers(1, 120, 2))
        nh, nw = (int(x) for x in rng.integers(1, 160, 2))
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        want = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(preprocess.resize_linear_u8(img, (nh, nw)), want,
                                      err_msg=f"{(h, w)} -> {(nh, nw)}")


def test_resize_nearest_matches_cv2():
    rng = np.random.default_rng(1)
    for _ in range(60):
        h, w = (int(x) for x in rng.integers(1, 200, 2))
        nh, nw = (int(x) for x in rng.integers(1, 300, 2))
        ids = rng.integers(0, 200_000, (h, w)).astype(np.float64)
        want = cv2.resize(ids, (nw, nh), interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(preprocess.resize_nearest(ids, (nh, nw)), want)


# ------------------------------------------------------------- panoptic ids
def test_panoptic_helpers_match_jax():
    from openpsg_tpu.utils import panoptic as jp

    rng = np.random.default_rng(2)
    ids = rng.integers(0, 256 ** 3, (17, 9))
    np.testing.assert_array_equal(panoptic.id2rgb(ids), jp.id2rgb(ids))
    rgb = rng.integers(0, 256, (5, 7, 3)).astype(np.uint8)
    np.testing.assert_array_equal(panoptic.rgb2id(rgb), jp.rgb2id(rgb))
    for seed in (None, 0, 3, 123):
        n = 40 if seed is not None else 0
        np.testing.assert_array_equal(panoptic.random_colors(n, seed=seed),
                                      jp.random_colors(n, seed=seed))
    np.testing.assert_array_equal(panoptic.random_colors(300, seed=5, forbid_black=False),
                                  jp.random_colors(300, seed=5, forbid_black=False))


# ---------------------------------------------------------------- PNG codec
def _png(pixels, colour_type, filters, palette=None):
    """A PNG with the given per-row filter types (a plain encoder)."""
    h, w = pixels.shape[:2]
    data = pixels.reshape(h, -1).astype(np.int64)
    bpp = data.shape[1] // w
    raw = bytearray()
    prev = np.zeros(data.shape[1], np.int64)
    for y in range(h):
        f, cur = filters[y % len(filters)], data[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            out = cur
        elif f == 1:
            out = cur - left
        elif f == 2:
            out = cur - prev
        elif f == 3:
            out = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            out = cur - pred
        raw += bytes([f]) + bytes((out & 255).astype(np.uint8))
        prev = cur
    chunk = lambda k, d: struct.pack(">I", len(d)) + k + d + struct.pack(
        ">I", zlib.crc32(k + d) & 0xFFFFFFFF)
    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0))
    if palette is not None:
        body += chunk(b"PLTE", palette.tobytes())
    return (image_io.PNG_SIGNATURE + body + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("colour_type", [2, 3, 6])
def test_png_reader_all_filters(colour_type, tmp_path):
    rng = np.random.default_rng(colour_type)
    h, w = 11, 7
    if colour_type == 3:
        palette = rng.integers(0, 256, (20, 3)).astype(np.uint8)
        pix = rng.integers(0, 20, (h, w)).astype(np.uint8)
        want = palette[pix]
    else:
        palette = None
        pix = rng.integers(0, 256, (h, w, 3 if colour_type == 2 else 4)).astype(np.uint8)
        want = pix[..., :3]
    data = _png(pix, colour_type, [0, 1, 2, 3, 4], palette)
    got = image_io.decode_png(data)
    np.testing.assert_array_equal(got, want)
    path = str(tmp_path / "filters.png")     # cv2 reads the same file the same way
    image_io.write_png(path, data)
    np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], want)


def test_png_codec_against_cv2_both_ways(tmp_path):
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[:61, :83]
    smooth = np.stack([yy * 3, xx * 2, (yy + xx) % 256], -1)
    rgb = np.clip(smooth + rng.integers(-3, 4, smooth.shape), 0, 255).astype(np.uint8)
    # cv2 writes (libpng's adaptive row filters) → the port reads
    for k, img in enumerate((rgb, rng.integers(0, 256, (40, 30, 3)).astype(np.uint8))):
        p = str(tmp_path / f"cv{k}.png")
        cv2.imwrite(p, img[..., ::-1])
        np.testing.assert_array_equal(image_io.read_png(p), img)
        rgba = np.concatenate([img[..., ::-1], img[..., :1]], -1)
        cv2.imwrite(p, rgba)
        np.testing.assert_array_equal(image_io.read_png(p), img)
    # the port writes → cv2 reads
    idx = rng.integers(0, 9, (37, 53)).astype(np.uint8)
    pal = rng.integers(0, 256, (9, 3)).astype(np.uint8)
    for k, (data, want) in enumerate(((image_io.encode_palette_png(idx, pal), pal[idx]),
                                      (image_io.encode_png_rgb(rgb), rgb))):
        p = str(tmp_path / f"port{k}.png")
        image_io.write_png(p, data)
        np.testing.assert_array_equal(cv2.imread(p)[..., ::-1], want)
        np.testing.assert_array_equal(image_io.read_png(p), want)
        np.testing.assert_array_equal(image_io.load_image_rgb(p), want)


# ---------------------------------------------------------------- submission
def test_submission_writer_matches_jax(tmp_path):
    from openpsg_tpu.utils.submission import SubmissionWriter as JaxWriter

    rng = np.random.default_rng(5)
    writers = {"jax": JaxWriter(str(tmp_path / "jax"), seed=3),
               "port": submission.SubmissionWriter(str(tmp_path / "port"), seed=3)}
    for test_idx in (3, 0, 2, 1, 4):          # out of order, as buckets give it
        h, w = (int(x) for x in rng.integers(20, 70, 2))
        oids = sorted(set(int(x) for x in rng.integers(0, 133, 6))) + [1007, 2016, 133]
        pan = rng.choice(np.asarray(oids + [133, 99999]), (h, w))
        rel = [] if test_idx == 4 else rng.integers(0, 5, (4, 3)).tolist()
        objs = [] if test_idx == 2 else oids
        for wr in writers.values():
            wr.add(pan, objs, rel, test_idx=test_idx)
    rel = {k: json.load(open(wr.finalize())) for k, wr in writers.items()}
    assert rel["port"] == rel["jax"]
    assert [r["pan_seg_file_name"] for r in rel["port"]] == [f"{i}.png" for i in range(5)]
    for r in rel["port"]:
        a, b = (cv2.imread(str(tmp_path / k / "submission" / "panseg" / r["pan_seg_file_name"]))
                for k in ("jax", "port"))
        np.testing.assert_array_equal(b, a)


def test_paint_index_matches_jax_native():
    from openpsg_tpu import native

    rng = np.random.default_rng(6)
    ids = rng.integers(-2, 40, (33, 21))
    for seg in ([], [5], [39, 3, 7, 3], list(range(0, 40, 3))):
        np.testing.assert_array_equal(submission.paint_index(ids, seg),
                                      native.paint_index(ids, seg))


# ----------------------------------------------------------------- scorers
def test_scorers_match_jax():
    from openpsg_tpu.eval.pq import panoptic_quality
    from openpsg_tpu.eval.sgg_metrics import sgg_recall

    from openpsg_tpu_torch.eval.pq import panoptic_quality as port_pq
    from openpsg_tpu_torch.eval.sgg_metrics import sgg_recall as port_recall

    rng = np.random.default_rng(7)
    pairs = []
    for _ in range(4):
        gt = rng.choice([133, 3, 1003, 60, 119], (30, 30))
        pred = np.where(rng.random((30, 30)) < 0.8, gt, rng.choice([133, 3, 60, 77], (30, 30)))
        pairs.append((pred, gt))
    a, b = port_pq(pairs), panoptic_quality(pairs)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
    images = []
    for pred, gt in pairs:
        ps, gs = np.unique(pred), np.unique(gt)
        images.append(dict(
            pred_masks=[pred == s for s in ps], gt_masks=[gt == s for s in gs],
            pred_labels=[int(s) % 1000 for s in ps], gt_labels=[int(s) % 1000 for s in gs],
            pred_triplets=rng.integers(0, len(ps), (30, 3)).tolist(),
            gt_triplets=rng.integers(0, len(gs), (5, 3)).tolist()))
    for per in (False, True):
        assert port_recall(images, per_predicate=per) == sgg_recall(images, per_predicate=per)


# ------------------------------------------------------ auto micro-batch
@settings(max_examples=60, deadline=None)
@given(steps=st.lists(st.one_of(st.none(), st.integers(0, 20)), max_size=40),
       threshold=st.integers(1, 16), k=st.integers(1, 6), hyst=st.integers(0, 4),
       mb=st.integers(2, 6))
def test_auto_mb_controller_matches_jax(steps, threshold, k, hyst, mb):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import infer as jax_infer
    finally:
        sys.path.pop(0)
    from openpsg_tpu_torch.tools.infer import AutoMBController

    a = AutoMBController(threshold, k, hyst, mb)
    b = jax_infer.AutoMBController(threshold, k, hyst, mb)
    for s in steps:
        a.observe(s)
        b.observe(s)
        assert a.decide() == b.decide()
    assert a.switches == b.switches and a.mode == b.mode


# ------------------------------------------------------------------ tracing
def test_device_busy_and_section_timer(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "model", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "model", "ts": 200, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "write", "ts": 100, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 20, "dur": 20},     # overlaps
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 150, "dur": 70},    # 20 inside
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 300},
    ]
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    assert profiling.device_busy(str(p), "model") == pytest.approx((50e-6, 200e-6))
    timer = profiling.SectionTimer()
    for name in ("a", "b", "a"):
        with timer.section(name):
            pass
    assert [len(timer.calls[k]) for k in ("a", "b")] == [2, 1]
    assert timer.total("a") == sum(timer.calls["a"]) and "a:" in timer.report()
