"""The port's ``predict``, ``parse_predict`` and ``pvsg`` tools against the
JAX package's on bridged tiny weights (``configs/psg/tiny_v4_ov.py``, its
64² bucket).

``predictions.json`` must be the JAX tool's (relation scores within TOL,
everything else exactly) and the panoptic PNGs' pixels identical; the
parsed triplets identical; the PVSG records identical at batch 2 (one pad)
and 1; the extracted frames byte-equal.  Both predict tools restore a part
checkpoint with the head group alone as the target, so a checkpoint
holding another group is refused on both sides (F8).
"""

import contextlib
import copy
import dataclasses
import glob
import json
import os
import pathlib
import re
import subprocess
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

from openpsg_tpu_torch.bridge import load_jax_params
from openpsg_tpu_torch.tools import parse_predict, predict
from openpsg_tpu_torch.tools.pvsg import extractor, infer_video

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HWS = [(64, 48), (48, 64), (64, 64)]   # the keep-ratio resize into 64² is the identity
TOL = dict(rtol=0, atol=1e-5)          # relation scores: the same float32
                                       # arithmetic in another order


def _jax_tool(name, subdir=""):
    sys.path.insert(0, os.path.join(REPO, "tools", subdir))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from openpsg_tpu.core.builder import build_detector_from_config as jax_build
    from openpsg_tpu.core.config import Config as JaxConfig
    from tests.fixtures import make_fixture

    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config

    tmp = tmp_path_factory.mktemp("predict")
    root = tmp / "psg"
    ann = make_fixture(str(root), n_images=3, hw=HWS)
    cfgs = {"jax": os.path.join(REPO, "configs/psg/tiny_v4_ov.py"),
            "port": os.path.join(REPO, "openpsg_tpu_torch/configs/psg/tiny_v4_ov.py")}
    jp = jax_build(JaxConfig.fromfile(cfgs["jax"]), jax.random.PRNGKey(0))
    model = build_detector_from_config(Config.fromfile(cfgs["port"]), seed=0, device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, jax.device_get(jp.params)))
    # the configs leave iou_thr at 0.8; 0.1 keeps several objects of the
    # tiny random model (set before the JAX program is first traced)
    jp.cfg = dataclasses.replace(jp.cfg, iou_thr=0.1)
    model.cfg = dataclasses.replace(model.cfg, iou_thr=0.1)
    return dict(tmp=tmp, root=str(root), ann=ann, cfgs=cfgs, jp=jp, model=model, runs={})


@contextlib.contextmanager
def jax_tool_on(s, argv):
    """The JAX tool's builder patched to hand over the bridged pair's JAX
    model (its params restored afterwards), ``sys.argv`` set."""
    import openpsg_tpu.core.builder as jax_builder

    saved = dict(s["jp"].params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_builder, "build_detector_from_config", lambda cfg, rng: s["jp"])
        mp.setattr(sys, "argv", ["tool.py"] + argv)
        try:
            yield
        finally:
            s["jp"].params.clear()
            s["jp"].params.update(saved)


def run_predict(s, key, extra=()):
    """Both predict tools once per key → (jax output dir, port output dir)."""
    if key not in s["runs"]:
        out = {side: s["tmp"] / f"{key}_{side}" for side in ("jax", "port")}
        args = lambda side: ["--config", s["cfgs"][side], "--input-json", s["ann"],
                             "--data-dir", s["root"], "--output-dir", str(out[side])] + list(extra)
        with jax_tool_on(s, args("jax")):
            _jax_tool("predict").main()
        predict.main(args("port") + ["--device", "cpu"], model=copy.deepcopy(s["model"]))
        s["runs"][key] = out["jax"], out["port"]
    return s["runs"][key]


def assert_same_predictions(out_j, out_p):
    want = json.loads((out_j / "predictions.json").read_text())
    got = json.loads((out_p / "predictions.json").read_text())
    assert len(got) == len(want) == len(HWS)
    for g, w, hw in zip(got, want, HWS):
        np.testing.assert_allclose(g.pop("relation_scores"), w.pop("relation_scores"), **TOL)
        assert g == w
        a = cv2.imread(str(out_p / "panseg" / g["pan_seg_file_name"]))
        b = cv2.imread(str(out_j / "panseg" / w["pan_seg_file_name"]))
        assert a.shape[:2] == hw
        np.testing.assert_array_equal(a, b)
    return got


def test_predictions_equal_jax(setup):
    got = assert_same_predictions(*run_predict(setup, "plain"))
    assert [r["pan_seg_file_name"] for r in got] == ["0.png", "1.png", "2.png"]
    assert sum(len(r["segments_info"]) for r in got) >= 3
    assert all(r >= 1 for rec in got for _, _, r in rec["relations"])
    assert all(rec["image_id"] == str(i) for i, rec in enumerate(got))


def _save_checkpoints(s, groups):
    """The same head (scaled by 0.5, so a restore shows) in a JAX orbax
    part checkpoint and a port one, plus ``groups``' other members →
    (jax dir, port dir)."""
    from openpsg_tpu.train.checkpoint import PartCheckpointer as JaxCheckpointer

    from openpsg_tpu_torch.train.checkpoint import PartCheckpointer

    tag = "_".join(groups)
    dirs = s["tmp"] / f"ck_{tag}_jax", s["tmp"] / f"ck_{tag}_port"
    tree = {g: jax.tree_util.tree_map(lambda x: np.asarray(x) * 0.5, s["jp"].params[g])
            for g in groups}
    ck = JaxCheckpointer(str(dirs[0]))
    ck.save(1, tree, opt_state={"count": np.int32(1)}, meta={"epoch": 1})
    ck.close()
    m = copy.deepcopy(s["model"])
    load_jax_params(m, dict(jax.tree_util.tree_map(np.asarray, jax.device_get(s["jp"].params)),
                            **tree))
    named = {f"{g}.{n}": p for g in groups for n, p in m.param_groups()[g].items()}
    zeros = {k: torch.zeros_like(v) for k, v in named.items()}
    PartCheckpointer(str(dirs[1])).save(1, named, {"count": 1, "mu": zeros, "nu": zeros},
                                        meta={"epoch": 1})
    return dirs


def test_head_checkpoint_restores_like_jax(setup):
    ck_j, ck_p = _save_checkpoints(setup, ["head"])
    out_j, out_p = setup["tmp"] / "head_jax", setup["tmp"] / "head_port"
    args = lambda out: ["--input-json", setup["ann"], "--data-dir", setup["root"],
                        "--output-dir", str(out)]
    with jax_tool_on(setup, ["--config", setup["cfgs"]["jax"], "--checkpoint", str(ck_j)]
                     + args(out_j)):
        _jax_tool("predict").main()
    model = copy.deepcopy(setup["model"])
    predict.main(["--config", setup["cfgs"]["port"], "--checkpoint", str(ck_p), "--device",
                  "cpu"] + args(out_p), model=model)
    assert_same_predictions(out_j, out_p)
    head = setup["model"].param_groups()["head"]
    assert all(torch.equal(p, head[n] * 0.5) for n, p in model.param_groups()["head"].items())


def test_f8_checkpoint_with_more_than_the_head_is_refused(setup, tmp_path):
    """F8: both predict tools (and both PVSG tools) restore with the head
    alone as the target; orbax refuses a checkpoint holding another group
    (here the trained LLM of a selfcheck-style {head, llm} checkpoint), and
    so does the port."""
    ck_j, ck_p = _save_checkpoints(setup, ["head", "llm"])
    args = lambda out: ["--input-json", setup["ann"], "--data-dir", setup["root"],
                        "--output-dir", str(tmp_path / out)]
    with jax_tool_on(setup, ["--config", setup["cfgs"]["jax"], "--checkpoint", str(ck_j)]
                     + args("j")):
        with pytest.raises(ValueError, match="do not match"):
            _jax_tool("predict").main()
    model = copy.deepcopy(setup["model"])
    with pytest.raises(ValueError, match="head group alone.*llm"):
        predict.main(["--config", setup["cfgs"]["port"], "--checkpoint", str(ck_p),
                      "--device", "cpu"] + args("p"), model=model)
    with pytest.raises(ValueError, match="head group alone"):
        infer_video.main(["--config", setup["cfgs"]["port"], "--checkpoint", str(ck_p),
                          "--frames-dir", str(tmp_path), "--device", "cpu"], model=model)


def test_parse_predict_equal_jax(setup):
    out_j, out_p = run_predict(setup, "plain")
    jax_parse = _jax_tool("parse_predict")
    got_all = json.loads((out_p / "predictions.json").read_text())
    want_all = json.loads((out_j / "predictions.json").read_text())
    n = 0
    for g_rec, w_rec in zip(got_all, want_all):
        got = parse_predict.parse_record(g_rec, str(out_p / "panseg"))
        want = jax_parse.parse_record(w_rec, str(out_j / "panseg"))
        assert len(got) == len(want) == len(g_rec["relations"])
        for g, w in zip(got, want):
            for key in ("subject", "relation", "object"):
                assert g[key] == w[key]
            np.testing.assert_array_equal(g["sub_mask"], w["sub_mask"])
            np.testing.assert_array_equal(g["obj_mask"], w["obj_mask"])
            assert g["sub_mask"].any() and g["obj_mask"].any()
            assert abs(g["score"] - w["score"]) <= TOL["atol"]
        n += len(got)
    assert n > 0
    parse_predict.main(["--predictions", str(out_p / "predictions.json"),
                        "--panseg-dir", str(out_p / "panseg")])


@pytest.mark.parametrize("batch", [2, 1])
def test_infer_video_equal_jax(setup, batch):
    frames = setup["tmp"] / "frames"
    if not frames.exists():
        # video a: 3 frames (a pad at batch 2), video b: 2 frames
        for video, idx in (("a", [0, 1, 2]), ("b", [2, 0])):
            os.makedirs(frames / video)
            for k, i in enumerate(idx):
                img = cv2.imread(os.path.join(setup["root"], "images", f"{i}.jpg"))
                cv2.imwrite(str(frames / video / f"{k:04d}.png"), img)
    out_j, out_p = setup["tmp"] / f"pvsg_{batch}_jax.json", setup["tmp"] / f"pvsg_{batch}.json"
    args = ["--frames-dir", str(frames), "--batch-size", str(batch)]
    with jax_tool_on(setup, ["--config", setup["cfgs"]["jax"], "--output", str(out_j)] + args):
        _jax_tool("infer_video", "pvsg").main()
    got = infer_video.main(["--config", setup["cfgs"]["port"], "--output", str(out_p),
                            "--device", "cpu"] + args, model=setup["model"])
    want = json.loads(out_j.read_text())
    assert json.loads(out_p.read_text()) == got
    assert sorted(got) == ["a", "b"] and [len(got[v]) for v in "ab"] == [3, 2]
    for v in "ab":
        for g, w in zip(got[v], want[v]):
            np.testing.assert_allclose(g.pop("relation_scores"), w.pop("relation_scores"),
                                       **TOL)
            assert g == w
    assert any(g["relations"] for v in "ab" for g in got[v])


def test_extractor_frames_byte_equal_jax(tmp_path, monkeypatch):
    videos = tmp_path / "videos"
    os.makedirs(videos)
    rng = np.random.default_rng(0)
    writer = cv2.VideoWriter(str(videos / "clip.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 5,
                             (48, 32))
    assert writer.isOpened()
    for _ in range(5):
        writer.write(rng.integers(0, 256, (32, 48, 3)).astype(np.uint8))
    writer.release()
    assert _jax_tool("extractor", "pvsg").extract(str(videos), str(tmp_path / "j"), "avi") == 5
    assert extractor.main(["--video-dir", str(videos), "--image-dir", str(tmp_path / "p"),
                           "--ext", "avi"]) == 5
    names = sorted(os.listdir(tmp_path / "j" / "clip"))
    assert names == [f"{i:04d}.png" for i in range(5)]
    assert sorted(os.listdir(tmp_path / "p" / "clip")) == names
    for n in names:
        assert (tmp_path / "p" / "clip" / n).read_bytes() == \
            (tmp_path / "j" / "clip" / n).read_bytes()
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="needs cv2"):
        extractor.extract(str(videos), str(tmp_path / "q"), "avi")


NEW_TOOLS = ("serve", "predict", "parse_predict", "pvsg/extractor", "pvsg/infer_video",
             "selfcheck_openset", "bench_stages", "probe_msda_variants", "bench_train",
             "bench_family", "bench_host")


def test_port_sources_import_no_jax():
    """No source of the port, and not ``chip_smoke.py``, imports JAX, its
    libraries or the JAX package; and the new tools' ``--help`` runs with
    those (and cv2) unimportable, each defaulting to the card."""
    pattern = re.compile(r"^\s*(?:import|from)\s+(?:jax|flax|optax|orbax|openpsg_tpu)(?:[.\s]|$)",
                         re.M)
    files = glob.glob(os.path.join(REPO, "openpsg_tpu_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(REPO, "chip_smoke.py"))
    for name in NEW_TOOLS:
        assert os.path.join(REPO, "openpsg_tpu_torch", "tools", name + ".py") in files
    bad = [f for f in files if pattern.search(pathlib.Path(f).read_text(encoding="utf-8"))]
    assert not bad, bad
    code = (
        "import sys, contextlib, io, importlib\n"
        "for m in ('jax', 'flax', 'optax', 'orbax', 'openpsg_tpu', 'cv2'):\n"
        "    sys.modules[m] = None\n"
        f"for name in {[n.replace('/', '.') for n in NEW_TOOLS]!r}:\n"
        "    tool = importlib.import_module('openpsg_tpu_torch.tools.' + name)\n"
        "    with contextlib.redirect_stdout(io.StringIO()) as out:\n"
        "        try:\n"
        "            tool.main(['--help'])\n"
        "        except SystemExit as e:\n"
        "            assert e.code == 0, (name, e.code)\n"
        "    assert ('--device' in out.getvalue()) == (name not in (\n"
        "        'parse_predict', 'pvsg.extractor')), name\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
    for tool, argv in ((predict, ["--config", "c", "--input-json", "j"]),
                       (infer_video, ["--config", "c", "--frames-dir", "f"])):
        assert tool.parse_args(argv).device == "cuda"
