"""The port's tools against the JAX package's, end to end on
``tests/fixtures.make_fixture`` at the tiny config.

One model pair: the JAX builder's model from ``configs/psg/tiny_v4_ov.py``,
and the port builder's from its copy, with the JAX weights bridged.  Each
case runs the JAX ``tools/infer.py`` and the port's tool once on the same
fixture and must give an identical ``relation.json`` and identical decoded
PNG pixels; the port's ``grade`` and ``eval_pq`` must print the JAX tools'
numbers on both submissions.  The test images have sizes whose keep-ratio
resize into the 128² scale is the identity, across three aspect buckets.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import cv2
import jax
import numpy as np
import pytest
import torch

from openpsg_tpu_torch.bridge import load_jax_params
from openpsg_tpu_torch.tools import eval_pq, grade, infer

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HWS = [(128, 96), (96, 128), (128, 128), (64, 128)]
CASES = {
    "per_image": [],
    "micro_batch": ["--micro-batch", "2"],
    "gt_masks": ["--gt-masks", "--single-bucket"],
}


def _jax_tool(name):
    sys.path.insert(0, os.path.join(REPO, "tools"))
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

    tmp = tmp_path_factory.mktemp("tools")
    root = tmp / "psg"
    ann = make_fixture(str(root), n_images=8, hw=HWS)
    override = "tpu = dict(input_hw=(128, 128))\n"
    cfgs = {}
    for side, base in (("jax", "configs/psg"), ("port", "openpsg_tpu_torch/configs/psg")):
        cfgs[side] = tmp / f"{side}_cfg.py"
        cfgs[side].write_text(f"_base_ = ['{REPO}/{base}/tiny_v4_ov.py']\n" + override)
    jp = jax_build(JaxConfig.fromfile(str(cfgs["jax"])), jax.random.PRNGKey(0))
    model = build_detector_from_config(Config.fromfile(str(cfgs["port"])), seed=0, device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, jax.device_get(jp.params)))
    return dict(tmp=tmp, root=str(root), ann=ann, cfgs=cfgs, jp=jp, model=model, runs={})


def _args(s, side, case, out):
    return (["--config", str(s["cfgs"][side]), "--test-file", s["ann"],
             "--data-dir", s["root"], "--output-dir", str(out),
             "--img-scale", "128", "128"] + CASES[case])


def run_case(s, case):
    """Both tools on one case, once per module → (jax stats, port stats,
    jax output dir, port output dir)."""
    if case not in s["runs"]:
        import openpsg_tpu.core.builder as jax_builder

        out_j, out_p = s["tmp"] / f"jax_{case}", s["tmp"] / f"port_{case}"
        with ThreadPoolExecutor(1) as pool, pytest.MonkeyPatch.context() as mp:
            # the port's tool in a thread, beside the JAX tool's run
            port = pool.submit(infer.main, _args(s, "port", case, out_p) + ["--device", "cpu"],
                               model=s["model"])
            mp.setattr(jax_builder, "build_detector_from_config", lambda cfg, rng: s["jp"])
            mp.setattr(sys, "argv", ["infer.py"] + _args(s, "jax", case, out_j))
            want = _jax_tool("infer").main()
        s["runs"][case] = (want, port.result(), out_j, out_p)
    return s["runs"][case]


@pytest.mark.parametrize("case", list(CASES))
def test_submission_identical(setup, case):
    want, got, out_j, out_p = run_case(setup, case)
    rel_j = json.load(open(out_j / "submission" / "relation.json"))
    rel_p = json.load(open(out_p / "submission" / "relation.json"))
    assert rel_p == rel_j
    assert len(rel_p) == 4
    assert sum(len(r["segments_info"]) for r in rel_p) >= 4
    for i, rec in enumerate(rel_p):
        a = cv2.imread(str(out_j / "submission" / "panseg" / rec["pan_seg_file_name"]))
        b = cv2.imread(str(out_p / "submission" / "panseg" / rec["pan_seg_file_name"]))
        assert b.shape[:2] == HWS[i]
        np.testing.assert_array_equal(b, a)
    for key in ("n_images", "micro_batch", "mb_switches"):
        assert got[key] == want[key], key
    if case == "micro_batch":
        assert got["micro_batch"] == 2
    if case == "gt_masks":
        assert all(len(r["segments_info"]) == 3 for r in rel_p)


def _printed_json(fn, *args):
    """The JSON object a tool prints as its last line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _jax_main(name, argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [f"{name}.py"] + argv)
        _jax_tool(name).main()


@pytest.mark.parametrize("case", list(CASES))
def test_grade_and_pq_identical(setup, case):
    """R@K, mR@K (grade) and PQ/SQ/RQ (eval_pq) printed by the port's tools
    equal the JAX tools' on both submissions of the case."""
    _, _, out_j, out_p = run_case(setup, case)
    for out in (out_j, out_p):
        argv = ["--submission", str(out), "--gt-json", setup["ann"], "--data-dir", setup["root"]]
        for tool, name in ((grade, "grade"), (eval_pq, "eval_pq")):
            got = _printed_json(tool.main, argv)
            assert got == _printed_json(_jax_main, name, argv), name


def test_auto_switch_mid_run(setup, tmp_path):
    """The controller switches to micro-batch 4 after 4 images whose median
    decode length (16 trips) crosses the threshold; the remaining 2 images
    are re-chunked into one padded chunk, and all 6 are written in order."""
    from tests.fixtures import make_fixture

    ann = make_fixture(str(tmp_path / "psg"), n_images=12, hw=(96, 128))
    stats = infer.main(["--config", str(setup["cfgs"]["port"]), "--test-file", ann,
                        "--data-dir", str(tmp_path / "psg"), "--output-dir", str(tmp_path),
                        "--img-scale", "128", "128", "--device", "cpu"],
                       model=setup["model"])
    assert stats["mb_switches"] == [(4, 4)] and stats["micro_batch"] == 4
    assert [len(v) for v in stats["sections"].values()] == [5, 5, 5]
    recs = json.load(open(stats["submission"]))
    assert [r["pan_seg_file_name"] for r in recs] == [f"{i}.png" for i in range(6)]


def test_tool_defaults_to_the_card(monkeypatch):
    """Without a card the tool raises unless ``--device cpu`` is given."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = os.path.join(REPO, "openpsg_tpu_torch", "configs", "psg", "tiny_v4_ov.py")
    with pytest.raises(RuntimeError, match="CUDA"):
        infer.main(["--config", cfg, "--test-file", "unused.json"])


def test_no_cv2_png_only_run(tmp_path):
    """Without cv2, PIL, JAX or the JAX package: the port writes a PNG
    fixture with its own codec, runs the tool on it on the CPU, reads the
    submission back and grades it."""
    code = f"""
import json, os, sys
for m in ('cv2', 'PIL', 'jax', 'flax', 'openpsg_tpu'):
    sys.modules[m] = None
sys.path.insert(0, {REPO!r})
import numpy as np
from openpsg_tpu_torch.utils.image_io import encode_png_rgb, write_png, image_decoder
from openpsg_tpu_torch.utils.panoptic import id2rgb
from openpsg_tpu_torch.tools import grade, infer
root = {str(tmp_path)!r}
rng = np.random.default_rng(0)
data = []
for i, (h, w) in enumerate([(64, 48), (48, 64)]):
    write_png(os.path.join(root, f"{{i}}.png"),
              encode_png_rgb(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)))
    pan = np.full((h, w), 7003)
    pan[: h // 2] = 7001
    write_png(os.path.join(root, f"pan{{i}}.png"), encode_png_rgb(id2rgb(pan)))
    data.append(dict(image_id=str(i), file_name=f"{{i}}.png", pan_seg_file_name=f"pan{{i}}.png",
                     height=h, width=w, relations=[[0, 1, 3]],
                     segments_info=[dict(id=7001, category_id=0, isthing=1),
                                    dict(id=7003, category_id=119, isthing=0)]))
ann = os.path.join(root, "psg.json")
json.dump(dict(data=data, test_image_ids=["0", "1"]), open(ann, "w"))
cfg = os.path.join({REPO!r}, "openpsg_tpu_torch/configs/psg/tiny_v4_ov.py")
out = os.path.join(root, "out")
stats = infer.main(["--config", cfg, "--test-file", ann, "--data-dir", root,
                    "--output-dir", out, "--img-scale", "64", "64", "--device", "cpu",
                    "--gt-masks"])
res = grade.main(["--submission", out, "--gt-json", ann, "--data-dir", root])
assert image_decoder().startswith("png"), image_decoder()
assert stats["n_images"] == 2 and res["R@20"] >= 0
bad = [m for m in sys.modules if m.split('.')[0] in ('cv2', 'PIL', 'jax', 'flax', 'openpsg_tpu')
       and sys.modules[m] is not None]
assert not bad, bad
print("OK", json.dumps(res))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    last = r.stdout.strip().splitlines()[-1]
    assert last.startswith("OK"), r.stdout[-2000:]
    assert set(json.loads(last[3:])) == {f"{m}@{k}" for m in ("R", "mR") for k in (20, 50, 100)}
