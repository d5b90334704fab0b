"""The port's per-image PSG v4 path against the JAX package at the tiny
config, plus the port's package rules (no JAX import, the card by default).

Weights: the JAX tree, through the bridge.  ``iou_thr=0.1`` so the tiny
random model keeps several objects (one of them a second instance of its
class).  Integer outputs and ``postprocess`` dicts are compared exactly;
relation scores (sigmoid probabilities, float32) at atol=1e-5.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpsg_tpu.models.detectors.psg_v4 import PSGv4 as JaxPSGv4
from openpsg_tpu.models.detectors.psg_v4 import PSGv4Config as JaxPSGv4Config
from openpsg_tpu_torch import resolve_device
from openpsg_tpu_torch.bridge import load_jax_params
from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HWS = [(64, 64), (56, 60)]


@pytest.fixture(scope="module")
def pair():
    jp = JaxPSGv4(dataclasses.replace(JaxPSGv4Config.tiny_test(), iou_thr=0.1),
                  jax.random.PRNGKey(0))
    model = PSGv4(dataclasses.replace(PSGv4Config.tiny_test(), iou_thr=0.1),
                  seed=0, device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, jax.device_get(jp.params)))
    img = np.random.default_rng(0).integers(0, 256, (64, 64, 3)).astype(np.uint8)
    return jp, model, img


def _jax_dev(jp, img, hw, budget):
    return jax.device_get(jp._infer_jit(jp.params, jnp.asarray(img),
                                        jnp.asarray(hw, jnp.int32), jnp.int32(budget)))


@pytest.mark.parametrize("hw", HWS)
def test_postprocess_identical(pair, hw):
    jp, model, img = pair
    want = jp.postprocess(_jax_dev(jp, img, hw, jp.cfg.max_new_tokens))
    got = model.infer(img, hw)
    assert got["rel_results"] == want["rel_results"]
    assert len(want["rel_results"]["object_id_list"]) >= 3
    np.testing.assert_array_equal(got["pan_results"], want["pan_results"])
    np.testing.assert_allclose(got["rel_scores"], want["rel_scores"], atol=1e-5)
    assert got["decode_steps"] == want["decode_steps"]


@pytest.mark.parametrize("hw", HWS)
def test_device_outputs(pair, hw):
    jp, model, img = pair
    want = _jax_dev(jp, img, hw, jp.cfg.max_new_tokens)
    seg = model.segment(torch.from_numpy(img))
    sel = model.fuse_select(seg, hw)
    out, prefix, pmask = model.tail_pre(seg["mask_features"], *sel)
    toks, scores, trips = model.tail_decode(prefix, pmask)
    for key in ("pan_seg", "object_ids", "object_valid", "object_labels",
                "fusion_pass_count", "top_pair_idx", "mc_triplets"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(want[key]), err_msg=key)
    for key in ("object_scores", "top_pair_scores", "mc_scores"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(want[key]), atol=1e-4,
                                   rtol=1e-4, err_msg=key)
    np.testing.assert_array_equal(toks.numpy(), want["gen_tokens"])
    np.testing.assert_allclose(scores.numpy(), want["gen_scores"], atol=1e-4, rtol=1e-4)
    assert trips == int(want["decode_trips"])


@pytest.mark.parametrize("budget", [0, 2])
def test_trip_budget_is_a_runtime_argument(pair, budget):
    jp, model, img = pair
    want = _jax_dev(jp, img, HWS[0], budget)
    got = model.infer(img, HWS[0], trip_budget=budget)
    assert got["decode_steps"] == int(want["decode_trips"]) == budget
    assert got["rel_results"] == jp.postprocess(want)["rel_results"]


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        PSGv4(PSGv4Config.tiny_test())
    assert resolve_device("cpu").type == "cpu"


def test_package_imports_without_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['openpsg_tpu'] = None\n"
        "import openpsg_tpu_torch\n"
        "for m in pkgutil.walk_packages(openpsg_tpu_torch.__path__, 'openpsg_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'openpsg_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_chip_smoke_refuses_without_a_card_or_the_package(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO), (str(alone), tmp_path)):
        r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
