"""The port's PSG v4 entry points against the JAX package at the tiny
config, plus the port's package rules (no JAX import, the card by default).

Weights: the JAX tree, through the bridge.  ``iou_thr=0.1`` so the tiny
random model keeps several objects (one of them a second instance of its
class).  Integer outputs and ``postprocess`` dicts are compared exactly;
relation scores (sigmoid probabilities, float32) at atol=1e-5.

The deployment program (``infer_microbatch``) runs the tiny config with an
int8 LLM (``quant``, ``act_int8``) against JAX ``make_pipelined_infer``; the
GT-mask ablation (``infer_gt``) runs on the same models.
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
from openpsg_tpu_torch.models.llm.llama import QDense

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


def _quant(cfg):
    return dataclasses.replace(cfg, iou_thr=0.1, llm=dataclasses.replace(
        cfg.llm, quant=True, act_int8=True))


@pytest.fixture(scope="module")
def quant_pair():
    jp = JaxPSGv4(_quant(JaxPSGv4Config.tiny_test()), jax.random.PRNGKey(1))
    model = PSGv4(_quant(PSGv4Config.tiny_test()), seed=1, device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, jax.device_get(jp.params)))
    rng = np.random.default_rng(11)
    imgs = rng.integers(0, 256, (3, 64, 64, 3)).astype(np.float32)
    hws = np.asarray([[64, 64], [58, 61], [60, 64]], np.int32)
    return jp, model, imgs, hws


def _recording_postprocess(model, monkeypatch):
    """Record the host dicts ``postprocess`` receives (device outputs)."""
    seen, real = [], model.postprocess
    monkeypatch.setattr(model, "postprocess", lambda dev: seen.append(dev) or real(dev))
    return seen


@pytest.mark.parametrize("n", [2, 3])
def test_microbatch_matches_jax_pipelined(quant_pair, n, monkeypatch):
    """One flattened prefill + decode over N images' top-K pairs.  Prefill
    rows are N·K·(R + Lp): N=2 stays under the 256-row act_int8 rule (every
    product weight-only), N=3 crosses it (int8 activations in prefill)."""
    jp, model, imgs, hws = quant_pair
    c = model.cfg
    rows = n * c.head.top_pairs * (c.head.qformer.num_relation_queries
                                   + model.llm_parts["max_len"])
    assert (rows >= QDense.ACT_INT8_MIN_ROWS) == (n == 3), rows
    int8_calls = []
    real_int_mm = torch._int_mm
    monkeypatch.setattr(torch, "_int_mm",
                        lambda a, b: int8_calls.append(a.shape[0]) or real_int_mm(a, b))
    seen = _recording_postprocess(model, monkeypatch)
    got = model.infer_microbatch(imgs[:n], hws[:n])
    assert int8_calls == ([rows] * 7 * c.llm.n_layers if n == 3 else [])
    dev = jax.device_get(jp.make_pipelined_infer()(
        jp.params, jnp.asarray(imgs[:n]), jnp.asarray(hws[:n])))
    assert len(got) == n
    for i in range(n):
        want_dev = jax.tree_util.tree_map(lambda x: x[i], dev)
        want = jp.postprocess(want_dev)
        assert got[i]["rel_results"] == want["rel_results"]
        np.testing.assert_array_equal(got[i]["pan_results"], want["pan_results"])
        np.testing.assert_allclose(got[i]["rel_scores"], want["rel_scores"], atol=1e-5)
        assert got[i]["decode_steps"] == int(dev["decode_trips"][i]) == int(dev["decode_trips"][0])
        for key in ("gen_tokens", "top_pair_idx", "mc_triplets"):
            np.testing.assert_array_equal(seen[i][key], np.asarray(want_dev[key]), err_msg=key)
    assert sum(len(r["rel_results"]["object_id_list"]) for r in got) >= 3


def test_microbatch_trip_budget_is_a_runtime_argument(quant_pair):
    _, model, imgs, hws = quant_pair
    for budget in (0, 2):
        got = model.infer_microbatch(imgs[:2], hws[:2], trip_budget=budget)
        assert [r["decode_steps"] for r in got] == [budget, budget]


def test_infer_batch_equals_infer(quant_pair):
    _, model, imgs, hws = quant_pair
    for got, img, hw in zip(model.infer_batch(imgs, hws), imgs, hws):
        want = model.infer(img, hw)
        np.testing.assert_array_equal(got["pan_results"], want["pan_results"])
        assert got["rel_results"] == want["rel_results"]
        assert got["rel_scores"] == want["rel_scores"]
        assert got["decode_steps"] == want["decode_steps"]


def test_infer_gt_matches_jax(quant_pair):
    """GT masks replace fusion (psg_v4.py:558-605): overlapping masks (the
    first valid one paints), an invalid slot with a mask, void pixels."""
    jp, model, imgs, _ = quant_pair
    M = model.cfg.head.max_objects_padded
    masks = np.zeros((M, 64, 64), bool)
    masks[0, :32, :] = True
    masks[1, 24:, :40] = True
    masks[2, 40:, 30:] = True
    masks[3, :, 60:] = True                    # slot 3 is not valid
    oids = np.zeros((M,), np.int64)
    oids[:4] = [7, 16 + 1000, 119, 55]
    valid = np.zeros((M,), bool)
    valid[:3] = True
    want = jp.infer_gt(imgs[0], masks, oids, valid)
    got = model.infer_gt(imgs[0], masks, oids, valid)
    assert got["rel_results"]["object_id_list"] == [7, 1016, 119]
    assert got["rel_results"] == want["rel_results"]
    np.testing.assert_array_equal(got["pan_results"], want["pan_results"])
    assert (got["pan_results"] == 133).any()
    np.testing.assert_allclose(got["rel_scores"], want["rel_scores"], atol=1e-5)
    assert got["decode_steps"] == want["decode_steps"]


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        PSGv4(PSGv4Config.tiny_test())
    assert resolve_device("cpu").type == "cpu"


def test_package_imports_without_jax():
    """Every module of the port, its configs (the v4 ones and the closed-set
    family's, through ``Config.fromfile``, which runs their imports and
    ``custom_imports``) and the infer, train and converter tools'
    ``--help``, with JAX, flax, optax, orbax, the JAX package, cv2,
    PIL, transformers and safetensors unimportable."""
    code = (
        "import sys, importlib, pkgutil, contextlib, io\n"
        "BLOCKED = ('jax', 'flax', 'optax', 'orbax', 'openpsg_tpu', 'cv2', 'PIL', 'transformers',\n"
        "           'safetensors')\n"
        "for m in BLOCKED:\n"
        "    sys.modules[m] = None\n"
        "import openpsg_tpu_torch\n"
        "for m in pkgutil.walk_packages(openpsg_tpu_torch.__path__, 'openpsg_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from openpsg_tpu_torch.core.config import Config\n"
        "import os\n"
        "names = sorted(os.listdir('openpsg_tpu_torch/configs/psg'))\n"
        "assert len(names) == 12, names\n"
        "for name in names:\n"
        "    Config.fromfile('openpsg_tpu_torch/configs/psg/' + name)\n"
        "from openpsg_tpu_torch.tools import (convert_mask2former, convert_openseed,\n"
        "                                     convert_relation, infer, train)\n"
        "for tool, flag in ((infer, '--vis'), (train, '--max-steps'),\n"
        "                   (convert_openseed, '--merges'), (convert_relation, '--verify'),\n"
        "                   (convert_mask2former, '--backbone')):\n"
        "    with contextlib.redirect_stdout(io.StringIO()) as out:\n"
        "        try:\n"
        "            tool.main(['--help'])\n"
        "        except SystemExit as e:\n"
        "            assert e.code == 0, e.code\n"
        "    assert flag in out.getvalue()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in BLOCKED\n"
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
