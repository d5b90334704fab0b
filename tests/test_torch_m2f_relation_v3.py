"""The port's closed-set v3 detector with the open-vocabulary head
(``tiny_v3_ov.py``: Swin under the Mask2Former decoder, a non-causal
2-layer Llama trunk over the objects and the predicate-name sequence)
against the JAX package, through both builders and infer tools, at the
tiny config.  (The closed-vocabulary head is held in
``test_torch_heads_v123.py``.)

Weights: the JAX trees, through the bridge; ``object_mask_thr=0`` and
``iou_thr=0.1`` so the tiny random models keep several objects.  Integer
outputs are compared exactly, triplet scores at atol = rtol = 1e-4; the
tools' ``relation.json`` files and panoptic PNGs must be identical.
"""

import dataclasses

import jax
import numpy as np
import pytest

from openpsg_tpu_torch.bridge import load_jax_params
from openpsg_tpu_torch.core import builder
from openpsg_tpu_torch.core.config import Config
from tests.test_torch_m2f_relation import (
    KEEP_ALL,
    REPO,
    _tree,
    assert_same_result,
    assert_same_submission,
    gt_objects,
    run_case,
)


@pytest.fixture(scope="module")
def ov_setup(tmp_path_factory):
    from openpsg_tpu.core.builder import build_detector_from_config as jax_build
    from openpsg_tpu.core.config import Config as JaxConfig
    from tests.fixtures import make_fixture

    tmp = tmp_path_factory.mktemp("v3ov")
    root = tmp / "psg"
    ann = make_fixture(str(root), n_images=4, hw=(64, 64))
    cfgs = {}
    for side, base in (("jax", "configs/psg"), ("port", "openpsg_tpu_torch/configs/psg")):
        cfgs[side] = tmp / f"{side}_cfg.py"
        cfgs[side].write_text(f"_base_ = ['{REPO}/{base}/tiny_v3_ov.py']\n" + KEEP_ALL)
    jp = jax_build(JaxConfig.fromfile(str(cfgs["jax"])), jax.random.PRNGKey(0))
    model = builder.build_detector_from_config(Config.fromfile(str(cfgs["port"])), seed=0,
                                               device="cpu")
    load_jax_params(model, _tree(jp))
    jp.cfg = dataclasses.replace(jp.cfg, iou_thr=0.1)
    model.cfg = dataclasses.replace(model.cfg, iou_thr=0.1)
    img = np.random.default_rng(0).integers(0, 256, (64, 64, 3)).astype(np.float32)
    return dict(tmp=tmp, root=str(root), ann=ann, cfgs=cfgs, jp=jp, model=model, img=img,
                runs={})


def test_ov_layout_and_trunk(ov_setup):
    jp, model = ov_setup["jp"], ov_setup["model"]
    np.testing.assert_array_equal(model.rel_token_ids.numpy(), np.asarray(jp.rel_token_ids))
    np.testing.assert_array_equal(model.rel_spans.numpy(), np.asarray(jp.rel_spans))
    llm = model.cfg.head_v3.llm
    assert not llm.causal and llm.n_layers == 2 and model.cfg.head_v3.ov_relation
    assert not hasattr(model.head.llama.core, "lm_head")


@pytest.mark.parametrize("case", ["per_image", "gt_masks"])
def test_ov_tool_submission_identical(ov_setup, case):
    out_j, out_p, stats = run_case(ov_setup, case)
    recs = assert_same_submission(out_j, out_p, stats["n_images"])
    assert stats["n_images"] == 2
    assert sum(len(r["relations"]) for r in recs) >= 2


def test_ov_infer_gt_identical(ov_setup):
    jp, model, img = ov_setup["jp"], ov_setup["model"], ov_setup["img"]
    masks, oids, valid = gt_objects()
    want = jp.infer_gt(img, masks, oids, valid)
    got = model.infer_gt(img, masks, oids, valid)
    assert_same_result(got, want)
    assert len(got["rel_results"]["relation"]) == 100
