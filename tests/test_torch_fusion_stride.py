"""``fusion_stride`` past 4 against the JAX package: the stride-4 masks
shrink with an antialiased bilinear resize, as ``jax.image.resize`` does;
stride 8 and 16 against the JAX ``_seg_stage`` (integers exact, floats
within 1e-5)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpsg_tpu.models.detectors.psg_v4 import PSGv4 as JaxPSGv4
from openpsg_tpu.models.detectors.psg_v4 import PSGv4Config as JaxPSGv4Config
from openpsg_tpu_torch.bridge import load_jax_params
from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

TOL = 1e-5
_np = lambda tree: jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def jax_model():
    return JaxPSGv4(dataclasses.replace(JaxPSGv4Config.tiny_test(), iou_thr=0.1),
                    jax.random.PRNGKey(8))


@pytest.mark.parametrize("stride", [8, 16])
def test_fusion_stride_past_4_matches_jax(jax_model, stride):
    jp = jax_model
    # the stride is read when the stage is traced: one model serves both
    jp.cfg = dataclasses.replace(jp.cfg, fusion_stride=stride)
    model = PSGv4(dataclasses.replace(PSGv4Config.tiny_test(), fusion_stride=stride,
                                      iou_thr=0.1), seed=0, device="cpu")
    load_jax_params(model, _np(jp.params))
    seg_stage = jax.jit(lambda p, img, hw: jp._seg_stage(p, img, hw))
    kept = 0
    for hw in [(64, 64), (50, 61)]:
        img = np.random.default_rng(hw[1]).integers(0, 256, (64, 64, 3)).astype(np.uint8)
        want = _np(seg_stage(jp.params, jnp.asarray(img, jnp.float32), jnp.asarray(hw)))
        seg = model.segment(torch.from_numpy(img))
        got = [t.numpy() for t in model.fuse_select(seg, hw)]
        # (mask_features, object_masks, valid, labels, sel_oid, obj_scores,
        #  pan_full, pass_count) against (object_masks, valid, labels,
        #  sel_oid, obj_scores, pan_seg, pass_count)
        np.testing.assert_allclose(seg["mask_features"].numpy(), want[0], atol=TOL, rtol=0)
        for i, (g, w) in enumerate(zip(got, want[1:])):
            if i == 4:
                np.testing.assert_allclose(g, w, atol=TOL, rtol=0)
            else:
                np.testing.assert_array_equal(g, w)
        pan = got[5]
        assert pan.shape == (64, 64)
        blocks = pan.reshape(64 // stride, stride, 64 // stride, stride)
        assert (blocks == blocks[:, :1, :, :1]).all()      # constant on each stride cell
        kept += int(got[1].sum())
        # the shrunk masks themselves, within 1e-5 of jax.image.resize
        small = seg["masks"][:5]
        resized = torch.nn.functional.interpolate(
            small[None], size=(64 // stride,) * 2, mode="bilinear", align_corners=False,
            antialias=True)[0]
        ref = jax.image.resize(jnp.asarray(small.numpy()), (5, 64 // stride, 64 // stride),
                               method="bilinear")
        np.testing.assert_allclose(resized.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    assert kept >= 1
