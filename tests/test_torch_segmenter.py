"""Port segmenter and fusion against the JAX package at the tiny config.

Weights: the JAX segmenter's init, through the bridge.  Float outputs at
atol=rtol=1e-4 (float32; only summation order differs); fusion ids,
survivors and labels exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpsg_tpu.models.detectors.psg_v4 import select_objects as jax_select_objects
from openpsg_tpu.models.segmenter.fusion import panoptic_fusion as jax_fusion
from openpsg_tpu.models.segmenter.openseed import OpenSeedSegmenter as JaxSeg
from openpsg_tpu.models.segmenter.openseed import SegmenterConfig as JaxSegCfg
from openpsg_tpu.models.segmenter.openseed import normalize_image as jax_normalize
from openpsg_tpu_torch.bridge import load_part
from openpsg_tpu_torch.models.detectors.psg_v4 import select_objects
from openpsg_tpu_torch.models.segmenter.fusion import panoptic_fusion
from openpsg_tpu_torch.models.segmenter.openseed import (
    OpenSeedSegmenter,
    SegmenterConfig,
    normalize_image,
)

TOL = dict(atol=1e-4, rtol=1e-4)
PPL = [None, (1, 2, 4)]


@pytest.fixture(scope="module")
def seg():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    ce = rng.normal(size=(133, 32)).astype(np.float32)
    ce /= np.linalg.norm(ce, axis=-1, keepdims=True)
    jm = JaxSeg(JaxSegCfg.tiny_test())
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.zeros((64, 64, 3)), jnp.asarray(ce))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    want, got = {}, {}
    for ppl in PPL:
        jcfg = dataclasses.replace(JaxSegCfg.tiny_test(), enc_points_per_level=ppl)
        fn = jax.jit(lambda p, x, c: JaxSeg(jcfg).apply(p, jax_normalize(x), c))
        want[ppl] = jax.device_get(fn(params, img, ce))
        port = OpenSeedSegmenter(
            dataclasses.replace(SegmenterConfig.tiny_test(), enc_points_per_level=ppl))
        load_part(port, "segmenter", params)
        with torch.no_grad():
            got[ppl] = port(normalize_image(torch.from_numpy(img)), torch.from_numpy(ce))
    return want, got


@pytest.mark.parametrize("ppl", PPL)
@pytest.mark.parametrize("key", ["cls_logits", "masks", "boxes", "mask_features"])
def test_segmenter_outputs(seg, ppl, key):
    want, got = seg
    np.testing.assert_allclose(got[ppl][key].numpy(), np.asarray(want[ppl][key]), **TOL)


def test_normalize_image():
    img = np.random.default_rng(1).integers(0, 256, (8, 6, 3)).astype(np.uint8)
    np.testing.assert_allclose(normalize_image(torch.from_numpy(img)).numpy(),
                               np.asarray(jax_normalize(jnp.asarray(img))), **TOL)


@pytest.mark.parametrize("iou_thr,region", [(0.8, None), (0.1, (64, 64)), (0.1, (50, 40)),
                                            (0.0, (64, 60))])
def test_fusion_exact(seg, iou_thr, region):
    want, _ = seg
    out = want[None]
    masks = np.asarray(jax.image.resize(jnp.asarray(out["masks"]), (20, 64, 64), "bilinear"))
    rm = None
    if region is not None:
        rm = (np.arange(64)[:, None] < region[0]) & (np.arange(64)[None, :] < region[1])
    j = jax_fusion(jnp.asarray(out["cls_logits"]), jnp.asarray(masks), cls_mode="sigmoid",
                   iou_thr=iou_thr, instance_mode="per_class",
                   region_mask=None if rm is None else jnp.asarray(rm))
    t = panoptic_fusion(torch.from_numpy(np.array(out["cls_logits"])),
                        torch.from_numpy(masks), iou_thr=iou_thr,
                        region_mask=None if rm is None else torch.from_numpy(rm))
    for name in ("pan_seg", "object_ids", "survive", "labels"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    for name in ("query_scores", "winner_score"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)), **TOL)


@pytest.mark.parametrize("survive,oids,M,cap", [
    ([1, 1, 0, 1, 1], [2005, 7, 7, 7, 1005], 8, 8),     # duplicate oids
    ([1] * 6, [15, 14, 13, 12, 11, 10], 8, 4),           # cap
    ([1, 0, 1], [3, 9, 3], 4, 4),                        # fewer queries than slots
])
def test_select_objects(survive, oids, M, cap):
    s, o = np.asarray(survive, bool), np.asarray(oids, np.int32)
    want = jax_select_objects(jnp.asarray(s), jnp.asarray(o), M, cap)
    got = select_objects(torch.from_numpy(s), torch.from_numpy(o), M, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
