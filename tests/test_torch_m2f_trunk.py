"""The port's assembled Mask2Former segmenter (backbone → deformable pixel
decoder → masked-attention decoder) against the JAX package on the tiny
ResNet backbone (the tiny Swin one runs inside every tiny detector test):
inputs from a numpy seed, flax parameters bridged, float32 outputs at
atol = rtol = 1e-4.
"""

import dataclasses

import jax
import numpy as np
import pytest

from openpsg_tpu_torch.models.segmenter.mask2former import (
    Mask2FormerConfig,
    Mask2FormerSegmenter,
)
from tests.test_torch_m2f_segmenter import _f, bridged, close


@pytest.mark.parametrize("backbone", ["tiny_r50"])
def test_segmenter_forward(backbone):
    from openpsg_tpu.models.segmenter.mask2former import (
        Mask2FormerConfig as JaxCfg,
        Mask2FormerSegmenter as JaxSeg,
    )

    extra = dict(backbone=backbone, num_queries=10, enc_layers=2, enc_ffn_hidden=48)
    img = np.random.default_rng(5).normal(size=(64, 64, 3)).astype(np.float32)
    jm = JaxSeg(dataclasses.replace(JaxCfg.tiny_test(), **extra))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), img)
    want = jax.jit(jm.apply)(params, img)
    pm = bridged(Mask2FormerSegmenter(dataclasses.replace(Mask2FormerConfig.tiny_test(),
                                                          **extra)), params)
    got = pm(_f(img))
    assert tuple(got["masks"].shape) == (10, 16, 16) and got["cls_logits"].shape[-1] == 9
    for k in ("cls_logits", "masks", "mask_features", "query_embed"):
        close(got[k], want[k])
