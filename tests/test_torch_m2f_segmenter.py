"""The port's Mask2Former segmenter and the ops it and the detector use,
against the JAX package: mask pooling (plain and chunked), per-object masks
from an id map, panoptic fusion's softmax-void and global-id modes, the
ResNet with frozen BatchNorm, the masked-attention decoder (its empty-gate
fallback included); and, at the published widths, every backbone's
parameter names and shapes against the flax tree (no weights built).  The
assembled segmenter's forward is in ``test_torch_m2f_trunk.py``.

Inputs from a numpy seed; flax parameters bridged; float32 outputs at
atol = rtol = 1e-4, integer outputs (ids, survivors, labels) exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpsg_tpu_torch.bridge import load_part, part_state_dict, scan_prefixes
from openpsg_tpu_torch.models.common import init_params
from openpsg_tpu_torch.models.segmenter.mask2former import (
    Mask2FormerConfig,
    Mask2FormerSegmenter,
)

TOL = dict(atol=1e-4, rtol=1e-4)


def _f(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(kw or TOL))


def bridged(port_module, params, part="segmenter"):
    init_params(port_module, torch.Generator().manual_seed(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    load_part(port_module.eval(), part, tree, scanned=scan_prefixes(port_module, part))
    return port_module


# ---------------------------------------------------------------- mask ops
def test_mask_pool_and_idmap():
    from openpsg_tpu.ops import mask_ops as jm

    from openpsg_tpu_torch.ops import mask_ops as pm

    rng = np.random.default_rng(0)
    feat = rng.normal(size=(8, 12, 10)).astype(np.float32)
    masks = rng.random((5, 12, 10)) < 0.3
    masks[2] = False
    close(pm.mask_pool(_f(feat), _f(masks)), jm.mask_pool(jnp.asarray(feat), jnp.asarray(masks)))
    idmap = rng.integers(0, 4, (12, 10)).astype(np.int32)
    oids = np.asarray([3, 0, 7, 1], np.int32)
    np.testing.assert_array_equal(pm.masks_from_idmap(_f(idmap), _f(oids)).numpy(),
                                  np.asarray(jm.masks_from_idmap(idmap, oids)))


@pytest.mark.parametrize("size", [1, 2, 3, 5])
def test_mask_pool_chunked(size):
    """The reference's S-chunked pooling: contiguous chunks of the masked
    pixels in scan order, tiled when a mask has fewer pixels than chunks,
    zero tokens for an empty mask."""
    from openpsg_tpu.ops.mask_ops import mask_pool_chunked as jax_pool

    from openpsg_tpu_torch.ops.mask_ops import mask_pool_chunked

    rng = np.random.default_rng(size)
    feat = rng.normal(size=(6, 9, 7)).astype(np.float32)
    masks = rng.random((6, 9, 7)) < 0.25
    masks[1] = False
    masks[2] = False
    masks[2, 4, 4] = True
    masks[3] = False
    masks[3, 0, :2] = True
    got = mask_pool_chunked(_f(feat), _f(masks), size)
    assert got.shape == (6, size, 6)
    close(got, jax_pool(jnp.asarray(feat), jnp.asarray(masks), size))


# ---------------------------------------------------------------- fusion
@pytest.mark.parametrize("cls_mode,instance_mode", [
    ("softmax_void", "global"),
    ("softmax_void", "per_class"),
    ("sigmoid", "global"),
    ("sigmoid", "per_class"),
])
def test_panoptic_fusion_modes(cls_mode, instance_mode):
    from openpsg_tpu.models.segmenter.fusion import panoptic_fusion as jax_fusion

    from openpsg_tpu_torch.models.segmenter.fusion import panoptic_fusion

    rng = np.random.default_rng(1)
    Q, K, H, W = 12, 9, 24, 20
    logits = rng.normal(size=(Q, K + (cls_mode == "softmax_void"))).astype(np.float32) * 3
    labels = rng.integers(0, K, Q)
    logits[np.arange(Q), labels] += 6.0                 # confident, repeated classes
    logits[0, -1] += 20.0                                # a void query (softmax_void)
    cy, cx = rng.integers(0, H, Q), rng.integers(0, W, Q)
    yy, xx = np.mgrid[:H, :W]
    masks = (6.0 - np.sqrt((yy[None] - cy[:, None, None]) ** 2
                           + (xx[None] - cx[:, None, None]) ** 2)).astype(np.float32)
    region = np.ones((H, W), bool)
    region[:, 17:] = False
    kw = dict(cls_mode=cls_mode, object_mask_thr=0.3, iou_thr=0.5, instance_mode=instance_mode,
              num_things=5)
    want = jax_fusion(jnp.asarray(logits), jnp.asarray(masks), region_mask=jnp.asarray(region), **kw)
    got = panoptic_fusion(_f(logits), _f(masks), region_mask=_f(region), **kw)
    for name in ("pan_seg", "object_ids", "survive", "labels"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("winner_score", "query_scores"):
        close(getattr(got, name), getattr(want, name))
    assert int(got.survive.sum()) >= 3


# ---------------------------------------------------------------- resnet
def test_resnet_frozen_bn():
    """The tiny ResNet (every block kind: stride-2 downsample, frozen BN
    with a drawn scale and shift, the -inf-padded max-pool) against flax."""
    from openpsg_tpu.models.segmenter.resnet import ResNet as JaxResNet

    from openpsg_tpu_torch.models.segmenter.resnet import ResNet

    img = np.random.default_rng(2).normal(size=(40, 48, 3)).astype(np.float32)
    jm = JaxResNet(depths=(1, 2, 1, 1), base_ch=8)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), img)
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32) * 0.1, params)
    want = jax.jit(jm.apply)(params, img)
    got = bridged(ResNet(depths=(1, 2, 1, 1), base_ch=8), params, "backbone")(_f(img))
    assert [tuple(g.shape) for g in got] == [(10, 12, 32), (5, 6, 64), (3, 3, 128), (2, 2, 256)]
    for g, w in zip(got, want):
        close(g, w)


# ---------------------------------------------------------------- decoder
@pytest.mark.parametrize("features", ["random", "constant"])
def test_masked_decoder(features):
    """The masked-attention decoder on three levels (coarsest first).  With
    constant mask features every query's gate is all or nothing, so some
    queries have an empty foreground and attend everywhere."""
    from openpsg_tpu.models.segmenter.mask2former_decoder import (
        Mask2FormerDecoder as JaxDecoder,
    )

    from openpsg_tpu_torch.models.common import mm_f32
    from openpsg_tpu_torch.models.segmenter.mask2former_decoder import Mask2FormerDecoder

    rng = np.random.default_rng(4)
    shapes = ((8, 6), (4, 3), (2, 2))
    memory = rng.normal(size=(sum(h * w for h, w in shapes), 32)).astype(np.float32)
    mf = rng.normal(size=(16, 12, 32)).astype(np.float32)
    if features == "constant":
        mf = np.broadcast_to(mf[0, 0], mf.shape).copy()
    jm = JaxDecoder(dim=32, num_queries=10, num_layers=4, num_heads=8, ffn_hidden=64,
                    mask_dim=32, num_classes=7)
    params = jax.jit(lambda k: jm.init(k, memory, shapes, mf))(jax.random.PRNGKey(0))
    want = jax.jit(lambda p: jm.apply(p, memory, shapes, mf))(params)
    pm = bridged(Mask2FormerDecoder(32, 10, 4, 8, 64, 32, 7), params, "decoder")
    got = pm(_f(memory), shapes, _f(mf))
    for k in ("cls_logits", "masks", "query_embed"):
        close(got[k], want[k])
    if features == "constant":
        layer = pm.layers[0]
        emb = layer.mask_head(layer.gate_norm(pm.query_embed))
        fg = mm_f32(emb, _f(mf[0, 0])[None], "qc,pc->qp")[:, 0] > 0
        assert 0 < int(fg.sum()) < 10     # some queries fall back, some do not


@pytest.mark.parametrize("backbone", ["r50", "swin_t", "swin_b"])
def test_full_width_parameter_layout(backbone):
    """At the published widths (100 queries, 6 encoder and 9 decoder layers,
    the reference's FFN widths) every flax leaf maps onto exactly one port
    parameter of the same shape: the flax tree from ``jax.eval_shape`` (no
    weights), the port module on the meta device."""
    from openpsg_tpu.models.segmenter.mask2former import (
        Mask2FormerConfig as JaxCfg,
        Mask2FormerSegmenter as JaxSeg,
    )

    kw = dict(backbone=backbone, enc_ffn_hidden=1024)
    shapes = jax.eval_shape(JaxSeg(JaxCfg(**kw)).init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((64, 64, 3), jnp.float32))
    with torch.device("meta"):
        pm = Mask2FormerSegmenter(Mask2FormerConfig(**kw))
    tree = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    sd = part_state_dict("segmenter", tree, scanned=scan_prefixes(pm, "segmenter"))
    ref = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert {k: v.shape for k, v in sd.items()} == ref
    assert len(pm.decoder.layers) == 9 and len(pm.pixel_decoder.layers) == 6
