"""The port's class-name language encoder against the JAX package's
(``openpsg_tpu/models/segmenter/language.py``), alone with bridged weights
(float32, ≤ 1e-5) and inside ``PSGv4`` (the class embeddings it computes,
and a precomputed ``.npy`` taken without renormalization); plus ``PSGv4``
with a custom vocabulary and the options ``input_hw``, ``fusion_stride``
and ``decode_early_exit`` against the JAX model, exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpsg_tpu.models.detectors.psg_v4 import PSGv4 as JaxPSGv4
from openpsg_tpu.models.detectors.psg_v4 import PSGv4Config as JaxPSGv4Config
from openpsg_tpu.models.segmenter.language import TextEncoder as JaxTextEncoder
from openpsg_tpu.models.segmenter.language import encode_names as jax_encode_names
from openpsg_tpu_torch import bridge
from openpsg_tpu_torch.data.vocab import OBJECT_CLASSES
from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config
from openpsg_tpu_torch.models.segmenter.language import TextEncoder, encode_names

TOL = 1e-5   # float32 on both sides; summation order and erf differ
NAMES = list(OBJECT_CLASSES) + [
    "A Class Name Longer Than Thirty-Two Bytes, Cut There", "Crème Brûlée", ""]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def test_encode_names_matches_jax():
    got = encode_names(NAMES)
    np.testing.assert_array_equal(got, jax_encode_names(NAMES))
    assert got.dtype == np.int32 and got.shape == (len(NAMES), 32)
    assert (got[-1] == 256).all() and (got[-3] != 256).all()


@pytest.mark.parametrize("dim", [32, 512])
def test_text_encoder_matches_jax(dim):
    """dim 32: the tiny config's proj_dim (8 heads of 4); 512: the full
    width's."""
    tokens = jax_encode_names(NAMES)
    enc = JaxTextEncoder(dim=dim)
    params = enc.init(jax.random.PRNGKey(dim), jnp.asarray(tokens))
    want = np.asarray(enc.apply(params, jnp.asarray(tokens)))
    port = TextEncoder(dim=dim)
    assert bridge.load_part(port, "text", _np(params)) == len(jax.tree_util.tree_leaves(params))
    with torch.no_grad():
        got = port(torch.from_numpy(tokens)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got[:-1], axis=-1), 1.0, atol=1e-5)
    assert not got[-1].any()                 # an empty name pools nothing


@pytest.fixture(scope="module")
def tiny_jax():
    return JaxPSGv4(JaxPSGv4Config.tiny_test(), jax.random.PRNGKey(0))


def test_psgv4_class_embeds_come_from_the_encoder(tiny_jax):
    params = _np(tiny_jax.params)
    model = PSGv4(PSGv4Config.tiny_test(), seed=0, device="cpu")
    tokens = torch.from_numpy(encode_names(OBJECT_CLASSES))
    with torch.no_grad():
        np.testing.assert_array_equal(model.class_embeds.numpy(), model.text(tokens).numpy())
        bridge.load_jax_params(model, params)
        got = model.text(tokens).numpy()
    np.testing.assert_allclose(got, params["class_embeds"], atol=TOL, rtol=0)


def test_precomputed_class_embeds_taken_as_is(tmp_path):
    mat = np.random.default_rng(0).normal(size=(133, 32)).astype(np.float32) * 3.0
    path = str(tmp_path / "class_embeds.npy")
    np.save(path, mat)
    jp = JaxPSGv4(JaxPSGv4Config.tiny_test(), jax.random.PRNGKey(0),
                  precomputed_class_embeds=path)
    model = PSGv4(PSGv4Config.tiny_test(), seed=0, device="cpu", precomputed_class_embeds=path)
    np.testing.assert_array_equal(np.asarray(jp.params["class_embeds"]), mat)
    np.testing.assert_array_equal(model.class_embeds.numpy(), mat)


CLASSES = ["cat", "dog", "person", "car", "tree", "sky", "road", "grass"]
RELATIONS = ["on", "near", "holding", "in front of"]


def _options(cfg):
    return dataclasses.replace(cfg, iou_thr=0.1, input_hw=(64, 64), fusion_stride=2,
                               decode_early_exit=False, max_new_tokens=3)


@pytest.fixture(scope="module")
def vocab_pair():
    kw = dict(class_names=CLASSES, relation_names=RELATIONS, num_things=4)
    jp = JaxPSGv4(_options(JaxPSGv4Config.tiny_test()), jax.random.PRNGKey(3), **kw)
    model = PSGv4(_options(PSGv4Config.tiny_test()), seed=3, device="cpu", **kw)
    bridge.load_jax_params(model, _np(jp.params))
    return jp, model


@pytest.mark.parametrize("hw", [(64, 64), (50, 61)])
def test_custom_vocabulary_and_options_match_jax(vocab_pair, hw):
    jp, model = vocab_pair
    assert model._model_hw() == jp._model_hw() == (64, 64)
    assert model.num_things == jp.num_things == 4
    assert model.relation_names == RELATIONS and model.class_names == CLASSES
    img = np.random.default_rng(hw[1]).integers(0, 256, (64, 64, 3)).astype(np.uint8)
    want = jp.infer(img, hw)
    got = model.infer(img, hw)
    np.testing.assert_array_equal(got["pan_results"], want["pan_results"])
    assert got["rel_results"] == want["rel_results"]
    np.testing.assert_allclose(got["rel_scores"], want["rel_scores"], atol=1e-5)
    assert got["decode_steps"] == want["decode_steps"] == 3      # pinned decode
    assert len(got["rel_results"]["object_id_list"]) >= 1
    assert all(o % 1000 < len(CLASSES) for o in got["rel_results"]["object_id_list"])


def test_fusion_stride_past_4_is_refused():
    """Once refused, a stride past 4 is ported: the stride-4 masks shrink
    with the antialiased resize the JAX package uses (held against it in
    tests/test_torch_fusion_stride.py); the id map comes back at the
    image's resolution, constant on each 8 × 8 cell."""
    model = PSGv4(dataclasses.replace(PSGv4Config.tiny_test(), fusion_stride=8), device="cpu")
    img = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (64, 64, 3)).astype(np.uint8))
    pan = model.fuse_select(model.segment(img), (64, 64))[5]
    assert pan.shape == (64, 64)
    cells = pan.reshape(8, 8, 8, 8)
    assert (cells == cells[:, :1, :, :1]).all()
