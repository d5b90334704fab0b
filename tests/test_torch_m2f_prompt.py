"""v1's optional paths against the JAX package at the tiny config: the
predicate-prompt path (``tiny_r50_prompt.py``: GPT-4 predicate descriptions
through the in-head text tower, the einsum_v2 fusion) through both
packages' builders and infer tools; the object-token embellishments and
the option combinations the detector refuses.

Weights: the JAX tree, through the bridge; ``object_mask_thr=0`` and
``iou_thr=0.1`` so the tiny random model keeps several objects.  The
tools' ``relation.json`` files and panoptic PNGs must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpsg_tpu_torch.bridge import load_jax_params
from openpsg_tpu_torch.core import builder
from openpsg_tpu_torch.core.config import Config
from openpsg_tpu_torch.models.detectors.mask2former_relation import (
    M2FRelationConfig,
    PSGMask2FormerRelation,
)
from tests.test_torch_m2f_relation import (
    KEEP_ALL,
    REPO,
    TOL,
    _tree,
    assert_same_submission,
    run_case,
)

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def prompt_setup(tmp_path_factory):
    """tiny_r50_prompt.py (v1 with GPT-4 predicate descriptions through the
    in-head text tower and the einsum_v2 fusion) through both builders."""
    from openpsg_tpu.core.builder import build_detector_from_config as jax_build
    from openpsg_tpu.core.config import Config as JaxConfig
    from tests.fixtures import make_fixture

    tmp = tmp_path_factory.mktemp("prompt")
    root = tmp / "psg"
    ann = make_fixture(str(root), n_images=4, hw=(64, 64))
    cfgs = {}
    for side, base in (("jax", "configs/psg"), ("port", "openpsg_tpu_torch/configs/psg")):
        cfgs[side] = tmp / f"{side}_cfg.py"
        cfgs[side].write_text(f"_base_ = ['{REPO}/{base}/tiny_r50_prompt.py']\n" + KEEP_ALL)
    jp = jax_build(JaxConfig.fromfile(str(cfgs["jax"])), jax.random.PRNGKey(0))
    model = builder.build_detector_from_config(Config.fromfile(str(cfgs["port"])), seed=0,
                                               device="cpu")
    load_jax_params(model, _tree(jp))
    jp.cfg = dataclasses.replace(jp.cfg, iou_thr=0.1)
    model.cfg = dataclasses.replace(model.cfg, iou_thr=0.1)
    img = np.random.default_rng(0).integers(0, 256, (64, 64, 3)).astype(np.float32)
    return dict(tmp=tmp, root=str(root), ann=ann, cfgs=cfgs, jp=jp, model=model, img=img,
                runs={})


def test_prompt_tokens_equal(prompt_setup):
    jp, model = prompt_setup["jp"], prompt_setup["model"]
    np.testing.assert_array_equal(model.sem_token_ids.numpy(), np.asarray(jp.sem_token_ids))
    np.testing.assert_array_equal(model.sem_token_mask.numpy(), np.asarray(jp.sem_token_mask))
    assert model.cfg.head_v1.encoder.vocab_size == jp.cfg.head_v1.encoder.vocab_size


@pytest.mark.parametrize("case", ["per_image", "gt_masks"])
def test_prompt_tool_submission_identical(prompt_setup, case):
    out_j, out_p, stats = run_case(prompt_setup, case)
    recs = assert_same_submission(out_j, out_p, stats["n_images"])
    assert stats["n_images"] == 2
    assert sum(len(r["relations"]) for r in recs) >= 2


def test_object_tokens_embellishments():
    """The optional v1 token paths (sine positional encoding, inverse-mask
    background feature, class concatenation, no class, S-chunked tokens)
    against the JAX ``_object_tokens`` on the same features and masks."""
    from openpsg_tpu.models.detectors.mask2former_relation import (
        M2FRelationConfig as JaxCfg,
        PSGMask2FormerRelation as JaxDet,
    )

    rng = np.random.default_rng(0)
    mf = rng.normal(size=(16, 16, 32)).astype(np.float32)
    masks = rng.random((8, 16, 16)) < 0.3
    masks[5] = False                      # an empty object
    masks[6] = False
    masks[6, 3, 4] = True                 # a one-pixel object (fewer pixels than chunks)
    labels = np.asarray([0, 3, 7, 1, 2, 5, 4, 6], np.int32)
    table = rng.normal(size=(8, 32)).astype(np.float32)
    for knobs, chunked in (
        (dict(use_positional_encoding=True), False),
        (dict(use_background_feature=True), False),
        (dict(use_positional_encoding=True, use_background_feature=True), False),
        (dict(merge_cls_type="cat"), False),
        (dict(embedding_add_cls=False), False),
        (dict(object_token_size=3, use_background_feature=True), True),
    ):
        jd = JaxDet.__new__(JaxDet)
        jd.cfg = dataclasses.replace(JaxCfg.tiny_test(), **knobs)
        want = jd._object_tokens(jnp.asarray(table), jnp.asarray(mf), jnp.asarray(masks),
                                 jnp.asarray(labels), chunked)
        pd = PSGMask2FormerRelation.__new__(PSGMask2FormerRelation)
        pd.cfg = dataclasses.replace(M2FRelationConfig.tiny_test(), **knobs)
        pd.object_cls_embed = torch.from_numpy(table)
        got = pd.object_tokens(torch.from_numpy(mf), torch.from_numpy(masks),
                               torch.from_numpy(labels), chunked)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=str(knobs), **TOL)


def test_invalid_combos_raise():
    cfg = M2FRelationConfig.tiny_test()
    for bad in (dict(use_positional_encoding=True, merge_cls_type="cat"),
                dict(use_background_feature=True, merge_cls_type="cat")):
        with pytest.raises(ValueError, match="merge_cls_type"):
            PSGMask2FormerRelation(dataclasses.replace(cfg, **bad), device="cpu")
    with pytest.raises(ValueError, match="object_token_size"):
        PSGMask2FormerRelation(dataclasses.replace(M2FRelationConfig.tiny_test("v2"),
                                                   object_token_size=2), device="cpu")
