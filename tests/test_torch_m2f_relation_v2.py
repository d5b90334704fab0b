"""The port's closed-set v2 detector (every expert and the MoE gate, with a
text KV store) against the JAX package at the tiny config, on
ground-truth objects whose classes hit the store's keys (the fusion path is
the v1 and v3 detectors', held in ``test_torch_m2f_relation.py`` and
``test_torch_m2f_relation_v3.py``).

Weights: the JAX tree, through the bridge.  Integer outputs are compared
exactly, triplet scores at atol = rtol = 1e-4.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from openpsg_tpu_torch.bridge import load_jax_params
from openpsg_tpu_torch.data.text_kv import TextKVStore
from openpsg_tpu_torch.models.detectors.mask2former_relation import (
    M2FRelationConfig,
    PSGMask2FormerRelation,
)
from openpsg_tpu_torch.models.relation.head_v2 import EXPERT_ORDER, HeadV2Config
from tests.test_torch_m2f_relation import _tree, assert_same_result, gt_objects

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

T = 16   # the tiny text width


def kv_table():
    """Pair and triplet embeddings for some of the ground-truth objects'
    class pairs (person 0, dog 16, and the stuff classes 119, 125); every
    other key reads as zeros."""
    from openpsg_tpu_torch.data.vocab import OBJECT_CLASSES, RELATION_CLASSES

    rng = np.random.default_rng(5)
    names = [OBJECT_CLASSES[i] for i in (0, 16, 119, 125)]
    table = {}
    for a in names:
        for b in names[:3]:
            table[f"{a}#{b}"] = rng.normal(size=T).astype(np.float32)
            for r in RELATION_CLASSES[::7]:
                table[f"{a}#{b}#{r}"] = rng.normal(size=T).astype(np.float32)
    return table


@pytest.fixture(scope="module")
def v2_pair():
    from openpsg_tpu.data.text_kv import TextKVStore as JaxKV
    from openpsg_tpu.models.detectors.mask2former_relation import (
        M2FRelationConfig as JaxCfg,
        PSGMask2FormerRelation as JaxDet,
    )
    from openpsg_tpu.models.relation.head_v2 import HeadV2Config as JaxH2

    table = kv_table()
    jc = dataclasses.replace(JaxCfg.tiny_test("v2"), head_v2=JaxH2.tiny_test(
        experts=EXPERT_ORDER, use_moe_gate=True))
    jp = JaxDet(jc, jax.random.PRNGKey(0), text_kv=JaxKV(embedding_size=T, table=table))
    pc = dataclasses.replace(M2FRelationConfig.tiny_test("v2"), head_v2=HeadV2Config.tiny_test(
        experts=EXPERT_ORDER, use_moe_gate=True))
    model = PSGMask2FormerRelation(pc, device="cpu",
                                   text_kv=TextKVStore(embedding_size=T, table=table))
    load_jax_params(model, _tree(jp))
    img = np.random.default_rng(0).integers(0, 256, (64, 64, 3)).astype(np.float32)
    return jp, model, img


def test_v2_text_features_equal(v2_pair):
    jp, model, _ = v2_pair
    np.testing.assert_array_equal(model.pair_text_matrix.numpy(), np.asarray(jp.pair_text_matrix))
    np.testing.assert_array_equal(model.triplet_lookup.numpy(), np.asarray(jp.triplet_lookup))
    np.testing.assert_array_equal(model.triplet_table.numpy(), np.asarray(jp.triplet_table))
    assert model.triplet_table.shape[0] > 1


def test_v2_infer_gt_identical(v2_pair):
    """The ground-truth objects' classes hit the store's keys, so the pair
    and triplet experts and the gate see nonzero text."""
    jp, model, img = v2_pair
    masks, oids, valid = gt_objects()
    want = jp.infer_gt(img, masks, oids, valid)
    got = model.infer_gt(img, masks, oids, valid)
    assert_same_result(got, want)
    assert len(got["rel_results"]["relation"]) == 100
