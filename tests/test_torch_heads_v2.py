"""The port's relation head v2 against the JAX package at tiny widths
(every expert, the MoE gate of both weight types, the inference cascade),
and the text KV store and the predicate descriptions it and head v1 read.

Inputs from a numpy seed; flax parameters bridged into the port's module;
float32 outputs at atol = rtol = 1e-4, lookups and texts exactly.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_heads_v123 import _f, bridged, close, rng_inputs

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

# ---------------------------------------------------------------- head v2
V2_CASES = {
    "all_moe_v1": dict(experts="all", use_moe_gate=True, moe_weight_type="v1"),
    "all_moe_v2": dict(experts="all", use_moe_gate=True, moe_weight_type="v2"),
    "two_moe_v2_mean_text": dict(experts=("object_vision_only", "pair_vision_only"),
                                 use_moe_gate=True, moe_weight_type="v2"),
    "ovo_and_pvo": dict(experts=("object_vision_only", "pair_vision_only")),
    "text_experts": dict(experts=("pair_text2vision", "pair_vision2text")),
}


@pytest.mark.parametrize("case", list(V2_CASES))
def test_head_v2(case):
    """Every expert on padded inputs (2 of 6 objects are pads), the gate per
    pair (v1) or per pair and relation (v2), with per-relation triplet text
    or (gate only) one triplet vector per pair; the inference cascade picks
    the same map."""
    from openpsg_tpu.models.relation.head_v2 import HeadV2Config as JC, RelationHeadV2 as JH

    from openpsg_tpu_torch.models.relation.head_v2 import (
        EXPERT_ORDER,
        HeadV2Config,
        RelationHeadV2,
    )

    kw = dict(V2_CASES[case])
    if kw["experts"] == "all":
        kw["experts"] = EXPERT_ORDER
    B, N, R, T = 1, 6, 56, 16
    x, mask = rng_inputs(B=B, N=N)
    rng = np.random.default_rng(5)
    text = {"pair_text_embeds": rng.normal(size=(B, N, N, T)).astype(np.float32)}
    if "triplet_text_w_vision" in kw["experts"]:
        text["triplet_text_embeds"] = rng.normal(size=(B, N, N, R, T)).astype(np.float32)
    elif kw.get("use_moe_gate"):
        text["triplet_text_embeds"] = rng.normal(size=(B, N, N, T)).astype(np.float32)
    jm = JH(JC.tiny_test(**kw))
    want, pm = bridged(jm, RelationHeadV2(HeadV2Config.tiny_test(**kw), 16, N), x, mask,
                         **text)
    got = pm(_f(x), _f(mask), **{k: _f(v) for k, v in text.items()})
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])
    close(RelationHeadV2.primary(got), JH.primary(want))


# ---------------------------------------------------------------- text, data
def test_text_kv_fallback_dbm_and_matrices(tmp_path):
    from openpsg_tpu.data.text_kv import TextKVStore as JaxKV

    from openpsg_tpu_torch.data.text_kv import TextKVStore, build_store

    rng = np.random.default_rng(7)
    names, rels = ["a", "b", "c"], ["on", "by"]
    table = {"a#b": rng.normal(size=8), "c#a": rng.normal(size=8),
             "a#b#on": rng.normal(size=8), "b#c#by": rng.normal(size=8),
             "x#y#on": rng.normal(size=8), "a#b#nope": rng.normal(size=8)}
    build_store(str(tmp_path / "kv.db"), table)
    store = TextKVStore(str(tmp_path / "kv.db"), embedding_size=8)
    assert store.get("missing").sum() == 0
    np.testing.assert_array_equal(store.get("a#b"), np.asarray(table["a#b"], np.float32))
    want = JaxKV(str(tmp_path / "kv.db"), embedding_size=8)
    np.testing.assert_array_equal(store.pair_matrix(names), want.pair_matrix(names))
    lut, tab = store.triplet_index(names, rels)
    jlut, jtab = want.triplet_index(names, rels)
    np.testing.assert_array_equal(lut, jlut)
    np.testing.assert_array_equal(tab, jtab)
    assert tab.shape == (3, 8) and not tab[0].any()
    np.testing.assert_array_equal(tab[lut], store.triplet_matrix(names, rels))
    store.close()
    want.close()


@pytest.mark.parametrize("semantic_type", ["relation_classes", "relation_description_v1",
                                           "relation_description_gpt4_v0"])
def test_predicate_descriptions(semantic_type):
    from openpsg_tpu.data.predicate_descriptions import get_descriptions as jax_get

    from openpsg_tpu_torch.data.predicate_descriptions import get_descriptions

    assert get_descriptions(semantic_type) == jax_get(semantic_type)
    sub = ["on", "beside", "not a predicate"]
    assert get_descriptions(semantic_type, sub) == jax_get(semantic_type, sub)
    assert get_descriptions(semantic_type, sub[:2]) == jax_get(semantic_type, sub[:2])
    if semantic_type == "relation_description_gpt4_v0":
        assert len(get_descriptions(semantic_type)[0]) > 200   # the vendored asset
