"""Port relation head v4, Q-Former and the pair/top-k helpers against the
JAX package.  Floats at atol=rtol=1e-4 (float32); indices and token ids
exact, including on inputs with deliberate ties (the JAX rule: the lower
index wins)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpsg_tpu.data.vocab import OBJECT_CLASSES, RELATION_CLASSES
from openpsg_tpu.models.relation import head_v4 as J
from openpsg_tpu.models.relation.tokenizer import build_prompt_tokenizer as jax_tokenizer
from openpsg_tpu_torch.bridge import load_part
from openpsg_tpu_torch.models.relation import head_v4 as T
from openpsg_tpu_torch.models.relation.tokenizer import build_prompt_tokenizer

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


def _head_inputs(seed=0, M=8, H4=16, C=32, n_valid=5):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(H4, H4, C)).astype(np.float32)
    yy, xx = np.mgrid[:H4, :H4]
    masks = np.zeros((M, H4, H4), bool)
    for i in range(M):
        cy, cx, r = rng.integers(0, H4, 2).tolist() + [int(rng.integers(2, 6))]
        masks[i] = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    masks[2] = False                      # a valid object with an empty mask
    valid = np.arange(M) < n_valid
    text_ids = rng.integers(0, 64, (M * M, 8)).astype(np.int32)
    text_mask = np.arange(8)[None, :] < rng.integers(3, 9, (M * M, 1))
    return feats, masks, valid, text_ids, text_mask


@pytest.fixture(scope="module")
def head():
    cfg = J.HeadV4Config.tiny_test()
    jm = J.RelationHeadV4(cfg)
    args = _head_inputs()
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), *(jnp.asarray(a) for a in args))
    want = jax.device_get(jax.jit(jm.apply)(params, *(jnp.asarray(a) for a in args)))
    port = T.RelationHeadV4(T.HeadV4Config.tiny_test(), mask_dim=32)
    load_part(port, "head", jax.tree_util.tree_map(np.asarray, jax.device_get(params)))
    targs = [torch.from_numpy(np.array(a)) for a in args]
    with torch.no_grad():
        got = port(*targs)
        got_plain = port(*targs, plain_attention=True)
    return want, got, got_plain


@pytest.mark.parametrize("key", ["qformer_out", "binary_logits", "multiclass_logits",
                                 "llm_visual_tokens"])
def test_head_outputs(head, key):
    want, got, got_plain = head
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL)
    np.testing.assert_allclose(got_plain[key].numpy(), np.asarray(want[key]), **TOL)


def test_pair_mask_exact(head):
    want, got, _ = head
    np.testing.assert_array_equal(got["pair_mask"].numpy(), np.asarray(want["pair_mask"]))


def _tied_logits(seed, NP=64, R=None):
    rng = np.random.default_rng(seed)
    shape = (NP,) if R is None else (NP, R)
    return rng.integers(-2, 3, shape).astype(np.float32)   # few distinct values


@pytest.mark.parametrize("seed,k", [(0, 4), (1, 20), (2, 64)])
def test_select_topk_pairs_ties(seed, k):
    logits = _tied_logits(seed)
    valid = np.random.default_rng(seed + 10).random(64) < 0.3   # many -inf ties
    wi, ws = J.select_topk_pairs(jnp.asarray(logits), jnp.asarray(valid), k)
    gi, gs = T.select_topk_pairs(torch.from_numpy(logits), torch.from_numpy(valid), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)


@pytest.mark.parametrize("seed,k", [(0, 10), (1, 100)])
def test_multiclass_topk_triplets_ties(seed, k):
    logits = _tied_logits(seed, NP=64, R=7)
    valid = np.random.default_rng(seed + 20).random(64) < 0.5
    wt, ws = J.multiclass_topk_triplets(jnp.asarray(logits), jnp.asarray(valid), 8, k=k)
    gt, gs = T.multiclass_topk_triplets(torch.from_numpy(logits), torch.from_numpy(valid), 8, k=k)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)


@pytest.fixture(scope="module")
def tables():
    names = list(OBJECT_CLASSES) + list(RELATION_CLASSES)
    jt, tt = jax_tokenizer(names), build_prompt_tokenizer(names)
    out = {}
    for tpl, n in (("Is there a relation between {} and {}?", 16),
                   ("What are the relations between {} and {}? Assistant: ", 20)):
        out[tpl] = (J.build_instruction_table(jt, OBJECT_CLASSES, tpl, n),
                    T.build_instruction_table(tt, OBJECT_CLASSES, tpl, n))
    return jt, tt, out


def test_tokenizer_copy_matches(tables):
    jt, tt, _ = tables
    assert jt.itos == tt.itos
    for s in ("What are the relations between person and sky? Assistant: ",
              "on  in front of", "unknownword ?"):
        assert jt.encode(s) == tt.encode(s)
        assert jt.decode(jt.encode(s) + [3, 5]) == tt.decode(tt.encode(s) + [3, 5])


def test_instruction_tables_and_assembly(tables):
    _, _, out = tables
    rng = np.random.default_rng(4)
    sub, obj = rng.integers(0, 133, 30).astype(np.int32), rng.integers(0, 133, 30).astype(np.int32)
    for jp, tp in out.values():
        for key in ("pre", "mid", "post", "names"):
            np.testing.assert_array_equal(tp[key], jp[key])
        assert (tp["max_len"], tp["pad_id"]) == (jp["max_len"], jp["pad_id"])
        wi, wm = J.assemble_pair_instructions(jp, jnp.asarray(sub), jnp.asarray(obj))
        gi, gm = T.assemble_pair_instructions(tp, torch.from_numpy(sub), torch.from_numpy(obj))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        wi2, wm2 = J.right_align(wi, wm)
        gi2, gm2 = T.right_align(gi, gm)
        np.testing.assert_array_equal(gi2.numpy(), np.asarray(wi2))
        np.testing.assert_array_equal(gm2.numpy(), np.asarray(wm2))
