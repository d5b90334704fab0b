"""The port's closed-set relation head v1 against the JAX package at tiny
widths: attention / einsum scores, the predicate-prompt path with learnable
prompts and the graph, external predicate embeddings, the losses and
recall@20.  Head v2, the text KV store and the predicate descriptions are
in ``test_torch_heads_v2.py``, head v3 and the Llama's ``causal`` /
``truncate`` in ``test_torch_heads_v3.py``, the graph transformer and the
fusion module in ``test_torch_m2f_commons.py``.

Every case draws its inputs from a numpy seed, initializes the flax module,
bridges its parameters into the port's module and compares the outputs at
atol = rtol = 1e-4 (float32); integer outputs (token layouts, lookups) are
compared exactly.
"""

import jax
import numpy as np
import pytest
import torch

from openpsg_tpu_torch.bridge import load_part, scan_prefixes
from openpsg_tpu_torch.models.common import init_params

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


def _f(x):
    return torch.from_numpy(np.asarray(x))


def bridged(flax_module, port_module, *args, **kw):
    """Init the flax module on (args, kw), load its parameters into the
    port module, run the flax module on the same inputs (each compiled
    once: faster than op by op) → (the flax output, the port module)."""
    params = jax.jit(lambda k: flax_module.init(k, *args, **kw))(jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(np.asarray, params)
    init_params(port_module, torch.Generator().manual_seed(0))
    load_part(port_module.eval(), "m", tree, scanned=scan_prefixes(port_module, "m"))
    want = jax.jit(lambda p, a, k: flax_module.apply(p, *a, **k))(params, args, kw)
    return want, port_module


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def rng_inputs(B=1, N=6, C=16, n_valid=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    mask = np.arange(N)[None].repeat(B, 0) < n_valid
    return x, mask


# ---------------------------------------------------------------- head v1
@pytest.mark.parametrize("pred_type", ["attention", "einsum"])
def test_head_v1_bilinear(pred_type):
    from openpsg_tpu.models.relation.head_v1 import HeadV1Config as JC, RelationHeadV1 as JH

    from openpsg_tpu_torch.models.relation.head_v1 import HeadV1Config, RelationHeadV1

    x, mask = rng_inputs(B=2)
    jm = JH(JC.tiny_test(pred_type=pred_type))
    want, pm = bridged(jm, RelationHeadV1(HeadV1Config.tiny_test(pred_type=pred_type)), x, mask)
    got = pm(_f(x), _f(mask))
    assert hasattr(pm, "fc_input")    # 16-wide tokens, a 32-wide tower
    close(got, want)


@pytest.mark.parametrize("graph", [None, "base"])
def test_head_v1_prompt_path(graph):
    """Predicate descriptions through the in-head tower with per-relation
    learnable prompt rows, fused with the objects (einsum_v2)."""
    from openpsg_tpu.models.relation.head_v1 import HeadV1Config as JC, RelationHeadV1 as JH

    from openpsg_tpu_torch.data.predicate_descriptions import get_descriptions
    from openpsg_tpu_torch.models.relation.head_v1 import HeadV1Config, RelationHeadV1
    from openpsg_tpu_torch.models.relation.tokenizer import WordTokenizer
    from openpsg_tpu.models.commons.text_encoder import BertStyleConfig as JaxBert
    from openpsg_tpu_torch.models.commons.text_encoder import BertStyleConfig

    texts = get_descriptions("relation_description_v1")
    tok = WordTokenizer(texts)
    ids, msk = tok.encode_batch(texts, max_len=16)
    kw = dict(use_relation_prompts=True, fusion_pred_type="einsum_v2",
              graph_transformer_type=graph, use_learnable_prompts=True,
              learnable_prompts_size=3)
    x, mask = rng_inputs(N=5, C=32)
    V = max(64, tok.vocab_size)
    jm = JH(JC.tiny_test(encoder=JaxBert.tiny_test(vocab_size=V), **kw))
    pm = RelationHeadV1(HeadV1Config.tiny_test(encoder=BertStyleConfig.tiny_test(vocab_size=V),
                                               **kw), token_dim=32)
    want, pm = bridged(jm, pm, x, mask, semantic_token_ids=ids, semantic_token_mask=msk)
    got = pm(_f(x), _f(mask), semantic_token_ids=_f(ids), semantic_token_mask=_f(msk))
    assert not hasattr(pm, "fc_input")
    close(got, want)


def test_head_v1_external_semantic_embeds():
    from openpsg_tpu.models.relation.head_v1 import HeadV1Config as JC, RelationHeadV1 as JH

    from openpsg_tpu_torch.models.relation.head_v1 import HeadV1Config, RelationHeadV1

    x, mask = rng_inputs(N=4)
    sem = np.random.default_rng(3).normal(size=(56, 24)).astype(np.float32)
    jm = JH(JC.tiny_test(use_relation_prompts=True))
    pm = RelationHeadV1(HeadV1Config.tiny_test(use_relation_prompts=True), semantic_dim=24)
    want, pm = bridged(jm, pm, x, mask, semantic_embeds=sem)
    close(pm(_f(x), _f(mask), semantic_embeds=_f(sem)), want)
    assert not hasattr(pm, "sem_encoder")


@pytest.mark.parametrize("loss_type", ["v1", "v1_no_bs_limit", "v0_sigmoid", "v0_softmax"])
def test_head_v1_loss_and_recall(loss_type):
    from openpsg_tpu.models.relation.head_v1 import HeadV1Config as JC, RelationHeadV1 as JH

    from openpsg_tpu_torch.models.relation.head_v1 import HeadV1Config, RelationHeadV1

    rng = np.random.default_rng(4)
    B, R, N = 2, 56, 6
    pred = rng.normal(size=(B, R, N, N)).astype(np.float32) * 3
    target = np.zeros((B, R, N, N), np.float32)
    for b, r, s, o in rng.integers(0, [B, R, 4, 4], (9, 4)):
        target[b, r, s, o] = 1.0
    valid = np.arange(N)[None].repeat(B, 0) < np.asarray([[4], [5]])
    want = JH(JC.tiny_test(loss_type=loss_type)).loss(pred, target, valid)
    got = RelationHeadV1(HeadV1Config.tiny_test(loss_type=loss_type)).loss(
        _f(pred), _f(target), _f(valid))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **TOL)
