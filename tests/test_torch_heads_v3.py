"""The port's closed-set relation head v3 (closed and open vocabulary,
causal or not, with former layers, the predicate token layout) and the
Llama's ``causal`` / ``truncate`` against the JAX package at tiny widths:
inputs from a numpy seed, flax parameters bridged, float32 outputs at
atol = rtol = 1e-4, token layouts exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from openpsg_tpu_torch.bridge import load_part, scan_prefixes
from openpsg_tpu_torch.models.common import init_params
from tests.test_torch_heads_v123 import _f, bridged, close, rng_inputs


V3_CASES = {
    "closed_causal": dict(),
    "closed_full_attention": dict(causal=False),
    "ov": dict(ov_relation=True, causal=False),
    "ov_formers_multiply": dict(ov_relation=True, num_object_in_layers=1,
                                num_object_out_layers=1, num_relation_out_layers=1,
                                sub_obj_merge_type="multiply"),
}


@pytest.mark.parametrize("case", list(V3_CASES))
def test_head_v3(case):
    from openpsg_tpu.data.vocab import RELATION_CLASSES
    from openpsg_tpu.models.relation.head_v3 import (
        HeadV3Config as JC,
        RelationHeadV3 as JH,
        build_relation_token_layout as jax_layout,
    )
    from openpsg_tpu.models.relation.tokenizer import build_prompt_tokenizer as jax_tok

    from openpsg_tpu_torch.models.relation.head_v3 import (
        HeadV3Config,
        RelationHeadV3,
        build_relation_token_layout,
    )
    from openpsg_tpu_torch.models.relation.tokenizer import build_prompt_tokenizer

    kw = dict(V3_CASES[case])
    causal = kw.pop("causal", True)
    jc = JC.tiny_test(**kw)
    jc = dataclasses.replace(jc, llm=dataclasses.replace(jc.llm, causal=causal))
    pc = HeadV3Config.tiny_test(**kw)
    pc = dataclasses.replace(pc, llm=dataclasses.replace(pc.llm, causal=causal))
    ids, spans = build_relation_token_layout(build_prompt_tokenizer(), list(RELATION_CLASSES))
    jids, jspans = jax_layout(jax_tok(), RELATION_CLASSES)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(spans, jspans)
    x, mask = rng_inputs(B=2, N=5)
    mask[1, 3] = False                                  # images with 4 and 3 objects
    extra = dict(relation_token_ids=ids, relation_spans=spans) if jc.ov_relation else {}
    jm = JH(jc)
    want, pm = bridged(jm, RelationHeadV3(pc), x, mask, **extra)
    got = pm(_f(x), _f(mask), **{k: _f(v) for k, v in extra.items()})
    close(got, want)


def test_llama_causal_flag_and_truncate():
    """``LlamaConfig.causal=False`` attends to every valid key; ``truncate``
    keeps the first layers; ``max_seq_len`` is the JAX default."""
    from openpsg_tpu.models.llm.llama import Llama as JaxLlama, LlamaConfig as JaxCfg

    from openpsg_tpu_torch.models.llm.llama import Llama, LlamaConfig

    assert LlamaConfig().max_seq_len == JaxCfg().max_seq_len and LlamaConfig().causal
    assert LlamaConfig.tiny_test().truncate(1).n_layers == 1
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    mask = np.asarray([[1, 1, 1, 1, 0], [1, 1, 1, 1, 1]], bool)
    pos = np.arange(5)[None].repeat(2, 0).astype(np.int32)
    for causal in (True, False):
        jc = dataclasses.replace(JaxCfg.tiny_test().truncate(1), causal=causal)
        jm = JaxLlama(jc)
        kw = dict(input_embeds=x, attention_mask=mask, positions=pos)
        params = jax.jit(lambda k: jm.init(k, **kw, return_hidden=True))(jax.random.PRNGKey(0))
        want = jm.apply(params, **kw, return_hidden=True)[0]
        pm = Llama(dataclasses.replace(LlamaConfig.tiny_test().truncate(1), causal=causal),
                   lm_head=False)
        init_params(pm, torch.Generator().manual_seed(0))
        tree = jax.tree_util.tree_map(np.asarray, params)
        load_part(pm.eval(), "m", tree, scanned=scan_prefixes(pm, "m"))
        got = pm(_f(x), _f(mask), _f(pos).long(), return_hidden=True)[0]
        close(got, want)
