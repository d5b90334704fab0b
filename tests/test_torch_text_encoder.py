"""The port's ``BertStyleEncoder`` (``models/commons/text_encoder.py``)
against the JAX module on the same parameters (the flax tree loaded with
``load_tree``), over its options: post-LN BERT with the pooler, the bare
layer stack, the pre-LN causal quickGELU CLIP tower, cross-attention to
encoder states of another width, adapters, learnable prompts (shared and
per row), projected input embeddings and constant position ids.  Float32,
within 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpsg_tpu.models.commons.text_encoder import BertStyleConfig as JaxBertStyleConfig
from openpsg_tpu.models.commons.text_encoder import BertStyleEncoder as JaxBertStyleEncoder
from openpsg_tpu_torch.models.commons.text_encoder import (
    BertStyleConfig,
    BertStyleEncoder,
    DenseLN,
    load_tree,
)

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

TOL = 1e-5
B, L, P, DE = 3, 7, 5, 24

CASES = {
    "bert_pool": (dict(), dict(pool=True)),
    "bert_tokens": (dict(), dict()),
    "bare": (dict(bare=True), dict(embeds=True)),
    "clip": (dict(pre_ln=True, quick_gelu=True, causal=True, ln_eps=1e-5), dict()),
    "cross": (dict(add_cross_attention=True, encoder_hidden_size=DE), dict(encoder=True)),
    # a decoder-mode tower called without encoder states skips the cross
    # block (its parameters exist: the tree comes from a call with them)
    "cross_skipped": (dict(add_cross_attention=True, encoder_hidden_size=DE),
                      dict(encoder="init")),
    "clip_cross": (dict(pre_ln=True, add_cross_attention=True, encoder_hidden_size=DE),
                   dict(encoder=True)),
    "adapters": (dict(use_adapters=True), dict()),
    "clip_adapters": (dict(pre_ln=True, quick_gelu=True, use_adapters=True), dict()),
    "prompts": (dict(num_learnable_prompts=3), dict()),
    "row_prompts_embeds": (dict(), dict(embeds=True, row_prompts=True, position_ids=1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bert_style_encoder_matches_jax(case):
    knobs, call = CASES[case]
    rng = np.random.default_rng(len(case))
    cfg = BertStyleConfig.tiny_test(**knobs)
    jcfg = JaxBertStyleConfig.tiny_test(**knobs)
    D = cfg.hidden_size
    ids = rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    mask = np.ones((B, L), bool)
    mask[0, 5:] = mask[2, 3:] = False
    kw = dict(attention_mask=mask)
    if call.get("embeds"):
        kw["input_embeds"] = rng.normal(size=(B, L, D)).astype(np.float32)
    else:
        kw["token_ids"] = ids
    if call.get("encoder"):
        kw["encoder_hidden"] = rng.normal(size=(B, P, DE)).astype(np.float32)
        kw["encoder_mask"] = np.arange(P)[None] < np.asarray([[5], [2], [4]])
    if call.get("row_prompts"):
        kw["learnable_embeds"] = rng.normal(size=(B, 2, D)).astype(np.float32)
    for key in ("pool", "position_ids"):
        if key in call:
            kw[key] = call[key]
    jenc = JaxBertStyleEncoder(jcfg)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    params = jenc.init(jax.random.PRNGKey(3), **jkw)["params"]
    if call.get("encoder") == "init":
        for k in ("encoder_hidden", "encoder_mask"):
            del jkw[k], kw[k]
    # nonzero biases and LayerNorm shifts, so a dropped one shows
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32) * 0.05, params)
    want = np.asarray(jenc.apply({"params": params}, **jkw))

    enc = BertStyleEncoder(cfg, word_embeddings="token_ids" in kw)
    load_tree(enc, params)
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    with torch.no_grad():
        got = enc(**tkw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_dense_ln_matches_jax():
    from openpsg_tpu.models.commons.text_encoder import DenseLN as JaxDenseLN

    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    params = JaxDenseLN(8).init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32) * 0.1, params)
    want = np.asarray(JaxDenseLN(8).apply({"params": params}, jnp.asarray(x)))
    m = DenseLN(16, 8)
    with torch.no_grad():
        m.dense.weight.copy_(torch.from_numpy(params["dense"]["kernel"].T))
        m.dense.bias.copy_(torch.from_numpy(params["dense"]["bias"]))
        m.ln.weight.copy_(torch.from_numpy(params["ln"]["scale"]))
        m.ln.bias.copy_(torch.from_numpy(params["ln"]["bias"]))
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_load_tree_is_strict():
    cfg = BertStyleConfig.tiny_test()
    enc = BertStyleEncoder(cfg)
    jenc = JaxBertStyleEncoder(JaxBertStyleConfig.tiny_test())
    params = jax.device_get(jenc.init(jax.random.PRNGKey(0),
                                      token_ids=jnp.zeros((1, 4), jnp.int32))["params"])
    params = dict(params)
    del params["pooler"]
    with pytest.raises(RuntimeError, match="pooler"):
        load_tree(enc, params)
    with pytest.raises(RuntimeError, match="layers.1"):
        load_tree(BertStyleEncoder(dataclasses.replace(cfg, num_layers=1)),
                  jax.device_get(jenc.init(jax.random.PRNGKey(0),
                                           token_ids=jnp.zeros((1, 4), jnp.int32))["params"]))
