"""Port Llama (bf16 dense path, here in float32) and greedy decoding
against the JAX package at the tiny config: logits at atol=rtol=1e-4;
greedy tokens and trip counts exact; scores at atol=1e-4 (log-probs of
the same argmax, float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpsg_tpu.models.llm.decode import greedy_decode as jax_greedy
from openpsg_tpu.models.llm.llama import LlamaConfig as JaxCfg
from openpsg_tpu.models.llm.llama import LlamaWithEmbeddings as JaxLlama
from openpsg_tpu.models.llm.llama import _rope as jax_rope
from openpsg_tpu_torch.bridge import load_part
from openpsg_tpu_torch.models.llm.decode import greedy_decode
from openpsg_tpu_torch.models.llm.llama import LlamaConfig, LlamaWithEmbeddings, rope

TOL = dict(atol=1e-4, rtol=1e-4)
STEPS = 8


@pytest.fixture(scope="module")
def llm():
    jm = JaxLlama(JaxCfg.tiny_test(vocab_size=32))
    params = jax.jit(lambda k: jm.init(
        k, token_ids=jnp.zeros((1, 4), jnp.int32), attention_mask=jnp.ones((1, 4), bool),
        positions=jnp.zeros((1, 4), jnp.int32)))(jax.random.PRNGKey(7))
    port = LlamaWithEmbeddings(LlamaConfig.tiny_test(vocab_size=32))
    load_part(port, "llm", jax.tree_util.tree_map(np.asarray, jax.device_get(params)))
    rng = np.random.default_rng(1)
    prefix = rng.normal(size=(3, 5, 64)).astype(np.float32)
    mask = np.ones((3, 5), bool)
    mask[1, 0] = False
    mask[2, 2] = False                       # a pad in the middle (HF positions)
    fns = {
        ee: jax.jit(lambda b, ee=ee: jax_greedy(
            jm, params, jnp.asarray(prefix), jnp.asarray(mask), STEPS, eos_id=31,
            pad_id=0, early_exit=ee, return_trips=True, trip_budget=b))
        for ee in (True, False)
    }
    return jm, params, port, prefix, mask, fns


def _port_decode(llm, early_exit=True, budget=None):
    _, _, port, prefix, mask, _ = llm
    return greedy_decode(port, torch.from_numpy(prefix), torch.from_numpy(mask), STEPS,
                         eos_id=31, pad_id=0, early_exit=early_exit, trip_budget=budget)


def test_forward_logits_and_kv(llm):
    jm, params, port, prefix, mask, _ = llm
    pos = np.maximum(np.cumsum(mask, 1) - 1, 0).astype(np.int32)
    wl, (wk, wv) = jm.apply(params, input_embeds=jnp.asarray(prefix),
                            attention_mask=jnp.asarray(mask), positions=jnp.asarray(pos))
    with torch.no_grad():
        gl, (gk, gv) = port(input_embeds=torch.from_numpy(prefix),
                            attention_mask=torch.from_numpy(mask),
                            positions=torch.from_numpy(pos).long())
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **TOL)


def test_rope_matches():
    x = np.random.default_rng(2).normal(size=(2, 3, 4, 16)).astype(np.float32)
    pos = np.array([[0, 1, 5], [3, 3, 9]], np.int32)
    want = jax_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = rope(torch.from_numpy(x), torch.from_numpy(pos).long(), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("budget", [None, 1, 3, STEPS, STEPS + 5])
def test_greedy_decode_matches(llm, early_exit, budget):
    fns = llm[5]
    jb = jnp.int32(STEPS if budget is None else budget)
    wt, ws, wtrips = jax.device_get(fns[early_exit](jb))
    gt, gs, gtrips = _port_decode(llm, early_exit, budget)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)
    assert gtrips == int(wtrips)


def test_budget_caps_trips_without_early_exit(llm):
    """min(budget, max_new_tokens) trips exactly (tests/test_llm.py)."""
    for b, want in ((3, 3), (STEPS, STEPS), (STEPS + 4, STEPS)):
        assert _port_decode(llm, early_exit=False, budget=b)[2] == want


def test_budget_prefix_agrees_with_uncapped(llm):
    full_t, full_s, full_trips = _port_decode(llm)
    for b in (1, 3):
        t, s, trips = _port_decode(llm, budget=b)
        assert trips == min(b, full_trips)
        np.testing.assert_array_equal(t[:, :b].numpy(), full_t[:, :b].numpy())
        assert (t[:, b:] == 0).all()
