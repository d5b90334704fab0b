"""Port Llama and greedy decoding against the JAX package at the tiny
config: logits at atol=rtol=1e-4; greedy tokens and trip counts exact;
scores at atol=1e-4 (log-probs of the same argmax, float32).

The int8 path (``QDense``, ``quantize_llama``): int8 values and scales
exact; QDense outputs exact where both packages do the same float32 work
(the int8×int8 product, and bf16 products summed in float32 at this width),
and at atol=rtol=1e-4 for a float32 weight-only product, whose sums run in
another order.  Greedy decode of the int8 LLM: tokens and trips exact;
scores within 5e-2, and 90% of them within 1e-4 (an activation that sits
on a rounding boundary of its int8 quantization may move by one step)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpsg_tpu.models.llm.decode import greedy_decode as jax_greedy
from openpsg_tpu.models.llm.llama import LlamaConfig as JaxCfg
from openpsg_tpu.models.llm.llama import LlamaWithEmbeddings as JaxLlama
from openpsg_tpu.models.llm.llama import QDense as JaxQDense
from openpsg_tpu.models.llm.llama import _rope as jax_rope
from openpsg_tpu.models.llm.llama import quantize_llama as jax_quantize
from openpsg_tpu_torch.bridge import load_part
from openpsg_tpu_torch.models.llm.decode import greedy_decode
from openpsg_tpu_torch.models.llm.llama import (
    QUANT_TARGETS,
    LlamaConfig,
    LlamaWithEmbeddings,
    QDense,
    quantize_llama,
    rope,
)

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


# ------------------------------------------------------------------ int8


def _qdense_pair(rng, D, F, act_int8, jdtype, tdtype):
    kq = rng.integers(-127, 128, (D, F)).astype(np.int8)
    scale = rng.uniform(0.005, 0.02, F).astype(np.float32)
    jax_fn = lambda x: JaxQDense(F, dtype=jdtype, act_int8=act_int8).apply(
        {"params": {"kernel_q": jnp.asarray(kq), "scale": jnp.asarray(scale)}}, x)
    port = QDense(D, F, act_int8=act_int8, dtype=tdtype)
    port.load_state_dict({"weight_q": torch.from_numpy(kq.T.copy()),
                          "scale": torch.from_numpy(scale)})
    return jax_fn, port


def _to_both(x, jdtype, tdtype):
    xj = jnp.asarray(x, jdtype)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act_int8", [False, True])
@pytest.mark.parametrize("lead", [(3, 100), (300,), (4,), (2, 127)])
def test_qdense_matches_jax(dtype, act_int8, lead):
    """Both sides of the 256-row rule, counted over ALL leading dims:
    (3, 100) and (300,) take the int8-activation path, (4,) and (2, 127)
    the weight-only one."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(11)
    jax_fn, port = _qdense_pair(rng, 64, 96, act_int8, jdt, tdt)
    xj, xt = _to_both(rng.normal(size=lead + (64,)), jdt, tdt)
    want = np.asarray(jax_fn(xj).astype(jnp.float32))
    with torch.no_grad():
        got = port(xt)
    assert got.dtype == tdt and got.shape == lead + (96,)
    got = got.float().numpy()
    if dtype == "float32" and not (act_int8 and np.prod(lead) >= 256):
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_array_equal(got, want)


def test_qdense_bf16_rounds_once():
    """The weight-only bf16 product is summed AND returned in float32, then
    scaled, then rounded to bf16 once (JAX llama.py:144-148).  A bf16
    product (``F.linear``) rounds before the scale and disagrees with the
    JAX QDense on many outputs; the port agrees on all."""
    rng = np.random.default_rng(12)
    jax_fn, port = _qdense_pair(rng, 64, 96, False, jnp.bfloat16, torch.bfloat16)
    xj, xt = _to_both(rng.normal(size=(20, 64)), jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jax_fn(xj).astype(jnp.float32))
    with torch.no_grad():
        got = port(xt).float().numpy()
        twice = (torch.nn.functional.linear(xt, port.weight_q.to(torch.bfloat16))
                 * port.scale.to(torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert (twice != want).mean() > 0.1


@pytest.mark.parametrize("rows", [4, 255])
def test_act_int8_below_rule_is_weight_only(rows):
    """Under 256 rows (decode steps, lm_head on the last logit) act_int8 is
    bit-identical to act_int8=False (JAX tests/test_llm.py:299-303)."""
    rng = np.random.default_rng(13)
    _, plain = _qdense_pair(rng, 64, 96, False, jnp.bfloat16, torch.bfloat16)
    act = QDense(64, 96, act_int8=True, dtype=torch.bfloat16)
    act.load_state_dict(plain.state_dict())
    x = torch.from_numpy(rng.normal(size=(rows, 64)).astype(np.float32)).bfloat16()
    with torch.no_grad():
        assert torch.equal(act(x), plain(x))


def test_quantize_llama_matches_jax(llm):
    """The port's quantize_llama on its own [out, in] weights gives the
    JAX function's int8 values and scales on the same tree, and the
    quantized tree loads through the bridge into a quant=True LLM."""
    _, params, port, *_ = llm
    jq = jax.tree_util.tree_map(np.asarray, jax_quantize(jax.device_get(params)))
    tq = quantize_llama(port.state_dict())
    layers = jq["params"]["core"]["layers"]
    for name in QUANT_TARGETS[:-1]:
        for i in range(layers[name]["kernel_q"].shape[0]):
            wq, sc = tq[f"core.layers.{i}.{name}.weight_q"], tq[f"core.layers.{i}.{name}.scale"]
            assert wq.dtype == torch.int8 and sc.dtype == torch.float32
            np.testing.assert_array_equal(wq.numpy(), layers[name]["kernel_q"][i].T)
            np.testing.assert_array_equal(sc.numpy(), layers[name]["scale"][i])
    head = jq["params"]["core"]["lm_head"]
    np.testing.assert_array_equal(tq["core.lm_head.weight_q"].numpy(), head["kernel_q"].T)
    np.testing.assert_array_equal(tq["core.lm_head.scale"].numpy(), head["scale"])
    for name in ("tok_embed.weight", "core.final_norm.weight", "core.layers.0.attn_norm.weight"):
        assert torch.equal(tq[name], port.state_dict()[name]), name
    qport = LlamaWithEmbeddings(dataclasses.replace(port.cfg, quant=True))
    load_part(qport, "llm", jq)
    for name, t in qport.state_dict().items():
        assert torch.equal(t, tq[name]), name


@pytest.fixture(scope="module")
def quant_llm(llm):
    """quant=True, act_int8=True tiny LLMs (JAX and port) on the quantized
    tree, with a prefill of 6 × 48 = 288 rows: over the 256-row rule, so
    prefill takes the int8-activation path and each decode step (6 rows)
    the weight-only one."""
    _, params, *_ = llm
    cfg = dataclasses.replace(JaxCfg.tiny_test(vocab_size=32), quant=True, act_int8=True)
    jm = JaxLlama(cfg)
    jq = jax.tree_util.tree_map(np.asarray, jax_quantize(jax.device_get(params)))
    port = LlamaWithEmbeddings(dataclasses.replace(
        LlamaConfig.tiny_test(vocab_size=32), quant=True, act_int8=True))
    load_part(port, "llm", jq)
    rng = np.random.default_rng(3)
    prefix = rng.normal(size=(6, 48, 64)).astype(np.float32)
    mask = np.ones((6, 48), bool)
    mask[1, :5] = False
    mask[4, 20] = False
    want = jax.device_get(jax.jit(lambda: jax_greedy(
        jm, jq, jnp.asarray(prefix), jnp.asarray(mask), STEPS, eos_id=31, pad_id=0,
        early_exit=True, return_trips=True))())
    return port, prefix, mask, want


def test_quant_greedy_decode_matches(quant_llm, monkeypatch):
    port, prefix, mask, (wt, ws, wtrips) = quant_llm
    int8_rows = []
    real = torch._int_mm
    monkeypatch.setattr(torch, "_int_mm", lambda a, b: int8_rows.append(a.shape[0]) or real(a, b))
    gt, gs, gtrips = greedy_decode(port, torch.from_numpy(prefix), torch.from_numpy(mask),
                                   STEPS, eos_id=31, pad_id=0)
    # 7 QDense per layer take the int8 path in prefill only (lm_head sees 6 rows)
    assert int8_rows == [6 * 48] * (7 * port.cfg.n_layers)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    assert gtrips == int(wtrips)
    # float32 sums in another order upstream can carry an activation across
    # a rounding boundary of its int8 quantization, moving that one input by
    # a step (max|x|/127): a few scores move by up to ~1e-2, the rest agree
    # as in the float32 path
    diff = np.abs(gs.numpy() - np.asarray(ws))
    assert diff.max() <= 5e-2 and np.mean(diff <= 1e-4) >= 0.9, diff
