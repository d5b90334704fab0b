"""Training through the int8 LLM, held against the JAX package: one
``V4Trainer`` step of the tiny config with a quantized LLM (weight-only,
and with int8 activations at ≥ 256 rows), its losses and head gradients
against ``jax.grad`` over the JAX ``loss_single`` — the tolerances of
tests/test_torch_train.py.  With int8 activations the JAX ``QDense``
passes the input gradient only through the per-token scale (rounding
passes none); the port copies that.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from openpsg_tpu.models.detectors.psg_v4 import PSGv4 as JaxPSGv4
from openpsg_tpu.models.detectors.psg_v4 import PSGv4Config as JaxPSGv4Config
from openpsg_tpu_torch.bridge import load_jax_params, part_state_dict
from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config
from openpsg_tpu_torch.models.llm.llama import QDense
from openpsg_tpu_torch.train import trainer
from tests.test_torch_train import _batch, _jax_grads

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

TOL = 1e-5
_np = lambda tree: jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _int8(cfg, act_int8):
    """The tiny config with a quantized LLM and 8 LLM pairs per image, so
    teacher forcing feeds the LLM 8 × 36 = 288 rows (≥ 256)."""
    return dataclasses.replace(
        cfg, llm=dataclasses.replace(cfg.llm, quant=True, act_int8=act_int8),
        head=dataclasses.replace(cfg.head, max_llm_forward_num=8))


class _GivenParams(JaxPSGv4):
    """A JAX model whose parameters are given, not initialized again."""

    def __init__(self, cfg, rng, params):
        self._given = params
        super().__init__(cfg, rng)

    def _init_params(self, rng, precomputed_class_embeds):
        return self._given


@pytest.fixture(scope="module")
def int8_steps():
    out, params = {}, None
    for act in (False, True):
        cfg = _int8(JaxPSGv4Config.tiny_test(), act)
        if params is None:
            jp = JaxPSGv4(cfg, jax.random.PRNGKey(0))
            params = _np(jp.params)
        else:
            # act_int8 adds no parameter and draws no key (its branch needs
            # >= 256 rows, which the initializers' trace does not reach):
            # the weight-only model's parameters are this one's as well
            jp = _GivenParams(cfg, jax.random.PRNGKey(0), params)
        model = PSGv4(_int8(PSGv4Config.tiny_test(), act), seed=0, device="cpu")
        load_jax_params(model, params)
        arrays = _batch(model.cfg, model.tokenizer, model.relation_names)
        want_loss, want_grads = _jax_grads(jp, params, arrays, ("head",))
        rows = []
        hook = lambda m, inp, _: rows.append(inp[0].reshape(-1, inp[0].shape[-1]).shape[0])
        handles = [m.register_forward_hook(hook) for m in model.llm.modules()
                   if isinstance(m, QDense)]
        tr = trainer.V4Trainer(model)
        got_loss, got_grads = tr.gradients(trainer.TrainBatch.from_numpy(arrays, "cpu"))
        for h in handles:
            h.remove()
        out[act] = (want_loss, want_grads, got_loss, got_grads, rows)
    return out


@pytest.mark.parametrize("act_int8", [False, True], ids=["weight_only", "act_int8"])
def test_int8_train_step_matches_jax_grad(int8_steps, act_int8):
    want_loss, want_grads, got_loss, got_grads, rows = int8_steps[act_int8]
    assert min(rows) >= QDense.ACT_INT8_MIN_ROWS or not act_int8
    assert max(rows) >= QDense.ACT_INT8_MIN_ROWS          # the quirk's regime is reached
    assert set(got_loss) == set(want_loss) and want_loss["rel_llm_loss"] > 0
    for k, v in want_loss.items():
        assert float(got_loss[k]) == pytest.approx(v, rel=TOL), k
    want = part_state_dict("head", want_grads["head"])
    assert {f"head.{n}" for n in want} == set(got_grads)
    largest = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        g = got_grads[f"head.{name}"].numpy()
        if name.endswith("k.bias") and "attn" in name:
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-5 * largest, name
            continue
        assert float(np.abs(g - w).max()) <= 1e-4 * float(np.abs(w).max()), name
    assert float(np.abs(want["language_projection.weight"]).max()) > 0


def test_act_int8_gradient_flows_only_through_the_scale(int8_steps):
    """The quirk: rounding to int8 passes no gradient, so the two programs'
    LLM-side head gradients differ (on both sides alike, as held above)."""
    g_w = int8_steps[False][3]["head.language_projection.weight"]
    g_a = int8_steps[True][3]["head.language_projection.weight"]
    assert not torch.allclose(g_w, g_a, rtol=0.1, atol=0)
    x = torch.randn(300, 64, dtype=torch.float32, requires_grad=True)
    dense = QDense(64, 8, act_int8=True, dtype=torch.float32)
    with torch.no_grad():
        dense.weight_q.copy_(torch.randint(-127, 128, (8, 64), dtype=torch.int8))
        dense.scale.fill_(1 / 127)
    dense(x).sum().backward()
    # one nonzero per row (the row's largest |x|: ties are measure zero)
    assert ((x.grad != 0).sum(dim=1) == 1).all()


def test_weight_only_backward_is_the_einsum_gradient():
    """The autograd Function's input gradient against the float32
    einsum's (the same product without the Function), on the CPU path the
    card's backward shares."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(5, 7, 32, generator=gen, requires_grad=True)
    dense = QDense(32, 16, dtype=torch.float32)
    with torch.no_grad():
        dense.weight_q.copy_(torch.randint(-127, 128, (16, 32), generator=gen).to(torch.int8))
        dense.scale.copy_(torch.rand(16, generator=gen) / 100)
    y = dense(x)
    cot = torch.randn(y.shape, generator=gen)
    (y * cot).sum().backward()
    want = (cot * dense.scale) @ dense.weight_q.float()
    torch.testing.assert_close(x.grad, want, rtol=1e-6, atol=1e-6)
    assert dense.weight_q.grad is None
