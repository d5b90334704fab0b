"""The port's segmenter training (``openpsg_tpu_torch.train.segmenter_trainer``)
against the JAX package's (``openpsg_tpu.train.segmenter_trainer``), in both
class modes: ``softmax_void`` on the tiny Mask2Former, ``sigmoid`` on the
tiny OpenSeeD segmenter with trainable class embeddings (the selfcheck's
phase A).  The same seeded weights (bridged from the JAX params) and batch.

Tolerances: ``dice_loss`` and ``_mask_bce`` within 1e-6 absolute; the cost
matrices within 1e-5 relative to the largest valid cost (the port computes
them from products instead of the [Q, M, P] terms); Hungarian assignments
identical; the losses within 1e-5 relative and each gradient leaf within
1e-4 of that leaf's largest magnitude (leaves whose JAX gradient is 0 up to
roundoff, below 1e-6 of the largest, are held to 1e-5 of the largest).  In
the sigmoid mode the gradients compared are the class embeddings' and
those of the query decoder's leaves outside its layers, the encoder's
proposal layers (0: the proposals are detached) included (the JAX gradient
program of the whole OpenSeeD segmenter takes about a minute to compile;
the softmax_void mode compares every leaf).  The
cosine schedule within 1e-6 relative of optax's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openpsg_tpu.models.segmenter.mask2former import Mask2FormerConfig as JaxM2FConfig
from openpsg_tpu.models.segmenter.mask2former import Mask2FormerSegmenter as JaxM2F
from openpsg_tpu.models.segmenter.openseed import OpenSeedSegmenter as JaxOpenSeed
from openpsg_tpu.models.segmenter.openseed import SegmenterConfig as JaxSegConfig
from openpsg_tpu.train import segmenter_trainer as jst
from openpsg_tpu_torch.bridge import load_part, part_state_dict, scan_prefixes
from openpsg_tpu_torch.models.segmenter.mask2former import Mask2FormerConfig, Mask2FormerSegmenter
from openpsg_tpu_torch.models.segmenter.openseed import OpenSeedSegmenter, SegmenterConfig
from openpsg_tpu_torch.train import segmenter_trainer as st
from openpsg_tpu_torch.train.trainer import AdamW, make_cosine_schedule

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

H = 64
T = lambda a: torch.from_numpy(np.asarray(a))


def _batch(B=2, seed=0):
    """The first ``B`` of two images with 2 and 3 objects (M = 4)."""
    rng = np.random.default_rng(seed)
    gt_masks = np.zeros((2, 4, H // 4, H // 4), bool)
    gt_masks[:, 0, :8, :8] = True
    gt_masks[:, 1, 8:, 8:] = True
    gt_masks[1, 2, :8, 8:] = True
    labels = np.asarray([[1, 3, 0, 0], [2, 3, 5, 0]], np.int32)
    valid = np.asarray([[True, True, False, False], [True, True, True, False]])
    return dict(image=rng.integers(0, 255, (B, H, H, 3)).astype(np.float32),
                gt_masks=gt_masks[:B], gt_labels=labels[:B], gt_valid=valid[:B])


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


@pytest.fixture(scope="module", params=["softmax_void", "sigmoid"])
def case(request):
    """(mode, JAX trainer, JAX params, port trainer, port params by JAX
    name) with the same weights."""
    mode = request.param
    key = jax.random.PRNGKey(0)
    if mode == "softmax_void":
        jseg = JaxM2F(JaxM2FConfig.tiny_test())
        params = _tree(jax.jit(jseg.init)(key, jnp.zeros((H, H, 3))))
        seg = Mask2FormerSegmenter(Mask2FormerConfig.tiny_test())
        load_part(seg, "segmenter", params, scanned=scan_prefixes(seg, "segmenter"))
        jtr = jst.SegmenterTrainer(jseg, num_classes=8)
        tr = st.SegmenterTrainer(seg, num_classes=8)
        return mode, jtr, params, tr, seg
    jcfg = JaxSegConfig.tiny_test()
    K = 12
    ce = np.random.default_rng(1).normal(size=(K, jcfg.proj_dim)).astype(np.float32)
    jseg = JaxOpenSeed(jcfg)
    params = {"seg": _tree(jax.jit(jseg.init)(key, jnp.zeros((H, H, 3)), jnp.asarray(ce))),
              "ce": ce}
    seg = OpenSeedSegmenter(SegmenterConfig.tiny_test())
    load_part(seg, "segmenter", params["seg"])
    ce_t = T(ce.copy())
    jtr = jst.SegmenterTrainer(jseg, num_classes=K, cls_mode="sigmoid",
                               apply_fn=lambda p, img: jseg.apply(p["seg"], img, p["ce"]))
    tr = st.SegmenterTrainer(seg, num_classes=K, cls_mode="sigmoid",
                             apply_fn=lambda img: seg(img, ce_t),
                             params={**{f"seg.{n}": p for n, p in seg.named_parameters()},
                                     "ce": ce_t})
    return mode, jtr, params, tr, seg


def _jax_batch(arrays):
    return jst.SegTrainBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _want_grads(mode, grads, seg):
    """JAX gradient tree → {port trainer name: array}."""
    if mode == "softmax_void":
        return part_state_dict("segmenter", grads, scanned=scan_prefixes(seg, "segmenter"))
    out = {f"seg.{n}": g for n, g in part_state_dict("segmenter", grads["seg"]).items()}
    out["ce"] = np.asarray(grads["ce"])
    return out


def test_dice_and_bce_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 4, (5, 37)).astype(np.float32)
    t = (rng.random((5, 37)) < 0.4).astype(np.float32)
    np.testing.assert_allclose(st.dice_loss(T(x), T(t)).numpy(),
                               np.asarray(jst.dice_loss(x, t)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(st._mask_bce(T(x), T(t)).numpy(),
                               np.asarray(jst._mask_bce(x, t)), atol=1e-6, rtol=0)
    good = T(np.asarray([20.0, 20.0, -20.0, -20.0], np.float32))
    tgt = T(np.asarray([1.0, 1.0, 0.0, 0.0], np.float32))
    assert float(st.dice_loss(good, tgt)) < 0.01
    assert float(st.dice_loss(-good, tgt)) > 0.7


@pytest.mark.parametrize("costs, valid, want", [
    ([[[1.0, 9.0], [9.0, 1.0], [5.0, 5.0]]], [[True, True]], [[0, 1, -1]]),
    (np.ones((1, 3, 2)), [[False, False]], [[-1, -1, -1]]),
])
def test_assign_cases(costs, valid, want):
    costs, valid = np.asarray(costs), np.asarray(valid)
    got = st.SegmenterTrainer.assign(costs, valid)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jst.SegmenterTrainer.assign(costs, valid))


def _case_batch(mode):
    """Two images for Mask2Former; one for the OpenSeeD segmenter, whose
    JAX gradient program takes several times as long to compile."""
    return _batch(B=2 if mode == "softmax_void" else 1)


def test_costs_and_assignment_match_jax(case):
    mode, jtr, params, tr, _ = case
    arrays = _case_batch(mode)
    want = np.asarray(jax.jit(jtr.cost_matrices)(params, _jax_batch(arrays)))
    got = tr.cost_matrices(st.SegTrainBatch.from_numpy(arrays, "cpu")).numpy()
    assert got.shape == want.shape == (len(arrays["image"]), tr.segmenter.cfg.num_queries, 4)
    ok = want < 1e8
    np.testing.assert_array_equal(got >= 1e8, ~ok)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-5 * np.abs(want[ok]).max())
    m_want = jst.SegmenterTrainer.assign(want, arrays["gt_valid"])
    np.testing.assert_array_equal(st.SegmenterTrainer.assign(got, arrays["gt_valid"]), m_want)
    assert (m_want >= 0).sum() == arrays["gt_valid"].sum()


def test_loss_and_gradients_match_jax(case):
    mode, jtr, params, tr, seg = case
    arrays = _case_batch(mode)
    jb = _jax_batch(arrays)
    costs = np.asarray(jax.jit(jtr.cost_matrices)(params, jb))
    match = jst.SegmenterTrainer.assign(costs, arrays["gt_valid"])

    if mode == "softmax_void":
        full, wrt = (lambda sub: sub), params
    else:
        # the class embeddings and the query decoder's leaves outside its
        # layers: the heads on the decoded queries, and the encoder's
        # proposal layers, whose gradient the detached proposals make 0
        # (differentiating the whole OpenSeeD segmenter costs the JAX
        # compiler about a minute; softmax_void holds every leaf)
        dec = params["seg"]["params"]["decoder"]

        def full(sub):
            seg_params = {**params["seg"]["params"],
                          "decoder": {**dec, **{k: v for k, v in sub.items() if k != "ce"}}}
            return {"seg": {"params": seg_params}, "ce": sub["ce"]}

        wrt = {k: v for k, v in dec.items() if k != "layers"}
        wrt["ce"] = params["ce"]

    def loss_fn(sub):
        d = jtr.loss(full(sub), jb, jnp.asarray(match))
        return sum(d.values()), d

    (total, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(wrt)
    got, got_grads = tr.gradients(st.SegTrainBatch.from_numpy(arrays, "cpu"), T(match))
    for k, v in want.items():
        assert float(got[k]) == pytest.approx(float(v), rel=1e-5), k
    assert float(got["loss"]) == pytest.approx(float(total), rel=1e-5)
    want_g = _want_grads(mode, _tree(full(grads)), seg)
    if mode == "sigmoid":
        want_g = {n: w for n, w in want_g.items() if n == "ce" or (
            n.startswith("seg.decoder.") and not n.startswith("seg.decoder.layers."))}
        assert float(np.abs(want_g["ce"]).max()) > 0
        enc = [n for n in want_g if n.startswith("seg.decoder.enc_")]
        assert enc and all(not got_grads[n].any() and not want_g[n].any() for n in enc)
    assert set(want_g) <= set(got_grads)
    largest = max(float(np.abs(w).max()) for w in want_g.values())
    for name, w in want_g.items():
        g = got_grads[name].numpy()
        scale = float(np.abs(w).max())
        if scale < 1e-6 * largest:     # 0 up to roundoff on the JAX side
            assert float(np.abs(g).max()) <= 1e-5 * largest, name
            continue
        assert float(np.abs(g - w).max()) <= 1e-4 * scale, (name, scale)


def test_cosine_schedule_matches_optax():
    want = optax.cosine_decay_schedule(2e-3, 900, 0.05)
    got = make_cosine_schedule(2e-3, 900, 0.05)
    for count in (0, 1, 450, 899, 900, 1200):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6), count


def test_overfit_one_image():
    """The JAX overfit case: 12 steps of optax.adamw(1e-3)'s chain on one
    image; the loss falls by at least 20%."""
    torch.manual_seed(0)
    seg = Mask2FormerSegmenter(Mask2FormerConfig.tiny_test())
    from openpsg_tpu_torch.models.common import init_params

    init_params(seg, torch.Generator().manual_seed(0))
    arrays = {k: v[:1] for k, v in _batch().items()}
    arrays["gt_masks"][0, 2] = False
    arrays["gt_valid"][0] = [True, True, False, False]
    tr = st.SegmenterTrainer(seg, num_classes=8)
    opt = AdamW(lambda count: 1e-3, max_norm=float("inf"), weight_decay=1e-4)
    state = opt.init(tr.master)
    batch = st.SegTrainBatch.from_numpy(arrays, "cpu")
    times = {}
    losses = [float(tr.train_step(batch, opt, state, times if i == 0 else None)["loss"])
              for i in range(12)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, losses
    assert set(times) == {"forward", "cost", "assign", "loss_backward", "optimizer"}


def test_bf16_segmenter_trains_float32_masters():
    """A bf16 segmenter trains on float32 masters; the module holds their
    rounding."""
    cfg = dataclasses.replace(Mask2FormerConfig.tiny_test(), dtype=torch.bfloat16)
    seg = Mask2FormerSegmenter(cfg).to(torch.bfloat16)
    from openpsg_tpu_torch.models.common import init_params

    init_params(seg, torch.Generator().manual_seed(0))
    tr = st.SegmenterTrainer(seg, num_classes=8)
    name = "decoder.query_feat.weight" if "decoder.query_feat.weight" in tr.master else next(
        iter(tr.master))
    assert tr.params[name].dtype == torch.bfloat16 and tr.master[name].dtype == torch.float32
    opt = AdamW(lambda count: 1e-3, max_norm=float("inf"), weight_decay=1e-4)
    d = tr.train_step(st.SegTrainBatch.from_numpy({k: v[:1] for k, v in _batch().items()},
                                                  "cpu"), opt, opt.init(tr.master))
    assert np.isfinite(float(d["loss"]))
    assert torch.equal(tr.params[name], tr.master[name].to(torch.bfloat16))
