"""The port's training path (openpsg_tpu_torch.train) against the JAX
package's (openpsg_tpu.train) at the tiny config.

Tolerances: losses exact in float32 up to summation order (atol 1e-6 /
rtol 1e-5); host sampling and LLM labels identical; the optimizer within
1e-6 of the optax chain over 5 steps; one train step's losses within 1e-5
relative and each head gradient leaf within 1e-4 of that leaf's largest
magnitude (the JAX gradients taken with ``jax.grad`` over the JAX
``loss_single`` here, from the same bridged weights and batch); the
attention key biases, whose gradient is 0 (the softmax cancels them), are
held to 1e-5 of the largest gradient on both sides.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openpsg_tpu.models.detectors.psg_v4 import PSGv4 as JaxPSGv4
from openpsg_tpu.models.detectors.psg_v4 import PSGv4Config as JaxPSGv4Config
from openpsg_tpu.train import checkpoint as jckpt
from openpsg_tpu.train import losses as jlosses
from openpsg_tpu.train import trainer as jtrainer
from openpsg_tpu_torch.bridge import jax_paths, load_jax_params, part_sources, part_state_dict
from openpsg_tpu_torch.core.config import Config
from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config
from openpsg_tpu_torch.train import checkpoint, losses, trainer

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = lambda a: torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------------ losses
def _mc_inputs(seed, shape=(6, 9)):
    rng = np.random.default_rng(seed)
    y_true = (rng.random(shape) < 0.3).astype(np.float32)
    y_pred = rng.normal(0, 3, shape).astype(np.float32)
    weight = (rng.random(shape[0]) < 0.7).astype(np.float32)
    return y_true, y_pred, weight


@pytest.mark.parametrize("seed", [0, 1])
def test_losses_match_jax(seed):
    y_true, y_pred, w = _mc_inputs(seed)
    close = lambda got, want: np.testing.assert_allclose(
        got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)
    close(losses.multilabel_categorical_crossentropy(T(y_true), T(y_pred)),
          jlosses.multilabel_categorical_crossentropy(y_true, y_pred))
    for sw in (None, w):
        close(losses.reweighted_mcce(T(y_true), T(y_pred), sample_weight=None if sw is None
                                     else T(sw)),
              jlosses.reweighted_mcce(y_true, y_pred, sample_weight=sw))
        close(losses.binary_existence_loss(T(y_pred[:, 0]), T(y_true[:, 0]),
                                           None if sw is None else T(sw)),
              jlosses.binary_existence_loss(y_pred[:, 0], y_true[:, 0], sw))
    rng = np.random.default_rng(seed + 10)
    logits = rng.normal(0, 2, (3, 7, 11)).astype(np.float32)
    ids = rng.integers(0, 11, (3, 7)).astype(np.int32)
    mask = rng.random((3, 7)) < 0.7
    close(losses.llm_teacher_forcing_loss(T(logits), T(ids), T(mask)),
          jlosses.llm_teacher_forcing_loss(logits, ids, mask))


def test_recall_at_k_matches_jax_with_ties():
    rng = np.random.default_rng(3)
    pred = rng.integers(0, 4, (2, 3, 5, 5)).astype(np.float32)   # many ties
    target = (rng.random((2, 3, 5, 5)) < 0.1).astype(np.float32)
    for k in (5, 20):
        want = float(jlosses.recall_at_k(pred, target, k=k))
        got = float(losses.recall_at_k(T(pred), T(target), k=k))
        assert got == pytest.approx(want, rel=1e-6), k


# ----------------------------------------------------- sampling and labels
def _targets():
    """relation targets [M, M, R] and pair validity: several positives,
    more positives than the sample (sampling with replacement: duplicates),
    a set without positives, and no valid pair at all."""
    M, R = 8, 56
    out = []
    rng = np.random.default_rng(0)
    t = np.zeros((M, M, R), np.float32)
    t[0, 1, 3] = t[0, 1, 7] = t[2, 0, 10] = t[5, 4, 0] = 1
    v = np.zeros(M, bool)
    v[:6] = True
    out.append((t, v))
    t = (rng.random((M, M, R)) < 0.01).astype(np.float32)
    out.append((t, np.ones(M, bool)))
    out.append((np.zeros((M, M, R), np.float32), np.r_[np.ones(4, bool), np.zeros(4, bool)]))
    out.append((np.zeros((M, M, R), np.float32), np.zeros(M, bool)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", range(4))
def test_sampling_and_labels_identical(seed, case):
    from openpsg_tpu.data.vocab import RELATION_CLASSES
    from openpsg_tpu.models.relation.tokenizer import build_prompt_tokenizer
    from openpsg_tpu_torch.models.relation.tokenizer import build_prompt_tokenizer as tok_port

    t, v = _targets()[case]
    M = v.shape[0]
    pv = np.repeat(v, M) & np.tile(v, M)
    for size, llm_pairs in ((8, 4), (32, 4)):
        want = jtrainer.sample_training_pairs(np.random.default_rng(seed), t, pv,
                                              sample_size=size, llm_pairs=llm_pairs)
        got = trainer.sample_training_pairs(np.random.default_rng(seed), t, pv,
                                            sample_size=size, llm_pairs=llm_pairs)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        li = want[2]
        ids_w, m_w = jtrainer.build_llm_labels(build_prompt_tokenizer(), RELATION_CLASSES, t, li, 12)
        ids_g, m_g = trainer.build_llm_labels(tok_port(), RELATION_CLASSES, t, li, 12)
        np.testing.assert_array_equal(ids_g, ids_w)
        np.testing.assert_array_equal(m_g, m_w)
    if case == 1:   # more positives than the sample: duplicates drawn
        qi = got[0][got[1] > 0]
        assert len(set(qi.tolist())) < len(qi)


def test_lr_schedule_matches_jax():
    kw = dict(base_lr=1e-4, warmup_iters=500, warmup_ratio=1e-3, step_epochs=(6, 10),
              steps_per_epoch=100)
    want, got = jtrainer.make_lr_schedule(**kw), trainer.make_lr_schedule(**kw)
    for count in (0, 499, 500, 650, 1050):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6), count
    assert got(0) == pytest.approx(1e-7, rel=1e-3)
    assert got(1050) == pytest.approx(1e-6, rel=1e-4)


# ----------------------------------------------------------------- optimizer
@pytest.mark.parametrize("max_norm", [0.05, 1e3])   # clipping active / inactive
@pytest.mark.parametrize("paramwise", [False, True])
def test_optimizer_matches_optax(max_norm, paramwise):
    rng = np.random.default_rng(7)
    shapes = {"a": (4, 5), "b": (6,), "c": (3, 2, 2)}
    params = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    lr = dec = None
    if paramwise:
        lr = {"a": 0.1, "b": 1.0, "c": 2.5}
        dec = {"a": 1.0, "b": 0.0, "c": 0.3}
    kw = dict(base_lr=1e-2, warmup_iters=3, warmup_ratio=0.1, step_epochs=(1,),
              steps_per_epoch=4)
    tx = jtrainer.make_optimizer(jtrainer.make_lr_schedule(**kw), max_norm=max_norm,
                                 weight_decay=0.05, lr_mult_tree=lr, decay_mult_tree=dec)
    opt = trainer.make_optimizer(trainer.make_lr_schedule(**kw), max_norm=max_norm,
                                 weight_decay=0.05, lr_mult=lr, decay_mult=dec)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: T(v.copy()) for k, v in params.items()}
    jstate, tstate = tx.init(jp), opt.init(tp)
    for step in range(5):
        grads = {k: rng.normal(0, 0.02, s).astype(np.float32) for k, s in shapes.items()}
        upd, jstate = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        norm = opt.step(tp, {k: T(g) for k, g in grads.items()}, tstate)
        assert float(norm) == pytest.approx(float(optax.global_norm(grads)), rel=1e-6)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy() - params[k], np.asarray(jp[k]) - params[k],
                                       atol=1e-6, rtol=0, err_msg=f"{k} step {step}")
    assert tstate["count"] == 5
    clipped = max_norm < float(optax.global_norm(grads))
    assert clipped == (max_norm == 0.05)


# ------------------------------------------------- the model and one step
@pytest.fixture(scope="module")
def models():
    jp = JaxPSGv4(JaxPSGv4Config.tiny_test(), jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jp.params))
    return jp, params


def _port(params):
    model = PSGv4(PSGv4Config.tiny_test(), seed=0, device="cpu")
    load_jax_params(model, params)
    return model


def test_jax_paths_invert_the_bridge(models):
    _, params = models
    model = _port(params)
    for part in ("segmenter", "head", "llm", "text"):
        assert jax_paths(getattr(model, part), part) == part_sources(part, params[part]), part


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def test_paramwise_multipliers_per_parameter(models):
    _, params = models
    keys = {"qformer": dict(lr_mult=0.1), "cross_attn0": dict(decay_mult=0.5),
            "relation_query": dict(lr_mult=1.0, decay_mult=0.0),
            "language_projection": dict(lr_mult=2.0, decay_mult=0.25)}
    want_lr, want_dec = jtrainer.paramwise_multipliers({"head": params["head"]}, keys,
                                                      norm_decay_mult=0.0)
    tr = trainer.V4Trainer(_port(params))
    lr, dec = trainer.paramwise_multipliers(tr.jax_paths(), keys, norm_decay_mult=0.0)
    assert set(lr) == set(tr.master)
    for name, path in tr.jax_paths().items():
        assert lr[name] == _leaf(want_lr, path), name
        assert dec[name] == _leaf(want_dec, path), name
    assert {dec[n] for n in dec} == {0.0, 0.25, 0.5, 1.0}    # norms, keys and the rest


def _batch(params_cfg, tokenizer, relation_names, B=2, seed=0):
    c = params_cfg
    M, R = c.head.max_objects_padded, c.head.num_relation_classes
    rng = np.random.default_rng(seed)
    examples = []
    for b in range(B):
        valid = np.zeros(M, bool)
        valid[:5 - b] = True
        t = np.zeros((M, M, R), np.float32)
        t[0, 1, 3] = t[0, 1, 10] = t[2, 0, 10] = t[3, 1, 4] = 1
        examples.append(dict(
            image=rng.integers(0, 255, (64, 64, 3)).astype(np.float32),
            object_masks=(rng.random((M, 16, 16)) > 0.7) & valid[:, None, None],
            object_labels=rng.integers(0, 133, M).astype(np.int32),
            object_valid=valid, relation_target=t))
    return trainer.host_batch(examples, tokenizer, relation_names, rng,
                              sample_size=c.head.sampled_qformer_batch_size,
                              llm_pairs=c.head.max_llm_forward_num, label_len=12)


def _jax_grads(jp, params, arrays, trainable_keys):
    jt = jtrainer.V4Trainer(jp)
    batch = jtrainer.TrainBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    trainable = {k: jax.tree_util.tree_map(jnp.asarray, params[k]) for k in trainable_keys}
    frozen = {k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in params.items()
              if k not in trainable_keys}

    def loss_fn(tr):
        per_image = jax.vmap(lambda b: jt.loss_single(tr, frozen, b))(batch)
        loss_dict = jax.tree_util.tree_map(jnp.mean, per_image)
        return sum(loss_dict.values()), loss_dict

    (total, loss_dict), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(trainable)
    loss_dict = {k: float(v) for k, v in loss_dict.items()}
    loss_dict["loss"] = float(total)
    return loss_dict, jax.tree_util.tree_map(np.asarray, grads)


@pytest.fixture(scope="module")
def jax_step(models):
    """The batch, and the JAX losses and gradients of the head and the LLM
    on it: one JAX program serves both recipes (a group's gradient does not
    depend on which other groups train)."""
    jp, params = models
    model = _port(params)
    arrays = _batch(model.cfg, model.tokenizer, model.relation_names)
    return (arrays,) + _jax_grads(jp, params, arrays, ("head", "llm"))


def _check_step(params, jax_step, trainable_keys):
    model = _port(params)
    arrays, want_loss, want_grads = jax_step
    tr = trainer.V4Trainer(model, trainable=trainable_keys)
    got_loss, got_grads = tr.gradients(trainer.TrainBatch.from_numpy(arrays, "cpu"))
    assert set(got_loss) == set(want_loss)
    for k, v in want_loss.items():
        assert float(got_loss[k]) == pytest.approx(v, rel=1e-5), k
    assert want_loss["rel_llm_loss"] > 0
    for part in trainable_keys:
        want = part_state_dict(part, want_grads[part])
        assert {f"{part}.{n}" for n in want} == {n for n in got_grads if n.startswith(part + ".")}
        largest = max(float(np.abs(w).max()) for w in want.values())
        for name, w in want.items():
            g = got_grads[f"{part}.{name}"].numpy()
            if name.endswith("k.bias") and "attn" in name:
                # a key bias shifts every score of a query alike, which the
                # softmax cancels: its gradient is 0, both sides roundoff
                assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-5 * largest, name
                continue
            scale = float(np.abs(w).max())
            assert float(np.abs(g - w).max()) <= 1e-4 * scale, (name, scale)
    return model, tr, arrays, {k: want_grads[k] for k in trainable_keys}


def test_train_step_matches_jax(models, jax_step):
    """One step, B=2: the loss dict and every head gradient leaf, then the
    optimizer's update against the JAX train step's (``make_train_step``:
    the same gradients, then the optimizer's update, applied here to the
    JAX gradients already computed, so the forward and backward compile
    once)."""
    _, params = models
    model, tr, arrays, jgrads = _check_step(params, jax_step, ("head",))
    cross = tr.params["head.qformer.cross_attn0.k.weight"]
    assert cross.requires_grad
    sched = dict(steps_per_epoch=10)
    jopt = jtrainer.make_optimizer(jtrainer.make_lr_schedule(**sched))
    trainable = {"head": params["head"]}
    new = jax.jit(lambda g, p: optax.apply_updates(p, jopt.update(g, jopt.init(p), p)[0]))(
        jgrads, trainable)
    opt = trainer.make_optimizer(trainer.make_lr_schedule(**sched))
    metrics = tr.train_step(trainer.TrainBatch.from_numpy(arrays, "cpu"), opt,
                            opt.init(tr.master))
    assert float(metrics["grad_norm"]) == pytest.approx(float(optax.global_norm(jgrads)),
                                                        rel=1e-4)
    for name, w in part_state_dict("head", jax.device_get(new["head"])).items():
        np.testing.assert_allclose(model.head.state_dict()[name].numpy(), w, atol=1e-6, rtol=0,
                                   err_msg=name)


def test_scratch_recipe_trains_the_llm(models, jax_step):
    """``tiny_v4_scratch``: the same groups split as in JAX (the LLM
    trainable), and the LLM's gradients match too."""
    _, params = models
    cfg = Config.fromfile(os.path.join(REPO, "openpsg_tpu_torch/configs/psg/tiny_v4_scratch.py"))
    freeze = checkpoint.freeze_keys_from_config(cfg)
    assert freeze == jckpt.freeze_keys_from_config(cfg, params, True) == {
        "segmenter", "text", "class_embeds"}
    assert checkpoint.trainable_groups(cfg) == ("head", "llm")
    _check_step(params, jax_step, ("head", "llm"))


def test_bf16_head_keeps_float32_masters():
    """A bf16 head trains on float32 master values; the module holds their
    bf16 rounding, and updates far below bf16's resolution accumulate in
    the masters."""
    cfg = PSGv4Config.tiny_test()
    cfg = dataclasses.replace(cfg, head=dataclasses.replace(
        cfg.head, dtype=torch.bfloat16,
        qformer=dataclasses.replace(cfg.head.qformer, dtype=torch.bfloat16)))
    model = PSGv4(cfg, seed=0, device="cpu")
    tr = trainer.V4Trainer(model)
    name = "head.relation_query"
    assert tr.params[name].dtype == torch.bfloat16 and tr.master[name].dtype == torch.float32
    before = tr.master[name].clone()
    opt = trainer.make_optimizer(lambda count: 1e-7)
    state = opt.init(tr.master)
    for _ in range(3):
        opt.step(tr.master, {n: torch.ones_like(m) for n, m in tr.master.items()}, state)
    tr._sync_modules()
    assert not torch.equal(tr.master[name], before)
    assert torch.equal(tr.params[name], tr.master[name].to(torch.bfloat16))


def test_bf16_head_gradients_add_in_float32():
    """A bf16 head's per-image gradients add in float32, not in the bf16
    ``grad``: the B=2 step's gradients equal the mean of the two images'
    own, as a dp=2 step all-reduces them."""
    from openpsg_tpu_torch.tools.dryrun_multichip import _batch

    cfg = PSGv4Config.tiny_test()
    cfg = dataclasses.replace(cfg, head=dataclasses.replace(
        cfg.head, dtype=torch.bfloat16,
        qformer=dataclasses.replace(cfg.head.qformer, dtype=torch.bfloat16)))
    model = PSGv4(cfg, seed=0, device="cpu")
    arrays = _batch(model, np.random.default_rng(2), 2)
    tr = trainer.V4Trainer(model)
    _, both = tr.gradients(trainer.TrainBatch.from_numpy(arrays, "cpu"))
    each = [tr.gradients(trainer.TrainBatch.from_numpy(
        {k: v[i:i + 1] for k, v in arrays.items()}, "cpu"))[1] for i in range(2)]
    assert tr.params["head.relation_query"].dtype == torch.bfloat16
    for name, g in both.items():
        assert g.dtype == torch.float32
        assert torch.equal(g, (each[0][name] + each[1][name]) / 2), name
