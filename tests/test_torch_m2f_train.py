"""The port's training step of the closed-set v1 / v2 / v3 family
(``openpsg_tpu_torch.train.trainer.M2FTrainer``) against the JAX package's
(``openpsg_tpu.train.trainer.M2FTrainer``) at the tiny configs: v1, v1 with
``object_token_size`` 2, v2 with a text KV store (an expert that reads the
triplet text, and the gate, which reads pair and triplet text) and v3.

The same weights (bridged from the JAX params) and the same seeded batch
(B = 2).  Tolerances: every entry of the loss dict within 1e-5 relative;
each gradient leaf of ``head`` and ``object_cls_embed`` within 1e-4 of that
leaf's largest magnitude (against ``jax.value_and_grad`` of the JAX step's
``loss_fn``); leaves whose gradient is 0 up to roundoff (below 1e-6 of the
largest, e.g. attention key biases, which the softmax cancels) are held to
1e-5 of the largest on the port's side; after one AdamW step the values
within 1e-6 absolute of the JAX update (optax's chain, applied to the JAX
gradients) and the global norms within 1e-4 relative.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openpsg_tpu.data.text_kv import TextKVStore as JaxKV
from openpsg_tpu.models.detectors import mask2former_relation as jm2f
from openpsg_tpu.train import checkpoint as jckpt
from openpsg_tpu.train import trainer as jtrainer
from openpsg_tpu_torch.bridge import load_jax_params, part_state_dict, scan_prefixes
from openpsg_tpu_torch.core.config import Config
from openpsg_tpu_torch.data.text_kv import TextKVStore
from openpsg_tpu_torch.data.vocab import OBJECT_CLASSES, RELATION_CLASSES
from openpsg_tpu_torch.models.detectors import mask2former_relation as m2f
from openpsg_tpu_torch.train import checkpoint, trainer

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ("v1", "v1_tokens2", "v2_text", "v3")


def _cfg(mod, case):
    """The case's config in module ``mod`` (the JAX or the port package)."""
    cfg = mod.M2FRelationConfig.tiny_test(case[:2])
    if case == "v1_tokens2":
        cfg = dataclasses.replace(cfg, object_token_size=2)
    if case == "v2_text":
        cfg = dataclasses.replace(cfg, head_v2=dataclasses.replace(
            cfg.head_v2, experts=("object_vision_only", "triplet_text_w_vision"),
            use_moe_gate=True, text_embedding_size=8))
    return cfg


def _kv_table():
    rng = np.random.default_rng(4)
    table = {}
    for a in OBJECT_CLASSES[:5]:
        for b in OBJECT_CLASSES[:5]:
            table[f"{a}#{b}"] = rng.normal(size=8).astype(np.float32)
            for r in RELATION_CLASSES[:4]:
                table[f"{a}#{b}#{r}"] = rng.normal(size=8).astype(np.float32)
    return table


def _batch(M, B=2, seed=0):
    rng = np.random.default_rng(seed)
    valid = np.stack([np.arange(M) < 4, np.arange(M) < 3])[:B]
    target = np.zeros((B, M, M, 56), np.float32)
    target[:, 0, 1, 2] = target[:, 0, 1, 4] = target[:, 2, 0, 3] = target[0, 3, 1, 1] = 1
    return dict(
        image=rng.integers(0, 255, (B, 64, 64, 3)).astype(np.float32),
        object_masks=(rng.uniform(size=(B, M, 16, 16)) > 0.7) & valid[:, :, None, None],
        object_labels=rng.integers(0, 5, (B, M)).astype(np.int32),
        object_valid=valid, relation_target=target)


@pytest.fixture(scope="module")
def results():
    """case → the JAX and port losses, gradients and updated values (each
    case computed once, on first use)."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _run(case)
        return cache[case]

    return get


@functools.lru_cache(maxsize=None)
def _jax_model(version):
    """The JAX model of a head version, built once (v1's serves both v1
    cases: the token count changes no parameter)."""
    kv = JaxKV(embedding_size=8, table=_kv_table()) if version == "v2" else None
    jp = jm2f.PSGMask2FormerRelation(_cfg(jm2f, {"v2": "v2_text"}.get(version, version)),
                                     jax.random.PRNGKey(0), text_kv=kv)
    return jp, jax.tree_util.tree_map(np.asarray, jax.device_get(jp.params))


def _run(case):
    use_kv = case == "v2_text"
    jp, params = _jax_model(case[:2])
    jp.cfg = dataclasses.replace(jp.cfg, object_token_size=_cfg(jm2f, case).object_token_size)
    model = m2f.PSGMask2FormerRelation(_cfg(m2f, case), seed=0, device="cpu",
                                       text_kv=TextKVStore(embedding_size=8, table=_kv_table())
                                       if use_kv else None)
    load_jax_params(model, params)
    arrays = _batch(model.cfg.max_objects_padded)

    jt = jtrainer.M2FTrainer(jp)
    jb = jtrainer.M2FTrainBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    trainable = {k: params[k] for k in m2f.TRAINABLE_GROUPS}
    frozen = {"segmenter": params["segmenter"]}

    def loss_fn(tr):
        per_image = jax.vmap(lambda b: jt.loss_single(tr, frozen, b))(jb)
        loss_dict = jax.tree_util.tree_map(jnp.mean, per_image)
        return sum(v for k, v in loss_dict.items() if k.startswith("loss_relation")), loss_dict

    (total, jloss), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(trainable)
    jloss = {k: float(v) for k, v in jloss.items()}
    jloss["loss"] = float(total)
    sched = dict(steps_per_epoch=10)
    jopt = jtrainer.make_optimizer(jtrainer.make_lr_schedule(**sched))
    jnew = jax.tree_util.tree_map(np.asarray, jax.jit(lambda g, p: optax.apply_updates(
        p, jopt.update(g, jopt.init(p), p)[0]))(jgrads, trainable))

    tr = trainer.M2FTrainer(model)
    before = {n: v.detach().clone() for n, v in tr.master.items()}
    batch = trainer.M2FTrainBatch.from_numpy(arrays, "cpu")
    loss, grads = tr.gradients(batch)
    opt = trainer.make_optimizer(trainer.make_lr_schedule(**sched))
    norm = opt.step(tr.master, grads, opt.init(tr.master))
    tr._sync_modules()

    def by_name(tree):
        out = {f"head.{n}": v for n, v in part_state_dict(
            "head", tree["head"], scanned=scan_prefixes(model.head, "head")).items()}
        out["object_cls_embed.object_cls_embed"] = np.asarray(tree["object_cls_embed"])
        return out

    return dict(jloss=jloss, jgrads=by_name(jax.tree_util.tree_map(np.asarray, jgrads)),
                jnorm=float(optax.global_norm(jgrads)), jnew=by_name(jnew),
                jold=by_name(trainable), loss={k: float(v) for k, v in loss.items()},
                grads={n: g.numpy() for n, g in grads.items()}, norm=float(norm),
                new={n: v.detach().numpy() for n, v in tr.master.items()},
                old={n: v.numpy() for n, v in before.items()}, model=model)


@pytest.mark.parametrize("case", CASES)
def test_losses_and_gradients_match_jax(results, case):
    r = results(case)
    assert set(r["loss"]) == set(r["jloss"])
    for k, v in r["jloss"].items():
        assert r["loss"][k] == pytest.approx(v, rel=1e-5), k
    assert r["jloss"]["loss"] > 0
    assert set(r["grads"]) == set(r["jgrads"])
    largest = max(float(np.abs(w).max()) for w in r["jgrads"].values())
    n_zero = 0
    for name, w in r["jgrads"].items():
        g = r["grads"][name]
        scale = float(np.abs(w).max())
        if scale < 1e-6 * largest:     # 0 up to roundoff
            n_zero += 1
            assert float(np.abs(g).max()) <= 1e-5 * largest, name
            continue
        assert float(np.abs(g - w).max()) <= 1e-4 * scale, (name, scale)
    assert n_zero < len(r["jgrads"]) // 4
    assert float(np.abs(r["grads"]["object_cls_embed.object_cls_embed"]).max()) > 0


@pytest.mark.parametrize("case", CASES)
def test_optimizer_step_matches_jax(results, case):
    r = results(case)
    assert r["norm"] == pytest.approx(r["jnorm"], rel=1e-4)
    for name, w in r["jnew"].items():
        np.testing.assert_allclose(r["new"][name], w, atol=1e-6, rtol=0, err_msg=name)
        np.testing.assert_array_equal(r["old"][name], r["jold"][name])
    moved = sum(not np.array_equal(r["new"][n], r["old"][n]) for n in r["new"])
    assert moved > len(r["new"]) // 2
    # the module holds the masters' values (float32: the masters themselves)
    model = r["model"]
    assert torch.equal(model.object_cls_embed,
                       torch.from_numpy(r["new"]["object_cls_embed.object_cls_embed"]))


def test_v2_losses_per_expert_and_text(results):
    """One loss per enabled expert and the gate (the reference's
    mask2former_relation_v2.py:639-668); the triplet text, gathered by
    label, reaches the expert and the gate (their weights get gradients
    that depend on it)."""
    r = results("v2_text")
    assert {k for k in r["loss"] if k.startswith("loss_relation")} == {
        "loss_relation_object_vision_only", "loss_relation_triplet_text_w_vision",
        "loss_relation_moe"}
    moe = [n for n in r["grads"] if ".moe_out." in n or n.startswith("head.moe_out")]
    assert moe and all(np.abs(r["grads"][n]).max() > 0 for n in moe)
    assert r["loss"]["loss"] == pytest.approx(sum(
        v for k, v in r["loss"].items() if k.startswith("loss_relation")), rel=1e-6)


def test_f7_v3_trains_the_llama_blocks(results):
    """F7, a reference behaviour the port copies: the family branch ignores
    ``freeze_layers`` (baseline_v3_ov.py freezes ``relation_head.llama_model``),
    so the whole head group trains, its Llama blocks included, in both
    packages."""
    cfg = Config.fromfile(os.path.join(REPO, "openpsg_tpu_torch/configs/psg/baseline_v3_ov.py"))
    assert any("llama" in f for f in cfg.model.train_cfg.freeze_layers)
    groups = dict.fromkeys(m2f.GROUPS)
    assert checkpoint.freeze_keys_from_config(cfg) == jckpt.freeze_keys_from_config(
        cfg, groups, False) == {"segmenter"}
    assert checkpoint.trainable_groups(cfg) == ("head", "object_cls_embed")
    r = results("v3")
    blocks = [n for n in r["new"] if n.startswith("head.llama.") and ".layers." in n]
    assert blocks
    for n in blocks:
        assert np.abs(r["grads"][n]).max() > 0 and np.abs(r["jgrads"][n]).max() > 0, n
        assert not np.array_equal(r["new"][n], r["old"][n]), n
        assert not np.array_equal(r["jnew"][n], r["jold"][n]), n


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("version", ["v1", "v3"])
def test_paramwise_multipliers_match_jax(version):
    """baseline_r50.py's ``paramwise_cfg`` (norm_decay_mult 0 reaches the
    head's LayerNorms; its custom keys match nothing in the head) gives
    every trainable tensor its JAX leaf's multipliers."""
    cfg = Config.fromfile(os.path.join(REPO, "openpsg_tpu_torch/configs/psg/baseline_r50.py"))
    pw = cfg.optimizer.paramwise_cfg
    keys = dict(pw.custom_keys)
    _, params = _jax_model(version)
    trainable = {k: params[k] for k in m2f.TRAINABLE_GROUPS}
    want_lr, want_dec = jtrainer.paramwise_multipliers(trainable, keys, pw.norm_decay_mult)
    model = m2f.PSGMask2FormerRelation(_cfg(m2f, version), seed=0, device="cpu")
    tr = trainer.M2FTrainer(model)
    paths = tr.jax_paths()
    assert set(paths) == set(tr.master)
    lr, dec = trainer.paramwise_multipliers(paths, keys, pw.norm_decay_mult)
    for name, path in paths.items():
        assert lr[name] == float(_leaf(want_lr, path)), name
        assert dec[name] == float(_leaf(want_dec, path)), name
    assert set(lr.values()) == {1.0} and 0.0 in dec.values() and 1.0 in dec.values()
