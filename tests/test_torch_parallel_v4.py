"""PSG v4's data-parallel and pair-sharded inference and its dp × tp
training step against the JAX package, on gloo ranks on the CPU (one JAX
model for the module; one spawn of 4 ranks runs every rank program, in a
thread started with the module, while the JAX references compile).

* PSG v4 ``infer_batch(mesh=)`` (each dp rank its block of 8 images):
  identical to the port's per-image ``infer`` (panoptic ids, relations,
  scores), again with the LLM tp-sharded (a dp 2 × tp 2 mesh, scores
  within 1e-5); and against JAX ``make_batch_infer`` over a dp mesh of 2
  CPU devices on one image of each size: panoptic ids identical, the same
  triplets with scores within 1e-5, in the same order except where two
  scores lie within 1e-5 of each other (float32 roundoff orders such a
  near-tie either way; the 8 images held one 1.2e-7 apart).
* ``make_pair_sharded_infer`` (the Q-Former on 1/4 of the pairs per rank,
  its outputs gathered) against plain ``infer``: identical, as the JAX
  package's ``tests/test_pipeline.py`` pins it.
* The closed-set family's ``infer_batch(mesh=)`` against its per-image
  ``infer``.
* A dp 2 × tp 2 train step (4 ranks, each dp rank its image of a B=2
  batch, the LLM tp-sharded), the reference recipe (head trained) and the
  scratch recipe (head and LLM trained, masters and AdamW moments per
  shard): losses within 1e-5 relative and every gradient within 1e-4 (of
  its leaf's largest entry) of JAX's step on a dp 2 × tp 2 mesh of 4 of
  the 8 CPU devices; the global norm within 1e-5.  One JAX step with
  head and LLM trainable serves both recipes (the head recipe's
  gradients are its head part; the fusion's ``iou_thr`` does not enter
  training).

The dry run and the train tool under ``torch.distributed.run`` are in
``test_torch_parallel_train.py`` and ``test_torch_parallel_tool.py``.
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openpsg_tpu.models.detectors.psg_v4 import PSGv4 as JaxPSGv4
from openpsg_tpu.models.detectors.psg_v4 import PSGv4Config as JaxPSGv4Config
from openpsg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from openpsg_tpu.parallel.sharding import batch_sharding, shard_params as jax_shard
from openpsg_tpu.train import trainer as jtrainer
from openpsg_tpu_torch.bridge import load_jax_params, part_state_dict
from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config
from openpsg_tpu_torch.parallel.launch import spawn
from openpsg_tpu_torch.tools.dryrun_multichip import _batch

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8
JAX_IMAGES = (0, 4)     # one image of each size


def _same(got, want, what):
    np.testing.assert_array_equal(got["pan_results"], want["pan_results"], err_msg=what)
    assert got["rel_results"] == want["rel_results"], what
    np.testing.assert_allclose(got["rel_scores"], want["rel_scores"], atol=1e-5, err_msg=what)


def _same_up_to_near_ties(got, want, what):
    """Panoptic ids and objects identical; the same triplets, each with its
    score within 1e-5; the order equal except among scores within 1e-5."""
    np.testing.assert_array_equal(got["pan_results"], want["pan_results"], err_msg=what)
    g, w = got["rel_results"], want["rel_results"]
    assert g["object_id_list"] == w["object_id_list"], what
    gs = {tuple(t): s for t, s in zip(g["relation"], got["rel_scores"])}
    ws = {tuple(t): s for t, s in zip(w["relation"], want["rel_scores"])}
    assert gs.keys() == ws.keys() and len(gs) == len(g["relation"]), what
    for t in gs:
        assert abs(gs[t] - ws[t]) <= 1e-5, (what, t)
    for k, (a, b) in enumerate(zip(g["relation"], w["relation"])):
        if a != b:
            assert abs(got["rel_scores"][k] - want["rel_scores"][k]) <= 1e-5, (what, k)


@pytest.fixture(scope="module")
def jax_v4(tmp_path_factory):
    """The JAX model (tiny, fusion at iou_thr 0.1 so that it keeps objects)
    and the port's model with its weights, saved for the ranks."""
    root = tmp_path_factory.mktemp("v4")
    jp = JaxPSGv4(dataclasses.replace(JaxPSGv4Config.tiny_test(), iou_thr=0.1),
                  jax.random.PRNGKey(0))
    model = PSGv4(dataclasses.replace(PSGv4Config.tiny_test(), iou_thr=0.1), seed=0,
                  device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, jax.device_get(jp.params)))
    state = {p: getattr(model, p).state_dict() for p in ("segmenter", "head", "llm", "text")}
    state["class_embeds"] = model.class_embeds
    torch.save(state, root / "v4.pt")
    return jp, model, root


RECIPES = {"head": ("head",), "scratch": ("head", "llm")}


@pytest.fixture(scope="module")
def ranks(jax_v4):
    """Every rank program of the module in one spawn of 4 ranks, started in
    a thread: dp infer (v4), the family's infer_batch, and the dp × tp step
    of each recipe.  → the inputs, and ``result()``, which waits for the
    ranks → [per rank: the programs' results, in that order]."""
    jp, model, root = jax_v4
    rng = np.random.default_rng(6)
    imgs = rng.integers(0, 255, (N, 64, 64, 3)).astype(np.float32)
    hws = np.asarray([[64, 64]] * 4 + [[56, 60]] * 4, np.int32)
    cfg = root / "tiny_r50.py"
    cfg.write_text(f"_base_ = ['{REPO}/openpsg_tpu_torch/configs/psg/tiny_r50.py']\n"
                   "model = dict(test_cfg=dict(object_mask_thr=0.0))\n")
    # image 0 is the family tests' image, on which the tiny model keeps objects
    fam_imgs = np.random.default_rng(0).integers(0, 256, (4, 64, 64, 3)).astype(np.float32)
    fam_hws = np.asarray([[64, 64], [56, 60], [64, 64], [48, 64]], np.int32)
    arrays = _batch(model, np.random.default_rng(4), 2)
    tasks = [("v4_infer", (str(root / "v4.pt"), imgs, hws, dict(iou_thr=0.1))),
             ("family_infer", (str(cfg), fam_imgs, fam_hws))]
    tasks += [("v4_train", (str(root / "v4.pt"), arrays, keys, 2, 2)) for keys in RECIPES.values()]
    ranks = ThreadPoolExecutor(1).submit(spawn, "torch_parallel_ranks:llm_suite", 4,
                                         str(root / "ranks"), args=(tasks,), timeout_s=360)
    return dict(imgs=imgs, hws=hws, arrays=arrays, result=ranks.result)


@pytest.fixture(scope="module")
def v4(jax_v4, ranks):
    jp, model, root = jax_v4
    imgs, hws = ranks["imgs"], ranks["hws"]
    # JAX's batch program on one image of each size (its cost grows with
    # the images), over a dp mesh of 2 of the 8 CPU devices
    jmesh = jax_make_mesh(dp=2, tp=1, devices=jax.devices()[:2])
    with jmesh:
        want = dict(zip(JAX_IMAGES, jp.infer_batch(imgs[list(JAX_IMAGES)],
                                                   hws[list(JAX_IMAGES)], mesh=jmesh)))
    got = [rank[0] for rank in ranks["result"]()]
    return model, imgs, hws, want, got


def test_v4_infer_batch_equals_per_image_infer(v4):
    model, imgs, hws, _, got = v4
    single = [model.infer(i, h) for i, h in zip(imgs, hws)]
    assert sum(len(s["rel_results"]["relation"]) for s in single) > 0
    for rank in got:
        assert len(rank["batch"]) == N and len(rank["batch_tp"]) == 4
        for i, (g, w) in enumerate(zip(rank["batch"], single)):
            assert g["rel_results"] == w["rel_results"] and g["rel_scores"] == w["rel_scores"]
            np.testing.assert_array_equal(g["pan_results"], w["pan_results"])
        for i, (g, w) in enumerate(zip(rank["batch_tp"], single)):
            _same(g, w, f"tp-sharded LLM, image {i}")


def test_v4_infer_batch_matches_jax_batch_program(v4):
    _, _, _, want, got = v4
    assert sum(len(w["rel_results"]["relation"]) for w in want.values()) > 0
    for rank in got:
        for i, w in want.items():
            g = rank["batch"][i]
            _same_up_to_near_ties(g, w, f"image {i}")


def test_pair_sharded_matches_plain_infer(v4):
    model, imgs, hws, want, got = v4
    plain = model.infer(imgs[0], hws[0])
    M = model.cfg.head.max_objects_padded
    for rank in got:
        assert rank["pair_np"] == [M * M // 4]          # each rank's share of the pairs
        _same(rank["pair"], plain, "pair-sharded vs infer")
        _same_up_to_near_ties(rank["pair"], want[0], "pair-sharded vs JAX")


def test_family_infer_batch_matches_per_image(ranks):
    got = [rank[1] for rank in ranks["result"]()]
    single = got[0]["single"]
    assert sum(len(s["rel_results"]["relation"]) for s in single) > 0
    for rank in got:
        for i, (g, w) in enumerate(zip(rank["batch"], single)):
            _same(g, w, f"image {i}")


# ------------------------------------------------------------ dp × tp step
def _jax_step(jp, arrays, trainable_keys):
    """JAX's loss and gradients on a dp 2 × tp 2 mesh (the LLM sharded by
    its Megatron rules, the batch on dp) → (losses, {part: gradients})."""
    mesh = jax_make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    jt = jtrainer.V4Trainer(jp)
    params = jax.tree_util.tree_map(jnp.asarray, jp.params)
    params["llm"] = jax_shard(params["llm"], mesh)
    batch = jtrainer.TrainBatch(**{k: jax.device_put(jnp.asarray(v), batch_sharding(mesh))
                                   for k, v in arrays.items()})
    trainable = {k: params[k] for k in trainable_keys}
    frozen = {k: v for k, v in params.items() if k not in trainable_keys}

    def loss_fn(tr):
        per_image = jax.vmap(lambda b: jt.loss_single(tr, frozen, b))(batch)
        loss_dict = jax.tree_util.tree_map(jnp.mean, per_image)
        return sum(loss_dict.values()), loss_dict

    with mesh:
        (total, loss), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(trainable)
    loss = {k: float(v) for k, v in loss.items()}
    loss["loss"] = float(total)
    return loss, jax.tree_util.tree_map(np.asarray, jax.device_get(grads))


@pytest.fixture(scope="module")
def dp_tp(jax_v4, ranks):
    jp = jax_v4[0]
    loss, grads = _jax_step(jp, ranks["arrays"], RECIPES["scratch"])
    want = {name: (loss, float(optax.global_norm({k: grads[k] for k in keys})),
                   {k: grads[k] for k in keys}) for name, keys in RECIPES.items()}
    got = [rank[2:] for rank in ranks["result"]()]
    return RECIPES, want, got


@pytest.mark.parametrize("recipe", ["head", "scratch"])
def test_dp_tp_step_matches_jax(dp_tp, recipe):
    recipes, want, got = dp_tp
    i = list(recipes).index(recipe)
    w_loss, w_norm, w_grads = want[recipe]
    assert w_loss["rel_llm_loss"] > 0
    for rank in got:
        res = rank[i]
        assert set(res["loss"]) == set(w_loss)
        for k, v in w_loss.items():
            assert res["loss"][k] == pytest.approx(v, rel=1e-5), k
        assert res["grad_norm"] == pytest.approx(w_norm, rel=1e-5)
        assert res["llm_sharded"] == 16
        if recipe == "scratch":
            assert res["mu_sharded"] == 16          # AdamW moments per shard
        for part in recipes[recipe]:
            w = part_state_dict(part, w_grads[part])
            assert {f"{part}.{n}" for n in w} == {n for n in res["grads"] if n.startswith(part)}
            largest = max(float(np.abs(a).max()) for a in w.values())
            for name, a in w.items():
                g = res["grads"][f"{part}.{name}"]
                if name.endswith("k.bias") and "attn" in name:
                    # a key bias shifts every score of a query alike, which
                    # the softmax cancels: both gradients are roundoff
                    assert max(np.abs(g).max(), np.abs(a).max()) <= 1e-5 * largest, name
                    continue
                assert float(np.abs(g - a).max()) <= 1e-4 * float(np.abs(a).max()), name
