"""The port against the JAX package on the functions no path calls yet, and
on the files the JAX package writes.

* Fusion: ``panoptic_fusion(filter_low_score=)``, ``panoptic_fusion_area``,
  ``extract_object_lists`` and ``extract_object_lists_area`` on the cases
  of ``tests/test_segmenter.py`` (``TestPanopticFusion``,
  ``TestPanopticFusionAreaMode``) and on seeded tie-free logits: ids, paint
  positions, survivors and object lists exact, scores within 1e-6.
* Decoupled labels: ``decouple_label_masks`` equal to the JAX function
  (mask and positions exact, the cases of ``tests/test_llm.py``
  ``TestDecoupledLabelMasks`` and more); the port's tiny Llama on the JAX
  weights fed the mask as ``full_mask``, with and without a cache, within
  1e-5 of the JAX Llama's logits; a later segment's logits do not move
  with an earlier segment's token.
* Checkpoints: one JAX model (``PSGv4Config.tiny_test()`` at ``iou_thr``
  0.1, the model ``test_torch_psg_v4.py`` compiles; ``tiny_v4_ov.py``'s
  training rules) writes a part checkpoint of its trainable groups with
  the JAX ``PartCheckpointer`` (orbax) and its segmenter as
  ``segmenter.msgpack`` with flax ``serialization.to_bytes``, as
  ``tools/convert_openseed.py`` does.  The port reads both (tensorstore and
  msgpack, no JAX): ``infer`` equals the JAX model's after the JAX restore;
  ``epoch=`` picks the step through each step's meta; predict's head-only
  restore takes the head checkpoint and refuses one that also holds the LLM
  (F8); with ``tensorstore`` or ``msgpack`` unimportable the port raises an
  ``ImportError`` naming it; and a process where jax, flax, orbax, optax
  and the JAX package cannot be imported reads both files.
* Resuming a JAX run's training: the JAX tiny model's head and LLM trees
  are traced, not compiled (``jax.eval_shape`` of their initializers), and
  filled with seeded values; the JAX ``make_optimizer`` chain takes 3
  seeded updates (one jitted update program serves the chain with and
  without paramwise multipliers, its fifth member), and the JAX
  ``PartCheckpointer`` saves values and chain state.  The port reads both
  without JAX (``OrbaxPartReader.opt_state``, ``read_training_state``): one
  more update with the same gradients, bridged, gives values and both
  AdamW moments within 1e-6 of the JAX update, relative to the largest
  magnitude of each (values, first moments, second moments), and the same
  count, the LLM's scanned blocks unstacked.  The port's train tool resumes
  from a JAX orbax directory given to ``--resume-from`` (that directory,
  not ``<work_dir>/ckpts``: the JAX tool's F11) and found by
  ``--auto-resume``, at the JAX step, and writes its own ``step_<N>``
  after.  Refused by name: another optax chain, Adam and schedule counts
  that differ, moments that do not cover the trained groups.  A process
  that cannot import JAX reads the state.
"""

import dataclasses
import glob
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fixtures import make_fixture
from openpsg_tpu.models.detectors.psg_v4 import PSGv4 as JaxPSGv4
from openpsg_tpu.models.detectors.psg_v4 import PSGv4Config as JaxPSGv4Config
from openpsg_tpu.models.llm import llama as jllama
from openpsg_tpu.models.segmenter import fusion as jfusion
from openpsg_tpu.train import trainer as jtrainer
from openpsg_tpu.train.checkpoint import PartCheckpointer as JaxCheckpointer
from openpsg_tpu_torch.bridge import load_jax_params, load_part, part_state_dict
from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config
from openpsg_tpu_torch.models.llm import llama as tllama
from openpsg_tpu_torch.models.segmenter import fusion as tfusion
from openpsg_tpu_torch.tools import train as train_tool
from openpsg_tpu_torch.train import trainer
from openpsg_tpu_torch.train.checkpoint import (
    OrbaxPartReader,
    PartCheckpointer,
    port_params,
    read_training_state,
)

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL = dict(rtol=0, atol=1e-6)
LOGIT_TOL = dict(rtol=0, atol=1e-5)

# the JAX fusion functions jitted, as the JAX model runs them (one compile
# per case instead of one per operation)
JAX_FUSION = jax.jit(jfusion.panoptic_fusion, static_argnames=(
    "cls_mode", "object_mask_thr", "iou_thr", "filter_low_score", "instance_mode", "num_things"))
JAX_FUSION_AREA = jax.jit(jfusion.panoptic_fusion_area,
                          static_argnames=("object_mask_thr", "num_things"))


# ------------------------------------------------------------------ fusion
def _mk(Q=4, K=6, H=8, W=8):
    return np.full((Q, K), -10.0, np.float32), np.full((Q, H, W), -10.0, np.float32)


def _raw_cases():
    """The inputs of ``tests/test_segmenter.py::TestPanopticFusion``, each
    with its keyword arguments."""
    cases = {}
    c, m = _mk()
    c[0, 0] = c[1, 0] = c[2, 3] = 5.0
    m[0, :4, :4] = m[1, 4:, :4] = m[2, :, 4:] = 10.0
    cases["two_things_one_stuff"] = (c, m, dict(num_things=2))
    cases["void"] = (*_mk(), dict(num_things=2))
    c, m = _mk(Q=2, K=4)
    c[0, 0], c[1, 1] = 8.0, 2.0
    m[0] = 10.0
    m[1, :2, :2] = 10.0
    cases["occluded"] = (c, m, dict(num_things=2))
    c, m = _mk(Q=3, K=5)
    c[0, 3] = c[1, 3] = 5.0
    m[0, :4] = 10.0
    m[1, 4:] = 10.0
    cases["stuff_merge"] = (c, m, dict(num_things=2))
    c, m = _mk(Q=2, K=5)
    c[0, 0] = c[1, 4] = 9.0
    m[0, :4] = 10.0
    m[1, 4:] = 10.0
    cases["softmax_void"] = (c, m, dict(cls_mode="softmax_void", object_mask_thr=0.8,
                                        instance_mode="global", num_things=2))
    rng = np.random.default_rng(11)
    c = rng.normal(0, 3, (10, 7)).astype(np.float32)
    m = rng.normal(0, 2, (10, 24, 20)).astype(np.float32)
    region = np.zeros((24, 20), bool)
    region[:20, :18] = True
    cases["seeded"] = (c, m, dict(num_things=4, iou_thr=0.3, object_mask_thr=0.3))
    cases["seeded_global_region"] = (c, m, dict(num_things=4, iou_thr=0.3, object_mask_thr=0.3,
                                                instance_mode="global", region_mask=region))
    return cases


def _same_fusion(got, want):
    for f in ("pan_seg", "object_ids", "survive", "labels"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("winner_score", "query_scores"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   err_msg=f, **SCORE_TOL)


def _same_lists(got, want):
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], **SCORE_TOL)


@pytest.mark.parametrize("filter_low_score", [False, True])
@pytest.mark.parametrize("case", list(_raw_cases()))
def test_panoptic_fusion_matches_jax(case, filter_low_score):
    c, m, kw = _raw_cases()[case]
    region = kw.pop("region_mask", None)
    want = JAX_FUSION(jnp.asarray(c), jnp.asarray(m), filter_low_score=filter_low_score,
                      region_mask=None if region is None else jnp.asarray(region), **kw)
    got = tfusion.panoptic_fusion(torch.from_numpy(c), torch.from_numpy(m),
                                  filter_low_score=filter_low_score,
                                  region_mask=None if region is None else torch.from_numpy(region),
                                  **kw)
    _same_fusion(got, want)
    _same_lists(tfusion.extract_object_lists(got), jfusion.extract_object_lists(want))


def test_filter_low_score_drops_weak_pixels():
    """A query that wins pixels where its own mask is below 0.5 keeps them
    only without ``filter_low_score``."""
    c, m = _mk(Q=2, K=4)
    c[0, 0], c[1, 1] = 5.0, 5.0
    m[0, :, :4] = 10.0
    m[0, :, 4:] = -0.5          # prob 0.38: wins over query 1's 0.0000454
    m[1, :, 4:] = -10.0
    kw = dict(num_things=2, iou_thr=0.1)
    plain = tfusion.panoptic_fusion(torch.from_numpy(c), torch.from_numpy(m), **kw)
    filt = tfusion.panoptic_fusion(torch.from_numpy(c), torch.from_numpy(m),
                                   filter_low_score=True, **kw)
    assert (plain.pan_seg[:, 4:] == 0).all() and (filt.pan_seg[:, 4:] == tfusion.VOID_ID).all()
    assert torch.equal(plain.pan_seg[:, :4], filt.pan_seg[:, :4])


def _area_cases():
    rng = np.random.default_rng(7)
    cases = [(rng.normal(0, 3, (8, 5)).astype(np.float32),
              rng.normal(0, 2, (8, 16, 16)).astype(np.float32), None) for _ in range(5)]
    c = np.full((2, 3), -10.0, np.float32)
    c[0, 0] = c[1, 0] = 8.0
    m = np.full((2, 8, 8), -10.0, np.float32)
    m[0, :4, :4] = 10.0
    m[1] = 10.0
    cases.append((c, m, None))             # the big mask overpainted, both listed
    c, m, _ = cases[0]
    region = np.zeros((16, 16), bool)
    region[:12, :10] = True
    cases.append((c, m, region))
    return cases


@pytest.mark.parametrize("i", range(len(_area_cases())))
def test_panoptic_fusion_area_matches_jax(i):
    c, m, region = _area_cases()[i]
    want, want_pos = JAX_FUSION_AREA(
        jnp.asarray(c), jnp.asarray(m), object_mask_thr=0.3, num_things=2,
        region_mask=None if region is None else jnp.asarray(region))
    got, got_pos = tfusion.panoptic_fusion_area(
        torch.from_numpy(c), torch.from_numpy(m), object_mask_thr=0.3, num_things=2,
        region_mask=None if region is None else torch.from_numpy(region))
    _same_fusion(got, want)
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    got_lists = tfusion.extract_object_lists_area(got, got_pos)
    _same_lists(got_lists, jfusion.extract_object_lists_area(want, want_pos))
    assert got_lists[0]
    if i == 5:
        ids = got_lists[0]
        assert len(ids) == 2 and got.pan_seg[0, 0] == ids[1] and got.pan_seg[7, 7] == ids[0]


# ------------------------------------------------------ decoupled labels
ARE, COMMA = 50, 51
DECOUPLE_IDS = {
    "reference": [[7, 8, 9, ARE, 20, 21, COMMA, 22, COMMA]],
    "trailing": [[7, ARE, 20, COMMA, 22, 23, COMMA, 24, 25]],
    "batch": [[7, 8, ARE, 20, COMMA, 22, COMMA, 0, 0],
              [COMMA, 8, ARE, 20, 21, COMMA, 22, 23, 24]],   # a delimiter in the prompt
    "no_answer": [[7, 8, 9, 20, COMMA, 22, COMMA, 1, 2]],
}


@pytest.mark.parametrize("decouple_positions", [False, True])
@pytest.mark.parametrize("case", list(DECOUPLE_IDS))
def test_decouple_label_masks_matches_jax(case, decouple_positions):
    ids = np.asarray(DECOUPLE_IDS[case])
    got = tllama.decouple_label_masks(ids, ARE, COMMA, decouple_positions)
    want = jllama.decouple_label_masks(ids, ARE, COMMA, decouple_positions)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if case == "reference" and decouple_positions:
        m, pos = got[0][0], got[1][0]
        assert m[6, :4].all() and m[6, 4:7].all()
        assert m[8, :4].all() and not m[8, 4:7].any() and m[8, 7:9].all()
        np.testing.assert_array_equal(pos[7:9], [3, 4])


@pytest.fixture(scope="module")
def llama_pair():
    jm = jllama.LlamaWithEmbeddings(jllama.LlamaConfig.tiny_test(vocab_size=64))
    params = jax.jit(lambda k: jm.init(
        k, token_ids=jnp.zeros((1, 4), jnp.int32), attention_mask=jnp.ones((1, 4), bool),
        positions=jnp.zeros((1, 4), jnp.int32)))(jax.random.PRNGKey(3))
    port = tllama.LlamaWithEmbeddings(tllama.LlamaConfig.tiny_test(vocab_size=64))
    load_part(port, "llm", jax.tree_util.tree_map(np.asarray, jax.device_get(params)))
    apply = jax.jit(lambda p, kw: jm.apply(p, **kw))    # → (logits, cache)
    return apply, params, port.eval()


def _jax_logits(pair, ids, mask, pos, full):
    apply, params, _ = pair
    return np.asarray(apply(params, dict(
        token_ids=jnp.asarray(ids, jnp.int32), attention_mask=jnp.asarray(mask),
        positions=jnp.asarray(pos), full_mask=jnp.asarray(full)))[0])


def _port_logits(pair, ids, mask, pos, full, **kw):
    with torch.no_grad():
        return pair[2](token_ids=torch.from_numpy(np.asarray(ids)).long(),
                       attention_mask=torch.from_numpy(mask),
                       positions=torch.from_numpy(np.asarray(pos)).long(),
                       full_mask=torch.from_numpy(full), **kw)[0].numpy()


@pytest.mark.parametrize("decouple_positions", [False, True])
def test_llama_full_mask_matches_jax(llama_pair, decouple_positions):
    ids = np.array([[7, 8, ARE, 20, COMMA, 22, COMMA, 0],
                    [9, 8, ARE, 21, 23, COMMA, 24, 25]])
    full, pos = tllama.decouple_label_masks(ids, ARE, COMMA, decouple_positions)
    attn = ids != 0
    want = _jax_logits(llama_pair, ids, attn, pos, full)
    got = _port_logits(llama_pair, ids, attn, pos, full)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)

    # with a cache of the whole length: the first P tokens, then the rest,
    # each block's full_mask its rows over every slot
    cfg = llama_pair[2].cfg
    B, L = ids.shape
    P = 3
    hd = cfg.dim // cfg.n_heads
    jcache = jllama.init_kv_cache(jllama.LlamaConfig.tiny_test(vocab_size=64), B, L)
    shape = (cfg.n_layers, B, L, cfg.n_kv_heads, hd)
    tcache = (torch.zeros(shape), torch.zeros(shape))
    outs = []
    for lo, hi in ((0, P), (P, L)):
        jw, jcache = llama_pair[0](llama_pair[1], dict(
            token_ids=jnp.asarray(ids[:, lo:hi], jnp.int32), attention_mask=jnp.asarray(attn),
            positions=jnp.asarray(pos[:, lo:hi]), cache=jcache, cache_index=jnp.int32(lo),
            key_positions=jnp.asarray(pos), full_mask=jnp.asarray(full[:, lo:hi])))
        tg = _port_logits(llama_pair, ids[:, lo:hi], attn, pos[:, lo:hi], full[:, lo:hi],
                          cache=tcache, cache_index=lo,
                          key_positions=torch.from_numpy(pos).long())
        np.testing.assert_allclose(tg, np.asarray(jw), **LOGIT_TOL)
        outs.append(tg)
    np.testing.assert_allclose(np.concatenate(outs, 1), got, **LOGIT_TOL)


def test_later_segment_ignores_earlier_segment(llama_pair):
    ids = np.array([[7, 8, ARE, 20, COMMA, 22, COMMA, 0]])
    ids2 = ids.copy()
    ids2[0, 3] = 21
    out = []
    for x in (ids, ids2):
        full, pos = tllama.decouple_label_masks(x, ARE, COMMA)
        out.append(_port_logits(llama_pair, x, x != 0, pos, full))
    np.testing.assert_allclose(out[0][0, 5:7], out[1][0, 5:7], **LOGIT_TOL)
    assert not np.allclose(out[0][0, 3:5], out[1][0, 3:5], atol=1e-3)


# ------------------------------------------------------------ checkpoints
def _tree(x):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(x))


_NO_JAX = """
import sys
for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'openpsg_tpu'):
    sys.modules[m] = None
import torch
from openpsg_tpu_torch.core.config import Config
from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config
from openpsg_tpu_torch.train.checkpoint import restore_trainable_for_inference
cfg_path, msgpack_path, ckpt_dir, out = sys.argv[1:]
cfg = Config.fromfile(cfg_path)
model = PSGv4(PSGv4Config.tiny_test(), seed=1, device='cpu')
model.load_segmenter_weights(msgpack_path)
print(restore_trainable_for_inference(model, cfg, ckpt_dir)[0])
torch.save({f'{g}.{k}': v for g in ('segmenter', 'head')
            for k, v in getattr(model, g).state_dict().items()}, out)
"""


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """One JAX model, its part checkpoints (orbax) and segmenter.msgpack;
    then, at once: a process that cannot import the JAX side reads both
    files, and (in a thread) the JAX model is restored at epoch 1 and run
    on two images (``want()`` waits for it)."""
    import optax
    from flax import serialization

    from openpsg_tpu.core.config import Config as JaxConfig
    from openpsg_tpu.models.detectors.psg_v4 import PSGv4 as JaxPSGv4
    from openpsg_tpu.models.detectors.psg_v4 import PSGv4Config as JaxPSGv4Config
    from openpsg_tpu.train.checkpoint import PartCheckpointer as JaxCheckpointer
    from openpsg_tpu.train.checkpoint import freeze_keys_from_config as jax_freeze
    from openpsg_tpu.train.checkpoint import (
        restore_trainable_for_inference as jax_restore,
    )

    root = tmp_path_factory.mktemp("interop")
    cfgs = {}
    for side, base in (("jax", "configs/psg"), ("port", "openpsg_tpu_torch/configs/psg")):
        cfgs[side] = root / f"{side}.py"
        cfgs[side].write_text(f"_base_ = ['{REPO}/{base}/tiny_v4_ov.py']\n"
                              "tpu = dict(input_hw=(64, 64))\n")
    jcfg = JaxConfig.fromfile(str(cfgs["jax"]))     # its training rules only
    jp = JaxPSGv4(dataclasses.replace(JaxPSGv4Config.tiny_test(), iou_thr=0.1),
                  jax.random.PRNGKey(0))
    initial = _tree(jp.params)
    with open(root / "segmenter.msgpack", "wb") as f:
        f.write(serialization.to_bytes({"params": jp.params["segmenter"]["params"]}))

    freeze = jax_freeze(jcfg, jp.params, is_v4=True)
    trainable = {k: v for k, v in jp.params.items() if k not in freeze}
    assert set(trainable) == {"head"}
    rng = np.random.default_rng(5)

    def moved(tree):
        return jax.tree_util.tree_map(
            lambda x: x + jnp.asarray(0.05 * rng.standard_normal(x.shape), x.dtype), tree)

    saved = {}
    ck = JaxCheckpointer(str(root / "ck"))
    for step, epoch in ((3, 1), (6, 2)):
        saved[step] = moved(trainable)
        ck.save(step, saved[step], optax.adamw(1e-4).init(saved[step]),
                {"epoch": epoch, "classes": ["a", "b"]})
    with_llm = dict(saved[3], llm=jp.params["llm"])
    ck2 = JaxCheckpointer(str(root / "ck_llm"))
    ck2.save(1, with_llm, optax.sgd(1e-4).init(with_llm), {"epoch": 1})
    ck.close()
    ck2.close()

    no_jax = subprocess.Popen(
        [sys.executable, "-c", _NO_JAX, str(cfgs["port"]), str(root / "segmenter.msgpack"),
         str(root / "ck"), str(root / "nojax.pt")], cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO))
    rng = np.random.default_rng(9)
    imgs = [rng.integers(0, 256, (64, 64, 3)).astype(np.uint8) for _ in range(2)]
    hws = [(64, 64), (56, 60)]

    def jax_side():
        step, meta = jax_restore(jp, jcfg, str(root / "ck"), epoch=1, is_v4=True)
        assert step == 3 and meta["epoch"] == 1
        want = [jp.infer(i, np.asarray(hw, np.int32)) for i, hw in zip(imgs, hws)]
        assert sum(len(w["rel_results"]["object_id_list"]) for w in want) >= 2
        return want

    return dict(root=root, cfgs=cfgs, initial=initial, saved={k: _tree(v) for k, v in
                                                              saved.items()},
                imgs=imgs, hws=hws, want=ThreadPoolExecutor(1).submit(jax_side).result,
                no_jax=no_jax)


def _port_model(s):
    from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config

    return PSGv4(dataclasses.replace(PSGv4Config.tiny_test(), iou_thr=0.1), seed=1,
                 device="cpu")


def test_jax_checkpoint_and_msgpack_give_the_jax_models_outputs(ckpts):
    from openpsg_tpu_torch.core.config import Config
    from openpsg_tpu_torch.train.checkpoint import restore_trainable_for_inference

    model = _port_model(ckpts)
    load_jax_params(model, ckpts["initial"])
    with torch.no_grad():
        for p in model.segmenter.parameters():
            p.zero_()
    model.load_segmenter_weights(str(ckpts["root"] / "segmenter.msgpack"))
    want_seg = part_state_dict("segmenter", ckpts["initial"]["segmenter"])
    for name, value in model.segmenter.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), want_seg[name], err_msg=name)
    step, meta = restore_trainable_for_inference(
        model, Config.fromfile(str(ckpts["cfgs"]["port"])), str(ckpts["root"] / "ck"), epoch=1)
    assert step == 3 and meta == {"epoch": 1, "classes": ["a", "b"]}
    for img, hw, want in zip(ckpts["imgs"], ckpts["hws"], ckpts["want"]()):
        got = model.infer(img, hw)
        np.testing.assert_array_equal(got["pan_results"], want["pan_results"])
        assert got["rel_results"] == want["rel_results"]
        np.testing.assert_allclose(got["rel_scores"], want["rel_scores"], rtol=0, atol=1e-5)


def test_epochs_map_to_steps_and_predict_takes_the_head(ckpts):
    from openpsg_tpu_torch.core.config import Config
    from openpsg_tpu_torch.tools.predict import restore_head
    from openpsg_tpu_torch.train.checkpoint import (
        OrbaxPartReader,
        open_checkpoint,
        restore_trainable_for_inference,
    )

    ck = str(ckpts["root"] / "ck")
    reader = open_checkpoint(ck)
    assert isinstance(reader, OrbaxPartReader) and reader.all_steps() == [3, 6]
    assert [reader.step_for_epoch(e) for e in (1, 2, 3)] == [3, 6, None]
    model = _port_model(ckpts)
    cfg = Config.fromfile(str(ckpts["cfgs"]["port"]))
    for epoch, step in ((2, 6), (None, 6), (1, 3)):
        got, _ = restore_trainable_for_inference(model, cfg, ck, epoch=epoch)
        assert got == step
        want = part_state_dict("head", ckpts["saved"][step]["head"])
        for name, value in model.head.state_dict().items():
            np.testing.assert_array_equal(value.numpy(), want[name], err_msg=name)
    with pytest.raises(FileNotFoundError, match="epoch 3"):
        restore_trainable_for_inference(model, cfg, ck, epoch=3)
    assert restore_head(model, ck) == 6
    with pytest.raises(ValueError, match="head group alone"):
        restore_head(model, str(ckpts["root"] / "ck_llm"))


@pytest.mark.parametrize("blocked", ["tensorstore", "msgpack"])
def test_missing_reader_package_is_named(ckpts, blocked, monkeypatch):
    from openpsg_tpu_torch.core.config import Config
    from openpsg_tpu_torch.train.checkpoint import restore_trainable_for_inference

    monkeypatch.setitem(sys.modules, blocked, None)
    model = _port_model(ckpts)
    with pytest.raises(ImportError, match=f"needs the '{blocked}' package"):
        if blocked == "tensorstore":
            restore_trainable_for_inference(model, Config.fromfile(str(ckpts["cfgs"]["port"])),
                                            str(ckpts["root"] / "ck"))
        else:
            model.load_segmenter_weights(str(ckpts["root"] / "segmenter.msgpack"))


def test_reading_needs_no_jax(ckpts):
    """Both files read in a process where the JAX side cannot be imported."""
    out, err = ckpts["no_jax"].communicate(timeout=300)
    assert ckpts["no_jax"].returncode == 0, err[-3000:]
    assert out.strip().splitlines()[-1] == "6"
    got = torch.load(ckpts["root"] / "nojax.pt", weights_only=True)
    want = {f"{g}.{k}": v for g, tree in (("segmenter", ckpts["initial"]["segmenter"]),
                                          ("head", ckpts["saved"][6]["head"]))
            for k, v in part_state_dict(g, tree).items()}
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].numpy(), value, err_msg=name)


@pytest.mark.parametrize("fmt", ["msgpack", "orbax"])
def test_jax_file_leaves_decode_exactly(tmp_path, fmt, monkeypatch):
    """bfloat16 leaves become the float32 of the same value, other dtypes
    stay; flax's chunked arrays (its limit lowered to 16 bytes) and numpy
    scalars come back whole."""
    from flax import serialization

    from openpsg_tpu_torch.utils.jax_files import read_flax_msgpack, read_orbax_tree

    rng = np.random.default_rng(2)
    tree = {"bf16": jnp.asarray(rng.normal(size=(3, 5)), jnp.bfloat16),
            "f32": rng.normal(size=(7,)).astype(np.float32),
            "nested": {"i8": rng.integers(-127, 128, (4, 2)).astype(np.int8)}}
    want = {"bf16": np.asarray(tree["bf16"].astype(jnp.float32)), "f32": tree["f32"],
            "nested": {"i8": tree["nested"]["i8"]}}
    if fmt == "msgpack":
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 16)
        tree["nested"]["scalar"] = np.float32(2.5)
        want["nested"]["scalar"] = np.float32(2.5)
        path = tmp_path / "t.msgpack"
        path.write_bytes(serialization.to_bytes(tree))
        assert b"__msgpack_chunked_array__" in path.read_bytes()
        got = read_flax_msgpack(str(path))
    else:
        import optax

        from openpsg_tpu.train.checkpoint import PartCheckpointer as JaxCheckpointer

        ck = JaxCheckpointer(str(tmp_path / "ck"))
        ck.save(1, tree, optax.sgd(0.1).init(tree), {})
        ck.close()
        got = read_orbax_tree(str(tmp_path / "ck" / "1" / "params"))

    def flat(t, p=()):
        return {k: v for kk, vv in t.items()
                for k, v in (flat(vv, p + (kk,)).items() if isinstance(vv, dict)
                             else [(p + (kk,), vv)])}

    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(g, w, err_msg=str(k))


# ------------------------------------------- resuming a JAX run's training
TINY = os.path.join(REPO, "openpsg_tpu_torch/configs/psg/tiny_v4_ov.py")
SCHED = dict(base_lr=1e-2, warmup_iters=3, warmup_ratio=0.1, step_epochs=(1,),
             steps_per_epoch=4)
PARAMWISE = dict(custom_keys={"qformer": dict(lr_mult=0.1)}, norm_decay_mult=0.0)


def _traced_params(seed):
    """The JAX tiny model's head and LLM trees, traced by ``jax.eval_shape``
    of their initializers as ``PSGv4._init_params`` calls them (no program
    compiles), filled with seeded float32 values."""

    class Bare(JaxPSGv4):   # tokenizers and modules only
        def _init_params(self, rng, pce):
            return {}

    jp = Bare(JaxPSGv4Config.tiny_test(), jax.random.PRNGKey(0))
    c = jp.cfg
    M, H4 = c.head.max_objects_padded, jp._model_hw()[0] // 4
    Ti = jp.qf_parts["max_len"]
    Lp = c.head.qformer.num_relation_queries + jp.llm_parts["max_len"]
    key = jax.random.PRNGKey(0)
    shapes = {
        "head": jax.eval_shape(jp.head.init, key, jnp.zeros((H4, H4, c.segmenter.mask_dim)),
                               jnp.zeros((M, H4, H4), bool), jnp.zeros((M,), bool),
                               jnp.zeros((M * M, Ti), jnp.int32), jnp.zeros((M * M, Ti), bool)),
        "llm": jax.eval_shape(lambda k: jp.llm.init(
            k, token_ids=jnp.zeros((1, Lp), jnp.int32), attention_mask=jnp.ones((1, Lp), bool),
            positions=jnp.zeros((1, Lp), jnp.int32)), key),
    }
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def _zeros(fn, *args):
    """``fn(*args)``'s result as zeros, traced (no program compiles): an
    optimizer's initial state."""
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  jax.eval_shape(fn, *args))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _grads(tree, rng):
    return jax.tree_util.tree_map(
        lambda x: (0.02 * rng.standard_normal(x.shape)).astype(np.float32), tree)


@jax.jit
def _jax_update(grads, state, values, lr_mult, decay_mult):
    """One update of the JAX ``make_optimizer`` chain with paramwise
    multipliers (its five members), the multipliers passed in, so one
    program serves every multiplier tree; with all multipliers 1 it computes
    the four-member chain's update bit for bit (``make_optimizer``'s
    docstring), whose state is the first four members."""
    tx = jtrainer.make_optimizer(jtrainer.make_lr_schedule(**SCHED), max_norm=1.0,
                                 weight_decay=0.05, lr_mult_tree=lr_mult,
                                 decay_mult_tree=decay_mult)
    upd, state = tx.update(grads, state, values)
    return optax.apply_updates(values, upd), state


_NO_JAX_RESUME = """
import sys
for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'openpsg_tpu'):
    sys.modules[m] = None
import torch
from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config
from openpsg_tpu_torch.train.checkpoint import read_training_state
ckpt_dir, out = sys.argv[1:]
model = PSGv4(PSGv4Config.tiny_test(), seed=1, device='cpu')
names = [f'head.{n}' for n, _ in model.head.named_parameters()]
params, state, meta, step = read_training_state(model, ckpt_dir, names)
print(step, state['count'])
torch.save(dict(params=params, mu=state['mu'], nu=state['nu']), out)
"""


@pytest.fixture(scope="module")
def jax_ckpts(tmp_path_factory):
    """Seeded JAX values of the tiny model's head and LLM; JAX orbax
    checkpoints after 3 updates of the chain with and without paramwise
    multipliers, and the next update; the head alone, as ``tiny_v4_ov.py``
    trains it; refused states; a process without JAX reading the head
    checkpoint."""
    root = tmp_path_factory.mktemp("resume")
    tree = _traced_params(seed=0)
    rng = np.random.default_rng(1)
    out = dict(root=root, runs={})
    for pw in (False, True):
        ones = jax.tree_util.tree_map(lambda x: 1.0, tree)
        lr, dec = jtrainer.paramwise_multipliers(tree, **PARAMWISE) if pw else (ones, ones)
        values, state = tree, _zeros(jtrainer.make_optimizer(lambda c: 0.0, lr_mult_tree=lr,
                                                             decay_mult_tree=dec).init, tree)
        for _ in range(3):
            values, state = _numpy(_jax_update(_grads(values, rng), state, values, lr, dec))
        grads = _grads(values, rng)
        nxt = _numpy(_jax_update(grads, state, values, lr, dec))
        if not pw:
            state = state[:4]
        ck = JaxCheckpointer(str(root / f"ck_pw{int(pw)}"))
        ck.save(3, values, state, {"epoch": 1})
        ck.close()
        out["runs"][pw] = dict(grads=grads, next=nxt)
        if not pw:
            head_state = state[:1] + (state[1]._replace(mu={"head": state[1].mu["head"]},
                                                        nu={"head": state[1].nu["head"]}),) \
                + state[2:]
            head = {"head": values["head"]}
    out["head_values"] = head
    for name, st in (
            ("ck_head", head_state),
            ("ck_adamw", _zeros(optax.adamw(1e-4).init, head)),
            ("ck_counts", head_state[:3] + (head_state[3]._replace(
                count=head_state[3].count + 1),)),
            ("ck_moments", state)):          # moments of the head and the LLM
        ck = JaxCheckpointer(str(root / name))
        ck.save(3, head, st, {"epoch": 1})
        ck.close()
    out["no_jax"] = subprocess.Popen(
        [sys.executable, "-c", _NO_JAX_RESUME, str(root / "ck_head"), str(root / "nojax.pt")],
        cwd=REPO, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO))
    return out


def _tiny_model():
    return PSGv4(PSGv4Config.tiny_test(), seed=1, device="cpu")


def _close(got, want, what):
    """Every tensor within 1e-6 of the largest magnitude among ``want``'s
    tensors (max-norm relative error of the whole state)."""
    assert set(got) == set(want), what
    want = {k: np.asarray(w) for k, w in want.items()}
    scale = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-6 * scale,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("paramwise", [False, True])
def test_one_more_update_matches_the_jax_update(jax_ckpts, paramwise):
    run = jax_ckpts["runs"][paramwise]
    model = _tiny_model()
    reader = OrbaxPartReader(str(jax_ckpts["root"] / f"ck_pw{int(paramwise)}"))
    assert reader.all_steps() == [3]
    params = port_params(model, reader.params(3))
    state = reader.opt_state(3, model)
    assert state["count"] == 3
    lr = dec = None
    if paramwise:
        paths = trainer.V4Trainer(model, trainable=("head", "llm")).jax_paths()
        lr, dec = trainer.paramwise_multipliers(paths, **PARAMWISE)
        assert {m for m in lr.values()} == {0.1, 1.0} and 0.0 in dec.values()
    opt = trainer.make_optimizer(trainer.make_lr_schedule(**SCHED), max_norm=1.0,
                                 weight_decay=0.05, lr_mult=lr, decay_mult=dec)
    # the LLM's scanned blocks land unstacked, each moment where its weight lands
    assert any(k.startswith("llm.core.layers.1.") for k in state["mu"])
    opt.step(params, port_params(model, run["grads"]), state)
    values, jstate = run["next"]
    adam = jstate[1]
    _close(params, port_params(model, values), "values")
    _close(state["mu"], port_params(model, adam.mu), "first moments")
    _close(state["nu"], port_params(model, adam.nu), "second moments")
    assert state["count"] == int(adam.count) == int(jstate[3].count) == 4


def _tool_cfg(tmp_path):
    root = str(tmp_path / "data")
    ann = make_fixture(root, n_images=4, hw=(64, 64))
    cfg = str(tmp_path / "cfg.py")
    with open(cfg, "w") as f:
        f.write(f"_base_ = [{TINY!r}]\n"
                f"data = dict(train=dict(ann_file={ann!r}, img_prefix={root!r}, "
                f"seg_prefix={root!r}, pipeline=[]))\n"
                "runner = dict(max_epochs=1)\nlog_config = dict(interval=1)\n")
    return cfg


@pytest.mark.parametrize("how", ["resume_from", "auto_resume"])
def test_train_tool_resumes_a_jax_run(jax_ckpts, tmp_path, how):
    """The tool continues the JAX run at its step.  ``--resume-from`` reads
    the directory it names even where ``<work_dir>/ckpts`` holds another
    run (F11: the JAX tool restores ``<work_dir>/ckpts`` whatever the path
    given); ``--auto-resume`` finds the JAX steps in ``<work_dir>/ckpts``."""
    cfg, wd = _tool_cfg(tmp_path), str(tmp_path / "wd")
    jax_dir = str(jax_ckpts["root"] / "ck_head")
    argv = [cfg, "--work-dir", wd, "--device", "cpu"]
    if how == "resume_from":
        train_tool.main(argv + ["--max-steps", "1"], model=_tiny_model())   # a port run at step 1
        argv += ["--resume-from", jax_dir]
    else:
        shutil.copytree(jax_dir, os.path.join(wd, "ckpts"))
        argv += ["--auto-resume"]
    model = _tiny_model()
    stats = train_tool.main(argv + ["--max-steps", "5"], model=model)
    assert stats["steps"] == 2 and stats["saved_steps"] == [5]
    ck = PartCheckpointer(os.path.join(wd, "ckpts"))
    assert ck.latest_step() == 5
    _, state, _, _ = ck.restore()
    assert state["count"] == 5
    text = "".join(open(p).read() for p in glob.glob(os.path.join(wd, "*.log")))
    resumed_from = jax_dir if how == "resume_from" else os.path.join(wd, "ckpts")
    assert f"resumed from {resumed_from} step 3 (AdamW count 3)" in text


def test_refusals_are_named(jax_ckpts):
    model = _tiny_model()
    root = jax_ckpts["root"]
    names = [f"head.{n}" for n, _ in model.head.named_parameters()]
    with pytest.raises(ValueError, match="not the state of the JAX make_optimizer chain"):
        read_training_state(model, str(root / "ck_adamw"), names)
    with pytest.raises(ValueError, match="scale_by_adam's count 3 differs from "
                                         "scale_by_learning_rate's count 4"):
        read_training_state(model, str(root / "ck_counts"), names)
    with pytest.raises(KeyError, match="first moments do not cover exactly the trainable"):
        read_training_state(model, str(root / "ck_moments"), names)
    # values, moments and count as the JAX run left them
    params, state, meta, step = read_training_state(model, str(root / "ck_head"), names)
    assert step == 3 and meta == {"epoch": 1} and state["count"] == 3
    _close(params, port_params(model, jax_ckpts["head_values"]), "values")


def test_reading_the_state_needs_no_jax(jax_ckpts):
    proc = jax_ckpts["no_jax"]
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    assert out.strip().splitlines()[-1] == "3 3"
    got = torch.load(jax_ckpts["root"] / "nojax.pt", weights_only=True)
    _, want, _, _ = read_training_state(_tiny_model(), str(jax_ckpts["root"] / "ck_head"),
                                        got["params"])
    for k in ("mu", "nu"):
        assert set(got[k]) == set(want[k])
        assert all(torch.equal(got[k][n], want[k][n]) for n in want[k])
