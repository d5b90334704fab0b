"""The train tool's family branch (``openpsg_tpu_torch.tools.train``) on
``tiny_r50.py`` on the CPU, against the JAX package's ``M2FTrainer`` on the
same weights (bridged) and the tool's own first batch: 2 steps with
``--stage-times`` and ``--validate``, a part checkpoint of ``{head,
object_cls_embed}``, ``tools.infer --checkpoint`` restoring it, and
``--resume-from``.  The first step's losses within 1e-5 relative of the JAX
step's; restored tensors bitwise equal to the trained ones.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpsg_tpu_torch.bridge import load_jax_params
from openpsg_tpu_torch.core import builder
from openpsg_tpu_torch.core.config import Config
from openpsg_tpu_torch.data.preprocess import Preprocessor
from openpsg_tpu_torch.data.psg_dataset import PSGDataset
from openpsg_tpu_torch.tools import infer
from openpsg_tpu_torch.tools import train as train_tool
from openpsg_tpu_torch.train.checkpoint import PartCheckpointer
from openpsg_tpu_torch.train.trainer import m2f_host_batch
from openpsg_tpu_torch.utils.fixture import make_fixture

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from openpsg_tpu.core.builder import build_detector_from_config as jax_build
    from openpsg_tpu.core.config import Config as JaxConfig
    from openpsg_tpu.train import trainer as jtrainer

    tmp = tmp_path_factory.mktemp("m2f_train")
    root = str(tmp / "psg")
    ann = make_fixture(root, n_images=4, hw=(64, 64))
    split = f"dict(ann_file={ann!r}, img_prefix={root!r}, seg_prefix={root!r})"
    cfgs = {}
    for side, base in (("jax", "configs/psg"), ("port", "openpsg_tpu_torch/configs/psg")):
        cfgs[side] = str(tmp / f"{side}.py")
        with open(cfgs[side], "w", encoding="utf-8") as f:
            f.write(f"_base_ = ['{REPO}/{base}/tiny_r50.py']\n"
                    f"data = dict(train={split}, val={split}, test={split})\n"
                    "log_config = dict(interval=1)\n")
    jp = jax_build(JaxConfig.fromfile(cfgs["jax"]), jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jp.params))
    model = builder.build_detector_from_config(Config.fromfile(cfgs["port"]), device="cpu")
    load_jax_params(model, params)

    # the JAX step's losses on the tool's first batch (same seed, same draws)
    H, _ = model._model_hw()
    ds = PSGDataset(ann, img_prefix=root, seg_prefix=root, split="train")
    first = next(ds.iter_train(Preprocessor(scale=(H, H)), model.cfg.max_objects_padded, 1,
                               seed=0))
    arrays = m2f_host_batch(first)
    jt = jtrainer.M2FTrainer(jp)
    jb = jtrainer.M2FTrainBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    frozen = {"segmenter": params["segmenter"]}
    trainable = {k: params[k] for k in ("head", "object_cls_embed")}
    jloss = jax.jit(lambda tr: jax.tree_util.tree_map(jnp.mean, jax.vmap(
        lambda b: jt.loss_single(tr, frozen, b))(jb)))(trainable)

    wd = str(tmp / "wd")
    stats = train_tool.main([cfgs["port"], "--work-dir", wd, "--max-steps", "2", "--device",
                             "cpu", "--stage-times", "--validate", "--val-limit", "2"],
                            model=model)
    return dict(tmp=tmp, root=root, ann=ann, cfg=cfgs["port"], model=model, wd=wd, stats=stats,
                jloss={k: float(v) for k, v in jloss.items()})


def test_family_trains_through_the_tool(trained):
    stats = trained["stats"]
    assert stats["steps"] == 2 and stats["saved_steps"] == [2]
    first = stats["metrics"][0]
    for k, v in trained["jloss"].items():
        assert first[k] == pytest.approx(v, rel=1e-5), k
    assert first["loss"] == pytest.approx(trained["jloss"]["loss_relation"], rel=1e-5)
    assert all(np.isfinite(list(m.values())).all() for m in stats["metrics"])
    assert set(stats["stage_ms"][0]) == {"data", "segmenter", "head", "optimizer"}
    assert set(stats["val"][0]) >= {"PQ", "SQ", "RQ"}
    log = "".join(open(os.path.join(trained["wd"], f)).read()
                  for f in os.listdir(trained["wd"]) if f.endswith(".log"))
    assert "trainable groups: ['head', 'object_cls_embed'] frozen: ['segmenter']" in log
    assert "tensors no-decay" in log and "loss_relation" in log


def test_checkpoint_holds_the_trainable_groups(trained):
    params, opt_state, meta, step = PartCheckpointer(
        os.path.join(trained["wd"], "ckpts")).restore()
    groups = trained["model"].param_groups()
    want = {f"{g}.{n}" for g in ("head", "object_cls_embed") for n in groups[g]}
    assert step == 2 and meta["epoch"] == 1 and set(params) == want
    assert set(opt_state["mu"]) == want and opt_state["count"] == 2
    for name, v in params.items():
        g, n = name.split(".", 1)
        assert torch.equal(v, groups[g][n].detach()), name


@pytest.mark.parametrize("mode", [[], ["--gt-masks"]])
def test_infer_restores_the_checkpoint(trained, mode):
    fresh = builder.build_detector_from_config(Config.fromfile(trained["cfg"]), seed=5,
                                               device="cpu")
    out = str(trained["tmp"] / f"out{len(mode)}")
    st = infer.main(["--config", trained["cfg"], "--checkpoint",
                     os.path.join(trained["wd"], "ckpts"), "--test-file", trained["ann"],
                     "--data-dir", trained["root"], "--output-dir", out, "--device", "cpu",
                     "--img-scale", "64", "64"] + mode, model=fresh)
    assert st["n_images"] == 2 and os.path.exists(st["submission"])
    have, want = fresh.param_groups(), trained["model"].param_groups()
    for g in ("head", "object_cls_embed"):
        for n, t in want[g].items():
            assert torch.equal(have[g][n], t.detach()), f"{g}.{n}"


def test_resume_from_continues_the_count(trained, tmp_path):
    fresh = builder.build_detector_from_config(Config.fromfile(trained["cfg"]), seed=5,
                                               device="cpu")
    stats = train_tool.main([trained["cfg"], "--work-dir", str(tmp_path), "--max-steps", "3",
                             "--device", "cpu", "--resume-from",
                             os.path.join(trained["wd"], "ckpts")], model=fresh)
    assert stats["steps"] == 1 and stats["saved_steps"] == [3]
    _, opt_state, _, step = PartCheckpointer(os.path.join(tmp_path, "ckpts")).restore()
    assert step == 3 and opt_state["count"] == 3


def test_family_defaults_to_the_card(trained, tmp_path, monkeypatch):
    assert train_tool.parse_args([trained["cfg"]]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_tool.main([trained["cfg"], "--work-dir", str(tmp_path / "wd")])
