"""The port's train tool (openpsg_tpu_torch.tools.train), part checkpoints
and the infer tool's checkpoint restore, on the CPU at the tiny config.

The train tool runs 2 steps on ``tests/fixtures.make_fixture`` (finite
logged losses, a checkpoint holding only the head and its optimizer
state); the infer tool restores the trained head bitwise through both of
its checkpoint surfaces; ``_parse_cfg_value``, ``Config.dump`` and
``update_data_root`` are held against the JAX package's.
"""

import glob
import math
import os
import re
import sys

import pytest
import torch

from fixtures import make_fixture
from openpsg_tpu_torch.core.config import Config, update_data_root
from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config
from openpsg_tpu_torch.tools import infer
from openpsg_tpu_torch.tools import train as train_tool
from openpsg_tpu_torch.train.checkpoint import PartCheckpointer

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "openpsg_tpu_torch/configs/psg/tiny_v4_ov.py")
TAG = "tinytag"


def _jax_tool():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import train as jax_train_tool

    return jax_train_tool


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The train tool, 2 steps with validation, run in the ``exp_tag``
    layout (config ``work_dirs/ov_psg_<tag>/<tag>.py``) → (root, cwd,
    config, the trained model, the tool's stats)."""
    root = str(tmp_path_factory.mktemp("train_psg"))
    ann = make_fixture(root, n_images=8, hw=(64, 64))
    cwd = str(tmp_path_factory.mktemp("cwd"))
    cfg = os.path.join(root, f"{TAG}.py")
    with open(cfg, "w") as f:
        f.write(f"_base_ = [{TINY!r}]\n"
                "data = dict(\n"
                f"    train=dict(ann_file={ann!r}, img_prefix={root!r}, seg_prefix={root!r},\n"
                "               pipeline=[]),\n"
                f"    val=dict(ann_file={ann!r}, img_prefix={root!r}, seg_prefix={root!r}),\n"
                f"    test=dict(ann_file={ann!r}, img_prefix={root!r}, seg_prefix={root!r}))\n"
                "runner = dict(max_epochs=1)\n"
                "log_config = dict(interval=1)\n")
    model = PSGv4(PSGv4Config.tiny_test(), seed=0, device="cpu")
    before = {k: v.clone() for k, v in model.head.state_dict().items()}
    wd = os.path.join(cwd, "work_dirs", f"ov_psg_{TAG}")
    stats = train_tool.main([cfg, "--work-dir", wd, "--max-steps", "2", "--device", "cpu",
                             "--validate", "--val-limit", "2", "--stage-times"], model=model)
    return dict(root=root, ann=ann, cwd=cwd, cfg=cfg, wd=wd, model=model, before=before,
                stats=stats)


def test_train_tool_two_steps(trained):
    stats, wd = trained["stats"], trained["wd"]
    assert stats["steps"] == 2 and len(stats["step_seconds"]) == 2
    assert set(stats["stage_ms"][0]) == {"data", "segmenter", "head", "llm_fwd_bwd", "optimizer"}
    text = "".join(open(p).read() for p in glob.glob(os.path.join(wd, "*.log")))
    lines = [ln for ln in text.splitlines() if "rel_llm_loss" in ln]
    assert len(lines) == 2, text[-2000:]
    for ln in lines:
        for key, val in re.findall(r"(\w+): ([-\w.]+)", ln):
            if key != "time":
                assert math.isfinite(float(val)), (key, val, ln)
    assert "runs unsharded on one device" in text and "] val PQ" in text
    assert os.path.exists(os.path.join(wd, f"{TAG}.py"))            # the dumped config
    # the head trained; every frozen group kept its values
    assert any(not torch.equal(v, trained["before"][k])
               for k, v in trained["model"].head.state_dict().items())
    # the checkpoint holds the head and its optimizer state only
    ckpt = PartCheckpointer(os.path.join(wd, "ckpts"))
    params, opt_state, meta, step = ckpt.restore()
    assert step == 2 and meta["epoch"] == 1 and meta["version"].startswith("0.1.0+")
    assert len(meta["classes"]) == 133
    assert {n.split(".")[0] for n in params} == {"head"}
    assert set(opt_state["mu"]) == set(params) and opt_state["count"] == 2
    assert all(v.dtype == torch.float32 for v in params.values())


def test_frozen_groups_unchanged(trained):
    fresh = PSGv4(PSGv4Config.tiny_test(), seed=0, device="cpu")
    for g in ("segmenter", "llm", "text"):
        a, b = getattr(fresh, g).state_dict(), getattr(trained["model"], g).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), g
    assert torch.equal(fresh.class_embeds, trained["model"].class_embeds)


@pytest.mark.parametrize("surface", ["exp_tag epoch", "--checkpoint"])
def test_infer_restores_the_trained_head(trained, surface, monkeypatch):
    monkeypatch.chdir(trained["cwd"])
    fresh = PSGv4(PSGv4Config.tiny_test(), seed=0, device="cpu")
    assert not all(torch.equal(v, trained["model"].head.state_dict()[k])
                   for k, v in fresh.head.state_dict().items())
    common = ["--device", "cpu", "--test-file", trained["ann"], "--data-dir", trained["root"],
              "--output-dir", os.path.join(trained["cwd"], surface.replace(" ", "_")),
              "--limit", "2"]
    if surface == "exp_tag epoch":
        argv = [TAG, "1"] + common
    else:
        argv = ["--config", trained["cfg"], "--checkpoint",
                os.path.join(trained["wd"], "ckpts")] + common
    stats = infer.main(argv, model=fresh)
    assert os.path.exists(stats["submission"])
    want = trained["model"].head.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in fresh.head.state_dict().items())


def test_checkpoint_round_trip_rotation_and_epochs(tmp_path):
    ck = PartCheckpointer(str(tmp_path / "ckpts"), max_keep=2)
    with pytest.raises(FileNotFoundError):
        ck.restore()
    assert ck.latest_step() is None
    for epoch, step in enumerate((3, 6, 9), start=1):
        params = {"head.w": torch.full((2, 3), float(step))}
        state = {"count": step, "mu": {"head.w": torch.ones(2, 3)},
                 "nu": {"head.w": torch.zeros(2, 3)}}
        ck.save(step, params, state, meta={"epoch": epoch})
    assert ck.all_steps() == [6, 9] and ck.latest_step() == 9      # rotation
    assert ck.step_for_epoch(2) == 6 and ck.step_for_epoch(1) is None
    params, state, meta, step = ck.restore(step=6)
    assert step == 6 and meta == {"epoch": 2} and state["count"] == 6
    assert torch.equal(params["head.w"], torch.full((2, 3), 6.0))
    assert torch.equal(state["mu"]["head.w"], torch.ones(2, 3))
    assert not glob.glob(str(tmp_path / "ckpts" / "*.tmp"))


@pytest.mark.parametrize("val", [
    "1", "-2.5", "true", "None", "'quoted'", "abc", "1,2,3", "[1,2]", "(1,2)", "[]", "()",
    "[(1,2),(3,4)]", "(1,2),(3,4)", "[a,[b,c]]", "1e-4", "x=y",
])
def test_parse_cfg_value_matches_jax(val):
    assert train_tool._parse_cfg_value(val) == _jax_tool()._parse_cfg_value(val)


def test_config_dump_round_trip_and_data_root(tmp_path, monkeypatch):
    from openpsg_tpu.core.config import Config as JaxConfig
    from openpsg_tpu.core.config import update_data_root as jax_update

    cfg = Config.fromfile(TINY)
    cfg.data_root = "/data/coco/"
    cfg.merge_from_dict({"data.train.img_prefix": "/data/coco/train2017",
                         "data.val.seg_prefix": "/data/coco"})
    path = str(tmp_path / "dumped.py")
    cfg.dump(path)
    again = Config.fromfile(path)
    assert again.to_dict() == cfg.to_dict()
    assert update_data_root(cfg) is cfg                              # no env var: no-op
    monkeypatch.setenv("MMDET_DATASETS", "/mnt/other")
    got = update_data_root(cfg).to_dict()
    want = jax_update(JaxConfig(cfg.to_dict())).to_dict()
    assert got == want
    assert got["data"]["train"]["img_prefix"] == "/mnt/other/train2017"
    assert got["data"]["val"]["seg_prefix"] == "/mnt/other"


def test_tool_refusals_and_card_default(tmp_path, monkeypatch, capsys):
    # the port's parallelism runs under torch.distributed.run: other
    # launchers are refused, and --launcher pytorch needs its ranks
    with pytest.raises(SystemExit, match="parallelism"):
        train_tool.main([TINY, "--launcher", "mpi"])
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        train_tool.main([TINY, "--launcher", "pytorch", "--device", "cpu"])
    args = train_tool.parse_args([TINY, "--gpus", "1", "--gpu-ids", "0", "1"])
    assert args.gpus == 1 and args.gpu_ids == [0, 1]
    assert "deprecated" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_tool.main([TINY, "--work-dir", str(tmp_path / "wd")])
    assert not (tmp_path / "wd").exists()


def test_auto_resume_continues_from_the_latest_step(trained, tmp_path):
    """``--auto-resume`` restores the values and the optimizer state of the
    latest step in ``<work_dir>/ckpts`` and counts on from it."""
    wd = str(tmp_path / "wd")
    argv = [trained["cfg"], "--work-dir", wd, "--device", "cpu"]
    model = PSGv4(PSGv4Config.tiny_test(), seed=0, device="cpu")
    train_tool.main(argv + ["--max-steps", "1"], model=model)
    after_one = {k: v.clone() for k, v in model.head.state_dict().items()}
    fresh = PSGv4(PSGv4Config.tiny_test(), seed=0, device="cpu")
    stats = train_tool.main(argv + ["--max-steps", "2", "--auto-resume"], model=fresh)
    assert stats["steps"] == 1 and stats["saved_steps"] == [2]
    params, opt_state, _, step = PartCheckpointer(os.path.join(wd, "ckpts")).restore()
    assert step == 2 and opt_state["count"] == 2
    text = "".join(open(p).read() for p in glob.glob(os.path.join(wd, "*.log")))
    assert "resumed from" in text and "step 1" in text
    assert any(not torch.equal(v, after_one[k]) for k, v in fresh.head.state_dict().items())


def test_infer_refuses_a_missing_checkpoint(trained, tmp_path):
    model = PSGv4(PSGv4Config.tiny_test(), seed=0, device="cpu")
    with pytest.raises(FileNotFoundError, match="no such directory"):
        infer.main(["--config", trained["cfg"], "--checkpoint", str(tmp_path / "none"),
                    "--device", "cpu"], model=model)
