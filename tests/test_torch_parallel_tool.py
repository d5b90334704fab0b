"""The port's train tool under ``python -m torch.distributed.run``
(``--launcher pytorch``) on gloo ranks on the CPU.

* ``tpu.mesh=dict(dp=2, pp=2, tp=2)`` (8 ranks, the pipelined step) on the
  JAX tool's weights: the logged losses equal those of the JAX tool run
  with the same mesh (``tests/test_train_tool.py``'s run); the checkpoint
  restores through the port's infer tool.
* The scratch recipe (the LLM trained) with dp 1 × tp 2 (the unpipelined
  step): whole-tensor checkpoints, ``--auto-resume`` onto the tp blocks,
  equal to the one-process run.
"""

import glob
import math
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from fixtures import make_fixture
from openpsg_tpu_torch.bridge import load_jax_params
from openpsg_tpu_torch.tools import infer

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")


def _save_v4(model, path):
    state = {p: getattr(model, p).state_dict() for p in ("segmenter", "head", "llm", "text")}
    state["class_embeds"] = model.class_embeds
    torch.save(state, path)


# ------------------------------------------------------ the tool under torchrun
def _logged(text):
    rows = [ln for ln in text.splitlines() if "rel_llm_loss" in ln and "Epoch [" in ln]
    return [{k: float(v) for k, v in re.findall(r"(\w+): ([-\w.]+)", ln) if k != "time"}
            for ln in rows]


@pytest.fixture(scope="module")
def tool_runs(tmp_path_factory, monkeypatch_module):
    """The JAX tool with the 3D mesh on the 8 CPU devices and the port's
    tool under torchrun with the same mesh (8 ranks) on the JAX tool's
    initial weights: torchrun starts as soon as the JAX tool has built its
    model, and runs while the JAX tool compiles and trains."""
    import openpsg_tpu.core.builder as jax_builder

    root = tmp_path_factory.mktemp("tool")
    ann = make_fixture(str(root), n_images=8, hw=(64, 64))
    data = (f"data = dict(train=dict(ann_file='{ann}', img_prefix='{root}', "
            f"seg_prefix='{root}', pipeline=[]), test=dict(ann_file='{ann}', "
            f"img_prefix='{root}', seg_prefix='{root}'))\n"
            "runner = dict(max_epochs=1)\nlog_config = dict(interval=1)\n")
    cfgs = {}
    for side, base in (("jax", "configs/psg"), ("3d", "openpsg_tpu_torch/configs/psg")):
        cfgs[side] = root / f"{side}.py"
        cfgs[side].write_text(f"_base_ = ['{REPO}/{base}/tiny_v4_ov.py']\n"
                              "tpu = dict(mesh=dict(dp=2, pp=2, tp=2))\n" + data)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import train as jax_tool

    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, TESTS]), OMP_NUM_THREADS="1")
    wd = root / "wd_3d"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "8", os.path.join(TESTS, "torch_parallel_ranks.py"), str(root / "v4.pt"),
           str(root / "3d.stats"), str(cfgs["3d"]), "--work-dir", str(wd),
           "--max-steps", "2", "--seed", "0", "--device", "cpu", "--launcher", "pytorch"]

    # the JAX tool's initial weights, kept as it builds its model; the
    # port's run starts from them at once
    built, real_build = [], jax_builder.build_detector_from_config

    def build_and_keep(*a, **k):
        jm = real_build(*a, **k)
        built.append(jax.tree_util.tree_map(np.asarray, jax.device_get(jm.params)))
        model = build_detector_from_config(Config.fromfile(str(cfgs["3d"])), seed=0,
                                           device="cpu")
        load_jax_params(model, built[0])
        _save_v4(model, root / "v4.pt")
        built.append((model, subprocess.Popen(cmd, cwd=str(root), env=env, text=True,
                                              stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT)))
        return jm

    monkeypatch_module.setattr(jax_builder, "build_detector_from_config", build_and_keep)
    monkeypatch_module.setattr(sys, "argv", ["train.py", str(cfgs["jax"]), "--work-dir",
                                             str(root / "wd_jax"), "--max-steps", "2",
                                             "--seed", "0"])
    try:
        jax_tool.main()
    except BaseException:
        if len(built) == 2:
            built[1][1].kill()
        raise
    assert len(built) == 2
    model, proc = built[1]
    out, _ = proc.communicate(timeout=240)
    jax_text = "".join(open(p).read() for p in sorted(glob.glob(str(root / "wd_jax" / "*.log"))))
    assert "GPipe pp×tp" in jax_text
    assert proc.returncode == 0, out[-4000:]
    text = "".join(open(p).read() for p in sorted(glob.glob(str(wd / "*.log"))))
    run = dict(wd=wd, text=text, stats=torch.load(root / "3d.stats", weights_only=False))
    return dict(root=root, ann=ann, cfgs=cfgs, jax=_logged(jax_text), run=run, model=model)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_train_tool_under_torchrun_matches_jax_tool(tool_runs):
    run = tool_runs["run"]
    want = tool_runs["jax"]
    got = run["stats"]["metrics"]
    assert run["stats"]["world"] == 8 and len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            assert math.isfinite(g[k])
            # the JAX log prints 4 decimals
            assert abs(g[k] - v) <= 1e-5 * abs(v) + 5e-5, (k, g[k], v)
    text = run["text"]
    assert "mesh: {'dp': 2, 'pp': 2, 'tp': 2} (GPipe pp×tp)" in text
    assert "LLM pipeline stage layers: (0, 1) of 2" in text
    assert "LLM tensor-sharded tensors on tp=2" in text and "runs unsharded" not in text


def test_torchrun_checkpoints_restore_through_the_infer_tool(tool_runs):
    from openpsg_tpu_torch.train.checkpoint import PartCheckpointer

    ckpts = tool_runs["run"]["wd"] / "ckpts"
    head, opt_state, meta, step = PartCheckpointer(str(ckpts)).restore()
    assert step == 2 and {n.split(".")[0] for n in head} == {"head"}
    fresh = tool_runs["model"]       # the bridged model, its head as before training
    out = tool_runs["root"] / "out"
    stats = infer.main(["--config", str(tool_runs["cfgs"]["3d"]), "--checkpoint", str(ckpts),
                        "--device", "cpu", "--test-file", tool_runs["ann"], "--data-dir",
                        str(tool_runs["root"]), "--output-dir", str(out), "--limit", "2"],
                       model=fresh)
    assert os.path.exists(stats["submission"])
    for name, v in head.items():
        assert torch.equal(fresh.head.state_dict()[name[len("head."):]].float(), v), name


def test_scratch_recipe_tp_checkpoint_and_resume(tmp_path):
    """The scratch recipe (the LLM trained) under torchrun with tp 2: one
    step, then ``--auto-resume`` for a second.  The checkpoint holds whole
    LLM tensors (tp blocks gathered), the resume cuts them back to each
    rank's block, and the losses and final values equal those of the same
    two runs in one process (a resume starts its epoch's data over, as
    the JAX tool's does); the infer tool restores the checkpoint."""
    from openpsg_tpu_torch.tools import train as train_tool
    from openpsg_tpu_torch.train.checkpoint import PartCheckpointer

    ann = make_fixture(str(tmp_path), n_images=4, hw=(64, 64))
    cfg = tmp_path / "scratch.py"
    cfg.write_text(f"_base_ = ['{REPO}/openpsg_tpu_torch/configs/psg/tiny_v4_scratch.py']\n"
                   "tpu = dict(mesh=dict(dp=1, tp=2))\n"
                   f"data = dict(train=dict(ann_file='{ann}', img_prefix='{tmp_path}', "
                   f"seg_prefix='{tmp_path}', pipeline=[]))\n"
                   "runner = dict(max_epochs=2)\nlog_config = dict(interval=1)\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    wd = tmp_path / "wd2"

    def under_torchrun():
        runs = []
        for steps, extra in (("1", []), ("2", ["--auto-resume"])):
            runs.append(subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", "2", "-m", "openpsg_tpu_torch.tools.train", str(cfg),
                 "--work-dir", str(wd), "--max-steps", steps, "--device", "cpu",
                 "--launcher", "pytorch"] + extra,
                cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=240))
            assert runs[-1].returncode == 0, (runs[-1].stdout + runs[-1].stderr)[-4000:]

    with ThreadPoolExecutor(1) as pool:   # beside the one-process runs
        torchrun = pool.submit(under_torchrun)
        one = [train_tool.main([str(cfg), "--work-dir", str(tmp_path / "wd1"), "--max-steps",
                                steps, "--device", "cpu"] + extra)["metrics"][0]
               for steps, extra in (("1", []), ("2", ["--auto-resume"]))]
    torchrun.result()
    text = "".join(open(p).read() for p in sorted(glob.glob(str(wd / "*.log"))))
    # the builder's tiny vocabulary (219) does not split over 2: the
    # embedding and lm_head stay whole, the 14 projections split
    assert "resumed from" in text and "LLM tensor-sharded tensors on tp=2: 14" in text
    got = _logged(text)
    assert len(got) == 2
    for g, w in zip(got, one):
        for k, v in w.items():
            assert abs(g[k] - v) <= 1e-5 * abs(v) + 5e-5, (k, g[k], v)
    want = PartCheckpointer(str(tmp_path / "wd1" / "ckpts")).restore()
    have = PartCheckpointer(str(wd / "ckpts")).restore()
    assert have[3] == want[3] == 2 and {n.split(".")[0] for n in have[0]} == {"head", "llm"}
    for name, v in want[0].items():
        assert have[0][name].shape == v.shape, name                  # whole tensors
        np.testing.assert_allclose(have[0][name].numpy(), v.numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(have[1]["mu"][name].numpy(), want[1]["mu"][name].numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)
    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config

    fresh = build_detector_from_config(Config.fromfile(str(cfg)), seed=0, device="cpu")
    stats = infer.main(["--config", str(cfg), "--checkpoint", str(wd / "ckpts"), "--device",
                        "cpu", "--test-file", ann, "--data-dir", str(tmp_path), "--output-dir",
                        str(tmp_path / "out"), "--limit", "1"], model=fresh)
    assert os.path.exists(stats["submission"])
    for name, v in have[0].items():
        part, _, leaf = name.partition(".")
        assert torch.equal(getattr(fresh, part).state_dict()[leaf].float(), v), name
