"""The port's synthetic PSG fixture and its end-to-end selfcheck on the CPU.

``openpsg_tpu_torch/utils/fixture.make_fixture`` writes the same bytes as
``tests/fixtures.make_fixture`` (images, panoptic PNGs, json) for the same
arguments.  ``openpsg_tpu_torch.tools.selfcheck_e2e`` runs its three phases
end to end at a few steps (segmenter training, head and LLM training, the
infer tool on the exported files, the grader); R@20 > 0 at its default
steps is checked on the card.
"""

import json
import os

import numpy as np
import pytest
import torch

from openpsg_tpu_torch.tools import selfcheck_e2e
from openpsg_tpu_torch.train.checkpoint import PartCheckpointer
from openpsg_tpu_torch.utils.fixture import make_fixture

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.mark.parametrize("kw", [
    dict(),
    dict(n_images=5, hw=[(64, 48), (32, 64)], seed=3,
         relations=lambda i: [[0, 1, i % 56], [2, 0, 7]]),
])
def test_fixture_is_byte_equal_to_the_jax_one(tmp_path, kw):
    from tests.fixtures import make_fixture as jax_fixture

    a = make_fixture(str(tmp_path / "port"), **kw)
    b = jax_fixture(str(tmp_path / "jax"), **kw)
    assert os.path.basename(a) == os.path.basename(b) == "psg.json"
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert set(got) == set(want) and len(got) == 2 * kw.get("n_images", 4) + 1
    for name in want:
        assert got[name] == want[name], name


def test_selfcheck_runs_end_to_end_on_the_cpu(tmp_path):
    root = str(tmp_path / "sc")
    res = selfcheck_e2e.run(root, seg_steps=3, rel_steps=2, device="cpu", log=lambda *a: None)
    seg = res["seg_losses"]
    assert len(seg) == 2 and all(np.isfinite(list(d.values())).all() for d in seg)
    assert seg[-1]["loss"] < seg[0]["loss"]
    assert len(res["rel_losses"]) == 2
    for key in ("scores", "gt_scores"):
        assert set(res[key]) >= {"R@20", "mR@20"}
    for sub in ("out", "out_gt"):
        with open(os.path.join(root, sub, "submission", "relation.json")) as f:
            assert len(json.load(f)) == 3
    params, _, meta, step = PartCheckpointer(os.path.join(root, "ckpts")).restore()
    assert step == 2 and meta["epoch"] == 1
    assert {n.split(".")[0] for n in params} == {"head", "llm"}
    seg_state = torch.load(os.path.join(root, "segmenter.pt"), weights_only=True)
    model = res["pipeline"]
    assert all(torch.equal(v, model.segmenter.state_dict()[k]) for k, v in seg_state.items())
    np.testing.assert_array_equal(np.load(os.path.join(root, "class_embeds.npy")),
                                  model.class_embeds.detach().numpy())
    with open(os.path.join(root, "selfcheck_cfg.py")) as f:
        assert "freeze_layers=['openseed']" in f.read()
