"""The port's server over a dp mesh on 2 gloo ranks against the JAX
``tools/serve.py`` ``InferenceService`` over a dp mesh of 2 CPU devices.

One model pair (``PSGv4Config.tiny_test()`` at 64², fusion at ``iou_thr``
0.1, the JAX model whose dp-mesh batch program ``test_torch_parallel_v4.py``
compiles too; the port's with its weights bridged).  The ranks
(``parallel.launch.spawn``, ``tests/torch_parallel_ranks.py::serve_dp``)
run the server with ``--batch-size 2`` while the JAX references compile:
rank 0 serves over HTTP (``make_server``), rank 1 follows (``main``).
Rank 0 posts image 0 alone (``infer`` on rank 0 alone), images 0 and 1 at
once (a group of 2, one image per rank), the same pair again (rank 1's
block raises: both requests fail, every rank goes on), waits idle past the
process group's collective timeout (the rank program forms the group anew
with ``COLLECTIVE_S``), posts images 1 and 2 at once, then at batch size 4
images 0-2 at once (a padded tail, 2 images per rank).  Every record equals the JAX
service's record of its image: relations, segments_info and
object_id_list exactly, relation scores within 1e-5 absolute, and the
decoded PNG pixels exactly.  The JAX service runs its dp-mesh batch program
on groups of 2 (images 0 and 1, then image 2 with its copy), which the JAX
package holds equal to its per-image program.  Every rank exits 0 after
``stop()``, and the follower ran exactly the groups that went over the mesh.
"""

import base64
import dataclasses
import os
import pathlib
import sys
from concurrent.futures import ThreadPoolExecutor

import cv2
import jax
import numpy as np
import pytest
import torch

from openpsg_tpu_torch.bridge import load_jax_params
from openpsg_tpu_torch.parallel.launch import spawn
from openpsg_tpu_torch.tools import serve

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HWS = [(64, 48), (48, 64), (64, 64)]
COLLECTIVE_S = 8    # the ranks' collective timeout; the idle wait outlasts it
IDLE_S = 10
TOL = dict(rtol=0, atol=1e-5)


def _jax_serve():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import serve as jax_serve
    finally:
        sys.path.pop(0)
    return jax_serve


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from openpsg_tpu.data.preprocess import Preprocessor
    from openpsg_tpu.models.detectors.psg_v4 import PSGv4 as JaxPSGv4
    from openpsg_tpu.models.detectors.psg_v4 import PSGv4Config as JaxPSGv4Config
    from openpsg_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from tests.fixtures import make_fixture

    from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config

    root = tmp_path_factory.mktemp("serve_dp")
    make_fixture(str(root / "psg"), n_images=len(HWS), hw=HWS)
    paths = [str(root / "psg" / "images" / f"{i}.jpg") for i in range(len(HWS))]
    bodies = [pathlib.Path(p).read_bytes() for p in paths]
    rgbs = [cv2.imread(p)[..., ::-1].copy() for p in paths]
    cfg = root / "tiny_v4_ov.py"       # read by make_server; the ranks pass the model
    cfg.write_text(f"_base_ = ['{REPO}/openpsg_tpu_torch/configs/psg/tiny_v4_ov.py']\n")
    jp = JaxPSGv4(dataclasses.replace(JaxPSGv4Config.tiny_test(), iou_thr=0.1),
                  jax.random.PRNGKey(0))
    model = PSGv4(dataclasses.replace(PSGv4Config.tiny_test(), iou_thr=0.1), seed=0,
                  device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, jax.device_get(jp.params)))
    state = {p: getattr(model, p).state_dict() for p in ("segmenter", "head", "llm", "text")}
    state["class_embeds"] = model.class_embeds
    torch.save(state, root / "v4.pt")

    # the ranks run while the JAX references compile
    argv = ["--config", str(cfg), "--port", "0", "--img-scale", "64", "64",
            "--single-bucket", "--device", "cpu", "--batch-size", "2", "--max-wait-ms", "1000"]
    ranks = ThreadPoolExecutor(1).submit(
        spawn, "torch_parallel_ranks:serve_dp", 2, str(root / "ranks"),
        args=(str(root / "v4.pt"), argv, bodies, IDLE_S, COLLECTIVE_S, str(root / "rdzv_serve")),
        timeout_s=240)
    jax_serve = _jax_serve()
    svc = jax_serve.InferenceService(jp, Preprocessor(scale=(64, 64)), batch_size=2,
                                     mesh=jax_make_mesh(dp=2, tp=1, devices=jax.devices()[:2]))
    want = {}
    try:
        for group in ([0, 1], [2, 2]):
            jobs = [svc._make_job(rgbs[i]) for i in group]
            svc._run_group(jobs)
            for i, job in zip(group, jobs):
                assert job.error is None, job.error
                want[i] = jax_serve._record_for(job.result, job.ex, 0)
    finally:
        svc.stop()
    assert sum(len(w["segments_info"]) for w in want.values()) >= 2
    return want, ranks.result()


def _pixels(rec):
    return cv2.imdecode(np.frombuffer(base64.b64decode(rec["pan_seg_png"]), np.uint8),
                        cv2.IMREAD_COLOR)


@pytest.mark.parametrize("phase,images", [("single", [0]), ("pair", [0, 1]),
                                          ("after_idle", [1, 2]), ("tail", [0, 1, 2])])
def test_records_equal_the_jax_dp_service(served, phase, images):
    want, ranks = served
    out = ranks[0][phase]
    assert len(out) == len(images)
    for (status, got), i in zip(out, images):
        assert status == 200, got
        got = dict(got)
        got.pop("latency_ms")
        assert set(got) == set(want[i])
        for key in ("relations", "segments_info", "object_id_list"):
            assert got[key] == want[i][key], (phase, i, key)
        np.testing.assert_allclose(got["relation_scores"], want[i]["relation_scores"], **TOL)
        pix = _pixels(got)
        assert pix.shape[:2] == HWS[i]
        np.testing.assert_array_equal(pix, _pixels(want[i]))


def test_groups_split_over_the_mesh_and_every_rank_returns(served):
    """A group of one ran on rank 0 alone; each larger group went over the
    mesh once (the follower ran each), padded to the batch size; a group
    whose block raised on rank 1 failed on both ranks and reached its
    callers as a 500; both ranks returned after stop(), past an idle wait
    longer than the collective timeout."""
    _, ranks = served
    assert [r["mesh"] for r in ranks] == [{"dp": 2, "tp": 1}] * 2
    assert ranks[0]["calls"] == [2, 2, 2, 4]
    assert ranks[1]["groups"] == 4
    for status, got in ranks[0]["failed"]:
        assert status == 500 and "rank 1 of dp" in got["error"], got
        assert "the follower's block fails" in got["error"], got
    assert IDLE_S > COLLECTIVE_S


def test_dp_mesh_condition_is_the_jax_servers():
    """JAX (tools/serve.py:288-297): ``batch_size > 1 and not micro_batch``,
    then ``ndev > 1 and batch_size % ndev == 0``.  The port asks the same of
    the launched world, and at a world of one (under a launcher) builds the
    identity mesh."""
    for world in (1, 2, 4):
        for batch_size in (1, 2, 3, 4, 8):
            for micro_batch in (False, True):
                jax_rule = (batch_size > 1 and not micro_batch and world > 1
                            and batch_size % world == 0)
                got = serve.wants_dp_mesh(batch_size, micro_batch, world)
                want = jax_rule or (world == 1 and batch_size > 1 and not micro_batch)
                assert got == want, (world, batch_size, micro_batch)
