"""The port's multi-rank dry run (``tools/dryrun_multichip.py``) at 8 gloo
ranks on the CPU, and F9 (the JAX tool's mesh that is smaller than the
device count).

The dp × tp train step against JAX's is in ``test_torch_parallel_v4.py``;
the train tool under ``torch.distributed.run`` in
``test_torch_parallel_tool.py``.
"""

import math

import jax
import pytest
import torch

from openpsg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from openpsg_tpu_torch.tools import dryrun_multichip

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)


# ---------------------------------------------------------------- dry run
def test_dryrun_multichip_8_ranks(tmp_path, capsys):
    results = dryrun_multichip.main(["--ranks", "8", "--device", "cpu", "--root",
                                     str(tmp_path)])
    out = capsys.readouterr().out
    for line in ("mesh: {'dp': 4, 'tp': 2}", "LLM tensor-sharded tensors on tp=2: 16",
                 "sharded infer_batch over 4 images OK", "pair-sharded single-image infer OK",
                 "scratch recipe: trainable LLM sharded, 16 sharded moment tensors",
                 "pipeline-parallel LLM (pp=4, dp=2, tp=1", "3D-parallel LLM (pp=2, dp=2, tp=2",
                 "dryrun_multichip(8) OK"):
        assert line in out, line
    assert len(results) == 8
    for r in results:
        assert all(math.isfinite(v) for v in r["train"].values())
        assert r["train"] == results[0]["train"]          # every rank took the same step


def test_f9_mesh_must_match_the_launched_ranks():
    """F9: the JAX tool takes its dp×tp branch for a mesh no larger than
    the device count, then ``make_mesh`` asserts dp*tp == devices, so
    ``dict(dp=2, tp=2)`` on 8 devices crashes.  The port forms the mesh
    over the launched ranks and refuses a mismatch by name."""
    from openpsg_tpu_torch.tools import train as train_tool

    assert jax.device_count() == 8
    with pytest.raises(AssertionError, match="devices"):
        jax_make_mesh(dp=2, tp=2)

    class Log:
        def info(self, *a):
            pass

    with pytest.raises(SystemExit, match="nproc_per_node"):
        train_tool._make_mesh({"dp": 2, "tp": 2}, "pytorch", 8, False, Log())
