"""The benchmark loads neither JAX nor the JAX package, its references
import nothing of the program, and a run without a card fails."""

import ast
import os
import subprocess
import sys

from tiny import ROOT

REPO = os.path.dirname(ROOT)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "openpsg_tpu"}

PASS = r"""
import sys, time, torch
sys.path[:0] = [{repo!r}, {tests!r}]
torch.set_num_threads(1)
import tiny
from psgbench import run, trace
from psgbench.drivers import offline
from psgbench.systems import psg_v1, psg_v4
for System, cfg, tr in ((psg_v4.System, tiny.v4_config(), tiny.traffic("vga_landscape_mb4")),
                        (psg_v1.System, tiny.v1_config(), tiny.traffic("vga_landscape_single"))):
    s = System(cfg, tr, 2 ** 31 + 99, "cpu")
    ctx = offline.run(s, tr, 2 ** 31 + 99, 0.2, True, time.perf_counter())
    taps = ctx.pop("taps")
    s.release()
    s.check(taps, ("f32", "fp8"))
print(" ".join(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def test_no_jax_after_a_tiny_pass():
    code = PASS.format(repo=REPO, tests=os.path.join(ROOT, "tests"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(out.stdout.split()[-1000:])
    assert "openpsg_tpu_torch" in loaded and "psgbench" in loaded
    assert not (loaded & FORBIDDEN), loaded & FORBIDDEN


def _imports(path):
    with open(path, "r", encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_references_import_nothing_of_the_program():
    ref = os.path.join(ROOT, "reference")
    files = [os.path.join(ref, f) for f in os.listdir(ref) if f.endswith(".py")]
    assert len(files) >= 5
    for f in files:
        mods = set(_imports(f))
        assert not (mods & (FORBIDDEN | {"openpsg_tpu_torch"})), (f, mods)


def test_no_file_of_the_benchmark_imports_jax():
    for dirpath, _, names in os.walk(ROOT):
        for n in names:
            if n.endswith(".py"):
                mods = set(_imports(os.path.join(dirpath, n)))
                assert not (mods & FORBIDDEN), (n, mods)


def test_run_without_a_card_fails_and_prints_no_result():
    code = ("import torch; torch.cuda.is_available = lambda: False; import sys; "
            "from psgbench import run; sys.exit(run.main(['--workload', 'v4m-offline-mb4', "
            "'--seed', '1', '--seconds', '1', '--trace', '0']))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 3
    assert out.stdout.strip() == ""
