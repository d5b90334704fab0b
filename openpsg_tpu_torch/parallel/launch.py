"""Start N ranks of one function, each in its own process, joined in one
process group through a ``file://`` rendezvous (no TCP port to collide
with another run), and bring their results back.

    results = spawn("pkg.module:function", world=4, root=tmpdir, args=(...))

Each rank runs ``function(*args)`` after :func:`init_distributed` (gloo on
the CPU by default; ``device="cuda:0", backend="gloo"`` lets ranks share
one card).  The ranks are joined with a deadline: a rank that fails or
hangs fails the call, the others are killed, and the error carries the
tail of each failed rank's log (``root/rank<r>.log``).  The rank functions
of the tests, the dry run and the chip smoke script all start here.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Any, List, Optional, Sequence

import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def spawn(target: str, world: int, root: str, args: Sequence[Any] = (),
          device: str = "cpu", backend: Optional[str] = None,
          timeout_s: float = 120.0) -> List[Any]:
    """Run ``target`` (``"module:function"``) on ``world`` ranks → each
    rank's return value, in rank order.  ``args`` are pickled with
    ``torch.save``; ``root`` holds the rendezvous file, the specs, the
    results and the logs."""
    os.makedirs(root, exist_ok=True)
    rdzv = os.path.join(root, "rdzv")
    if os.path.exists(rdzv):
        os.remove(rdzv)
    spec = os.path.join(root, "spec.pt")
    torch.save(dict(target=target, args=tuple(args), device=device, backend=backend,
                    init_method="file://" + rdzv,
                    sys_path=list(sys.path)), spec)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO_ROOT] + [p for p in env.get(
        "PYTHONPATH", "").split(os.pathsep) if p])
    env.update(WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(root, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "openpsg_tpu_torch.parallel.launch", spec, str(r)],
            env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, stdout=log,
            stderr=subprocess.STDOUT, cwd=root))
    deadline = time.monotonic() + timeout_s
    failed, reason = [], ""
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                time.sleep(1.0)     # let a peer's own error land in its log
                reason = "exited with " + ", ".join(
                    f"rank {r}: {procs[r].poll()}" for r in failed)
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = [r for r, c in enumerate(codes) if c is None]
                reason = f"not done within {timeout_s:.0f} s"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    if failed:
        tails = []
        for r in failed[:2]:
            with open(os.path.join(root, f"rank{r}.log")) as f:
                tails.append(f"--- rank {r} ---\n" + f.read()[-3000:])
        raise RuntimeError(f"{target} on {world} ranks: {reason}\n" + "\n".join(tails))
    return [torch.load(os.path.join(root, f"rank{r}.out"), weights_only=False)
            for r in range(world)]


def _child(spec_path: str, rank: str) -> None:
    import importlib

    import torch.distributed as dist

    from openpsg_tpu_torch.parallel.mesh import init_distributed

    spec = torch.load(spec_path, weights_only=False)
    for p in reversed(spec["sys_path"]):
        if p not in sys.path:
            sys.path.insert(0, p)
    torch.set_num_threads(1)
    init_distributed("pytorch", device=spec["device"], backend=spec["backend"],
                     init_method=spec["init_method"])
    module, _, name = spec["target"].partition(":")
    out = getattr(importlib.import_module(module), name)(*spec["args"])
    torch.save(out, os.path.join(os.path.dirname(spec_path), f"rank{rank}.out"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _child(sys.argv[1], sys.argv[2])
