"""Process groups and device meshes (counterpart of
``openpsg_tpu/parallel/mesh.py``).

The JAX package names its parallelism once as a ``jax.sharding.Mesh``
over ``("dp", "tp")`` and lets XLA insert the collectives.  Here the same
mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over ranks
that ``torch.distributed.run`` (the reference's torchrun recipe) or
:mod:`openpsg_tpu_torch.parallel.launch` started, one rank per process:

  * ``dp`` — data parallel over images;
  * ``tp`` — Megatron tensor parallel for the LLM
    (:mod:`openpsg_tpu_torch.parallel.sharding`);
  * ``pp`` — GPipe stages of the LLM trunk
    (:mod:`openpsg_tpu_torch.parallel.pipeline`).

The collectives are explicit (:mod:`openpsg_tpu_torch.parallel.comm`).
The backend follows the device: NCCL for ``cuda``, gloo for ``cpu``;
``backend="gloo"`` on ``cuda`` is only for ranks that share one card
(NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

# a hung collective fails the run instead of stalling it
DEFAULT_TIMEOUT_S = 60


def launched() -> bool:
    """Whether this process was started as one rank of a launcher
    (``torch.distributed.run`` or :func:`~openpsg_tpu_torch.parallel.launch.spawn`
    set ``RANK`` and ``WORLD_SIZE``)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_distributed(launcher: str = "pytorch", device=None, backend: Optional[str] = None,
                     init_method: Optional[str] = None) -> Tuple[int, int, torch.device]:
    """Join the process group of a launched run → (rank, world size, the
    rank's device).

    ``launcher="pytorch"`` reads ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK`` as ``torch.distributed.run`` sets them; the rendezvous
    is ``init_method`` (default ``env://``: ``MASTER_ADDR`` /
    ``MASTER_PORT``).  ``device`` ``cuda`` (the default) becomes
    ``cuda:LOCAL_RANK``.  The backend follows the device (NCCL for cuda,
    gloo for cpu) unless ``backend`` names one; ``"nccl"`` on the CPU is
    refused."""
    if launcher != "pytorch":
        raise ValueError(f"init_distributed: launcher {launcher!r}: only 'pytorch' "
                         "(torch.distributed.run) starts ranks")
    if not launched():
        raise RuntimeError("--launcher pytorch needs RANK and WORLD_SIZE in the "
                           "environment: start the run with python -m torch.distributed.run")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: device cuda asked for and none is "
                               "available; pass device='cpu' for gloo ranks on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    want = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if want == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs device cuda")
    if not dist.is_initialized():
        kw = dict(backend=want, init_method=init_method or "env://", rank=rank,
                  world_size=world, timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
        dist.init_process_group(**kw)
    return rank, world, dev


def world() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def device_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    """A DeviceMesh of the launched ranks, row-major over ``names`` (the
    JAX meshes' ``reshape`` order).  Its device type follows the backend:
    gloo ranks that share a card communicate through host memory."""
    from torch.distributed.device_mesh import init_device_mesh

    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, shape, mesh_dim_names=names)


def make_mesh(dp: Optional[int] = None, tp: int = 1):
    """Mesh over ("dp", "tp") of the launched ranks.  Default: every rank on
    dp.  ``dp * tp`` must equal the world size."""
    n = dist.get_world_size()
    if dp is None:
        assert n % tp == 0, (n, tp)
        dp = n // tp
    assert dp * tp == n, f"dp({dp}) * tp({tp}) != ranks({n})"
    return device_mesh((dp, tp), ("dp", "tp"))


def mesh_shape(mesh) -> Dict[str, int]:
    """{dim name: size} of a DeviceMesh; a plain dict passes through (the
    spec-level planners take ``{"tp": 4}`` without any process group)."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, axis: str) -> int:
    return int(mesh_shape(mesh).get(axis, 1))


def axis_group(mesh, axis: str):
    """(process group, this rank's index, size) along ``axis``, or None
    where the mesh has no such dim."""
    if mesh is None or isinstance(mesh, dict) or axis not in mesh.mesh_dim_names:
        return None
    return mesh.get_group(axis), mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(axis))
