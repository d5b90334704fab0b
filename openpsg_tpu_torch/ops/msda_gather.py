"""Exact row gather for deformable attention: CUDA kernel wrapper and plain
version.

Counterpart of ``openpsg_tpu/ops/pallas/msda_gather.py`` (``sparse_row_gather``,
:70).  Each bilinear sample of multi-scale deformable attention is one row of
a "quad" table (the 2×2 corner neighbourhood concatenated on the feature
axis, :mod:`openpsg_tpu_torch.ops.deform_attn`), so the op is

    out[h, s, :] = quad[h, idx[h, s], :]      (float32 whatever quad's type)

and an index outside ``[0, HW)`` gives a zero row: the TPU kernel's one-hot
matches no row for it, and its padded rows ``HW..HWpad`` are zero.

* :func:`sparse_row_gather` — the wrapper.  On a CUDA tensor it launches the
  hand-written kernel ``csrc/sparse_row_gather.cu`` (or raises); on a CPU
  tensor it runs :func:`sparse_row_gather_plain`.
  ``sparse_row_gather.launches`` counts kernel launches.
* :func:`sparse_row_gather_plain` — ``torch.gather`` on clamped indices,
  zeroed where the index is out of range.

Like the TPU kernel, it is on no path of the JAX package: ``ms_deform_attn``
gathers with XLA ``take`` there (msda_gather.py:23-31) and with
``torch.gather`` here.
"""

from __future__ import annotations

import ctypes

import torch

from openpsg_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def sparse_row_gather_plain(quad: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """quad [nH, HW, C] (any float type); idx [nH, S] integer → [nH, S, C]
    float32; rows whose index lies outside [0, HW) are zero."""
    nH, HW, C = quad.shape
    idx = idx.long()
    inside = (idx >= 0) & (idx < HW)
    rows = torch.gather(quad, 1, idx.clamp(0, HW - 1)[..., None].expand(-1, -1, C))
    return torch.where(inside[..., None], rows.float(), 0.0)


def _check(quad, idx):
    if quad.dim() != 3 or idx.dim() != 2 or idx.shape[0] != quad.shape[0]:
        raise ValueError(f"shapes quad {tuple(quad.shape)} idx {tuple(idx.shape)}: "
                         "want [nH, HW, C] and [nH, S]")
    if quad.dtype not in _DTYPE_CODES:
        raise TypeError(f"quad must be float32 or bfloat16, got {quad.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    nH, HW, C = quad.shape
    vec = 16 // quad.element_size()              # elements per 16-byte load
    if C % vec:
        raise ValueError(f"row width C={C} must be a multiple of {vec} for {quad.dtype}")
    if min(nH, HW, idx.shape[1]) <= 0 or max(HW, idx.shape[1], C) >= 2**31:
        raise ValueError(f"sizes nH={nH} HW={HW} S={idx.shape[1]} C={C} out of range")
    if idx.device != quad.device:
        raise ValueError(f"idx on {idx.device}, quad on {quad.device}")
    for name, t in (("quad", quad), ("idx", idx)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch(quad, idx):
    lib = _build.library("sparse_row_gather")
    fn = lib.openpsg_sparse_row_gather
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    nH, HW, C = quad.shape
    S = idx.shape[1]
    out = torch.empty(nH, S, C, dtype=torch.float32, device=quad.device)
    with torch.cuda.device(quad.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(quad.data_ptr(), idx.data_ptr(), out.data_ptr(), nH, S, HW, C,
                 _DTYPE_CODES[quad.dtype], stream)
    if err != 0:
        raise RuntimeError(f"sparse_row_gather launch failed: CUDA error {err}")
    sparse_row_gather.launches += 1
    return out


def sparse_row_gather(quad: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """quad [nH, HW, C]; idx [nH, S] int32 → [nH, S, C] float32, zero rows
    for indices outside [0, HW).  CUDA tensors go to the kernel; CPU
    tensors to the plain version."""
    if quad.device.type == "cpu":
        return sparse_row_gather_plain(quad, idx)
    _check(quad, idx)
    return _launch(quad, idx)


sparse_row_gather.launches = 0
