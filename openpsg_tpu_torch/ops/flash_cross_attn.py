"""Shared-KV masked cross-attention: CUDA kernel wrapper and plain version.

Counterpart of ``openpsg_tpu/ops/pallas/flash_cross_attn.py``.  The
relation Q-Former cross-attends every object pair's Lq queries to the SAME
image-patch keys/values, restricted by a per-pair boolean patch mask.

* :func:`flash_shared_kv_cross_attn` — the wrapper.  On a CUDA tensor it
  launches the hand-written kernel ``csrc/flash_shared_kv_cross_attn.cu``
  (or raises); on a CPU tensor it runs :func:`shared_kv_cross_attn_plain`.
  ``flash_shared_kv_cross_attn.launches`` counts kernel launches.
* :func:`shared_kv_cross_attn_plain` — einsum, softmax, einsum, as the JAX
  reference (flash_cross_attn.py:139-147).

A fully masked row gives 0 in the kernel but the mean of V in the plain
version, so the wrapper first sets such rows to all-true
(:func:`guard_empty_mask`, the JAX package's ``_guard_empty_mask``).
"""

from __future__ import annotations

import ctypes

import torch

from openpsg_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 64)  # the tiny and the baseline_v4_ov Q-Former


def guard_empty_mask(mask: torch.Tensor) -> torch.Tensor:
    """Rows with an all-False mask attend everywhere instead (those rows are
    padding pairs whose outputs are discarded downstream)."""
    return mask | ~mask.any(dim=-1, keepdim=True)


def shared_kv_cross_attn_plain(q, k, v, mask):
    """q [NP, H, Lq, hd]; k, v [H, P, hd]; mask [NP, P] bool →
    [NP, H, Lq, hd] in v's dtype.  Scores and softmax in float32."""
    hd = q.shape[-1]
    s = torch.einsum("bhqd,hpd->bhqp", q.float(), k.float()) * (hd ** -0.5)
    s = torch.where(mask[:, None, None, :], s, torch.tensor(-1e9, dtype=s.dtype, device=s.device))
    attn = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqp,hpd->bhqd", attn, v)


def _check(q, k, v, mask):
    if q.dim() != 4 or k.dim() != 3 or v.shape != k.shape or mask.dim() != 2:
        raise ValueError(
            f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
            f"mask {tuple(mask.shape)}: want [NP,H,Lq,hd], [H,P,hd] x2, [NP,P]"
        )
    NP, H, Lq, hd = q.shape
    if k.shape[0] != H or k.shape[2] != hd or mask.shape != (NP, k.shape[1]):
        raise ValueError("q, k/v and mask disagree on NP, H, P or hd")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {_HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v), ("mask", mask)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch(q, k, v, mask):
    lib = _build.library("flash_shared_kv_cross_attn")
    fn = lib.openpsg_flash_skv_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    NP, H, Lq, hd = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                 out.data_ptr(), NP, H, Lq, k.shape[1], hd,
                 _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_shared_kv_cross_attn launch failed: CUDA error {err}")
    flash_shared_kv_cross_attn.launches += 1
    return out


def flash_shared_kv_cross_attn(q, k, v, mask):
    """q [NP, H, Lq, hd]; k, v [H, P, hd] (shared by all pairs); mask
    [NP, P] bool → [NP, H, Lq, hd] in v's dtype.  Empty mask rows are
    guarded first.  CUDA tensors go to the kernel; CPU tensors to the plain
    version."""
    mask = guard_empty_mask(mask)
    if q.device.type == "cpu":
        return shared_kv_cross_attn_plain(q, k, v, mask)
    _check(q, k, v, mask)
    return _launch(q, k, v, mask)


flash_shared_kv_cross_attn.launches = 0
