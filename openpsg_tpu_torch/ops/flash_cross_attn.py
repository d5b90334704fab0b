"""Shared-KV masked cross-attention: CUDA kernel wrapper and plain version.

Counterpart of ``openpsg_tpu/ops/pallas/flash_cross_attn.py``.  The
relation Q-Former cross-attends every object pair's Lq queries to the SAME
image-patch keys/values, restricted by a per-pair boolean patch mask.

* :func:`flash_shared_kv_cross_attn` — the wrapper.  On a CUDA tensor it
  launches the hand-written kernel ``csrc/flash_shared_kv_cross_attn.cu``
  (or raises); on a CPU tensor it runs :func:`shared_kv_cross_attn_plain`.
  The kernel has two variants, chosen by shape (:func:`kernel_variant`):
  ``"hopper"`` (wgmma/TMA, K/V resident in shared memory) for bf16, hd 64
  and P ≤ :data:`HOPPER_MAX_P`, the main path's case; ``"simple"`` for the
  rest (float32, hd 16, longer patch sequences).
  ``flash_shared_kv_cross_attn.launches`` counts kernel launches and
  ``.launches_by_variant`` splits them by variant.
* :func:`shared_kv_cross_attn_plain` — einsum, softmax, einsum, as the JAX
  reference (flash_cross_attn.py:139-147).

A fully masked row gives 0 in the kernel but the mean of V in the plain
version, so the wrapper first sets such rows to all-true
(:func:`guard_empty_mask`, the JAX package's ``_guard_empty_mask``).

The kernel is forward only, as the Pallas kernel is: its output carries no
autograd history.  So the wrapper refuses inputs that require a gradient
while grad mode is on; a caller that differentiates runs the plain version
(the Q-Former does, as the JAX package's ``custom_vjp`` does).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from openpsg_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 64)  # the tiny and the baseline_v4_ov Q-Former
VARIANTS = ("simple", "hopper")  # the kernel's variant codes 0 and 1
HOPPER_MAX_P = 448  # patches the hopper variant keeps resident (kMaxP in the source)
_MASK_WORDS = 16  # the hopper variant's packed mask: 32-bit words per pair (kWords)


def kernel_variant(dtype: torch.dtype, hd: int, P: int) -> str:
    """The kernel variant for these inputs: ``"hopper"`` for bf16, hd 64
    and at most :data:`HOPPER_MAX_P` patches, else ``"simple"``."""
    if dtype == torch.bfloat16 and hd == 64 and P <= HOPPER_MAX_P:
        return "hopper"
    return "simple"


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


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.library("flash_shared_kv_cross_attn")
    lib.openpsg_flash_skv_forward.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.openpsg_flash_skv_forward.restype = ctypes.c_int
    lib.openpsg_flash_skv_hopper_attrs.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.openpsg_flash_skv_hopper_attrs.restype = ctypes.c_int
    return lib


def _launch(q, k, v, mask, variant):
    fn = _library().openpsg_flash_skv_forward
    NP, H, Lq, hd = q.shape
    P = k.shape[1]
    out = torch.empty_like(q)
    bits = None
    if variant == "hopper":  # scratch for the mask packed into bits
        bits = torch.empty(NP, _MASK_WORDS, dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                 out.data_ptr(), 0 if bits is None else bits.data_ptr(), NP, H, Lq, P, hd,
                 _DTYPE_CODES[q.dtype], VARIANTS.index(variant), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_shared_kv_cross_attn ({variant}) launch failed: CUDA error {err}")
    flash_shared_kv_cross_attn.launches += 1
    flash_shared_kv_cross_attn.launches_by_variant[variant] += 1
    return out


def hopper_kernel_attrs() -> dict:
    """The built hopper kernel's registers per thread, shared memory per
    block and local (spill) memory per thread, from the CUDA runtime."""
    vals = [ctypes.c_int() for _ in range(3)]
    err = _library().openpsg_flash_skv_hopper_attrs(*(ctypes.byref(x) for x in vals))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
    return dict(zip(("registers", "smem_bytes", "local_bytes"), (x.value for x in vals)))


def reset_launches() -> None:
    flash_shared_kv_cross_attn.launches = 0
    flash_shared_kv_cross_attn.launches_by_variant = dict.fromkeys(VARIANTS, 0)


def flash_shared_kv_cross_attn(q, k, v, mask, variant=None):
    """q [NP, H, Lq, hd]; k, v [H, P, hd] (shared by all pairs); mask
    [NP, P] bool → [NP, H, Lq, hd] in v's dtype.  Empty mask rows are
    guarded first.  CUDA tensors go to the kernel variant
    :func:`kernel_variant` picks (``variant`` names one instead; the hopper
    variant only where :func:`kernel_variant` allows it); CPU tensors to
    the plain version.  Raises ``RuntimeError`` when grad mode is on and
    q, k or v requires a gradient: the kernel's output would have none."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "flash_shared_kv_cross_attn is forward only and would drop the gradient "
            "of q, k and v; differentiate through shared_kv_cross_attn_plain")
    mask = guard_empty_mask(mask)
    if q.device.type == "cpu":
        return shared_kv_cross_attn_plain(q, k, v, mask)
    _check(q, k, v, mask)
    auto = kernel_variant(q.dtype, q.shape[-1], k.shape[1])
    if variant is None:
        variant = auto
    elif variant not in VARIANTS or (variant == "hopper" and auto != "hopper"):
        raise ValueError(f"variant {variant!r} does not take {q.dtype}, hd {q.shape[-1]}, "
                         f"P {k.shape[1]}")
    return _launch(q, k, v, mask, variant)


reset_launches()
