"""Multi-scale deformable attention: CUDA kernel wrapper and plain version.

Counterpart of ``openpsg_tpu/ops/deform_attn.py`` (``_ms_deform_attn_flat``,
:125-213).  That op is XLA in the JAX package, not Pallas, so its fused
Hopper kernel ``csrc/ms_deform_attn.cu`` replaces no TPU kernel.  Semantics
kept exactly:

* each sample is a bilinear read from a "quad" row (the 2×2 corner
  neighbourhood) at the border-clipped base ``(by, bx)``, weighted by tent
  functions — equivalent to zero padding outside the map;
* ``points_per_level`` reads only the first K_l of the K points on level l.

* :func:`ms_deform_attn` — the wrapper; each call is the span
  ``psg.ms_deform_attn`` (``utils/profiling.span``).  A CPU tensor runs
  :func:`ms_deform_attn_plain`.  So does a CUDA tensor whose result autograd
  needs (:func:`needs_autograd`), as the JAX package's ``custom_vjp`` routes
  AD through its plain implementation; ``ms_deform_attn.plain_calls`` counts
  those.  Every other CUDA tensor launches the kernel once
  (``ms_deform_attn.launches``, bumped through ``utils/graphs.bump``, so a
  replayed CUDA graph counts its launches) or raises
  (:func:`check_kernel_inputs`).
* :func:`ms_deform_attn_plain` — per level, the K_l points of all queries
  and heads are gathered at once from a quad table of four rolled copies and
  reduced in float32 (the JAX version accumulates per (level, point) in
  f32).  The kernel computes the same samples and weights without the
  tables.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from openpsg_tpu_torch.ops import _build
from openpsg_tpu_torch.utils.graphs import bump
from openpsg_tpu_torch.utils.profiling import span

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_LEVELS = 4       # kMaxLevels in the source
_MAX_THREADS = 256   # kMaxThreads: threads per block
_SM_THREADS = 2048   # resident threads per SM on Hopper


def _points(value, spatial_shapes, sampling_locations, points_per_level) -> Tuple[int, ...]:
    """The level checks both paths make → K_l per level."""
    Lv = value.shape[1]
    L, K = sampling_locations.shape[3], sampling_locations.shape[4]
    if L != len(spatial_shapes):
        raise ValueError(f"{L} levels in locations, {len(spatial_shapes)} shapes")
    if sum(h * w for h, w in spatial_shapes) != Lv:
        raise ValueError(f"spatial shapes {spatial_shapes} != Lv {Lv}")
    kpl = tuple(int(k) for k in points_per_level) if points_per_level else (K,) * L
    if len(kpl) != L or not all(0 < k <= K for k in kpl):
        raise ValueError(f"points_per_level {points_per_level}")
    return kpl


def ms_deform_attn(
    value: torch.Tensor,                # [B, Lv, nH, hd]
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,   # [B, Lq, nH, L, K, 2] in [0, 1]
    attention_weights: torch.Tensor,    # [B, Lq, nH, L, K]
    points_per_level: Optional[Tuple[int, ...]] = None,
) -> torch.Tensor:                      # [B, Lq, nH * hd], value's dtype
    with span("ms_deform_attn"):
        if value.device.type == "cpu" or needs_autograd(value, sampling_locations,
                                                        attention_weights):
            if value.device.type != "cpu":
                ms_deform_attn.plain_calls += 1
            return ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                                        attention_weights, points_per_level)
        kpl = check_kernel_inputs(value, spatial_shapes, sampling_locations,
                                  attention_weights, points_per_level)
        return _launch(value, spatial_shapes, sampling_locations, attention_weights, kpl)


ms_deform_attn.launches = 0
ms_deform_attn.plain_calls = 0


def needs_autograd(*tensors: torch.Tensor) -> bool:
    """Whether autograd needs the op's result: grad mode on and an input
    that requires a gradient.  The kernel is forward only."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def ms_deform_attn_plain(value, spatial_shapes, sampling_locations, attention_weights,
                         points_per_level=None) -> torch.Tensor:
    """:func:`ms_deform_attn` in plain PyTorch, on any device."""
    B, Lv, nH, hd = value.shape
    Lq = sampling_locations.shape[1]
    kpl = _points(value, spatial_shapes, sampling_locations, points_per_level)
    out = torch.zeros(B, nH, Lq, hd, dtype=torch.float32, device=value.device)
    for lvl in range(len(kpl)):
        quad, idx, cw = level_samples(value, spatial_shapes, sampling_locations,
                                      attention_weights, lvl, kpl[lvl])
        g = torch.gather(quad, 2, idx[..., None].expand(-1, -1, -1, 4 * hd))  # [B,nH,Lq*kl,4hd]
        g = g.view(B, nH, Lq, kpl[lvl], 4, hd).float()
        out += torch.einsum("bhqkcd,bhqkc->bhqd", g, cw)
    return out.permute(0, 2, 1, 3).reshape(B, Lq, nH * hd).to(value.dtype)


def _tent(d: torch.Tensor) -> torch.Tensor:
    """``max(0, 1 - |d|)`` with the JAX package's derivatives at its kinks:
    ``jnp.abs`` takes slope +1 at 0 and ``jnp.maximum`` splits a tie's
    gradient in half (``abs`` and ``clamp`` here would give 0 and 1).  A
    sample on a pixel centre, as the offsets' grid initialization places
    every one, sits on those kinks."""
    return torch.maximum(1.0 - torch.where(d >= 0, d, -d), torch.zeros((), dtype=d.dtype,
                                                                        device=d.device))


def level_samples(value, spatial_shapes, sampling_locations, attention_weights,
                  lvl: int, kl: int):
    """Level ``lvl``'s share of :func:`ms_deform_attn_plain` for the first
    ``kl`` points → (quad [B, nH, h·w, 4·hd] in value's dtype, idx [B, nH,
    Lq·kl] int64 quad rows, query-major then point, cw [B, nH, Lq, kl, 4]
    float32 corner × attention weights).  The level's sampling is the row
    gather ``quad[b, h, idx[b, h]]`` (the op of ``ops/msda_gather.py``)."""
    h, w = spatial_shapes[lvl]
    start = sum(hh * ww for hh, ww in spatial_shapes[:lvl])
    B, _, nH, _ = value.shape
    Lq = sampling_locations.shape[1]
    vl = value[:, start:start + h * w].permute(0, 2, 1, 3)   # [B,nH,hw,hd]
    # quad row r = values at r, r+1, r+w, r+w+1 (wrapping within the
    # level as jnp.roll does; wrapped corners get zero tent weight)
    quad = torch.cat([vl, vl.roll(-1, 2), vl.roll(-w, 2), vl.roll(-(w + 1), 2)], dim=-1)
    loc = sampling_locations[:, :, :, lvl, :kl].float()      # [B,Lq,nH,kl,2]
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    bx = torch.clamp(torch.floor(x), 0, max(w - 2, 0))
    by = torch.clamp(torch.floor(y), 0, max(h - 2, 0))
    fx0, fx1, fy0, fy1 = _tent(torch.stack([x - bx, x - (bx + 1), y - by, y - (by + 1)]))
    aw = attention_weights[:, :, :, lvl, :kl].float()
    cw = torch.stack([fx0 * fy0, fx1 * fy0, fx0 * fy1, fx1 * fy1], dim=-1) * aw[..., None]
    idx = (by * w + bx).long().permute(0, 2, 1, 3).reshape(B, nH, Lq * kl)
    return quad, idx, cw.permute(0, 2, 1, 3, 4)


def channels_per_thread(dtype: torch.dtype, hd: int) -> int:
    """V, the channels one kernel thread holds: 16 bytes' worth, or 4 bf16
    channels for a bf16 head of 4 (mod 8)."""
    return 8 if dtype == torch.bfloat16 and hd % 8 == 0 else 4


def check_kernel_inputs(value, spatial_shapes, sampling_locations, attention_weights,
                        points_per_level=None) -> Tuple[int, ...]:
    """Raise on what the kernel does not take, naming the argument → K_l per
    level.  Device-independent, so it runs on CPU tensors too."""
    loc, aw = sampling_locations, attention_weights
    if value.dim() != 4 or loc.dim() != 6 or loc.shape[-1] != 2 or aw.shape != loc.shape[:-1] \
            or loc.shape[0] != value.shape[0] or loc.shape[2] != value.shape[2]:
        raise ValueError(
            f"shapes value {tuple(value.shape)} sampling_locations {tuple(loc.shape)} "
            f"attention_weights {tuple(aw.shape)}: want [B, Lv, nH, hd], [B, Lq, nH, L, K, 2] "
            "and [B, Lq, nH, L, K]")
    kpl = _points(value, spatial_shapes, loc, points_per_level)
    if len(kpl) > MAX_LEVELS:
        raise ValueError(f"spatial_shapes: {len(kpl)} levels, the kernel takes at most "
                         f"{MAX_LEVELS}")
    if value.dtype not in _DTYPE_CODES:
        raise TypeError(f"value must be float32 or bfloat16, got {value.dtype}")
    for name, t in (("sampling_locations", loc), ("attention_weights", aw)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    hd = value.shape[3]
    V = channels_per_thread(value.dtype, hd)
    G = hd // V
    if hd % V or G & (G - 1) or not 0 < G <= 32:
        raise ValueError(f"value's head width hd={hd} for {value.dtype}: the kernel takes "
                         "hd * itemsize a power of two from 16 to 512 bytes (or 4 bf16)")
    for name, t in (("sampling_locations", loc), ("attention_weights", aw)):
        if t.device != value.device:
            raise ValueError(f"{name} on {t.device}, value on {value.device}")
    for name, t in (("value", value), ("sampling_locations", loc), ("attention_weights", aw)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return kpl


def launch_plan(dtype: torch.dtype, hd: int, groups: int, levels: int, sms: int
                ) -> Tuple[int, int, int]:
    """How the kernel spreads ``groups`` = B·Lq·nH (query, head) pairs over
    a card of ``sms`` SMs → (G threads per pair's channels, P level parts,
    threads per block).  P doubles (up to 4, to at most the level count
    rounded up to a power of two) while the threads would not fill the
    card's resident slots; the block shrinks (to 64) while there would be
    fewer than 2 blocks per SM.  The encoder's calls take (4, 1, 256); the
    decoder's 300 queries (4, 4, 128)."""
    G = hd // channels_per_thread(dtype, hd)
    P = 1
    while P < 4 and P < levels and G * P < 32 and groups * G * P < sms * _SM_THREADS:
        P *= 2
    threads = _MAX_THREADS
    while threads > 64 and -(-groups * G * P // threads) < 2 * sms:
        threads //= 2
    return G, P, threads


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.library("ms_deform_attn")
    fn = lib.openpsg_ms_deform_attn_forward
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _launch(value, spatial_shapes, loc, aw, kpl):
    B, Lv, nH, hd = value.shape
    Lq, L, K = loc.shape[1], loc.shape[3], loc.shape[4]
    out = torch.empty(B, Lq, nH * hd, dtype=value.dtype, device=value.device)
    fn = _library().openpsg_ms_deform_attn_forward
    _, P, threads = launch_plan(value.dtype, hd, B * Lq * nH, L, _sm_count(value.device.index))
    levels = (ctypes.c_int * (3 * L))(
        *(int(n) for (h, w), kl in zip(spatial_shapes, kpl) for n in (h, w, kl)))
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(value.data_ptr(), loc.data_ptr(), aw.data_ptr(), out.data_ptr(), B, Lq, Lv,
                 nH, hd, L, K, levels, _DTYPE_CODES[value.dtype], P, threads, stream)
    if err != 0:
        raise RuntimeError(f"ms_deform_attn launch failed: CUDA error {err}")
    bump(ms_deform_attn, "launches", 1)     # a replayed graph counts its launches too
    return out
