#!/usr/bin/env python
"""Formulations of multi-scale deformable attention's gather at the exact
encoder geometry, timed on the card (counterpart of
``tools/probe_msda_variants.py``).

At 1344² the four levels are 168², 84², 42² and 21², so Lv = Lq = 37,485,
with 8 heads of 32 channels and 4 points per level.  Each bilinear sample
is one row of a "quad" table (a 2×2 corner neighbourhood, 4·hd wide;
:mod:`openpsg_tpu_torch.ops.deform_attn`).  Variants, each the whole
``ms_deform_attn`` output except ``raw``:

  raw   the floor: per head, L·K gathers of Lq random rows from a
        contiguous [Lv, 4hd] table, each summed; no weights, no output.
  v0    the plain path (``ops/deform_attn.ms_deform_attn_plain``): one
        ``torch.gather`` per level.
  v1    a head-major quad table [nH, Lv, 4hd] built once; one gather of Lq
        rows per (head, level, point).
  v2    v1's table, ONE ``torch.gather`` per head over the merged indices of
        all levels and points.
  v2k   v2's gather for every head in ONE launch of the row-gather kernel
        (``ops/msda_gather.sparse_row_gather``, ``csrc/sparse_row_gather.cu``).
        The kernel writes float32 rows, so it moves twice the output bytes
        of v2's bf16 gather.
  v4    merged indices as in v2, on the strided [Lv, nH, 4hd] table (a
        head is a strided slice): separates the two effects.
  fused the shipped op (``ops/deform_attn.ms_deform_attn``): on the card one
        launch of the fused kernel (``csrc/ms_deform_attn.cu``), no quad
        table; on the CPU the plain path.

Before any timing each variant but ``raw`` computes the whole output, which
must agree with v0's within :func:`agreement_tol`.  A variant is pure
device work: CUDA events around :data:`CALLS_PER_SAMPLE` back-to-back
calls, ``BENCH_ITERS`` samples, median and interquartile range
(``utils/profiling.time_samples``).

Env knobs (the JAX tool's): ``BENCH_IMAGE`` (1344), ``BENCH_ITERS`` (4),
``VARIANTS`` (raw,v0,v1,v2,v2k,v4,fused).  Prints one JSON line.

    python -m openpsg_tpu_torch.tools.probe_msda_variants [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from openpsg_tpu_torch.ops.deform_attn import level_samples, ms_deform_attn, ms_deform_attn_plain
from openpsg_tpu_torch.ops.msda_gather import sparse_row_gather
from openpsg_tpu_torch.utils.profiling import (
    PEAK_BYTES_PER_S,
    PEAK_F32_FLOPS,
    device_record,
    time_samples,
)

VARIANTS = ("raw", "v0", "v1", "v2", "v2k", "v4", "fused")
CALLS_PER_SAMPLE = 3
N_HEADS, HEAD_DIM, N_LEVELS, N_POINTS = 8, 32, 4, 4


def encoder_shapes(size: int, levels: int = N_LEVELS) -> Tuple[Tuple[int, int], ...]:
    """The pixel decoder's level shapes for a ``size``² input: strides 8,
    16, 32, 64."""
    shapes, h = [], size // 8
    for _ in range(levels):
        shapes.append((h, h))
        h //= 2
    return tuple(shapes)


def uniform_inputs(shapes, device, dtype=torch.bfloat16, seed: int = 0,
                   n_heads: int = N_HEADS, head_dim: int = HEAD_DIM,
                   points: int = N_POINTS, queries: Optional[int] = None):
    """The JAX tool's inputs: value N(0, 1), locations uniform in [0.05,
    0.95], N(0, 1) weights softmaxed over each point set of a (query, head,
    level); ``queries`` Lq (default Lv, the encoder's) → (value [1, Lv, nH,
    hd], locations [1, Lq, nH, L, K, 2] f32, weights [1, Lq, nH, L, K] f32)."""
    L = len(shapes)
    Lv = sum(h * w for h, w in shapes)
    Lq = Lv if queries is None else int(queries)
    rng = np.random.default_rng(seed)
    value = rng.normal(size=(1, Lv, n_heads, head_dim)).astype(np.float32)
    loc = rng.uniform(0.05, 0.95, (1, Lq, n_heads, L, points, 2)).astype(np.float32)
    logits = rng.normal(size=(1, Lq, n_heads, L, points)).astype(np.float32)
    aw = torch.softmax(torch.from_numpy(logits), dim=-1)
    return (torch.from_numpy(value).to(device, dtype), torch.from_numpy(loc).to(device),
            aw.to(device))


def _points(loc, points_per_level) -> Tuple[int, ...]:
    L, K = loc.shape[3], loc.shape[4]
    return tuple(int(k) for k in points_per_level) if points_per_level else (K,) * L


def _tables(value, shapes, loc, aw, kpl, head_major: bool = True):
    """The quad tables of all levels and the merged rows → (table [nH, Lv,
    4hd] head-major, or [Lv, nH, 4hd] with ``head_major=False``; row index
    [nH, R, Lq] int64 with each level's offset; weights [nH, R, Lq, 4]
    float32), R = Σ K_l, the rows level by level, point by point."""
    if value.shape[0] != 1:
        raise ValueError("the probe runs one image (B = 1)")
    nH, Lq = value.shape[2], loc.shape[1]
    quads, idx, cw, start = [], [], [], 0
    for lvl, (h, w) in enumerate(shapes):
        kl = kpl[lvl]
        q, i, c = level_samples(value, shapes, loc, aw, lvl, kl)
        quads.append(q[0] if head_major else q[0].permute(1, 0, 2))
        idx.append((i[0].view(nH, Lq, kl) + start).permute(0, 2, 1))
        cw.append(c[0].permute(0, 2, 1, 3))
        start += h * w
    return (torch.cat(quads, 1 if head_major else 0), torch.cat(idx, 1), torch.cat(cw, 1))


def _finish(out: torch.Tensor, dtype) -> torch.Tensor:
    """[nH, Lq, hd] float32 → [1, Lq, nH·hd] in the value's type."""
    nH, Lq, hd = out.shape
    return out.permute(1, 0, 2).reshape(1, Lq, nH * hd).to(dtype)


def _rows(table, idx):
    """``torch.gather`` of rows ``idx`` (1-D) of a 2-D table → [len, C]."""
    return torch.gather(table, 0, idx[:, None].expand(-1, table.shape[1]))


def v0(value, shapes, loc, aw, points_per_level=None):
    return ms_deform_attn_plain(value, shapes, loc, aw, points_per_level)


def v1(value, shapes, loc, aw, points_per_level=None):
    table, idx, cw = _tables(value, shapes, loc, aw, _points(loc, points_per_level))
    nH, R, Lq = idx.shape
    hd = table.shape[-1] // 4
    out = torch.zeros(nH, Lq, hd, dtype=torch.float32, device=value.device)
    for h in range(nH):
        for r in range(R):
            g = _rows(table[h], idx[h, r]).view(Lq, 4, hd).float()
            out[h] += torch.einsum("qcd,qc->qd", g, cw[h, r])
    return _finish(out, value.dtype)


def _merged_per_head(table_of, idx, cw, hd, dtype, device):
    nH, R, Lq = idx.shape
    out = torch.empty(nH, Lq, hd, dtype=torch.float32, device=device)
    for h in range(nH):
        g = _rows(table_of(h), idx[h].reshape(-1)).view(R, Lq, 4, hd).float()
        out[h] = torch.einsum("rqcd,rqc->qd", g, cw[h])
    return _finish(out, dtype)


def v2(value, shapes, loc, aw, points_per_level=None):
    table, idx, cw = _tables(value, shapes, loc, aw, _points(loc, points_per_level))
    return _merged_per_head(lambda h: table[h], idx, cw, table.shape[-1] // 4, value.dtype,
                            value.device)


def v4(value, shapes, loc, aw, points_per_level=None):
    table, idx, cw = _tables(value, shapes, loc, aw, _points(loc, points_per_level),
                             head_major=False)
    return _merged_per_head(lambda h: table[:, h], idx, cw, table.shape[-1] // 4,
                            value.dtype, value.device)


def v2k(value, shapes, loc, aw, points_per_level=None):
    table, idx, cw = _tables(value, shapes, loc, aw, _points(loc, points_per_level))
    nH, R, Lq = idx.shape
    hd = table.shape[-1] // 4
    g = sparse_row_gather(table.contiguous(), idx.reshape(nH, R * Lq).to(torch.int32)
                          .contiguous())                      # [nH, R·Lq, 4hd] float32
    out = torch.einsum("hrqcd,hrqc->hqd", g.view(nH, R, Lq, 4, hd), cw)
    return _finish(out, value.dtype)


def fused(value, shapes, loc, aw, points_per_level=None):
    return ms_deform_attn(value, shapes, loc, aw, points_per_level)


FORMULATIONS = {"v0": v0, "v1": v1, "v2": v2, "v2k": v2k, "v4": v4, "fused": fused}


def raw_fn(value, shapes, points, seed: int = 0):
    """The floor: per head, Σ K_l gathers of Lq random rows from a
    contiguous [Lv, 4hd] table (hd channels repeated 4 times), each summed
    in float32 → (a zero-argument function returning the sum, the row index
    [nH, R, Lq])."""
    _, Lv, nH, hd = value.shape
    table = value[0].permute(1, 0, 2).repeat(1, 1, 4).contiguous()      # [nH, Lv, 4hd]
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, Lv, (nH, sum(points), Lv))).to(value.device)

    def fn():
        acc = torch.zeros((), dtype=torch.float32, device=value.device)
        for h in range(nH):
            for r in range(idx.shape[1]):
                acc = acc + _rows(table[h], idx[h, r]).sum(dtype=torch.float32)
        return acc

    return fn, idx


def agreement_tol(ref: torch.Tensor) -> float:
    """How far a variant may lie from v0: one step of the output type at v0's
    largest output for bf16, 2^-16 of it for float32.  Every variant sums
    the same float32 products (the value widened, times the float32 corner
    and attention weights) in another order, which moves a float32 sum by
    about 1e-7 of its terms' size; rounded to bf16, an element then lands on
    the same value or a neighbour, one bf16 step (2^-7 of its size) away.
    A wrong row or weight moves an output by the size of a value."""
    eps = max(torch.finfo(ref.dtype).eps, 2.0 ** -16)
    return eps * max(float(ref.float().abs().max()), 1e-30)


def op_bound(value, loc, points) -> Tuple[float, str, float]:
    """Least time of the whole op on this card class → (ms, 'bytes' |
    'operations', bytes): the value, the used locations and weights read
    once, the output written once; 2 FLOP per (sample, corner, channel) at
    the float32 peak (the products are float32)."""
    _, Lv, nH, hd = value.shape
    Lq, R = loc.shape[1], sum(points)
    nbytes = (value.numel() * value.element_size() + Lq * nH * R * (2 + 1) * 4
              + Lq * nH * hd * value.element_size())
    ops = 2.0 * Lq * nH * R * 4 * hd
    t_b, t_o = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_FLOPS * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), float(nbytes)


def gather_bound(idx, row_bytes_in: int, row_bytes_out: int, idx_bytes: int
                 ) -> Tuple[float, float]:
    """Least time of row gathers → (ms, bytes): each distinct row of a head
    that ``idx`` [nH, ...] reaches read once, the indices (``idx_bytes``
    each), every gathered row written once (``row_bytes_out``: 4hd times the
    output type's size, 0 where nothing is written)."""
    rows = sum(int(torch.unique(idx[h]).numel()) for h in range(idx.shape[0]))
    nbytes = (rows * row_bytes_in + idx.numel() * idx_bytes
              + idx.numel() * row_bytes_out)
    return nbytes / PEAK_BYTES_PER_S * 1e3, float(nbytes)


def run(value, shapes, loc, aw, points_per_level=None, variants: Sequence[str] = VARIANTS,
        iters: int = 4, label: str = "uniform", device_label: Optional[str] = None,
        emit: bool = True) -> Dict:
    """Check each variant against v0, then time it → the JSON record (also
    printed with ``emit``): per variant the median and IQR in ms, its largest
    difference from v0 and the tolerance, and its bound."""
    dev = value.device
    points = _points(loc, points_per_level)
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        raise ValueError(f"unknown variants {sorted(unknown)}; known {VARIANTS}")
    launches0 = sparse_row_gather.launches
    fused0 = ms_deform_attn.launches
    ref = v0(value, shapes, loc, aw, points_per_level)
    tol = agreement_tol(ref)
    op_ms, op_by, op_bytes = op_bound(value, loc, points)
    nH, hd = value.shape[2], value.shape[3]
    res: Dict[str, Dict] = {}
    for name in variants:
        entry: Dict = {}
        if name == "raw":
            fn, idx = raw_fn(value, shapes, points)
            fn()
            ms, nbytes = gather_bound(idx, 4 * hd * value.element_size(), 0, 8)
            entry.update(bound_ms=ms, bound_by="bytes",
                         bound_note=f"distinct rows read once and the indices, "
                                    f"{nbytes / 1e6:.1f} MB; no output")
        else:
            f = FORMULATIONS[name]
            out = f(value, shapes, loc, aw, points_per_level)
            err = float((out.float() - ref.float()).abs().max())
            if not (err <= tol):
                raise AssertionError(f"msda variant {name} differs from v0 by {err:.3e} "
                                     f"(tol {tol:.3e}, {label} inputs)")
            del out
            entry.update(max_abs_diff_vs_v0=err, tol=tol, bound_ms=op_ms, bound_by=op_by,
                         bound_note=f"the whole op: value, used locations and weights "
                                    f"read once, output written once, {op_bytes / 1e6:.1f} MB")
            fn = lambda f=f: f(value, shapes, loc, aw, points_per_level)  # noqa: E731
            if name in ("v2", "v2k"):
                _, idx, _ = _tables(value, shapes, loc, aw, points)
                out_size = 4 if name == "v2k" else value.element_size()
                g_ms, g_bytes = gather_bound(idx, 4 * hd * value.element_size(),
                                             4 * hd * out_size, 4 if name == "v2k" else 8)
                entry.update(gather_bound_ms=g_ms, gather_bound_note=(
                    f"its merged gather alone: {nH} x {idx.shape[1] * idx.shape[2]} rows of "
                    f"{4 * hd} written as {'float32' if name == 'v2k' else str(value.dtype)[6:]}"
                    f", {g_bytes / 1e6:.1f} MB"
                    + ("; the kernel writes float32, twice v2's bf16 gather output"
                       if name == "v2k" else "")))
                del idx
        entry.update({k: v for k, v in time_samples(fn, iters, dev, CALLS_PER_SAMPLE).items()
                      if k != "samples_ms"})
        res[name] = entry
        del fn
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    Lv = sum(h * w for h, w in shapes)
    record = {
        "tool": "probe_msda_variants", "inputs": label,
        "geometry": {"levels": [list(s) for s in shapes], "Lv": Lv, "Lq": loc.shape[1],
                     "heads": nH, "head_dim": hd, "points_per_level": list(points),
                     "dtype": str(value.dtype)[6:]},
        "variants": res,
        "calls_per_sample": CALLS_PER_SAMPLE, "samples": iters,
        "sparse_row_gather_launches": sparse_row_gather.launches - launches0,
        "ms_deform_attn_launches": ms_deform_attn.launches - fused0,
        "device": device_label or device_record(dev),
    }
    if emit:
        print(json.dumps(record), flush=True)
    return record


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card; cpu runs the plain versions)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from openpsg_tpu_torch import resolve_device

    device = resolve_device(args.device)
    size = int(os.environ.get("BENCH_IMAGE", 1344))
    iters = int(os.environ.get("BENCH_ITERS", 4))
    variants = [v for v in os.environ.get("VARIANTS", ",".join(VARIANTS)).split(",") if v]
    shapes = encoder_shapes(size)
    value, loc, aw = uniform_inputs(shapes, device)
    with torch.no_grad():
        return run(value, shapes, loc, aw, variants=variants, iters=iters)


if __name__ == "__main__":
    main()
