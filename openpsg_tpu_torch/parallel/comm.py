"""The collectives the port's parallel paths issue, and their autograd
forms.

XLA inserts these implicitly in the JAX package (psum for a row-parallel
matmul or the dp gradient mean, all-gather for a column-parallel output,
``lax.ppermute`` between pipeline stages).  Here each is one call on an
explicit process group:

  * :func:`all_reduce` (SUM or MAX) and :func:`all_gather` (along a dim);
  * Megatron's pair of autograd functions: :func:`copy_to_group`
    (identity forward, all-reduce of the gradient) in front of a
    column-parallel layer, :func:`reduce_from_group` (all-reduce forward,
    identity backward) after a row-parallel one; :func:`gather_from_group`
    (all-gather forward, the rank's slice of the gradient backward);
  * :func:`row_amax`: a row's max |x| over a feature axis split across the
    group (the int8 activation scale of a row-parallel ``QDense``), with
    the gradient of ``jnp.max``: shared equally among ties;
  * :func:`permute`: the pipeline's stage-to-stage send, whose backward
    sends the gradient back (the transpose of ``lax.ppermute``).

A group of one rank still issues its collectives, so a world of one on
the card drives NCCL.  bf16 tensors travel as float32 through gloo, whose
reductions do not take bf16 on every build.
"""

from __future__ import annotations

from typing import Any, List

import torch
import torch.distributed as dist


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    if x.dtype == torch.bfloat16 and dist.get_backend(group) == "gloo":
        return x.float()
    return x.contiguous()


def all_reduce(x: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """A new tensor: ``x`` reduced over ``group`` with SUM or MAX."""
    w = _wire(x, group)
    w = w.clone() if w is x else w
    dist.all_reduce(w, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op], group=group)
    return w.to(x.dtype)


def all_gather(x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """The group's tensors concatenated along ``dim``, in rank order."""
    w = _wire(x, group)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts, dim=dim).to(x.dtype)


def gather_objects(obj: Any, group=None) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order, on every rank."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


class BlockFailed(RuntimeError):
    """A rank's block of a :func:`dp_map` raised: every rank of the axis
    raises this, naming each rank that failed."""


def dp_map(fn, n: int, mesh, axis: str = "dp") -> List[Any]:
    """``[fn(i) for i in range(n)]`` split over the mesh ``axis``: each rank
    runs its contiguous block of the indices (JAX's ``P("dp")`` split; n
    must divide the axis) and every rank gets every result, in order.
    Where a block raises, every rank still gathers, then raises
    :class:`BlockFailed`: the ranks stay in step for their next call."""
    from openpsg_tpu_torch.parallel.mesh import axis_group

    g = axis_group(mesh, axis)
    if g is None:
        return [fn(i) for i in range(n)]
    group, r, size = g
    if n % size:
        raise ValueError(f"{n} items do not split over {axis}={size}")
    per = n // size
    try:
        mine, err, own = [fn(i) for i in range(r * per, (r + 1) * per)], None, None
    except Exception as e:  # gathered, so every rank leaves the call together
        mine, err, own = None, f"{type(e).__name__}: {e}", e
    parts = gather_objects((mine, err), group)
    failed = [f"rank {k} of {axis}: {e}" for k, (_, e) in enumerate(parts) if e is not None]
    if failed:
        raise BlockFailed("; ".join(failed)) from own
    return [res for part, _ in parts for res in part]


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "sum", ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.rank, ctx.n = dim, dist.get_rank(group), x.shape[dim]
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the gradient is summed over ``group`` (the input of a
    column-parallel layer, replicated across its ranks)."""
    return _CopyTo.apply(x, group) if torch.is_grad_enabled() and x.requires_grad else x


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` (a row-parallel layer's partial products);
    the gradient passes unchanged to every rank."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFrom.apply(x, group)
    return all_reduce(x, "sum", group)


def gather_from_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's column blocks concatenated along ``dim``; backward keeps
    the rank's block of the gradient."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherFrom.apply(x, dim, group)
    return all_gather(x, dim, group)


class _RowAmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        a = x.abs()
        m = all_reduce(a.amax(dim=-1, keepdim=True), "max", group)
        ctx.group = group
        ctx.save_for_backward(x, m)
        return m

    @staticmethod
    def backward(ctx, g):
        x, m = ctx.saved_tensors
        tie = (x.abs() == m).to(g.dtype)
        count = all_reduce(tie.sum(dim=-1, keepdim=True), "sum", ctx.group)
        return torch.sign(x) * tie * (g / count), None


def row_amax(x: torch.Tensor, group) -> torch.Tensor:
    """max |x| over the last axis, whose blocks are split across ``group``
    → [..., 1], equal on every rank."""
    return _RowAmax.apply(x, group)


class _Permute(torch.autograd.Function):
    """One pipeline tick's exchange: stage s sends ``y`` to s+1 and receives
    from s-1 (zeros at stage 0).  ``token`` (a scalar that requires grad)
    chains the ticks, so every rank's backward runs the exchanges in the
    same order, newest first."""

    @staticmethod
    def forward(ctx, y, token, group, stage, n_stages):
        ctx.group, ctx.stage, ctx.n, ctx.dtype = group, stage, n_stages, y.dtype
        recv = _exchange(y, group, stage, n_stages, forward=True)
        return recv, token.clone()

    @staticmethod
    def backward(ctx, g_recv, g_token):
        g_y = _exchange(g_recv.to(ctx.dtype).contiguous(), ctx.group, ctx.stage, ctx.n,
                        forward=False)
        return g_y, g_token, None, None, None


def _exchange(x, group, stage, n_stages, forward: bool):
    """Send ``x`` one stage on (forward) or back, receive its counterpart."""
    to = stage + 1 if forward else stage - 1
    frm = stage - 1 if forward else stage + 1
    w = _wire(x, group)
    recv = torch.zeros_like(w)
    ops = []
    if 0 <= to < n_stages:
        ops.append(dist.P2POp(dist.isend, w, dist.get_global_rank(group, to), group))
    if 0 <= frm < n_stages:
        ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, frm), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return recv.to(x.dtype)


def permute(y: torch.Tensor, token: torch.Tensor, group, stage: int, n_stages: int):
    """→ (the previous stage's ``y``, the next ``token``)."""
    if torch.is_grad_enabled() and (y.requires_grad or token.requires_grad):
        return _Permute.apply(y, token, group, stage, n_stages)
    return _exchange(y.contiguous(), group, stage, n_stages, forward=True), token
