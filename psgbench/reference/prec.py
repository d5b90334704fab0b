"""The arithmetic of the plain references: float32 products with TF32 off,
or the control's float8 (e4m3) operands, and a count of the products'
floating-point operations.

Every product of a reference goes through one :class:`Prec`.  In
``"f32"`` mode it is a plain float32 product.  In ``"fp8"`` mode (the
control) both operands are rounded to float8 e4m3 first, with a scale per
row of the reduced axis (activations per token, weights per output
channel), and the product is then taken in float32: the precision one
step below the bfloat16 the configurations state.  ``flops`` counts two
operations per multiply-add of every product, whatever the mode, so a run
on the ``meta`` device counts a model's operations from its shapes alone.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def fp8_round(t: torch.Tensor, dim=-1) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (``None``: one scale for the tensor), returned in float32."""
    t = t.float()
    if t.device.type == "meta":
        return t
    amax = t.abs().amax() if dim is None else t.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Prec:
    """``mode``: ``"f32"`` or ``"fp8"``."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(mode)
        self.mode = mode
        self.flops = 0

    def _r(self, t, dim=-1):
        return fp8_round(t, dim) if self.mode == "fp8" else t.float()

    def linear(self, x, w, b=None):
        """x [..., K] times w [N, K] transposed, plus b [N]."""
        K, N = w.shape[1], w.shape[0]
        self.flops += 2 * (x.numel() // K) * N * K
        y = self._r(x) @ self._r(w).t()
        return y if b is None else y + b.float()

    def einsum(self, eq: str, a, b):
        """A two-operand product; the float8 control scales each operand as
        a whole."""
        ins, out = eq.split("->")
        la, lb = ins.split(",")
        sizes = dict(zip(la, a.shape))
        sizes.update(zip(lb, b.shape))
        n = 1
        for s in set(la) | set(lb):
            n *= sizes[s]
        self.flops += 2 * n
        return torch.einsum(eq, self._r(a, None), self._r(b, None))

    def conv(self, x_hwc, w, b=None, stride=1, padding=0):
        """Conv2d on one [H, W, C] map → [H', W', C']."""
        y = F.conv2d(self._r(x_hwc.permute(2, 0, 1)[None], None),
                     self._r(w.reshape(w.shape[0], -1)).reshape(w.shape),
                     None if b is None else b.float(), stride=stride, padding=padding)
        self.flops += 2 * y.numel() * w[0].numel()
        return y[0].permute(1, 2, 0)


@contextlib.contextmanager
def strict_f32():
    """Float32 products in float32 on the card (TF32 off), restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    """‖a − ref‖ / ‖ref‖ over the whole tensor, in float64."""
    a, ref = a.double(), ref.double()
    den = torch.linalg.vector_norm(ref)
    return float(torch.linalg.vector_norm(a - ref) / torch.clamp(den, min=1e-30))


def layer_norm(x, w, b, eps):
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)


def group_norm32(x_hwc, w, b):
    y = F.group_norm(x_hwc.permute(2, 0, 1)[None].float(), 32, w.float(), b.float(), 1e-5)
    return y[0].permute(1, 2, 0)
