"""Image preprocessing: keep-ratio resize, pad to static buckets (counterpart
of ``openpsg_tpu/data/preprocess.py``), with the resizes in numpy.

Test pipeline: resize keep-ratio to fit the scale, pad to a bucket (÷32),
carry the valid region (img_h, img_w); normalization runs on the device
(``openseed.normalize_image``).  The JAX package resizes with cv2; the
port's :func:`resize_linear_u8` and :func:`resize_nearest` reproduce
cv2's ``INTER_LINEAR`` on 8-bit images and ``INTER_NEAREST`` exactly, so
the port needs no cv2.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from openpsg_tpu_torch.utils.image_io import load_image_rgb  # noqa: F401  (the data API)

COEF_BITS = 11               # cv2's INTER_RESIZE_COEF_BITS
COEF_SCALE = 1 << COEF_BITS


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _linear_taps(n_in: int, n_out: int):
    """cv2's source index and fractional offset per output index: the
    offset ``(i + 0.5) * (in / out) - 0.5`` in float64, then float32."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(np.float32)).astype(np.float32)


def _coefs(frac: np.ndarray):
    """11-bit fixed-point weights of the two taps, each rounded half to even
    from float32 (``saturate_cast<short>``)."""
    w0 = np.rint((np.float32(1) - frac) * np.float32(COEF_SCALE)).astype(np.int32)
    w1 = np.rint(frac * np.float32(COEF_SCALE)).astype(np.int32)
    return w0, w1


def resize_linear_u8(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """cv2 ``resize(img, (w, h), interpolation=INTER_LINEAR)`` on a uint8
    [h, w, C] image, bit for bit.

    Horizontal pass in integers: taps clamped to the border (an offset
    before the first pixel or past the last takes that pixel with weight
    2048).  Vertical pass as cv2's vector code computes it: each row sum
    shifted right by 4 to 16 bits, multiplied by the row weight keeping the
    high 16 bits, the two products added, then ``(x + 2) >> 2``; rows
    clamped to the border.  At an exact 2× downscale cv2 switches to
    ``INTER_AREA``, whose ``(a + b + c + d + 2) >> 2`` this rule equals
    (every weight is 1024)."""
    h, w = img.shape[:2]
    nh, nw = int(out_hw[0]), int(out_hw[1])
    src = img.reshape(h, w, -1).astype(np.int32)
    sx, fx = _linear_taps(w, nw)
    edge = (sx < 0) | (sx >= w - 1)
    fx = np.where(edge, np.float32(0), fx)
    sx = np.clip(sx, 0, w - 1)
    a0, a1 = _coefs(fx)
    rows = (src[:, sx] * a0[None, :, None]
            + src[:, np.minimum(sx + 1, w - 1)] * a1[None, :, None])      # [h, nw, C]
    sy, fy = _linear_taps(h, nh)
    b0, b1 = _coefs(fy)
    r0 = rows[np.clip(sy, 0, h - 1)] >> 4
    r1 = rows[np.clip(sy + 1, 0, h - 1)] >> 4
    out = (((r0 * b0[:, None, None]) >> 16) + ((r1 * b1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape((nh, nw) + img.shape[2:])


def resize_nearest(a: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """cv2 ``INTER_NEAREST``: source index ``min(floor(i * (1 / (out /
    in))), in - 1)`` in float64 along each of the first two axes."""
    h, w = a.shape[:2]
    nh, nw = int(out_hw[0]), int(out_hw[1])
    sy = np.minimum(np.floor(np.arange(nh) * (1.0 / (nh / h))).astype(np.int64), h - 1)
    sx = np.minimum(np.floor(np.arange(nw) * (1.0 / (nw / w))).astype(np.int64), w - 1)
    return a[sy][:, sx]


def aspect_buckets(scale: Tuple[int, int] = (1333, 1333),
                   size_divisor: int = 32) -> Tuple[Tuple[int, int], ...]:
    """Square + landscape + portrait 4:3 buckets for a square test cap: a
    keep-ratio resize of a 4:3 (or wider) image into (1333, 1333) fits
    1000×1333 → the 1024×1344 bucket; squarer images take the square one."""
    long_side = _round_up(max(scale), size_divisor)
    short_side = _round_up(int(max(scale) * 3 / 4 + 0.5), size_divisor)
    if short_side >= long_side:
        return ((long_side, long_side),)
    return ((short_side, long_side), (long_side, short_side), (long_side, long_side))


@dataclasses.dataclass(frozen=True)
class Preprocessor:
    """[h, w, 3] uint8 RGB → padded bucket image, valid region, scale.

    ``buckets``: static pad targets (h, w); None → one square bucket at the
    scale rounded up to ÷size_divisor.  Each image takes the smallest-area
    bucket that fits its keep-ratio resize."""

    scale: Tuple[int, int] = (1333, 1333)
    size_divisor: int = 32
    buckets: Optional[Tuple[Tuple[int, int], ...]] = None

    @property
    def bucket_hw(self) -> Tuple[int, int]:
        """The largest (fallback) bucket."""
        if self.buckets:
            return max(self.buckets, key=lambda b: b[0] * b[1])
        return (_round_up(max(self.scale), self.size_divisor),) * 2

    def rescale_size(self, h: int, w: int) -> Tuple[int, int]:
        """mmdet keep-ratio: factor min(long/max(h,w), short/min(h,w)),
        sizes rounded half up."""
        long_side, short_side = max(self.scale), min(self.scale)
        f = min(long_side / max(h, w), short_side / min(h, w))
        return int(h * f + 0.5), int(w * f + 0.5)

    def bucket_for(self, h: int, w: int) -> Tuple[int, int]:
        """Smallest-area bucket fitting the keep-ratio resize of (h, w)."""
        nh, nw = self.rescale_size(h, w)
        cands = list(self.buckets) if self.buckets else [self.bucket_hw]
        fits = [b for b in cands if nh <= b[0] and nw <= b[1]]
        if not fits:
            raise ValueError(f"no bucket of {cands} fits a {nh}x{nw} resize")
        return min(fits, key=lambda b: b[0] * b[1])

    def __call__(self, image_rgb: np.ndarray, bucket: Optional[Tuple[int, int]] = None):
        """→ dict(image [H, W, 3] uint8 padded, img_shape (h', w'),
        ori_shape (h, w), scale_factor).  ``bucket`` pins the pad target;
        when an annotation's size disagreed with the file and the resize
        does not fit it, the image shrinks to fit."""
        h, w = image_rgb.shape[:2]
        nh, nw = self.rescale_size(h, w)
        H, W = bucket if bucket is not None else self.bucket_for(h, w)
        if nh > H or nw > W:
            f = min(H / nh, W / nw)
            nh, nw = min(int(nh * f), H), min(int(nw * f), W)
        resized = resize_linear_u8(image_rgb, (nh, nw))
        out = np.zeros((H, W, 3), image_rgb.dtype)
        out[:nh, :nw] = resized
        return {
            "image": out,
            "img_shape": (nh, nw),
            "ori_shape": (h, w),
            "scale_factor": np.array([nw / w, nh / h, nw / w, nh / h], np.float32),
        }
