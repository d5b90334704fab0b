"""Port ops (openpsg_tpu_torch.ops) against the JAX package's ops.

Inputs come from numpy with a seed and go through both.  Tolerances:
float32 at atol=rtol=1e-4 unless stated; boolean/integer outputs exact.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpsg_tpu.ops import mask_ops as jmask
from openpsg_tpu.ops.deform_attn import _ms_deform_attn_flat, ms_deform_attn_reference
from openpsg_tpu.ops.pallas.flash_cross_attn import (
    flash_shared_kv_cross_attn as jflash,
    shared_kv_cross_attn_reference as jref,
)
from openpsg_tpu.ops.pallas.msda_gather import sparse_row_gather as jgather
from openpsg_tpu_torch.ops import flash_cross_attn as fca
from openpsg_tpu_torch.ops import mask_ops
from openpsg_tpu_torch.ops import msda_gather
from openpsg_tpu_torch.ops.deform_attn import level_samples, ms_deform_attn

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


class TestMaskOps:
    @pytest.mark.parametrize("dtype", [bool, np.float32])
    def test_pair_or_masks(self, dtype):
        m = (np.random.default_rng(0).random((5, 12)) < 0.4).astype(dtype)
        want = np.asarray(jmask.pair_or_masks(jnp.asarray(m)))
        got = mask_ops.pair_or_masks(torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("hw,out", [((16, 16), (4, 4)), ((84, 84), (21, 21)),
                                        ((20, 12), (7, 5)), ((8, 8), (16, 16))])
    def test_downsample_mask_bilinear(self, hw, out):
        m = np.random.default_rng(1).random((6,) + hw) < 0.5
        want = np.asarray(jmask.downsample_mask_bilinear(jnp.asarray(m), out))
        got = mask_ops.downsample_mask_bilinear(torch.from_numpy(m), out).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("hw,out", [((64, 64), (16, 16)), ((60, 48), (15, 12)),
                                        ((16, 16), (64, 64)), ((30, 20), (7, 9))])
    def test_downsample_nearest(self, hw, out):
        idm = np.random.default_rng(2).integers(0, 3000, hw).astype(np.int32)
        want = np.asarray(jmask.downsample_nearest(jnp.asarray(idm), out))
        got = mask_ops.downsample_nearest(torch.from_numpy(idm), out).numpy()
        np.testing.assert_array_equal(got, want)

    def test_downsample_nearest_keeps_leading_dims(self):
        """A stack of boolean masks resizes as jax.image.resize 'nearest'
        does over [M, H, W] (the GT-mask path, psg_v4.py:580-582)."""
        m = np.random.default_rng(3).random((5, 64, 60)) < 0.5
        want = np.asarray(jax.image.resize(jnp.asarray(m, jnp.int32), (5, 16, 15),
                                           method="nearest")).astype(bool)
        got = mask_ops.downsample_nearest(torch.from_numpy(m), (16, 15)).numpy()
        np.testing.assert_array_equal(got, want)


def _msda_inputs(seed, shapes, Lq=23, nH=2, hd=8, K=3, spread=1.2):
    rng = np.random.default_rng(seed)
    Lv = sum(h * w for h, w in shapes)
    value = rng.normal(size=(1, Lv, nH, hd)).astype(np.float32)
    # locations reach past the border on every side (zero-padding region)
    loc = (rng.random((1, Lq, nH, len(shapes), K, 2)) * spread - (spread - 1) / 2)
    aw = rng.random((1, Lq, nH, len(shapes), K))
    aw = aw / aw.sum(axis=(-2, -1), keepdims=True)
    return value, loc.astype(np.float32), aw.astype(np.float32)


class TestMSDeformAttn:
    SHAPES = ((8, 6), (4, 3), (2, 2), (1, 1))

    @pytest.mark.parametrize("ppl", [None, (1, 2, 3, 3), (3, 1, 1, 2)])
    def test_matches_flat(self, ppl):
        v, loc, aw = _msda_inputs(0, self.SHAPES)
        want = np.asarray(_ms_deform_attn_flat(
            jnp.asarray(v), self.SHAPES, jnp.asarray(loc), jnp.asarray(aw), ppl))
        got = ms_deform_attn(torch.from_numpy(v), self.SHAPES, torch.from_numpy(loc),
                             torch.from_numpy(aw), points_per_level=ppl).numpy()
        np.testing.assert_allclose(got, want, **TOL)

    def test_matches_numpy_reference(self):
        v, loc, aw = _msda_inputs(1, self.SHAPES[:3], Lq=11)
        want = ms_deform_attn_reference(v, self.SHAPES[:3], loc, aw)
        got = ms_deform_attn(torch.from_numpy(v), self.SHAPES[:3], torch.from_numpy(loc),
                             torch.from_numpy(aw)).numpy()
        np.testing.assert_allclose(got, want, **TOL)

    def test_points_per_level_reads_only_first_points(self):
        """Weights of dropped points must not matter (they are never read)."""
        v, loc, aw = _msda_inputs(2, self.SHAPES)
        ppl = (1, 2, 3, 1)
        aw2 = aw.copy()
        for lvl, kl in enumerate(ppl):
            aw2[..., lvl, kl:] = 7.0
        args = lambda a: (torch.from_numpy(v), self.SHAPES, torch.from_numpy(loc),
                          torch.from_numpy(a))
        np.testing.assert_array_equal(ms_deform_attn(*args(aw), points_per_level=ppl).numpy(),
                                      ms_deform_attn(*args(aw2), points_per_level=ppl).numpy())


def _skv(seed, NP, H, Lq, hd, P, mask_p=0.5):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(NP, H, Lq, hd)).astype(np.float32)
    k = rng.normal(size=(H, P, hd)).astype(np.float32)
    v = rng.normal(size=(H, P, hd)).astype(np.float32)
    mask = rng.random((NP, P)) < mask_p
    mask = np.where(mask.any(-1, keepdims=True), mask, True)
    return q, k, v, mask


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


class TestSharedKVAttention:
    """The plain shared-KV attention against the Pallas kernel (interpret
    mode) and the JAX reference, on the cases of test_pallas_kernels.py."""

    @pytest.mark.parametrize("NP,Lq,P,chunk,tile", [(6, 5, 40, 16, 4), (8, 33, 128, 64, 8)])
    def test_plain_matches_pallas_and_reference(self, NP, Lq, P, chunk, tile):
        q, k, v, mask = _skv(0, NP, 2, Lq, 16, P)
        jargs = [jnp.asarray(a) for a in (q, k, v, mask)]
        pallas = np.asarray(jflash(*jargs, chunk=chunk, pair_tile=tile, interpret=True))
        ref = np.asarray(jref(*jargs))
        got = fca.shared_kv_cross_attn_plain(*_t(q, k, v, mask)).numpy()
        np.testing.assert_allclose(got, pallas, **TOL)
        np.testing.assert_allclose(got, ref, **TOL)

    def test_fully_masked_chunk(self):
        q, k, v, mask = _skv(1, 4, 2, 8, 16, 64, mask_p=1.0)
        mask[0, :32] = False
        pallas = np.asarray(jflash(*(jnp.asarray(a) for a in (q, k, v, mask)),
                                   chunk=32, pair_tile=2, interpret=True))
        got = fca.flash_shared_kv_cross_attn(*_t(q, k, v, mask)).numpy()
        np.testing.assert_allclose(got, pallas, **TOL)

    def test_empty_row_guard(self):
        """An all-False row attends everywhere in both packages' wrappers."""
        from openpsg_tpu.models.relation.qformer import _shared_kv_attention as jskv
        from openpsg_tpu_torch.models.relation.qformer import _shared_kv_attention

        q, k, v, mask = _skv(3, 4, 2, 5, 8, 24)
        mask[1] = False
        want = np.asarray(jskv(*(jnp.asarray(a) for a in (q, k, v, mask))))
        for plain in (False, True):
            got = _shared_kv_attention(*_t(q, k, v, mask), plain=plain).numpy()
            np.testing.assert_allclose(got, want, **TOL)
            assert np.isfinite(got).all()
        np.testing.assert_array_equal(
            fca.guard_empty_mask(torch.from_numpy(mask)).numpy()[1], True)

    def test_cpu_wrapper_takes_plain_path_and_counts_nothing(self):
        q, k, v, mask = _t(*_skv(4, 3, 2, 4, 16, 20))
        before = fca.flash_shared_kv_cross_attn.launches
        by_variant = dict(fca.flash_shared_kv_cross_attn.launches_by_variant)
        got = fca.flash_shared_kv_cross_attn(q, k, v, mask)
        assert fca.flash_shared_kv_cross_attn.launches == before
        assert fca.flash_shared_kv_cross_attn.launches_by_variant == by_variant
        torch.testing.assert_close(got, fca.shared_kv_cross_attn_plain(q, k, v, mask))

    def test_cpu_wrapper_counts_no_hopper_launch(self):
        """bf16, hd 64: the hopper variant's inputs on the card, the plain
        path here, with no launch of either variant counted."""
        q, k, v, mask = _t(*_skv(8, 3, 2, 5, 64, 70))
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        assert fca.kernel_variant(q.dtype, 64, 70) == "hopper"
        before = fca.flash_shared_kv_cross_attn.launches
        by_variant = dict(fca.flash_shared_kv_cross_attn.launches_by_variant)
        got = fca.flash_shared_kv_cross_attn(q, k, v, mask)
        assert fca.flash_shared_kv_cross_attn.launches == before
        assert fca.flash_shared_kv_cross_attn.launches_by_variant == by_variant
        torch.testing.assert_close(got, fca.shared_kv_cross_attn_plain(q, k, v, mask))


# (NP, Lq, P, dtype, hd, variant): the main path's shape and the edges of
# the hopper variant (one pair, a ragged last pair tile, Lq 1, P at the cap
# and one past it), then what only the simple variant takes
VARIANT_CASES = [
    (1024, 33, 441, torch.bfloat16, 64, "hopper"),
    (1, 33, 441, torch.bfloat16, 64, "hopper"),
    (1000, 33, 441, torch.bfloat16, 64, "hopper"),
    (64, 1, 441, torch.bfloat16, 64, "hopper"),
    (130, 33, fca.HOPPER_MAX_P, torch.bfloat16, 64, "hopper"),
    (130, 33, fca.HOPPER_MAX_P + 1, torch.bfloat16, 64, "simple"),
    (1024, 33, 441, torch.float32, 64, "simple"),
    (6, 5, 40, torch.bfloat16, 16, "simple"),
    (6, 5, 40, torch.float32, 16, "simple"),
]


class TestKernelVariant:
    @pytest.mark.parametrize("NP,Lq,P,dtype,hd,variant", VARIANT_CASES)
    def test_kernel_variant(self, NP, Lq, P, dtype, hd, variant):
        assert fca.kernel_variant(dtype, hd, P) == variant

    def test_cap_matches_the_source(self):
        src = (Path(fca.__file__).parents[1] / "csrc" / "flash_shared_kv_cross_attn.cu").read_text()
        assert re.search(r"constexpr int kMaxP = (\d+);", src).group(1) == str(fca.HOPPER_MAX_P)
        assert re.search(r"constexpr int kWords = (\d+);", src).group(1) == str(fca._MASK_WORDS)
        assert 441 <= fca.HOPPER_MAX_P <= 32 * fca._MASK_WORDS  # 441: the main path's 21 x 21

    def test_reset_launches(self):
        fca.flash_shared_kv_cross_attn.launches_by_variant["hopper"] += 1
        fca.reset_launches()
        assert fca.flash_shared_kv_cross_attn.launches == 0
        assert fca.flash_shared_kv_cross_attn.launches_by_variant == {"simple": 0, "hopper": 0}


def _gather_inputs(seed, nH, HW, C, S, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    quad = rng.normal(size=(nH, HW, C)).astype(np.float32)
    idx = rng.integers(lo, HW if hi is None else hi, (nH, S)).astype(np.int32)
    return quad, idx


def _local_gather_inputs():
    """Raster-local indices, the deformable regime (test_pallas_kernels.py:22-32)."""
    rng = np.random.default_rng(2)
    nH, HW, C, S = 2, 2048, 128, 1024
    quad = rng.normal(size=(nH, HW, C)).astype(np.float32)
    base = np.arange(S) * 2 % HW
    idx = np.clip(base + rng.integers(-32, 32, S), 0, HW - 1)
    return quad, np.tile(idx[None], (nH, 1)).astype(np.int32)


# (name, inputs, tq, tv): the cases of test_pallas_kernels.py, then
# out-of-range indices (negative, in the padding rows HW..HWpad, and past
# HWpad) with ragged S and HW, and the tiny segmenter's row width C=16
GATHER_CASES = [
    ("take_0", lambda: _gather_inputs(0, 3, 1000, 128, 700), 128, 256),
    ("take_1", lambda: _gather_inputs(1, 3, 300, 128, 513), 128, 256),
    ("local", _local_gather_inputs, 256, 256),
    ("out_of_range", lambda: _gather_inputs(3, 3, 300, 16, 513, lo=-600, hi=1200), 128, 256),
    ("ragged_default_tiles", lambda: _gather_inputs(4, 2, 700, 128, 1100, lo=-5, hi=705),
     512, 512),
]


class TestSparseRowGather:
    """The plain gather against the Pallas kernel in interpret mode,
    exactly: the one-hot product adds each row to zeros, so it is exact in
    float32, and bf16 rows convert to float32 exactly."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("name,make,tq,tv", GATHER_CASES, ids=[c[0] for c in GATHER_CASES])
    def test_plain_matches_pallas(self, name, make, tq, tv, dtype):
        quad, idx = make()
        jquad = jnp.asarray(quad, dtype)
        want = np.asarray(jgather(jquad, jnp.asarray(idx), tq=tq, tv=tv, interpret=True))
        tquad = torch.from_numpy(np.array(jquad.astype(jnp.float32))).to(getattr(torch, dtype))
        got = msda_gather.sparse_row_gather_plain(tquad, torch.from_numpy(idx))
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_array_equal(got.numpy(), want)

    def test_out_of_range_rows_are_zero(self):
        quad, idx = _gather_inputs(5, 2, 40, 16, 200, lo=-100, hi=140)
        got = msda_gather.sparse_row_gather_plain(*_t(quad, idx)).numpy()
        outside = (idx < 0) | (idx >= 40)
        assert outside.any() and (~outside).any()
        np.testing.assert_array_equal(got[outside], 0.0)
        h = np.nonzero(~outside)
        np.testing.assert_array_equal(got[~outside], quad[h[0], idx[~outside]])

    def test_is_the_gather_of_ms_deform_attn(self):
        """Each level of ms_deform_attn is this gather on ``level_samples``'
        quad table and row index, weighted by its corner weights."""
        shapes = TestMSDeformAttn.SHAPES
        v, loc, aw = _msda_inputs(7, shapes)
        want = np.asarray(_ms_deform_attn_flat(jnp.asarray(v), shapes, jnp.asarray(loc),
                                               jnp.asarray(aw)))
        nH, hd = v.shape[2:]
        Lq, K = loc.shape[1], loc.shape[4]
        out = torch.zeros(Lq, nH, hd)
        for lvl in range(len(shapes)):
            quad, idx, cw = level_samples(*_t(v), shapes, *_t(loc, aw), lvl, K)
            g = msda_gather.sparse_row_gather(quad[0], idx[0].int())
            out += torch.einsum("hqkcd,hqkc->qhd", g.view(nH, Lq, K, 4, hd), cw[0])
        np.testing.assert_allclose(out.reshape(1, Lq, nH * hd).numpy(), want, **TOL)

    def test_cpu_wrapper_takes_plain_path_and_counts_nothing(self):
        quad, idx = _t(*_gather_inputs(6, 2, 50, 16, 30, lo=-3, hi=60))
        before = msda_gather.sparse_row_gather.launches
        got = msda_gather.sparse_row_gather(quad, idx)
        assert msda_gather.sparse_row_gather.launches == before
        torch.testing.assert_close(got, msda_gather.sparse_row_gather_plain(quad, idx),
                                   rtol=0, atol=0)


@pytest.mark.cuda
class TestSparseRowGatherOnCard:
    """The CUDA gather kernel against its plain version, bitwise (needs the card)."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("name,make,tq,tv", GATHER_CASES, ids=[c[0] for c in GATHER_CASES])
    def test_kernel_matches_plain(self, cuda_device, name, make, tq, tv, dtype):
        quad, idx = (t.to(cuda_device) for t in _t(*make()))
        quad = quad.to(dtype)
        before = msda_gather.sparse_row_gather.launches
        got = msda_gather.sparse_row_gather(quad, idx)
        torch.cuda.synchronize()
        assert msda_gather.sparse_row_gather.launches == before + 1
        assert torch.equal(got, msda_gather.sparse_row_gather_plain(quad, idx))

    def test_kernel_rejects_unsupported_input(self, cuda_device):
        quad, idx = (t.to(cuda_device) for t in _t(*_gather_inputs(7, 2, 30, 16, 10)))
        with pytest.raises(ValueError):
            msda_gather.sparse_row_gather(quad[:, :, :12].bfloat16().contiguous(), idx)
        with pytest.raises(TypeError):
            msda_gather.sparse_row_gather(quad.half(), idx)
        with pytest.raises(TypeError):
            msda_gather.sparse_row_gather(quad, idx.long())


@pytest.mark.cuda
class TestSharedKVKernelOnCard:
    """The CUDA kernel against its plain version (needs the card)."""

    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("NP,Lq,hd,P", [(1000, 33, 64, 441), (6, 5, 16, 40)])
    def test_kernel_matches_plain(self, cuda_device, dtype, tol, NP, Lq, hd, P):
        q, k, v, mask = _skv(5, NP, 3, Lq, hd, P)
        mask[::5] = False
        mask[1::2, :64] = False
        q, k, v, mask = (t.to(cuda_device) for t in _t(q, k, v, mask))
        q, k, v = (t.to(dtype) for t in (q, k, v))
        before = fca.flash_shared_kv_cross_attn.launches
        got = fca.flash_shared_kv_cross_attn(q, k, v, mask)
        torch.cuda.synchronize()
        assert fca.flash_shared_kv_cross_attn.launches == before + 1
        want = fca.shared_kv_cross_attn_plain(
            q.float(), k.float(), v.float(), fca.guard_empty_mask(mask))
        assert float((got.float() - want).abs().max()) <= tol

    @pytest.mark.parametrize("NP,Lq,P,dtype,hd,variant", VARIANT_CASES)
    def test_variant_matches_plain(self, cuda_device, NP, Lq, P, dtype, hd, variant):
        """Each variant on its own shapes, by the launch counts it adds; a
        fully masked 64-patch chunk and guarded empty rows in each case."""
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
        q, k, v, mask = _skv(9, NP, 3, Lq, hd, P)
        mask[:, 64:128] = False                     # one whole chunk (or none when P <= 64)
        mask[1::2, :64] = False
        mask[::7] = False                           # empty rows (guarded)
        q, k, v, mask = (t.to(cuda_device) for t in _t(q, k, v, mask))
        q, k, v = (t.to(dtype) for t in (q, k, v))
        before = dict(fca.flash_shared_kv_cross_attn.launches_by_variant)
        got = fca.flash_shared_kv_cross_attn(q, k, v, mask)
        torch.cuda.synchronize()
        after = fca.flash_shared_kv_cross_attn.launches_by_variant
        assert {name: after[name] - before[name] for name in after} == {
            name: int(name == variant) for name in after}
        want = fca.shared_kv_cross_attn_plain(
            q.float(), k.float(), v.float(), fca.guard_empty_mask(mask))
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        assert float((got.float() - want).abs().max()) <= tol

    def test_kernel_rejects_unsupported_input(self, cuda_device):
        q, k, v, mask = (t.to(cuda_device) for t in _t(*_skv(6, 2, 2, 3, 24, 10)))
        with pytest.raises(ValueError):
            fca.flash_shared_kv_cross_attn(q, k, v, mask)       # hd 24
        q, k, v, mask = (t.to(cuda_device) for t in _t(*_skv(6, 2, 2, 3, 64, 10)))
        with pytest.raises(ValueError):
            fca.flash_shared_kv_cross_attn(q, k, v, mask, variant="hopper")  # float32
        q, k, v, mask = (t.to(cuda_device) for t in _t(*_skv(6, 2, 2, 3, 16, 10)))
        with pytest.raises(TypeError):
            fca.flash_shared_kv_cross_attn(q.half(), k.half(), v.half(), mask)
