"""Port ops (openpsg_tpu_torch.ops) against the JAX package's ops.

Inputs come from numpy with a seed and go through both.  Tolerances:
float32 at atol=rtol=1e-4 unless stated; boolean/integer outputs exact.
"""

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
from openpsg_tpu_torch.ops import flash_cross_attn as fca
from openpsg_tpu_torch.ops import mask_ops
from openpsg_tpu_torch.ops.deform_attn import ms_deform_attn

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
        got = fca.flash_shared_kv_cross_attn(q, k, v, mask)
        assert fca.flash_shared_kv_cross_attn.launches == before
        torch.testing.assert_close(got, fca.shared_kv_cross_attn_plain(q, k, v, mask))


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

    def test_kernel_rejects_unsupported_input(self, cuda_device):
        q, k, v, mask = (t.to(cuda_device) for t in _t(*_skv(6, 2, 2, 3, 24, 10)))
        with pytest.raises(ValueError):
            fca.flash_shared_kv_cross_attn(q, k, v, mask)       # hd 24
        q, k, v, mask = (t.to(cuda_device) for t in _t(*_skv(6, 2, 2, 3, 16, 10)))
        with pytest.raises(TypeError):
            fca.flash_shared_kv_cross_attn(q.half(), k.half(), v.half(), mask)
