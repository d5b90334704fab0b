"""The fused ``ms_deform_attn`` kernel (``csrc/ms_deform_attn.cu``) against
the port's plain PyTorch version on the card.  Every test here needs a CUDA
device and skips without one; the file imports nothing of JAX.

Tolerances: float32, 2^-16 of the plain output's largest magnitude (the
same float32 products summed in another order: about 1e-7 of the terms'
size over at most 64 samples); bf16, one bf16 step of the larger of the two
outputs plus that float32 slack (both round a float32 sum once, and two sums
that differ in the last float32 bits land on the same bf16 value or a
neighbour).  A wrong row or weight moves an output by the size of a value.
"""

import math

import pytest
import torch

from openpsg_tpu_torch.ops import deform_attn as da

BUCKET_V4 = ((128, 168), (64, 84), (32, 42), (16, 21))  # the 1024x1344 bucket, strides 8-64
BUCKET_V1 = BUCKET_V4[:3]                                # Mask2Former's 3 levels
PR13_1344 = ((168, 168), (84, 84), (42, 42), (21, 21))
DEGENERATE = ((1, 5), (3, 1), (2, 2), (1, 1))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def make_inputs(device, shapes, dtype, Lq=None, B=1, nH=8, hd=32, K=4, where="local",
                seed=0):
    """Seeded inputs: value N(0, 1); locations near each query's own pixel
    (``local``, the encoder's regime, a few pixels of spread), uniform over
    [-0.25, 1.25] (``uniform``: outside the map on every side), or around
    300 boxes (``boxes``, the decoder's box references); weights softmaxed
    over each (query, head)'s L·K points."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    L = len(shapes)
    Lv = sum(h * w for h, w in shapes)
    Lq = Lv if Lq is None else Lq
    value = torch.randn(B, Lv, nH, hd, generator=g)
    if where == "local":
        ref = torch.cat([torch.stack(torch.meshgrid((torch.arange(w) + 0.5) / w,
                                                    (torch.arange(h) + 0.5) / h,
                                                    indexing="xy"), -1).reshape(-1, 2)
                         for h, w in shapes])[:Lq]
        sizes = torch.tensor([(w, h) for h, w in shapes], dtype=torch.float32)
        off = torch.randn(B, Lq, nH, L, K, 2, generator=g) * 3.0 / sizes[None, None, None, :,
                                                                          None, :]
        loc = ref[None, :, None, None, None, :] + off
    elif where == "boxes":
        centre = torch.rand(B, Lq, 1, 1, 1, 2, generator=g)
        wh = torch.rand(B, Lq, 1, 1, 1, 2, generator=g) * 0.5
        loc = centre + (torch.rand(B, Lq, nH, L, K, 2, generator=g) - 0.5) * wh
    else:
        loc = torch.rand(B, Lq, nH, L, K, 2, generator=g) * 1.5 - 0.25
    aw = torch.softmax(torch.randn(B, Lq, nH, L * K, generator=g), -1).view(B, Lq, nH, L, K)
    return (value.to(device, dtype), loc.to(device, torch.float32).contiguous(),
            aw.to(device).contiguous())


def assert_close_to_plain(got, want):
    want_f = want.float()
    slack = 2.0 ** -16 * float(want_f.abs().max())
    diff = (got.float() - want_f).abs()
    if want.dtype == torch.float32:
        assert float(diff.max()) <= slack
        return
    big = torch.maximum(got.float().abs(), want_f.abs()).clamp_min(1e-30)
    step = torch.exp2(torch.floor(torch.log2(big))) * torch.finfo(torch.bfloat16).eps
    assert bool((diff <= step + slack).all()), float((diff - step).max())


# (name, shapes, Lq (None: the encoder's Lv), B, hd, points_per_level, where)
CASES = [
    ("v4_encoder_1024x1344", BUCKET_V4, None, 1, 32, None, "local"),
    ("v1_encoder_1024x1344", BUCKET_V1, None, 1, 32, None, "local"),
    ("encoder_1344x1344", PR13_1344, None, 1, 32, None, "local"),
    ("v4_decoder_300q_boxes", BUCKET_V4, 300, 1, 32, None, "boxes"),
    ("encoder_B2", BUCKET_V1, None, 2, 32, None, "local"),
    ("decoder_B4", BUCKET_V4, 300, 4, 32, None, "boxes"),
    ("int8_config_points_2224", BUCKET_V4, None, 1, 32, (2, 2, 2, 4), "local"),
    ("degenerate_levels_outside", DEGENERATE, 57, 2, 32, (4, 1, 3, 2), "uniform"),
    ("single_pixel_level", ((1, 1),), 9, 1, 32, None, "uniform"),
    ("tiny_head_4", ((8, 6), (4, 3), (2, 2)), 23, 1, 4, (1, 2, 3), "uniform"),
    ("wide_head_64", ((12, 10), (6, 5)), 40, 1, 64, None, "uniform"),
    ("wide_head_128", ((12, 10), (6, 5)), 40, 1, 128, None, "uniform"),
]


@pytest.mark.cuda
class TestMSDeformAttnKernel:
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("name,shapes,Lq,B,hd,ppl,where", CASES, ids=[c[0] for c in CASES])
    def test_kernel_matches_plain(self, cuda_device, name, shapes, Lq, B, hd, ppl, where, dtype):
        value, loc, aw = make_inputs(cuda_device, shapes, dtype, Lq, B, hd=hd, where=where)
        launches, plain = da.ms_deform_attn.launches, da.ms_deform_attn.plain_calls
        with torch.no_grad():
            got = da.ms_deform_attn(value, shapes, loc, aw, points_per_level=ppl)
        torch.cuda.synchronize()
        assert da.ms_deform_attn.launches == launches + 1
        assert da.ms_deform_attn.plain_calls == plain
        want = da.ms_deform_attn_plain(value, shapes, loc, aw, ppl)
        assert got.shape == want.shape and got.dtype == want.dtype == dtype
        assert bool(torch.isfinite(got).all())
        assert_close_to_plain(got, want)

    def test_dropped_points_are_never_read(self, cuda_device):
        value, loc, aw = make_inputs(cuda_device, BUCKET_V1, torch.bfloat16, 300)
        ppl = (1, 3, 2)
        aw2, loc2 = aw.clone(), loc.clone()
        for lvl, kl in enumerate(ppl):
            aw2[..., lvl, kl:] = float("nan")
            loc2[..., lvl, kl:, :] = float("nan")
        a = da.ms_deform_attn(value, BUCKET_V1, loc, aw, points_per_level=ppl)
        b = da.ms_deform_attn(value, BUCKET_V1, loc2, aw2, points_per_level=ppl)
        assert torch.equal(a, b)

    def test_is_deterministic(self, cuda_device):
        value, loc, aw = make_inputs(cuda_device, BUCKET_V4, torch.bfloat16, 300, where="boxes")
        a = da.ms_deform_attn(value, BUCKET_V4, loc, aw)
        assert torch.equal(a, da.ms_deform_attn(value, BUCKET_V4, loc, aw))

    def test_kernel_rejects_unsupported_input(self, cuda_device):
        shapes = ((6, 5), (3, 3))
        value, loc, aw = make_inputs(cuda_device, shapes, torch.bfloat16, 7)
        with pytest.raises(TypeError, match="value"):
            da.ms_deform_attn(value.half(), shapes, loc, aw)
        with pytest.raises(TypeError, match="sampling_locations"):
            da.ms_deform_attn(value, shapes, loc.bfloat16(), aw)
        with pytest.raises(ValueError, match="value must be contiguous"):
            da.ms_deform_attn(value.transpose(2, 3).contiguous().transpose(2, 3), shapes,
                              loc, aw)
        with pytest.raises(ValueError, match="hd=12"):
            da.ms_deform_attn(value[..., :12].contiguous(), shapes, loc, aw)
        assert torch.isfinite(da.ms_deform_attn(value, shapes, loc, aw)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_routes_to_plain(cuda_device, dtype):
    """An input that needs a gradient takes the plain path (one plain call,
    no launch) with today's output and gradient; under ``no_grad`` the same
    inputs launch the kernel."""
    shapes = ((10, 12), (5, 6), (3, 3))
    value, loc, aw = make_inputs(cuda_device, shapes, dtype, 50, where="uniform")
    value.requires_grad_()
    loc.requires_grad_()
    launches, plain = da.ms_deform_attn.launches, da.ms_deform_attn.plain_calls
    out = da.ms_deform_attn(value, shapes, loc, aw)
    assert (da.ms_deform_attn.launches, da.ms_deform_attn.plain_calls) == (launches, plain + 1)
    ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to(cuda_device, dtype)
    got = torch.autograd.grad(out, (value, loc), ct)
    want_out = da.ms_deform_attn_plain(value, shapes, loc, aw)
    want = torch.autograd.grad(want_out, (value, loc), ct)
    assert torch.equal(out, want_out)
    for g, w in zip(got, want):
        # the gather's backward adds with atomics, in bf16 for a bf16 value:
        # the order of a sum may change from run to run
        tol = (2.0 ** -5 if dtype == torch.bfloat16 else 1e-5) * float(w.float().abs().max())
        assert g is not None and float((g.float() - w.float()).abs().max()) <= tol
        assert bool(g.abs().sum() > 0)
    with torch.no_grad():
        fused = da.ms_deform_attn(value, shapes, loc, aw)
    torch.cuda.synchronize()
    assert da.ms_deform_attn.launches == launches + 1
    assert_close_to_plain(fused, want_out.detach())


@pytest.mark.cuda
def test_plan_follows_the_shape_on_this_card(cuda_device):
    """The encoder fills the card with one thread per 16 bytes of a head;
    the decoder's 300 queries split each (query, head) over the levels."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    enc = da.launch_plan(torch.bfloat16, 32, 8 * sum(h * w for h, w in BUCKET_V4), 4, sms)
    dec = da.launch_plan(torch.bfloat16, 32, 8 * 300, 4, sms)
    assert enc[:2] == (4, 1) and dec[:2] == (4, 4)
    assert math.ceil(8 * 300 * 16 / dec[2]) >= sms
