"""``models.common.mm_f32``, the port's one rule for float32 sums of exact
products, over every equation the port passes to it.

The CPU widens both operands (the einsum the CPU tests have always seen);
its planned route, one ``torch.bmm`` per call (``bmm_einsum``), runs here
on float32 operands, contiguous or not, against ``torch.einsum`` at
atol=rtol=1e-6.  On a card, bf16 operands take that route with
``out_dtype=float32`` and agree with the widened einsum to float32
rounding; an operand that needs a gradient widens.  No JAX here."""

import pytest
import torch

from openpsg_tpu_torch.models.common import bmm_einsum, mm_f32

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

# every equation of an mm_f32 call in openpsg_tpu_torch, by caller
EQUATIONS = [
    "whld,whmd->whlm",       # Swin window attention
    "qhd,khd->hqk",          # OpenSeeD decoder attention
    "qc,hwc->qhw",           # both segmenters' masks
    "qc,cp->qp",             # OpenSeeD class projection
    "qc,pc->qp",             # Mask2Former attention mask gate
    "bhqd,bhkd->bhqk",       # Q-Former
    "brnc,brmc->brnm",       # heads v1 and v3
    "rl,bld->brd",           # head v3 relation spans
    "bnmp,brp->brnm",        # head v3 pair scores
    "bsrc,borc->brso",       # head v2 vision scores
    "brpd,rd->brp",          # head v2 triplet scores
    "bpc,brc->bpr",          # interactive fusion
    "nsoc,rc->nrso",         # interactive fusion pair scores
    "mk,nk->mn",             # weight-only int8 and row-parallel products
    "blgrd,bmgd->bgrlm",     # Llama grouped-query attention
    "blhd,bmhd->bhlm",       # MLA prefill
    "bqr,bsr->bqs",          # MLA decode over the latent cache
    "td,ed->te",             # MoE router
]


def _operands(eq, contiguous, dtype=torch.float32, device="cpu", seed=0):
    """Operands of ``eq`` with a distinct size per index; not contiguous:
    each laid out in reversed dim order, then permuted back."""
    ins = eq.split("->")[0].split(",")
    size = {i: 2 + n for n, i in enumerate(sorted(set("".join(ins))))}
    gen = torch.Generator().manual_seed(seed)
    out = []
    for idx in ins:
        shape = [size[i] for i in idx]
        if contiguous:
            t = torch.randn(shape, generator=gen)
        else:
            t = torch.randn(shape[::-1], generator=gen).permute(*reversed(range(len(shape))))
        out.append(t.to(device, dtype))
    return out


@pytest.mark.parametrize("contiguous", [True, False])
@pytest.mark.parametrize("eq", EQUATIONS)
def test_planned_bmm_matches_einsum(eq, contiguous):
    a, b = _operands(eq, contiguous)
    if not contiguous:
        assert not (a.is_contiguous() and b.is_contiguous())
    got = bmm_einsum(a, b, eq)
    want = torch.einsum(eq, a, b)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_planned_result_takes_a_view_as_the_router_does():
    """The router views the product's [T, E] as [B, L, E]."""
    h, w = torch.randn(3, 5, 8), torch.randn(6, 8)
    got = bmm_einsum(h.reshape(-1, 8), w, "td,ed->te").view(3, 5, 6)
    torch.testing.assert_close(got, torch.einsum("bld,ed->ble", h, w), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("eq", ["qc,hwc->qhw", "blgrd,bmgd->bgrlm"])
def test_cpu_widens_bf16_as_before(eq):
    a, b = _operands(eq, True, torch.bfloat16)
    got = mm_f32(a, b, eq)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.einsum(eq, a.float(), b.float()))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: out_dtype products have no CPU kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("eq", EQUATIONS)
def test_card_bf16_takes_out_dtype_and_agrees_with_widening(cuda_device, eq):
    a, b = _operands(eq, False, torch.bfloat16, cuda_device)
    with torch.no_grad():
        got = mm_f32(a, b, eq)
        route = bmm_einsum(a, b, eq, out_dtype=torch.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = torch.einsum(eq, a.float(), b.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert got.dtype == torch.float32 and torch.equal(got, route)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    # a gradient takes the widened einsum
    a.requires_grad_(True)
    y = mm_f32(a, b, eq)
    y.sum().backward()
    assert a.grad is not None and a.grad.dtype == torch.bfloat16
