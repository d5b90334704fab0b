"""The segmenters' ``segment`` on the graph path (``utils/graphs.graphed_call``:
one segmented CUDA graph per image shape) and the hook rule of every
segmented graph (``utils/graphs.SegmentedGraph``: a hooked module's forward
stays captured, its hooks run eagerly between the graphs).

On the CPU: ``segment`` runs eagerly and counts so; a second call at a
shape builds no constant from host data (the segmenters' constants are
cached per shape and device); each cached constant holds the bits of the
per-call construction it replaced.  On the card (``cuda`` cases, which
skip here): both families at full width (OpenSeeD Swin-T and Mask2Former
R50, bf16) on the three COCO buckets replay bit for bit as the eager call
runs, without a wait for the card; a call's outputs survive the next; the
deformable-attention kernel's launches are counted on replay; the
benchmark's kind of hooks fire once a call with eager values; new hooks or
moved weights capture anew; and the hook rule alone on a tiny module, a
tiny Llama and a tiny DeepSeek-V3.  The file imports nothing of JAX."""

import dataclasses

import numpy as np
import pytest
import torch

from openpsg_tpu_torch.models.common import init_params
from openpsg_tpu_torch.models.detectors.mask2former_relation import (
    M2FRelationConfig,
    PSGMask2FormerRelation,
)
from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config
from openpsg_tpu_torch.models.llm.decode import greedy_decode
from openpsg_tpu_torch.models.llm.deepseek_v3 import (
    DeepseekV3Config,
    DeepseekV3WithEmbeddings,
    MoE,
)
from openpsg_tpu_torch.models.llm.llama import LlamaConfig, LlamaWithEmbeddings
from openpsg_tpu_torch.models.segmenter import (
    decoder,
    deform_layers,
    mask2former_decoder,
    openseed,
    pixel_decoder,
    swin,
)
from openpsg_tpu_torch.models.segmenter.mask2former import (
    Mask2FormerConfig,
    Mask2FormerSegmenter,
)
from openpsg_tpu_torch.models.segmenter.openseed import (
    OpenSeedSegmenter,
    SegmenterConfig,
    normalize_image,
)
from openpsg_tpu_torch.ops.deform_attn import ms_deform_attn
from openpsg_tpu_torch.utils.graphs import graphed_call

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

FAMILIES = ("v4", "v1")
BUCKETS = ((1024, 1344), (1344, 1024), (1344, 1344))
# fused ms_deform_attn launches a call: v4's 6 encoder and 9 decoder layers,
# v1's 6 encoder layers
MSDA_LAUNCHES = {"v4": 15, "v1": 6}
COUNTERS = ("graph_captures", "graph_calls", "eager_calls")


def counts():
    return {k: getattr(graphed_call, k) for k in COUNTERS}


def since(before):
    return {k: getattr(graphed_call, k) - before[k] for k in COUNTERS}


def same_bits(a, b) -> bool:
    """Equal structure and equal bytes in every tensor (NaNs included)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return (a.shape == b.shape and a.dtype == b.dtype
                and torch.equal(a.contiguous().view(-1).view(torch.uint8),
                                b.contiguous().view(-1).view(torch.uint8)))
    return a == b


def eager(model, img):
    """The segmenter's forward called directly: the eager call's ops."""
    with torch.no_grad():
        if isinstance(model, PSGv4):
            return model.segmenter(normalize_image(img), model.class_embeds)
        return model.segmenter(normalize_image(img))


# ------------------------------------------------------------------ CPU


@pytest.fixture(scope="module")
def tiny():
    """Both families at their tiny configs on the CPU; v4's Swin has shifted
    windows in two stages and its encoder reads fewer points on some
    levels, so its shift masks and point table are built too."""
    seg = dataclasses.replace(SegmenterConfig.tiny_test(), depths=(2, 2, 1, 1),
                              enc_points_per_level=(2, 4, 3))
    v4 = PSGv4(dataclasses.replace(PSGv4Config.tiny_test(), segmenter=seg), seed=0,
               device="cpu")
    v1 = PSGMask2FormerRelation(M2FRelationConfig.tiny_test(), seed=0, device="cpu")
    img = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (64, 64, 3))
                           .astype(np.uint8))
    return {"v4": v4, "v1": v1}, img


@pytest.mark.parametrize("family", FAMILIES)
def test_cpu_segment_runs_eagerly(tiny, family):
    models, img = tiny
    before = counts()
    got = models[family].segment(img)
    assert since(before) == {"graph_captures": 0, "graph_calls": 0, "eager_calls": 1}
    assert same_bits(got, eager(models[family], img))
    assert "_graph_keeper" not in vars(models[family].segmenter)


@pytest.mark.parametrize("family", FAMILIES)
def test_a_seen_shape_builds_no_constant_from_the_host(tiny, family, monkeypatch):
    """The second call at a shape takes every constant from the caches: no
    ``torch.tensor``, ``torch.from_numpy`` or ``torch.as_tensor`` runs."""
    models, img = tiny
    first = models[family].segment(img)
    made = []
    for name in ("tensor", "from_numpy", "as_tensor"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _r=real, _n=name, **k:
                            made.append(_n) or _r(*a, **k))
    second = models[family].segment(img)
    monkeypatch.undo()
    assert made == []
    assert same_bits(first, second)


# the per-call constructions the caches replaced, as they were
def _old_rel_index(window, device):
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij")
                      ).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (window - 1)
    idx = (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int64)
    return torch.from_numpy(idx.reshape(-1)).to(device)


def _old_shift_mask(Hp, Wp, w, s, device):
    img = np.zeros((Hp, Wp), np.int32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -s), slice(-s, None)):
        for ws in (slice(0, -w), slice(-w, -s), slice(-s, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(Hp // w, w, Wp // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    diff = win[:, None, :] != win[:, :, None]
    return torch.from_numpy(np.where(diff, -100.0, 0.0).astype(np.float32)).to(device)


def _old_level_sizes(spatial_shapes, device):
    return torch.tensor([(w, h) for (h, w) in spatial_shapes], dtype=torch.float32,
                        device=device)


def _old_point_keep(L, K, points_per_level, device):
    keep = torch.zeros(L, K, dtype=torch.float32, device=device)
    for lvl, kl in enumerate(points_per_level):
        keep[lvl, : int(kl)] = 1.0
    return keep


def _old_sine_ladder(half, temperature, device):
    return torch.tensor(temperature ** (2.0 * (np.arange(half) // 2) / half),
                        dtype=torch.float32, device=device)


def _old_points(make):
    return lambda spatial_shapes, device: torch.from_numpy(
        np.asarray(make(list(spatial_shapes)))).to(device)


def _old_proposal_bases(spatial_shapes, wh_exp, device):
    centers = deform_layers.make_reference_points(spatial_shapes)
    base_wh = np.concatenate([np.full((h * w, 2), 0.05, np.float32) * (2.0 ** wh_exp[lvl])
                              for lvl, (h, w) in enumerate(spatial_shapes)])
    base_np = np.concatenate([centers, base_wh], -1).astype(np.float32)
    valid = torch.from_numpy(((base_np > 0.01) & (base_np < 0.99)).all(-1)).to(device)
    return valid, torch.from_numpy(base_np).to(device), torch.tensor(float("inf"),
                                                                     device=device)


def _old_pixel_stats(device):
    return (torch.tensor(openseed.PIXEL_MEAN, dtype=torch.float32, device=device),
            torch.tensor(openseed.PIXEL_STD, dtype=torch.float32, device=device))


CONSTANTS = {
    "rel_pos_index": ([swin], _old_rel_index),
    "shift_mask": ([swin], _old_shift_mask),
    "level_sizes": ([deform_layers], _old_level_sizes),
    "point_keep": ([deform_layers], _old_point_keep),
    "sine_ladder": ([deform_layers], _old_sine_ladder),
    "reference_points_on": ([pixel_decoder], _old_points(deform_layers.make_reference_points)),
    "cumsum_points_on": ([pixel_decoder, mask2former_decoder],
                      _old_points(deform_layers.make_cumsum_points)),
    "proposal_bases": ([decoder], _old_proposal_bases),
    "pixel_stats": ([openseed], _old_pixel_stats),
}


@pytest.mark.parametrize("name", sorted(CONSTANTS))
def test_constants_hold_the_per_call_bits(tiny, name, monkeypatch):
    """Every key a tiny family's call asks of the cache ``name`` (both
    families' calls recorded) gives the bits of the construction it
    replaced; both families together ask at least one."""
    models, img = tiny
    mods, old = CONSTANTS[name]
    asked = []
    for mod in mods:
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *key, _r=real: asked.append(key) or _r(*key))
    for family in FAMILIES:
        models[family].segment(img)
    monkeypatch.undo()
    assert asked
    cached = getattr(mods[0], name)
    for key in asked:
        got, want = cached(*key), old(*key)
        assert same_bits(got, want), (name, key)


# ------------------------------------------------------------------ card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph path runs only there")
    return torch.device("cuda")


class _Seg:
    """What ``segment`` reads of its model: the segmenter (and v4's class
    embeddings), so that the methods run without the relation head and
    the LLM."""

    def __init__(self, family, dev, seed=0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        bf16 = torch.bfloat16
        if family == "v4":
            make = lambda: OpenSeedSegmenter(SegmenterConfig(dtype=bf16))
        else:
            make = lambda: Mask2FormerSegmenter(Mask2FormerConfig(dtype=bf16,
                                                                  enc_ffn_hidden=1024))
        with torch.device("meta"):
            m = make()
        self.segmenter = m.to(bf16).to_empty(device=dev).eval().requires_grad_(False)
        init_params(self.segmenter, gen)
        self.family = family
        if family == "v4":
            self.class_embeds = torch.randn(133, 512, generator=gen, device=dev)

    def segment(self, img):
        cls = PSGv4 if self.family == "v4" else PSGMask2FormerRelation
        return cls.segment(self, img)

    def eager(self, img):
        with torch.no_grad():
            if self.family == "v4":
                return self.segmenter(normalize_image(img), self.class_embeds)
            return self.segmenter(normalize_image(img))


@pytest.fixture(scope="module")
def full(card):
    return {f: _Seg(f, card) for f in FAMILIES}


def image(hw, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, hw + (3,), generator=gen, device=dev, dtype=torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", BUCKETS)
@pytest.mark.parametrize("family", FAMILIES)
def test_replay_equals_eager_bit_for_bit(full, card, family, hw):
    """A bucket's first call captures, the next ones replay: each equals
    the eager call on its image bit for bit, a call's outputs survive the
    next call, a replay counts the kernel's launches, and neither a replay
    nor an eager call at a seen shape waits for the card."""
    s = full[family]
    imgs = [image(hw, i, card) for i in range(3)]
    want = [s.eager(x) for x in imgs]
    before = counts()
    got = [s.segment(imgs[0])]
    assert since(before) == {"graph_captures": 1, "graph_calls": 1, "eager_calls": 0}
    launches = ms_deform_attn.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got.append(s.segment(imgs[1]))
        got.append(s.segment(imgs[2]))
        again = s.eager(imgs[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert ms_deform_attn.launches - launches == 3 * MSDA_LAUNCHES[family]
    assert since(before) == {"graph_captures": 1, "graph_calls": 3, "eager_calls": 0}
    for g, w in zip(got, want):
        assert same_bits(g, w)
    assert same_bits(again, want[0])
    assert not same_bits(got[0]["masks"], got[1]["masks"])


def install_taps(s, seen):
    """The benchmark's kind of hooks: the pixel decoder's output, every
    decoder layer's inputs, the last layer's output, and (v1) every gate's
    mask head; each keeps what it is handed.  → their handles."""
    dec = s.segmenter.decoder
    keep = lambda key, pick: lambda mod, args, out=None: seen.setdefault(key, []).append(
        pick(args, out))
    hs = [s.segmenter.pixel_decoder.register_forward_hook(keep("memory", lambda a, o: o[0])),
          dec.layers[-1].register_forward_hook(keep("dec_out", lambda a, o: o))]
    for layer in dec.layers:
        hs.append(layer.register_forward_pre_hook(keep("dec_in", lambda a, o: a[:2])))
        if s.family == "v1":
            hs.append(layer.mask_head.register_forward_hook(keep("gate", lambda a, o: o)))
    return hs


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_hooks_fire_once_a_call_with_eager_values(full, card, family):
    """Hooks put on after a capture: the next call captures anew, the hooks
    see each call once, the capture's included, with the eager call's
    values, and what they keep survives later replays."""
    s = full[family]
    hw = BUCKETS[0]
    imgs = [image(hw, 10 + i, card) for i in range(3)]
    s.segment(imgs[0])
    eager_seen, seen = {}, {}
    handles = install_taps(s, eager_seen)
    try:
        want = [s.eager(x) for x in imgs]
        handles += install_taps(s, seen)
        for h in handles[:len(handles) // 2]:
            h.remove()
        before = counts()
        got = [s.segment(x) for x in imgs]
        assert since(before)["graph_captures"] == 1
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    assert same_bits(got, want)
    assert set(seen) == set(eager_seen)
    for key in seen:
        assert len(seen[key]) == len(eager_seen[key]) > 0
        assert same_bits(seen[key], eager_seen[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("change", ["hook", "weights"])
@pytest.mark.parametrize("family", FAMILIES)
def test_new_hooks_or_moved_weights_capture_anew(full, card, family, change):
    """A hook put on a module, or weights loaded with ``assign=True`` (new
    tensors), after a capture: the next call captures anew and gives the
    eager call's bits with the model as it now is."""
    s = _Seg(family, card, seed=1) if change == "weights" else full[family]
    img = image(BUCKETS[0], 20, card)
    first = s.segment(img)
    before = counts()
    handle = None
    if change == "hook":
        handle = s.segmenter.backbone.register_forward_hook(lambda mod, args, out: None)
    else:
        other = _Seg(family, card, seed=2)
        s.segmenter.load_state_dict(other.segmenter.state_dict(), assign=True)
    try:
        got = s.segment(img)
        want = s.eager(img)
    finally:
        if handle is not None:
            handle.remove()
    assert since(before)["graph_captures"] == 1
    assert same_bits(got, want)
    assert same_bits(got, first) == (change == "hook")


# ------------------------------------------------------ the hook rule alone


class Inner(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(8, 8)
        self.forwards = 0

    def forward(self, x, scale):
        self.forwards += 1
        return torch.relu(self.lin(x)) * scale


class Outer(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.inner = Inner()
        self.out = torch.nn.Linear(8, 4)

    def forward(self, x):
        h = self.inner(x * 0.5, torch.ones((), device=x.device))
        return self.out(h + 1.0)


def tiny_module(dev):
    torch.manual_seed(0)
    return Outer().to(dev).eval().requires_grad_(False)


def run(m, x):
    with torch.no_grad():
        return graphed_call(m, lambda v: m(v), x)


@pytest.mark.cuda
def test_a_hooked_forward_stays_captured(card):
    """A pre-hook and a forward hook on the inner module: its Python forward
    runs twice (the warm-up and the capture), never at replay, and the
    hooks run once a call, on copies with the eager values."""
    m = tiny_module(card)
    seen = []
    m.inner.register_forward_pre_hook(lambda mod, args: seen.append(("pre", args[0])))
    m.inner.register_forward_hook(lambda mod, args, out: seen.append(("post", out)))
    xs = [torch.randn(3, 8, device=card) for _ in range(4)]
    got = [run(m, x) for x in xs]
    assert m.inner.forwards == 2
    want_seen = []
    m.inner._forward_pre_hooks.clear()
    m.inner._forward_hooks.clear()
    m.inner.register_forward_pre_hook(lambda mod, args: want_seen.append(("pre", args[0])))
    m.inner.register_forward_hook(lambda mod, args, out: want_seen.append(("post", out)))
    with torch.no_grad():
        want = [m(x) for x in xs]
    assert same_bits(got, want)
    assert [k for k, _ in seen] == ["pre", "post"] * 4
    assert same_bits([t for _, t in seen], [t for _, t in want_seen])


@pytest.mark.cuda
def test_returned_values_replace_the_buffers(card):
    """A pre-hook returns new arguments and a forward hook a new output,
    each from a value that changes from call to call: the later graphs read
    what the hooks returned, as the eager call does."""
    calls = []

    def pre(mod, args):
        calls.append(None)
        return args[0] + len(calls), args[1] * 2

    def post(mod, args, out):
        return out - len(calls)

    xs = [torch.randn(3, 8, device=card) for _ in range(4)]
    m = tiny_module(card)
    m.inner.register_forward_pre_hook(pre)
    m.inner.register_forward_hook(post)
    got = [run(m, x) for x in xs]
    calls.clear()
    with torch.no_grad():
        want = [m(x) for x in xs]
    assert same_bits(got, want)
    assert not same_bits(got[1], got[2])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
@pytest.mark.parametrize("kind", ["pre", "post"])
def test_edits_in_place_reach_the_later_graphs(card, kind, mode):
    """A pre-hook that edits its argument in place, or a forward hook its
    output (``out.mul_``), by a factor that changes from call to call and
    returns nothing: the later graphs read the edited values, as the eager
    call does, under ``no_grad`` and under inference mode."""
    calls = []

    def pre(mod, args):
        calls.append(None)
        args[0].add_(len(calls))

    def post(mod, args, out):
        calls.append(None)
        out.mul_(len(calls) + 1)

    ctx = torch.inference_mode if mode == "inference_mode" else torch.no_grad
    xs = [torch.randn(3, 8, device=card) for _ in range(4)]
    m = tiny_module(card)
    (m.inner.register_forward_pre_hook(pre) if kind == "pre"
     else m.inner.register_forward_hook(post))
    with ctx():
        got = [graphed_call(m, lambda v: m(v), x) for x in xs]
    assert m.inner.forwards == 2
    calls.clear()
    with ctx():
        want = [m(x) for x in xs]
        plain = [m.out(m.inner.lin(x * 0.5).relu() + 1.0) for x in xs]
    assert same_bits(got, want)
    assert not any(same_bits(g, p) for g, p in zip(got, plain))


@pytest.mark.cuda
@pytest.mark.parametrize("when", ["capture", "replay"])
def test_a_returned_value_of_another_shape_raises(card, when):
    """A forward hook that returns an output of another shape, at the
    capture or at a later replay: the call raises and names the module."""
    m = tiny_module(card)
    bad = {"on": when == "capture"}
    m.inner.register_forward_hook(lambda mod, args, out: out[:1] if bad["on"] else out)
    x = torch.randn(3, 8, device=card)
    if when == "replay":
        run(m, x)
        bad["on"] = True
    with pytest.raises(ValueError, match="inner"):
        run(m, x)


def tiny_llm(kind, dev):
    gen = torch.Generator().manual_seed(0)
    bf16 = torch.bfloat16
    if kind == "llama":
        c = dataclasses.replace(LlamaConfig.tiny_test(vocab_size=64), dtype=bf16)
        m = LlamaWithEmbeddings(c)
    else:
        c = dataclasses.replace(DeepseekV3Config.tiny_test(vocab_size=64), dtype=bf16)
        m = DeepseekV3WithEmbeddings(c)
    init_params(m, gen)
    m = m.to(bf16).to(dev).eval().requires_grad_(False)
    x = torch.randn(4, 7, c.dim, generator=gen).to(dev, bf16)
    return m, x, torch.ones(4, 7, dtype=torch.bool, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["llama", "deepseek"])
def test_the_trip_captures_hooked_routers_and_lm_head(card, kind, monkeypatch):
    """Hooks on ``lm_head`` and every router: their forwards run in Python
    at the prefill and the capture only, the hooks see every trip, and the
    tokens, scores and trips equal the eager loop's."""
    from openpsg_tpu_torch.models.llm import decode

    m, x, mask = tiny_llm(kind, card)
    mods = {"lm_head": m.core.lm_head}
    mods.update({f"router{i}": layer.mlp.gate for i, layer in enumerate(m.core.layers)
                 if isinstance(getattr(layer, "mlp", None), MoE)})
    assert len(mods) == (1 if kind == "llama" else 3)
    ran, fired = {n: 0 for n in mods}, {n: 0 for n in mods}
    for n, mod in mods.items():
        real = mod.forward

        def counted(*a, _n=n, _r=real, **k):
            ran[_n] += 1
            return _r(*a, **k)

        mod.forward = counted
        mod.register_forward_hook(lambda mod, args, out, _n=n: fired.__setitem__(
            _n, fired[_n] + 1))
    T = 6
    got = [greedy_decode(m, x, mask, T, eos_id=-1) for _ in range(2)]
    runs = dict(ran)
    with monkeypatch.context() as mp:
        mp.setattr(decode, "_graphs", lambda model, dev: None)
        want = greedy_decode(m, x, mask, T, eos_id=-1)
    torch.cuda.synchronize()
    for g in got:
        assert g[2] == want[2] == T
        assert torch.equal(g[0], want[0]) and torch.equal(g[1], want[1])
    for n in mods:
        # the prefill twice, the capture's trip once; the replays run no Python
        assert runs[n] == 3, (n, runs)
        assert fired[n] == 3 * (1 + T), (n, fired)
