"""``greedy_decode``'s graph path (``models/llm/decode.py`` ``DecodeState``,
``utils/graphs.py``) against the same trips run eagerly on the card, for a
tiny Llama (bf16, and int8 weight-only) and a tiny DeepSeek-V3 (bf16): the
same kernels on the same inputs, so tokens, scores and trips are equal bit
for bit; hooks on ``lm_head`` and on the routers fire once a call and once
a trip with the eager values; host counters read the same; and a profiler
reads the same spans, with the same device time inside them within 5%.  Every test here needs a
CUDA device and skips without one; the file imports nothing of JAX."""

import dataclasses
import json

import pytest
import torch

from openpsg_tpu_torch.models.common import init_params
from openpsg_tpu_torch.models.llm import decode
from openpsg_tpu_torch.models.llm.decode import greedy_decode
from openpsg_tpu_torch.models.llm.deepseek_v3 import (
    DeepseekV3Config,
    DeepseekV3WithEmbeddings,
    MoE,
)
from openpsg_tpu_torch.models.llm.llama import LlamaConfig, LlamaWithEmbeddings, quantize_llama

T = 8          # max_new_tokens
KINDS = ("llama_bf16", "llama_int8", "deepseek_bf16")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph path runs only there")
    return torch.device("cuda")


def build(kind: str, dev, seed: int = 0):
    """A seeded tiny LLM in bf16 on ``dev``, and a prefix for it: 4 rows of
    7, rows 2 and 3 copies of row 0, row 1 padded at the left (so some
    tokens stop a few rows and others all)."""
    gen = torch.Generator().manual_seed(seed)
    bf16 = torch.bfloat16
    if kind.startswith("llama"):
        c = dataclasses.replace(LlamaConfig.tiny_test(vocab_size=64), dtype=bf16)
        m = LlamaWithEmbeddings(c)
        init_params(m, gen)
        if kind == "llama_int8":
            q = LlamaWithEmbeddings(dataclasses.replace(c, quant=True))
            q.load_state_dict(quantize_llama(m.state_dict()))
            m = q
        for name, p in m.named_parameters():     # int8 weights and their scales stay
            if p.is_floating_point() and not name.endswith(".scale"):
                p.data = p.data.to(bf16)
    else:
        c = dataclasses.replace(DeepseekV3Config.tiny_test(vocab_size=64), dtype=bf16)
        m = DeepseekV3WithEmbeddings(c)
        init_params(m, gen)
        for layer in m.core.layers:
            if isinstance(layer.mlp, MoE):
                layer.mlp.gate.e_score_correction_bias.data.normal_(0.0, 0.1, generator=gen)
        m = m.to(bf16)
    m = m.to(dev).eval().requires_grad_(False)
    x = torch.randn(4, 7, c.dim, generator=gen)[[0, 1, 0, 0]].to(dev, bf16)
    mask = torch.ones(4, 7, dtype=torch.bool, device=dev)
    mask[1, :2] = False
    return m, x, mask


def run(m, x, mask, graphs: bool, monkeypatch, **kw):
    """greedy_decode on the graph path, or on the eager loop."""
    with monkeypatch.context() as mp:
        if not graphs:
            mp.setattr(decode, "_graphs", lambda model, dev: None)
        out = greedy_decode(m, x, mask, T, **dict(dict(eos_id=-1, pad_id=0), **kw))
    torch.cuda.synchronize()
    return out


def span_readings(trace: dict, names):
    """Each named range of a Chrome trace of ``torch.profiler`` → (its count,
    the seconds of the device work launched inside it, the launches inside
    it): a host call belongs to a range open on its thread (a CUDA graph's
    launch counts once), device work to the call of its correlation id."""
    xs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    where = lambda e: (e.get("pid"), e.get("tid"))
    corr = lambda e: (e.get("args") or {}).get("correlation")
    calls = [e for e in xs if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    device_us = {}
    for e in xs:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and corr(e) is not None:
            device_us[corr(e)] = device_us.get(corr(e), 0.0) + float(e.get("dur", 0.0))
    out = {}
    for n in names:
        ranges = [(where(e), float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                  for e in xs if e.get("cat") == "user_annotation" and e.get("name") == n]
        inside = [c for c in calls if any(w == where(c) and a <= float(c["ts"]) < b
                                          for w, a, b in ranges)]
        launches = sum(c["name"] in ("cudaMemcpyAsync", "cudaMemsetAsync")
                       or "LaunchKernel" in c["name"] or "GraphLaunch" in c["name"]
                       for c in inside)
        ids = {corr(c) for c in inside if corr(c) is not None}
        out[n] = (len(ranges), sum(device_us.get(i, 0.0) for i in ids) * 1e-6, launches)
    return out


def assert_same(a, b):
    assert a[2] == b[2]
    assert torch.equal(a[0], b[0])
    assert torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_graph_matches_eager_with_exit_budget_and_cap(cuda_device, kind, monkeypatch):
    m, x, mask = build(kind, cuda_device)
    # every token the rows pick is tried as EOS: rows stop at different
    # trips; then 4 copies of one row, whose third token as EOS stops every
    # row at once, so the loop exits early
    free = run(m, x, mask, False, monkeypatch)
    cases = [(x, mask, eos) for eos in sorted(set(free[0].flatten().tolist()))]
    same = torch.ones_like(mask)
    one = run(m, x[[0, 0, 0, 0]], same, False, monkeypatch)
    cases.append((x[[0, 0, 0, 0]], same, int(one[0][0, 2])))
    counters = ("graph_captures", "graph_trips", "eager_trips")
    before = {k: getattr(greedy_decode, k) for k in counters}
    trips = []
    for xs, ms, eos in cases:
        want = run(m, xs, ms, False, monkeypatch, eos_id=eos)
        got = run(m, xs, ms, True, monkeypatch, eos_id=eos)
        assert_same(got, want)
        trips.append(want[2])
    assert trips[-1] < T
    for budget in (1, 3, T + 5):
        want = run(m, x, mask, False, monkeypatch, trip_budget=budget)
        got = run(m, x, mask, True, monkeypatch, trip_budget=budget)
        assert_same(got, want)
        assert got[2] == min(budget, T)
    ran = {k: getattr(greedy_decode, k) - before[k] for k in counters}
    # one capture serves every EOS and budget of the shape (EOS and pad are
    # device values of the state); the same trips each way
    assert ran["graph_captures"] == 1
    assert ran["graph_trips"] == ran["eager_trips"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["heads", "llm"])
@pytest.mark.parametrize("kind", KINDS)
def test_hooks_fire_once_a_trip_with_eager_values(cuda_device, kind, where, monkeypatch):
    """Hooks registered after a first graph call, on ``lm_head`` and every
    router (``heads``) or on the whole LLM (``llm``: its forward then runs
    eagerly between the graphs, and writes the cache it is handed): the
    graphs are captured anew, split at the hooked modules, and the hooks see
    the prefill and every trip, the capture's included, with the eager
    loop's values."""
    m, x, mask = build(kind, cuda_device)
    run(m, x, mask, True, monkeypatch)
    seen = {}

    def keep(name):
        return lambda mod, args, out: seen.setdefault(name, []).append(
            tuple(t.clone() for t in out) if isinstance(out, tuple) else out.clone())

    if where == "llm":
        hooked = {"llm": m}
        m.register_forward_hook(lambda mod, args, out: seen.setdefault("llm", []).append(
            out[0][:, -1].clone()))
    else:
        hooked = {"lm_head": m.core.lm_head}
        hooked.update({f"router{i}": layer.mlp.gate for i, layer in enumerate(m.core.layers)
                       if isinstance(getattr(layer, "mlp", None), MoE)})
        for name, mod in hooked.items():
            mod.register_forward_hook(keep(name))
    captures = greedy_decode.graph_captures
    want = run(m, x, mask, False, monkeypatch)
    eager_seen, seen = seen, {}
    got = run(m, x, mask, True, monkeypatch)
    assert_same(got, want)
    assert greedy_decode.graph_captures == captures + 1
    assert set(seen) == set(hooked)
    for name in hooked:
        assert len(seen[name]) == len(eager_seen[name]) == 1 + T
        for a, b in zip(seen[name], eager_seen[name]):
            for ta, tb in zip(a if isinstance(a, tuple) else (a,),
                              b if isinstance(b, tuple) else (b,)):
                assert torch.equal(ta, tb)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ("llama_bf16", "deepseek_bf16"))
def test_profiler_reads_the_same_spans(cuda_device, kind, monkeypatch, tmp_path):
    """Under the profiler (:func:`span_readings`), the graph path
    opens as many ``psg.trip``, ``psg.mla`` and ``psg.moe`` ranges as the
    eager loop, with the device time of the same work inside each, and
    launches fewer times inside ``psg.trip``."""
    m, x, mask = build(kind, cuda_device)
    names = ("psg.prefill", "psg.trip", "psg.mla", "psg.moe")
    read = {}
    for graphs in (False, True, False, True):
        run(m, x, mask, graphs, monkeypatch)       # warm, captured
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                run(m, x, mask, graphs, monkeypatch)
        trace = tmp_path / "trace.json"
        prof.export_chrome_trace(str(trace))
        read.setdefault(graphs, []).append(span_readings(json.loads(trace.read_text()), names))
    eager, graph = read[False][-1], read[True][-1]
    for n in names:
        assert graph[n][0] == eager[n][0]
        if eager[n][0]:
            best = min(abs(g[n][1] - e[n][1]) / e[n][1]
                       for g in read[True] for e in read[False])
            assert best <= 0.05, (n, read)
    assert eager["psg.trip"][0] == 3 * T
    assert graph["psg.trip"][2] < eager["psg.trip"][2]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ("llama_bf16", "deepseek_bf16"))
def test_graph_reads_weights_handed_over_after_a_capture(cuda_device, kind, monkeypatch):
    """Another seed's weights loaded with ``assign=True`` (new tensors, as the
    benchmark hands weights over) after a capture: the graph path captures
    anew and decodes with them, as the eager loop does."""
    m, x, mask = build(kind, cuda_device)
    before = run(m, x, mask, True, monkeypatch)
    other, _, _ = build(kind, cuda_device, seed=1)
    m.load_state_dict(other.state_dict(), assign=True)
    captures = greedy_decode.graph_captures
    want = run(m, x, mask, False, monkeypatch)
    got = run(m, x, mask, True, monkeypatch)
    assert greedy_decode.graph_captures == captures + 1
    assert_same(got, want)
    assert not torch.equal(got[1], before[1])


@pytest.mark.cuda
def test_an_embed_replaced_on_the_instance_takes_the_eager_loop(cuda_device, monkeypatch):
    """A wrapper put over ``embed`` on the instance (teacher forcing feeds
    its own tokens through one) runs on every trip: such a model decodes in
    the eager loop, and the wrapper sees each trip."""
    m, x, mask = build("llama_bf16", cuda_device)
    fed = []
    real = m.embed
    m.embed = lambda ids: fed.append(ids.shape) or real(torch.zeros_like(ids))
    eager, graphed = greedy_decode.eager_trips, greedy_decode.graph_trips
    got = run(m, x, mask, True, monkeypatch)
    assert greedy_decode.eager_trips - eager == got[2] == T
    assert greedy_decode.graph_trips == graphed
    assert len(fed) == T
    del m.embed
    assert_same(run(m, x, mask, False, monkeypatch, eos_id=-1),
                run(m, x, mask, True, monkeypatch))


@pytest.mark.cuda
@pytest.mark.parametrize("first", ["inference_mode", "no_grad"])
def test_states_serve_calls_in_and_out_of_inference_mode(cuda_device, first, monkeypatch):
    """A decode shape's state made under ``torch.inference_mode`` (as the
    server's device loop runs) serves a later call outside it, and the other
    way round; each call decodes as the eager loop does."""
    m, x, mask = build("llama_bf16", cuda_device)
    want = run(m, x, mask, False, monkeypatch)
    modes = [torch.inference_mode, torch.no_grad]
    if first == "no_grad":
        modes.reverse()
    for mode in modes * 2:
        with mode():
            assert_same(run(m, x, mask, True, monkeypatch), want)


@pytest.mark.cuda
def test_moe_counters_count_every_replayed_trip(cuda_device, monkeypatch):
    """``MoE.grouped_launches`` and ``MoE.routed_rows`` read the same for a
    call whose trips replay graphs as for the eager call."""
    m, x, mask = build("deepseek_bf16", cuda_device)
    run(m, x, mask, True, monkeypatch)          # the capture
    read = {}
    for graphs in (False, True):
        before = (MoE.grouped_launches, MoE.routed_rows)
        out = run(m, x, mask, graphs, monkeypatch)
        read[graphs] = (MoE.grouped_launches - before[0], MoE.routed_rows - before[1])
    assert out[2] == T
    assert read[True] == read[False]
    assert read[False][1] > 0
