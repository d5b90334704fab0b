"""The benchmark's arithmetic: quartiles, percentiles, interval merging,
the trace reduction, and the operation and byte counts."""

import statistics

import pytest

from psgbench import stats
from psgbench.flops import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, least_seconds, llm, shared_kv_attn
from psgbench.trace import WINDOW, Trace


def test_quartile_spread_is_statistics_quantiles():
    v = [10.0, 11.0, 9.0, 10.5, 12.0, 10.2]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.quartile_spread(v) == pytest.approx((q3 - q1) / med)


def test_percentile_nearest_rank():
    v = list(range(1, 101))
    assert stats.percentile(v, 90) == 90
    assert stats.percentile(v, 100) == 100
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile([1, 2, float("inf")], 90) == float("inf")


def test_merge_busy_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (6, 7), (10, 12)]
    assert stats.merged(iv) == [[0, 3], [5, 7], [10, 12]]
    assert stats.busy_within(iv, 1, 11) == pytest.approx(2 + 2 + 1)
    assert stats.gaps_within(iv, 1, 11) == [(3, 5), (7, 10)]
    assert stats.gaps_within([], 0, 4) == [(0, 4)]


def test_trace_reduction():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "segment", "ts": 0, "dur": 50},
        {"ph": "X", "cat": "user_annotation", "name": "run_chunk", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 70, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 90},
    ]
    t = Trace(ev, {"segment", "run_chunk"})
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)
    assert t.device_time_s(lambda n: n == "k1") == pytest.approx(20e-6)
    assert t.top_ops()[0] == ["k1", pytest.approx(20e-6)]
    gaps = dict(t.idle_gaps())
    # a gap goes to the innermost range open at its midpoint: 0-10 to "segment",
    # 40-70 (midpoint 55) and 80-100 to "run_chunk"
    assert gaps["segment"] == pytest.approx(10e-6)
    assert gaps["run_chunk"] == pytest.approx(50e-6)


def test_shared_kv_attention_counts_at_the_main_path_shape():
    c = shared_kv_attn.counts(NP=1024, H=12, Lq=33, P=441, hd=64)
    assert c["flops"] == 4 * 1024 * 12 * 33 * 441 * 64
    assert c["flops"] / 1e9 == pytest.approx(45.8, abs=0.05)
    assert shared_kv_attn.bound_s(1024, 12, 33, 441, 64) * 1e3 == pytest.approx(0.0463, abs=1e-4)
    assert shared_kv_attn.is_kernel("skv_hopper_kernel(CUtensorMap, ...)")
    assert shared_kv_attn.is_kernel("void skv_attn_kernel<__nv_bfloat16, 64>(...)")
    assert not shared_kv_attn.is_kernel("nvjet_tst_192x192")


def test_llm_counts_hand_worked():
    c = {"hidden_size": 8, "num_attention_heads": 2, "num_key_value_heads": 1,
         "intermediate_size": 16, "vocab_size": 10, "num_hidden_layers": 1}
    # per layer: q 8x8, k and v 8x4 each, o 8x8, three FFN 8x16 → 64+64+64+384 = 576
    p = llm.prefill(c, rows=1, L=2)
    attn = 2 * 2 * 2 * 4 * (1 + 2)          # 2 heads × hd 4 × keys seen (1 + 2)
    assert p["flops"] == 2 * 2 * 576 + attn + 2 * 8 * 10
    assert p["bytes"] == (576 + 80) * 2 + 2 * 8 * 2 + 2 * 2 * 4 * 2
    t = llm.trip(c, rows=3, keys=5)
    assert t["flops"] == 2 * 3 * 576 + 2 * 2 * 3 * 2 * 4 * 5 + 2 * 3 * 8 * 10
    assert t["bytes"] == (576 + 80) * 2 + 3 * 8 * 2 + 2 * 3 * 5 * 4 * 2
    want = least_seconds(p["flops"], p["bytes"]) + sum(
        least_seconds(**dict(zip(("flops", "nbytes"),
                                 (llm.trip(c, 1, 2 + i + 1)["flops"],
                                  llm.trip(c, 1, 2 + i + 1)["bytes"])))) for i in range(2))
    assert llm.decode_bound_s(c, 1, 2, 2) == pytest.approx(want)
    assert least_seconds(PEAK_BF16_FLOPS, 0) == 1.0
    assert least_seconds(0, PEAK_BYTES_PER_S) == 1.0
