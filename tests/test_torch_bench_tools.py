"""The port's measurement tools (``openpsg_tpu_torch/tools/bench_stages.py``,
``probe_msda_variants.py``, ``bench_train.py``, ``bench_family.py``,
``bench_host.py``) on the CPU at tiny sizes: each probe variant against the
JAX package's ``ms_deform_attn``, each stage closure against the port's own
entry points (bitwise), the timed train step against the train tool's
trainer, the family's lines, the host bench's synthetic device output
against the JAX tool's, the timing helper, and no CPU fallback for a tool
asked for the card.

Tolerances: the probe's float32 variants against JAX within 1e-5 (the same
float32 products summed in another order); everything else exact."""

import dataclasses
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpsg_tpu.ops.deform_attn import ms_deform_attn as jax_msda
from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config
from openpsg_tpu_torch.tools import (
    bench_family,
    bench_host,
    bench_stages,
    bench_train,
    probe_msda_variants as probe,
)
from openpsg_tpu_torch.utils.profiling import device_record, sample_stats, time_samples

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE_SHAPES = ((8, 6), (4, 3), (2, 2))
PROBE_POINTS = (2, 1, 3)


# ------------------------------------------------------------------ probe
@pytest.fixture(scope="module")
def probe_case():
    """Seeded float32 inputs (Lq 11 queries, 2 heads of 4 channels, 3 levels,
    3 points, some outside the map) and the JAX op's output on them."""
    rng = np.random.default_rng(0)
    Lv = sum(h * w for h, w in PROBE_SHAPES)
    value = rng.normal(size=(1, Lv, 2, 4)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (1, 11, 2, 3, 3, 2)).astype(np.float32)
    aw = rng.uniform(0.0, 1.0, (1, 11, 2, 3, 3)).astype(np.float32)
    want = np.asarray(jax_msda(jnp.asarray(value), PROBE_SHAPES, jnp.asarray(loc),
                               jnp.asarray(aw), points_per_level=PROBE_POINTS))
    return tuple(torch.from_numpy(a) for a in (value, loc, aw)), want


@pytest.mark.parametrize("variant", ["v0", "v1", "v2", "v2k", "v4", "fused"])
def test_probe_variant_matches_jax(probe_case, variant):
    (value, loc, aw), want = probe_case
    got = probe.FORMULATIONS[variant](value, PROBE_SHAPES, loc, aw, PROBE_POINTS)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_probe_run_holds_every_variant_to_v0(probe_case, monkeypatch):
    (value, loc, aw), _ = probe_case
    rec = probe.run(value, PROBE_SHAPES, loc, aw, PROBE_POINTS, iters=1, emit=False)
    assert list(rec["variants"]) == list(probe.VARIANTS)
    assert rec["device"] == "cpu" and rec["sparse_row_gather_launches"] == 0
    assert rec["ms_deform_attn_launches"] == 0
    assert rec["geometry"]["points_per_level"] == list(PROBE_POINTS)
    for name, e in rec["variants"].items():
        assert e["median_ms"] > 0 and e["bound_ms"] > 0
        assert name == "raw" or e["max_abs_diff_vs_v0"] <= e["tol"]
    # a variant that reads a wrong row fails the check before it is timed
    bad = lambda *a: probe.v1(*a).roll(1, dims=1)  # noqa: E731
    monkeypatch.setitem(probe.FORMULATIONS, "v1", bad)
    with pytest.raises(AssertionError, match="v1 differs from v0"):
        probe.run(value, PROBE_SHAPES, loc, aw, PROBE_POINTS, variants=("v1",), iters=1,
                  emit=False)


# ------------------------------------------------------------ bench_stages
@pytest.fixture(scope="module")
def tiny_v4():
    cfg = dataclasses.replace(PSGv4Config.tiny_test(), iou_thr=0.1)
    model = PSGv4(cfg, seed=0, device="cpu")
    image = np.random.default_rng(0).integers(0, 255, (64, 64, 3)).astype(np.uint8)
    return model, image


def _equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def test_stage_closures_compute_what_the_entry_points_do(tiny_v4):
    model, image = tiny_v4
    hw = (64, 60)
    fns, keys, _ = bench_stages.stage_fns(model, image, hw)
    img = torch.as_tensor(image)
    seg = model.segment(img)
    feats = fns["swin_backbone"]()
    memory, shapes, mf = model.segmenter.pixel_decoder(feats)
    _equal(fns["pixel_decoder_1L"](), (memory, shapes, mf))
    dec = fns["query_decoder_2L_20q"]()
    _equal(dict(dec, mask_features=mf), seg)
    sel = model.fuse_select(seg, hw)
    assert bool(sel[1].any()), "the tiny model keeps no object: the stages test nothing"
    _equal(fns["fusion_block_top64_of_20"](), sel)
    out, prefix, pmask = model.tail_pre(seg["mask_features"], *sel)
    _equal(fns["qformer_64pairs"](), (out, prefix, pmask))
    K, Lp = prefix.shape[:2]
    _equal(fns[f"llm_prefill_{K}x{Lp}"](), model.tail_decode(prefix, pmask, trip_budget=0))
    _equal(fns[f"llm_prefill+decode_{K}x6"](), model.tail_decode(prefix, pmask))
    assert set(keys.values()) == set(bench_stages.STAGES)


def test_bench_stages_line(tiny_v4, capsys):
    model, image = tiny_v4
    rec = bench_stages.run(model, image, iters=1)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(rec))
    _, _, ctx = bench_stages.stage_fns(model, image, (64, 64), ("backbone",))
    K, Lp = ctx["tail_pre"][1].shape[:2]
    shp, S = "x[64,128]x2", Lp + 6
    assert list(rec["stages_ms"]) == [
        "swin_backbone", "pixel_decoder_1L", "msda_core_1layer_encoder_geom",
        "msda_core_1layer_decoder_geom", "query_decoder_2L_20q", "fusion_block_top64_of_20",
        "qformer_64pairs", f"llm_prefill_{K}x{Lp}", f"llm_prefill+decode_{K}x6",
        f"micro_bf16_decode_[{K},1]{shp}", f"micro_int8deq_decode_[{K},1]{shp}",
        f"micro_int8deq_decode_[{2 * K},1]{shp}", f"micro_kv_attn_decode_[{K},{S}]x2",
        f"micro_kv_attn_decode_[{4 * K},{S}]x2", f"micro_bf16_prefill_[{K},{Lp}]{shp}",
        f"micro_int8deq_prefill_[{K},{Lp}]{shp}", f"micro_int8act_prefill_[{K},{Lp}]{shp}"]
    assert all(ms > 0 for ms in rec["stages_ms"].values())
    assert rec["device"] == "cpu" and rec["decode_trips"] == model.tail_decode(
        *ctx["tail_pre"][1:])[2]
    assert rec["flash_shared_kv_cross_attn_launches_by_variant"] == {"simple": 0, "hopper": 0}
    assert 0 < rec["msda_share_of_segmenter"]["encoder"] and rec["infer_segmenter_ms"] > 0
    assert "vs_baseline" not in rec and "rtt_ms" not in rec


# ------------------------------------------------------------- bench_train
def test_bench_train_step_is_the_train_tools_step():
    """The timed step's loss equals the step of a trainer built as
    ``tools/train.py`` builds one for ``baseline_v4_ov.py``, on the same
    model seed and batch."""
    from openpsg_tpu_torch.core.config import Config
    from openpsg_tpu_torch.train.checkpoint import trainable_groups
    from openpsg_tpu_torch.train.trainer import (
        TrainBatch,
        V4Trainer,
        make_lr_schedule,
        make_optimizer,
    )

    cfg_t = PSGv4Config.tiny_test()
    rec = bench_train.run(PSGv4(cfg_t, seed=0, device="cpu"), iters=1, emit=False)
    assert len(rec["losses"]) == 2 and rec["flash_shared_kv_cross_attn_launches"] == 0
    assert rec["device"] == "cpu" and rec["metric"] == "psg_v4_train_step_s@64px_llm2L_frozenllm"

    cfg = Config.fromfile(os.path.join(REPO, "openpsg_tpu_torch/configs/psg/baseline_v4_ov.py"))
    model = PSGv4(cfg_t, seed=0, device="cpu")
    trainer = V4Trainer(model, trainable=trainable_groups(cfg))
    sched = make_lr_schedule(base_lr=cfg.optimizer.lr,
                             warmup_iters=cfg.lr_config.get("warmup_iters", 500),
                             warmup_ratio=cfg.lr_config.get("warmup_ratio", 1e-3),
                             step_epochs=tuple(cfg.lr_config.get("step", [6, 10])))
    opt = make_optimizer(sched, max_norm=cfg.optimizer_config.grad_clip.get("max_norm", 0.01),
                         weight_decay=cfg.optimizer.get("weight_decay", 0.05))
    state = opt.init(trainer.master)
    batch = TrainBatch.from_numpy(bench_train.make_batch(model), "cpu")
    losses = [float(trainer.train_step(batch, opt, state)["loss"]) for _ in range(2)]
    assert losses == rec["losses"]


def test_bench_train_refuses_a_trained_7b_llm_by_its_size():
    cfg = bench_stages.model_config(1344, llm_int8=False)
    assert 130e9 < bench_train.train_llm_bytes(cfg.llm) < 140e9     # > one card's 80 GB
    cut = dataclasses.replace(cfg.llm, n_layers=4)
    assert bench_train.train_llm_bytes(cut) < 40e9


# ------------------------------------------------------------ bench_family
def test_bench_family_tiny_lines(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_TINY", "1")
    monkeypatch.setenv("BENCH_ITERS", "2")
    monkeypatch.delenv("BENCH_FAMILY", raising=False)
    bench_family.main(["--device", "cpu"])
    out = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()
           if ln.startswith("{")]
    assert [o["metric"] for o in out] == [
        "psg_v1_e2e_infer_img_per_s@tiny64px",
        "psg_v2_e2e_infer_img_per_s@tiny64px",
        "psg_v3_e2e_infer_img_per_s@tiny64px",
    ]
    for o in out:
        assert o["value"] > 0 and o["device"] == "cpu" and "vs_baseline" not in o
        assert o["detail"]["iters"] == 2 and o["detail"]["ms_per_image"] > 0


# -------------------------------------------------------------- bench_host
@pytest.mark.parametrize("size,n_obj,top_k", [(64, 20, 20), (96, 5, 12)])
def test_bench_host_make_dev_matches_jax_tool(size, n_obj, top_k, monkeypatch):
    from openpsg_tpu.data.vocab import OBJECT_CLASSES, RELATION_CLASSES
    from openpsg_tpu.models.detectors.psg_v4 import PSGv4Config as JaxPSGv4Config
    from openpsg_tpu.models.relation.tokenizer import build_prompt_tokenizer

    monkeypatch.syspath_prepend(REPO)
    import tools.bench_host as jax_tool

    stand_in = types.SimpleNamespace(
        cfg=JaxPSGv4Config.tiny_test(), relation_names=list(RELATION_CLASSES),
        tokenizer=build_prompt_tokenizer(list(OBJECT_CLASSES) + list(RELATION_CLASSES)))
    want = jax_tool.make_dev(size, n_obj, top_k, stand_in)
    got = bench_host.make_dev(size, n_obj, top_k, PSGv4(PSGv4Config.tiny_test(), device="cpu"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def test_bench_host_line(capsys):
    rec = bench_host.main(["--device", "cpu", "--size", "64", "--iters", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(rec))
    assert rec["device"] == "cpu" and rec["runs_on"].startswith("host CPU")
    for key in ("postprocess_ms", "paint_indexed_ms", "png_palette_ms", "writer_add_ms"):
        assert rec[key] > 0, key
    assert rec["infer_host_ms_per_image"] == rec["postprocess_ms"] + rec["writer_add_ms"]


# ------------------------------------------------------- no CPU fallback
@pytest.mark.parametrize("tool", [bench_stages, probe, bench_train, bench_family, bench_host],
                         ids=lambda t: t.__name__.rsplit(".", 1)[-1])
def test_tool_asked_for_the_card_raises_without_one(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the missing-card case is not reachable here")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tool.main(["--device", "cuda"])


# ---------------------------------------------------------- timing helper
def test_sample_stats_on_known_samples():
    s = sample_stats([4.0, 1.0, 3.0, 2.0, 5.0])
    assert (s["median_ms"], s["q1_ms"], s["q3_ms"], s["iqr_ms"]) == (3.0, 2.0, 4.0, 2.0)
    s = sample_stats([10.0, 20.0])
    assert (s["median_ms"], s["q1_ms"], s["q3_ms"], s["iqr_ms"]) == (15.0, 12.5, 17.5, 5.0)
    with pytest.raises(ValueError):
        sample_stats([])


def test_time_samples_counts_calls_and_names_the_device():
    calls = []
    s = time_samples(lambda: calls.append(1), 3, "cpu")
    assert len(calls) == 1 + 3 and len(s["samples_ms"]) == 3
    calls.clear()
    s = time_samples(lambda: calls.append(1), 3, "cpu", launches=4)
    assert len(calls) == 1 + 3 * 4 and len(s["samples_ms"]) == 3
    assert device_record("cpu") == "cpu"
