#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``openpsg_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, each fatal on failure:
  1. device line (``nvidia-smi`` name and power limit, torch and CUDA);
  2. build both CUDA kernels from ``csrc/`` (one nvcc each, started
     together from two threads) and log their registers and spills, and
     the shared-KV kernel's hopper variant's registers, shared memory and
     local memory as the CUDA runtime reports them;
  3. each kernel against its plain PyTorch version: the shared-KV
     attention at the main-path shape (float32: the simple variant; bf16:
     the hopper variant), with fully masked rows and 64-patch chunks, and
     at the hopper variant's edges at the main width (NP = 1 and 1000,
     Lq = 1, P at the cap and one past it), each case holding the variant's
     launch count; the row gather bitwise on seeded cases (float32 and
     bf16, ragged sizes, out-of-range indices, C = 128 and 16);
  4. the per-image path at full ``baseline_v4_ov`` width (bf16 LLM):
     ``PSGv4.infer`` on seeded 1344² images with seeded random weights,
     launch counts (per variant) read around exactly that run; plus the
     tiny config on the card against the CPU path, with its float32 LLM
     through ``infer`` and with an int8 bf16 LLM through
     ``infer_microbatch`` (3 images, int8-activation prefill);
  5. the kernels' times, the plain versions', the library's and the bound
     on the main path's own inputs (image 0, CUDA events around 10
     back-to-back calls, median per call with its interquartile range): the shared-KV kernel on the first Q-Former
     layer's inputs (its hopper variant, the simple variant called
     explicitly, the plain version and SDPA in two formulations, timed in
     turns), the gather on level 0 of the first pixel-decoder
     encoder layer (quad table and row index rebuilt by
     ``ops/deform_attn.level_samples``); then the full-width head with the
     plain attention forced (test-only switch) against the kernel path on
     one image with 30 seeded objects, in bf16 and on a float32 copy;
  6. the deployment path at full ``baseline_v4_ov_w8a8`` width (int8
     Llama-2-7B, int8-activation prefill, encoder points 2,2,2,4):
     ``QDense`` on the card against its CPU path at the model's widths;
     ``PSGv4.infer_microbatch`` on 4 seeded 1344² images (a warm-up, then
     one timed call, launch counts read around it), then the same images
     through ``PSGv4.infer`` on the same model, its decode teacher-forced
     on the micro-batch's tokens: pan maps, objects, top-20 pairs and
     top-100 triplets identical, logits within TOL_LOGIT_REL, and a token
     chosen differently only where its top-1 margin is within twice the
     largest logit change at the steps that agree;
  7. the tool path: a PNG fixture of 12 images at COCO sizes (4 landscape,
     4 portrait, 4 square) with GT PNGs and a PSG json, written by the
     port's own codec; ``openpsg_tpu_torch.tools.infer.main`` on the card
     with the port's ``baseline_v4_ov.py`` plus the int8 deployment
     settings (3 buckets of 4 images; the tool selects micro-batch 4),
     launch counts read around exactly that run; the submission checked
     (12 records in test order, each PNG at its image's size) and graded;
     section times per image, images per second, the prefetch overlap; the
     square chunk's model call timed alone and beside a thread doing the
     prefetch's work, in turns; then 4 of the images again with
     ``--profile`` and the share of the model sections in which the card
     ran a kernel.

The last three lines are the JSON object ``{"kernels": [...]}``, the
``nvidia-smi`` line and ``{"ok": true, "device": {...}}``.  Imports nothing
of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# baseline_v4_ov's input bucket: the 1333 test scale padded to a multiple of 32
BUCKET = (1344, 1344)

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# tolerances, with their reasons
TOL_F32 = 1e-5   # same f32 inputs; only the summation order differs
TOL_BF16 = 2e-2  # kernel rounds p and the output to bf16; the plain
                 # reference runs in f32 from the same bf16 inputs
TOL_HEAD_F32 = 1e-4  # the whole f32 head (2 Q-Former layers, LayerNorms,
                     # heads): kernel and plain differ in summation order only
TOL_LOGIT_REL = 0.1  # largest LLM logit change between the micro-batch (80
                     # decode rows, 4x the prefill rows) and per-image runs
                     # (or the card and the CPU), relative to the largest
                     # logit: both run bf16 activations through every
                     # layer, and the GEMMs' row count (or device) changes
                     # the summation order, so bf16 roundings flip and
                     # propagate; a wrong weight, scale or row would move
                     # logits by their own size
TOL_QDENSE_FLIPS = 0.01  # share of bf16 QDense outputs (weight-only) one
                         # bf16 step apart between card and CPU: the same
                         # exact products summed in float32 in another order
                         # flip a rounding only within ~1e-6 of a boundary;
                         # a product rounded to bf16 before the scale moves
                         # more than 10% of them


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, warmup=5, reps=50, batch=10, raw=False):
    """``reps`` CUDA-event timings of ``batch`` back-to-back calls of
    ``fn()``, each divided by ``batch``, after warm-up → (median, 25th
    percentile, 75th percentile) in ms per call, or the list of times with
    ``raw``.  Back to back, the host enqueues the next call while the card
    runs this one, so a call's host work is hidden where it is shorter than
    the card's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    if raw:
        return times
    q1, _, q3 = statistics.quantiles(times, n=4)
    return statistics.median(times), q1, q3


def skv_bound_ms(q, k, mask) -> tuple:
    """Least time for shared-KV attention on these inputs: bytes (q, k, v,
    mask read once, out written once) over the memory rate vs the two
    matrix products over the unmasked (pair, patch) entries this mask
    needs, at the peak rate of q's type.  → (ms, 'bytes' | 'operations')."""
    import torch

    NP, H, Lq, hd = q.shape
    es = q.element_size()
    nbytes = 2 * q.numel() * es + 2 * k.numel() * es + mask.numel()
    ops = 4.0 * H * Lq * hd * float(mask.sum())
    peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def phase_kernel(torch, results):
    """Phase 3: the shared-KV attention kernel against its plain version,
    each case also holding the launch count of the variant
    ``kernel_variant`` picks for it."""
    from openpsg_tpu_torch.ops import flash_cross_attn as fca

    gen = torch.Generator(device="cuda").manual_seed(0)

    def data(NP, H, Lq, hd, P, dtype, p_mask=0.5):
        q = torch.randn(NP, H, Lq, hd, generator=gen, device="cuda").to(dtype)
        k = torch.randn(H, P, hd, generator=gen, device="cuda").to(dtype)
        v = torch.randn(H, P, hd, generator=gen, device="cuda").to(dtype)
        mask = torch.rand(NP, P, generator=gen, device="cuda") < p_mask
        return q, k, v, mask

    def check(name, q, k, v, mask, tol):
        variant = fca.kernel_variant(q.dtype, q.shape[-1], k.shape[1])
        before = dict(fca.flash_shared_kv_cross_attn.launches_by_variant)
        got = fca.flash_shared_kv_cross_attn(q, k, v, mask)
        torch.cuda.synchronize()
        after = fca.flash_shared_kv_cross_attn.launches_by_variant
        added = {n: after[n] - before[n] for n in after}
        g = fca.guard_empty_mask(mask)
        want = fca.shared_kv_cross_attn_plain(q.float(), k.float(), v.float(), g)
        err = float((got.float() - want).abs().max())
        ok = (err <= tol and bool(torch.isfinite(got).all())
              and added == {n: int(n == variant) for n in after})
        log(f"[kernel] {name} ({variant}): max_abs_err={err:.3e} tol={tol:g} "
            f"launches {added} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees with plain on {name}")
        return err

    main = dict(NP=1024, H=12, Lq=33, hd=64, P=441)
    errs = []
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        tag = str(dtype).split(".")[-1]
        q, k, v, mask = data(dtype=dtype, **main)
        e = [check(f"{tag} main shape random mask", q, k, v, mask, tol)]
        m2 = mask.clone()
        m2[::7] = False                      # fully masked rows (guarded)
        e.append(check(f"{tag} fully masked rows", q, k, v, m2, tol))
        m3 = mask.clone()
        m3[:, 64:128] = False                # one whole 64-patch chunk
        m3[1::2, :64] = False                # ... and the first chunk on odd pairs
        e.append(check(f"{tag} fully masked 64-patch chunks", q, k, v, m3, tol))
        q4, k4, v4, mk4 = data(NP=1000, H=12, Lq=33, hd=64, P=441, dtype=dtype)
        e.append(check(f"{tag} NP=1000 (ragged row tile)", q4, k4, v4, mk4, tol))
        for hd, P in ((16, 40), (64, 130)):
            e.append(check(f"{tag} small hd={hd} P={P}", *data(6, 2, 5, hd, P, dtype), tol))
        if dtype == torch.bfloat16:
            errs += e
    cap = fca.HOPPER_MAX_P
    edges = (("NP=1 (one pair: 63 empty tile rows)", dict(main, NP=1)),
             ("Lq=1", dict(main, Lq=1)),
             (f"P={cap} (the cap)", dict(main, NP=256, P=cap)),
             (f"P={cap + 1} (past the cap)", dict(main, NP=256, P=cap + 1)))
    for name, shape in edges:
        errs.append(check(f"bfloat16 {name}", *data(dtype=torch.bfloat16, **shape), TOL_BF16))
    results["max_abs_err"] = max(errs)


def time_turns(runs, reps=25) -> dict:
    """Each of ``runs`` ({key: fn}) timed ``reps`` times in the given order,
    then ``reps`` times in the reverse order (so drift hits all alike) →
    {key: (median, 25th percentile, 75th percentile)} in ms."""
    times = {key: [] for key in runs}
    for order in (list(runs), list(runs)[::-1]):
        for key in order:
            times[key] += time_ms(runs[key], reps=reps, raw=True)
    out = {}
    for key, t in times.items():
        q1, _, q3 = statistics.quantiles(t, n=4)
        out[key] = (statistics.median(t), q1, q3)
    return out


def time_kernel(torch, fca, q, k, v, mask, results):
    """Times on these inputs, in turns (:func:`time_turns`): the kernel (the
    variant the wrapper picks), the simple variant called explicitly, the
    plain version, and SDPA in two formulations — per pair on K/V expanded
    with stride 0, and in one call on q as [1, H, NP*Lq, hd] rows against
    [1, H, P, hd] with the pair mask expanded to rows (layouts prepared
    outside the timed call).  ``library_ms`` is the faster SDPA; the other
    is logged beside it.  Plus the bound."""
    import torch.nn.functional as F

    g = fca.guard_empty_mask(mask)
    NP, H, Lq, hd = q.shape
    P = k.shape[1]
    ke, ve = k[None].expand(NP, -1, -1, -1), v[None].expand(NP, -1, -1, -1)
    am = g[:, None, None, :]
    q1 = q.transpose(0, 1).reshape(1, H, NP * Lq, hd)
    m1 = g[:, None, :].expand(NP, Lq, P).reshape(1, 1, NP * Lq, P)
    one_call = F.scaled_dot_product_attention(q1, k[None], v[None], attn_mask=m1)
    want = fca.shared_kv_cross_attn_plain(q, k, v, g)
    sdpa_err = float((one_call.view(H, NP, Lq, hd).transpose(0, 1).float()
                      - want.float()).abs().max())
    del one_call, want
    results["variant"] = fca.kernel_variant(q.dtype, hd, P)
    runs = {
        "ms": lambda: fca.flash_shared_kv_cross_attn(q, k, v, g),
        "simple_ms": lambda: fca.flash_shared_kv_cross_attn(q, k, v, g, variant="simple"),
        "plain_ms": lambda: fca.shared_kv_cross_attn_plain(q, k, v, g),
        "sdpa_per_pair_ms": lambda: F.scaled_dot_product_attention(q, ke, ve, attn_mask=am),
        "sdpa_one_call_ms": lambda: F.scaled_dot_product_attention(
            q1, k[None], v[None], attn_mask=m1),
    }
    text = []
    for key, (med, lo, hi) in time_turns(runs).items():
        results[key] = med
        text.append(f"{key} {med:.4f} (IQR {lo:.4f}-{hi:.4f})")
    sdpa = {"SDPA per pair": results.pop("sdpa_per_pair_ms"),
            "SDPA one call": results.pop("sdpa_one_call_ms")}
    best = min(sdpa, key=sdpa.get)
    results["library"], results["library_ms"] = best, sdpa[best]
    (other,) = set(sdpa) - {best}
    results["library_other"], results["library_other_ms"] = other, sdpa[other]
    results["bound_ms"], results["bound_by"] = skv_bound_ms(q, k, g)
    log(f"[kernel] inputs {tuple(q.shape)} {q.dtype} mask density "
        f"{float(g.float().mean()):.3f}: " + ", ".join(text)
        + f"; ms = the {results['variant']} variant; library = {best} (SDPA one call vs "
        f"plain max_abs_err {sdpa_err:.3e}); bound_ms {results['bound_ms']:.4f} "
        f"({results['bound_by']}); {results['bound_ms'] / results['ms']:.1%} of the bound")


def phase_tiny_vs_cpu(torch):
    """The tiny config on the card (kernel path) against the CPU path: with
    its float32 LLM through ``infer`` (identical results); then with an
    int8 bf16 LLM (``quant``, ``act_int8``) through ``infer_microbatch`` on
    3 images, whose prefill crosses the 256-row int8-activation rule, the
    CPU run teacher-forced on the card's tokens (:func:`compare_runs`)."""
    import dataclasses

    import numpy as np

    from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config
    from openpsg_tpu_torch.models.llm.llama import QDense

    def pair(cfg):
        cpu = PSGv4(cfg, seed=3, device="cpu")
        gpu = PSGv4(cfg, seed=3, device="cuda")
        for part in ("segmenter", "head", "llm"):
            getattr(gpu, part).load_state_dict(getattr(cpu, part).state_dict())
        gpu.class_embeds = cpu.class_embeds.cuda()
        return cpu, gpu

    cfg = dataclasses.replace(PSGv4Config.tiny_test(), iou_thr=0.1)
    cpu, gpu = pair(cfg)
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    a, b = cpu.infer(img, (64, 60)), gpu.infer(img, (64, 60))
    same = (np.array_equal(a["pan_results"], b["pan_results"])
            and a["rel_results"] == b["rel_results"]
            and np.allclose(a["rel_scores"], b["rel_scores"], atol=1e-4))
    log(f"[tiny] card vs CPU: objects {b['rel_results']['object_id_list']} "
        f"relations {len(b['rel_results']['relation'])} identical={same}")
    if not same:
        raise AssertionError("tiny config on the card disagrees with the CPU path")

    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, quant=True, act_int8=True, dtype=torch.bfloat16))
    cpu, gpu = pair(cfg)
    imgs = np.stack([img] + [rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
                             for _ in range(2)])
    hws = [(64, 60), (58, 61), (60, 64)]
    c = gpu.cfg
    rows = len(hws) * c.head.top_pairs * (c.head.qformer.num_relation_queries
                                          + gpu.llm_parts["max_len"])
    assert rows >= QDense.ACT_INT8_MIN_ROWS, rows
    with recorded(gpu) as a:
        gpu.infer_microbatch(imgs, hws)
    with recorded(cpu, forced=fed_tokens(torch, a)) as b:
        cpu.infer_microbatch(imgs, hws)
    log(f"[tiny] int8 bf16 LLM, infer_microbatch of {len(hws)} images ({rows} prefill "
        "rows, int8 activations): card vs CPU")
    compare_runs(torch, "tiny", per_image(torch, a), per_image(torch, b))


def check_variants(by_variant, n_images):
    """The main path launches the shared-KV kernel's hopper variant twice
    per image (two Q-Former layers) and its simple variant never."""
    want = {"simple": 0, "hopper": 2 * n_images}
    if by_variant != want:
        raise AssertionError(f"expected shared-KV launches {want}, saw {by_variant}")


def check_result(res, hw):
    import numpy as np

    pan = res["pan_results"]
    assert pan.shape == hw and np.issubdtype(pan.dtype, np.integer), pan.shape
    oids = res["rel_results"]["object_id_list"]
    assert oids == sorted(set(oids)), oids
    assert all(np.isfinite(res["rel_scores"])), "non-finite relation score"
    n = len(oids)
    for s, o, r in res["rel_results"]["relation"]:
        assert 0 <= s < n and 0 <= o < n and s != o and 0 <= r < 56, (s, o, r)
    present = set(np.unique(pan).tolist()) - {133}
    assert present <= set(oids) | {133}, "pan ids outside the object list"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 2
    if not os.path.exists(os.path.join(HERE, "openpsg_tpu_torch", "__init__.py")):
        print("chip_smoke: openpsg_tpu_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device line
    smi = smi_line()
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} {torch.cuda.get_device_name(0)}")

    # ---- 2. build
    from concurrent.futures import ThreadPoolExecutor

    from openpsg_tpu_torch.ops import _build, flash_cross_attn as fca, msda_gather as mg

    kernels = ("flash_shared_kv_cross_attn", "sparse_row_gather")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:   # one nvcc per source, all at once
        list(pool.map(_build.library, kernels))
    log(f"[build] {', '.join(kernels)} in {time.perf_counter() - t0:.1f} s (in parallel)")
    for name in kernels:
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if any(w in line.lower() for w in ("registers", "spill", "error", "wgmma")):
                log(f"[build] {name}: {line.strip()}")
    attrs = fca.hopper_kernel_attrs()
    log(f"[build] flash_shared_kv_cross_attn hopper variant as built: {attrs['registers']} "
        f"registers, {attrs['smem_bytes']} bytes of shared memory per CTA, "
        f"{attrs['local_bytes']} bytes of local memory per thread")

    # ---- 3. kernels against their plain versions
    skv = {"name": "flash_shared_kv_cross_attn", "route": "cuda",
           "source": "openpsg_tpu_torch/csrc/flash_shared_kv_cross_attn.cu",
           "replaces": "openpsg_tpu/ops/pallas/flash_cross_attn.py:80",
           "hopper_registers": attrs["registers"], "hopper_smem_bytes": attrs["smem_bytes"],
           "hopper_local_bytes": attrs["local_bytes"]}
    gat = {"name": "sparse_row_gather", "route": "cuda",
           "source": "openpsg_tpu_torch/csrc/sparse_row_gather.cu",
           "replaces": "openpsg_tpu/ops/pallas/msda_gather.py:70",
           "on_main_path": False}
    phase_kernel(torch, skv)
    phase_gather(torch, gat)

    # ---- 4. main path at full width
    import numpy as np

    from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config

    phase_tiny_vs_cpu(torch)
    t0 = time.perf_counter()
    model = PSGv4(PSGv4Config.baseline_v4_ov(), seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[main] built baseline_v4_ov with seeded random weights in "
        f"{time.perf_counter() - t0:.1f} s; weights "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    H, W = BUCKET
    rng = np.random.default_rng(0)
    hws = [(H, W), (1200, 1344), (1344, 1000)]  # valid (h, w) inside the bucket
    images = [rng.integers(0, 256, (H, W, 3)).astype(np.uint8) for _ in hws]
    model.infer(images[0], hws[0])     # warm-up (cuDNN / cuBLAS plans), not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fca.reset_launches()
    mg.sparse_row_gather.launches = 0
    results = []
    for i, (img, hw) in enumerate(zip(images, hws)):
        st = {}
        t0 = time.perf_counter()
        res = model.infer(img, hw, stage_times=st)
        wall = (time.perf_counter() - t0) * 1e3
        results.append(res)
        log(f"[main] image {i} hw={hw}: total {wall:.1f} ms; "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in st.items())
            + f"; objects {len(res['rel_results']['object_id_list'])}, relations "
            f"{len(res['rel_results']['relation'])}, decode_trips {res['decode_steps']}")
    launches = fca.flash_shared_kv_cross_attn.launches
    by_variant = dict(fca.flash_shared_kv_cross_attn.launches_by_variant)
    skv["launches_by_path"] = {"infer": launches}
    skv["launches_by_variant"] = {"infer": by_variant}
    gat["launches_by_path"] = {"infer": mg.sparse_row_gather.launches}
    log(f"[main] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"flash_shared_kv_cross_attn launches {launches} for {len(images)} images "
        f"({by_variant}); sparse_row_gather launches {mg.sparse_row_gather.launches}")
    check_variants(by_variant, len(images))
    for res in results:
        check_result(res, (H, W))

    # ---- 5. kernel times on the main path's own inputs; the head with the
    # plain attention forced, against the kernel
    img = torch.as_tensor(images[0]).cuda()
    seg, msda = first_msda_call(lambda: model.segment(img))
    own = model.fuse_select(seg, hws[0])
    _, calls = kernel_calls(lambda: model.tail_pre(seg["mask_features"], *own))
    log("[kernel] timing on image 0's first Q-Former layer, as phase 4 ran it")
    time_kernel(torch, fca, *calls[0], skv)
    log("[gather] timing on level 0 of image 0's first pixel-decoder encoder layer")
    time_gather(torch, mg, msda, gat)
    phase_head_parity(torch, model, seg["mask_features"], synthetic_objects(model, seg, own))
    del model, seg, own, calls, msda
    torch.cuda.empty_cache()

    # ---- 6. the deployment path
    phase_deployment(torch, skv, gat)
    torch.cuda.empty_cache()

    # ---- 7. the tool path
    phase_tool(torch, skv, gat)

    for k in (skv, gat):
        k["launches"] = sum(k["launches_by_path"].values())
        for key in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms"):
            assert key in k, key
    for key in ("variant", "simple_ms", "library_other_ms", "hopper_registers"):
        assert key in skv, key
    log(json.dumps({"kernels": [skv, gat]}))
    log(smi)
    return 0


def phase_gather(torch, results):
    """Phase 3: the row-gather kernel against its plain version, bitwise, on
    seeded cases: float32 and bf16 rows; S and HW off any tile size;
    negative and too-large indices (zero rows); C = 128 (the main path's
    4 × head_dim 32) and C = 16 (the tiny segmenter's)."""
    from openpsg_tpu_torch.ops import msda_gather as mg

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = (  # name, nH, HW, C, S, lowest index, highest index + 1
        ("C=128 in range", 8, 4096, 128, 8192, 0, 4096),
        ("C=128 ragged, out-of-range indices", 8, 1000, 128, 1537, -300, 1400),
        ("C=16 ragged, out-of-range indices", 3, 300, 16, 513, -600, 1200),
    )
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, nH, HW, C, S, lo, hi in cases:
            quad = torch.randn(nH, HW, C, generator=gen, device="cuda").to(dtype)
            idx = torch.randint(lo, hi, (nH, S), generator=gen, device="cuda",
                                dtype=torch.int32)
            got = mg.sparse_row_gather(quad, idx)
            torch.cuda.synchronize()
            want = mg.sparse_row_gather_plain(quad, idx)
            e = float((got - want).abs().max())
            outside = float(((idx < 0) | (idx >= HW)).float().mean())
            same = torch.equal(got, want) and got.dtype == torch.float32
            log(f"[gather] {str(dtype).split('.')[-1]} {name} (nH={nH} HW={HW} C={C} "
                f"S={S}, {outside:.2f} out of range): bitwise {'ok' if same else 'FAIL'}, "
                f"max_abs_err={e:.3e}")
            if not same:
                raise AssertionError(f"gather kernel differs from plain on {name}")
            err = max(err, e)
    results["max_abs_err"] = err


def first_msda_call(fn):
    """Run ``fn()`` with the segmenter's ``ms_deform_attn`` recorded → (its
    result, the arguments of the first call: the first pixel-decoder
    encoder layer's value, spatial shapes, locations and weights)."""
    import openpsg_tpu_torch.models.segmenter.deform_layers as dl

    real, calls = dl.ms_deform_attn, []

    def record(*args, **kw):
        if not calls:
            calls.append(args[:4])
        return real(*args, **kw)

    dl.ms_deform_attn = record
    try:
        return fn(), calls[0]
    finally:
        dl.ms_deform_attn = real


def time_gather(torch, mg, msda, results):
    """Kernel, plain and library (``torch.gather``) times and the bound of
    the row gather on level 0 of the recorded layer: the quad table and row
    index that ``ms_deform_attn`` gathers from, rebuilt by
    ``level_samples``.  The kernel must match the plain version bitwise."""
    from openpsg_tpu_torch.ops.deform_attn import level_samples

    value, shapes, loc, aw = msda
    quad, idx, _ = level_samples(value, shapes, loc, aw, 0, loc.shape[4])
    quad, idx = quad[0].contiguous(), idx[0].to(torch.int32).contiguous()
    nH, HW, C = quad.shape
    got = mg.sparse_row_gather(quad, idx)
    torch.cuda.synchronize()
    want = mg.sparse_row_gather_plain(quad, idx)
    if not torch.equal(got, want):
        raise AssertionError("gather kernel differs from plain on the main path's level 0")
    results["max_abs_err"] = max(results["max_abs_err"], float((got - want).abs().max()))
    del got, want
    idx64 = idx.long()[..., None].expand(-1, -1, C)
    runs = {
        "ms": lambda: mg.sparse_row_gather(quad, idx),
        "plain_ms": lambda: mg.sparse_row_gather_plain(quad, idx),
        "library_ms": lambda: torch.gather(quad, 1, idx64),
    }
    text = []
    for key, fn in runs.items():
        results[key], q1, q3 = time_ms(fn)
        text.append(f"{key} {results[key]:.4f} (IQR {q1:.4f}-{q3:.4f})")
    # bytes: each distinct quad row the indices reach, read once; the
    # indices; the float32 output written once.  No arithmetic.
    inside = (idx >= 0) & (idx < HW)
    rows = sum(int(torch.unique(idx[h][inside[h]]).numel()) for h in range(nH))
    nbytes = (rows * C * quad.element_size() + idx.numel() * idx.element_size()
              + idx.numel() * C * 4)
    results["bound_ms"], results["bound_by"] = nbytes / PEAK_BYTES * 1e3, "bytes"
    log(f"[gather] inputs quad {tuple(quad.shape)} {quad.dtype}, idx {tuple(idx.shape)} "
        f"({rows} distinct rows of {nH * HW}, {float(inside.float().mean()):.4f} in range); "
        + ", ".join(text) + f"; library = torch.gather (bf16 out); bound_ms "
        f"{results['bound_ms']:.4f} ({nbytes / 1e6:.1f} MB, bytes); bitwise equal to plain")


@contextlib.contextmanager
def recorded(model, forced=None):
    """Record, while the block runs, the host dicts ``postprocess`` receives
    and the LLM's last-position logits of every forward (prefill, then one
    per decode trip).  With ``forced`` [B, F] (the tokens another run's
    decode steps fed, :func:`fed_tokens`), decode step t feeds
    ``forced[:, t]`` instead of its own choice (teacher forcing), so both
    runs' logits at step t follow the same history."""
    rec = {"dev": [], "logits": []}
    real, real_embed = model.postprocess, model.llm.embed

    def embed(ids):
        t = len(rec["logits"]) - 1         # the decode step: forwards so far, less prefill
        if forced is not None and ids.shape[1] == 1 and 0 <= t < forced.shape[1]:
            ids = forced[:, t:t + 1].to(ids.device)
        return real_embed(ids)

    model.postprocess = lambda dev: rec["dev"].append(dev) or real(dev)
    model.llm.embed = embed
    hook = model.llm.register_forward_hook(
        lambda mod, args, out: rec["logits"].append(out[0][:, -1].float()))
    try:
        yield rec
    finally:
        hook.remove()
        del model.postprocess, model.llm.embed


def fed_tokens(torch, rec):
    """The tokens a recorded run's decode steps fed: the argmax of each
    forward's logits → [B, forwards]."""
    return torch.stack([lg.argmax(dim=-1) for lg in rec["logits"]], dim=1)


def per_image(torch, rec):
    """A recorded run → [(host dict, logits [forwards, K, V])], one per image."""
    K = rec["dev"][0]["gen_tokens"].shape[0]
    lg = torch.stack(rec["logits"])
    return [(d, lg[:, i * K:(i + 1) * K]) for i, d in enumerate(rec["dev"])]


def phase_qdense(torch, model):
    """``QDense`` on the card against its CPU path at Llama-2-7B widths: the
    deployment model's own int8 weights (layer 0's wq, w_gate, w_down, and
    lm_head), seeded bf16 inputs of 20 and 80 rows (a decode step of one
    image and of the micro-batch: weight-only) and 320 rows (over the
    256-row rule: int8 activations).  The int8-activation path is integer
    products and elementwise float32 on both sides: bitwise equal.  The
    weight-only path sums the same exact products in float32 in another
    order, so a bf16 output rounds the other way only where its float32
    value lies within that order's error of a rounding boundary: every
    output within one bf16 step plus the worst-case float32 error of two
    orders of the CPU's, at most TOL_QDENSE_FLIPS of them different.
    Under 256 rows act_int8 is bitwise equal to
    act_int8=False on the card (decode steps do not change)."""
    import copy

    from openpsg_tpu_torch.models.llm.llama import QDense

    layer, core = model.llm.core.layers[0], model.llm.core
    mods = {"wq": layer.wq, "w_gate": layer.w_gate, "w_down": layer.w_down,
            "lm_head": core.lm_head}
    gen = torch.Generator(device="cuda").manual_seed(4)
    for name, mod in mods.items():
        assert isinstance(mod, QDense) and mod.act_int8, name
        on_cpu = copy.deepcopy(mod).cpu()
        weight_only = copy.copy(mod)               # shares the weights
        weight_only.act_int8 = False
        N, K = mod.weight_q.shape
        # lm_head sees B x 1 rows (last logit only): never the int8 path
        for rows in (20, 80) if name == "lm_head" else (20, 80, 320):
            x = torch.randn(rows, K, generator=gen, device="cuda").to(torch.bfloat16)
            with torch.no_grad():
                got, want = mod(x), on_cpu(x.cpu()).cuda()
                diff = (got.float() - want.float()).abs()
                if rows >= QDense.ACT_INT8_MIN_ROWS:
                    ok, text = torch.equal(got, want), "int8 activations, bitwise"
                else:
                    # one bf16 rounding step, plus the worst-case float32
                    # error of two summation orders, 2·K·2^-24·Σ|x·w|·scale
                    big = torch.maximum(got.float().abs(), want.float().abs())
                    step = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
                    order = (2 * K * 2.0 ** -24
                             * (x.float().abs() @ mod.weight_q.float().abs().t()) * mod.scale)
                    beyond = int((diff > step + order).sum())
                    flips = float((diff > 0).float().mean())
                    same = torch.equal(got, weight_only(x))
                    ok = not beyond and flips <= TOL_QDENSE_FLIPS and same
                    text = (f"weight-only, {flips:.4%} of outputs differ (tol "
                            f"{TOL_QDENSE_FLIPS:.0%}), {int((diff > step).sum())} by more than "
                            f"one bf16 step, {beyond} beyond step + float32 order bound; "
                            f"act_int8 == weight-only on the card: {same}")
            log(f"[qdense] {name} [{N}, {K}] x {rows} rows: {text}, max diff "
                f"{float(diff.max()):.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"QDense {name} on the card disagrees with its CPU path")


def phase_deployment(torch, skv, gat):
    """Phase 6: ``QDense`` on the card against the CPU; ``infer_microbatch``
    at full ``baseline_v4_ov_w8a8`` width on 4 seeded images (warm-up, then
    one timed call), then ``infer`` on each image with the same int8 model,
    teacher-forced on the micro-batch's tokens, and the two compared."""
    import numpy as np

    from openpsg_tpu_torch.models.detectors.psg_v4 import AUTO_MB_SIZE, PSGv4, PSGv4Config
    from openpsg_tpu_torch.ops import flash_cross_attn as fca, msda_gather as mg

    t0 = time.perf_counter()
    model = PSGv4(PSGv4Config.baseline_v4_ov_w8a8(), seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[deploy] built baseline_v4_ov_w8a8 (seeded bf16 LLM quantized by quantize_llama) "
        f"in {time.perf_counter() - t0:.1f} s; weights "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    phase_qdense(torch, model)
    H, W = BUCKET
    rng = np.random.default_rng(1)
    hws = [(H, W), (1200, 1344), (1344, 1000), (1100, 1200)][:AUTO_MB_SIZE]
    images = np.stack([rng.integers(0, 256, (H, W, 3)).astype(np.uint8) for _ in hws])
    N = len(hws)
    model.infer_microbatch(images, hws)      # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fca.reset_launches()
    mg.sparse_row_gather.launches = 0
    st = {}
    with recorded(model) as mb:
        t0 = time.perf_counter()
        res = model.infer_microbatch(images, hws, stage_times=st)
        wall = (time.perf_counter() - t0) * 1e3
    launches = fca.flash_shared_kv_cross_attn.launches
    by_variant = dict(fca.flash_shared_kv_cross_attn.launches_by_variant)
    skv["launches_by_path"]["infer_microbatch"] = launches
    skv["launches_by_variant"]["infer_microbatch"] = by_variant
    gat["launches_by_path"]["infer_microbatch"] = mg.sparse_row_gather.launches
    log(f"[deploy] infer_microbatch of {N} images: total {wall:.1f} ms, {wall / N:.1f} "
        "ms/image; per image " + ", ".join(f"{k} {v / N:.1f} ms" for k, v in st.items())
        + f"; decode_trips {res[0]['decode_steps']} (joint); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; flash_shared_kv_cross_attn "
        f"launches {launches} ({by_variant}); sparse_row_gather launches "
        f"{mg.sparse_row_gather.launches}")
    check_variants(by_variant, N)
    for r in res:
        check_result(r, (H, W))
        assert r["decode_steps"] == res[0]["decode_steps"]

    fed = fed_tokens(torch, mb)
    K = mb["dev"][0]["gen_tokens"].shape[0]
    per = []
    for i, (img, hw) in enumerate(zip(images, hws)):
        st = {}
        with recorded(model, forced=fed[i * K:(i + 1) * K]) as one:
            t0 = time.perf_counter()
            model.infer(img, hw, stage_times=st)
            wall = (time.perf_counter() - t0) * 1e3
        per += per_image(torch, one)
        log(f"[deploy] infer image {i} hw={hw} (same int8 model, decode teacher-forced on "
            f"the micro-batch's tokens): total {wall:.1f} ms; "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in st.items())
            + f"; decode_trips {int(one['dev'][0]['decode_trips'])}")
    compare_runs(torch, "deploy", per_image(torch, mb), per)


# COCO sizes (h, w): 4 square, 3 + 1 landscape, 4 portrait.  The tool runs
# the largest bucket first, so its first chunk is the 4 square images, the
# ones ``--limit 4`` takes again under the profiler
TOOL_SIZES = [(640, 640)] * 4 + [(480, 640)] * 3 + [(375, 500)] + [(640, 480)] * 4
TOOL_INT8 = "tpu = dict(llm_int8=True, act_int8=True, enc_points_per_level=[2, 2, 2, 4])\n"


def write_png_fixture(root, sizes, seed=0):
    """Images (three coloured regions plus noise), GT panoptic PNGs with
    three segments (person, dog, sky) and a PSG json whose test split is
    every image, written by the port's PNG codec → the json's path."""
    import numpy as np

    from openpsg_tpu_torch.utils.image_io import encode_png_rgb, write_png
    from openpsg_tpu_torch.utils.panoptic import id2rgb

    rng = np.random.default_rng(seed)
    colours = np.asarray([[200, 60, 60], [60, 200, 60], [60, 60, 200]])
    data = []
    for i, (h, w) in enumerate(sizes):
        pan = np.full((h, w), 7003)
        pan[: h // 2, : w // 2], pan[: h // 2, w // 2:] = 7001, 7002
        img = colours[pan - 7001] + rng.integers(-30, 30, (h, w, 3))
        write_png(os.path.join(root, f"{i}.png"),
                  encode_png_rgb(np.clip(img, 0, 255).astype(np.uint8)))
        write_png(os.path.join(root, f"pan{i}.png"), encode_png_rgb(id2rgb(pan)))
        data.append(dict(image_id=str(i), file_name=f"{i}.png", pan_seg_file_name=f"pan{i}.png",
                         height=h, width=w, relations=[[0, 2, 4], [1, 0, 23]],
                         segments_info=[dict(id=7001, category_id=0, isthing=1),
                                        dict(id=7002, category_id=16, isthing=1),
                                        dict(id=7003, category_id=119, isthing=0)]))
    path = os.path.join(root, "psg.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(dict(data=data, test_image_ids=[d["image_id"] for d in data]), f)
    return path


def prefetch_contention(model, root, sizes, pairs=3):
    """Does the tool's prefetch slow its host-bound model?  The square chunk
    (``infer_microbatch`` on the first 4 images) timed alone and with a
    thread preparing the 4 landscape images as the tool's worker does
    (decode + keep-ratio resize), in turns (with, alone, alone, with, ...)
    → (alone seconds, with-worker seconds), one per turn."""
    import threading

    import numpy as np

    from openpsg_tpu_torch.data.preprocess import Preprocessor, aspect_buckets, load_image_rgb

    prep = Preprocessor(scale=(1333, 1333), buckets=aspect_buckets((1333, 1333)))
    square = [prep(load_image_rgb(os.path.join(root, f"{i}.png"))) for i in range(4)]
    imgs = np.stack([e["image"] for e in square])
    hws = np.asarray([e["img_shape"] for e in square], np.int32)
    landscape = [os.path.join(root, f"{i}.png") for i in range(4, 8)]
    bucket = prep.bucket_for(*sizes[4])

    def work():
        for path in landscape:
            prep(load_image_rgb(path), bucket=bucket)

    times = {False: [], True: []}
    for k in range(2 * pairs):
        with_worker = k % 4 in (0, 3)
        worker = threading.Thread(target=work) if with_worker else None
        if worker:
            worker.start()
        t0 = time.perf_counter()
        model.infer_microbatch(imgs, hws)
        times[with_worker].append(time.perf_counter() - t0)
        if worker:
            worker.join()
    return times[False], times[True]


def phase_tool(torch, skv, gat):
    """Phase 7: the infer tool on the card at full width with the int8
    deployment settings, on a 12-image PNG fixture; then the grader; then
    the prefetch's cost to the model (:func:`prefetch_contention`); then 4
    images again under the profiler."""
    import shutil
    import tempfile

    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config

    from openpsg_tpu_torch.ops import flash_cross_attn as fca, msda_gather as mg
    from openpsg_tpu_torch.tools import eval_pq, grade, infer
    from openpsg_tpu_torch.utils.image_io import read_png

    root = tempfile.mkdtemp(prefix="chip_smoke_tool_")
    try:
        ann = write_png_fixture(root, TOOL_SIZES)
        cfg = os.path.join(root, "deploy.py")
        with open(cfg, "w", encoding="utf-8") as f:
            f.write(f"_base_ = [{os.path.join(HERE, 'openpsg_tpu_torch/configs/psg/baseline_v4_ov.py')!r}]\n"
                    + TOOL_INT8)
        out = os.path.join(root, "out")
        argv = ["--config", cfg, "--test-file", ann, "--data-dir", root, "--output-dir", out]
        n = len(TOOL_SIZES)
        torch.cuda.synchronize()
        fca.reset_launches()
        mg.sparse_row_gather.launches = 0
        stats = infer.main(argv)
        by_variant = dict(fca.flash_shared_kv_cross_attn.launches_by_variant)
        skv["launches_by_path"]["tool"] = fca.flash_shared_kv_cross_attn.launches
        skv["launches_by_variant"]["tool"] = by_variant
        gat["launches_by_path"]["tool"] = mg.sparse_row_gather.launches
        check_variants(by_variant, n)
        if stats["n_images"] != n or stats["micro_batch"] != 4:
            raise AssertionError(f"tool ran {stats['n_images']} images at micro-batch "
                                 f"{stats['micro_batch']}, expected {n} at 4")
        with open(stats["submission"], encoding="utf-8") as f:
            recs = json.load(f)
        if [r["pan_seg_file_name"] for r in recs] != [f"{i}.png" for i in range(n)]:
            raise AssertionError("submission records are not in test order")
        for i, (rec, hw) in enumerate(zip(recs, TOOL_SIZES)):
            png = read_png(os.path.join(out, "submission", "panseg", rec["pan_seg_file_name"]))
            if png.shape[:2] != hw or not rec["segments_info"] or not rec["relations"]:
                raise AssertionError(f"record {i}: PNG {png.shape[:2]} vs image {hw}, "
                                     f"{len(rec['segments_info'])} segments, "
                                     f"{len(rec['relations'])} relations")
        sec = stats["sections"]
        per = {k: sum(v) / n * 1e3 for k, v in sec.items()}
        waited = sum(sec["load+preprocess"])
        chunk_ms = [t * 1e3 for t in sec["model"]]
        log(f"[tool] {n} images (buckets 4 x 1344x1344, 4 x 1024x1344, 4 x 1344x1024), "
            f"micro-batch {stats['micro_batch']}: {stats['seconds']:.2f} s, "
            f"{n / stats['seconds']:.3f} img/s; per image " + ", ".join(
                f"{k} {v:.1f} ms" for k, v in per.items())
            + f"; prefetch {stats['prep_seconds']:.2f} s on the worker thread, {waited:.2f} s "
            f"waited on the main thread ({stats['prep_seconds'] - waited:.2f} s hidden under "
            f"the model); model per chunk (square, landscape, portrait) "
            + ", ".join(f"{t:.1f}" for t in chunk_ms) + " ms, the worker preparing the next "
            "chunk during the first two; flash_shared_kv_cross_attn launches "
            f"{by_variant}; sparse_row_gather launches {mg.sparse_row_gather.launches}")
        grading = ["--submission", out, "--gt-json", ann, "--data-dir", root]
        r = grade.main(grading)
        pq = eval_pq.main(grading)
        log(f"[tool] graded: {json.dumps(r)} {json.dumps(pq)} (random weights: no fused "
            "object, so each record carries the dummy segment and relation)")

        model = build_detector_from_config(Config.fromfile(cfg), seed=0)
        alone, busy_worker = prefetch_contention(model, root, TOOL_SIZES)
        med = lambda t: statistics.median(t) * 1e3
        log(f"[tool] the square chunk's infer_microbatch, in turns: alone "
            + ", ".join(f"{t * 1e3:.1f}" for t in alone) + " ms (median "
            f"{med(alone):.1f}); with a thread preparing the landscape chunk "
            + ", ".join(f"{t * 1e3:.1f}" for t in busy_worker) + " ms (median "
            f"{med(busy_worker):.1f}); difference of medians "
            f"{med(busy_worker) - med(alone):+.1f} ms")

        prof_dir = os.path.join(root, "profile")
        p_stats = infer.main(argv + ["--limit", "4", "--output-dir", os.path.join(root, "out4"),
                                     "--profile", prof_dir], model=model)
        busy, window = p_stats["busy_seconds"], p_stats["model_trace_seconds"]
        log(f"[tool] the 4 square images again under the profiler ({p_stats['seconds']:.2f} s): "
            f"a kernel ran in {busy:.3f} s of the {window:.3f} s model section "
            f"({busy / window:.1%}; the profiler's host overhead stretches the section); "
            f"against the same chunk's unprofiled model section ({chunk_ms[0] / 1e3:.3f} s): "
            f"{busy / (chunk_ms[0] / 1e3):.1%}")
        log("[tool] stats " + json.dumps(dict(
            images=n, seconds=stats["seconds"], img_per_s=n / stats["seconds"],
            ms_per_image=per, model_chunk_ms=chunk_ms, prep_seconds=stats["prep_seconds"],
            waited_seconds=waited, profiled_seconds=p_stats["seconds"],
            busy_seconds=busy, profiled_model_seconds=window,
            busy_share_profiled=busy / window, busy_share_unprofiled=busy / (chunk_ms[0] / 1e3),
            square_chunk_alone_ms=[t * 1e3 for t in alone],
            square_chunk_with_worker_ms=[t * 1e3 for t in busy_worker])))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def compare_runs(torch, tag, a, b):
    """Two runs of one model on the same images (:func:`per_image` lists),
    run b teacher-forced on run a's tokens: everything before the LLM runs
    the same per-image code, so it must be identical; the LLM's GEMMs ran
    with other row counts (or on another device), so its choices are held
    to :func:`agree_tokens`."""
    import numpy as np

    for i, ((da, _), (db, _)) in enumerate(zip(a, b)):
        for key in ("pan_seg", "object_ids", "object_valid", "top_pair_idx", "mc_triplets"):
            if not np.array_equal(da[key], db[key]):
                raise AssertionError(f"{tag} image {i}: {key} differs between the runs")
    log(f"[{tag}] pan maps, object lists, top pairs and top-100 triplets identical "
        f"on all {len(a)} images")
    runs = []
    for (da, la), (db, lb) in zip(a, b):
        T = min(int(da["decode_trips"]), int(db["decode_trips"]))
        runs.append((la[:T], lb[:T].to(la.device)))
    agree_tokens(torch, tag, runs)


def agree_tokens(torch, tag, runs):
    """Greedy choices of two runs of one LLM on the same sequences, given
    per image as (logits_a [T, K, V], logits_b [T, K, V]), logits_t the
    forward that chose token t, run b teacher-forced on run a's tokens: at
    every step both saw the same history.  Gates: (1) the largest logit
    change between the runs is within TOL_LOGIT_REL of the largest logit;
    (2) with ``err`` the largest change at the steps where both choose the
    same token, a step where they choose differently must have a top-1
    margin (run b's) of at most 2·err — a wider margin would need a change
    larger than every change at the agreeing steps."""
    differ, change, margin = [], [], []
    for la, lb in runs:
        differ.append((la.argmax(dim=-1) != lb.argmax(dim=-1)).flatten())
        change.append((la - lb).abs().amax(dim=-1).flatten())
        top2 = torch.topk(lb, 2, dim=-1).values
        margin.append((top2[..., 0] - top2[..., 1]).flatten())
    differ, change, margin = (torch.cat(t) for t in (differ, change, margin))
    scale = max(float(lb.abs().max()) for _, lb in runs)
    err_all = float(change.max())
    err = float(change[~differ].max()) if bool((~differ).any()) else 0.0
    n_diff = int(differ.sum())
    bad = int((differ & (margin > 2 * err)).sum())
    widest = float(margin[differ].max()) if n_diff else 0.0
    log(f"[{tag}] tokens at the same history: {differ.numel() - n_diff}/{differ.numel()} "
        f"steps choose the same token; largest logit change {err_all:.4e} "
        f"({err_all / scale:.3e} of the largest logit {scale:.3f}, tol {TOL_LOGIT_REL:g}), "
        f"{err:.4e} at the agreeing steps; {n_diff} steps differ, widest top-1 margin "
        f"among them {widest:.4e}, {bad} with a margin > 2*{err:.4e}")
    if bad or not err_all <= TOL_LOGIT_REL * scale:
        raise AssertionError(f"{tag}: the two runs' tokens disagree beyond the margin rule")


def synthetic_objects(model, seg, sel, n_obj=30, seed=0):
    """Replace the fused objects by ``n_obj`` disjoint seeded regions (a
    Voronoi partition of the stride-4 grid) with seeded labels, so the head
    sees valid pairs whose masks differ pair by pair: seeded random weights
    leave fusion with no surviving object at this width."""
    import numpy as np
    import torch

    from openpsg_tpu_torch.data.vocab import INSTANCE_OFFSET, NUM_THING_CLASSES

    H4, W4 = seg["mask_features"].shape[:2]
    M = model.cfg.head.max_objects_padded
    rng = np.random.default_rng(seed)
    seeds = rng.random((n_obj, 2)) * (H4, W4)
    yy, xx = np.mgrid[:H4, :W4]
    owner = np.argmin((yy[None] - seeds[:, 0, None, None]) ** 2
                      + (xx[None] - seeds[:, 1, None, None]) ** 2, axis=0)
    labels = rng.integers(0, 133, n_obj)
    counts, oids = {}, []
    for lab in labels:
        inst = counts.get(lab, 0) if lab < NUM_THING_CLASSES else 0
        counts[lab] = counts.get(lab, 0) + 1
        oids.append(int(lab) + INSTANCE_OFFSET * inst)
    masks = np.zeros((M, H4, W4), bool)
    masks[:n_obj] = owner[None] == np.arange(n_obj)[:, None, None]
    lab = np.zeros(M, np.int32)
    lab[:n_obj] = labels
    oid = np.zeros(M, np.int32)
    oid[:n_obj] = oids
    dev = seg["mask_features"].device
    t = lambda a: torch.as_tensor(a, device=dev)
    valid = t(np.arange(M) < n_obj)
    scores = t(rng.random(M).astype(np.float32))
    return (t(masks), valid, t(lab), t(oid), scores) + tuple(sel[5:])


def kernel_calls(fn):
    """Run ``fn()`` with the Q-Former's attention wrapper recorded → (its
    result, the argument tuple of each wrapper call)."""
    import openpsg_tpu_torch.models.relation.qformer as qf

    real, calls = qf.flash_shared_kv_cross_attn, []

    def record(*args):
        calls.append(args)
        return real(*args)

    qf.flash_shared_kv_cross_attn = record
    try:
        return fn(), calls
    finally:
        qf.flash_shared_kv_cross_attn = real


def phase_head_parity(torch, model, mask_features, sel):
    """Phase 5: ``tail_pre`` (Q-Former, existence heads, top-k, LLM prefix)
    with the kernel against the same with the plain attention forced, on
    one full-width image's features and ``sel``'s objects: in bf16 as the
    main path runs it (tolerance TOL_BF16), then on a float32 copy of the
    head (TOL_HEAD_F32)."""
    import copy

    M = model.cfg.head.max_objects_padded
    valid = sel[1]
    pair = torch.arange(M * M, device=valid.device)
    pair_valid = valid[pair // M] & valid[pair % M]

    def run(m, plain):
        heads = {}
        hook = m.head.register_forward_hook(lambda mod, inp, out: heads.update(out))
        try:
            (out, _, _), calls = kernel_calls(
                lambda: m.tail_pre(mask_features, *sel, plain_attention=plain))
        finally:
            hook.remove()
        want = 0 if plain else m.cfg.head.qformer.num_layers
        if len(calls) != want:
            raise AssertionError(f"{len(calls)} kernel calls, expected {want}")
        return out, heads

    m32 = copy.copy(model)
    m32.head = copy.deepcopy(model.head).float()
    for tag, m, tol in (("bf16", model, TOL_BF16), ("f32 head", m32, TOL_HEAD_F32)):
        compare_head(torch, tag, tol, M, pair_valid, run(m, plain=False), run(m, plain=True))


def agree_ranked(torch, name, tol, idx_k, idx_p, full_k, full_p):
    """Two top-k selections, by the kernel path (``idx_k``) and the plain
    path (``idx_p``), of candidates scored ``full_k`` / ``full_p`` (every
    candidate, as the selection saw it).  With ``err`` the largest score
    change the kernel made, a rank whose plain score lies more than 2·err
    from both neighbours cannot swap, so it must pick the same candidate;
    and every rank must pick a candidate whose plain score is within 2·err
    of the plain score at that rank.  ``err`` itself must be ≤ ``tol``."""
    fk, fp = full_k.float().flatten(), full_p.float().flatten()
    fin = torch.isfinite(fp)
    err = float((fk[fin] - fp[fin]).abs().max())
    k = idx_k.shape[0]
    sp = torch.sort(fp, descending=True, stable=True).values[: k + 1].clamp(min=-1e30)
    d = sp[:-1] - sp[1:]                                  # k gaps below each rank
    above = torch.cat([torch.full((1,), float("inf"), device=d.device), d[:-1]])
    separated = torch.minimum(above, d) > 2 * err
    same = idx_k == idx_p
    drift = float((fp[idx_k] - sp[:k]).abs().max())
    bad = int((separated & ~same).sum())
    log(f"[plain-vs-kernel] {name}: max score diff {err:.3e} (tol {tol:g}); "
        f"{int(separated.sum())}/{k} ranks separated by > 2*diff, {bad} of them differ; "
        f"{int(same.sum())}/{k} ranks equal; rank drift {drift:.3e}")
    if bad or not err <= tol or not drift <= 2 * err:
        raise AssertionError(f"{name}: kernel and plain paths disagree")


def compare_head(torch, tag, tol, M, pair_valid, kern, plain):
    """Kernel-path and plain-path outputs (``(tail_pre out, head outputs)``
    each): the top-20 pairs and top-100 triplets agree rank by rank
    (:func:`agree_ranked`), and the Q-Former outputs and LLM visual tokens
    of the valid pairs are within ``tol`` relative to their largest entry."""
    (out_k, head_k), (out_p, head_p) = kern, plain
    ninf = torch.tensor(float("-inf"), device=pair_valid.device)
    bin_k = torch.where(pair_valid, torch.sigmoid(head_k["binary_logits"]), ninf)
    bin_p = torch.where(pair_valid, torch.sigmoid(head_p["binary_logits"]), ninf)
    agree_ranked(torch, f"{tag} top_pair_idx", tol, out_k["top_pair_idx"].long(),
                 out_p["top_pair_idx"].long(), bin_k, bin_p)

    pair = torch.arange(M * M, device=pair_valid.device)
    mc_ok = (pair_valid & (pair // M != pair % M))[:, None]
    mc_k = torch.where(mc_ok, torch.sigmoid(head_k["multiclass_logits"]), 0.0)
    mc_p = torch.where(mc_ok, torch.sigmoid(head_p["multiclass_logits"]), 0.0)
    R = mc_k.shape[1]
    flat = lambda t: ((t[:, 0].long() * M + t[:, 1].long()) * R + t[:, 2].long())
    agree_ranked(torch, f"{tag} mc_triplets", tol, flat(out_k["mc_triplets"]),
                 flat(out_p["mc_triplets"]), mc_k, mc_p)

    for key in ("qformer_out", "llm_visual_tokens"):
        a, b = head_k[key][pair_valid].float(), head_p[key][pair_valid].float()
        rel = float((a - b).abs().max() / b.abs().max().clamp(min=1e-6))
        log(f"[plain-vs-kernel] {tag} {key} of {a.shape[0]} valid pairs: max diff "
            f"relative to the largest entry {rel:.3e} (tol {tol:g})")
        if not rel <= tol:
            raise AssertionError(f"{tag}: {key} differs beyond the tolerance")


if __name__ == "__main__":
    rc = main()
    if rc == 0:
        import torch

        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    sys.exit(rc)
