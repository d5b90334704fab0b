#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``openpsg_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, each fatal on failure:
  1. device line (``nvidia-smi`` name and power limit, torch and CUDA);
  2. build the CUDA kernel of the main path from ``csrc/``;
  3. the kernel against its plain PyTorch version at the main-path shape;
  4. the main path at full ``baseline_v4_ov`` width: ``PSGv4.infer`` on
     seeded 1344² images with seeded random weights, launch counts read
     around exactly that run; plus the tiny config on the card against the
     CPU path;
  5. the kernel's, the plain version's and the library's times and the
     bound on the main path's own kernel inputs (image 0, CUDA events,
     median of 50 with its interquartile range); then the full-width head
     with the plain attention forced (test-only switch) against the kernel
     path on one image with 30 seeded objects, in bf16 and on a float32
     copy of the head.

The last three lines are the JSON object ``{"kernels": [...]}``, the
``nvidia-smi`` line and ``{"ok": true, "device": {...}}``.  Imports nothing
of JAX.
"""

from __future__ import annotations

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


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, warmup=5, reps=50) -> tuple:
    """``reps`` CUDA-event timings of ``fn()`` after warm-up → (median, 25th
    percentile, 75th percentile) in ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
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
    """Phase 3: the shared-KV attention kernel against its plain version."""
    from openpsg_tpu_torch.ops import flash_cross_attn as fca

    gen = torch.Generator(device="cuda").manual_seed(0)

    def data(NP, H, Lq, hd, P, dtype, p_mask=0.5):
        q = torch.randn(NP, H, Lq, hd, generator=gen, device="cuda").to(dtype)
        k = torch.randn(H, P, hd, generator=gen, device="cuda").to(dtype)
        v = torch.randn(H, P, hd, generator=gen, device="cuda").to(dtype)
        mask = torch.rand(NP, P, generator=gen, device="cuda") < p_mask
        return q, k, v, mask

    def check(name, q, k, v, mask, tol):
        got = fca.flash_shared_kv_cross_attn(q, k, v, mask)
        torch.cuda.synchronize()
        g = fca.guard_empty_mask(mask)
        want = fca.shared_kv_cross_attn_plain(q.float(), k.float(), v.float(), g)
        err = float((got.float() - want).abs().max())
        ok = err <= tol and bool(torch.isfinite(got).all())
        log(f"[kernel] {name}: max_abs_err={err:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees with plain on {name}")
        return err

    main = dict(NP=1024, H=12, Lq=33, hd=64, P=441)
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        tag = str(dtype).split(".")[-1]
        q, k, v, mask = data(dtype=dtype, **main)
        err = check(f"{tag} main shape random mask", q, k, v, mask, tol)
        if dtype == torch.bfloat16:
            results["max_abs_err"] = err
        m2 = mask.clone()
        m2[::7] = False                      # fully masked rows (guarded)
        check(f"{tag} fully masked rows", q, k, v, m2, tol)
        m3 = mask.clone()
        m3[:, 64:128] = False                # one whole 64-patch chunk
        m3[1::2, :64] = False                # ... and the first chunk on odd pairs
        check(f"{tag} fully masked 64-patch chunks", q, k, v, m3, tol)
        q4, k4, v4, mk4 = data(NP=1000, H=12, Lq=33, hd=64, P=441, dtype=dtype)
        check(f"{tag} NP=1000 (ragged row tile)", q4, k4, v4, mk4, tol)
        for hd, P in ((16, 40), (64, 130)):
            check(f"{tag} small hd={hd} P={P}", *data(6, 2, 5, hd, P, dtype), tol)


def time_kernel(torch, fca, q, k, v, mask, results):
    """Kernel, plain and library times (each the median of 50 runs with its
    interquartile range) and the bound, on these inputs, into ``results``."""
    import torch.nn.functional as F

    g = fca.guard_empty_mask(mask)
    NP = q.shape[0]
    ke, ve = k[None].expand(NP, -1, -1, -1), v[None].expand(NP, -1, -1, -1)
    am = g[:, None, None, :]
    runs = {
        "ms": lambda: fca.flash_shared_kv_cross_attn(q, k, v, g),
        "plain_ms": lambda: fca.shared_kv_cross_attn_plain(q, k, v, g),
        "library_ms": lambda: F.scaled_dot_product_attention(q, ke, ve, attn_mask=am),
    }
    text = []
    for key, fn in runs.items():
        results[key], q1, q3 = time_ms(fn)
        text.append(f"{key} {results[key]:.4f} (IQR {q1:.4f}-{q3:.4f})")
    results["bound_ms"], results["bound_by"] = skv_bound_ms(q, k, g)
    log(f"[kernel] inputs {tuple(q.shape)} {q.dtype} mask density "
        f"{float(g.float().mean()):.3f}: " + ", ".join(text)
        + f"; library = SDPA; bound_ms {results['bound_ms']:.4f} ({results['bound_by']})")


def phase_tiny_vs_cpu(torch):
    """The tiny config on the card (kernel path) against the CPU path."""
    import numpy as np

    from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config

    cfg = PSGv4Config.tiny_test()
    import dataclasses

    cfg = dataclasses.replace(cfg, iou_thr=0.1)
    cpu = PSGv4(cfg, seed=3, device="cpu")
    gpu = PSGv4(cfg, seed=3, device="cuda")
    for part in ("segmenter", "head", "llm"):
        getattr(gpu, part).load_state_dict(getattr(cpu, part).state_dict())
    gpu.class_embeds = cpu.class_embeds.cuda()
    img = np.random.default_rng(5).integers(0, 256, (64, 64, 3)).astype(np.uint8)
    a, b = cpu.infer(img, (64, 60)), gpu.infer(img, (64, 60))
    same = (np.array_equal(a["pan_results"], b["pan_results"])
            and a["rel_results"] == b["rel_results"]
            and np.allclose(a["rel_scores"], b["rel_scores"], atol=1e-4))
    log(f"[tiny] card vs CPU: objects {b['rel_results']['object_id_list']} "
        f"relations {len(b['rel_results']['relation'])} identical={same}")
    if not same:
        raise AssertionError("tiny config on the card disagrees with the CPU path")


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
    from openpsg_tpu_torch.ops import _build, flash_cross_attn as fca

    t0 = time.perf_counter()
    _build.library("flash_shared_kv_cross_attn")
    log(f"[build] flash_shared_kv_cross_attn in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[build] {name}: {line.strip()}")

    # ---- 3. kernels against their plain versions
    skv = {"name": "flash_shared_kv_cross_attn", "route": "cuda",
           "source": "openpsg_tpu_torch/csrc/flash_shared_kv_cross_attn.cu",
           "replaces": "openpsg_tpu/ops/pallas/flash_cross_attn.py:80"}
    phase_kernel(torch, skv)

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
    fca.flash_shared_kv_cross_attn.launches = 0
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
    skv["launches"] = launches
    log(f"[main] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"flash_shared_kv_cross_attn launches {launches} for {len(images)} images")
    if launches != 2 * len(images):
        raise AssertionError(f"expected {2 * len(images)} kernel launches, saw {launches}")
    for res in results:
        check_result(res, (H, W))

    # ---- 5. kernel times on the main path's own inputs; the head with the
    # plain attention forced, against the kernel
    img = torch.as_tensor(images[0]).cuda()
    seg = model.segment(img)
    own = model.fuse_select(seg, hws[0])
    _, calls = kernel_calls(lambda: model.tail_pre(seg["mask_features"], *own))
    log("[kernel] timing on image 0's first Q-Former layer, as phase 4 ran it")
    time_kernel(torch, fca, *calls[0], skv)
    phase_head_parity(torch, model, seg["mask_features"], synthetic_objects(model, seg, own))

    for key in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        assert key in skv, key
    log(json.dumps({"kernels": [skv]}))
    log(smi)
    return 0


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
