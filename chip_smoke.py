#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``openpsg_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, each fatal on failure:
  1. device line (``nvidia-smi`` name and power limit, torch and CUDA);
  2. build the three CUDA kernels from ``csrc/`` (one nvcc each, started
     together from three threads) and log their registers and spills, and
     the shared-KV kernel's hopper variant's registers, shared memory and
     local memory as the CUDA runtime reports them;
  3. each kernel against its plain PyTorch version: the shared-KV
     attention at the main-path shape (float32: the simple variant; bf16:
     the hopper variant), with fully masked rows and 64-patch chunks, and
     at the hopper variant's edges at the main width (NP = 1 and 1000,
     Lq = 1, P at the cap and one past it), each case holding the variant's
     launch count; the row gather bitwise on seeded cases (float32 and
     bf16, ragged sizes, out-of-range indices, C = 128 and 16); the fused
     ``ms_deform_attn`` within one step of the output type of its plain
     version (the 1344² encoder, 300 decoder queries at B = 2, points
     2,2,2,4, levels of height or width 1 and 2 with locations outside the
     map, a head of 4 channels; float32 and bf16), one launch a call;
  4. the per-image path at full ``baseline_v4_ov`` width (bf16 LLM):
     ``PSGv4.infer`` on seeded 1344² images with seeded random weights,
     launch counts (per variant) read around exactly that run; plus the
     tiny config on the card against the CPU path, with its float32 LLM
     through ``infer`` and with an int8 bf16 LLM through
     ``infer_microbatch`` (3 images, int8-activation prefill); one
     ``ms_deform_attn`` launch per deformable layer and image (15), no
     plain call; the segmenter captured once in the warm-up and replayed
     from its CUDA graph once an image after it, never eagerly;
  5. the segmenter's output on the main path (its graph) against its
     eager call, bit for bit, on each image whose deformable-attention
     inputs are recorded; the kernels' times, the plain versions', the
     library's and the bound
     on the main path's own inputs (image 0, CUDA events around 10
     back-to-back calls, median per call with its interquartile range): the shared-KV kernel on the first Q-Former
     layer's inputs (its hopper variant, the simple variant called
     explicitly, the plain version and SDPA in two formulations, timed in
     turns), the gather on level 0 of the first pixel-decoder
     encoder layer (quad table and row index rebuilt by
     ``ops/deform_attn.level_samples``); the fused ``ms_deform_attn`` and
     its plain version in turns, beside the op's bound, on image 0's first
     encoder and decoder calls (1344²) and on a 1024x1344 image's (its
     encoder with 4 levels and with the first 3, and its decoder); no
     single PyTorch call computes it, so its ``library_ms`` is none; then
     the full-width head with the
     plain attention forced (test-only switch) against the kernel path on
     one image with 30 seeded objects, in bf16 and on a float32 copy;
  6. the deployment path at full ``baseline_v4_ov_w8a8`` width (int8
     Llama-2-7B, int8-activation prefill, encoder points 2,2,2,4):
     ``QDense`` on the card against its CPU path at the model's widths;
     ``PSGv4.infer_microbatch`` on 4 seeded 1344² images (a warm-up, then
     one timed call, launch counts read around it), then the same images
     through ``PSGv4.infer`` on the same model, its decode teacher-forced
     on the micro-batch's tokens (15 ``ms_deform_attn`` launches an image
     on the micro-batch): pan maps, objects, top-20 pairs and
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
     ran a kernel;
  8. training: (a) the tiny config, one training step on the card against
     the CPU on the same weights and batch (losses, every head gradient
     and the updated values within TOL_TRAIN_*; no shared-KV launch; a
     nonzero gradient through the cross-attention); (b) full width through
     ``openpsg_tpu_torch.tools.train.main``: the port's
     ``baseline_v4_ov.py`` (bf16 Llama-2-7B frozen, the head trained) on a
     PNG fixture from phase 7's writer with 8 train images at COCO sizes
     (4-12 segments, 2-6 relations each) and 4 val images, 8 steps with
     ``--validate --val-limit 4``: finite losses, the head changed, the
     frozen groups bitwise unchanged, a checkpoint holding only the head
     and its optimizer state, 0 launches in the steps and 2 hopper per
     validation image; then 4 steps again with ``--stage-times`` for the
     split; (c) ``openpsg_tpu_torch.tools.infer.main`` in the
     ``exp_tag epoch`` layout restoring the trained head bitwise, on the 4
     val images, its submission graded; (a') the tiny step again through
     an int8 LLM, weight-only and with int8 activations at >= 256 rows,
     card vs CPU; (d) the train tool at full width with
     ``--cfg-options tpu.llm_int8=True``, 2 steps: s/step, peak memory;
  9. published-format weights and tokenizers at full width, from seeded
     checkpoints in the reference layouts (an OpenSeeD ``.pt`` with its
     CLIP text tower, a toy CLIP merges file, a toy SentencePiece
     ``.model``, a v4 ``PartCheckpointHook`` ``.pth``): the port's
     ``convert_openseed`` and ``convert_relation``, then the infer tool
     with ``--config`` (converted segmenter, class embeddings, tokenizer),
     ``--checkpoint`` and ``--vis`` on 4 of phase 7's images: loaded
     tensors equal to the converted ones, the raw ``.pt`` loading the same,
     2 hopper launches per image, 4 overlays and tables, a graded
     submission; then an HF Llama-2-7B state at full width cut to 2 layers,
     loaded, converted and quantized, its logits card vs CPU;
 10. the closed-set v1-v3 family (``PSGMask2FormerRelation``): (a) tiny
     float32 models on the card against the CPU on the same weights: v1
     (attention, einsum, prompt + graph), v2 (all five experts with a text
     KV store, the gate per pair and per pair and relation), v3 (closed,
     open vocabulary), through fusion and on ground-truth objects: the
     selections identical, the top-100 triplets agreeing rank by rank
     within TOL_FAMILY; (b) full width on seeded random weights:
     ``baseline_r50.py`` through the infer tool (``--gt-masks --vis``, 4
     images), then v1, v2 and v3 (``baseline_r50.py``,
     ``baseline_v2_r50.py``, ``baseline_v3_ov.py``) ``infer`` and
     ``infer_gt`` (30 objects) on 2 seeded 1344² images each with stage ms
     per image and peak memory, and the other three full configs built and
     run once; no shared-KV or gather launch on any of it; (c) the
     converter chain: a seeded mmdet R50 Mask2Former ``.pth`` and a
     reference v1 head ``.pth`` through ``convert_mask2former`` and
     ``convert_relation``, the infer tool with the converted segmenter and
     ``--checkpoint``, every loaded tensor equal to its converted value;
 11. the family's training and segmenter training: (a) one ``M2FTrainer``
     step of the tiny float32 v1, v2 (all experts and the gate, text KV
     store), v3 and v1 with ``object_token_size`` 2, and one
     ``SegmenterTrainer`` step in each class mode, card vs CPU (losses,
     gradients, updated values; costs and Hungarian assignments); (b)
     ``tools.train.main`` at full width for ``baseline_r50.py`` (with
     ``--validate --val-limit 2``), ``baseline_v2_r50.py`` and
     ``baseline_v3_ov.py``, 4 steps each with ``--stage-times`` on phase
     8's fixture, each checkpoint restored bitwise through the infer tool
     (``--checkpoint --gt-masks``, 2 images): s/step, the split, peak
     memory, checkpoint bytes, no kernel launch; (c) ``SegmenterTrainer``
     on ``baseline_r50.py``'s Mask2Former at 1344², B=1, 3 steps: the split
     and peak memory; (d) ``tools.selfcheck_e2e`` at its defaults: strict
     R@20 > 0, the objects fusion keeps, decode trips, the shared-KV
     kernel's launches, and the kernel against its plain version on the
     trained model's learned pair masks;
 12. serving, prediction and the open-set check: (a) ``tools.serve`` at
     full width with phase 7's int8 deployment settings (one model handed
     to ``make_server``, ``--single-bucket --batch-size 4 --micro-batch
     --max-wait-ms 200``, warmed up): 8 of phase 7's PNGs posted at once
     from 8 threads over a real socket, then 2 identical posts, then
     ``/healthz``: every status 200, each record well formed (its PNG at
     the image's size, every segment id painted, relations 1-indexed), the
     identical posts' records identical, 2 hopper launches of the shared-KV
     kernel per image the model computed (pad copies included, counted
     around exactly those requests), no gather launch; requests/s, p50 and
     max latency, peak memory; then one ``service.submit`` at trip budget 2
     (at most 2 decode trips) and one at None; (b) phase 11d's trained
     model, started as a user starts the server (its config and
     checkpoint): its 3 held-out images served with records equal to 11d's
     infer-tool submission, then ``tools.predict`` on them (records and PNGs
     equal to the submission's) and ``tools.parse_predict`` (one named
     triplet per relation, no empty mask), then ``tools.predict
     --checkpoint`` refusing the {head, llm} checkpoint as the JAX tool
     does (F8); (c) ``tools.pvsg.infer_video`` at batch 4 on two 6-frame
     videos written from those images: each frame's record equal to
     ``infer`` on it; the frame extractor on a short video where
     ``cv2.VideoWriter`` can write one; (d) ``tools.selfcheck_openset`` at
     its defaults: the JAX tool's exit rule, the easy tier's R@10 above
     chance, its median rank below half the hard tier's, no kernel launch;
     (e) ``tools.selfcheck_knobs`` at KNOB_STEPS (fewer than its 700 +
     400): both losses fall, the six knob variants graded over the same 8
     held-out images, the ``harness`` block equal to the JAX harness's
     constants, 2 "simple" shared-KV launches per image and variant (path
     ``knobs``) and no gather, the ``QDense`` routes per variant, the R@20
     matrix and the ``KNOBCHECK`` verdict (asserted at the defaults only);
     then the fullest variant (int8, int8 activations, points 1,1,4) on
     the trained weights card vs CPU: panoptic ids, objects, top pairs and
     triplets equal, scores within TOL_KNOB_SCORE, an integer that differs
     excused only by a deciding margin within it (counted), tokens by the
     margin rule.

  13. parallelism on the card (``parallel/``): (a) ``python -m
     torch.distributed.run --standalone --nproc_per_node 1 -m
     openpsg_tpu_torch.tools.train --launcher pytorch`` at full
     ``baseline_v4_ov`` width with ``tpu.mesh=dict(dp=1, tp=1)`` (NCCL at
     world size 1), 2 steps on phase 8b's fixture: its logged losses equal
     8b's first two within TOL_TRAIN_LOSS; then the infer tool with
     ``--batch-size 2 --single-bucket`` on the 4 val images: in this process
     without a process group, under the launcher, and in this process as
     rank 0 of an NCCL world of 1 (``infer_batch`` over a dp mesh, its
     launches counted as path ``infer_batch_dp``): relation.json and every
     PNG byte-equal; (b) ``make_pair_sharded_infer`` over that NCCL world:
     results equal ``infer``, 2 hopper launches per image, and on 30 seeded
     objects per image the gathered head outputs (logits, visual tokens,
     top pairs, LLM prefix) equal the unsplit head's within TOL_F32; (c)
     one dp=2 train step at full width as 2 gloo ranks sharing ``cuda:0``
     (``parallel.launch.spawn``): the losses, the dp-averaged head
     gradients and the updated head equal a single-process step at B=2
     within TOL_TRAIN_LOSS, TOL_TRAIN_GRAD and TOL_TRAIN_UPDATE (the
     largest gradient difference is printed too); peak memory per rank;
     (d) before (c), in that NCCL world: ``tools.serve.make_server`` with
     ``--batch-size 2`` builds its dp mesh of 1 and serves phase 12a's
     full-width int8 model: 4 PNGs posted at once, each record equal to
     ``infer`` on the same image (launches counted as path ``serve_dp``);
     then the tiny float32 Llama with a ``decouple_label_masks``
     ``full_mask``, with and without a cache, card against CPU; and whether
     ``tensorstore`` and ``msgpack`` (the JAX-file readers) import here.
 14. the measurement tools (``openpsg_tpu_torch/tools/``) at 1344², each
     through its ``run`` at BENCH_SMOKE_ITERS samples: (a) ``bench_stages``
     on phase 12a's int8 deployment model, every stage (segmenter parts,
     one deformable-attention call at encoder and at decoder geometry,
     fusion, the Q-Former, prefill, prefill + decode, the LLM
     microbenches), with deformable attention's share of the segmenter
     and ``infer``'s segmenter ms beside the split's sum, the shared-KV
     kernel's hopper launches counted as path ``bench_stages``; (b)
     ``probe_msda_variants`` on the JAX tool's uniform inputs and on that
     model's own first encoder call, every variant (v2k: one launch of the
     row-gather kernel, path ``probe_msda``) held against v0 before it is
     timed; (c) ``bench_train`` at its default recipe (frozen int8
     Llama-2-7B, 32 layers; no launch); (d) ``bench_family`` for v1, v2 and
     v3 (no launch); (e) ``bench_host`` at 1344².  Every record names the
     card and its power limit as ``nvidia-smi`` does.

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
TOL_TRAIN_LOSS = 1e-4  # tiny float32 train step, card vs CPU, relative: the
                       # same float32 arithmetic summed in another order
TOL_TRAIN_GRAD = 1e-3  # each head gradient leaf, card vs CPU, relative to the
                       # leaf's largest entry (leaves whose gradient is 0 up to
                       # roundoff, below 1e-5 of the largest gradient, are held
                       # to that instead): summation order through the
                       # segmenter, the LLM's backward and the Q-Former's
TOL_TRAIN_UPDATE = 1e-6  # values after the optimizer step (absolute; lr 1e-7)
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

    t_start = time.perf_counter()

    # ---- 1. device line
    smi = smi_line()
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} {torch.cuda.get_device_name(0)}")

    # ---- 2. build
    from concurrent.futures import ThreadPoolExecutor

    from openpsg_tpu_torch.ops import (
        _build,
        deform_attn as da,
        flash_cross_attn as fca,
        msda_gather as mg,
    )

    kernels = ("flash_shared_kv_cross_attn", "sparse_row_gather", "ms_deform_attn")
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
    fused = {"name": "ms_deform_attn", "route": "cuda",
             "source": "openpsg_tpu_torch/csrc/ms_deform_attn.cu",
             "replaces": "none (XLA in the JAX package: openpsg_tpu/ops/deform_attn.py:125)"}
    phase_kernel(torch, skv)
    phase_gather(torch, gat)
    phase_msda(torch, fused)

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
    from openpsg_tpu_torch.models.llm.decode import greedy_decode
    from openpsg_tpu_torch.utils.graphs import graphed_call

    decode_counters = ("graph_captures", "graph_trips", "eager_trips")
    segment_counters = ("graph_captures", "graph_calls", "eager_calls")
    for k in decode_counters:
        setattr(greedy_decode, k, 0)
    for k in segment_counters:
        setattr(graphed_call, k, 0)
    # warm-up (cuDNN / cuBLAS plans, the segmenter's graph, the decode graph)
    model.infer(images[0], hws[0])
    torch.cuda.synchronize()
    warm = {k: getattr(graphed_call, k) for k in segment_counters}
    assert warm == {"graph_captures": 1, "graph_calls": 1, "eager_calls": 0}, warm
    for k in segment_counters:
        setattr(graphed_call, k, 0)
    torch.cuda.reset_peak_memory_stats()
    fca.reset_launches()
    mg.sparse_row_gather.launches = 0
    da.ms_deform_attn.launches = da.ms_deform_attn.plain_calls = 0
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
    fused["launches_by_path"] = {"infer": da.ms_deform_attn.launches}
    log(f"[main] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"flash_shared_kv_cross_attn launches {launches} for {len(images)} images "
        f"({by_variant}); sparse_row_gather launches {mg.sparse_row_gather.launches}; "
        f"ms_deform_attn launches {da.ms_deform_attn.launches}, plain calls "
        f"{da.ms_deform_attn.plain_calls}")
    check_variants(by_variant, len(images))
    check_msda_launches(model, len(images))
    for res in results:
        check_result(res, (H, W))
    # the LLM's trips replayed from CUDA graphs, the warm-up's capture included
    counts = {k: getattr(greedy_decode, k) for k in decode_counters}
    log(f"[main] greedy_decode {counts}")
    assert counts["eager_trips"] == 0 and counts["graph_trips"] > 0, counts
    assert counts["graph_captures"] == 1, counts
    # the segmenter replayed from its graph: one call an image, nothing captured anew
    seg_counts = {k: getattr(graphed_call, k) for k in segment_counters}
    log(f"[main] graphed_call {seg_counts} (after the warm-up's capture)")
    assert seg_counts == {"graph_captures": 0, "graph_calls": len(images),
                          "eager_calls": 0}, seg_counts

    # ---- 5. kernel times on the main path's own inputs; the head with the
    # plain attention forced, against the kernel
    img = torch.as_tensor(images[0]).cuda()
    seg, enc_calls = msda_calls(lambda: model.segment(img))
    msda = enc_calls[0][:4]
    own = model.fuse_select(seg, hws[0])
    (_, prefix, pmask), calls = kernel_calls(lambda: model.tail_pre(seg["mask_features"], *own))
    check_graph_decode(model, prefix, pmask)
    log("[kernel] timing on image 0's first Q-Former layer, as phase 4 ran it")
    time_kernel(torch, fca, *calls[0], skv)
    log("[gather] timing on level 0 of image 0's first pixel-decoder encoder layer")
    time_gather(torch, mg, msda, gat)
    log("[msda] timing on image 0's first encoder call, and on a 1024x1344 image's")
    time_msda(torch, model, enc_calls, fused)
    phase_head_parity(torch, model, seg["mask_features"], synthetic_objects(model, seg, own))
    del model, seg, own, calls, msda, enc_calls
    torch.cuda.empty_cache()

    # ---- 6. the deployment path
    phase_deployment(torch, skv, gat, fused)
    torch.cuda.empty_cache()

    # ---- 7. the tool path
    phase_tool(torch, skv, gat)
    torch.cuda.empty_cache()

    # ---- 8. training
    phase_train_tiny(torch)
    for quant in ("weight_only", "act_int8"):
        phase_train_tiny(torch, quant)
    train_metrics = phase_train(torch, skv, gat)
    phase_train_int8(torch, skv)
    torch.cuda.empty_cache()

    # ---- 9. published-format weights and tokenizers
    phase_weights(torch, skv, gat)

    # ---- 10. the closed-set v1-v3 family
    phase_family(torch, skv, gat)

    # ---- 11. the family's training, segmenter training, the selfcheck;
    # ---- 12. serving, predict, PVSG frames and the open-set selfcheck
    import shutil
    import tempfile

    selfcheck_root = tempfile.mkdtemp(prefix="chip_smoke_selfcheck_")
    try:
        learned = phase_training_family(torch, skv, gat, selfcheck_root)
        deploy = phase_serving(torch, skv, gat, learned)
    finally:
        shutil.rmtree(selfcheck_root, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- 13. parallelism on the card
    phase_parallel(torch, skv, gat, train_metrics, deploy)
    torch.cuda.empty_cache()

    # ---- 14. the measurement tools
    phase_bench_tools(torch, skv, gat, deploy)
    del deploy
    log(f"[smoke] all phases in {time.perf_counter() - t_start:.1f} s")

    for k in (skv, gat):
        for path in ("serve", "serve_learned", "predict", "pvsg", "openset", "knobs",
                     "infer_batch_tool", "infer_batch_dp", "pair_sharded", "serve_dp",
                     "bench_stages", "probe_msda", "bench_train", "bench_family"):
            assert path in k["launches_by_path"], (k["name"], path)
        k["launches"] = sum(k["launches_by_path"].values())
        for key in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms"):
            assert key in k, key
    for key in ("variant", "simple_ms", "library_other_ms", "hopper_registers"):
        assert key in skv, key
    fused["launches"] = sum(fused["launches_by_path"].values())
    log(json.dumps({"kernels": [skv, gat, fused]}))
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


def msda_calls(fn):
    """Run ``fn()``, a ``segment`` call, on the main path (replayed from the
    segmenter's CUDA graph on the card), then once more eagerly with the
    segmenter's ``ms_deform_attn`` recorded, and require the two results to
    be equal bit for bit → (the main path's result, the arguments of every
    call in order: value, spatial shapes, locations, weights and points per
    level; the pixel decoder's encoder layers first, then the query
    decoder's).  A hook on every module keeps the second call off the
    graphs, which run no Python."""
    import torch

    import openpsg_tpu_torch.models.segmenter.deform_layers as dl

    res = fn()
    real, calls = dl.ms_deform_attn, []

    def record(*args, **kw):
        calls.append(args[:4] + (kw.get("points_per_level"),))
        return real(*args, **kw)

    dl.ms_deform_attn = record
    try:
        with segmenter_eager():
            recorded_res = fn()
    finally:
        dl.ms_deform_attn = real
    if not same_bits(torch, res, recorded_res):
        raise AssertionError("segment on the main path differs from its eager call")
    log(f"[msda] segment on the main path equals its eager call bit for bit "
        f"({len(calls)} ms_deform_attn calls recorded)")
    return res, calls


@contextlib.contextmanager
def segmenter_eager():
    """A no-op forward hook on every module for the block: ``segment`` then
    runs eagerly (``utils/graphs.GraphKeeper.of``), so Python that records
    calls inside the segmenter sees each one; its graphs run no Python."""
    import torch.nn as nn

    handle = nn.modules.module.register_module_forward_hook(lambda mod, args, out: None)
    try:
        yield
    finally:
        handle.remove()


def same_bits(torch, a, b) -> bool:
    """Equal structure, and equal bytes in every tensor leaf."""
    from torch.utils._pytree import tree_flatten

    (la, sa), (lb, sb) = tree_flatten(a), tree_flatten(b)
    return sa == sb and all(
        torch.equal(x.contiguous().view(-1).view(torch.uint8),
                    y.contiguous().view(-1).view(torch.uint8))
        if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))


def first_msda_call(fn):
    """:func:`msda_calls` → (the result, the first call's value, spatial
    shapes, locations and weights: the first pixel-decoder encoder layer's)."""
    res, calls = msda_calls(fn)
    return res, calls[0][:4]


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


def msda_agreement(torch, got, want):
    """→ (largest difference, whether every element of the kernel's output
    ``got`` lies within one step of its type of the plain version's ``want``
    plus 2^-16 of ``want``'s largest magnitude).  Both round one float32 sum
    of the same products, taken in another order, to the output type."""
    want_f = want.float()
    diff = (got.float() - want_f).abs()
    slack = 2.0 ** -16 * float(want_f.abs().max())
    big = torch.maximum(got.float().abs(), want_f.abs()).clamp_min(1e-30)
    step = (torch.exp2(torch.floor(torch.log2(big))) * torch.finfo(want.dtype).eps
            if want.dtype == torch.bfloat16 else torch.zeros_like(big))
    return float(diff.max()), bool((diff <= step + slack).all()) and got.shape == want.shape


def phase_msda(torch, results):
    """Phase 3: the fused ``ms_deform_attn`` kernel against its plain
    version (:func:`msda_agreement`), float32 and bf16, one launch a call:
    the 1344² encoder's 4 levels, 300 decoder queries at B = 2, points per
    level 2,2,2,4, levels of height or width 1 and 2 with locations outside
    [0, 1], and the tiny segmenter's head of 4 channels."""
    from openpsg_tpu_torch.ops import deform_attn as da

    gen = torch.Generator(device="cuda").manual_seed(2)
    enc = ((168, 168), (84, 84), (42, 42), (21, 21))
    cases = (  # name, levels, Lq (None: Lv), B, hd, points per level, location range
        ("1344^2 encoder", enc, None, 1, 32, None, (0.0, 1.0)),
        ("300 decoder queries, B=2", enc, 300, 2, 32, None, (0.0, 1.0)),
        ("points 2,2,2,4", enc, 5000, 1, 32, (2, 2, 2, 4), (0.0, 1.0)),
        ("levels of 1 and 2, outside [0, 1]", ((1, 5), (3, 1), (2, 2), (1, 1)), 77, 2, 32,
         (4, 1, 3, 2), (-0.5, 1.5)),
        ("head of 4", ((8, 6), (4, 3), (2, 2)), 23, 1, 4, None, (-0.25, 1.25)),
    )
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, shapes, Lq, B, hd, ppl, (lo, hi) in cases:
            L, Lv = len(shapes), sum(h * w for h, w in shapes)
            Lq = Lv if Lq is None else Lq
            value = torch.randn(B, Lv, 8, hd, generator=gen, device="cuda").to(dtype)
            loc = torch.rand(B, Lq, 8, L, 4, 2, generator=gen, device="cuda") * (hi - lo) + lo
            aw = torch.softmax(torch.randn(B, Lq, 8, L * 4, generator=gen, device="cuda"),
                               -1).view(B, Lq, 8, L, 4)
            before = da.ms_deform_attn.launches
            got = da.ms_deform_attn(value, shapes, loc, aw, ppl)
            torch.cuda.synchronize()
            e, ok = msda_agreement(torch, got, da.ms_deform_attn_plain(value, shapes, loc, aw,
                                                                       ppl))
            ok = ok and da.ms_deform_attn.launches == before + 1
            log(f"[msda] {str(dtype).split('.')[-1]} {name} (B={B} Lq={Lq} hd={hd}): "
                f"max_abs_err={e:.3e}, one launch {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"ms_deform_attn kernel disagrees with plain on {name}")
            err = max(err, e)
    results["max_abs_err"] = err


def check_msda_launches(model, n_images):
    """One kernel launch per deformable layer per image, no plain call."""
    from openpsg_tpu_torch.ops import deform_attn as da

    sc = model.cfg.segmenter
    want = (sc.enc_layers + sc.dec_layers) * n_images
    got = (da.ms_deform_attn.launches, da.ms_deform_attn.plain_calls)
    if got != (want, 0):
        raise AssertionError(f"ms_deform_attn (launches, plain calls) {got}, want ({want}, 0)")


def time_msda(torch, model, calls, results):
    """Phase 5: the fused kernel's time and the plain version's, in turns
    (:func:`time_turns`), beside the op's bound (the probe's ``op_bound``),
    on the main path's own inputs: ``calls`` (image 0's, 1344²: PR 13's
    probe shape) give the first encoder and decoder calls; a seeded
    1024x1344 image (the benchmark's bucket) gives its first encoder call,
    the same with its first 3 levels (the v1 cell's), and its first decoder
    call.  No single PyTorch call computes this op: ``library_ms`` is none."""
    import numpy as np

    from openpsg_tpu_torch.ops import deform_attn as da
    from openpsg_tpu_torch.tools.probe_msda_variants import op_bound

    Q = model.cfg.segmenter.num_queries
    img = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (1024, 1344, 3))
                          .astype(np.uint8), device="cuda")
    _, cell = msda_calls(lambda: model.segment(img))
    first_decoder = lambda cs: next(c for c in cs if c[2].shape[1] == Q)  # noqa: E731
    v, shapes, loc, aw, ppl = cell[0]
    n3 = sum(h * w for h, w in shapes[:3])
    v1_levels = (v[:, :n3].contiguous(), shapes[:3], loc[:, :n3, :, :3].contiguous(),
                 aw[:, :n3, :, :3].contiguous(), None if ppl is None else ppl[:3])
    cases = {"encoder_1344x1344": calls[0], "decoder_1344x1344": first_decoder(calls),
             "encoder_1024x1344": cell[0], "encoder_1024x1344_3_levels": v1_levels,
             "decoder_1024x1344": first_decoder(cell)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for name, (value, shapes, loc, aw, ppl) in cases.items():
        def kernel(a=(value, shapes, loc, aw, ppl)):
            return da.ms_deform_attn(*a)

        def plain(a=(value, shapes, loc, aw, ppl)):
            return da.ms_deform_attn_plain(*a)

        err, ok = msda_agreement(torch, kernel(), plain())
        if not ok:
            raise AssertionError(f"ms_deform_attn kernel disagrees with plain on {name}")
        t = time_turns({"ms": kernel, "plain_ms": plain})
        kpl = ppl or (loc.shape[4],) * loc.shape[3]
        bound, by, nbytes = op_bound(value, loc, kpl)
        plan = da.launch_plan(value.dtype, value.shape[3],
                              value.shape[0] * loc.shape[1] * value.shape[2], len(kpl), sms)
        out[name] = {"Lq": loc.shape[1], "levels": [list(x) for x in shapes],
                     "points_per_level": list(kpl), "ms": t["ms"][0],
                     "ms_iqr": [t["ms"][1], t["ms"][2]], "plain_ms": t["plain_ms"][0],
                     "bound_ms": bound, "bound_by": by, "of_bound": bound / t["ms"][0],
                     "max_abs_err": err, "plan_G_P_threads": list(plan)}
        log(f"[msda] {name} (Lq {loc.shape[1]}, levels {list(shapes)}, points {list(kpl)}, "
            f"{value.dtype}; plan G, P, threads {plan}): ms {t['ms'][0]:.4f} (IQR "
            f"{t['ms'][1]:.4f}-{t['ms'][2]:.4f}), plain_ms {t['plain_ms'][0]:.4f} (IQR "
            f"{t['plain_ms'][1]:.4f}-{t['plain_ms'][2]:.4f}); bound_ms {bound:.4f} ({by}, "
            f"{nbytes / 1e6:.1f} MB); {bound / t['ms'][0]:.1%} of the bound; library none; "
            f"max_abs_err {err:.3e}")
    results["shapes"] = out
    main = out["encoder_1344x1344"]
    results.update({k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
    results["library"], results["library_ms"] = "none: no single PyTorch call computes it", None
    results["max_abs_err"] = max([results["max_abs_err"]] + [e["max_abs_err"]
                                                             for e in out.values()])


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


def phase_deployment(torch, skv, gat, fused):
    """Phase 6: ``QDense`` on the card against the CPU; ``infer_microbatch``
    at full ``baseline_v4_ov_w8a8`` width on 4 seeded images (warm-up, then
    one timed call), then ``infer`` on each image with the same int8 model,
    teacher-forced on the micro-batch's tokens, and the two compared."""
    import numpy as np

    from openpsg_tpu_torch.models.detectors.psg_v4 import AUTO_MB_SIZE, PSGv4, PSGv4Config
    from openpsg_tpu_torch.ops import deform_attn as da, flash_cross_attn as fca, msda_gather as mg

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
    da.ms_deform_attn.launches = da.ms_deform_attn.plain_calls = 0
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
    fused["launches_by_path"]["infer_microbatch"] = da.ms_deform_attn.launches
    check_msda_launches(model, N)
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


def write_png_fixture(root, sizes, seed=0, train_sizes=()):
    """Images (three coloured regions plus noise), GT panoptic PNGs with
    three segments (person, dog, sky) and two relations, which form the
    json's test split; then ``train_sizes`` train images, each a grid of
    4-12 segments of seeded classes (things and stuff) in their own colours
    with 2-6 seeded relations.  Written by the port's PNG codec → the json's
    path."""
    import numpy as np

    from openpsg_tpu_torch.data.vocab import NUM_THING_CLASSES
    from openpsg_tpu_torch.utils.image_io import encode_png_rgb, write_png
    from openpsg_tpu_torch.utils.panoptic import id2rgb

    rng = np.random.default_rng(seed)
    colours = np.asarray([[200, 60, 60], [60, 200, 60], [60, 60, 200]])
    data = []

    def write(i, img, pan, segments, relations):
        write_png(os.path.join(root, f"{i}.png"),
                  encode_png_rgb(np.clip(img, 0, 255).astype(np.uint8)))
        write_png(os.path.join(root, f"pan{i}.png"), encode_png_rgb(id2rgb(pan)))
        h, w = pan.shape
        data.append(dict(image_id=str(i), file_name=f"{i}.png", pan_seg_file_name=f"pan{i}.png",
                         height=h, width=w, relations=relations, segments_info=segments))

    for i, (h, w) in enumerate(sizes):
        pan = np.full((h, w), 7003)
        pan[: h // 2, : w // 2], pan[: h // 2, w // 2:] = 7001, 7002
        img = colours[pan - 7001] + rng.integers(-30, 30, (h, w, 3))
        write(i, img, pan, [dict(id=7001, category_id=0, isthing=1),
                            dict(id=7002, category_id=16, isthing=1),
                            dict(id=7003, category_id=119, isthing=0)], [[0, 2, 4], [1, 0, 23]])
    test_ids = [d["image_id"] for d in data]
    for j, (h, w) in enumerate(train_sizes):
        n = int(rng.integers(4, 13))
        rows = int(np.ceil(np.sqrt(n)))
        cols = -(-n // rows)
        cell = (np.arange(h)[:, None] * rows // h) * cols + np.arange(w)[None, :] * cols // w
        cell = np.minimum(cell, n - 1)
        cats = rng.integers(0, 133, n)
        palette = rng.integers(30, 226, (n, 3))
        img = palette[cell] + rng.integers(-30, 30, (h, w, 3))
        subj = rng.integers(0, n, int(rng.integers(2, 7)))
        relations = [[int(s), int((s + rng.integers(1, n)) % n), int(rng.integers(0, 56))]
                     for s in subj]
        write(len(sizes) + j, img, 9001 + cell,
              [dict(id=9001 + k, category_id=int(c), isthing=int(c < NUM_THING_CLASSES))
               for k, c in enumerate(cats)], relations)
    path = os.path.join(root, "psg.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(dict(data=data, test_image_ids=test_ids), f)
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


def phase_train_tiny(torch, quant=None):
    """Phase 8a: one training step of the tiny config (float32) on the card
    against the CPU, on the same weights and the same seeded batch: the
    losses (TOL_TRAIN_LOSS), every head gradient leaf (TOL_TRAIN_GRAD) and
    the values after the optimizer step (TOL_TRAIN_UPDATE).  The step must
    launch no shared-KV kernel (gradients run the plain attention, as in
    the JAX package) and get a nonzero gradient through the
    cross-attention's key projection.  ``quant``: train through an int8
    LLM instead, "weight_only" or "act_int8", with 8 LLM pairs per image
    so that teacher forcing feeds every ``QDense`` at least 256 rows (the
    int8-activation rule's regime; its input gradient flows only through
    the per-token scale, as in the JAX package)."""
    import dataclasses

    import numpy as np

    from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config
    from openpsg_tpu_torch.models.llm.llama import QDense
    from openpsg_tpu_torch.ops import flash_cross_attn as fca
    from openpsg_tpu_torch.train.trainer import (
        TrainBatch,
        V4Trainer,
        host_batch,
        make_lr_schedule,
        make_optimizer,
    )

    cfg = PSGv4Config.tiny_test()
    if quant:
        cfg = dataclasses.replace(
            cfg, llm=dataclasses.replace(cfg.llm, quant=True, act_int8=quant == "act_int8"),
            head=dataclasses.replace(cfg.head, max_llm_forward_num=8))
    tag = f"train-tiny{'-' + quant if quant else ''}"
    cpu = PSGv4(cfg, seed=3, device="cpu")
    gpu = PSGv4(cfg, seed=3, device="cuda")
    for part in ("segmenter", "head", "llm", "text"):
        getattr(gpu, part).load_state_dict(getattr(cpu, part).state_dict())
    gpu.class_embeds = cpu.class_embeds.cuda()
    c = cpu.cfg
    M, R = c.head.max_objects_padded, c.head.num_relation_classes
    rng = np.random.default_rng(8)
    examples = []
    for b in range(2):
        valid = np.arange(M) < 5 - b
        t = np.zeros((M, M, R), np.float32)
        t[0, 1, 3] = t[0, 1, 10] = t[2, 0, 10] = t[3, 1, 4] = 1
        examples.append(dict(
            image=rng.integers(0, 255, (64, 64, 3)).astype(np.float32),
            object_masks=(rng.random((M, 16, 16)) > 0.7) & valid[:, None, None],
            object_labels=rng.integers(0, 133, M).astype(np.int32),
            object_valid=valid, relation_target=t))
    arrays = host_batch(examples, cpu.tokenizer, cpu.relation_names, rng,
                        c.head.sampled_qformer_batch_size, c.head.max_llm_forward_num, 12)
    runs, rows = {}, []
    for side, m in (("cpu", cpu), ("card", gpu)):
        tr = V4Trainer(m)
        fca.reset_launches()
        hooks = [q.register_forward_hook(lambda mod, inp, out: rows.append(
            inp[0].reshape(-1, inp[0].shape[-1]).shape[0]))
            for q in m.llm.modules() if isinstance(q, QDense) and side == "card"]
        losses, grads = tr.gradients(TrainBatch.from_numpy(arrays, m.device))
        for h in hooks:
            h.remove()
        opt = make_optimizer(make_lr_schedule(steps_per_epoch=10))
        opt.step(tr.master, grads, opt.init(tr.master))
        if side == "card":
            torch.cuda.synchronize()
            launches = dict(fca.flash_shared_kv_cross_attn.launches_by_variant)
        runs[side] = ({k: float(v) for k, v in losses.items()},
                      {n: g.cpu() for n, g in grads.items()},
                      {n: v.detach().cpu() for n, v in tr.master.items()})
    if quant and not (rows and min(rows) >= QDense.ACT_INT8_MIN_ROWS):
        raise AssertionError(f"{tag}: QDense saw {sorted(set(rows))} rows, not all >= "
                             f"{QDense.ACT_INT8_MIN_ROWS}")
    loss_err, grad_err, zero_leaves, upd_err = step_agreement(runs)
    l_card, g_cpu, g_card = runs["card"][0], runs["cpu"][1], runs["card"][1]
    cross = float(g_card["head.qformer.cross_attn0.k.weight"].abs().sum())
    ok = (loss_err <= TOL_TRAIN_LOSS and grad_err <= TOL_TRAIN_GRAD
          and upd_err <= TOL_TRAIN_UPDATE and launches == {"simple": 0, "hopper": 0}
          and cross > 0)
    log(f"[{tag}] one step, B=2, card vs CPU"
        + (f" (int8 LLM, {quant}; QDense rows {sorted(set(rows))})" if quant else "")
        + f": losses {l_card} (largest relative "
        f"difference {loss_err:.3e}, tol {TOL_TRAIN_LOSS:g}); {len(g_cpu)} head gradient "
        f"leaves, largest difference relative to the leaf {grad_err:.3e} (tol "
        f"{TOL_TRAIN_GRAD:g}; {len(zero_leaves)} leaves 0 up to roundoff: {zero_leaves}); "
        f"values after the update within {upd_err:.3e} (tol {TOL_TRAIN_UPDATE:g}); "
        f"shared-KV launches {launches}; |grad cross_attn0.k.weight| sum {cross:.4e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: the tiny train step on the card disagrees with the CPU")


# COCO sizes (h, w) of phase 8's fixture: 8 train images, 4 val images
TRAIN_SIZES = [(640, 480), (480, 640), (427, 640), (640, 427), (500, 375), (375, 500),
               (640, 640), (612, 612)]
VAL_SIZES = [(640, 640), (480, 640), (640, 480), (427, 640)]


def phase_train(torch, skv, gat):
    """Phase 8b and 8c: the train tool at full ``baseline_v4_ov`` width
    (bf16 Llama-2-7B frozen, the head trained) on a PNG fixture of 8 train
    and 4 val images, 8 steps with validation; the checks listed in the
    module docstring; the restore through the infer tool's ``exp_tag
    epoch`` layout; then 4 more steps with ``--stage-times`` for the
    split."""
    import shutil
    import tempfile

    import numpy as np

    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config
    from openpsg_tpu_torch.ops import flash_cross_attn as fca, msda_gather as mg
    from openpsg_tpu_torch.tools import eval_pq, grade, infer, train
    from openpsg_tpu_torch.train.checkpoint import PartCheckpointer
    from openpsg_tpu_torch.train.trainer import V4Trainer

    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    cwd = os.getcwd()
    real_step = V4Trainer.train_step
    try:
        ann = write_png_fixture(root, VAL_SIZES, seed=1, train_sizes=TRAIN_SIZES)
        tag = "smoke"
        cfg_path = os.path.join(root, f"{tag}.py")
        split = f"dict(ann_file={ann!r}, img_prefix={root!r}, seg_prefix={root!r})"
        with open(cfg_path, "w", encoding="utf-8") as f:
            f.write(f"_base_ = [{os.path.join(HERE, 'openpsg_tpu_torch/configs/psg/baseline_v4_ov.py')!r}]\n"
                    f"data = dict(train={split}, val={split}, test={split})\n"
                    "runner = dict(max_epochs=1)\nlog_config = dict(interval=1)\n")
        model = build_detector_from_config(Config.fromfile(cfg_path), seed=0)
        groups = model.param_groups()
        frozen = {g: {n: t.detach().cpu() for n, t in groups[g].items()}
                  for g in ("segmenter", "llm", "text", "class_embeds")}
        head_before = {n: t.detach().clone() for n, t in groups["head"].items()}

        step_launches = []

        def counted(self, *a, **kw):
            before = fca.flash_shared_kv_cross_attn.launches
            out = real_step(self, *a, **kw)
            step_launches.append(fca.flash_shared_kv_cross_attn.launches - before)
            return out

        V4Trainer.train_step = counted
        wd = os.path.join(root, "work_dirs", f"ov_psg_{tag}")
        torch.cuda.synchronize()
        fca.reset_launches()
        mg.sparse_row_gather.launches = 0
        t0 = time.perf_counter()
        stats = train.main([cfg_path, "--work-dir", wd, "--max-steps", "8", "--validate",
                            "--val-limit", "4"], model=model)
        wall = time.perf_counter() - t0
        V4Trainer.train_step = real_step
        by_variant = dict(fca.flash_shared_kv_cross_attn.launches_by_variant)
        skv["launches_by_path"]["train_steps"] = sum(step_launches)
        skv["launches_by_path"]["train_validate"] = (fca.flash_shared_kv_cross_attn.launches
                                                     - sum(step_launches))
        skv["launches_by_variant"]["train"] = by_variant
        gat["launches_by_path"]["train"] = mg.sparse_row_gather.launches
        n_val = len(VAL_SIZES)
        if stats["steps"] != 8 or step_launches != [0] * 8:
            raise AssertionError(f"{stats['steps']} steps, shared-KV launches per step "
                                 f"{step_launches}: expected 8 steps launching none")
        check_variants(by_variant, n_val)
        values = [v for m in stats["metrics"] for v in m.values()]
        if len(stats["metrics"]) != 8 or not all(np.isfinite(values)):
            raise AssertionError(f"logged metrics not finite: {stats['metrics']}")
        changed = sum(not torch.equal(t, head_before[n]) for n, t in groups["head"].items())
        same = {g: all(torch.equal(groups[g][n].detach().cpu(), t) for n, t in d.items())
                for g, d in frozen.items()}
        if not changed or not all(same.values()):
            raise AssertionError(f"head tensors changed {changed}; frozen unchanged {same}")
        ckpt = PartCheckpointer(os.path.join(wd, "ckpts"))
        params, opt_state, meta, step = ckpt.restore()
        step_dir = os.path.join(ckpt.directory, f"step_{step}")
        sizes = {f: os.path.getsize(os.path.join(step_dir, f)) for f in sorted(os.listdir(step_dir))}
        if ({n.split(".")[0] for n in params} != {"head"} or set(opt_state["mu"]) != set(params)
                or set(params) != {f"head.{n}" for n in groups["head"]} or step != 8
                or meta.get("epoch") != 1):
            raise AssertionError(f"checkpoint step {step} holds {len(params)} tensors of groups "
                                 f"{ {n.split('.')[0] for n in params} }")
        kept = [n for n, t in groups["head"].items() if torch.equal(t, head_before[n])]
        moved = sum(not torch.equal(params[f"head.{n}"], t.float().cpu())
                    for n, t in head_before.items())
        st = stats["step_seconds"]
        med = statistics.median(st[1:])
        first = stats["metrics"][0]
        last = stats["metrics"][-1]
        log(f"[train] tools.train.main, baseline_v4_ov (bf16 Llama-2-7B frozen, head trained), "
            f"{len(TRAIN_SIZES)} train images at COCO sizes, B=1: {stats['steps']} steps + "
            f"validation of {n_val} images in {wall:.1f} s; step seconds "
            + ", ".join(f"{t:.3f}" for t in st) + f"; median of steps 2-8 {med:.3f} s/step "
            f"({1 / med:.3f} steps/s); peak memory {stats['peak_memory_bytes'] / 2**30:.2f} GiB "
            f"(training and validation); loss {first['loss']:.4f} -> {last['loss']:.4f}, "
            f"rel_llm_loss {first['rel_llm_loss']:.4f} -> {last['rel_llm_loss']:.4f}, grad_norm "
            f"{first['grad_norm']:.4f} -> {last['grad_norm']:.4f}; bf16 head tensors changed "
            f"{changed}/{len(head_before)} (unchanged: {kept}), float32 master values moved "
            f"{moved}/{len(head_before)}; frozen groups bitwise unchanged {same}; shared-KV "
            f"launches {step_launches} in the steps, {by_variant} in all (validation: 2 per "
            f"image); val {stats['val'][0]}")
        log(f"[train] checkpoint step {step} (epoch {meta['epoch']}): {len(params)} head tensors, "
            f"{sum(v.numel() for v in params.values())} float32 values, optimizer moments for the "
            f"same; files " + ", ".join(f"{f} {b / 2**20:.1f} MiB" for f, b in sizes.items())
            + f"; total {sum(sizes.values()) / 2**20:.1f} MiB")

        # 8c: restore through the infer tool (exp_tag epoch layout) into a
        # head reset to its initial values
        trained = {n: t.detach().clone() for n, t in groups["head"].items()}
        with torch.no_grad():
            for n, t in groups["head"].items():
                t.copy_(head_before[n])
        os.chdir(root)
        out = os.path.join(root, "out")
        fca.reset_launches()
        i_stats = infer.main([tag, "1", "--test-file", ann, "--data-dir", root, "--output-dir",
                              out, "--limit", str(n_val)], model=model)
        os.chdir(cwd)
        skv["launches_by_path"]["train_restore_infer"] = fca.flash_shared_kv_cross_attn.launches
        check_variants(dict(fca.flash_shared_kv_cross_attn.launches_by_variant), n_val)
        restored = all(torch.equal(t, trained[n]) for n, t in groups["head"].items())
        if not restored or i_stats["n_images"] != n_val:
            raise AssertionError(f"restored head bitwise equal: {restored}; "
                                 f"{i_stats['n_images']} images")
        grading = ["--submission", out, "--gt-json", ann, "--data-dir", root]
        log(f"[train] infer tool, '{tag} 1' (exp_tag epoch layout): restored head bitwise equal "
            f"to the trained one; {n_val} images in {i_stats['seconds']:.2f} s; graded "
            f"{json.dumps(grade.main(grading))} {json.dumps(eval_pq.main(grading))}")

        # the split: 4 more steps with --stage-times (the card synchronized
        # around each stage), training only
        s_stats = train.main([cfg_path, "--work-dir", os.path.join(root, "wd_split"),
                              "--max-steps", "4", "--stage-times"], model=model)
        rows = s_stats["stage_ms"][1:]
        split = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
        s_med = statistics.median(s_stats["step_seconds"][1:]) * 1e3
        log(f"[train] step split, --stage-times, median of steps 2-4 (ms): "
            + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
            + f"; stages sum {sum(split.values()):.1f}, step {s_med:.1f}; peak memory "
            f"{s_stats['peak_memory_bytes'] / 2**30:.2f} GiB (training only)")
        log("[train] stats " + json.dumps(dict(
            step_seconds=st, median_step_seconds=med, steps_per_second=1 / med,
            peak_memory_gib=stats["peak_memory_bytes"] / 2**30,
            peak_memory_train_only_gib=s_stats["peak_memory_bytes"] / 2**30,
            split_ms=split, split_step_ms=s_med, checkpoint_bytes=sizes,
            metrics=stats["metrics"], val=stats["val"])))
        return stats["metrics"]
    finally:
        V4Trainer.train_step = real_step
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)


def phase_train_int8(torch, skv):
    """Phase 8d: ``openpsg_tpu_torch.tools.train.main`` at full
    ``baseline_v4_ov`` width through the int8 Llama-2-7B (``--cfg-options
    tpu.llm_int8=True``: weight-only, bf16 activations, the card's
    ``mm_f32``'s ``out_dtype`` product under autograd), the model built
    by the tool itself, 2 steps on 2 of phase 8's train images: finite
    losses, no shared-KV launch; s/step and peak memory."""
    import shutil
    import tempfile

    import numpy as np

    from openpsg_tpu_torch.ops import flash_cross_attn as fca
    from openpsg_tpu_torch.tools import train

    root = tempfile.mkdtemp(prefix="chip_smoke_train_int8_")
    try:
        ann = write_png_fixture(root, VAL_SIZES[:1], seed=2, train_sizes=TRAIN_SIZES[:2])
        cfg_path = os.path.join(root, "int8.py")
        split = f"dict(ann_file={ann!r}, img_prefix={root!r}, seg_prefix={root!r})"
        with open(cfg_path, "w", encoding="utf-8") as f:
            f.write(f"_base_ = [{os.path.join(HERE, 'openpsg_tpu_torch/configs/psg/baseline_v4_ov.py')!r}]\n"
                    f"data = dict(train={split}, val={split}, test={split})\n"
                    "runner = dict(max_epochs=1)\nlog_config = dict(interval=1)\n")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fca.reset_launches()
        t0 = time.perf_counter()
        stats = train.main([cfg_path, "--work-dir", os.path.join(root, "wd"), "--max-steps", "2",
                            "--cfg-options", "tpu.llm_int8=True"])
        wall = time.perf_counter() - t0
        launches = fca.flash_shared_kv_cross_attn.launches
        skv["launches_by_path"]["train_int8_steps"] = launches
        values = [v for m in stats["metrics"] for v in m.values()]
        if stats["steps"] != 2 or launches or not all(np.isfinite(values)):
            raise AssertionError(f"int8 training: {stats['steps']} steps, {launches} shared-KV "
                                 f"launches, metrics {stats['metrics']}")
        st = stats["step_seconds"]
        log(f"[train-int8] tools.train.main, baseline_v4_ov with --cfg-options tpu.llm_int8=True "
            f"(int8 Llama-2-7B frozen, head trained, built by the tool), B=1: {stats['steps']} "
            f"steps in {wall:.1f} s with the build; step seconds "
            + ", ".join(f"{t:.3f}" for t in st) + f" (second step {st[-1]:.3f} s/step); peak "
            f"memory {stats['peak_memory_bytes'] / 2**30:.2f} GiB; loss "
            f"{stats['metrics'][0]['loss']:.4f} -> {stats['metrics'][-1]['loss']:.4f}, "
            f"rel_llm_loss {stats['metrics'][-1]['rel_llm_loss']:.4f}; shared-KV launches "
            f"{launches}")
        log("[train-int8] stats " + json.dumps(dict(
            step_seconds=st, peak_memory_gib=stats["peak_memory_bytes"] / 2**30,
            metrics=stats["metrics"])))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_weights(torch, skv, gat):
    """Phase 9: the weights slice at full ``baseline_v4_ov`` width, from
    seeded checkpoints in the published layouts (nothing is downloaded):
    an OpenSeeD ``.pt`` (Swin-T, the 6-layer pixel decoder, the 300-query
    9-layer decoder, the 12-layer CLIP text tower and ``lang_proj``), a toy
    CLIP merges file, a toy SentencePiece ``.model``, and a reference v4
    ``PartCheckpointHook`` ``.pth`` at full Q-Former width.  The port's
    ``convert_openseed`` and ``convert_relation`` convert them; the infer
    tool runs a config naming the converted segmenter, the class
    embeddings and the tokenizer, with ``--checkpoint`` and ``--vis``, on 4
    of phase 7's images.  Checks: every segmenter and head tensor on the
    card equals the converted value cast to the module's dtype; the raw
    ``.pt`` loads the same tensors; 2 hopper launches per image; 4
    overlays and 4 tables; a graded submission.  Then an HF Llama-2-7B
    state at full width cut to 2 layers (as ``llm_truncate_num`` does),
    saved as bf16, loaded, converted and quantized: its last-token logits
    on the card against the CPU within TOL_LOGIT_REL."""
    import dataclasses
    import io
    import shutil
    import tempfile

    import numpy as np

    import openpsg_tpu_torch.core.builder as builder
    from openpsg_tpu_torch.core.config import Config
    from openpsg_tpu_torch.data.vocab import OBJECT_CLASSES, RELATION_CLASSES, clean_name
    from openpsg_tpu_torch.models.detectors.psg_v4 import LLM_INSTRUCTION, QFORMER_INSTRUCTION
    from openpsg_tpu_torch.models.llm import weight_convert as lw
    from openpsg_tpu_torch.models.llm.llama import LlamaConfig, LlamaWithEmbeddings
    from openpsg_tpu_torch.models.relation.sp_tokenizer import (
        build_sp_model_bytes,
        build_toy_llama_tokenizer,
    )
    from openpsg_tpu_torch.models.segmenter.openseed import SegmenterConfig
    from openpsg_tpu_torch.ops import flash_cross_attn as fca, msda_gather as mg
    from openpsg_tpu_torch.tools import convert_openseed, convert_relation, grade, infer
    from openpsg_tpu_torch.utils import synthetic_weights as syn

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_weights_")
    real_build = builder.build_detector_from_config
    try:
        t0 = time.perf_counter()
        ann = write_png_fixture(root, TOOL_SIZES[:4])          # phase 7's first 4 images
        merges = syn.write_merges(os.path.join(root, "merges.txt"),
                                  syn.toy_clip_merges(OBJECT_CLASSES))
        state = syn.synthetic_openseed_state(SegmenterConfig(), num_lang_layers=12, lang_dim=512,
                                             vocab=49408, seed=11, fan_in=True)
        raw_pt = os.path.join(root, "model_state_dict_swint.pt")
        torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}}, raw_pt)
        n_raw = sum(v.size for v in state.values())
        del state
        words = sorted({w for t in [clean_name(n) for n in OBJECT_CLASSES] + RELATION_CLASSES
                        + [QFORMER_INSTRUCTION, LLM_INSTRUCTION] for w in t.replace("{}", "").split()})
        sp_model = os.path.join(root, "tokenizer.model")
        with open(sp_model, "wb") as f:
            f.write(build_sp_model_bytes(build_toy_llama_tokenizer(words).pieces))
        conv = os.path.join(root, "openseed_converted")
        cfg_path = os.path.join(root, "weights.py")
        with open(cfg_path, "w", encoding="utf-8") as f:
            f.write(f"_base_ = [{os.path.join(HERE, 'openpsg_tpu_torch/configs/psg/baseline_v4_ov.py')!r}]\n"
                    f"model = dict(openseed_pretrained_path={os.path.join(conv, 'segmenter.pt')!r},\n"
                    f"             precomputed_class_embeds={os.path.join(conv, 'class_embeds.npy')!r},\n"
                    f"             relation_head=dict(tokenizer_path={sp_model!r}))\n"
                    f"data = dict(test=dict(ann_file={ann!r}, img_prefix={root!r}))\n")
        head_cfg = builder.resolved_config_from(Config.fromfile(cfg_path))
        rel = syn.synthetic_relation_v4_state(head_cfg.head, head_cfg.segmenter.mask_dim, seed=12,
                                              fan_in=True)
        pth = os.path.join(root, "epoch_1.pth")
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in rel.items()},
                    "meta": {"epoch": 1}}, pth)
        t_inputs = time.perf_counter() - t0
        log(f"[weights] seeded inputs in {t_inputs:.1f} s: OpenSeeD .pt {n_raw:,} values "
            f"({os.path.getsize(raw_pt) / 2**20:.1f} MiB), v4 relation .pth {len(rel)} tensors "
            f"({os.path.getsize(pth) / 2**20:.1f} MiB), toy SentencePiece model of "
            f"{os.path.getsize(sp_model)} bytes, toy CLIP merges")

        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            convert_openseed.main([raw_pt, "--out", conv, "--merges", merges])
        t_seg = time.perf_counter() - t0
        report = [ln for ln in out.getvalue().splitlines() if "level" in ln or "converted" in ln]
        t0 = time.perf_counter()
        ckpt = os.path.join(root, "ckpts")
        with contextlib.redirect_stdout(out):
            convert_relation.main([pth, "--config", cfg_path, "--out", ckpt, "--verify"])
        t_rel = time.perf_counter() - t0
        log(f"[weights] convert_openseed {t_seg:.1f} s (class embeddings on the card), "
            f"convert_relation --verify {t_rel:.1f} s; report: " + " | ".join(report))

        built = []

        def capture(*a, **kw):
            built.append(real_build(*a, **kw))
            return built[-1]

        builder.build_detector_from_config = capture
        vis_dir, sub_dir = os.path.join(root, "vis"), os.path.join(root, "out")
        torch.cuda.synchronize()
        fca.reset_launches()
        mg.sparse_row_gather.launches = 0
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            stats = infer.main(["--config", cfg_path, "--checkpoint", ckpt, "--vis", vis_dir,
                                "--output-dir", sub_dir])
        t_infer = time.perf_counter() - t0
        builder.build_detector_from_config = real_build
        by_variant = dict(fca.flash_shared_kv_cross_attn.launches_by_variant)
        skv["launches_by_path"]["weights"] = fca.flash_shared_kv_cross_attn.launches
        skv["launches_by_variant"]["weights"] = by_variant
        gat["launches_by_path"]["weights"] = mg.sparse_row_gather.launches
        check_variants(by_variant, 4)
        text = printed.getvalue()
        tables = text.count("| subject")
        jpgs = sorted(f for f in os.listdir(vis_dir) if f.endswith("_pan_seg.jpg"))
        if stats["n_images"] != 4 or tables != 4 or len(jpgs) != 4:
            raise AssertionError(f"{stats['n_images']} images, {tables} tables, overlays {jpgs}")

        model = built[0]
        from openpsg_tpu_torch.models.relation.sp_tokenizer import SentencePieceTokenizer

        if not isinstance(model.tokenizer, SentencePieceTokenizer):
            raise AssertionError(f"the LLM tokenizer is {type(model.tokenizer).__name__}")

        def same(module, want, prefix=""):
            """Names of ``module``'s tensors unequal to ``want`` cast to them."""
            sd = module.state_dict()
            names = {k[len(prefix):] for k in want if k.startswith(prefix)}
            if names != set(sd):
                return sorted(names ^ set(sd))
            return [n for n, t in sd.items()
                    if not torch.equal(t, want[prefix + n].to(t.device, t.dtype))]

        seg_file = torch.load(os.path.join(conv, "segmenter.pt"), weights_only=True)
        head_file = torch.load(os.path.join(ckpt, "step_0", "params.pt"), weights_only=True)
        bad_seg, bad_head = same(model.segmenter, seg_file), same(model.head, head_file, "head.")
        emb = torch.from_numpy(np.load(os.path.join(conv, "class_embeds.npy")))
        bad_emb = not torch.equal(model.class_embeds.cpu(), emb)
        loaded = {k: v.clone() for k, v in model.segmenter.state_dict().items()}
        with torch.no_grad():
            for p in model.segmenter.parameters():
                p.zero_()
        with contextlib.redirect_stdout(io.StringIO()):
            model.load_segmenter_weights(raw_pt)
        raw_diff = [n for n, t in model.segmenter.state_dict().items() if not torch.equal(t, loaded[n])]
        dtypes = sorted({str(t.dtype) for t in model.segmenter.state_dict().values()})
        if bad_seg or bad_head or bad_emb or raw_diff:
            raise AssertionError(f"segmenter tensors off {bad_seg[:5]}, head {bad_head[:5]}, class "
                                 f"embeddings off {bad_emb}, raw .pt vs converted {raw_diff[:5]}")
        grading = ["--submission", sub_dir, "--gt-json", ann, "--data-dir", root]
        with contextlib.redirect_stdout(io.StringIO()):
            graded = grade.main(grading)
        lines = text.splitlines()
        top = next(i for i, ln in enumerate(lines) if ln.startswith("| subject"))
        log(f"[weights] tools.infer --config (converted segmenter, class_embeds.npy, SentencePiece "
            f"tokenizer) --checkpoint --vis on 4 images: {t_infer:.1f} s with the build, "
            f"{stats['seconds']:.2f} s for the images; {len(seg_file)} segmenter tensors "
            f"({dtypes}) and {len(head_file)} head tensors on the card equal to the converted "
            f"values; class embeddings equal; the raw .pt loads the same segmenter tensors; "
            f"shared-KV launches {by_variant}; {len(jpgs)} overlays, {tables} tables; graded "
            f"{json.dumps(graded)}")
        log("[weights] first table:\n" + "\n".join(lines[max(top - 2, 0):top + 6]))
        del model, built, loaded
        torch.cuda.empty_cache()

        # the LLM: an HF Llama-2-7B state at full width, 2 layers
        t0 = time.perf_counter()
        lcfg = dataclasses.replace(LlamaConfig.llama2_7b(), n_layers=2)
        hf = syn.synthetic_hf_state(lcfg, seed=13, fan_in=True)
        bin_path = os.path.join(root, "pytorch_model.bin")
        torch.save({k: torch.from_numpy(v).bfloat16() for k, v in hf.items()}, bin_path)
        del hf
        t_make = time.perf_counter() - t0
        t0 = time.perf_counter()
        qcfg = dataclasses.replace(lcfg, quant=True)
        sd = lw.convert_llama(lw.load_state_dict(bin_path), qcfg)
        with torch.device("meta"):
            ref = LlamaWithEmbeddings(qcfg)
        lw.verify_structure(sd, ref.state_dict())
        t_conv = time.perf_counter() - t0
        llms = {}
        for dev in ("cpu", "cuda"):
            with torch.device("meta"):
                m = LlamaWithEmbeddings(qcfg)
            m.load_state_dict({k: v.to(dev) for k, v in sd.items()}, assign=True)
            llms[dev] = m.eval()
        gen = torch.Generator().manual_seed(14)
        ids = torch.randint(3, lcfg.vocab_size, (2, 12), generator=gen)
        logits = {}
        with torch.no_grad():
            for dev, m in llms.items():
                i = ids.to(dev)
                pos = torch.arange(i.shape[1], device=dev)[None].expand_as(i)
                logits[dev] = m(token_ids=i, attention_mask=torch.ones_like(i, dtype=torch.bool),
                                positions=pos, last_logit_only=True)[0][:, -1].float().cpu()
        a, b = logits["cuda"], logits["cpu"]
        rel_err = float((a - b).abs().max() / b.abs().max())
        agree = bool(torch.equal(a.argmax(-1), b.argmax(-1)))
        ok = rel_err <= TOL_LOGIT_REL and torch.isfinite(a).all()
        log(f"[weights] HF Llama-2-7B state, 4096 wide, 2 layers: made and saved as bf16 "
            f"({os.path.getsize(bin_path) / 2**30:.2f} GiB) in {t_make:.1f} s; loaded, converted "
            f"and quantized in {t_conv:.1f} s ({sum(v.numel() for v in sd.values()):,} values); "
            f"last-token logits of 2 x 12 tokens, card vs CPU: largest difference "
            f"{rel_err:.3e} of the largest logit (tol {TOL_LOGIT_REL:g}), argmax equal {agree} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the converted int8 LLM on the card disagrees with the CPU")
        log(f"[weights] phase 9 in {time.perf_counter() - t_phase:.1f} s")
    finally:
        builder.build_detector_from_config = real_build
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------- phase 10
# tolerance of the closed-set family's tiny float32 models, card vs CPU,
# relative to the largest triplet score: the same float32 arithmetic
# summed in another order through the segmenter, the tower and the head
TOL_FAMILY = 1e-4
FAMILY_FULL = ("baseline_r50.py", "baseline_v2_r50.py", "baseline_v3_ov.py")
FAMILY_BUILD_ONLY = ("baseline_r50_prompt.py", "baseline_swin_b.py", "baseline_v3_r50.py")


def family_gt_objects(hw, n_obj, M, seed=0):
    """``n_obj`` disjoint seeded regions (a Voronoi partition of the stride-4
    grid, upsampled) with seeded classes and mmdet ids, padded to ``M`` →
    (masks [M, H, W], ids [M], validity [M]), numpy."""
    import numpy as np

    from openpsg_tpu_torch.data.vocab import INSTANCE_OFFSET, NUM_THING_CLASSES

    H, W = hw
    rng = np.random.default_rng(seed)
    seeds = rng.random((n_obj, 2)) * (H // 4, W // 4)
    yy, xx = np.mgrid[:H // 4, :W // 4]
    owner = np.argmin((yy[None] - seeds[:, 0, None, None]) ** 2
                      + (xx[None] - seeds[:, 1, None, None]) ** 2, axis=0)
    owner = owner.repeat(4, 0).repeat(4, 1)
    counts, oids = {}, np.zeros(M, np.int64)
    for i, lab in enumerate(rng.integers(0, 133, n_obj)):
        inst = counts.get(lab, 0) if lab < NUM_THING_CLASSES else 0
        counts[lab] = counts.get(lab, 0) + 1
        oids[i] = int(lab) + INSTANCE_OFFSET * inst
    masks = np.zeros((M, H, W), bool)
    masks[:n_obj] = owner[None] == np.arange(n_obj)[:, None, None]
    return masks, oids, np.arange(M) < n_obj


def family_kv(T):
    """A text KV store with pair and triplet embeddings for some class pairs
    of :func:`family_gt_objects` (seed 0)'s objects; other keys read 0."""
    import numpy as np

    from openpsg_tpu_torch.data.text_kv import TextKVStore
    from openpsg_tpu_torch.data.vocab import OBJECT_CLASSES, RELATION_CLASSES

    rng = np.random.default_rng(5)
    _, oids, valid = family_gt_objects((64, 64), 6, 8)
    names = sorted({OBJECT_CLASSES[int(o) % 1000] for o in oids[valid]})
    table = {}
    for a in names:
        for b in names:
            table[f"{a}#{b}"] = rng.normal(size=T).astype(np.float32)
            for r in RELATION_CLASSES[::5]:
                table[f"{a}#{b}#{r}"] = rng.normal(size=T).astype(np.float32)
    return TextKVStore(embedding_size=T, table=table)


def family_cases():
    """Phase 10a's tiny models: v1 (attention, einsum, prompt + graph), v2
    (all five experts, the gate per pair and per pair and relation), v3
    (closed, open vocabulary)."""
    import dataclasses

    from openpsg_tpu_torch.models.detectors.mask2former_relation import M2FRelationConfig
    from openpsg_tpu_torch.models.relation.head_v1 import HeadV1Config
    from openpsg_tpu_torch.models.relation.head_v2 import EXPERT_ORDER, HeadV2Config
    from openpsg_tpu_torch.models.relation.head_v3 import HeadV3Config

    v3 = HeadV3Config.tiny_test()
    cases = {
        "v1 attention": M2FRelationConfig.tiny_test("v1"),
        "v1 einsum": dataclasses.replace(M2FRelationConfig.tiny_test("v1"),
                                         head_v1=HeadV1Config.tiny_test(pred_type="einsum")),
        "v1 prompt+graph": dataclasses.replace(
            M2FRelationConfig.tiny_test("v1"), head_v1=HeadV1Config.tiny_test(
                use_relation_prompts=True, fusion_pred_type="einsum_v2",
                graph_transformer_type="base", use_learnable_prompts=True,
                learnable_prompts_size=4)),
        "v2 experts, MoE v1": dataclasses.replace(
            M2FRelationConfig.tiny_test("v2"),
            head_v2=HeadV2Config.tiny_test(experts=EXPERT_ORDER, use_moe_gate=True)),
        "v2 experts, MoE v2": dataclasses.replace(
            M2FRelationConfig.tiny_test("v2"), head_v2=HeadV2Config.tiny_test(
                experts=EXPERT_ORDER, use_moe_gate=True, moe_weight_type="v2")),
        "v3 closed": M2FRelationConfig.tiny_test("v3"),
        "v3 open vocabulary": dataclasses.replace(
            M2FRelationConfig.tiny_test("v3"), head_v3=dataclasses.replace(
                v3, ov_relation=True, llm=dataclasses.replace(v3.llm, causal=False))),
    }
    return {k: dataclasses.replace(c, object_mask_thr=0.0, iou_thr=0.1) for k, c in cases.items()}


def phase_family_tiny(torch):
    """Phase 10a: each tiny model of :func:`family_cases` on the card against
    the CPU, the same weights on both: fusion and selection (or the
    ground-truth objects) identical, and the top-100 triplets agree rank by
    rank on the triplet scores relative to the largest (:func:`agree_ranked`,
    TOL_FAMILY), through fusion on a seeded image and on 6 ground-truth
    objects."""
    import numpy as np

    from openpsg_tpu_torch.models.detectors.mask2former_relation import PSGMask2FormerRelation
    from openpsg_tpu_torch.models.relation.head_v4 import topk_stable

    img = np.random.default_rng(5).integers(0, 256, (64, 64, 3)).astype(np.float32)
    gt = family_gt_objects((64, 64), 6, 8)
    for name, cfg in family_cases().items():
        kv = family_kv(cfg.head_v2.text_embedding_size) if cfg.head_version == "v2" else None
        cpu = PSGMask2FormerRelation(cfg, seed=3, device="cpu", text_kv=kv)
        gpu = PSGMask2FormerRelation(cfg, seed=3, device="cuda", text_kv=kv)
        gpu.segmenter.load_state_dict(cpu.segmenter.state_dict())
        gpu.head.load_state_dict(cpu.head.state_dict())
        gpu.object_cls_embed = cpu.object_cls_embed.cuda()
        for kind in ("fusion", "gt"):
            sels, probs = [], []
            for m in (cpu, gpu):
                image = torch.as_tensor(img, device=m.device)
                seg = m.segment(image)
                sel = (m.fuse_select(seg, image.shape[:2], (60, 64)) if kind == "fusion"
                       else m.gt_select(seg, *gt))
                sels.append([t.cpu() for t in sel])
                probs.append(m.triplet_probs(seg["mask_features"], sel[0], sel[2], sel[3],
                                             sel[4]).cuda())
            (mc, oc, vc, lc, sc, pc), (mg, og, vg, lg, sg, pg) = sels
            for a, b, what in ((mc, mg, "object masks"), (oc, og, "ids"), (vc, vg, "validity"),
                               (lc, lg, "labels"), (pc, pg, "pan map")):
                if not torch.equal(a, b):
                    raise AssertionError(f"[family] {name} {kind}: {what} differ card vs CPU")
            if not torch.allclose(sc, sg, rtol=TOL_FAMILY, atol=1e-6):
                raise AssertionError(f"[family] {name} {kind}: object scores differ")
            scale = probs[0].abs().max().clamp(min=1e-30)
            full_g, full_c = (probs[1] / scale).flatten(), (probs[0] / scale).flatten()
            log(f"[family] {name} {kind}: {int(vc.sum())} objects")
            agree_ranked(torch, f"family {name} {kind} top-100 (card vs CPU)", TOL_FAMILY,
                         topk_stable(full_g, 100)[1], topk_stable(full_c, 100)[1],
                         full_g, full_c)


def phase_family_full(torch, skv, gat, root, ann):
    """Phase 10b: the full-width family on seeded random weights, launch
    counts read around all of it: ``baseline_r50.py`` through the infer tool
    (``--gt-masks --vis``, phase 7's 4 square images); then for v1, v2 and
    v3 (``baseline_r50.py``, ``baseline_v2_r50.py``, ``baseline_v3_ov.py``)
    ``infer`` on 2 seeded 1344² images and ``infer_gt`` on the same images
    with 30 seeded objects: stage ms per image, peak memory, objects kept by
    fusion; the other three full configs are built and run once."""
    import numpy as np

    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config
    from openpsg_tpu_torch.ops import flash_cross_attn as fca, msda_gather as mg
    from openpsg_tpu_torch.tools import infer

    cfgs = os.path.join(HERE, "openpsg_tpu_torch", "configs", "psg")
    rng = np.random.default_rng(7)
    H, W = BUCKET
    hws = [(H, W), (1200, 1344)]
    images = [rng.integers(0, 256, (H, W, 3)).astype(np.float32) for _ in hws]
    torch.cuda.synchronize()
    fca.reset_launches()
    mg.sparse_row_gather.launches = 0
    stats_out = {}
    for name in FAMILY_FULL + FAMILY_BUILD_ONLY:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model = build_detector_from_config(Config.fromfile(os.path.join(cfgs, name)), seed=0)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        weights = torch.cuda.memory_allocated() / 2**30
        if name in FAMILY_BUILD_ONLY:
            t0 = time.perf_counter()
            res = model.infer(images[0], hws[0])
            check_result(res, BUCKET)
            log(f"[family] {name} (head {model.cfg.head_version}, {model.cfg.segmenter.backbone}):"
                f" built in {built:.1f} s, weights {weights:.2f} GiB; one infer "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms (first call)")
            del model
            continue
        if name == "baseline_r50.py":
            out, vis = os.path.join(root, "family_out"), os.path.join(root, "family_vis")
            st = infer.main(["--config", os.path.join(cfgs, name), "--test-file", ann,
                             "--data-dir", root, "--output-dir", out, "--gt-masks",
                             "--vis", vis], model=model)
            with open(st["submission"], encoding="utf-8") as f:
                recs = json.load(f)
            if (len(recs) != 4 or any(len(r["segments_info"]) != 3 or not r["relations"]
                                      for r in recs) or len(os.listdir(vis)) != 4):
                raise AssertionError("family tool run: expected 4 records of 3 GT segments "
                                     "with relations and 4 overlays")
            log(f"[family] {name} through the infer tool (--gt-masks --vis, 4 images): "
                f"{st['seconds']:.2f} s; model {sum(st['sections']['model']) / 4 * 1e3:.1f} ms "
                f"per image; {sum(len(r['relations']) for r in recs)} relations written")
        gt = family_gt_objects(BUCKET, model.cfg.max_objects, model.cfg.max_objects_padded)
        model.infer(images[0], hws[0])            # warm-up, not counted
        model.infer_gt(images[0], *gt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        per = []
        for img, hw in zip(images, hws):
            times = {}
            t0 = time.perf_counter()
            res = model.infer(img, hw, stage_times=times)
            times["total"] = (time.perf_counter() - t0) * 1e3
            check_result(res, BUCKET)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res_gt = model.infer_gt(img, *gt)
            times["infer_gt"] = (time.perf_counter() - t0) * 1e3
            want = [int(o) for o in gt[1][gt[2]]]
            if (res_gt["rel_results"]["object_id_list"] != want
                    or len(res_gt["rel_results"]["relation"]) != 100
                    or np.isnan(res_gt["rel_scores"]).any()):
                raise AssertionError(f"{name}: infer_gt result malformed")
            # exp of random-weight scores may overflow (v2's expert is unscaled)
            times["gt_inf_scores"] = int(np.isinf(res_gt["rel_scores"]).sum())
            times["fusion_objects"] = len(res["rel_results"]["object_id_list"])
            per.append(times)
        peak = torch.cuda.max_memory_allocated() / 2**30
        stats_out[name] = dict(built_s=built, weights_gib=weights, peak_gib=peak, per_image=per)
        log(f"[family] {name} (head {model.cfg.head_version}, {model.cfg.segmenter.backbone}, "
            f"{model.cfg.segmenter.dtype}): built in {built:.1f} s, weights {weights:.2f} GiB, "
            f"peak {peak:.2f} GiB; per image " + "; ".join(
                ", ".join(f"{k} {v}" if isinstance(v, int) else f"{k} {v:.1f} ms"
                          for k, v in t.items()) for t in per))
        del model
    n_skv = fca.flash_shared_kv_cross_attn.launches
    n_gat = mg.sparse_row_gather.launches
    skv["launches_by_path"]["family"] = n_skv
    gat["launches_by_path"]["family"] = n_gat
    log(f"[family] flash_shared_kv_cross_attn launches {n_skv}, sparse_row_gather launches "
        f"{n_gat} on the family's paths")
    if n_skv or n_gat:
        raise AssertionError("the closed-set family's paths launched a kernel")
    log("[family] stats " + json.dumps(stats_out))


def phase_family_weights(torch, root, ann):
    """Phase 10c: the converter chain at full width: a seeded mmdet-layout
    Mask2Former R50 ``.pth`` (the published geometry, encoder FFN 1024)
    through ``convert_mask2former``, a seeded reference v1 head
    ``PartCheckpointHook`` ``.pth`` through ``convert_relation --verify``;
    then the infer tool on ``baseline_r50.py`` (its pixel-decoder FFN set to
    the published 1024) with the converted ``segmenter_pretrained_path`` and
    ``--checkpoint``, ``--gt-masks``, on phase 7's 4 square images.  Every
    loaded tensor equals its converted value in the model's dtype; the raw
    ``.pth`` loads the same segmenter."""
    import numpy as np

    from openpsg_tpu_torch.core.builder import build_detector_from_config, m2f_relation_config
    from openpsg_tpu_torch.core.config import Config
    from openpsg_tpu_torch.models.segmenter.mask2former import Mask2FormerConfig
    from openpsg_tpu_torch.tools import convert_mask2former, convert_relation, infer
    from openpsg_tpu_torch.utils.synthetic_weights import (
        synthetic_mask2former_state,
        synthetic_relation_v1_state,
    )

    t_phase = time.perf_counter()
    to_pt = lambda st: {k: torch.from_numpy(v) for k, v in st.items()}
    m2f = os.path.join(root, "mask2former_r50.pth")
    torch.save({"state_dict": to_pt(synthetic_mask2former_state(
        Mask2FormerConfig(backbone="r50", enc_ffn_hidden=1024), seed=11, fan_in=True))}, m2f)
    seg_pt = os.path.join(root, "m2f_conv", "segmenter.pt")
    cfg_file = os.path.join(root, "converted.py")
    with open(cfg_file, "w", encoding="utf-8") as f:
        f.write(f"_base_ = [{os.path.join(HERE, 'openpsg_tpu_torch/configs/psg/baseline_r50.py')!r}]\n"
                f"model = dict(segmenter_pretrained_path={seg_pt!r}, panoptic_head=dict("
                "pixel_decoder=dict(encoder=dict(transformerlayers=dict(ffn_cfgs=dict("
                "feedforward_channels=1024))))))\n")
    convert_mask2former.main([m2f, "--out", os.path.dirname(seg_pt)])
    cfg = Config.fromfile(cfg_file)
    mcfg = m2f_relation_config(cfg)
    head_pth = os.path.join(root, "epoch_12.pth")
    torch.save({"state_dict": to_pt(synthetic_relation_v1_state(
        mcfg.head_v1, mcfg.segmenter.mask_dim, 133, fan_in=True)), "meta": {"epoch": 12}},
        head_pth)
    ckpts = os.path.join(root, "v1_ckpts")
    convert_relation.main([head_pth, "--config", cfg_file, "--out", ckpts, "--verify"])
    model = build_detector_from_config(cfg, seed=0)
    st = infer.main(["--config", cfg_file, "--test-file", ann, "--data-dir", root,
                     "--output-dir", os.path.join(root, "v1_out"), "--checkpoint", ckpts,
                     "--gt-masks"], model=model)
    seg_state = torch.load(seg_pt, weights_only=True)
    params = torch.load(os.path.join(ckpts, "step_0", "params.pt"), weights_only=True)
    groups = model.param_groups()
    n = 0
    for name, value in list(seg_state.items()) + list(params.items()):
        group, pname = ("segmenter", name) if name in seg_state else name.split(".", 1)
        have = groups[group][pname]
        if not torch.equal(have, value.to(have.device, have.dtype)):
            raise AssertionError(f"{group}.{pname} differs from its converted value")
        n += 1
    if n != sum(len(g) for g in groups.values()):
        raise AssertionError(f"{n} converted tensors for {sum(len(g) for g in groups.values())}")
    raw = build_detector_from_config(Config.fromfile(cfg_file), seed=1)
    raw.load_segmenter_weights(m2f)
    for k, v in raw.segmenter.state_dict().items():
        if not torch.equal(v, model.segmenter.state_dict()[k]):
            raise AssertionError(f"raw .pth and segmenter.pt differ at {k}")
    with open(st["submission"], encoding="utf-8") as f:
        recs = json.load(f)
    if len(recs) != 4 or any(len(r["segments_info"]) != 3 for r in recs):
        raise AssertionError("converted-weights tool run: malformed submission")
    log(f"[family] converter chain at full width: mmdet R50 Mask2Former ({len(seg_state)} "
        f"tensors) and a v1 head checkpoint ({len(params)} tensors) converted, loaded by the "
        f"infer tool ({n} tensors, each equal to its converted value in the model's dtype; "
        f"the raw .pth loads the same segmenter); {st['n_images']} images in "
        f"{st['seconds']:.2f} s; phase in {time.perf_counter() - t_phase:.1f} s")
    del model, raw


def phase_family(torch, skv, gat):
    """Phase 10: the closed-set v1-v3 family (:func:`phase_family_tiny`,
    :func:`phase_family_full`, :func:`phase_family_weights`)."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    phase_family_tiny(torch)
    root = tempfile.mkdtemp(prefix="chip_smoke_family_")
    try:
        ann = write_png_fixture(root, TOOL_SIZES[:4])
        phase_family_full(torch, skv, gat, root, ann)
        torch.cuda.empty_cache()
        phase_family_weights(torch, root, ann)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[family] phase 10 in {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------- phase 11
# tolerances of the family's and the segmenter's tiny float32 train steps,
# card vs CPU: TOL_TRAIN_LOSS, TOL_TRAIN_GRAD and TOL_TRAIN_UPDATE (phase 8a's,
# for the same reasons), and the assignment costs relative to the largest
# valid cost (float32 products summed in another order)
TOL_SEG_COST = 1e-5
FAMILY_TRAIN = ("baseline_r50.py", "baseline_v2_r50.py", "baseline_v3_ov.py")
SEG_TRAIN_BUCKETS = (1344, 1024, 768)


def step_agreement(runs):
    """{"cpu": (losses, grads, values), "card": ...} of one train step →
    (largest relative loss difference, largest gradient difference relative
    to its leaf, leaves 0 up to roundoff (held to 1e-5 of the largest
    gradient instead, scaled onto TOL_TRAIN_GRAD), largest absolute
    difference of the values after the update)."""
    (l_cpu, g_cpu, v_cpu), (l_card, g_card, v_card) = runs["cpu"], runs["card"]
    loss_err = max(abs(l_card[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12) for k in l_cpu)
    largest = max(float(g.abs().max()) for g in g_cpu.values())
    grad_err, zero_leaves = 0.0, []
    for n, g in g_cpu.items():
        scale = float(g.abs().max())
        if scale < 1e-5 * largest:
            zero_leaves.append(n)
            grad_err = max(grad_err, float(g_card[n].abs().max()) / largest / 1e-5
                           * TOL_TRAIN_GRAD)
            continue
        grad_err = max(grad_err, float((g_card[n] - g).abs().max()) / scale)
    upd_err = max(float((v_card[n] - v).abs().max()) for n, v in v_cpu.items())
    return loss_err, grad_err, zero_leaves, upd_err


def check_step(tag, runs, extra=""):
    loss_err, grad_err, zero, upd_err = step_agreement(runs)
    ok = (loss_err <= TOL_TRAIN_LOSS and grad_err <= TOL_TRAIN_GRAD
          and upd_err <= TOL_TRAIN_UPDATE)
    log(f"[{tag}] one step, card vs CPU: losses {runs['card'][0]} (largest relative difference "
        f"{loss_err:.3e}, tol {TOL_TRAIN_LOSS:g}); {len(runs['cpu'][1])} gradient leaves, largest "
        f"difference relative to the leaf {grad_err:.3e} (tol {TOL_TRAIN_GRAD:g}; {len(zero)} "
        f"leaves 0 up to roundoff); values after the update within {upd_err:.3e} (tol "
        f"{TOL_TRAIN_UPDATE:g}){extra} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: the tiny train step on the card disagrees with the CPU")


def family_train_batch(M, B=2, seed=0):
    """Seeded family training examples (the tiny models' 64² images)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    valid = np.stack([np.arange(M) < 5, np.arange(M) < 4])[:B]
    target = np.zeros((B, M, M, 56), np.float32)
    target[:, 0, 1, 2] = target[:, 0, 1, 4] = target[:, 2, 0, 3] = target[0, 3, 1, 1] = 1
    return dict(image=rng.integers(0, 255, (B, 64, 64, 3)).astype(np.float32),
                object_masks=(rng.uniform(size=(B, M, 16, 16)) > 0.7) & valid[:, :, None, None],
                object_labels=rng.integers(0, 133, (B, M)).astype(np.int32),
                object_valid=valid, relation_target=target)


def phase_family_train_tiny(torch):
    """Phase 11a: one ``M2FTrainer`` step of the tiny float32 v1, v2 (all
    five experts and the gate, text KV store), v3 and v1 with
    ``object_token_size`` 2, on the card against the CPU (the same weights
    and batch): losses, every gradient leaf, the values after the update;
    then one ``SegmenterTrainer`` step in each class mode (Mask2Former,
    ``softmax_void``; the OpenSeeD segmenter with trainable class
    embeddings, ``sigmoid``): the costs within TOL_SEG_COST, the Hungarian
    assignments identical, and the step as above."""
    import dataclasses

    import numpy as np

    from openpsg_tpu_torch.models.detectors.mask2former_relation import PSGMask2FormerRelation
    from openpsg_tpu_torch.models.segmenter.mask2former import (
        Mask2FormerConfig,
        Mask2FormerSegmenter,
    )
    from openpsg_tpu_torch.models.segmenter.openseed import OpenSeedSegmenter, SegmenterConfig
    from openpsg_tpu_torch.models.common import init_params
    from openpsg_tpu_torch.ops import flash_cross_attn as fca
    from openpsg_tpu_torch.train.segmenter_trainer import SegmenterTrainer, SegTrainBatch
    from openpsg_tpu_torch.train.trainer import (
        AdamW,
        M2FTrainBatch,
        M2FTrainer,
        make_lr_schedule,
        make_optimizer,
    )

    cases = family_cases()
    cases = {"v1": cases["v1 attention"], "v2 experts + gate, text KV": cases["v2 experts, MoE v1"],
             "v3": cases["v3 closed"],
             "v1 object_token_size 2": dataclasses.replace(cases["v1 attention"],
                                                           object_token_size=2)}
    fca.reset_launches()
    for name, cfg in cases.items():
        kv = family_kv(cfg.head_v2.text_embedding_size) if cfg.head_version == "v2" else None
        cpu = PSGMask2FormerRelation(cfg, seed=3, device="cpu", text_kv=kv)
        gpu = PSGMask2FormerRelation(cfg, seed=3, device="cuda", text_kv=kv)
        gpu.segmenter.load_state_dict(cpu.segmenter.state_dict())
        gpu.head.load_state_dict(cpu.head.state_dict())
        gpu.object_cls_embed = cpu.object_cls_embed.cuda()
        arrays = family_train_batch(cfg.max_objects_padded)
        runs = {}
        for side, m in (("cpu", cpu), ("card", gpu)):
            tr = M2FTrainer(m)
            losses, grads = tr.gradients(M2FTrainBatch.from_numpy(arrays, m.device))
            opt = make_optimizer(make_lr_schedule(steps_per_epoch=10))
            opt.step(tr.master, grads, opt.init(tr.master))
            runs[side] = ({k: float(v) for k, v in losses.items()},
                          {n: g.cpu() for n, g in grads.items()},
                          {n: v.detach().cpu() for n, v in tr.master.items()})
        check_step(f"family-train-tiny {name}", runs)
    launches = dict(fca.flash_shared_kv_cross_attn.launches_by_variant)
    if any(launches.values()):
        raise AssertionError(f"the family's train steps launched the shared-KV kernel {launches}")

    rng = np.random.default_rng(4)
    gt_masks = np.zeros((2, 4, 16, 16), bool)
    gt_masks[:, 0, :8, :8] = gt_masks[:, 1, 8:, 8:] = gt_masks[1, 2, :8, 8:] = True
    arrays = dict(image=rng.integers(0, 255, (2, 64, 64, 3)).astype(np.float32),
                  gt_masks=gt_masks, gt_labels=np.asarray([[1, 3, 0, 0], [2, 3, 5, 0]], np.int32),
                  gt_valid=np.asarray([[1, 1, 0, 0], [1, 1, 1, 0]], bool))
    ce = torch.from_numpy(rng.normal(size=(12, SegmenterConfig.tiny_test().proj_dim))
                          .astype(np.float32))
    for mode in ("softmax_void", "sigmoid"):
        make = ((lambda: Mask2FormerSegmenter(Mask2FormerConfig.tiny_test()))
                if mode == "softmax_void" else
                (lambda: OpenSeedSegmenter(SegmenterConfig.tiny_test())))
        ref = make()
        init_params(ref, torch.Generator().manual_seed(5))
        runs, costs, matches = {}, {}, {}
        for side, dev in (("cpu", "cpu"), ("card", "cuda")):
            seg = make().to(dev)
            seg.load_state_dict(ref.state_dict())
            if mode == "softmax_void":
                tr = SegmenterTrainer(seg, num_classes=8)
            else:
                emb = ce.clone().to(dev)
                tr = SegmenterTrainer(
                    seg, num_classes=12, cls_mode="sigmoid",
                    apply_fn=lambda img, seg=seg, emb=emb: seg(img, emb),
                    params={**{f"seg.{n}": p for n, p in seg.named_parameters()}, "ce": emb})
            batch = SegTrainBatch.from_numpy(arrays, dev)
            costs[side] = tr.cost_matrices(batch).cpu()
            matches[side] = tr.assign(costs[side].numpy(), arrays["gt_valid"])
            losses, grads = tr.gradients(batch, torch.from_numpy(matches[side]).to(dev))
            opt = AdamW(lambda count: 1e-7, max_norm=float("inf"), weight_decay=1e-4)
            opt.step(tr.master, grads, opt.init(tr.master))
            runs[side] = ({k: float(v) for k, v in losses.items()},
                          {n: g.cpu() for n, g in grads.items()},
                          {n: v.detach().cpu() for n, v in tr.master.items()})
        ok = costs["cpu"] < 1e8
        cost_err = float((costs["card"][ok] - costs["cpu"][ok]).abs().max()
                         / costs["cpu"][ok].abs().max())
        same = bool(np.array_equal(matches["card"], matches["cpu"]))
        if not (cost_err <= TOL_SEG_COST and same):
            raise AssertionError(f"segmenter-train-tiny {mode}: costs differ by {cost_err:.3e} "
                                 f"(tol {TOL_SEG_COST:g}), assignments identical {same}")
        check_step(f"segmenter-train-tiny {mode}", runs,
                   f"; costs within {cost_err:.3e} of the largest (tol {TOL_SEG_COST:g}), "
                   f"Hungarian assignments identical ({int((matches['cpu'] >= 0).sum())} matches)")


def phase_family_train(torch, skv, gat, root, ann):
    """Phase 11b: ``tools.train.main`` at full width for v1, v2 and v3
    (``baseline_r50.py``, ``baseline_v2_r50.py``, ``baseline_v3_ov.py``) on
    phase 8's fixture, 4 steps each with ``--stage-times`` (v1 also with
    ``--validate --val-limit 2``): finite losses, the head and the class
    embeddings changed, the segmenter bitwise unchanged, a checkpoint of
    exactly ``{head, object_cls_embed}``; then the infer tool with
    ``--checkpoint --gt-masks`` on 2 images restores the trained values
    bitwise into a model reset to its initial ones.  s/step (median of
    steps 2-4), the stage split, peak memory and checkpoint bytes; no
    kernel launch."""
    import numpy as np

    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config
    from openpsg_tpu_torch.ops import flash_cross_attn as fca, msda_gather as mg
    from openpsg_tpu_torch.tools import infer, train
    from openpsg_tpu_torch.train.checkpoint import PartCheckpointer

    cfgs = os.path.join(HERE, "openpsg_tpu_torch", "configs", "psg")
    split = f"dict(ann_file={ann!r}, img_prefix={root!r}, seg_prefix={root!r})"
    fca.reset_launches()
    mg.sparse_row_gather.launches = 0
    out = {}
    for name in FAMILY_TRAIN:
        torch.cuda.empty_cache()
        cfg_path = os.path.join(root, f"train_{name}")
        with open(cfg_path, "w", encoding="utf-8") as f:
            f.write(f"_base_ = [{os.path.join(cfgs, name)!r}]\n"
                    f"data = dict(train={split}, val={split}, test={split})\n"
                    "runner = dict(max_epochs=1)\nlog_config = dict(interval=1)\n")
        model = build_detector_from_config(Config.fromfile(cfg_path), seed=0)
        groups = model.param_groups()
        seg_before = {n: t.detach().clone() for n, t in groups["segmenter"].items()}
        before = {f"{g}.{n}": t.detach().clone() for g in ("head", "object_cls_embed")
                  for n, t in groups[g].items()}
        argv = [cfg_path, "--work-dir", os.path.join(root, f"wd_{name}"), "--max-steps", "4",
                "--stage-times"]
        if name == "baseline_r50.py":
            argv += ["--validate", "--val-limit", "2"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = train.main(argv, model=model)
        wall = time.perf_counter() - t0
        values = [v for m in stats["metrics"] for v in m.values()]
        trained = {f"{g}.{n}": t.detach().clone() for g in ("head", "object_cls_embed")
                   for n, t in groups[g].items()}
        changed = sum(not torch.equal(t, before[n]) for n, t in trained.items())
        seg_same = all(torch.equal(t, seg_before[n]) for n, t in groups["segmenter"].items())
        ckpt = PartCheckpointer(os.path.join(root, f"wd_{name}", "ckpts"))
        params, opt_state, meta, step = ckpt.restore()
        step_dir = os.path.join(ckpt.directory, f"step_{step}")
        sizes = {f: os.path.getsize(os.path.join(step_dir, f)) for f in sorted(os.listdir(step_dir))}
        if (stats["steps"] != 4 or not all(np.isfinite(values)) or not changed or not seg_same
                or set(params) != set(trained) or set(opt_state["mu"]) != set(trained)):
            raise AssertionError(f"{name}: {stats['steps']} steps, metrics finite "
                                 f"{all(np.isfinite(values))}, {changed} trainable tensors "
                                 f"changed, segmenter unchanged {seg_same}, checkpoint of "
                                 f"{len(params)} tensors for {len(trained)}")
        rows = stats["stage_ms"][1:]
        split_ms = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
        med = statistics.median(stats["step_seconds"][1:])
        with torch.no_grad():
            for n, t in before.items():
                g, p = n.split(".", 1)
                groups[g][p].copy_(t)
        res_dir = os.path.join(root, f"out_{name}")
        i_stats = infer.main(["--config", cfg_path, "--checkpoint", ckpt.directory,
                              "--test-file", ann, "--data-dir", root, "--output-dir", res_dir,
                              "--gt-masks", "--limit", "2"], model=model)
        restored = all(torch.equal(groups[n.split(".")[0]][n.split(".", 1)[1]], t)
                       for n, t in trained.items())
        if not restored or i_stats["n_images"] != 2:
            raise AssertionError(f"{name}: the infer tool restored the trained values "
                                 f"bitwise {restored}; {i_stats['n_images']} images")
        m0, m1 = stats["metrics"][0], stats["metrics"][-1]
        loss_keys = sorted(k for k in m0 if k.startswith("loss"))
        out[name] = dict(step_seconds=stats["step_seconds"], median_step_seconds=med,
                         split_ms=split_ms, peak_memory_gib=stats["peak_memory_bytes"] / 2**30,
                         checkpoint_bytes=sizes, tensors=len(params),
                         values=sum(v.numel() for v in params.values()), val=stats["val"],
                         metrics=stats["metrics"])
        log(f"[family-train] {name} (head {model.cfg.head_version}, trainable "
            f"{sum(v.numel() for v in params.values())} values in {len(params)} tensors): "
            f"4 steps in {wall:.1f} s; step seconds "
            + ", ".join(f"{t:.3f}" for t in stats["step_seconds"])
            + f"; median of steps 2-4 {med:.3f} s/step; split (ms, median of steps 2-4) "
            + ", ".join(f"{k} {v:.1f}" for k, v in split_ms.items())
            + f"; peak memory {out[name]['peak_memory_gib']:.2f} GiB"
            + (" (training and validation)" if stats["val"] else "")
            + "; " + ", ".join(f"{k} {m0[k]:.4f} -> {m1[k]:.4f}" for k in loss_keys)
            + f"; {changed}/{len(trained)} trainable tensors changed, segmenter bitwise "
            f"unchanged; checkpoint " + ", ".join(f"{f} {b / 2**20:.1f} MiB" for f, b in
                                                  sizes.items())
            + f"; restored bitwise by the infer tool (--checkpoint --gt-masks, 2 images in "
            f"{i_stats['seconds']:.2f} s)" + (f"; val {stats['val'][0]}" if stats["val"] else ""))
        del model, groups, before, trained, seg_before, params, opt_state
    n_skv = fca.flash_shared_kv_cross_attn.launches
    n_gat = mg.sparse_row_gather.launches
    skv["launches_by_path"]["family_train"] = n_skv
    gat["launches_by_path"]["family_train"] = n_gat
    log(f"[family-train] flash_shared_kv_cross_attn launches {n_skv}, sparse_row_gather "
        f"launches {n_gat} in the family's training, validation and restore")
    if n_skv or n_gat:
        raise AssertionError("the family's training path launched a kernel")
    log("[family-train] stats " + json.dumps(out))


def phase_segmenter_train(torch, root, ann):
    """Phase 11c: ``SegmenterTrainer`` at full width: ``baseline_r50.py``'s
    Mask2Former (bf16, float32 masters), ``softmax_void``, B = 1, 3 steps
    on one of phase 8's train images: finite losses; ms per step split
    into forward, cost, assign, loss and backward, optimizer; peak memory.
    Tries the 1344² bucket first and, only if it runs out of memory,
    smaller ones, saying so."""
    import numpy as np

    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config
    from openpsg_tpu_torch.data.preprocess import Preprocessor
    from openpsg_tpu_torch.data.psg_dataset import PSGDataset
    from openpsg_tpu_torch.train.segmenter_trainer import SegmenterTrainer, SegTrainBatch
    from openpsg_tpu_torch.train.trainer import AdamW

    model = build_detector_from_config(Config.fromfile(os.path.join(
        HERE, "openpsg_tpu_torch", "configs", "psg", "baseline_r50.py")), seed=0)
    seg = model.segmenter
    del model.head
    ds = PSGDataset(ann, img_prefix=root, seg_prefix=root, split="train")
    for side in SEG_TRAIN_BUCKETS:
        torch.cuda.empty_cache()
        ex = ds.load_example(0, Preprocessor(scale=(side, side)), 32)
        batch = SegTrainBatch.from_numpy(dict(
            image=ex["image"][None], gt_masks=ex["object_masks"][None],
            gt_labels=ex["object_labels"][None].astype(np.int32),
            gt_valid=ex["object_valid"][None]), "cuda")
        tr = SegmenterTrainer(seg, num_classes=len(model.class_names))
        opt = AdamW(lambda count: 1e-5, max_norm=float("inf"), weight_decay=1e-4)
        state = opt.init(tr.master)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rows, losses = [], []
        try:
            for _ in range(3):
                times = {}
                t0 = time.perf_counter()
                d = tr.train_step(batch, opt, state, times)
                torch.cuda.synchronize()
                times["step"] = (time.perf_counter() - t0) * 1e3
                rows.append(times)
                losses.append({k: float(v) for k, v in d.items()})
        except torch.cuda.OutOfMemoryError:
            log(f"[segmenter-train] {side}² bucket: out of memory; trying a smaller bucket")
            del tr, state, opt, batch
            continue
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not all(np.isfinite(list(d.values())).all() for d in losses):
            raise AssertionError(f"segmenter training losses not finite: {losses}")
        split = {k: statistics.median(r[k] for r in rows[1:]) for k in rows[0]}
        log(f"[segmenter-train] baseline_r50 Mask2Former ({seg.cfg.dtype}, float32 masters, "
            f"{sum(p.numel() for p in tr.master.values())} values), softmax_void, B=1 at "
            f"{side}² ({int(ex['object_valid'].sum())} objects, {seg.cfg.num_queries} queries): "
            f"3 steps, ms per step " + ", ".join(f"{r['step']:.1f}" for r in rows)
            + "; median of steps 2-3 (ms): " + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
            + f"; peak memory {peak:.2f} GiB; losses " + json.dumps(losses[0]) + " -> "
            + json.dumps(losses[-1]))
        log("[segmenter-train] stats " + json.dumps(dict(bucket=side, rows_ms=rows,
                                                         split_ms=split, peak_memory_gib=peak,
                                                         losses=losses)))
        break
    else:
        raise AssertionError("segmenter training fits no bucket")
    for p in tr.params.values():
        p.requires_grad_(False)
    del model, seg, tr, state, opt, batch


def phase_selfcheck(torch, skv, gat, root):
    """Phase 11d: ``tools.selfcheck_e2e`` on the card at its defaults (900
    segmenter steps, 400 head and LLM steps, the 6-image 64² fixture, all in
    ``root``, which phase 12 serves from afterwards):
    strict R@20 > 0; mR@20 and the ground-truth-mask upper bound; per
    held-out image the objects fusion kept, the decode trips and the pair
    mask's density; the shared-KV kernel's launches by variant.  Then, on
    one held-out image, the trained model's Q-Former with the kernel
    against the plain attention forced (:func:`compare_head`,
    TOL_HEAD_F32): the first learned, sparse pair masks the kernel sees on
    an inference path.  → the selfcheck's result (:func:`selfcheck_e2e.run`)."""
    import numpy as np

    from openpsg_tpu_torch.data.preprocess import Preprocessor, load_image_rgb
    from openpsg_tpu_torch.ops import flash_cross_attn as fca, msda_gather as mg
    from openpsg_tpu_torch.tools import selfcheck_e2e

    fca.reset_launches()
    mg.sparse_row_gather.launches = 0
    t0 = time.perf_counter()
    res = selfcheck_e2e.run(root, device="cuda", log=lambda *a: None)
    wall = time.perf_counter() - t0
    by_variant = dict(fca.flash_shared_kv_cross_attn.launches_by_variant)
    skv["launches_by_path"]["selfcheck"] = fca.flash_shared_kv_cross_attn.launches
    skv["launches_by_variant"]["selfcheck"] = by_variant
    gat["launches_by_path"]["selfcheck"] = mg.sparse_row_gather.launches
    s, g = res["scores"], res["gt_scores"]
    log(f"[selfcheck] tools.selfcheck_e2e on the card (900 + 400 steps): strict R@20 "
        f"{s['R@20']:.1f}, mR@20 {s['mR@20']:.1f}; ground-truth-mask upper bound R@20 "
        f"{g['R@20']:.1f}, mR@20 {g['mR@20']:.1f}; phases (s) "
        + ", ".join(f"{k} {v:.1f}" for k, v in res["seconds"].items())
        + f"; in all {wall:.1f} s; segmenter losses {json.dumps(res['seg_losses'][-1])}; "
        f"relation losses {json.dumps(res['rel_losses'][-1])}; shared-KV launches "
        f"{by_variant}, sparse_row_gather {mg.sparse_row_gather.launches}")
    if not s["R@20"] > 0:
        raise AssertionError("selfcheck: strict R@20 is 0 on the card")

    model = res["pipeline"]
    with open(res["ann"], encoding="utf-8") as f:
        data = json.load(f)
    held_out = [d for d in data["data"] if d["image_id"] in set(data["test_image_ids"])]
    H, _ = model._model_hw()
    pre = Preprocessor(scale=(H, H))
    per, first = [], None
    for d in held_out:
        ex = pre(load_image_rgb(os.path.join(root, d["file_name"])))
        r = model.infer(ex["image"].astype(np.float32), ex["img_shape"])
        img = torch.as_tensor(ex["image"].astype(np.float32), device="cuda")
        seg = model.segment(img)
        sel = model.fuse_select(seg, ex["img_shape"])
        _, calls = kernel_calls(lambda: model.tail_pre(seg["mask_features"], *sel))
        mask = calls[0][3]
        per.append(dict(objects=len(r["rel_results"]["object_id_list"]),
                        decode_trips=int(r["decode_steps"]),
                        pair_mask_density=float(mask.float().mean())))
        if first is None:
            first = (seg["mask_features"], sel)
    log(f"[selfcheck] held-out images (learned weights): " + "; ".join(
        f"image {i}: {p['objects']} objects kept, {p['decode_trips']} decode trips "
        f"(of {model.cfg.max_new_tokens}), pair mask density {p['pair_mask_density']:.3f}"
        for i, p in enumerate(per)))
    mf, sel = first
    M = model.cfg.head.max_objects_padded
    valid = sel[1]
    pair = torch.arange(M * M, device=valid.device)
    pair_valid = valid[pair // M] & valid[pair % M]

    def run(plain):
        heads = {}
        hook = model.head.register_forward_hook(lambda mod, inp, o: heads.update(o))
        try:
            (o, _, _), calls = kernel_calls(
                lambda: model.tail_pre(mf, *sel, plain_attention=plain))
        finally:
            hook.remove()
        want = 0 if plain else model.cfg.head.qformer.num_layers
        if len(calls) != want:
            raise AssertionError(f"{len(calls)} kernel calls, expected {want}")
        return o, heads

    compare_head(torch, "selfcheck (learned masks, f32)", TOL_HEAD_F32, M, pair_valid,
                 run(False), run(True))
    log("[selfcheck] stats " + json.dumps(dict(
        scores=s, gt_scores=g, seconds=res["seconds"], per_image=per,
        launches_by_variant=by_variant, seg_losses=res["seg_losses"],
        rel_losses=res["rel_losses"])))
    return res


def phase_training_family(torch, skv, gat, selfcheck_root):
    """Phase 11: the closed-set family's training and segmenter training
    (:func:`phase_family_train_tiny`, :func:`phase_family_train`,
    :func:`phase_segmenter_train`, :func:`phase_selfcheck` in
    ``selfcheck_root``) → the selfcheck's result."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    phase_family_train_tiny(torch)
    root = tempfile.mkdtemp(prefix="chip_smoke_family_train_")
    try:
        ann = write_png_fixture(root, VAL_SIZES[:2], seed=1, train_sizes=TRAIN_SIZES)
        phase_family_train(torch, skv, gat, root, ann)
        torch.cuda.empty_cache()
        phase_segmenter_train(torch, root, ann)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    res = phase_selfcheck(torch, skv, gat, selfcheck_root)
    torch.cuda.empty_cache()
    log(f"[family-train] phase 11 in {time.perf_counter() - t_phase:.1f} s")
    return res


# ------------------------------------------------------------------ phase 12
SERVE_ARGS = ["--port", "0", "--single-bucket", "--batch-size", "4", "--micro-batch",
              "--max-wait-ms", "200"]
TOL_SERVE = 1e-5   # a relation score of the same float32 model on the same
                   # image, through two entry points (the same kernels)


@contextlib.contextmanager
def computed_images(model):
    """Record the image count of every ``infer_microbatch`` call of a PSG v4
    ``model``, pad copies included: ``infer`` and ``infer_batch`` run
    through it too, so the list covers every image the model computed."""
    sizes, real = [], model.infer_microbatch

    def wrapped(images, *a, **kw):
        sizes.append(len(images))
        return real(images, *a, **kw)

    model.infer_microbatch = wrapped
    try:
        yield sizes
    finally:
        del model.infer_microbatch


@contextlib.contextmanager
def served(argv, model=None):
    """``tools.serve.make_server`` on ``argv`` (port 0), serving from a
    thread → (address, service); shut down and joined on exit."""
    import threading

    from openpsg_tpu_torch.tools import serve

    httpd, service = serve.make_server(serve.parse_args(argv), model=model)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield httpd.server_address[:2], service
    finally:
        httpd.shutdown()
        service.stop()
        httpd.server_close()
        thread.join(timeout=30)


def http_request(addr, method, path, body=None):
    """One request over a real socket → (status, decoded JSON body)."""
    import http.client

    conn = http.client.HTTPConnection(*addr, timeout=900)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def post_concurrently(addr, bodies):
    """POST every body to /infer from its own thread, all started together
    → ([(status, record)], wall seconds)."""
    import threading

    out = [(None, "no answer")] * len(bodies)

    def hit(i):
        try:
            out[i] = http_request(addr, "POST", "/infer", bodies[i])
        except Exception as e:   # reported as a failed request below
            out[i] = (None, repr(e))

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return out, time.perf_counter() - t0


def segment_map(ids, segments_info):
    """[h, w] rgb2id map → each pixel's index in ``segments_info`` (-1 where
    none): the partition, whatever colours painted it."""
    import numpy as np

    out = np.full(ids.shape, -1, np.int64)
    for k, seg in enumerate(segments_info):
        out[ids == seg["id"]] = k
    return out


def check_served_record(tag, rec, hw):
    """A served record is well formed: its PNG at the image's original size,
    every ``segments_info`` id painted in it, relations 1-indexed over its
    segments → the PNG's id map."""
    import base64

    import numpy as np

    from openpsg_tpu_torch.utils.image_io import decode_png
    from openpsg_tpu_torch.utils.panoptic import rgb2id

    ids = rgb2id(decode_png(base64.b64decode(rec["pan_seg_png"])))
    present = set(np.unique(ids).tolist())
    n = len(rec["segments_info"])
    bad = [s["id"] for s in rec["segments_info"] if s["id"] not in present]
    if ids.shape != tuple(hw) or bad or len(rec["object_id_list"]) != n:
        raise AssertionError(f"{tag}: PNG {ids.shape} vs image {hw}, segment ids not painted "
                             f"{bad}, {n} segments for {len(rec['object_id_list'])} objects")
    for s, o, r in rec["relations"]:
        if not (0 <= s < n and 0 <= o < n and 1 <= r <= 56):
            raise AssertionError(f"{tag}: relation {(s, o, r)} over {n} segments")
    if len(rec["relation_scores"]) != len(rec["relations"]):
        raise AssertionError(f"{tag}: {len(rec['relation_scores'])} scores for "
                             f"{len(rec['relations'])} relations")
    return ids


def read_path_launches(fca, mg, skv, gat, key):
    """Store the launches since the last reset under ``key`` → (shared-KV
    launches, by variant, gather launches)."""
    skv["launches_by_path"][key] = fca.flash_shared_kv_cross_attn.launches
    skv["launches_by_variant"][key] = dict(fca.flash_shared_kv_cross_attn.launches_by_variant)
    gat["launches_by_path"][key] = mg.sparse_row_gather.launches
    return (skv["launches_by_path"][key], skv["launches_by_variant"][key],
            gat["launches_by_path"][key])


def phase_serve_full(torch, skv, gat):
    """Phase 12a: ``tools.serve`` at full width with the int8 deployment
    settings (phase 7's config), one model handed to ``make_server`` (port
    0, ``--single-bucket --batch-size 4 --micro-batch --max-wait-ms 200``),
    warmed up; then 8 of phase 7's PNGs posted at once from 8 threads, 2
    identical posts at once, ``/healthz``; launch counts and the images the
    model computed (pads included) read around exactly those requests;
    then one ``service.submit`` at trip budget 2 and one at None.  → the
    model, which phase 13d serves again."""
    import shutil
    import statistics
    import tempfile

    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config
    from openpsg_tpu_torch.data.preprocess import load_image_rgb
    from openpsg_tpu_torch.ops import flash_cross_attn as fca, msda_gather as mg

    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        write_png_fixture(root, TOOL_SIZES)
        cfg = os.path.join(root, "deploy.py")
        with open(cfg, "w", encoding="utf-8") as f:
            f.write(f"_base_ = [{os.path.join(HERE, 'openpsg_tpu_torch/configs/psg/baseline_v4_ov.py')!r}]\n"
                    + TOOL_INT8)
        n_req = 8
        paths = [os.path.join(root, f"{i}.png") for i in range(n_req)]
        bodies = []
        for p in paths:
            with open(p, "rb") as f:
                bodies.append(f.read())
        model = build_detector_from_config(Config.fromfile(cfg), seed=0)
        with served(["--config", cfg] + SERVE_ARGS, model) as (addr, service):
            t0 = time.perf_counter()
            service.warmup()
            warm = time.perf_counter() - t0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with computed_images(model) as sizes:
                fca.reset_launches()
                mg.sparse_row_gather.launches = 0
                burst, t_burst = post_concurrently(addr, bodies)
                same, t_same = post_concurrently(addr, [bodies[0]] * 2)
                health = http_request(addr, "GET", "/healthz")
                launches, by_variant, gathers = read_path_launches(fca, mg, skv, gat, "serve")
            peak = torch.cuda.max_memory_allocated() / 2**30
            for i, (status, rec) in enumerate(burst + same):
                if status != 200:
                    raise AssertionError(f"serve request {i}: status {status}: {rec}")
            if health[0] != 200 or health[1].get("status") != "ok":
                raise AssertionError(f"/healthz answered {health}")
            for i, (_, rec) in enumerate(burst):
                check_served_record(f"serve request {i}", rec, TOOL_SIZES[i])
            a, b = (dict(r) for _, r in same)
            lat = [r["latency_ms"] for _, r in burst + same]
            a.pop("latency_ms"), b.pop("latency_ms")
            if a != b:
                raise AssertionError("the two identical posts gave different records")
            check_served_record("identical post", a, TOOL_SIZES[0])
            n = sum(sizes)
            check_variants(by_variant, n)
            if gathers:
                raise AssertionError(f"sparse_row_gather launched {gathers} times while serving")
            log(f"[serve] full width, int8 deployment settings, batch 4 micro-batch: warm-up "
                f"{warm:.1f} s; 8 concurrent requests in {t_burst:.2f} s ({n_req / t_burst:.3f} "
                f"requests/s), then 2 identical in {t_same:.2f} s; latency_ms p50 "
                f"{statistics.median(lat):.1f}, max {max(lat):.1f}; groups computed {sizes} "
                f"({n} images, {n - n_req - 2} pad copies); flash_shared_kv_cross_attn launches "
                f"{by_variant}, 2 per computed image; sparse_row_gather 0; peak memory "
                f"{peak:.2f} GiB; /healthz {json.dumps(health[1])}")
            rgb = load_image_rgb(paths[0])
            service.trip_budget = 2
            capped, _ = service.submit(rgb)
            service.trip_budget = None
            free, _ = service.submit(rgb)
            if capped["decode_steps"] > 2:
                raise AssertionError(f"trip budget 2 decoded {capped['decode_steps']} trips")
            log(f"[serve] service.submit at trip budget 2: {capped['decode_steps']} decode "
                f"trips; at None on the same service: {free['decode_steps']} (of "
                f"{model.cfg.max_new_tokens})")
        log("[serve] stats " + json.dumps(dict(
            requests_per_s=n_req / t_burst, burst_seconds=t_burst, same_seconds=t_same,
            latency_ms=lat, groups=sizes, computed_images=n, launches=launches,
            peak_gib=peak, warmup_seconds=warm, capped_trips=capped["decode_steps"],
            free_trips=free["decode_steps"])))
        return model
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_serve_learned(torch, skv, gat, learned):
    """Phase 12b: the selfcheck's trained tiny model (phase 11d's files),
    started as a user starts the server (``--config`` and ``--checkpoint``;
    the server builds and restores it on the card): its 3 held-out images
    posted, each record equal to phase 11d's infer-tool submission (the
    relations, the segments' categories and pixels); then ``tools.predict``
    on the same images with the served model (records, PNGs and relations
    equal to the submission's) and ``tools.parse_predict`` on its output;
    then ``tools.predict --checkpoint`` on the selfcheck's {head, llm}
    checkpoint, which it refuses (F8) → the served model."""
    import numpy as np

    from openpsg_tpu_torch.ops import flash_cross_attn as fca, msda_gather as mg
    from openpsg_tpu_torch.tools import parse_predict, predict
    from openpsg_tpu_torch.utils.image_io import read_png
    from openpsg_tpu_torch.utils.panoptic import rgb2id

    root = os.path.dirname(learned["ann"])
    cfg, ckpt = os.path.join(root, "selfcheck_cfg.py"), os.path.join(root, "ckpts")
    sub_dir = os.path.join(root, "out", "submission")
    with open(os.path.join(sub_dir, "relation.json"), encoding="utf-8") as f:
        submission = json.load(f)
    with open(learned["ann"], encoding="utf-8") as f:
        data = json.load(f)
    held = [d for d in data["data"] if d["image_id"] in set(data["test_image_ids"])]
    sub_maps = [segment_map(rgb2id(read_png(os.path.join(sub_dir, "panseg",
                                                         r["pan_seg_file_name"]))),
                            r["segments_info"]) for r in submission]

    def same_as_submission(tag, rec, i, ids):
        sub = submission[i]
        cats = lambda r: [s["category_id"] for s in r["segments_info"]]
        if rec["relations"] != sub["relations"] or cats(rec) != cats(sub):
            raise AssertionError(f"{tag} image {i}: relations {rec['relations']} / categories "
                                 f"{cats(rec)} vs the submission's {sub['relations']} / "
                                 f"{cats(sub)}")
        if not np.array_equal(segment_map(ids, rec["segments_info"]), sub_maps[i]):
            raise AssertionError(f"{tag} image {i}: segments differ from the submission's")

    argv = ["--config", cfg, "--checkpoint", ckpt, "--port", "0", "--img-scale", "64", "64"]
    with served(argv) as (addr, service):
        model = service.model
        with computed_images(model) as sizes:
            fca.reset_launches()
            mg.sparse_row_gather.launches = 0
            recs = []
            for d in held:
                with open(os.path.join(root, d["file_name"]), "rb") as f:
                    recs.append(http_request(addr, "POST", "/infer", f.read()))
            launches, by_variant, gathers = read_path_launches(fca, mg, skv, gat,
                                                               "serve_learned")
    for i, ((status, rec), d) in enumerate(zip(recs, held)):
        if status != 200:
            raise AssertionError(f"learned serve image {i}: status {status}: {rec}")
        ids = check_served_record(f"learned serve image {i}", rec, (d["height"], d["width"]))
        if i == 0 and not np.array_equal(ids, rgb2id(read_png(os.path.join(
                sub_dir, "panseg", submission[0]["pan_seg_file_name"])))):
            raise AssertionError("served image 0: PNG ids differ from the submission's")
        same_as_submission("served", rec, i, ids)
    n = sum(sizes)
    if launches != 2 * n or gathers:
        raise AssertionError(f"learned serve: {launches} shared-KV launches for {n} images, "
                             f"{gathers} gather launches")
    log(f"[serve] learned weights (selfcheck model built and restored by the server): 3 "
        f"held-out images, records equal to phase 11d's submission: relations per image "
        f"{[len(r['relations']) for _, r in recs]}, "
        f"{[len(r['segments_info']) for _, r in recs]} segments; latency_ms "
        f"{[r['latency_ms'] for _, r in recs]}; shared-KV launches {by_variant}")

    held_json = os.path.join(root, "held_out.json")
    with open(held_json, "w", encoding="utf-8") as f:
        json.dump(held, f)
    pred_dir = os.path.join(root, "predict")
    common = ["--config", cfg, "--input-json", held_json, "--data-dir", root]
    with computed_images(model) as sizes:
        fca.reset_launches()
        mg.sparse_row_gather.launches = 0
        predict.main(common + ["--output-dir", pred_dir], model=model)
        launches, by_variant, gathers = read_path_launches(fca, mg, skv, gat, "predict")
    n = sum(sizes)
    if launches != 2 * n or gathers:
        raise AssertionError(f"predict: {launches} shared-KV launches for {n} images, "
                             f"{gathers} gather launches")
    with open(os.path.join(pred_dir, "predictions.json"), encoding="utf-8") as f:
        preds = json.load(f)
    n_trip = 0
    for i, rec in enumerate(preds):
        ids = rgb2id(read_png(os.path.join(pred_dir, "panseg", rec["pan_seg_file_name"])))
        sub_ids = rgb2id(read_png(os.path.join(sub_dir, "panseg",
                                               submission[i]["pan_seg_file_name"])))
        same_as_submission("predict", rec, i, ids)
        if rec["segments_info"] != submission[i]["segments_info"] or \
                not np.array_equal(ids, sub_ids):
            raise AssertionError(f"predict image {i}: segment ids differ from the submission's")
        triplets = parse_predict.parse_record(rec, os.path.join(pred_dir, "panseg"))
        if len(triplets) != len(rec["relations"]) or not all(
                t["sub_mask"].any() and t["obj_mask"].any() for t in triplets):
            raise AssertionError(f"parse_predict image {i}: {len(triplets)} triplets for "
                                 f"{len(rec['relations'])} relations, or an empty mask")
        n_trip += len(triplets)
    try:
        predict.main(common + ["--output-dir", os.path.join(root, "predict_ckpt"),
                               "--checkpoint", ckpt])
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("predict --checkpoint restored a {head, llm} checkpoint; the "
                             "JAX tool's head-only restore refuses it (F8)")
    log(f"[serve] tools.predict with the served model: 3 records equal to the submission "
        f"(relations, segments_info, PNG ids); parse_predict: {n_trip} named triplets, every "
        f"mask non-empty; shared-KV launches {by_variant}. predict --checkpoint on the "
        f"selfcheck's {{head, llm}} checkpoint restores nothing and refuses it, as the JAX "
        f"tool's head-only orbax restore does (F8): {refusal}")
    return model, held


def phase_pvsg(torch, skv, gat, learned, model, held):
    """Phase 12c: two 6-frame "videos" written as PNGs by the port's codec
    from the selfcheck's held-out images (the second mirrored), through
    ``tools.pvsg.infer_video`` at batch 4 (a chunk of 4, then 2 and 2 pad
    copies): each frame's record equal to ``infer`` on that frame; then the
    frame extractor on a short video where ``cv2.VideoWriter`` can write
    one."""
    import numpy as np

    from openpsg_tpu_torch.data.preprocess import Preprocessor, load_image_rgb
    from openpsg_tpu_torch.ops import flash_cross_attn as fca, msda_gather as mg
    from openpsg_tpu_torch.tools.pvsg import extractor, infer_video
    from openpsg_tpu_torch.utils.image_io import encode_png_rgb, write_png

    root = os.path.dirname(learned["ann"])
    frames_dir = os.path.join(root, "frames")
    frames = []
    for video, mirror in (("a", False), ("b", True)):
        os.makedirs(os.path.join(frames_dir, video))
        for k in range(6):
            img = load_image_rgb(os.path.join(root, held[k % 3]["file_name"]))
            path = os.path.join(frames_dir, video, f"{k:04d}.png")
            write_png(path, encode_png_rgb(np.ascontiguousarray(img[:, ::-1] if mirror else img)))
            frames.append((video, k, path))
    out = os.path.join(root, "pvsg.json")
    with computed_images(model) as sizes:
        fca.reset_launches()
        mg.sparse_row_gather.launches = 0
        videos = infer_video.main(["--config", os.path.join(root, "selfcheck_cfg.py"),
                                   "--frames-dir", frames_dir, "--output", out,
                                   "--batch-size", "4"], model=model)
        launches, by_variant, gathers = read_path_launches(fca, mg, skv, gat, "pvsg")
    n = sum(sizes)
    if sizes != [1] * 16 or launches != 2 * n or gathers:
        raise AssertionError(f"pvsg: computed {sizes}, {launches} shared-KV launches, "
                             f"{gathers} gather launches")
    H, _ = model._model_hw()
    pre = Preprocessor(scale=(H, H))
    n_rel = 0
    for video, k, path in frames:
        got = videos[video][k]
        ex = pre(load_image_rgb(path))
        want = model.infer(ex["image"].astype(np.float32), ex["img_shape"])
        if (got["frame"] != f"{k:04d}.png"
                or got["object_id_list"] != want["rel_results"]["object_id_list"]
                or got["relations"] != want["rel_results"]["relation"]
                or not np.allclose(got["relation_scores"], want["rel_scores"], rtol=0,
                                   atol=TOL_SERVE)):
            raise AssertionError(f"pvsg video {video} frame {k}: record differs from infer")
        n_rel += len(got["relations"])
    log(f"[pvsg] 2 videos x 6 frames at batch 4: 12 records equal to per-frame infer "
        f"({n_rel} relations, 0-indexed as the JAX tool writes them); computed {n} images "
        f"(4 pad copies); shared-KV launches {by_variant}")

    try:
        import cv2
    except ImportError:
        cv2 = None
    writer, video_dir = None, os.path.join(root, "videos")
    if cv2 is not None:
        os.makedirs(video_dir)
        writer = cv2.VideoWriter(os.path.join(video_dir, "clip.avi"),
                                 cv2.VideoWriter_fourcc(*"MJPG"), 5, (64, 64))
    if writer is None or not writer.isOpened():
        log("[pvsg] frame extractor not run: cv2.VideoWriter cannot write a video here")
        return
    for k in range(5):
        writer.write(load_image_rgb(os.path.join(root, held[k % 3]["file_name"]))[..., ::-1])
    writer.release()
    image_dir = os.path.join(root, "extracted")
    count = extractor.extract(video_dir, image_dir, "avi")
    names = sorted(os.listdir(os.path.join(image_dir, "clip")))
    shapes = {load_image_rgb(os.path.join(image_dir, "clip", nm)).shape for nm in names}
    if count != 5 or names != [f"{k:04d}.png" for k in range(5)] or shapes != {(64, 64, 3)}:
        raise AssertionError(f"extractor: {count} frames, {names}, shapes {shapes}")
    log("[pvsg] frame extractor: a 5-frame MJPG .avi written by cv2.VideoWriter gave 5 "
        "64x64 PNG frames")


def phase_openset(torch, skv, gat):
    """Phase 12d: ``tools.selfcheck_openset`` at its defaults (400 steps) on
    the card: the JAX tool's exit rule, the easy tier's R@10 above chance,
    the easy median rank below half the hard one; no kernel launch (the v3
    family)."""
    import shutil
    import tempfile

    from openpsg_tpu_torch.ops import flash_cross_attn as fca, msda_gather as mg
    from openpsg_tpu_torch.tools import selfcheck_openset

    root = tempfile.mkdtemp(prefix="chip_smoke_openset_")
    try:
        fca.reset_launches()
        mg.sparse_row_gather.launches = 0
        t0 = time.perf_counter()
        res = selfcheck_openset.run(root, device="cuda", log=lambda *a: None)
        wall = time.perf_counter() - t0
        launches, _, gathers = read_path_launches(fca, mg, skv, gat, "openset")
        s = res["summary"]
        easy, hard = s["easy_tier"], s["hard_tier"]
        log(f"[openset] tools.selfcheck_openset on the card (400 steps): easy tier "
            f"{easy['held_out_predicate']!r} ranks {easy['rank_per_image']} (median "
            f"{easy['median_rank']}), zero-shot R@10 {easy['zero_shot_R@10']:.1f} R@20 "
            f"{easy['zero_shot_R@20']:.1f} vs chance R@10 {res['chance10']:.1f}; hard tier "
            f"{hard['held_out_predicate']!r} ranks {hard['rank_per_image']} (median "
            f"{hard['median_rank']}, chance median {hard['chance_median_rank']}); closed-set "
            f"R@10 {s['closed_set_R@10(looking at)']:.1f}; token overlap easy "
            f"{easy['token_overlap']}, hard {hard['token_overlap']}; phases (s) "
            + ", ".join(f"{k} {v:.1f}" for k, v in res["seconds"].items())
            + f"; in all {wall:.1f} s; last losses {json.dumps(res['losses'][-1])}; "
            f"shared-KV launches {launches}, sparse_row_gather {gathers}")
        if not res["ok"]:
            raise AssertionError("open-set selfcheck: the JAX tool's exit rule failed")
        if not (easy["zero_shot_R@10"] > res["chance10"]
                and easy["median_rank"] < hard["median_rank"] / 2):
            raise AssertionError("open-set selfcheck: easy tier not above chance, or the "
                                 "tier contrast does not hold")
        if launches or gathers:
            raise AssertionError(f"open-set selfcheck launched {launches} shared-KV and "
                                 f"{gathers} gather kernels (v3 family: expected none)")
        log("[openset] stats " + json.dumps(dict(summary=s, seconds=res["seconds"],
                                                 wall=wall, losses=res["losses"])))
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 12e's steps, fewer than the harness's defaults (700 + 400) so that
# the phase fits its budget of 150 s; the defaults run alone (PERF.md)
KNOB_STEPS = (100, 40)
# the JAX harness's constants: 16 images, 8 objects, 8·7·56 candidates
KNOB_HARNESS = {"images": 16, "objects_per_image": 8, "predicates": 12,
                "gt_relations_per_image": 10, "candidates_per_image": 3136,
                "chance_R@20_pct": 0.64}
TOL_KNOB_SCORE = 1e-4  # a score of the trained f32 tiny model, card vs CPU:
                       # phase 4's tiny check's tolerance (``atol`` there)


def fusion_gap(torch, model, seg, img_hw):
    """``fuse_select``'s per-pixel winner rule on a segmenter output: the gap
    between the best and the second-best score-weighted mask probability
    of each pixel [H, W] (the margin that decides its panoptic id)."""
    c = model.cfg
    cls_logits, masks = seg["cls_logits"].float(), seg["masks"].float()
    scores = torch.sigmoid(cls_logits).max(dim=-1).values
    C = int(c.fusion_candidates)
    if C and C < scores.shape[0]:
        from openpsg_tpu_torch.models.relation.head_v4 import topk_stable

        cand = torch.sort(topk_stable(scores, C)[1]).values
        cls_logits, masks, scores = cls_logits[cand], masks[cand], scores[cand]
    H4, W4 = seg["mask_features"].shape[:2]
    probs = torch.sigmoid(torch.nn.functional.interpolate(
        masks[None], size=(H4 * 4, W4 * 4), mode="bilinear", align_corners=False)[0])
    dev = probs.device
    inside = ((torch.arange(probs.shape[1], device=dev)[:, None] < int(img_hw[0]))
              & (torch.arange(probs.shape[2], device=dev)[None, :] < int(img_hw[1])))
    probs = torch.where(inside[None], probs, torch.zeros_like(probs))
    w = torch.where((scores > c.object_mask_thr)[:, None, None], scores[:, None, None] * probs,
                    torch.full_like(probs, -1.0))
    top2 = torch.topk(w, 2, dim=0).values
    return top2[0] - top2[1]


def knob_run(torch, model, image, hw, forced=None):
    """One ``infer`` of ``model`` recorded (:func:`recorded`), with its
    segmenter output, the query decoder's two-stage selection (the encoder
    scores and the chosen indices) and its head outputs → (host dict,
    logits, segmenter output, (scores, indices), head outputs).  The
    selection is recorded in Python inside the segmenter, so ``segment``
    runs eagerly (:func:`segmenter_eager`); on the card its output must
    equal the main path's (its graph) on the same image bit for bit."""
    from openpsg_tpu_torch.models.segmenter import decoder

    segs, heads, picks = [], {}, []
    real_segment, real_topk = model.segment, decoder.topk_indices

    def eager_segment(img):
        with segmenter_eager():
            segs.append((img, real_segment(img)))
        return segs[-1][1]

    model.segment = eager_segment
    decoder.topk_indices = lambda x, k: picks.append((x.detach(), real_topk(x, k))) or picks[-1][1]
    hook = model.head.register_forward_hook(lambda mod, inp, o: heads.update(o))
    try:
        with recorded(model, forced=forced) as rec:
            model.infer(image, hw)
    finally:
        hook.remove()
        del model.segment
        decoder.topk_indices = real_topk
    (dev, logits), = per_image(torch, rec)
    (scores, idx), = picks
    (img, seg), = segs
    if not same_bits(torch, real_segment(img), seg):
        raise AssertionError("knobs: segment on the main path differs from its eager call")
    return dev, logits, seg, (scores.float().cpu(), idx.cpu()), heads


def phase_knobs_card_vs_cpu(torch, res, name):
    """The variant ``name`` of the harness's trained weights on the card and
    on the CPU, on the held-out images, the CPU run teacher-forced on the
    card's tokens.  Panoptic ids, kept objects, top pairs and top-100
    triplets must be equal, scores within TOL_KNOB_SCORE; where an integer
    output differs, the margin that decided it must lie within the
    tolerance (:func:`agree_ranked` for the query decoder's two-stage
    selection of encoder tokens, the top pairs and the triplets; the
    fusion's top-2 gap on the CPU for a pixel).  Where the selected queries
    differ (neighbouring tokens of one uniform cell score alike), the
    segmenter's outputs differ by more than roundoff: that image's pixels,
    objects and object scores are excused, counted, and an image whose
    objects or panoptic pixels differ is excused from the pair, triplet and
    token checks, whose inputs then differ.  Tokens: :func:`agree_tokens`.  → {output
    kind: excused count}."""
    import numpy as np

    from openpsg_tpu_torch.data.preprocess import Preprocessor, load_image_rgb
    from openpsg_tpu_torch.tools.selfcheck_knobs import variant_model

    trained = res["pipeline"]
    card, cpu = variant_model(trained, name, "cuda"), variant_model(trained, name, "cpu")
    H, _ = card._model_hw()
    pre = Preprocessor(scale=(H, H))
    root = os.path.dirname(res["ann"])
    M = card.cfg.head.max_objects_padded
    excused = {"query_ranks": 0, "pixels": 0, "object_lists": 0, "object_scores": 0,
               "head_images": 0, "pair_ranks": 0, "triplet_ranks": 0}
    runs, n_same, query_err = [], 0, 0.0
    for i, d in enumerate(res["held_out"]):
        ex = pre(load_image_rgb(os.path.join(root, d["file_name"])))
        image, hw = ex["image"].astype(np.float32), ex["img_shape"]
        da, la, sa, qa, ha = knob_run(torch, card, image, hw)
        db, lb, sb, qb, hb = knob_run(torch, cpu, image, hw, forced=fed_tokens(torch, {
            "logits": [lg.reshape(-1, lg.shape[-1]) for lg in la]}))
        same_queries = torch.equal(qa[1], qb[1])
        query_err = max(query_err, float((qa[0] - qb[0]).abs().max()))
        if not same_queries:
            agree_ranked(torch, f"knobs {name} image {i} decoder queries", TOL_KNOB_SCORE,
                         qa[1], qb[1], qa[0], qb[0])
            excused["query_ranks"] += int((qa[1] != qb[1]).sum())
        pix = da["pan_seg"] != db["pan_seg"]
        if pix.any() and not same_queries:
            excused["pixels"] += int(pix.sum())
        elif pix.any():
            gap = fusion_gap(torch, cpu, sb, hw).numpy()
            widest = float(gap[pix].max())
            if widest > TOL_KNOB_SCORE:
                raise AssertionError(f"knobs {name} image {i}: {int(pix.sum())} pixels differ, "
                                     f"one decided by a margin of {widest:.3e}")
            excused["pixels"] += int(pix.sum())
        if not (np.array_equal(da["object_ids"], db["object_ids"])
                and np.array_equal(da["object_valid"], db["object_valid"])):
            if not pix.any():
                raise AssertionError(f"knobs {name} image {i}: the object lists differ on "
                                     "equal panoptic maps")
            excused["object_lists"] += 1
            continue
        off = np.abs(da["object_scores"] - db["object_scores"]) > TOL_KNOB_SCORE
        if off.any() and same_queries:
            raise AssertionError(f"knobs {name} image {i}: object scores differ by "
                                 f"{float(np.abs(da['object_scores'] - db['object_scores']).max()):.3e}"
                                 " with the same decoder queries")
        excused["object_scores"] += int(off.sum())
        if pix.any():          # the head's object masks differ, so do its inputs
            excused["head_images"] += 1
            continue
        valid = torch.as_tensor(db["object_valid"])
        pair = torch.arange(M * M)
        pv = valid[pair // M] & valid[pair % M]
        if not bool(pv.any()):      # no pair to rank: the selections are the padding's
            for key in ("top_pair_idx", "mc_triplets"):
                if not np.array_equal(da[key], db[key]):
                    raise AssertionError(f"knobs {name} image {i}: {key} differs with no "
                                         "valid pair")
            continue
        ninf = torch.tensor(float("-inf"))
        full = [torch.where(pv, torch.sigmoid(h["binary_logits"].float().cpu()), ninf)
                for h in (ha, hb)]
        agree_ranked(torch, f"knobs {name} image {i} top_pair_idx", TOL_KNOB_SCORE,
                     torch.as_tensor(da["top_pair_idx"]).long(),
                     torch.as_tensor(db["top_pair_idx"]).long(), *full)
        excused["pair_ranks"] += int((da["top_pair_idx"] != db["top_pair_idx"]).sum())
        mc_ok = (pv & (pair // M != pair % M))[:, None]
        mc = [torch.where(mc_ok, torch.sigmoid(h["multiclass_logits"].float().cpu()), 0.0)
              for h in (ha, hb)]
        R = mc[0].shape[1]
        flat = lambda t: ((torch.as_tensor(t[:, 0]).long() * M + torch.as_tensor(t[:, 1]).long())
                          * R + torch.as_tensor(t[:, 2]).long())
        agree_ranked(torch, f"knobs {name} image {i} mc_triplets", TOL_KNOB_SCORE,
                     flat(da["mc_triplets"]), flat(db["mc_triplets"]), *mc)
        excused["triplet_ranks"] += int((flat(da["mc_triplets"]) != flat(db["mc_triplets"]))
                                        .sum())
        if np.array_equal(da["top_pair_idx"], db["top_pair_idx"]):
            n_same += 1
            T = min(int(da["decode_trips"]), int(db["decode_trips"]))
            runs.append((la[:T], lb[:T].to(la.device)))
    if runs:
        agree_tokens(torch, f"knobs {name}", runs)
    log(f"[knobs] {name} on the trained weights, card vs CPU on {len(res['held_out'])} "
        f"held-out images: {n_same} with equal objects and top pairs (their tokens held by "
        f"the margin rule); the encoder scores of the decoder's query selection within "
        f"{query_err:.3e}; outputs excused by a margin within {TOL_KNOB_SCORE:g}: {excused}")
    return excused


def phase_knobs(torch, skv, gat):
    """Phase 12e: ``tools.selfcheck_knobs`` on the card at KNOB_STEPS: both
    losses fall; the six variants graded, each over the same 8 held-out
    images; the printed ``harness`` block equal to the JAX harness's
    constants; 2 "simple" launches of the shared-KV kernel per image and
    variant (the tiny float32 Q-Former's 2 layers), none "hopper", no
    gather (path ``knobs``); the ``QDense`` routes per variant; the
    fullest variant card vs CPU (:func:`phase_knobs_card_vs_cpu`).  Prints
    the R@20 matrix and the ``KNOBCHECK`` verdict, which it asserts only
    at the harness's default steps."""
    import shutil
    import tempfile

    from openpsg_tpu_torch.ops import flash_cross_attn as fca, msda_gather as mg
    from openpsg_tpu_torch.tools import selfcheck_knobs

    seg_steps, rel_steps = KNOB_STEPS
    root = tempfile.mkdtemp(prefix="chip_smoke_knobs_")
    try:
        fca.reset_launches()
        mg.sparse_row_gather.launches = 0
        t0 = time.perf_counter()
        res = selfcheck_knobs.run(root, seg_steps=seg_steps, rel_steps=rel_steps,
                                  device="cuda", log=lambda *a: None)
        wall = time.perf_counter() - t0
        launches, by_variant, gathers = read_path_launches(fca, mg, skv, gat, "knobs")
        s = res["summary"]
        images = [d["image_id"] for d in res["held_out"]]
        log(f"[knobs] tools.selfcheck_knobs on the card ({seg_steps} + {rel_steps} steps): "
            f"R@20 {json.dumps(s['R@20'])}; mR@20 {json.dumps(s['mR@20'])}; R@50 "
            f"{json.dumps(s['R@50'])}; delta R@20 vs int8 {json.dumps(s['delta_R@20_vs_int8'])};"
            f" KNOBCHECK {'PASS' if res['ok'] else 'FAIL'} (bf16 R@20 {s['R@20']['bf16']} vs "
            f"({5 * s['harness']['chance_R@20_pct']:.1f}, 99.5)); QDense calls by route "
            f"{json.dumps(res['qdense'])}; phases (s) "
            + ", ".join(f"{k} {v:.1f}" for k, v in res["seconds"].items())
            + f" (C per variant {json.dumps({k: round(v, 1) for k, v in res['variant_seconds'].items()})});"
            f" in all {wall:.1f} s; losses {json.dumps(res['seg_losses'][0])} -> "
            f"{json.dumps(res['seg_losses'][-1])}, {json.dumps(res['rel_losses'][0])} -> "
            f"{json.dumps(res['rel_losses'][-1])}; shared-KV launches {by_variant}, "
            f"sparse_row_gather {gathers}")
        for key in ("seg_losses", "rel_losses"):
            if not res[key][-1]["loss"] < res[key][0]["loss"]:
                raise AssertionError(f"knobs: {key} did not fall")
        if list(res["results"]) != list(selfcheck_knobs.VARIANTS) or images != [
                str(i) for i in range(8, 16)] or any(
                len(r) != len(images) for r in res["results"].values()):
            raise AssertionError(f"knobs: expected six variants over the same 8 held-out "
                                 f"images, saw {[(k, len(r)) for k, r in res['results'].items()]}"
                                 f" over {images}")
        for name, (sub, *_rest) in selfcheck_knobs.VARIANTS.items():
            with open(os.path.join(root, sub, "submission", "relation.json")) as f:
                if len(json.load(f)) != len(images):
                    raise AssertionError(f"knobs: {name}'s submission is not 8 records")
        if s["harness"] != KNOB_HARNESS:
            raise AssertionError(f"knobs: harness block {s['harness']} != {KNOB_HARNESS}")
        want = {"simple": 2 * len(images) * len(selfcheck_knobs.VARIANTS), "hopper": 0}
        if by_variant != want or gathers:
            raise AssertionError(f"knobs: expected shared-KV launches {want} and no gather, "
                                 f"saw {by_variant} and {gathers}")
        for name, (_, _, quant, act) in selfcheck_knobs.VARIANTS.items():
            q = res["qdense"][name]
            if (q["int8"] > 0) != act or (q["weight_only"] > 0) != quant:
                raise AssertionError(f"knobs: {name}'s QDense routes {q}")
        if KNOB_STEPS == (700, 400) and not res["ok"]:
            raise AssertionError("knobs: the harness is not discriminative at its defaults")
        t1 = time.perf_counter()
        excused = phase_knobs_card_vs_cpu(torch, res, "int8+act+deep_prune")
        log("[knobs] stats " + json.dumps(dict(
            summary=s, ok=res["ok"], steps=KNOB_STEPS, seconds=res["seconds"],
            variant_seconds=res["variant_seconds"], qdense=res["qdense"], wall=wall,
            card_vs_cpu_s=time.perf_counter() - t1, excused=excused,
            seg_losses=res["seg_losses"], rel_losses=res["rel_losses"])))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_serving(torch, skv, gat, learned):
    """Phase 12: serving, prediction, PVSG frames, the open-set selfcheck and
    the knob-cost harness (:func:`phase_serve_full`,
    :func:`phase_serve_learned` on phase 11d's result ``learned``,
    :func:`phase_pvsg`, :func:`phase_openset`, :func:`phase_knobs`).  → 12a's
    full-width int8 model, for phase 13d."""
    t_phase = time.perf_counter()
    times = {}
    t0 = time.perf_counter()
    deploy = phase_serve_full(torch, skv, gat)
    torch.cuda.empty_cache()
    times["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, held = phase_serve_learned(torch, skv, gat, learned)
    times["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_pvsg(torch, skv, gat, learned, model, held)
    times["c"] = time.perf_counter() - t0
    del model
    t0 = time.perf_counter()
    phase_openset(torch, skv, gat)
    torch.cuda.empty_cache()
    times["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_knobs(torch, skv, gat)
    torch.cuda.empty_cache()
    times["e"] = time.perf_counter() - t0
    log(f"[serve] phase 12 in {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"12{k} {v:.1f} s" for k, v in times.items()) + ")")
    return deploy


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


def check_graph_decode(model, prefix, pmask):
    """Phase 4's LLM decode of one image's prefix at full width, replayed
    from the shape's CUDA graphs, against the same trips run eagerly (the
    graph path bypassed): tokens, scores and trips equal bit for bit."""
    import torch

    from openpsg_tpu_torch.models.llm import decode

    replays = decode.greedy_decode.graph_trips
    graph = model.tail_decode(prefix, pmask)
    real = decode._graphs
    decode._graphs = lambda llm, dev: None
    try:
        eager = model.tail_decode(prefix, pmask)
    finally:
        decode._graphs = real
    same = (graph[2] == eager[2] and torch.equal(graph[0], eager[0])
            and torch.equal(graph[1], eager[1]))
    log(f"[main] image 0's decode ({prefix.shape[0]} rows): {graph[2]} trips replayed "
        f"({decode.greedy_decode.graph_trips - replays} graph trips), eager {eager[2]} "
        f"trips; tokens, scores and trips equal bit for bit: {same}")
    assert decode.greedy_decode.graph_trips - replays == graph[2] > 0
    assert same, "graph path's decode differs from the eager trips"


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
    drift = float((fp[idx_k].clamp(min=-1e30) - sp[:k]).abs().max())
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




# ---------------------------------------------------------------- phase 13
def _torchrun(args, cwd, timeout):
    """``python -m torch.distributed.run --standalone --nproc_per_node 1``
    running ``args`` → (wall seconds, its output); fails on a nonzero exit."""
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc_per_node", "1"] + args, cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"torchrun {args[:2]} exited {r.returncode}:\n"
                             + (r.stdout + r.stderr)[-4000:])
    return wall, r.stdout + r.stderr


def _logged_metrics(work_dir):
    """The metric dicts of the train tool's log lines, in order."""
    import glob
    import re

    text = "".join(open(p).read() for p in sorted(glob.glob(os.path.join(work_dir, "*.log"))))
    rows = [ln for ln in text.splitlines() if "rel_llm_loss" in ln and "Epoch [" in ln]
    return [{k: float(v) for k, v in re.findall(r"(\w+): ([-\d.]+)", ln) if k != "time"}
            for ln in rows], text


def rank_dp_step(cfg_path, ex):
    """Phase 13c's rank: the config's model on cuda:0 (seed 0), a dp mesh
    over the 2 gloo ranks, one train step on this rank's image of the B=2
    batch → (losses, the dp-averaged head gradients, the head's float32
    masters after the update, peak memory)."""
    import torch

    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config
    from openpsg_tpu_torch.parallel.mesh import axis_group, make_mesh
    from openpsg_tpu_torch.train.trainer import (
        TrainBatch,
        V4Trainer,
        make_lr_schedule,
        make_optimizer,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_detector_from_config(Config.fromfile(cfg_path), seed=0, device="cuda:0")
    mesh = make_mesh(dp=2, tp=1)
    d = axis_group(mesh, "dp")[1]
    tr = V4Trainer(model, mesh=mesh)
    opt = make_optimizer(make_lr_schedule(steps_per_epoch=10))
    torch.cuda.reset_peak_memory_stats()
    batch = TrainBatch.from_numpy({k: v[d:d + 1] for k, v in ex.items()}, "cuda:0")
    # train_step's two halves, keeping the gradients it averaged over dp
    metrics, grads = tr._reduce_dp(*tr.gradients(batch))
    metrics["grad_norm"] = tr._update(opt, grads, opt.init(tr.master), None, model.device)
    torch.cuda.synchronize()
    return dict(loss={k: float(v) for k, v in metrics.items()},
                grads={k: g.cpu() for k, g in grads.items()},
                head={k: v.detach().cpu() for k, v in tr.master.items()},
                peak=torch.cuda.max_memory_allocated())


def phase_parallel(torch, skv, gat, train_metrics, deploy):
    """Phase 13 (see the module docstring): the distributed entry points at
    full width on one card; ``deploy`` is phase 12a's int8 model, served
    again in 13d."""
    import shutil
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config
    from openpsg_tpu_torch.ops import flash_cross_attn as fca, msda_gather as mg
    from openpsg_tpu_torch.parallel.launch import spawn
    from openpsg_tpu_torch.parallel.mesh import axis_group, init_distributed, make_mesh
    from openpsg_tpu_torch.parallel.sharding import pair_sharded_range
    from openpsg_tpu_torch.tools import infer
    from openpsg_tpu_torch.tools.dryrun_multichip import _batch
    from openpsg_tpu_torch.train.trainer import (
        TrainBatch,
        V4Trainer,
        make_lr_schedule,
        make_optimizer,
    )

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        # 13a: the train tool under the launcher, NCCL at world size 1
        ann = write_png_fixture(root, VAL_SIZES, seed=1, train_sizes=TRAIN_SIZES)
        cfg_path = os.path.join(root, "par.py")
        split = f"dict(ann_file={ann!r}, img_prefix={root!r}, seg_prefix={root!r})"
        with open(cfg_path, "w", encoding="utf-8") as f:
            f.write(f"_base_ = [{os.path.join(HERE, 'openpsg_tpu_torch/configs/psg/baseline_v4_ov.py')!r}]\n"
                    f"data = dict(train={split}, val={split}, test={split})\n"
                    "runner = dict(max_epochs=1)\nlog_config = dict(interval=1)\n"
                    "tpu = dict(mesh=dict(dp=1, tp=1))\n")
        wd = os.path.join(root, "wd")
        wall, _ = _torchrun(["-m", "openpsg_tpu_torch.tools.train", cfg_path, "--work-dir", wd,
                             "--max-steps", "2", "--launcher", "pytorch"], root, 600)
        got, text = _logged_metrics(wd)
        if "mesh: {'dp': 1, 'tp': 1}" not in text or "launcher: pytorch" not in text:
            raise AssertionError("the train tool did not form the mesh:\n" + text[-2000:])
        want = train_metrics[:2]
        bad = [(i, k, g[k], w[k]) for i, (g, w) in enumerate(zip(got, want)) for k in w
               if abs(g[k] - w[k]) > TOL_TRAIN_LOSS * abs(w[k]) + 1e-4]   # 4 decimals logged
        if len(got) != 2 or bad:
            raise AssertionError(f"torchrun train losses {got} vs phase 8b {want}: {bad}")
        log(f"[parallel] 13a train tool under torch.distributed.run (--launcher pytorch, NCCL, "
            f"world 1, mesh dp=1 tp=1), baseline_v4_ov, 2 steps in {wall:.1f} s (process "
            f"included): logged losses equal phase 8b's first two within TOL_TRAIN_LOSS: "
            + "; ".join(f"loss {g['loss']:.4f} rel_llm_loss {g['rel_llm_loss']:.4f} grad_norm "
                        f"{g['grad_norm']:.4f}" for g in got))

        model = build_detector_from_config(Config.fromfile(cfg_path), seed=0)
        n_val = len(VAL_SIZES)
        common = ["--config", cfg_path, "--test-file", ann, "--data-dir", root, "--batch-size",
                  "2", "--limit", str(n_val), "--single-bucket"]
        fca.reset_launches()
        mg.sparse_row_gather.launches = 0
        ref = infer.main(common + ["--output-dir", os.path.join(root, "ref")], model=model)
        skv["launches_by_path"]["infer_batch_tool"] = fca.flash_shared_kv_cross_attn.launches
        gat["launches_by_path"]["infer_batch_tool"] = mg.sparse_row_gather.launches
        check_variants(dict(fca.flash_shared_kv_cross_attn.launches_by_variant), n_val)
        wall_i, out = _torchrun(["-m", "openpsg_tpu_torch.tools.infer"] + common
                                + ["--output-dir", os.path.join(root, "dist")], root, 600)
        if "dp mesh over 1 ranks" not in out:
            raise AssertionError("the infer tool did not form the dp mesh:\n" + out[-2000:])
        files = sorted(os.path.relpath(os.path.join(d, f), os.path.join(root, "ref"))
                       for d, _, fs in os.walk(os.path.join(root, "ref")) for f in fs)

        def differ(run):
            return [f for f in files if not os.path.isfile(os.path.join(root, run, f))
                    or open(os.path.join(root, "ref", f), "rb").read()
                    != open(os.path.join(root, run, f), "rb").read()]

        if differ("dist") or not files:
            raise AssertionError(f"submission files differ: {differ('dist')} of {files}")

        # the same tool over the dp mesh in this process (launches counted),
        # then 13b, as rank 0 of an NCCL world of 1
        for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0").items():
            os.environ[k] = v
        init_distributed("pytorch", device="cuda", init_method="file://" + os.path.join(root, "pg"))
        try:
            fca.reset_launches()
            mg.sparse_row_gather.launches = 0
            dp_run = infer.main(common + ["--output-dir", os.path.join(root, "dp")], model=model)
            skv["launches_by_path"]["infer_batch_dp"] = fca.flash_shared_kv_cross_attn.launches
            gat["launches_by_path"]["infer_batch_dp"] = mg.sparse_row_gather.launches
            check_variants(dict(fca.flash_shared_kv_cross_attn.launches_by_variant), n_val)
            if differ("dp"):
                raise AssertionError(f"dp-mesh submission files differ: {differ('dp')}")
            log(f"[parallel] 13a infer tool --batch-size 2 --single-bucket on {n_val} images: "
                f"without a process group {ref['seconds']:.2f} s; over a dp mesh of 1 NCCL rank "
                f"in this process {dp_run['seconds']:.2f} s (shared-KV launches "
                f"{skv['launches_by_path']['infer_batch_dp']}); under torch.distributed.run "
                f"{wall_i:.1f} s with the process; {len(files)} submission files byte-equal "
                "in all three")

            # 13b: the pair axis split over the NCCL world of 1
            mesh = make_mesh(dp=1, tp=1)
            fn = model.make_pair_sharded_infer(mesh)
            H, W = BUCKET
            rng = np.random.default_rng(13)
            hws = [(H, W), (1200, 1344)]
            imgs = [rng.integers(0, 256, (H, W, 3)).astype(np.uint8) for _ in hws]
            fca.reset_launches()
            mg.sparse_row_gather.launches = 0
            t0 = time.perf_counter()
            sharded = [fn(i, hw) for i, hw in zip(imgs, hws)]
            torch.cuda.synchronize()
            t_sharded = time.perf_counter() - t0
            by_variant = dict(fca.flash_shared_kv_cross_attn.launches_by_variant)
            skv["launches_by_path"]["pair_sharded"] = fca.flash_shared_kv_cross_attn.launches
            gat["launches_by_path"]["pair_sharded"] = mg.sparse_row_gather.launches
            check_variants(by_variant, len(imgs))
            t0 = time.perf_counter()
            plains = [model.infer(i, hw) for i, hw in zip(imgs, hws)]
            torch.cuda.synchronize()
            t_plain = time.perf_counter() - t0
            for res, plain in zip(sharded, plains):
                check_result(res, (H, W))
                if (res["rel_results"] != plain["rel_results"]
                        or not np.array_equal(res["pan_results"], plain["pan_results"])
                        or not np.allclose(res["rel_scores"], plain["rel_scores"], atol=1e-5)):
                    raise AssertionError("pair-sharded inference differs from infer")
            # the gathered head outputs against the unsplit head's, on seeded
            # objects (random weights leave fusion with none at this width)
            M = model.cfg.head.max_objects_padded
            lo, hi = pair_sharded_range(mesh, M * M, "dp")
            shard = (lo, hi, axis_group(mesh, "dp")[0])
            head_outs = []
            hook = model.head.register_forward_hook(lambda mod, inp, o: head_outs.append(o))
            head_err, n_valid = 0.0, 0
            try:
                for img, hw in zip(imgs, hws):
                    seg = model.segment(torch.as_tensor(img, device=model.device))
                    syn = synthetic_objects(model, seg, model.fuse_select(seg, hw))
                    n_valid += int(syn[1].sum())
                    runs = [model.tail_pre(seg["mask_features"], *syn, pair_shard=ps)
                            for ps in (None, shard)]
                    (o1, p1, m1), (o2, p2, m2) = runs
                    for k in ("top_pair_idx", "mc_triplets"):
                        if k in o1 and not torch.equal(o1[k], o2[k]):
                            raise AssertionError(f"pair-sharded {k} differs from the unsplit head")
                    if not torch.equal(m1, m2):
                        raise AssertionError("pair-sharded prefix mask differs")
                    floats = [(o1[k], o2[k]) for k in ("top_pair_scores", "mc_scores") if k in o1]
                    floats += [(p1, p2)] + [(head_outs[-2][k], head_outs[-1][k])
                                            for k in ("binary_logits", "multiclass_logits",
                                                      "llm_visual_tokens") if k in head_outs[-1]]
                    for x, y in floats:
                        err = float((x.float() - y.float()).abs().max())
                        head_err = max(head_err, err / max(1.0, float(x.float().abs().max())))
            finally:
                hook.remove()
            if head_err > TOL_F32:
                raise AssertionError(f"pair-sharded head outputs differ by {head_err:.3g}")
            log(f"[parallel] 13b make_pair_sharded_infer over an NCCL world of 1 (NP = 1024 "
                f"pairs per rank): {len(imgs)} images in {t_sharded:.2f} s ({t_plain:.2f} s "
                f"through infer after it), shared-KV launches {by_variant}; results equal "
                f"infer; on 30 seeded objects per image ({n_valid} valid in all) the gathered "
                f"head logits, visual tokens, top pairs and LLM prefix equal the unsplit "
                f"head's (largest difference {head_err:.3g} of scale, tol {TOL_F32:g})")
            phase_serve_dp(torch, skv, gat, deploy, root)
        finally:
            dist.destroy_process_group()
            for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
                os.environ.pop(k, None)

        # 13c: one dp=2 step as 2 gloo ranks sharing cuda:0, against one
        # process at B=2 on the same weights and batch
        ex = _batch(model, np.random.default_rng(3), 2)
        tr = V4Trainer(model)
        opt = make_optimizer(make_lr_schedule(steps_per_epoch=10))
        ref_loss, ref_grads = tr.gradients(TrainBatch.from_numpy(ex, "cuda"))
        ref_loss["grad_norm"] = tr._update(opt, ref_grads, opt.init(tr.master), None,
                                           model.device)
        ref = ({k: float(v) for k, v in ref_loss.items()},
               {k: g.cpu() for k, g in ref_grads.items()},
               {k: v.detach().cpu() for k, v in tr.master.items()})
        del model, tr, ref_loss, ref_grads
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn("chip_smoke:rank_dp_step", 2, os.path.join(root, "dp2"), args=(cfg_path, ex),
                      device="cuda:0", backend="gloo", timeout_s=600)
        wall_c = time.perf_counter() - t0
        errs = []
        largest = max(float(g.abs().max()) for g in ref[1].values())
        for r, res in enumerate(ranks):
            # the dp mean of the two ranks' gradients against the B=2 step's
            # (which adds its images' gradients in float32 too), leaf by
            # leaf, as phase 8a holds the card against the CPU
            loss_err, grad_err, zero, upd_err = step_agreement(
                {"cpu": ref, "card": (res["loss"], res["grads"], res["head"])})
            diff = max(float((res["grads"][k] - g).abs().max()) for k, g in ref[1].items())
            errs.append((loss_err, grad_err, upd_err, diff / largest))
            if (loss_err > TOL_TRAIN_LOSS or grad_err > TOL_TRAIN_GRAD
                    or upd_err > TOL_TRAIN_UPDATE):
                raise AssertionError(f"rank {r}: losses {res['loss']} vs {ref[0]} (largest "
                                     f"relative difference {loss_err:.3g}); gradient leaves "
                                     f"within {grad_err:.3g} of the leaf; head after the update "
                                     f"within {upd_err:.3g}")
        loss_err, grad_err, upd_err, diff = (max(e[i] for e in errs) for i in range(4))
        log(f"[parallel] 13c dp=2 train step, 2 gloo ranks sharing cuda:0, baseline_v4_ov: "
            f"{wall_c:.1f} s with the processes; against the single-process B=2 step: losses "
            f"within {loss_err:.3e} relative (tol {TOL_TRAIN_LOSS:g}; loss "
            f"{ranks[0]['loss']['loss']:.4f} vs {ref[0]['loss']:.4f}, grad_norm "
            f"{ranks[0]['loss']['grad_norm']:.4f} vs {ref[0]['grad_norm']:.4f}), the dp-averaged "
            f"gradients of {len(ref[1])} head leaves within {grad_err:.3e} of the leaf (tol "
            f"{TOL_TRAIN_GRAD:g}; {len(zero)} leaves 0 up to roundoff, held to 1e-5 of the "
            f"largest gradient; largest difference of any entry {diff:.3e} of the largest "
            f"gradient), head masters after the "
            f"update within {upd_err:.3g} (tol {TOL_TRAIN_UPDATE:g}); peak memory per rank "
            + ", ".join(f"{r['peak'] / 2**30:.2f} GiB" for r in ranks))
        log(f"[parallel] phase 13 in {time.perf_counter() - t_phase:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_serve_dp(torch, skv, gat, model, root):
    """Phase 13d: ``tools.serve`` over a dp mesh of the NCCL world of 1 that
    13a-13b stand in (``make_server`` builds it: ``--batch-size 2``, no
    micro-batch), serving phase 12a's full-width int8 model: 4 of 13a's PNGs
    posted at once, twice.  The first round is the model as it stands (its
    time is set beside 12a's); seeded random weights leave fusion no object
    at this width, so the records are void.  The second round replaces the
    fused objects with 30 seeded regions whose seed is the image's checksum
    (at trip budget 2), so each record holds that image's objects.  Every
    record equals ``infer`` of the same preprocessed image through
    ``_record_for`` (relation scores within TOL_F32 absolute, the rest
    exact), and the seeded records differ image by image; 2 hopper launches
    per computed image, counted as path ``serve_dp``.  Then the port's tiny
    float32 Llama fed a ``decouple_label_masks`` ``full_mask``, with and
    without a cache, on the card against the CPU."""
    import zlib

    import numpy as np

    from openpsg_tpu_torch.ops import flash_cross_attn as fca, msda_gather as mg
    from openpsg_tpu_torch.tools import serve

    t_phase = time.perf_counter()
    cfg = os.path.join(root, "deploy.py")
    with open(cfg, "w", encoding="utf-8") as f:
        f.write(f"_base_ = [{os.path.join(HERE, 'openpsg_tpu_torch/configs/psg/baseline_v4_ov.py')!r}]\n"
                + TOOL_INT8)
    paths = [os.path.join(root, f"{i}.png") for i in range(4)]
    bodies = [open(p, "rb").read() for p in paths]
    argv = ["--config", cfg, "--port", "0", "--single-bucket", "--batch-size", "2",
            "--max-wait-ms", "1000"]
    checksum, segment, fuse_select = [], model.segment, model.fuse_select

    def seeded_segment(image):
        checksum[:] = [zlib.crc32(image.cpu().numpy().tobytes())]
        return segment(image)

    def seeded_objects(seg, hw):
        return synthetic_objects(model, seg, fuse_select(seg, hw), seed=checksum[0])

    def infer_each(service, budget):
        out = []
        for body in bodies:
            job = service._make_job(serve.decode_image(body))
            out.append(serve._record_for(model.infer(job.ex["image"].astype(np.float32),
                                                     job.ex["img_shape"], budget), job.ex, 0))
        return out

    rounds = {}
    with served(argv, model) as (addr, service):
        if service.mesh is None or dict(zip(service.mesh.mesh_dim_names,
                                            service.mesh.shape)) != {"dp": 1, "tp": 1}:
            raise AssertionError(f"make_server built no dp mesh of 1: {service.mesh}")
        groups, batch = [], model.infer_batch
        model.infer_batch = lambda imgs, *a, **k: groups.append(len(imgs)) or batch(imgs, *a, **k)
        try:
            with computed_images(model) as sizes:
                fca.reset_launches()
                mg.sparse_row_gather.launches = 0
                rounds["fused"] = post_concurrently(addr, bodies)
                model.segment, model.fuse_select = seeded_segment, seeded_objects
                service.trip_budget = 2
                rounds["seeded"] = post_concurrently(addr, bodies)
                launches, by_variant, gathers = read_path_launches(fca, mg, skv, gat,
                                                                   "serve_dp")
        finally:
            for k in ("infer_batch", "segment", "fuse_select"):
                model.__dict__.pop(k, None)
        t0 = time.perf_counter()
        with torch.inference_mode():
            want = {"fused": infer_each(service, None)}
            model.segment, model.fuse_select = seeded_segment, seeded_objects
            try:
                want["seeded"] = infer_each(service, 2)
            finally:
                del model.segment, model.fuse_select
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    worst = 0.0
    for name, (out, _) in rounds.items():
        for i, ((status, rec), w) in enumerate(zip(out, want[name])):
            if status != 200:
                raise AssertionError(f"serve_dp {name} request {i}: status {status}: {rec}")
            rec = dict(rec)
            rec.pop("latency_ms")
            if any(rec[k] != w[k] for k in w if k != "relation_scores") or set(rec) != set(w):
                raise AssertionError(f"serve_dp {name} request {i}: record differs from infer's")
            if rec["relation_scores"]:
                worst = max(worst, float(np.abs(np.subtract(rec["relation_scores"],
                                                            w["relation_scores"])).max()))
    if worst > TOL_F32:
        raise AssertionError(f"serve_dp relation scores differ by {worst:.3g}")
    seeded = want["seeded"]
    n_obj = [len(r["segments_info"]) for r in seeded]
    if min(n_obj) == 0 or len({json.dumps(r["segments_info"]) for r in seeded}) != len(seeded):
        raise AssertionError(f"serve_dp seeded records hold {n_obj} objects and do not differ "
                             "image by image")
    n = sum(sizes)
    check_variants(by_variant, n)
    if gathers:
        raise AssertionError(f"sparse_row_gather launched {gathers} times in serve_dp")
    if groups != [2, 2, 2, 2]:
        raise AssertionError(f"serve_dp ran groups {groups} through infer_batch, not [2] * 4")
    (out, wall), (out2, wall2) = rounds["fused"], rounds["seeded"]
    lat = [r["latency_ms"] for _, r in out]
    log(f"[parallel] 13d tools.serve over a dp mesh of 1 NCCL rank (--batch-size 2, full-width "
        f"int8 model of 12a): 4 concurrent requests in {wall:.2f} s ({4 / wall:.3f} "
        f"requests/s, {wall / 4 * 1e3:.1f} ms per request), latency_ms p50 "
        f"{statistics.median(lat):.1f}, max {max(lat):.1f}; with 30 seeded objects per image "
        f"at trip budget 2: {wall2:.2f} s ({wall2 / 4 * 1e3:.1f} ms per request), objects "
        f"{n_obj}, relations {[len(r['relations']) for r in seeded]}; infer_batch groups over "
        f"the mesh {groups} ({n} images computed); records equal infer's on the same images "
        f"({plain_s:.2f} s for the 8 through infer; relation scores within {worst:.3g}); "
        f"flash_shared_kv_cross_attn launches {by_variant}, sparse_row_gather {gathers}")
    llama_full_mask(torch)
    log(f"[parallel] 13d in {time.perf_counter() - t_phase:.1f} s")


def llama_full_mask(torch):
    """The port's tiny float32 Llama fed ``decouple_label_masks``'s
    ``full_mask`` (and its positions), with and without a cache of the
    whole length, on the card against the CPU on the same weights: logits
    within TOL_F32 of their scale.  Also logs whether the JAX-file readers'
    packages (tensorstore, msgpack) import here."""
    import importlib.util

    import numpy as np

    from openpsg_tpu_torch.models.llm.llama import (
        LlamaConfig,
        LlamaWithEmbeddings,
        decouple_label_masks,
    )

    torch.manual_seed(0)
    cfg = LlamaConfig.tiny_test(vocab_size=64)
    cpu = LlamaWithEmbeddings(cfg).eval()
    card = LlamaWithEmbeddings(cfg).eval()
    card.load_state_dict(cpu.state_dict())
    card = card.cuda()
    ids = np.array([[7, 8, 50, 20, 51, 22, 51, 0], [9, 8, 50, 21, 23, 51, 24, 25]])
    full, pos = decouple_label_masks(ids, 50, 51, decouple_positions=True)
    attn = ids != 0
    worst = 0.0
    for cached in (False, True):
        outs = {}
        for dev, m in (("cpu", cpu), ("cuda", card)):
            t = lambda a, dt=None: torch.as_tensor(a, device=dev, dtype=dt)
            with torch.no_grad():
                if not cached:
                    outs[dev] = m(token_ids=t(ids, torch.long), attention_mask=t(attn),
                                  positions=t(pos, torch.long), full_mask=t(full))[0].cpu()
                    continue
                hd = cfg.dim // cfg.n_heads
                shape = (cfg.n_layers, 2, ids.shape[1], cfg.n_kv_heads, hd)
                cache = (torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))
                parts = [m(token_ids=t(ids[:, lo:hi], torch.long), attention_mask=t(attn),
                           positions=t(pos[:, lo:hi], torch.long), cache=cache,
                           cache_index=lo, key_positions=t(pos, torch.long),
                           full_mask=t(full[:, lo:hi]))[0].cpu() for lo, hi in ((0, 3), (3, 8))]
                outs[dev] = torch.cat(parts, 1)
        err = float((outs["cuda"] - outs["cpu"]).abs().max()) / max(
            1.0, float(outs["cpu"].abs().max()))
        worst = max(worst, err)
    if worst > TOL_F32:
        raise AssertionError(f"Llama with a decoupled full_mask: card vs CPU {worst:.3g}")
    have = {m: importlib.util.find_spec(m) is not None for m in ("tensorstore", "msgpack")}
    log(f"[parallel] 13d tiny Llama with a decouple_label_masks full_mask (no cache, and a "
        f"cache filled in 2 blocks), card vs CPU: logits within {worst:.3g} of scale (tol "
        f"{TOL_F32:g}); the JAX-file readers' packages import here: "
        + ", ".join(f"{k} {'yes' if v else 'no'}" for k, v in have.items())
        + ("" if have["tensorstore"] else " (so reading a JAX orbax checkpoint, for "
           "inference or to resume a JAX run's training, runs in the CPU tests only)"))


BENCH_SMOKE_ITERS = 2   # samples per stage, variant, step and family in phase 14
BENCH_HOST_SMOKE_ITERS = 5
BENCH_FAMILIES = ("v1", "v2", "v3")


def phase_bench_tools(torch, skv, gat, deploy):
    """Phase 14: the port's five measurement tools at 1344² on the card, each
    through its ``run`` at BENCH_SMOKE_ITERS samples (their own defaults are
    run alone): (a) ``bench_stages`` on ``deploy`` (phase 12a's int8
    deployment model), every stage, kernel 1 launched as path
    ``bench_stages``; (b) ``probe_msda_variants`` on the JAX tool's uniform
    inputs and on ``deploy``'s own first encoder call (its points per level),
    every variant held against v0 before it is timed, kernel 2 launched as
    path ``probe_msda``; (c) ``bench_train`` at its default recipe (frozen
    int8 Llama-2-7B, 32 layers), no launch (path ``bench_train``); (d)
    ``bench_family`` for v1, v2 and v3, no launch (path ``bench_family``);
    (e) ``bench_host`` at 1344².  Each record must carry the card's name and
    power limit."""
    import math

    import numpy as np

    from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config
    from openpsg_tpu_torch.ops import flash_cross_attn as fca, msda_gather as mg
    from openpsg_tpu_torch.tools import (
        bench_family,
        bench_host,
        bench_stages,
        bench_train,
        probe_msda_variants as probe,
    )
    from openpsg_tpu_torch.utils.profiling import device_record

    t_phase = time.perf_counter()
    label = device_record("cuda")
    if label != smi_line():
        raise AssertionError(f"device record {label!r} is not nvidia-smi's {smi_line()!r}")
    iters = BENCH_SMOKE_ITERS
    H, W = BUCKET
    times = {}

    def finite(name, x):
        if not (isinstance(x, (int, float)) and math.isfinite(x) and x > 0):
            raise AssertionError(f"{name}: {x!r} is not a positive finite number")

    def fresh():
        torch.cuda.synchronize()
        fca.reset_launches()
        mg.sparse_row_gather.launches = 0

    # 14a
    t0 = time.perf_counter()
    fresh()
    rec = bench_stages.run(deploy, iters=iters, device_label=label)
    launches, by_variant, gathers = read_path_launches(fca, mg, skv, gat, "bench_stages")
    sc = deploy.cfg.segmenter
    want = ["swin_backbone", f"pixel_decoder_{sc.enc_layers}L", "msda_core_1layer_encoder_geom",
            "msda_core_1layer_decoder_geom", f"query_decoder_{sc.dec_layers}L_{sc.num_queries}q"]
    missing = [n for n in want if n not in rec["stages_ms"]]
    if missing or len(rec["stages_ms"]) != 17:
        raise AssertionError(f"bench_stages stages {sorted(rec['stages_ms'])}: missing {missing}")
    for name, ms in rec["stages_ms"].items():
        finite(f"bench_stages {name}", ms)
    if by_variant["simple"] or by_variant["hopper"] < 2 or gathers:
        raise AssertionError(f"bench_stages launches: shared-KV {by_variant}, gather {gathers}")
    if rec["flash_shared_kv_cross_attn_launches_by_variant"] != by_variant:
        raise AssertionError("bench_stages' own launch count differs from the counter's")
    share = rec["msda_share_of_segmenter"]
    log(f"[bench] 14a bench_stages on the int8 deployment model at {H}x{W}: "
        + ", ".join(f"{n} {ms:.3f}" for n, ms in rec["stages_ms"].items())
        + f" ms; segmenter split {rec['segmenter_split_sum_ms']:.1f} ms against infer's "
        f"segmenter {rec['infer_segmenter_ms']:.1f} ms; deformable attention's share of the "
        f"segmenter: encoder {share['encoder']:.3f}, decoder {share['decoder']:.3f}; decode "
        f"trips {rec['decode_trips']}; shared-KV launches {by_variant}")
    times["a"] = time.perf_counter() - t0

    # 14b
    t0 = time.perf_counter()
    fresh()
    shapes = probe.encoder_shapes(H)
    value, loc, aw = probe.uniform_inputs(shapes, "cuda")
    recs = [probe.run(value, shapes, loc, aw, iters=iters, label="uniform", device_label=label)]
    del value, loc, aw
    torch.cuda.empty_cache()
    img = torch.as_tensor(np.random.default_rng(0).integers(0, 255, (H, W, 3)).astype(np.uint8),
                          device="cuda")
    _, msda = first_msda_call(lambda: deploy.segment(img))
    recs.append(probe.run(*msda, points_per_level=sc.enc_points_per_level, iters=iters,
                          label="main path: first encoder call", device_label=label))
    del msda
    torch.cuda.empty_cache()
    launches, by_variant, gathers = read_path_launches(fca, mg, skv, gat, "probe_msda")
    if gathers < 1 or launches:
        raise AssertionError(f"probe launches: gather {gathers}, shared-KV {launches}")
    for r in recs:
        if sorted(r["variants"]) != sorted(probe.VARIANTS):
            raise AssertionError(f"probe variants {sorted(r['variants'])}")
        for v, e in r["variants"].items():
            finite(f"probe {v}", e["median_ms"])
        log(f"[bench] 14b probe_msda_variants, {r['inputs']} inputs "
            f"{r['geometry']}: " + ", ".join(
                f"{v} {e['median_ms']:.3f} ms (IQR {e['q1_ms']:.3f}-{e['q3_ms']:.3f}, bound "
                f"{e['bound_ms']:.4f}" + (f", vs v0 {e['max_abs_diff_vs_v0']:.3g} <= "
                                          f"{e['tol']:.3g}" if "tol" in e else "") + ")"
                for v, e in r["variants"].items())
            + f"; sparse_row_gather launches {r['sparse_row_gather_launches']}, "
            f"ms_deform_attn launches {r['ms_deform_attn_launches']}")
    times["b"] = time.perf_counter() - t0

    # 14c
    t0 = time.perf_counter()
    fresh()
    model = PSGv4(bench_stages.model_config(H), seed=0, device="cuda")
    rec = bench_train.run(model, iters=iters, device_label=label)
    launches, by_variant, gathers = read_path_launches(fca, mg, skv, gat, "bench_train")
    finite("bench_train s/step", rec["value"])
    for loss in rec["losses"]:
        finite("bench_train loss", loss)
    if launches or gathers:
        raise AssertionError(f"bench_train launches: shared-KV {by_variant}, gather {gathers}")
    log(f"[bench] 14c bench_train {rec['metric']}: {rec['value']:.4f} s/step (IQR "
        f"{rec['q1_s']:.4f}-{rec['q3_s']:.4f}), peak {rec['peak_gib']:.2f} GiB, losses "
        f"{[round(x, 4) for x in rec['losses']]}, shared-KV launches {launches}")
    del model
    torch.cuda.empty_cache()
    times["c"] = time.perf_counter() - t0

    # 14d
    t0 = time.perf_counter()
    fresh()
    for fam in BENCH_FAMILIES:
        model, build_s = bench_family.build(fam, "cuda")
        rec = bench_family.run(model, fam, str(H), iters, (H, W), build_s, label)
        finite(f"bench_family {fam}", rec["value"])
        log(f"[bench] 14d bench_family {rec['metric']}: {rec['value']:.3f} img/s "
            f"({rec['detail']['ms_per_image']:.1f} ms, IQR {rec['detail']['q1_ms']:.1f}-"
            f"{rec['detail']['q3_ms']:.1f}), built in {build_s:.1f} s, peak "
            f"{rec['detail']['peak_gib']:.2f} GiB")
        del model
        torch.cuda.empty_cache()
    launches, by_variant, gathers = read_path_launches(fca, mg, skv, gat, "bench_family")
    if launches or gathers:
        raise AssertionError(f"bench_family launches: shared-KV {by_variant}, gather {gathers}")
    times["d"] = time.perf_counter() - t0

    # 14e
    t0 = time.perf_counter()
    pipe = PSGv4(PSGv4Config.tiny_test(), seed=0, device="cuda")
    rec = bench_host.run(pipe, H, BENCH_HOST_SMOKE_ITERS, device_label=label)
    for key in ("postprocess_ms", "paint_indexed_ms", "png_palette_ms", "writer_add_ms"):
        finite(f"bench_host {key}", rec[key])
    log(f"[bench] 14e bench_host at {H}: infer host path {rec['infer_host_ms_per_image']:.2f} "
        f"ms per image (postprocess {rec['postprocess_ms']:.2f}, writer {rec['writer_add_ms']:.2f}"
        f"), serve host path {rec['serve_host_ms_per_image']:.2f} (paint "
        f"{rec['paint_indexed_ms']:.2f}, PNG {rec['png_palette_ms']:.2f}, base64 "
        f"{rec['serve_b64_ms']:.3f}), on {rec['host']}")
    times["e"] = time.perf_counter() - t0
    log(f"[bench] phase 14 in {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"14{k} {v:.1f} s" for k, v in times.items()) + ")")


if __name__ == "__main__":
    rc = main()
    if rc == 0:
        import torch

        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    sys.exit(rc)
