"""Batched PSG inference server (counterpart of ``tools/serve.py``).

    python -m openpsg_tpu_torch.tools.serve --config C [--checkpoint DIR [--epoch N]]
        [--batch-size 4 --micro-batch] [--max-wait-ms 10] [--single-bucket]
        [--decode-trip-budget N] [--host H --port P] [--device cpu]

The server owns the model and one device loop, and batches concurrent
requests:

  * a request's image is decoded and preprocessed on its HTTP handler
    thread, then queued;
  * one device-owner thread drains the queue: after the first request it
    waits up to ``--max-wait-ms`` for up to ``--batch-size`` requests,
    groups them by resolution bucket, drops the requests whose caller gave
    up, and runs each group: a group of one through ``infer``; a larger one
    padded to ``--batch-size`` with copies of its last image, through
    ``infer_microbatch`` (``--micro-batch``, PSG v4 only: one flattened LLM
    prefill and decode for the group) or ``infer_batch``; an error reaches
    every caller of the group;
  * every bucket is run once at startup at 1 and ``--batch-size`` images
    (``--no-warmup`` skips), so no request pays for first-call set-up.

Under ``python -m torch.distributed.run`` (``RANK`` and ``WORLD_SIZE``
set) every rank joins the process group (:func:`init_distributed`) and
builds the model on its own device.  With ``--batch-size`` > 1, no
``--micro-batch`` and the batch a multiple of the world size, the server
builds a dp mesh over every rank (the JAX ``tools/serve.py`` builds one
over the devices on the same condition), and a group of more than one
image runs ``infer_batch(mesh=)``: each rank its block of the padded
group, the results gathered to every rank.  Rank 0 alone binds HTTP, holds
the queue and answers; a group of one runs ``infer`` on rank 0 alone, as
in JAX.  The other ranks follow (:class:`Follower`): for every group that
runs over the mesh, rank 0 first sends them (images, valid sizes, trip
budget), so every rank enters the same collectives in the same order;
``stop()`` sends them a stop message, after which every rank returns.

The control messages travel on a gloo group of their own whose timeout is
:data:`CONTROL_TIMEOUT_S` (a week): a follower waits there between
requests, for as long as the server stays idle, where the process group's
own collective timeout (``parallel.mesh.DEFAULT_TIMEOUT_S``, 60 s) would
end it.  The collectives inside a group's ``infer_batch`` keep the short
timeout: there every rank is working.  A group whose block raises on any
rank fails on every rank (``dp_map`` gathers the error): rank 0 returns it
to the group's callers, and every rank goes on serving.  A collective that
fails (its timeout, a lost rank) ends the follower, and with it the
launched server.  Without a launcher no process group is formed and no mesh
is built.

``--decode-trip-budget N`` caps a PSG v4 request's LLM decode at N trips.
It is an argument of every call (``InferenceService.trip_budget``), so
changing it rebuilds nothing; 0 means zero trips (the JAX package reads 0
as uncapped).  The device loop runs under ``torch.inference_mode()``: grad
mode is per thread in PyTorch, and a thread starts with it on.

API (stdlib ``http.server``):
  POST /infer     body = image bytes: anything cv2 decodes, or PNG without
                  cv2 (the port's PNG reader); 400 ``undecodable image``
                  otherwise → JSON record shaped like ``tools/predict.py``'s:
                  {relations (1-indexed), relation_scores, segments_info,
                   pan_seg_png (base64 PNG, rgb2id ids), object_id_list,
                   latency_ms}
  GET  /healthz   → {"status": "ok", device, buckets, batch_size}

Any config the builder resolves is served: PSG v4 and the closed-set v1-v3
family.  Runs on the card unless ``--device cpu`` is given, and raises when
asked for the card without one.  ``make_server(args, model=...)`` serves a
ready model in place of building one.
"""

from __future__ import annotations

import argparse
import base64
import datetime
import json
import os
import queue
import struct
import threading
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist

from openpsg_tpu_torch.data.preprocess import resize_nearest
from openpsg_tpu_torch.parallel.comm import BlockFailed
from openpsg_tpu_torch.utils.image_io import PNG_SIGNATURE, _cv2, decode_png, encode_palette_png
from openpsg_tpu_torch.utils.submission import paint_panoptic_indexed, relations_1indexed


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m openpsg_tpu_torch.tools.serve")
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--epoch", type=int, default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8265)
    ap.add_argument("--batch-size", type=int, default=1,
                    help="most images per device step; a group of more than one runs "
                         "infer_batch (or infer_microbatch with --micro-batch)")
    ap.add_argument("--micro-batch", action="store_true",
                    help="with --batch-size > 1 (PSG v4): run a group through the "
                         "micro-batch program (one flattened LLM prefill and decode)")
    ap.add_argument("--max-wait-ms", type=float, default=10.0,
                    help="how long the device loop waits to fill a batch after the "
                         "first request")
    ap.add_argument("--img-scale", type=int, nargs=2, default=(1333, 1333))
    ap.add_argument("--single-bucket", action="store_true",
                    help="pad every image to the square cap (one bucket)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the startup run of each bucket")
    ap.add_argument("--decode-trip-budget", type=int, default=None,
                    help="PSG v4: cap each request's LLM decode at N trips, an argument "
                         "of every call (0 = zero trips; default max_new_tokens)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; pass cpu for the CPU path)")
    return ap.parse_args(argv)


# how long a follower may wait for rank 0's next message: an idle server
# sends none
CONTROL_TIMEOUT_S = 7 * 24 * 3600


def _control_group(mesh):
    """The control channel of a mesh that spans more than this process (a
    gloo group of every rank, long timeout; made collectively on every
    rank), else None."""
    if mesh is None or not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return dist.new_group(backend="gloo",
                          timeout=datetime.timedelta(seconds=CONTROL_TIMEOUT_S))


def _broadcast(msg, group):
    box = [msg]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def wants_dp_mesh(batch_size: int, micro_batch: bool, world: int) -> bool:
    """The JAX server's rule (tools/serve.py:288-297) with the launched
    world in place of the device count: a dp mesh when a group can hold
    more than one image, the micro-batch program is not asked for, and the
    batch splits evenly over the ranks.  The port builds it only inside a
    process group, and then at a world of one too (the identity split)."""
    return batch_size > 1 and not micro_batch and batch_size % world == 0


class _Job:
    __slots__ = ("ex", "bucket", "event", "result", "error", "cancelled")

    def __init__(self, ex, bucket):
        self.ex, self.bucket = ex, bucket
        self.event = threading.Event()
        self.result = self.error = None
        self.cancelled = False   # set by submit() on timeout: the device loop
        #                          drops the job instead of computing it


class InferenceService:
    """Owns the model and the device loop; ``submit`` is thread-safe.
    ``trip_budget`` (PSG v4) is read at every call.  ``mesh``: a dp mesh
    for ``infer_batch``; where it spans other ranks, they must run a
    :class:`Follower` (its constructor and this one make the control
    channel together)."""

    def __init__(self, model, preproc, batch_size=1, max_wait_s=0.01, mesh=None,
                 micro_batch=False, trip_budget=None):
        self.model = model
        self.preproc = preproc
        self.batch_size = max(batch_size, 1)
        self.max_wait_s = max_wait_s
        self.mesh = mesh
        self.micro_batch = micro_batch
        self.trip_budget = trip_budget
        self.control = _control_group(mesh)
        self.queue: "queue.Queue[_Job]" = queue.Queue()
        self._stop = threading.Event()
        self.worker = threading.Thread(target=self._loop, daemon=True)
        self.worker.start()

    # -- client side ----------------------------------------------------
    def _make_job(self, image_rgb: np.ndarray) -> _Job:
        bucket = self.preproc.bucket_for(*image_rgb.shape[:2])
        ex = self.preproc(image_rgb, bucket=bucket)
        ex["ori"] = image_rgb.shape[:2]
        return _Job(ex, bucket)

    def submit(self, image_rgb: np.ndarray, timeout: float = 1800.0):
        """Preprocess and queue one RGB image; block until its result →
        (result, preprocessed example)."""
        job = self._make_job(image_rgb)
        self.queue.put(job)
        if not job.event.wait(timeout):
            job.cancelled = True
            raise TimeoutError("inference timed out")
        if job.error is not None:
            raise job.error
        return job.result, job.ex

    # -- device side -----------------------------------------------------
    def _loop(self):
        try:
            self._serve_queue()
        finally:
            if self.control is not None:   # release the followers
                _broadcast(("stop",), self.control)

    def _serve_queue(self):
        with torch.inference_mode():
            while not self._stop.is_set():
                try:
                    first = self.queue.get(timeout=0.1)
                except queue.Empty:
                    continue
                batch = [first]
                deadline = time.time() + self.max_wait_s
                while len(batch) < self.batch_size:
                    rest = deadline - time.time()
                    if rest <= 0:
                        break
                    try:
                        batch.append(self.queue.get(timeout=rest))
                    except queue.Empty:
                        break
                groups = {}
                for job in batch:
                    if not job.cancelled:
                        groups.setdefault(job.bucket, []).append(job)
                for jobs in groups.values():
                    self._run_group(jobs)

    def _run_group(self, jobs):
        jobs = [j for j in jobs if not j.cancelled]
        if not jobs:
            return
        kw = {} if self.trip_budget is None else {"trip_budget": self.trip_budget}
        try:
            if len(jobs) == 1:
                job = jobs[0]
                job.result = self.model.infer(job.ex["image"].astype(np.float32),
                                              job.ex["img_shape"], **kw)
                job.event.set()
                return
            pads = self.batch_size - len(jobs)
            imgs = np.stack([j.ex["image"].astype(np.float32) for j in jobs]
                            + [jobs[-1].ex["image"].astype(np.float32)] * pads)
            hws = np.asarray([j.ex["img_shape"] for j in jobs]
                             + [jobs[-1].ex["img_shape"]] * pads, np.int32)
            if self.micro_batch:
                results = self.model.infer_microbatch(imgs, hws, **kw)
            else:
                if self.control is not None:
                    _broadcast(("batch", imgs, hws, kw), self.control)
                results = self.model.infer_batch(imgs, hws, mesh=self.mesh, **kw)
            for job, res in zip(jobs, results):
                job.result = res
                job.event.set()
        except Exception as e:  # the device's error reaches each caller
            for job in jobs:
                if not job.event.is_set():
                    job.error = e
                    job.event.set()

    def warmup(self):
        """Run every bucket once before serving: one image, and
        ``batch_size`` images when that is more (a window that does not
        fill still runs single images)."""
        buckets = list(self.preproc.buckets or [self.preproc.bucket_hw])
        for b in buckets:
            img = np.zeros((b[0], b[1], 3), np.uint8)
            for n in sorted({1, self.batch_size}):
                t0 = time.time()
                jobs = [self._make_job(img) for _ in range(n)]
                for j in jobs:
                    self.queue.put(j)
                for j in jobs:
                    j.event.wait(1800.0)
                    if j.error is not None:
                        raise j.error
                print(f"warmed bucket {b[0]}x{b[1]} batch {n} in {time.time() - t0:.1f}s",
                      flush=True)

    def stop(self):
        """End the device loop after its current group; the followers are
        sent their stop message as it ends."""
        self._stop.set()
        self.worker.join(timeout=None if self.control is not None else 5)


class Follower:
    """A rank other than 0 of a server whose dp mesh spans ranks: runs its
    block of every group rank 0 sends through ``infer_batch(mesh=)`` until
    the stop message.  The constructor makes the control channel together
    with rank 0's :class:`InferenceService`."""

    def __init__(self, model, mesh):
        self.model = model
        self.mesh = mesh
        self.control = _control_group(mesh)
        self.groups = 0

    def run(self) -> int:
        """Follow rank 0 until it stops → the number of groups run (failed
        ones too)."""
        if self.control is None:
            return 0
        with torch.inference_mode():
            while True:
                msg = _broadcast(None, self.control)
                if msg[0] == "stop":
                    return self.groups
                _, imgs, hws, kw = msg
                self.groups += 1
                try:
                    self.model.infer_batch(imgs, hws, mesh=self.mesh, **kw)
                except BlockFailed as e:   # rank 0 answers its callers with it
                    print(f"[rank {dist.get_rank()}] group {self.groups} failed: {e}",
                          flush=True)


def decode_image(raw: bytes):
    """Request body → [h, w, 3] uint8 RGB, or None when it is no image:
    cv2 where it can be imported, else the port's PNG reader."""
    cv2 = _cv2()
    if cv2 is not None:
        bgr = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
        return None if bgr is None else bgr[..., ::-1]
    if raw[:8] != PNG_SIGNATURE:
        return None
    try:
        return decode_png(raw)
    except (ValueError, IndexError, zlib.error, struct.error):   # damaged or unsupported
        return None


def _record_for(res, ex, seed: int):
    """``tools/predict.py``-shaped record of one result: the pan map cropped
    to the image's valid region, resized back to its original size
    (nearest, as cv2 does), painted and encoded as an 8-bit palette PNG."""
    nh, nw = ex["img_shape"]
    pan_ori = resize_nearest(res["pan_results"][:nh, :nw], ex["ori"]).astype(np.int64)
    idx, palette, segments_info, kept, _ = paint_panoptic_indexed(
        pan_ori, res["rel_results"]["object_id_list"], seed=seed)
    png = encode_palette_png(idx, palette)
    return dict(
        object_id_list=kept,
        relations=relations_1indexed(res["rel_results"]["relation"]),
        relation_scores=[float(s) for s in res.get("rel_scores", [])],
        segments_info=segments_info,
        pan_seg_png=base64.b64encode(png).decode("ascii"),
    )


def make_server(args, model=None):
    """→ (``ThreadingHTTPServer``, :class:`InferenceService`), not yet
    serving: the caller runs ``serve_forever`` (tests bind port 0).  On a
    launched rank other than 0 → (None, :class:`Follower`), whose ``run``
    the caller calls.  ``model``: a ready model in place of the one the
    config builds."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from openpsg_tpu_torch import resolve_device
    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config
    from openpsg_tpu_torch.data.preprocess import Preprocessor, aspect_buckets
    from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4
    from openpsg_tpu_torch.parallel.mesh import init_distributed, launched, make_mesh

    cfg = Config.fromfile(args.config)
    rank, world, mesh = 0, 1, None
    if launched():
        rank, world, device = init_distributed("pytorch", device=args.device)
        if wants_dp_mesh(args.batch_size, args.micro_batch, world):
            mesh = make_mesh(dp=world, tp=1)
            print(f"[rank {rank}] dp mesh over {world} ranks: --batch-size "
                  f"{args.batch_size} runs {args.batch_size // world} images per rank")
        elif rank == 0 and world > 1:
            print(f"no dp mesh (--batch-size {args.batch_size}, --micro-batch "
                  f"{args.micro_batch}, {world} ranks): ranks 1-{world - 1} stay idle")
    else:
        device = resolve_device(args.device)
    if model is None:
        model = build_detector_from_config(cfg, seed=args.seed, device=device)
    if args.checkpoint:
        from openpsg_tpu_torch.train.checkpoint import restore_trainable_for_inference

        if not os.path.isdir(args.checkpoint):
            raise FileNotFoundError(f"--checkpoint {args.checkpoint}: no such directory")
        step, meta = restore_trainable_for_inference(model, cfg, args.checkpoint,
                                                     epoch=args.epoch)
        print(f"restored trainable params from step {step} (epoch {meta.get('epoch')})")
    is_v4 = isinstance(model, PSGv4)
    if args.decode_trip_budget is not None:
        if not is_v4:
            raise SystemExit("--decode-trip-budget requires a PSG v4 (LLM-decode) model")
        print(f"decode trip budget: {args.decode_trip_budget} (an argument of every call)")
    if args.micro_batch and not is_v4:
        raise SystemExit("--micro-batch is a PSG v4 path")
    if rank != 0:
        return None, Follower(model, mesh)

    H, _ = model._model_hw()
    scale = (min(args.img_scale), min(args.img_scale))
    if Preprocessor(scale=scale).bucket_hw[0] > H:
        scale = (H, H)   # tiny test models cap the bucket
    preproc = Preprocessor(scale=scale,
                           buckets=None if args.single_bucket else aspect_buckets(scale))
    service = InferenceService(model, preproc, batch_size=args.batch_size,
                               max_wait_s=args.max_wait_ms / 1e3, mesh=mesh,
                               micro_batch=args.micro_batch,
                               trip_budget=args.decode_trip_budget)

    device = str(model.device)
    buckets = [list(b) for b in (preproc.buckets or [preproc.bucket_hw])]
    seed = args.seed

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, dict(status="ok", device=device, buckets=buckets,
                                     batch_size=service.batch_size))
            else:
                self._json(404, dict(error="unknown path"))

        def do_POST(self):
            if self.path != "/infer":
                self._json(404, dict(error="unknown path"))
                return
            try:
                raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                img = decode_image(raw)
                if img is None:
                    self._json(400, dict(error="undecodable image"))
                    return
                t0 = time.time()
                res, ex = service.submit(img)
                rec = _record_for(res, ex, seed)
                rec["latency_ms"] = round((time.time() - t0) * 1e3, 1)
                self._json(200, rec)
            except Exception as e:  # a failed group reaches its callers
                self._json(500, dict(error=repr(e)))

        def log_message(self, fmt, *a):   # quiet access log
            pass

    httpd = ThreadingHTTPServer((args.host, args.port), Handler)
    return httpd, service


def main(argv=None, model=None):
    args = parse_args(argv)
    httpd, service = make_server(args, model=model)
    if httpd is None:   # a following rank: returns once rank 0 stops
        try:
            service.run()
        except KeyboardInterrupt:
            pass
        return
    if not args.no_warmup:
        service.warmup()
    host, port = httpd.server_address[:2]
    print(f"serving on http://{host}:{port}  (POST /infer, GET /healthz)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        service.stop()
        httpd.server_close()


if __name__ == "__main__":
    main()
