"""Closed loop over a bucketed image mix, as the infer tool runs a test
set: images grouped by bucket in chunks of ``group``, the chunks in a
bucket sequence that is the same for every seed (``traffic.chunk_order``),
and each chunk through the system's call as soon as the previous one
returned its host results.  The program's ``Preprocessor`` prepares every
image once at set-up, so the window runs the model on prepared inputs."""

from __future__ import annotations

import collections
import contextlib
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import torch

from psgbench import trace as tracing
from psgbench import traffic as gen

SETUP_THREADS = 4
# the benchmark's own profiler ranges around its calls into the program
HOST_SPANS = ("run_chunk", "infer", "segment", "fuse_select", "tail_pre",
              "tail_decode", "relation_tail")


class OfflineLoop:
    def __init__(self, system, traffic: Dict, seed: int):
        self.system, self.traffic = system, traffic
        self.pre = system.preprocessor()
        sizes = gen.image_sizes(traffic["mix"], seed)
        self.images = gen.make_images(sizes, seed)
        buckets = [self.pre.bucket_for(h, w) for h, w in sizes]
        self.chunks = gen.chunks_by_bucket(buckets, int(traffic["group"]))
        self.order = gen.chunk_order([b for b, _ in self.chunks], seed)
        # every chunk prepared once, on SETUP_THREADS threads while the card idles
        with ThreadPoolExecutor(max_workers=SETUP_THREADS) as pool:
            self.prepared = list(pool.map(self._prep, range(len(self.chunks))))
        self.attempted = self.failed = 0
        self.errors = []

    def _prep(self, c: int):
        bucket, idx = self.chunks[c]
        ims, hws, ms = [], [], []
        for i in idx:
            t0 = time.perf_counter()
            ex = self.pre(self.images[i], bucket=bucket)
            ms.append((time.perf_counter() - t0) * 1e3)
            ims.append(ex["image"])
            hws.append(ex["img_shape"])
        return bucket, ims, hws, ms

    def warm(self) -> None:
        """Each bucket of the mix once, at its group size."""
        seen = set()
        for c, (bucket, _) in enumerate(self.chunks):
            if bucket in seen:
                continue
            seen.add(bucket)
            _, ims, hws, _ = self.prepared[c]
            self.system.run_chunk(ims, hws)
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def phase(self, seconds: float, capture_at: Optional[int] = None, staged: bool = False,
              profiled: bool = False) -> Dict:
        """Chunks until ``seconds`` have passed (and the chunk ``capture_at``
        has run, its taps kept) → the phase's counts."""
        out = {"images": 0, "buckets": collections.Counter(), "chunks": [],
               "stage_ms": collections.Counter(), "taps": None}
        ctx = tracing.profiled(HOST_SPANS, out) if profiled else contextlib.nullcontext()
        keep_rows = capture_at is not None and hasattr(self.system, "phase_taps")
        if keep_rows:
            self.system.phase_taps = []
        with ctx:
            t0 = time.perf_counter()
            i = 0
            while True:
                bucket, ims, hws, _ = self.prepared[next(self.order)]
                st = {} if staged else None
                sys_ = self.system
                if i == capture_at:
                    sys_.taps = []
                self.attempted += len(ims)
                try:
                    with torch.profiler.record_function("run_chunk"):
                        res = sys_.run_chunk(ims, hws, stage_times=st)
                except Exception:  # a failed call is counted, the loop goes on
                    self.failed += len(ims)
                    self.errors.append(traceback.format_exc())
                    res = None
                if i == capture_at:
                    out["taps"], sys_.taps = sys_.taps, None
                if res is not None:
                    out["images"] += len(ims)
                    out["buckets"][tuple(bucket)] += len(ims)
                    out["chunks"].append(dict(n=len(ims), bucket=tuple(bucket), stage=st,
                                              **sys_.rows(res)))
                    if st:
                        out["stage_ms"].update(st)
                i += 1
                if time.perf_counter() - t0 >= seconds and (capture_at is None or i > capture_at):
                    break
            out["seconds"] = time.perf_counter() - t0
        if keep_rows:
            rows, self.system.phase_taps = self.system.phase_taps, None
            out["taps"] = (out["taps"] or []) + [{"llm": rows}]
        return out


def sample_chunk(traffic: Dict, seed: int) -> int:
    """The chunk of the window whose outputs are compared, drawn from the seed."""
    return int(gen.rng(seed, 7).integers(0, int(traffic["sample_within"])))


def run(system, traffic: Dict, seed: int, seconds: float, trace: bool, clock0: float) -> Dict:
    """A run's window(s) → the context the metric readers take."""
    loop = OfflineLoop(system, traffic, seed)
    loop.warm()
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    at = sample_chunk(traffic, seed)
    ctx = {"setup_s": time.perf_counter() - clock0, "phases": {}}
    if not trace:
        ctx["phases"]["timed"] = loop.phase(seconds, capture_at=at)
    else:
        third = seconds / 3.0
        ctx["phases"]["plain"] = loop.phase(third, capture_at=at)
        ctx["phases"]["profiled"] = loop.phase(third, profiled=True)
        ctx["phases"]["staged"] = loop.phase(third, staged=True)
    first = next(iter(ctx["phases"].values()))
    ctx["setup_prep_ms"] = [ms for c in loop.prepared for ms in c[3]]
    ctx.update(attempted=loop.attempted, failed=loop.failed, errors=loop.errors,
               taps=first["taps"] or [])
    return ctx
