"""Readings for the correctness limits of a cell, many seeds in one
process: for each seed the program is handed that seed's weights and
images, runs a short window at the cell's own load (the run's sampled
chunk kept), and its outputs are read against the float32 reference; on
the ``--control-seeds`` the control (the reference in float8) is read too.

    python3 -m psgbench.calibrate --workload <name> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 4 [--out chiprun_out/calib.jsonl]

One JSON line per seed: ``{"seed", "program": {number: value},
"control": {number: value}}``.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

from psgbench import run as bench
from psgbench.drivers import offline


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}

    manifest = bench.load_json("BENCHMARK.json")
    wl = bench.cell(manifest, args.workload)
    cfg = bench.load_json("psgbench", "configs", wl["config"] + ".json")
    traffic = bench.load_json("psgbench", "traffic", wl["traffic"] + ".json")
    system = importlib.import_module("psgbench.systems." + cfg["system"]).System(
        cfg, traffic, seeds[0], "cuda")
    sink = open(args.out, "a", encoding="utf-8") if args.out else None
    try:
        for n, seed in enumerate(seeds):
            t0 = time.perf_counter()
            if n:
                system.set_seed(seed)
            loop = offline.OfflineLoop(system, traffic, seed)
            if n == 0:
                loop.warm()
            ph = loop.phase(args.seconds, capture_at=offline.sample_chunk(traffic, seed))
            modes = ("f32", "fp8") if seed in ctl else ("f32",)
            r = system.check(ph["taps"], modes)
            line = {"workload": args.workload, "seed": seed, "failed": loop.failed,
                    "images": ph["images"], "program": r["f32"], "control": r.get("fp8"),
                    "seconds": time.perf_counter() - t0}
            for e in loop.errors[:1]:
                print(e, file=sys.stderr)
            if getattr(system, "detail", None):
                print(json.dumps({"seed": seed, "detail": system.detail}), file=sys.stderr)
            print(json.dumps(line), flush=True)
            if sink:
                sink.write(json.dumps(line) + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
