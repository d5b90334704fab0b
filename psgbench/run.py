"""Run one benchmark cell once on the card.

    python3 -m psgbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``;
its configuration ``psgbench/configs/<config>.json``, whose ``system``
names the adapter ``psgbench/systems/<system>.py`` and whose limits are
``psgbench/limits/<config>.json``; its traffic ``psgbench/traffic/<traffic>.json``,
whose ``driver`` names ``psgbench/drivers/<driver>.py``; and one reader
``psgbench/metrics/<metric>.py`` per metric.  With ``--trace 0`` the line
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``compared``: each compared number with its limit).
Without a CUDA device, or with fewer than the cell asks for, it exits 3
and prints no result; it never falls back to the CPU.
"""

import time

CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import math  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's build and kernel caches live inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["USE_FLAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "openpsg_tpu")


def load_json(*parts):
    with open(os.path.join(ROOT, *parts), "r", encoding="utf-8") as f:
        return json.load(f)


def cell(manifest, workload: str):
    for w in manifest["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def metrics_for(manifest, workload: str, trace: bool):
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[kind] if workload in m.get("workloads", [workload])]


def read_metric(name: str, ctx):
    path = os.path.join(ROOT, "psgbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("psgbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def forbidden_modules():
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def power_record() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not read"


def judge(readings, limits):
    """→ (correct, [[name, value, limit]])."""
    rows, ok = [], True
    for name, lim in limits["numbers"].items():
        v = readings.get(name)
        good = v is not None and v <= lim["limit"]
        ok = ok and good
        rows.append([name, v, lim["limit"]])
    return ok, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    manifest = load_json("BENCHMARK.json")
    wl = cell(manifest, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        print(f"psgbench: the cell needs {wl['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    cfg = load_json("psgbench", "configs", wl["config"] + ".json")
    traffic = load_json("psgbench", "traffic", wl["traffic"] + ".json")
    limits = load_json("psgbench", "limits", wl["config"] + ".json")
    system_mod = importlib.import_module("psgbench.systems." + cfg["system"])
    driver = importlib.import_module("psgbench.drivers." + traffic["driver"])
    print(f"psgbench: {args.workload} seed {args.seed} on {power_record()}", file=sys.stderr)

    system = system_mod.System(cfg, traffic, args.seed, "cuda")
    ctx = driver.run(system, traffic, args.seed, args.seconds, bool(args.trace), CLOCK0)
    ctx["system"], ctx["config"] = system, cfg
    for e in ctx["errors"][:3]:
        print(e, file=sys.stderr)
    peak = int(torch.cuda.max_memory_allocated())
    metrics = {}
    for m in metrics_for(manifest, args.workload, bool(args.trace)):
        v = read_metric(m["name"], ctx)
        if v is None and not args.trace:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(wl["chips"]),
              "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": ctx["attempted"], "failed": ctx["failed"],
              "metrics": metrics, "device": device}
    if args.trace:
        tr = ctx["phases"]["profiled"]["trace"]
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}

    taps = ctx.pop("taps")
    system.release()
    ctx.clear()
    t0 = time.perf_counter()
    readings = system.check(taps)["f32"] if taps else {}
    print(f"psgbench: the reference took {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    print(f"psgbench: detail {json.dumps(getattr(system, 'detail', {}))}", file=sys.stderr)
    ok, rows = judge(readings, limits)
    result["correct"] = bool(ok and result["failed"] == 0 and result["attempted"] > 0)
    shown = lambda v: v if v is not None and math.isfinite(v) else str(v)
    result["compared"] = {name: {"value": shown(v), "limit": lim} for name, v, lim in rows}
    for name, v, lim in rows:
        print(f"compared {name}: {v} limit {lim}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"psgbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except Exception:
        traceback.print_exc()
        sys.exit(1)
