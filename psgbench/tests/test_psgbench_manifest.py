"""BENCHMARK.json against the benchmark's contract, and every file it
names present under psgbench/."""

import json
import os
import re

import pytest

from tiny import ROOT

REPO = os.path.dirname(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(REPO, "BENCHMARK.json"), "r", encoding="utf-8") as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_entry_keys(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(manifest["paths"][0] + "/")
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for kind in ("end_to_end", "per_layer"):
        for m in manifest[kind]:
            keys = {"name", "unit", "better", "source"} | (
                {"bound"} if kind == "end_to_end" else {"layer", "moves"})
            assert set(m) - {"workloads"} == keys
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    names = [m["name"] for k in ("end_to_end", "per_layer") for m in manifest[k]]
    assert len(names) == len(set(names))
    assert len({w["name"] for w in manifest["workloads"]}) == len(manifest["workloads"])
    assert len({(w["config"], w["traffic"]) for w in manifest["workloads"]}) == len(
        manifest["workloads"])


def test_metrics_follow_the_rules(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    reports = lambda name, cell: cell in e2e[name].get("workloads", cells)
    for w in cells:
        assert reports("setup_s", w)
        assert any(reports(n, w) for n in e2e if n != "setup_s")
        assert any(w in m.get("workloads", cells) for m in manifest["per_layer"])
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        for w in m.get("workloads", cells):
            assert w in cells and reports(m["moves"], w)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_named_file_exists(manifest):
    pkg = os.path.join(REPO, "psgbench")
    configs = {c["name"] for c in manifest["configs"]}
    for c in manifest["configs"]:
        assert os.path.isfile(os.path.join(REPO, c["file"]))
        assert os.path.isfile(os.path.join(pkg, "limits", c["name"] + ".json"))
    for w in manifest["workloads"]:
        assert w["config"] in configs
        with open(os.path.join(pkg, "traffic", w["traffic"] + ".json"), "r",
                  encoding="utf-8") as f:
            t = json.load(f)
        assert os.path.isfile(os.path.join(pkg, "drivers", t["driver"] + ".py"))
    for k in ("end_to_end", "per_layer"):
        for m in manifest[k]:
            assert os.path.isfile(os.path.join(pkg, "metrics", m["name"] + ".py")), m["name"]
    for c in manifest["configs"]:
        with open(os.path.join(REPO, c["file"]), "r", encoding="utf-8") as f:
            cfg = json.load(f)
        assert os.path.isfile(os.path.join(pkg, "systems", cfg["system"] + ".py"))
        assert cfg["reduced"] == c["reduced"]


def test_four_chip_cells_within_the_share(manifest):
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)
