"""The harness on the CPU at a tiny size: the result line, the files it finds
by name, and BENCHMARK.json against the benchmark's contract."""
from __future__ import annotations

import contextlib
import io
import json
import re

import pytest

import bench_tiny
from bench_tiny import ROOT, WORKLOADS, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_result_line(workload, trace):
    result, lines = bench_tiny.run(workload, trace=trace)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    dev = result["device"]
    assert set(dev) >= {"platform", "kind", "count", "memory_peak_bytes"}
    plan = harness.cell_plan(bench_tiny.spec(), workload)
    declared = {m["name"]: m["unit"] for m in plan["per_layer" if trace else "end_to_end"]}
    assert set(result["metrics"]) <= set(declared)
    for name, m in result["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"]) and m["unit"] == declared[name]
        assert isinstance(m["value"], float) and m["value"] > 0
    if trace:          # the host spans read on the CPU; the device's only from a trace
        assert set(result["metrics"]) == {"admit_host_ms", "queue_wait_ms"}
    else:
        assert set(result["metrics"]) == set(declared)
    assert lines[-len(result["checks"]):] == [
        f"check {k}: {c['value']} (limit {c['limit']})" for k, c in result["checks"].items()]
    json.dumps(result)


def test_cli_refuses_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = harness.main(["--workload", WORKLOADS[0], "--seed", "1", "--seconds", "1"], 0.0)
    assert rc != 0 and out.getvalue() == ""


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_found_by_name(workload):
    plan = harness.cell_plan(bench_tiny.spec(), workload)
    assert callable(harness.load("systems", plan["config"]["system"]).build)
    assert callable(harness.load("loops", plan["traffic"]["loop"]).run)
    assert hasattr(harness.load("reference", plan["config"]["reference"]), "Reference")
    for m in plan["end_to_end"] + plan["per_layer"]:
        assert callable(harness.load("metrics", m["name"]).read)


def test_a_reader_finds_nothing_without_a_trace():
    import types

    ctx = types.SimpleNamespace(trace=None, shapes={})
    for name in ("serve_device_ms", "search_device_ms", "top1_roofline", "device_idle"):
        assert harness.load("metrics", name).read(ctx) is None


def test_benchmark_json_keeps_the_contract():
    raw = (ROOT / "BENCHMARK.json").read_text()
    assert len(raw.encode()) <= 64 * 1024
    spec = json.loads(raw)
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "bench/run.py"] and spec["paths"] == ["bench"]
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.add(c["name"])
    cells, pairs = set(), set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
        cells.add(w["name"])
    assert len(pairs) == len(cells) == len(spec["workloads"])
    assert {w["config"] for w in spec["workloads"]} == names
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in (
            "lower", "higher")
        names.add(m["name"])
    assert len(names) == len(spec["configs"]) + len(spec["end_to_end"]) + len(spec["per_layer"])
    for path in (ROOT / "bench").rglob("*"):
        if "__pycache__" not in path.parts and path.is_file():
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", str(path.relative_to(ROOT)))
