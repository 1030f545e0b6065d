"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

ROOT = harness.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"] and SPEC["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    for e in SPEC[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer"):
            if key in e:
                assert LINE.match(e[key]), e[key]


def test_configs_found_by_name():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_workloads_found_by_name():
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        cell = json.loads((harness.BENCH / "cells" / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"] and cell["why"] == w["why"] and LINE.match(w["why"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert (harness.BENCH / "adapters" / f"{cell['adapter']}.py").exists()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(SPEC["workloads"])


def test_end_to_end_bounds():
    names = {m["name"]: m for m in SPEC["end_to_end"]}
    assert names["setup_s"]["bound"] <= 0.25 and "workloads" not in names["setup_s"]
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_enough():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in harness.metrics_of(w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(w["name"], "per_layer")


def test_per_layer_readers_and_moves():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    layers: dict[str, str] = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell]), (m["name"], cell)
        layers.setdefault(m["layer"].lower(), m["layer"])
        assert layers[m["layer"].lower()] == m["layer"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_reader_finds_nothing_in_an_empty_record():
    for m in SPEC["per_layer"]:
        assert harness.read_per_layer(m["name"], {"window_s": 1.0}) is None


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH / "reference").glob("*.py"):
        assert not _imports(path) & {"lotus_tpu_torch", "lotus_tpu", "jax", "jaxlib", "flax"}, path


def test_benchmark_imports_no_jax():
    for path in harness.BENCH.rglob("*.py"):
        assert not _imports(path) & {"lotus_tpu", "jax", "jaxlib", "flax"}, path
        if "tests" not in path.parts:
            assert "benchmarks/" not in path.read_text() and "BENCH_r" not in path.read_text(), path


def test_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "lotus_tpu_torch_fake_probe", sys)
    assert "lotus_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "lotus_tpu.fake_probe", sys)
    assert "lotus_tpu" in harness.forbidden_modules()


def test_run_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload", "c4_ivf10m.bulk", "--seed",
                          "3000000001", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
