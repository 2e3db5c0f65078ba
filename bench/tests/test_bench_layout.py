"""The benchmark is driven by data: a cell, a mix, a fault schedule and a
per-layer metric added as files (and entries of ``BENCHMARK.json``) are
found by name and run, with no edit to a file the benchmark has. Nothing
under ``bench/`` imports JAX or the JAX package, at rest or at run time."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from bench import harness
from bench.tests.smoke import REPO, smoke_tree

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_benchmark_json_names_files_that_exist():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in b["configs"]:
        assert (REPO / c["file"]).is_file()
    for w in b["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.chips == w["chips"] == 1
    for m in b["end_to_end"] + b["per_layer"]:
        assert (REPO / "bench" / "metrics" / f"{m['name']}.py").is_file()
    for w in b["workloads"]:
        layer = harness.cell_metrics(b, w["name"], True)
        e2e = {m["name"] for m in harness.cell_metrics(b, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_a_cell_mix_schedule_and_metric_added_as_files(tmp_path):
    root = smoke_tree(tmp_path)
    (root / "traffic" / "tiny-burst.json").write_text(json.dumps(dict(
        json.loads((root / "traffic" / "longdoc.json").read_text()),
        rate_rps=8.0)))
    (root / "faults" / "one-crash.json").write_text(json.dumps(
        {"crashes": [0.3], "targets": ["any"], "rejoin_after": 0.2}))
    (root / "workloads" / "qwen2.5-3b.tiny-burst.json").write_text(
        json.dumps({"config": "qwen2.5-3b", "traffic": "tiny-burst",
                    "faults": "one-crash", "chips": 1, "why": "a test"}))
    (root / "metrics" / "answered_share.py").write_text(
        "def read(run):\n"
        "    return 100.0 * len(run.done) / len(run.records)\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "qwen2.5-3b.tiny-burst",
                           "config": "qwen2.5-3b", "traffic": "tiny-burst",
                           "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "answered_share", "unit": "%",
                           "better": "higher", "source": "host_clock",
                           "layer": "client and router",
                           "moves": "tokens_per_s",
                           "workloads": ["qwen2.5-3b.tiny-burst"]})
    for m in b["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("qwen2.5-3b.tiny-burst")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    out = harness.run_cell("qwen2.5-3b.tiny-burst", 2**31 + 7, 3.0, True,
                           device="cpu", root=root,
                           bench_json=tmp_path / "BENCHMARK.json")
    assert out["correct"], out["checks"]
    assert out["metrics"]["answered_share"]["value"] == 100.0
    assert out["attempted"] == 24


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_import_under_bench():
    for path in (REPO / "bench").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
            if "reference" in path.parts:
                assert name.split(".")[0] != "repro_torch", (path, name)


def test_a_whole_run_loads_no_jax(tmp_path):
    smoke_tree(tmp_path)
    code = (
        "import sys, json; from pathlib import Path\n"
        f"sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]\n"
        "from bench import harness, run\n"
        f"root = Path({str(tmp_path)!r})\n"
        "out = harness.run_cell('rwkv6-3b.longdoc64k-crash', 11, 3.0, False,"
        " device='cpu', root=root / 'bench',"
        " bench_json=root / 'BENCHMARK.json')\n"
        "print(json.dumps([out['correct'], run.loaded_forbidden()]))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == [True, []]
