"""BENCHMARK.json against the contract's form, and its cross-references:
every file it names exists and every per-layer metric's end-to-end metric
is reported wherever the metric is; a cell added as files alone is found."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.lib import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names(manifest):
    assert set(manifest) == KEYS
    assert manifest["paths"] == ["benchmark"]
    names = [c["name"] for c in manifest["configs"]]
    names += [w["name"] for w in manifest["workloads"]]
    names += [m["name"]
              for m in manifest["end_to_end"] + manifest["per_layer"]]
    names += [w["config"] for w in manifest["workloads"]]
    names += [w["traffic"] for w in manifest["workloads"]]
    names += [k for c in manifest["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        own = [e["name"] for e in manifest[group]]
        assert len(own) == len(set(own)), group
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])
    for w in manifest["workloads"]:
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200


def test_files_exist(manifest):
    for c in manifest["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in manifest["workloads"]:
        cell = harness.load_cell(w["name"])
        assert os.path.exists(os.path.join(
            harness.BENCH_DIR, "drivers", cell.traffic["driver"] + ".py"))
        assert cell.traffic["limits"]
    for m in manifest["per_layer"]:
        assert harness.metric_reader(m["name"]) is not None, m["name"]
    for op in ("resize_ce_fwd", "resize_ce_bwd", "pgd_step", "nms"):
        assert harness.kernel_names(op), op


def test_every_cell_reports_setup_another_metric_and_a_layer(manifest):
    for w in manifest["workloads"]:
        cell = harness.load_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


def test_moves_is_reported_where_the_metric_is(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = [w["name"] for w in manifest["workloads"]]
    for m in manifest["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert "workloads" not in moved or cell in moved["workloads"], (
                m["name"], cell)


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """A new cell, traffic file and metric reader, with new entries in the
    manifest and no file edited, load in a copy of the checkout."""
    copy = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    first = manifest["workloads"][0]
    with open(copy / "benchmark" / "workloads" / (first["name"] + ".json")) \
            as f:
        traffic = json.load(f)
    manifest["workloads"].append(dict(first, name="new-cell",
                                      traffic="new-mix"))
    manifest["per_layer"].append({
        "name": "new_metric", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "device",
        "moves": manifest["per_layer"][0]["moves"],
        "workloads": ["new-cell"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(manifest))
    (copy / "benchmark" / "workloads" / "new-cell.json").write_text(
        json.dumps(dict(traffic, pool_batches=2)))
    (copy / "benchmark" / "metrics" / "new_metric.py").write_text(
        "def read(layer):\n    return 42.0\n")
    (copy / "benchmark" / "kernels" / "nms-other.json").write_text(
        json.dumps({"op": "nms", "impl": "other", "kernels": ["nms_v2"],
                    "source": "x"}))
    probe = (
        "from benchmark.lib import harness\n"
        "c = harness.load_cell('new-cell')\n"
        "assert c.traffic['pool_batches'] == 2\n"
        "assert [m['name'] for m in c.per_layer][-1] == 'new_metric'\n"
        "assert harness.metric_reader('new_metric')(None) == 42.0\n"
        "assert 'nms_v2' in harness.kernel_names('nms')\n"
        "assert hasattr(c.driver(), 'run')\n"
        "print('found')\n")
    done = subprocess.run([sys.executable, "-c", probe], cwd=copy,
                          capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=str(copy)))
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "found"


def test_idle_share_is_of_an_untraced_step():
    """0.075 busy seconds a traced step against 0.1 s a measured step: 25%
    idle, whatever the (slower) traced window's length."""
    from types import SimpleNamespace
    layer = SimpleNamespace(
        trace=SimpleNamespace(busy_s=0.3, units=4, window_s=0.9),
        window={"steps": 50, "seconds": 5.0})
    read = harness.metric_reader("device_idle_pct.train")
    assert read(layer) == pytest.approx(25.0)
