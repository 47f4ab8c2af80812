"""BENCHMARK.json against the contract's shape, and the harness finding a
new configuration, cell and metric by name, with no edit to a file."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.harness.cell import BENCH, ROOT, load_cell, metric_reader, read_spec, unlisted_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    return read_spec()


def test_keys_names_and_units(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and spec["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    names = [e["name"] for part in ("configs", "workloads", "end_to_end", "per_layer") for e in spec[part]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json" and os.path.exists(ROOT / c["file"])
        assert all(NAME.match(k) for k in c["reduced"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES, m
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    for m in spec["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def test_every_cell_resolves_and_reports(spec):
    cells = [w["name"] for w in spec["workloads"]]
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(1, len(cells) // 4)
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        cell = load_cell(w["name"], spec)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in names, (w["name"], m["name"])
            assert callable(metric_reader(m["name"]))
    assert {w["config"] for w in spec["workloads"]} == {c["name"] for c in spec["configs"]}
    for m in spec["per_layer"]:
        assert set(m["workloads"]) <= set(cells)


def test_the_kept_training_cells_resolve_from_their_files():
    """The training cells' traffic files, configuration and per-layer readers,
    kept for a later PR that lists them (PERF.md, Open questions)."""
    for name in ("flownetc.chairs-aug-b8", "flownetc.chairs-crop-b8"):
        cell = unlisted_cell(name)
        assert cell.config["name"] == "flownetc" and set(cell.limits) == {"flow_epe1", "loss_gap", "grad_gap",
                                                                          "change_gap"}
    for metric in ("device_idle.train", "mfu.train", "data_wait_ms.train", "optimizer_ms.train",
                   "correlation_bwd_roofline.train", "warp_roofline.train"):
        assert callable(metric_reader(metric))


def test_a_check_fits_the_driver_budget(spec):
    assert 2 + 14 * 24 * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_a_new_config_cell_and_metric_are_files_and_entries(tmp_path):
    """Copy the benchmark, add a configuration, a cell and a per-layer metric as
    new files and BENCHMARK.json entries, and load them from the copy."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((BENCH / "configs" / "flownet2.json").read_text())
    (tmp_path / "benchmark/configs/flownet2-copy.json").write_text(json.dumps(dict(config, name="flownet2-copy")))
    traffic = json.loads((BENCH / "workloads" / "flownet2.chairs-b16.json").read_text())
    cell = dict(traffic, config="flownet2-copy", traffic="kitti-b4", height=375, width=1242, pairs_per_request=4)
    (tmp_path / "benchmark/workloads/flownet2-copy.kitti-b4.json").write_text(json.dumps(cell))
    (tmp_path / "benchmark/metrics/pairs_in_stretch.kitti.py").write_text(
        "def read(st):\n    return st.units.get('pairs')\n")
    spec["configs"].append({"name": "flownet2-copy", "source": "https://arxiv.org/abs/1612.01925",
                            "file": "benchmark/configs/flownet2-copy.json", "reduced": [], "why": "a copy"})
    spec["workloads"].append({"name": "flownet2-copy.kitti-b4", "config": "flownet2-copy", "traffic": "kitti-b4",
                              "chips": 1, "why": "KITTI size"})
    for m in spec["end_to_end"]:
        if m["name"] in ("pairs_per_s", "latency_p95_ms"):
            m["workloads"].append("flownet2-copy.kitti-b4")
    spec["per_layer"].append({"name": "pairs_in_stretch.kitti", "unit": "pairs", "better": "higher",
                              "source": "program_counter", "layer": "runner", "moves": "pairs_per_s",
                              "workloads": ["flownet2-copy.kitti-b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "from benchmark.harness.cell import load_cell, metric_reader, driver\n"
            "from types import SimpleNamespace\n"
            "c = load_cell('flownet2-copy.kitti-b4')\n"
            "assert c.config['name'] == 'flownet2-copy' and c.traffic['width'] == 1242\n"
            "assert driver(c).__name__ == 'benchmark.traffic.infer'\n"
            "names = [m['name'] for m in c.per_layer]\n"
            "assert 'pairs_in_stretch.kitti' in names and 'head_conv_roofline.infer' not in names, names\n"
            "assert metric_reader('pairs_in_stretch.kitti')(SimpleNamespace(units={'pairs': 12})) == 12\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
