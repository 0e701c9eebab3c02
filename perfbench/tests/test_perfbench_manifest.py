"""BENCHMARK.json keeps to the benchmark's contract, and a cell, a
configuration or a per-layer metric is added by files alone."""

import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(TEXT.match(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # every run of every cell fits the check's time with 24 cells
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_name_their_files():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and data["name"] == c["name"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_workloads_find_their_files():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert TEXT.match(w["why"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = harness.load_cell(w["name"])
        assert (ROOT / "perfbench" / "drivers" / f"{cell.traffic['driver']}.py").exists()
        assert cell.limits and all(isinstance(v, (int, float)) for v in cell.limits.values())
        # every cell reports setup_s, another end-to-end metric and a per-layer one
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


def test_metrics_keep_to_the_contract():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and TEXT.match(m["layer"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        assert (ROOT / "perfbench" / "layer_metrics" / f"{m['name']}.py").exists()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A throwaway cell, configuration, traffic and per-layer metric, in a
    copy of the benchmark's files plus new ones, load with no edit."""
    files = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", files, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    conf = json.loads((ROOT / "perfbench/configs/seva-bf16.json").read_text()) | {"name": "seva-extra"}
    (files / "configs" / "seva-extra.json").write_text(json.dumps(conf))
    traffic = json.loads((files / "traffic" / "basic-orbit80-768x576-pass1.json").read_text())
    (files / "traffic" / "basic-orbit21-576-pass1.json").write_text(
        json.dumps(traffic | {"image_hw": [576, 576], "num_targets": 21}))
    (files / "limits" / "extra-576-pass1.json").write_text(json.dumps({"unet_rel": 0.1}))
    (files / "layer_metrics" / "steps.extra.py").write_text("def read(run):\n    return run.steps or None\n")
    bench["configs"].append({"name": "seva-extra", "source": "x", "file": "perfbench/configs/seva-extra.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "extra-576-pass1", "config": "seva-extra",
                               "traffic": "basic-orbit21-576-pass1", "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("extra-576-pass1")
    bench["per_layer"].append({"name": "steps.extra", "unit": "steps", "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "render_step_s", "workloads": ["extra-576-pass1"]})
    cell = harness.load_cell("extra-576-pass1", root=tmp_path, bench=bench, files=files)
    assert cell.traffic["num_targets"] == 21 and cell.config["name"] == "seva-extra"
    assert [m["name"] for m in cell.per_layer] == ["steps.extra"]
    assert harness.layer_reader("steps.extra", files)(harness.RunData(steps=7)) == 7
