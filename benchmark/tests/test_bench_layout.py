"""BENCHMARK.json keeps the contract's shape, and every file it names is
found by name, also one added in another checkout."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from benchmark.harness.cell import Context
from benchmark.harness.registry import ROOT, Registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(BENCH["configs"]) <= 24
    # a full check with 24 cells fits its time
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert all(not p.startswith("/") and ".." not in p
               for p in BENCH["command"] + BENCH["paths"])


def test_names_units_and_lines():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        texts = [e[k] for k in ("why", "layer") if k in e]
        if "file" in e:
            texts.append(e["source"])
            assert len(e["reduced"]) <= 16
            assert all(NAME.match(k) for k in e["reduced"])
        for text in texts:
            assert 1 <= len(text) <= 200 and "\n" not in text
            assert "\t" not in text
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))


def test_metrics_reference_what_exists():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        reported = [m for m in BENCH["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(cells) // 4)


def test_every_file_is_found_by_name():
    reg = Registry()
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/")
        assert reg.config(c["name"])["name"] == c["name"]
    for w in BENCH["workloads"]:
        wl = reg.workload(w["name"])
        assert wl["limits"] and wl["config"] == w["config"]
        driver = reg.driver(reg.traffic(w["traffic"])["driver"])
        assert hasattr(driver, "Driver")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(reg.reader(m["name"]).read)


def test_a_file_added_in_another_checkout_is_found(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(tmp_path / "BENCHMARK.json"))
    bench["workloads"].append(
        {"name": "nerf_lego_b1024", "config": "nerf_lego",
         "traffic": "rays_b1024", "chips": 1, "why": "lego.json's batch"})
    bench["per_layer"].append(
        {"name": "steps_per_s.nerf_train", "unit": "1/s", "better": "higher",
         "source": "host_clock", "layer": "driver step",
         "moves": "nerf_train_rays_per_s", "workloads": ["nerf_lego_b1024"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.load(open(tmp_path / "benchmark/traffic/rays_b4096.json"))
    traffic["batch_rays"] = 1024
    (tmp_path / "benchmark/traffic/rays_b1024.json").write_text(
        json.dumps(traffic))
    shutil.copy(tmp_path / "benchmark/workloads/nerf_lego_b4096.json",
                tmp_path / "benchmark/workloads/nerf_lego_b1024.json")
    (tmp_path / "benchmark/metrics/steps_per_s.nerf_train.py").write_text(
        "def read(ctx):\n    return ctx.steps / ctx.window_s\n")
    reg = Registry(str(tmp_path))
    assert reg.traffic(reg.workload("nerf_lego_b1024")["traffic"])[
        "batch_rays"] == 1024
    names = [m["name"] for m in reg.metrics("nerf_lego_b1024", True)]
    assert names == ["steps_per_s.nerf_train"]
    ctx = Context(cell="nerf_lego_b1024", config={}, traffic={}, setup_s=1.0,
                  window_s=2.0, steps=10, items=10240, step_ms=[],
                  parts_ms={})
    assert reg.reader("steps_per_s.nerf_train").read(ctx) == 5.0
    with pytest.raises(FileNotFoundError):
        reg.reader("no_such_metric")
