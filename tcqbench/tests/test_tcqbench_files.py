"""``BENCHMARK.json`` and the harness's data files: every cell names a
configuration, a driver and metrics that exist, with names and units of
the allowed characters."""

import json
import re

import pytest

from tcqbench.tests.tiny import ROOT, bench

HERE = ROOT / "tcqbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["tcqbench"]
    assert b["command"] == ["python3", "tcqbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells = len(b["workloads"])
    # a full check at 24 cells has to fit 43,200 s
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43_200
    assert 1 <= cells <= 24


def test_configs():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and c["name"] in used
        assert c["file"].startswith("tcqbench/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_entries(kind):
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    keys = {"end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[kind]
    for m in b[kind]:
        assert set(m) - {"workloads"} == keys
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert m["moves"] in e2e and LINE.match(m["layer"])
            assert (HERE / "metrics" / f"{m['name']}.py").exists()
            moved = next(x for x in b["end_to_end"]
                         if x["name"] == m["moves"])
            assert set(m["workloads"]) <= set(moved.get("workloads",
                                                         cells))


def test_every_cell_has_its_files_and_metrics():
    b = bench()
    configs = {c["name"] for c in b["configs"]}
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) \
        == len(b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
        cell = json.loads((HERE / "workloads" / f"{w['name']}.json")
                          .read_text())
        assert cell["name"] == w["name"] and cell["config"] == w["config"]
        assert (HERE / "traffic" / f"{cell['driver']}.py").exists()
        e2e = [m for m in b["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in b["per_layer"])


def test_file_names_use_name_characters():
    for p in HERE.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        assert re.match(r"^[A-Za-z0-9_.-]+$", p.name), p
