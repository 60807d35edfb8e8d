"""BENCHMARK.json keeps to the benchmark's contract: its keys, names,
units, bounds, cells and the time a full check takes."""

from __future__ import annotations

import os
import re

import pytest

from gvbench import yardstick

SPEC = yardstick.bench_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
    assert len(SPEC["command"]) <= 32
    assert all(LINE.match(w) for w in SPEC["command"])
    assert os.path.getsize(os.path.join(yardstick.ROOT,
                                        "BENCHMARK.json")) <= 64 * 1024


def _entries():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[key]:
            yield key, e


@pytest.mark.parametrize("key,entry", list(_entries()),
                         ids=lambda v: v if isinstance(v, str) else v["name"])
def test_entry(key, entry):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source",
                              "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves", "workloads"}}[key]
    assert set(entry) <= allowed
    assert NAME.match(entry["name"])
    if key == "configs":
        assert LINE.match(entry["source"]) and LINE.match(entry["why"])
        assert entry["file"].startswith(SPEC["paths"][0] + "/")
        assert len(entry["reduced"]) <= 16
        assert all(NAME.match(k) for k in entry["reduced"])
    elif key == "workloads":
        assert entry["chips"] in (1, 4)
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
        assert LINE.match(entry["why"])
    else:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    if key == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if key == "per_layer":
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        assert LINE.match(entry["layer"])
        assert entry["moves"] in {m["name"] for m in SPEC["end_to_end"]}


def test_names_are_unique_and_cells_complete():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert "setup_s" in metrics
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        e2e = [m for m in SPEC["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert {"setup_s"} < {m["name"] for m in e2e}
        layer = [m for m in SPEC["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert layer
        assert all(m["moves"] in {e["name"] for e in e2e} for m in layer)
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_a_full_check_of_24_cells_fits():
    s = SPEC["run_seconds"]
    assert 1 <= s <= 51 and s == int(s)
    cells = 24
    total = (2 + 14 * cells) * (s + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
