"""Every configuration, traffic mix, limits file, driver, reference and
per-layer metric is found by its name, and new ones placed beside them
are picked up without an edit."""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys

import pytest

from gvbench import run, yardstick

SPEC = yardstick.bench_spec()


@pytest.mark.parametrize("wl", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found(wl):
    w, config, traffic, limits = yardstick.cell(SPEC, wl)
    assert config["name"] == w["config"]
    assert yardstick.layout(config)
    importlib.import_module("gvbench.drivers." + traffic["driver"])
    ref = importlib.import_module("gvbench.reference." + traffic["driver"])
    assert callable(ref.check)
    assert limits and all(v > 0 for v in limits.values())


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_module_found(metric):
    mod = importlib.import_module("gvbench.metrics."
                                  + metric.replace(".", "_"))
    assert callable(mod.read)


def test_layout_is_the_loaders():
    """A configuration states the word rows and padded markers that the
    program's loader gives its N and M, and no other padding."""
    config = dict(N=488377, M=402713, Nw=30528, Mpad=402944)
    assert yardstick.layout(config) == (30528, 402944)
    with pytest.raises(ValueError):
        yardstick.layout(dict(config, Mpad=403968))
    with pytest.raises(ValueError):
        yardstick.layout(dict(config, N=414055, Nw=25920))


def test_config_files_state_their_cut():
    for c in SPEC["configs"]:
        data = yardstick.load_json(os.path.join(yardstick.ROOT, c["file"]))
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        assert set(data["reduced_from"]) == set(c["reduced"])


NEW = {
    "config": {"name": "new_cohort", "source": "a public source",
               "file": "gvbench/configs/new_cohort.json", "reduced": [],
               "why": "a cohort added later"},
    "workload": {"name": "new_cohort.fit2", "config": "new_cohort",
                 "traffic": "fit2", "chips": 1, "why": "added later"},
    "metric": {"name": "traits_done", "unit": "traits", "better": "higher",
               "source": "program_counter", "layer": "engine",
               "moves": "trait_s"},
}

PROBE = """
import json
from gvbench import run, yardstick
spec = yardstick.bench_spec()
wl, config, traffic, limits = yardstick.cell(spec, "new_cohort.fit2")
record = dict(spans={"data": [1.0]}, counters={"iterations": 4}, calls=[],
              traits=3, trace={"window_s": 2.0, "busy_s": 1.0,
                               "product_s": None})
print(json.dumps([config["N"], traffic["causal"], limits,
                  run.per_layer(spec, wl, record)]))
"""


def test_new_files_are_picked_up(scratch_copy):
    """A configuration, a traffic mix, a cell's limits and a per-layer
    metric added as files of their own, with their entries in
    BENCHMARK.json, run without an edit of any file already there."""
    here = scratch_copy / "gvbench"
    config = yardstick.load_json(here / "configs" / "ukb_array_3card.json")
    config.update(name="new_cohort", N=2000, Nw=32)
    (here / "configs" / "new_cohort.json").write_text(json.dumps(config))
    traffic = yardstick.load_json(here / "traffic" / "fit.json")
    traffic["causal"] = 77
    (here / "traffic" / "fit2.json").write_text(json.dumps(traffic))
    (here / "limits" / "new_cohort.fit2.json").write_text(
        json.dumps({"estimate": 1e-3}))
    (here / "metrics" / "traits_done.py").write_text(
        "def read(record):\n    return float(record['traits'])\n")
    spec = json.loads((scratch_copy / "BENCHMARK.json").read_text())
    spec["configs"].append(NEW["config"])
    spec["workloads"].append(NEW["workload"])
    spec["per_layer"].append(NEW["metric"])
    # an existing metric takes the new cell by its entry alone
    for m in spec["per_layer"]:
        if m["name"] == "stats_s":
            m["workloads"].append(NEW["workload"]["name"])
    (scratch_copy / "BENCHMARK.json").write_text(json.dumps(spec))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=scratch_copy,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, causal, limits, metrics = json.loads(out.stdout.splitlines()[-1])
    assert (n, causal, limits) == (2000, 77, {"estimate": 1e-3})
    assert metrics["traits_done"] == {"value": 3.0, "unit": "traits"}
    assert metrics["stats_s"] == {"value": 1.0, "unit": "s"}


def test_run_refuses_without_a_card_or_the_program(scratch_copy):
    """In a folder holding only BENCHMARK.json and gvbench/ a run exits
    with an error and prints no result."""
    out = subprocess.run(
        [sys.executable, "-m", "gvbench.run", "--workload", "array3.gwas",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=scratch_copy, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_per_layer_leaves_out_what_finds_nothing():
    wl = {w["name"]: w for w in SPEC["workloads"]}["array3.gwas"]
    record = dict(spans={}, counters={}, calls=[], traits=1,
                  trace={"window_s": 1.0, "busy_s": 0.0, "product_s": None})
    assert run.per_layer(SPEC, wl, record) == {}
