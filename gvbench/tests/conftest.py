"""Fixtures of the benchmark's tests: a copy of the data files at a size
the CPU runs in seconds, and the card check of the tests marked ``card``
(run on the card with ``python -m pytest gvbench/tests -m card``)."""

from __future__ import annotations

import json
import os
import shutil

import pytest
import torch

from gvbench import yardstick


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs a cell on the card")


# N people, M markers (the upstream prior needs M > 50,000), 5 iterations
TINY = dict(N=1000, M=51000, Nw=64, Mpad=51200, Mt_deployment=102000)


def make_tiny(root: str, max_iter: int = 5) -> str:
    """A folder ``root/gvbench`` holding every configuration, traffic and
    limits file of the benchmark, cut to TINY; returns it."""
    here = os.path.join(root, "gvbench")
    for kind in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(here, kind))
        for name in os.listdir(os.path.join(yardstick.HERE, kind)):
            src = os.path.join(yardstick.HERE, kind, name)
            data = yardstick.load_json(src)
            if kind == "configs":
                data.update(TINY)
                data["run"] = dict(data["run"], max_iter=max_iter)
            elif kind == "traffic":
                data.update(causal=50)
            with open(os.path.join(here, kind, name), "w") as f:
                json.dump(data, f)
    return here


@pytest.fixture
def tiny(tmp_path):
    return yardstick.bench_spec(), make_tiny(str(tmp_path))


@pytest.fixture
def scratch_copy(tmp_path):
    """A copy of the benchmark's folder and BENCHMARK.json."""
    dst = tmp_path / "copy"
    shutil.copytree(yardstick.HERE, dst / "gvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(yardstick.ROOT, "BENCHMARK.json"), dst)
    return dst
