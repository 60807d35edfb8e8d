"""One cell through ``gvbench.run`` on the card, as the check runs it:
a result line whose every number is within its limit."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from gvbench import yardstick


@pytest.mark.card
@pytest.mark.parametrize("wl", ["array3.gwas"])
def test_cell_on_the_card(card, wl):
    out = subprocess.run(
        [sys.executable, "-m", "gvbench.run", "--workload", wl, "--seed",
         "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=yardstick.ROOT, capture_output=True, text=True, timeout=360,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
