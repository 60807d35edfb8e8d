"""The plain reference agrees with the port's CPU path at a tiny size, a
sound run comes out correct, and the control (the reference in the
program's place with TF32 products) comes out not correct."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gvamp_tpu_torch.data import GenoBed
from gvamp_tpu_torch.ops.layout import PlanarLayout

from gvbench import run, yardstick
from gvbench.reference import linear_fit as ref

CELLS = ["array3.gwas", "array3.fit"]


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      -3.0 - 2**-12], dtype=torch.float64)
    assert ref.tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9,
                                    -3.0]


def test_person_order_is_the_ports_layout():
    lay = PlanarLayout.create(1000)
    v = np.arange(lay.n_planar, dtype=np.float64).reshape(4, lay.n_bytes)
    got = ref.person_order(torch.as_tensor(v), 1000).numpy()
    assert np.array_equal(got, lay.deplanarize(v))


@pytest.mark.parametrize("miss", [False, True])
def test_passes_and_statistics_match_the_port(miss):
    """The reference's decode, products and statistics against the port's
    float64 container on the CPU."""
    n, m, nw, mpad = 300, 700, 32, 1024
    words = yardstick.make_words(11, n, m, miss, "cpu", nw, mpad)
    rng = np.random.default_rng(0)
    y = rng.standard_normal(n)
    y[:7] = np.nan
    geno = GenoBed.from_device_words(words, y, N=n, M=m,
                                     standardize_phen=False,
                                     dtype=torch.float64)
    assert geno.geno_complete == (not miss)
    passes = ref.Passes(words, n, block=96)
    na = torch.as_tensor(~np.isnan(y), dtype=torch.float64)
    av, bv, aa = passes.transposed(na[:, None], na[:, None])
    nonas = float(na.sum())
    mave = torch.where(bv[:, 0] > 0, av[:, 0] / bv[:, 0].clamp(min=1), 0.0)
    sd = torch.sqrt((aa[:, 0] - mave * av[:, 0]) / (nonas - 1))
    real = slice(0, m)
    assert torch.allclose(mave[real], geno.mave[real], rtol=1e-12)
    assert torch.allclose(1 / sd[real], geno.msig[real], rtol=1e-12)
    x = torch.as_tensor(rng.standard_normal((mpad, 2)))
    x[m:] = 0
    W = geno.msig[:, None] * x
    z = passes.forward(W, geno.mave[:, None] * W) / np.sqrt(n)
    z = z * na[:, None]
    want = ref.person_order(geno.axm(x), n)
    assert torch.allclose(z, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tiny):
    spec, here = tiny
    out = run.run(spec, cell, 2**31 + 12345, 0.0, False, "cpu", here=here)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"trait_s", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, tiny):
    spec, here = tiny
    out = run.run(spec, cell, 2**31 + 777, 0.0, False, "cpu", here=here,
                  control=True)
    assert out["correct"]
    limits = {k: c["limit"] for k, c in out["checks"].items()}
    assert any(out["control_checks"][k] > v for k, v in limits.items()), (
        out["control_checks"], limits)


def test_traced_run_reports_per_layer_metrics(tiny):
    spec, here = tiny
    out = run.run(spec, "array3.gwas", 99, 0.0, True, "cpu", here=here)
    assert out["correct"]
    # on the CPU no device activity: the device's metrics find nothing
    assert {"stats_s", "iter_ms", "host_syncs_per_iter", "cg_per_iter",
            "loco_s", "mfu.trait"} == set(out["metrics"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
