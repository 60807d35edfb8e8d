"""The benchmark's own arithmetic of a product's least time, and the
readers of the kernels layer, against values worked out by hand at the
cells' shapes."""

from __future__ import annotations

import pytest

from gvbench import yardstick
from gvbench.metrics import mfu_trait, products_roofline

IMP = dict(nw=25920, mpad=528384, n=414055, m=526903)
ARR = dict(nw=30528, mpad=403968, n=488377, m=402713)


@pytest.mark.parametrize("name,shape,b,seconds", [
    # 4 Nw Mpad = 54,782,853,120 bytes of words; B = 2 columns of Mpad in
    # and of 16 Nw = 414,720 out: 7,544,832 bytes; at 3.35e12 B/s
    ("axm_i8a", IMP, 2, 54_790_397_952 / 3.35e12),
    ("atxm_i8a", IMP, 1, (54_782_853_120 + 4 * (414_720 + 528_384))
     / 3.35e12),
    # 4 Nw Mpad = 49,329,340,416; in 2 x Mpad x 8 = 6,463,488, out 16 Nw x
    # 8 = 1,953,792 at B = 8 (the LOCO width)
    ("axm_i8", ARR, 8, (49_329_340_416 + 4 * 8 * (2 * 403_968 + 488_448))
     / 3.35e12),
    ("atxm_i8", ARR, 1, (49_329_340_416 + 4 * (488_448 + 2 * 403_968))
     / 3.35e12),
])
def test_least_seconds_by_hand(name, shape, b, seconds):
    got = yardstick.least_seconds(name, shape["nw"], shape["mpad"],
                                  shape["n"], shape["m"], b)
    assert got == pytest.approx(seconds, rel=1e-12)


def test_operations_bound_a_wide_call():
    # at B = 4096 the 2 N M B operations outweigh the words
    n, m, b = IMP["n"], IMP["m"], 4096
    ops = 2.0 * n * m * b / 1.979e15
    got = yardstick.least_seconds("axm_i8a", IMP["nw"], IMP["mpad"], n, m, b)
    assert got == pytest.approx(ops, rel=1e-12)


def test_readers_of_the_kernels_layer():
    call = ("atxm_i8a", IMP["nw"], IMP["mpad"], IMP["n"], IMP["m"], 1)
    least = yardstick.least_seconds(*call)
    record = dict(calls=[call, call], spans={"data": [9.0], "pvals": []},
                  trace={"product_s": [(call, 2 * least), (call, 4 * least)],
                         "window_s": 10.0})
    assert products_roofline.read(record) == pytest.approx(100 * 2 / 6)
    words = 4.0 * IMP["nw"] * IMP["mpad"] / 3.35e12
    assert mfu_trait.read(record) == pytest.approx(
        100 * (2 * least + words) / 10.0)
    record["trace"]["product_s"] = None
    assert products_roofline.read(record) is None
