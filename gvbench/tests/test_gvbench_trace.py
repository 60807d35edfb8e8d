"""The reduction of the profiler's device activity: busy and idle time,
the product kernels paired with the calls, and the idle gaps under the
innermost benchmark span."""

from __future__ import annotations

import pytest

from gvbench import yardstick


class Ev:
    def __init__(self, name, start, dur, device="CUDA"):
        self._n, self._s, self._d, self._dev = name, start, dur, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType." + self._dev


def test_reduce_trace():
    rec = yardstick.Recorder("cpu")
    rec.ranges = [(0, 1000, "window"), (10, 990, "trait"), (10, 400, "data"),
                  (400, 990, "engine"), (500, 600, "product:axm_i8a")]
    call = ("axm_i8a", 64, 512, 1000, 500, 2)
    rec.calls = [call]
    events = [Ev("void axm_i8_kernel<0>(unsigned int const*)", 520, 100),
              Ev("aten::add", 100, 50, device="CPU"),
              Ev("elementwise", 20, 300),
              Ev("memcpy", 700, 100)]
    dev = yardstick.device_events(events)
    assert len(dev) == 3
    out = yardstick.reduce_trace(dev, rec, (0, 1000))
    assert out["window_s"] == pytest.approx(1e-6)
    assert out["busy_s"] == pytest.approx(500e-9)
    assert out["product_s"] == [(call, pytest.approx(100e-9))]
    gaps = dict(out["idle_gaps"])
    # each gap goes to the span open at its start: 0-20 the window,
    # 320-520 data, 620-700 and 800-1000 engine
    assert gaps == {"window": 20e-9, "data": pytest.approx(200e-9),
                    "engine": pytest.approx(280e-9)}
    assert out["device_ops"][0][0] == "elementwise"


def test_unpaired_kernels_leave_the_roofline_silent():
    rec = yardstick.Recorder("cpu")
    rec.calls = [("atxm_i8a", 64, 512, 1000, 500, 1)] * 2
    dev = [(0, 10, "void atxm_i8_kernel<false>(int)")]
    assert yardstick.reduce_trace(dev, rec, (0, 20))["product_s"] is None
