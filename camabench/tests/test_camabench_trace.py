"""The trace's reduction on a made-up trace: busy time, the window between
the two synchronisations, lost launches, and idle gaps charged to the host
span open at their middle, through the clocks' offset."""
from __future__ import annotations

import pytest

from camabench.trace import reduce_trace


def _ev(cat, name, ts, dur, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_reduce_trace():
    # trace clock = host clock + 1000 us
    events = [
        _ev("cuda_runtime", "cudaDeviceSynchronize", 1100.0, 5.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 1200.0, 3.0, 1),
        _ev("kernel", "k_a", 1300.0, 100.0, 1),
        _ev("cuda_runtime", "cudaMemcpyAsync", 1500.0, 3.0, 2),
        _ev("gpu_memcpy", "Memcpy DtoH", 1350.0, 150.0, 2),
        _ev("cuda_runtime", "cudaLaunchKernel", 1600.0, 3.0, 3),  # its kernel is lost
        _ev("cuda_runtime", "cudaDeviceSynchronize", 2095.0, 5.0),
    ]
    marks = [(100.0, 106.0), (1095.0, 1101.0)]
    spans = [(100.0, 1100.0, "cli.main"), (500.0, 1000.0, "host_composite")]
    s = reduce_trace(events, marks, spans)
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx(200e-6)
    assert s["launches"] == 3 and s["lost"] == 1
    assert s["clock_drift_us"] == pytest.approx(0.0)
    assert dict(s["device_ops"]) == pytest.approx({"k_a": 100e-6, "Memcpy DtoH": 150e-6})
    # gaps: 1100-1300 (middle 1200: host 200, cli.main), 1500-2100 (middle
    # 1800: host 800, host_composite)
    assert dict(s["idle_gaps"]) == pytest.approx({"cli.main": 200e-6, "host_composite": 600e-6})


def test_no_synchronisation_no_summary():
    with pytest.raises(RuntimeError):
        reduce_trace([_ev("kernel", "k", 0.0, 1.0, 1)], [(0.0, 1.0)], [])
