"""Reading a device trace: kernels charged to the dispatch and encode
ranges their launches sat in (graph replays through their
``cudaGraphLaunch``), the busy share, and the idle gaps by host activity."""

from __future__ import annotations

import pytest

from portbench.core import trace as T


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events():
    return [
        _x("user_annotation", T.WINDOW_RANGE, 0.0, 2_000_000.0, tid=9),
        # dispatch 4: an encode with one kernel, then a graph replay of two kernels
        _x("user_annotation", "portbench.dispatch.4", 100.0, 1000.0),
        _x("user_annotation", "portbench.encode.4", 110.0, 300.0),
        _x("cuda_runtime", "cudaLaunchKernel", 120.0, 5.0, corr=1),
        _x("cuda_runtime", "cudaGraphLaunch", 700.0, 5.0, corr=2),
        _x("kernel", "logmel_kernel", 130.0, 50.0, corr=1),
        _x("kernel", "gemm_s8s8", 710.0, 100.0, corr=2),
        _x("kernel", "softmax", 810.0, 40.0, corr=2),
        # dispatch 5 ends too close to the trace's end to count
        _x("user_annotation", "portbench.dispatch.5", 1_900_000.0, 50_000.0),
        _x("cuda_runtime", "cudaLaunchKernel", 1_900_010.0, 5.0, corr=3),
        _x("kernel", "gemm_s8s8", 1_900_020.0, 10.0, corr=3),
        # a host op while the device idles
        _x("cpu_op", "aten::copy_", 1_000.0, 1_799_000.0, tid=1),
    ]


def test_kernels_are_charged_to_their_dispatch_and_encode():
    d = T.parse(_events())
    assert d.window_s == pytest.approx(2.0)
    assert d.complete == {4}
    assert d.kernels[4] == pytest.approx({"logmel_kernel": 50e-6, "gemm_s8s8": 100e-6,
                                          "softmax": 40e-6})
    assert d.encode[4] == pytest.approx({"logmel_kernel": 50e-6})
    assert d.dispatch_seconds(4, lambda n: "s8" in n) == pytest.approx(100e-6)
    assert d.busy_s == pytest.approx((50 + 140 + 10) * 1e-6)
    assert d.device_ops[0] == ["gemm_s8s8", pytest.approx(110e-6)]


def test_idle_gaps_are_labelled_by_the_host():
    d = T.parse(_events())
    labels = dict((n, s) for n, s in d.idle_gaps)
    assert "aten::copy_" in labels
    assert sum(labels.values()) == pytest.approx(d.window_s - d.busy_s)


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(ValueError):
        T.parse([_x("kernel", "k", 0.0, 1.0)])
