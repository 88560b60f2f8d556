"""The least bytes of each kernel from hand-worked data counts, and a
roofline share from a hand-made trace."""

import pytest

from streambench.core.readers import roofline_pct
from streambench.core.spec import load_module
from streambench.core.trace import kernel_seconds


def test_ysb_k1_bytes():
    # 3 views read as key and time (4 + 4 bytes), 2 counts written (4 bytes)
    data = {"aggregated_records": 3, "result_cells": 2}
    assert load_module("roofline", "ysb").least_bytes("k1", data) == 3 * 8 + 2 * 4
    assert load_module("roofline", "ysb").least_bytes("k3", data) is None


def test_kernel_seconds_by_name():
    trace = {"kernel_s": {"k1_scan(int*, Fields)": 2e-3, "void k1_ingest_tiled(...)": 1e-3,
                          "k3_ingest_atomic(int*)": 5e-4, "at::native::k1_like": 7.0},
             "kernel_n": {"k1_scan(int*, Fields)": 4, "void k1_ingest_tiled(...)": 4,
                          "k3_ingest_atomic(int*)": 2, "at::native::k1_like": 1}}
    assert kernel_seconds(trace, "k1_") == pytest.approx((3e-3, 8))
    assert kernel_seconds(trace, "k3_") == pytest.approx((5e-4, 2))
    assert kernel_seconds(None, "k1_") == (0.0, 0)


def test_roofline_share_of_the_traced_part():
    # the run: 10 dispatches carrying 1e9 views; the traced part: 2 of them,
    # 4 CUDA kernels, 10 ms of K1
    rec = {"config": "ysb", "data": {"aggregated_records": 10**9, "result_cells": 0},
           "peak": {"hbm_bytes_per_s": 3.35e12},
           "launches_run": {"k1_superscan": 10},
           "trace_launches": {"k1_superscan": 2}, "trace_cuda_launches": {"k1_superscan": 4},
           "trace": {"kernel_s": {"k1_scan": 0.006, "k1_ingest": 0.004},
                     "kernel_n": {"k1_scan": 2, "k1_ingest": 2}}}
    # 8e9 bytes x 2/10 at 3.35e12 B/s take 0.478 ms; the kernels took 10 ms
    assert roofline_pct(rec, "k1", ("k1_superscan",)) == pytest.approx(
        100 * 8e9 * 0.2 / 3.35e12 / 0.01)
    rec["trace"]["kernel_n"]["k1_scan"] = 1     # the capture lost a kernel
    assert roofline_pct(rec, "k1", ("k1_superscan",)) is None
    rec["trace"]["kernel_n"]["k1_scan"] = 2
    rec["trace_launches"] = {"k1_superscan": 0}   # no dispatch in the traced part
    assert roofline_pct(rec, "k1", ("k1_superscan",)) is None
    rec["trace_launches"] = None                 # no capture
    assert roofline_pct(rec, "k1", ("k1_superscan",)) is None
