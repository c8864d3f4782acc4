"""The device-trace readers on a made-up trace: each reads its own
operations, and reads nothing (None, never 0) where the trace has none."""
from __future__ import annotations

import types

import pytest

from perfbench import readers

PAGEABLE = "Memcpy HtoD (Pageable -> Device)"
INDEX_PUT = ("void (anonymous namespace)::indexing_backward_kernel_stride_1"
             "<long>(long const*, long const*, long*, long, bool)")


def _ctx(device_time: dict, **counters) -> readers.Context:
    prof = types.SimpleNamespace(device_time=device_time, spans={},
                                 window_s=10.0, busy_s=2.0)
    return readers.Context(counters, prof, {})


def test_pageable_upload():
    ctx = _ctx({PAGEABLE: 1.5, "Memcpy HtoD (Pinned -> Device)": 9.0},
               requests=3_000_000, schedule_requests=6_000_000)
    assert readers.pageable_upload_s_per_mreq(ctx) == pytest.approx(0.5)
    assert readers.pageable_upload_s_per_mreq(
        ctx, per_schedule=True) == pytest.approx(0.25)


def test_index_put_per_window():
    ctx = _ctx({INDEX_PUT: 0.8, "Memset (Device)": 5.0}, windows=400)
    assert readers.index_put_ms_per_window(ctx) == pytest.approx(2.0)


@pytest.mark.parametrize("read", [
    readers.pageable_upload_s_per_mreq, readers.index_put_ms_per_window])
def test_nothing_to_read(read):
    ctx = _ctx({"Memset (Device)": 1.0}, requests=10, windows=3)
    assert read(ctx) is None
