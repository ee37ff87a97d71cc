"""The readers of the program's inner spans on synthetic traces: waits
counted per call, time exclusive of nested spans, and nothing read where
a run has no traced call of the direction or a program has no such spans;
then each tiny cell, traced on the CPU, reports every such metric it
lists."""

import time

import pytest

from portbench import harness, spans
from portbench.program import Program
from portbench.trace import Trace

from ._cells import CELLS, tiny

NEW = ("device.syncs_per_call", "device.wait_ms", "ops.host_ms",
       "api.bytes_ms")


def _ctx(trace, direction="encode", n=2):
    return harness.Context(
        direction=direction,
        calls=[harness.Call(direction, 0, 1, 1.0, True)] * n, window_s=1.0,
        setup_s=1.0, on_card=True, device_kind="NVIDIA H100 80GB HBM3",
        kernels=harness.load_kernels(), trace=trace)


def _encode_trace():
    """Two compress calls: an input upload, then ops spans holding waits
    and copies, one wait outside any ops span (the model's), and a span
    half outside the window."""
    host = [
        ("portbench.encode", 0, 100), ("rans.input", 1, 11),
        ("rans.wait", 2, 4), ("rans.put", 4, 10),
        ("rans.model", 12, 20), ("rans.wait", 13, 15),
        ("rans.encode", 20, 60), ("rans.stage", 21, 25),
        ("rans.tables", 25, 35), ("rans.wait", 26, 27), ("rans.put", 27, 30),
        ("rans.launch", 35, 40), ("rans.compact", 40, 50),
        ("rans.wait", 42, 48), ("rans.assemble", 50, 60),
        ("rans.wait", 50, 52), ("rans.fetch", 52, 56),
        ("portbench.encode", 100, 210), ("rans.tables", 195, 215),
        ("rans.wait", 196, 198),
    ]
    return Trace(host, [("k", 36, 39)], (0, 205))


def test_waits_are_counted_per_call():
    ctx = _ctx(_encode_trace())
    assert spans.count_per_call(ctx, "encode", "rans.wait") == 6 / 2
    assert spans.ms_per_call(ctx, "encode", ("rans.wait",)) == \
        pytest.approx((2 + 2 + 1 + 6 + 2 + 2) / 2 / 1e3)
    read = harness.load_module("metrics", "device.syncs_per_call.compress")
    assert read.read(ctx) == 3.0


def test_ops_time_leaves_out_the_nested_waits_and_copies():
    ctx = _ctx(_encode_trace())
    # stage 4 + tables 10 + launch 5 + compact 10 + assemble 10, and the
    # window cuts the last tables span to 195-205 (10, a wait of 2 in it)
    held = 4 + 10 + 5 + 10 + 10 + 10
    nested = (1 + 3) + 6 + (2 + 4) + 2
    got = harness.load_module("metrics", "ops.host_ms.compress").read(ctx)
    assert got == pytest.approx((held - nested) / 2 / 1e3)
    assert harness.load_module("metrics", "api.bytes_ms.compress").read(
        ctx) == pytest.approx(10 / 2 / 1e3)


def test_overlapping_outer_spans_count_once():
    t = Trace([("rans.stage", 0, 10), ("rans.launch", 5, 15),
               ("rans.wait", 8, 12), ("rans.put", 9, 11)], [], (0, 20))
    assert spans.exclusive_ms_per_call(
        _ctx(t, n=1), "encode", ("rans.stage", "rans.launch"),
        ("rans.wait", "rans.put")) == pytest.approx((15 - 4) / 1e3)


def test_nothing_is_read_without_calls_or_spans():
    t = _encode_trace()
    assert spans.count_per_call(_ctx(t), "decode", "rans.wait") is None
    assert spans.exclusive_ms_per_call(_ctx(t, "decode"), "encode",
                                       ("rans.tables",), ()) is None
    assert spans.ms_per_call(_ctx(None), "encode", ("rans.wait",)) is None
    # a program with no inner spans: only the phase spans it had
    old = Trace([("rans.model", 0, 5), ("rans.encode", 5, 9),
                 ("rans.fetch", 10, 12)], [], (0, 20))
    for name in ("device.syncs_per_call.compress", "device.wait_ms.compress",
                 "ops.host_ms.compress", "api.bytes_ms.compress"):
        assert harness.load_module("metrics", name).read(_ctx(old)) is None
    # decompress's bytes need both its fetch and its output spans
    dec = _ctx(old, "decode")
    assert harness.load_module("metrics", "api.bytes_ms.decompress").read(
        dec) is None
    with_out = Trace(old.host + [("rans.output", 12, 15)], [], (0, 20))
    assert harness.load_module("metrics", "api.bytes_ms.decompress").read(
        _ctx(with_out, "decode")) == pytest.approx(5 / 2 / 1e3)


@pytest.mark.parametrize("workload", CELLS)
def test_traced_tiny_cell_reports_the_span_metrics(workload):
    cell = tiny(workload)
    listed = {m["name"] for m in cell.per_layer
              if m["name"].startswith(NEW)}
    assert listed
    r = harness.run(cell, 2**31 + 9, 0.3, True, Program(cell.config, "cpu"),
                    "cpu", time.perf_counter())
    assert r["correct"], r["checks"]
    assert listed <= set(r["metrics"])
    assert all(r["metrics"][m]["value"] > 0 for m in listed)
