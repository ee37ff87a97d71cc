"""The reader of the program's pinned-ring fetches on synthetic traces:
``rans.pinned`` spans counted per call of one direction, and nothing read
where a run has no traced call of that direction or a program stages
nothing."""

import dataclasses

import pytest

from portbench import harness
from portbench.trace import Trace


def _ctx(calls, direction, trace=None):
    return harness.Context(
        direction=direction, calls=calls, window_s=2.0, setup_s=9.0,
        on_card=True, device_kind="NVIDIA H100 80GB HBM3",
        kernels=harness.load_kernels(), trace=trace)


@pytest.mark.parametrize("direction,mix", [("decode", "decompress"),
                                           ("encode", "compress")])
def test_pinned_fetches_are_counted_per_call(direction, mix):
    """``device.pinned_per_call.*`` counts the ``rans.pinned`` spans, each
    nested in a ``rans.fetch``, per call of its direction; a program that
    stages nothing (one without the ring) reads None."""
    reader = harness.load_module("metrics", f"device.pinned_per_call.{mix}")
    host = [(f"portbench.{direction}", 0, 40), ("rans.wait", 5, 6),
            ("rans.fetch", 6, 20), ("rans.pinned", 7, 19),
            (f"portbench.{direction}", 50, 90), ("rans.wait", 55, 56),
            ("rans.fetch", 56, 60), ("rans.wait", 61, 62),
            ("rans.fetch", 62, 80), ("rans.pinned", 62, 79),
            ("rans.pinned", 79, 80)]
    calls = [harness.Call(direction, i, 10**8, 0.1, True) for i in range(2)]
    staged = _ctx(calls, direction, Trace(host, [], (0, 100)))
    assert reader.read(staged) == 1.5
    plain = [s for s in host if s[0] != "rans.pinned"]
    assert reader.read(_ctx(calls, direction,
                            Trace(plain, [], (0, 100)))) is None
    assert reader.read(_ctx(calls, direction)) is None
    other = "encode" if direction == "decode" else "decode"
    theirs = [dataclasses.replace(c, direction=other) for c in calls]
    assert reader.read(_ctx(theirs, other,
                            Trace(host, [], (0, 100)))) is None
