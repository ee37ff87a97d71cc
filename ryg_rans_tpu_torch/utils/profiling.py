"""Timing and tracing utilities.

Counterpart of the reference package's ``utils/profiling.py``.  The
reference's demos instrument with __rdtsc and the wall clock, 5
repetitions, printing clocks/symbol and MiB/s (main.cpp:169-186).  Here:

* ``timed_runs``: best-of-N wall-clock timing; a CUDA tensor returned by
  the timed function is waited for with ``torch.cuda.synchronize``;
* ``trace``: a ``torch.profiler`` scope whose trace lands in a directory
  (view it with TensorBoard or ``chrome://tracing``);
* ``dispatch_slope``: seconds per repetition from the slope between two
  repetition counts, which cancels what one call costs around the work;
* ``report_line``: the reference's 'name: X ns/symbol (Y MiB/s)' line.

The port's own tracing is here too: ``span``, the one way the package
marks a phase (a ``rans.*`` ``record_function`` while a profiler runs, a
shared no-op otherwise, so that with no profiler a span costs one check),
and ``to_device`` / ``to_host``, through which every blocking copy of the
entry points goes.  While a profiler runs, each copy helper first drains
the stream under ``rans.wait``, so that its ``rans.put`` / ``rans.fetch``
holds the copy alone; an operation that synchronises inside (a boolean
mask select, a ``bincount``) runs whole in a ``rans.wait`` of its own.
One ``rans.wait`` is one point at which the host drains the device.
``SPANS`` lists every span name.  ``trace(dir)`` captures them, with the
device's work on the same clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch
from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

#: Every span the package records, and what it holds.
SPANS = {
    "rans.input": "compress: the input as a uint8 array and its upload",
    "rans.model": "the histogram where the data lies, its fetch and the "
                  "host normalisation",
    "rans.encode": "padding and the codec's encode",
    "rans.raw": "the raw-block rule (encode); the raw blocks' upload, "
                "padding and concatenation (decode)",
    "rans.crc": "the per-block CRCs on the host",
    "rans.pack": "the container's bytes",
    "rans.unpack": "the container parsed",
    "rans.decode": "the codec's decode of the coded blocks",
    "rans.output": "the decoded bytes as ``bytes``",
    "rans.wait": "the host blocked until the device's stream drains",
    "rans.put": "blocking copies, host to device",
    "rans.fetch": "blocking copies, device to host",
    "rans.tables": "a codec's host tables and their upload",
    "rans.stage": "encode: the padding; decode: a launch group's words "
                  "stacked, uploaded and their heads gathered",
    "rans.launch": "a kernel wrapper's call: checks, allocation, launch",
    "rans.compact": "a launch group's emitted words selected on the device",
    "rans.assemble": "a launch group's words fetched and split per block",
}
_OFF = contextlib.nullcontext()


def span(name: str):
    """Context of the phase ``name`` (one of ``SPANS``): a
    ``torch.profiler.record_function`` while a profiler runs, else a
    shared no-op, so that a span costs one check with no profiler."""
    return record_function(name) if _profiler_enabled() else _OFF


def _drain(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _copies(fn, items, device: torch.device, name: str):
    if _profiler_enabled():
        with record_function("rans.wait"):
            _drain(device)
        with record_function(name):
            out = tuple(fn(x) for x in items)
    else:
        out = tuple(fn(x) for x in items)
    return out[0] if len(out) == 1 else out


def to_device(*arrays, device):
    """Host arrays (NumPy or CPU tensors; None passes through) -> tensors
    on ``device``, one blocking copy each under one ``rans.put``.  One
    array gives one tensor, several a tuple."""
    device = torch.device(device)
    return _copies(lambda a: None if a is None
                   else torch.as_tensor(a).to(device),
                   arrays, device, "rans.put")


def to_host(*tensors):
    """Tensors of one device -> NumPy arrays, one blocking copy each under
    one ``rans.fetch``.  One tensor gives one array, several a tuple."""
    return _copies(lambda t: t.cpu().numpy(), tensors, tensors[0].device,
                   "rans.fetch")


def _sync(out=None) -> None:
    """Wait for the card: always when ``out`` is None and a card is up,
    else when ``out`` is a CUDA tensor."""
    if out is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    elif isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


def timed_runs(fn: Callable[[], object], runs: int = 5):
    """Run ``fn`` ``runs`` times; returns (best_seconds, all_seconds).

    ``fn`` must finish its work before it returns, or return a tensor: a
    CUDA tensor is waited for here (``torch.cuda.synchronize``), as the
    reference waits with ``block_until_ready``.
    """
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        _sync(fn())
        times.append(time.perf_counter() - t0)
    return min(times), times


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` scope over the host and, when there is a card,
    the card; its Chrome trace is written into ``log_dir`` on exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def dispatch_slope(make_chained: Callable[[int], Callable[[], object]],
                   lo: int = 2, hi: int = 14, tries: int = 3) -> float:
    """Seconds per repetition via the slope between chained-rep calls.

    ``make_chained(reps)`` returns a zero-arg callable that runs ``reps``
    data-dependent repetitions.  The card is synchronized around each
    timed call, so what a call costs besides its repetitions (launch,
    copies, the host round trip) cancels in the slope.
    """
    run_lo = make_chained(lo)
    run_hi = make_chained(hi)
    for f in (run_lo, run_hi):  # warm both
        _sync(f())

    def best(f):
        ts = []
        for _ in range(tries):
            _sync()
            t0 = time.perf_counter()
            _sync(f())
            _sync()
            ts.append(time.perf_counter() - t0)
        return min(ts)

    return (best(run_hi) - best(run_lo)) / (hi - lo)


def report_line(name: str, n_bytes: int, seconds: float) -> str:
    """Reference-style report: 'name: X ns/symbol (Y MiB/s)'
    (main.cpp:184-186 prints clocks/symbol + MB/s)."""
    return (f"{name}: {seconds * 1e9 / max(n_bytes, 1):.2f} ns/symbol "
            f"({n_bytes / max(seconds, 1e-12) / 1048576:.1f} MiB/s)")
