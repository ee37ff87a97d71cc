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

``to_host`` fetches a contiguous CUDA tensor of ``STAGE_MIN`` bytes or
more through a pinned ring of two ``CHUNK``-byte slots per device, made at
the first such fetch and kept: chunk k + 1 crosses the link while host
threads copy chunk k out of its slot, so the bytes cross to the host in
one pass, into a new array or into the caller's ``out``.  ``host_bytes``
makes a ``bytes`` to be filled that way.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
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
    "rans.pinned": "one tensor's fetch staged through the pinned ring",
    "rans.tables": "a codec's host tables and their upload",
    "rans.stage": "encode: the padding; decode: a launch group's words "
                  "uploaded (the blob's span where they lie back to back, "
                  "else joined first) and their heads gathered",
    "rans.launch": "a kernel wrapper's call: checks, allocation, launch",
    "rans.compact": "a launch group's emitted words selected on the device",
    "rans.assemble": "a launch group's words fetched and split per block",
}
_OFF = contextlib.nullcontext()
#: The start of the warning PyTorch gives on reading a read-only array.
_NOT_WRITABLE = "The given NumPy array is not writable"
#: Held while ``to_device`` silences that warning: ``catch_warnings``
#: swaps the process's filters, so two threads must not overlap in it.
_QUIET = threading.Lock()


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
    array gives one tensor, several a tuple.  A read-only NumPy array (a
    view of a ``bytes``) is copied even to the CPU: PyTorch has no
    read-only tensors, so the tensor it is read through lives only for the
    copy, and PyTorch's warning about that one is silenced."""
    device = torch.device(device)

    def put(a):
        if a is None:
            return None
        if isinstance(a, np.ndarray) and not a.flags.writeable:
            with _QUIET, warnings.catch_warnings():
                warnings.filterwarnings("ignore", _NOT_WRITABLE, UserWarning)
                src = torch.as_tensor(a)
            return src.to(device, copy=True)
        return torch.as_tensor(a).to(device)
    return _copies(put, arrays, device, "rans.put")


#: Bytes of one slot of the pinned ring that ``to_host`` stages through
#: (on an H100's 8-core host, 32 MiB fetched 10^8 B faster than 8 or 16:
#: fewer chunks, fewer waits for a chunk's slowest thread).
CHUNK = 1 << 25
#: The fewest bytes of a contiguous CUDA tensor that ``to_host`` stages.
#: A smaller one takes the pageable copy, which was faster there: its
#: array is mostly heap memory used before, where the staged copy's gain
#: is on fresh memory, faulted in by several threads at once.
STAGE_MIN = 1 << 25
#: Host threads, the caller's among them, that copy a chunk out of its slot.
COPY_THREADS = min(8, os.cpu_count() or 1)
#: The fewest bytes one of them copies.
_PIECE_MIN = 1 << 20

_STAGING = threading.Lock()  # guards the two below as they are made
_RINGS: dict[int, "_Ring"] = {}
_POOL: ThreadPoolExecutor | None = None


class _Ring:
    """Two pinned host slots of ``CHUNK`` bytes and an event each, for the
    staged fetches from one device; ``lock`` makes their callers take
    turns."""

    def __init__(self):
        self.slots = [torch.empty(CHUNK, dtype=torch.uint8, pin_memory=True)
                      for _ in range(2)]
        self.views = [s.numpy() for s in self.slots]
        self.events = [torch.cuda.Event() for _ in range(2)]
        self.lock = threading.Lock()


def _ring(device: torch.device) -> _Ring:
    with _STAGING:
        if device.index not in _RINGS:
            with torch.cuda.device(device):
                _RINGS[device.index] = _Ring()
        return _RINGS[device.index]


def _pool() -> ThreadPoolExecutor:
    global _POOL
    with _STAGING:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(COPY_THREADS - 1, "rans-host-copy")
        return _POOL


def _host_copy(dst: np.ndarray, src: np.ndarray) -> None:
    """``dst[:] = src`` for flat uint8 arrays of one length, in pieces of at
    least ``_PIECE_MIN`` bytes over up to ``COPY_THREADS`` threads:
    ``ctypes.memmove`` lets go of the GIL while it copies."""
    n = src.size
    parts = max(1, min(COPY_THREADS, n // _PIECE_MIN))
    step = -(-n // parts)
    d, s = dst.ctypes.data, src.ctypes.data
    pool = _pool() if parts > 1 else None
    rest = [pool.submit(ctypes.memmove, d + o, s + o, min(step, n - o))
            for o in range(step, n, step)] if pool else []
    ctypes.memmove(d, s, min(step, n))
    for f in rest:
        f.result()


def chunk_plan(nbytes: int) -> list[tuple[int, int, int]]:
    """(offset, length, slot) of each chunk of a staged fetch of
    ``nbytes``: ``CHUNK`` bytes each but the last, the slots in turn."""
    return [(off, min(CHUNK, nbytes - off), k % 2)
            for k, off in enumerate(range(0, nbytes, CHUNK))]


def _stage(src: torch.Tensor, dst: np.ndarray, ring: _Ring, stream) -> None:
    """``dst[:] = src`` (flat uint8, ``src`` on the device) through
    ``ring``: each chunk is copied into its slot on ``stream`` and an event
    recorded after it; once the event is reached the host copies the chunk
    out, and only then is the chunk two ahead copied into that slot.  The
    waits are on the ring's own copies, not drains of the stream."""
    plan = chunk_plan(src.numel())

    def enqueue(k):
        off, n, s = plan[k]
        ring.slots[s][:n].copy_(src[off:off + n], non_blocking=True)
        ring.events[s].record(stream)

    try:
        for k in range(min(2, len(plan))):
            enqueue(k)
        for k, (off, n, s) in enumerate(plan):
            ring.events[s].synchronize()
            _host_copy(dst[off:off + n], ring.views[s][:n])
            if k + 2 < len(plan):
                enqueue(k + 2)
    except BaseException:
        # no copy may still be writing a slot once the ring is let go
        for e in ring.events:
            e.synchronize()
        raise


@functools.cache
def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """NumPy's dtype for ``dtype``; raises as ``.numpy()`` does where NumPy
    has none."""
    return torch.empty(0, dtype=dtype).numpy().dtype


def to_host(*tensors, out: np.ndarray | None = None):
    """Tensors of one device -> NumPy arrays, one blocking copy each under
    one ``rans.fetch``.  One tensor gives one array, several a tuple.

    A contiguous CUDA tensor of ``STAGE_MIN`` bytes or more crosses through
    the device's pinned ring, under a ``rans.pinned`` of its own; any other
    takes ``.cpu().numpy()``.  With ``out`` (one tensor only: a writable,
    C-contiguous uint8 array of the tensor's byte size) the bytes land in
    ``out``, which comes back viewed as the tensor's dtype and shape."""
    if out is not None:
        if len(tensors) != 1:
            raise ValueError("to_host takes `out` with one tensor only")
        t = tensors[0]
        if (out.dtype != np.uint8 or not out.flags.c_contiguous
                or not out.flags.writeable
                or out.size != t.numel() * t.element_size()):
            raise ValueError(f"`out` must be a writable C-contiguous uint8 "
                             f"array of {t.numel() * t.element_size()} "
                             f"bytes")

    def fetch(t):
        nbytes = t.numel() * t.element_size()
        if t.is_cuda and t.is_contiguous() and nbytes >= STAGE_MIN:
            dtype = _np_dtype(t.dtype)
            dst = np.empty(nbytes, np.uint8) if out is None else out
            ring = _ring(t.device)
            with span("rans.pinned"), ring.lock:
                _stage(t.reshape(-1).view(torch.uint8), dst.reshape(-1),
                       ring, torch.cuda.current_stream(t.device))
            return dst.reshape(-1).view(dtype).reshape(t.shape)
        a = t.cpu().numpy()
        if out is None:
            return a
        dst = out.reshape(-1).view(a.dtype).reshape(a.shape)
        np.copyto(dst, a)
        return dst

    return _copies(fetch, tensors, tensors[0].device, "rans.fetch")


class _Bytes:
    """A ``bytes`` object's buffer as NumPy's array interface, writable;
    an array made from it keeps the ``bytes`` alive."""

    def __init__(self, owner: bytes):
        self.owner = owner
        self.__array_interface__ = {
            "data": (_PyBytes_AsString(owner), False),
            "shape": (len(owner),), "typestr": "|u1", "version": 3}


_PyBytes_FromStringAndSize = ctypes.PYFUNCTYPE(
    ctypes.py_object, ctypes.c_void_p, ctypes.c_ssize_t)(
    ("PyBytes_FromStringAndSize", ctypes.pythonapi))
_PyBytes_AsString = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.py_object)(
    ("PyBytes_AsString", ctypes.pythonapi))


def host_bytes(n: int) -> tuple[bytes, np.ndarray]:
    """A new ``bytes`` of ``n`` bytes, not yet filled, and a writable uint8
    view of it.  Fill it through the view before anything else holds the
    ``bytes``: the C API allows that of a new one, and nothing after."""
    if n == 0:
        return b"", np.empty(0, np.uint8)
    b = _PyBytes_FromStringAndSize(None, n)
    return b, np.asarray(_Bytes(b))


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
