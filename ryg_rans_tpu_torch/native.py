"""ctypes binding to the port's C++ host core (``csrc/rans_core.cpp``): the
``backend="native"`` of the API.

The shared library builds on first use with ``g++ -O3 -march=native`` into
``_build/host/<hash>/rans_core.so`` inside the package, a directory that
``.gitignore`` lists.  The hash covers the source, the flags, ``g++
--version`` and the build host's CPU (its machine type and the ``flags``
line of ``/proc/cpuinfo``), since ``-march=native`` code may not run on
another CPU.  There is no fallback: without g++, or when the build fails,
every call raises RuntimeError, with the compiler's output.

The C calls release the GIL, so the API codes independent blocks on host
threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from .config import RansConfig
from .utils.container import word_dtype

_HERE = Path(__file__).resolve().parent
SRC = _HERE / "csrc" / "rans_core.cpp"
BUILD_ROOT = _HERE / "_build" / "host"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_U32P = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: Seconds of this process's g++ run; None when the library was built
#: before (or not yet loaded).
build_seconds: float | None = None


def _cpu_flags() -> str:
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return ""
    return next((ln for ln in text.splitlines() if ln.startswith("flags")),
                "")


def _lib_path(gxx: str) -> Path:
    version = subprocess.run([gxx, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256()
    for part in (" ".join(GXX_FLAGS), version, platform.machine(),
                 _cpu_flags()):
        h.update(part.encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "rans_core.so"


def _build(gxx: str, so: Path) -> None:
    global build_seconds
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"rans_core.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    p = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if p.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SRC.name} (exit "
                           f"{p.returncode}):\n{p.stdout}")
    os.replace(tmp, so)  # atomic: concurrent builders agree
    build_seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """Build (if needed) and load the host core; raise when it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(
                "g++ not found: the native host core (csrc/rans_core.cpp) "
                "cannot be built; install g++ or use backend='numpy'")
        so = _lib_path(gxx)
        if not so.exists():
            _build(gxx, so)
        lib = ctypes.CDLL(str(so))
        lib.trans_encode.restype = ctypes.c_int64
        lib.trans_encode.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _U8P, ctypes.c_int64, _U32P, _U32P, _U8P, ctypes.c_int64, _I64P,
        ]
        lib.trans_decode.restype = ctypes.c_int64
        lib.trans_decode.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _U8P, _I64P, ctypes.c_int64, _U32P, _U32P, _U8P,
        ]
        lib.trans_build_alias.restype = ctypes.c_int64
        lib.trans_build_alias.argtypes = [
            ctypes.c_int, _U32P, _U32P, _U32P, _U32P, _U32P, _U8P, _U32P,
        ]
        _lib = lib
        return lib


def _u32_model(freqs, cum_freqs):
    return (np.ascontiguousarray(freqs, dtype=np.uint32),
            np.ascontiguousarray(cum_freqs, dtype=np.uint32))


def encode(cfg: RansConfig, data: np.ndarray, freqs, cum_freqs):
    """Encode uint8 ``data`` -> (payload bytes, int64 word count of each
    substream); the substreams lie back to back in the payload."""
    lib = load()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    freqs32, cum32 = _u32_model(freqs, cum_freqs)
    ws = np.dtype(word_dtype(cfg.variant)).itemsize
    spec = cfg.spec
    cap = (data.size * spec.max_renorm + cfg.n_lanes * spec.state_words
           + 64) * ws
    out = np.empty(cap, np.uint8)
    stream_words = np.zeros(cfg.n_streams, np.int64)
    n = lib.trans_encode(
        int(cfg.variant), cfg.prob_bits, cfg.n_lanes, cfg.lanes_per_stream,
        data, data.size, freqs32, cum32, out, cap, stream_words)
    if n < 0:
        raise RuntimeError(f"trans_encode failed: {n}")
    return out[:n].copy(), stream_words


def decode(cfg: RansConfig, payload: np.ndarray, stream_words: np.ndarray,
           n_symbols: int, freqs, cum_freqs) -> np.ndarray:
    """Decode ``n_symbols`` symbols from a payload of back-to-back
    substreams of ``stream_words`` words each -> uint8 array.

    Raises ValueError when the counts do not describe the payload.  The
    decoders read at most the words a valid stream of ``n_symbols``
    symbols holds, so the payload travels in a zero-filled buffer that
    size past its end: a corrupt stream decodes to wrong symbols and reads
    nothing out of bounds."""
    lib = load()
    payload = np.ascontiguousarray(payload).view(np.uint8).reshape(-1)
    sw = np.ascontiguousarray(stream_words, dtype=np.int64).reshape(-1)
    spec = cfg.spec
    ws = np.dtype(word_dtype(cfg.variant)).itemsize
    lpg = cfg.lanes_per_stream
    head = lpg * spec.state_words
    if (sw.size != cfg.n_streams or (sw < head).any()
            or int(sw.sum()) * ws != payload.size):
        raise ValueError("container corrupt: substream word counts do not "
                         "match the payload")
    steps = -(-n_symbols // cfg.n_lanes)
    slack = (head + spec.max_renorm * steps * lpg) * ws + 64
    buf = np.zeros(payload.size + slack, np.uint8)
    buf[:payload.size] = payload
    freqs32, cum32 = _u32_model(freqs, cum_freqs)
    out = np.empty(n_symbols, np.uint8)
    rc = lib.trans_decode(
        int(cfg.variant), cfg.prob_bits, cfg.n_lanes, cfg.lanes_per_stream,
        buf, sw, n_symbols, freqs32, cum32, out)
    if rc != 0:
        raise RuntimeError(f"trans_decode failed: {rc}")
    return out


def build_alias_tables(scale_bits: int, freqs, cum_freqs) -> dict:
    """The host core's alias tables -> dict of arrays (divider, slot_freqs,
    slot_adjust, sym_id, alias_remap), field for field those of
    ``models.alias.make_alias_tables``."""
    lib = load()
    freqs32, cum32 = _u32_model(freqs, cum_freqs)
    divider = np.zeros(256, np.uint32)
    slot_freqs = np.zeros(512, np.uint32)
    slot_adjust = np.zeros(512, np.uint32)
    sym_id = np.zeros(512, np.uint8)
    remap = np.zeros(1 << scale_bits, np.uint32)
    rc = lib.trans_build_alias(
        scale_bits, freqs32, cum32, divider, slot_freqs, slot_adjust,
        sym_id, remap)
    if rc != 0:
        raise RuntimeError(f"trans_build_alias failed: {rc}")
    return dict(divider=divider, slot_freqs=slot_freqs,
                slot_adjust=slot_adjust, sym_id=sym_id, alias_remap=remap)
