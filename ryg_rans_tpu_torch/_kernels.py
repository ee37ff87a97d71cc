"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles on first use, with ``nvcc`` for
``sm_90a``, into a shared library with a plain C interface that ``ctypes``
loads.  All sources build at once, one ``nvcc`` process each.  Libraries
go to ``_build/<hash>/`` inside the package, a directory that
``.gitignore`` lists; the hash covers the flags, the source and every
``csrc/*.cuh`` header, so a changed source or header rebuilds and an
unchanged one loads from there.  There is no fallback: a missing ``nvcc``
or a failed build raises.

Every pointer and the stream pass as ``ctypes.c_void_p``, every size as
``ctypes.c_int``; each C entry returns ``cudaGetLastError()`` after its
launch, and :func:`call` raises when that is not 0.  The three cluster
decoders also export an occupancy query (:func:`query`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_ROOT = _HERE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signature of each entry point: (source stem, argtypes).  The
#: launches take PyTorch's stream last; the ``*_occupancy`` queries take a
#: pointer to the int they fill.
SIGNATURES = {
    "word_encode": ("word_encode", [_P] * 4 + [_I] * 4 + [_P]),
    "word_decode": ("word_decode", [_P] * 8 + [_I] * 8 + [_P]),
    "word_decode_occupancy": ("word_decode", [_I] * 6 + [_P]),
    "byte_encode": ("byte_encode", [_P] * 5 + [_I] * 4 + [_P]),
    "byte_decode": ("byte_decode", [_P] * 9 + [_I] * 9 + [_P]),
    "byte_decode_occupancy": ("byte_decode", [_I] * 7 + [_P]),
    "rans64_encode": ("rans64_encode", [_P] * 4 + [_I] * 4 + [_P]),
    "rans64_decode": ("rans64_decode", [_P] * 8 + [_I] * 8 + [_P]),
    "rans64_decode_occupancy": ("rans64_decode", [_I] * 6 + [_P]),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: ptxas report and seconds per source of the last build in this process.
build_log: dict[str, str] = {}
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    cands = [os.path.join(os.environ[k], "bin", "nvcc")
             for k in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(k)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(stem: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"{stem}.so"


def _build(stems: list[str]) -> None:
    """Compile every missing library, all nvcc processes at once."""
    nvcc = _nvcc()
    procs = []
    for stem in stems:
        dst = _lib_path(stem)
        dst.parent.mkdir(parents=True, exist_ok=True)
        tmp = dst.with_name(f"{stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs.append((stem, dst, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failed = []
    for stem, dst, tmp, t0, p in procs:
        out, _ = p.communicate()
        build_seconds[stem] = time.perf_counter() - t0
        build_log[stem] = out
        if p.returncode != 0:
            failed.append(f"{stem}.cu (exit {p.returncode}):\n{out}")
        else:
            os.replace(tmp, dst)  # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(names=None) -> dict[str, ctypes.CDLL]:
    """Build (if needed) and load the libraries of ``names`` (default: all
    entry points); returns {entry name: library}."""
    names = list(SIGNATURES) if names is None else list(names)
    with _lock:
        missing = [n for n in names if n not in _libs]
        stems = sorted({SIGNATURES[n][0] for n in missing})
        to_build = [s for s in stems if not _lib_path(s).exists()]
        if to_build:
            _build(to_build)
        for n in missing:
            stem, argtypes = SIGNATURES[n]
            lib = ctypes.CDLL(str(_lib_path(stem)))
            fn = getattr(lib, n)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{stem}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[n] = lib
        return {n: _libs[n] for n in names}


def _check(name: str, lib: ctypes.CDLL, rc: int) -> None:
    if rc != 0:
        msg = getattr(lib, f"{SIGNATURES[name][0]}_error_string")(rc)
        raise RuntimeError(
            f"{name} failed: CUDA error {rc} "
            f"({msg.decode() if msg else 'unknown'})")


def call(name: str, device, *args) -> None:
    """Launch entry ``name`` on ``device`` and PyTorch's current stream
    there; raise on a non-zero CUDA error code."""
    import torch

    lib = load([name])[name]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, name)(*args, stream)
    _check(name, lib, rc)


def query(name: str, device, *args) -> int:
    """Call the query entry ``name`` on ``device``; return the int it
    fills, or raise on a non-zero CUDA error code."""
    import torch

    lib = load([name])[name]
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = getattr(lib, name)(*args, ctypes.byref(out))
    _check(name, lib, rc)
    return out.value
