"""Public one-call API: compress / decompress on the card or the host.

Every entry point takes ``device="cuda"`` by default and runs the kernels
of the container's variant there: WORD (``ops.word``), BYTE and ALIAS
(``ops.byte``) or RANS64 (``ops.rans64``).  ``device="cpu"`` runs the
kernels' plain PyTorch versions instead.  With no CUDA device the default
raises, and a kernel that fails to build or launch raises.  A config
outside the kernels' shapes raises NotImplementedError.

``compress``, ``decompress`` and ``decompress_block`` also take
``backend="native"`` (the C++ host core, ``native``, blocks on host
threads) or ``backend="numpy"`` (the NumPy oracle,
``ops.reference_numpy``).  They code every ``RansConfig`` on the host (any
lane count and substream layout, prob_bits 8 up to the variant's maximum)
and do not use ``device``.  A host backend runs only when the call names
it: nothing falls back to one.

For the same input and ``RansConfig`` the containers of every backend are
byte-identical to the reference package's ``compress(data,
backend="numpy")``: the same model (main.cpp:49-129), the same padding
with the most frequent symbol, the same raw-block rule and the same
per-block CRC.

Each phase runs inside a ``torch.profiler.record_function`` span named
``rans.<phase>`` (model, encode, raw, crc, pack, unpack, decode, fetch), so
a profiler trace splits a call's wall time by phase; with no profiler
running a span costs about a microsecond.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.profiler import record_function

from . import native
from .config import RansConfig, Variant
from .models import stats
from .ops import byte, rans64, word
from .ops import reference_numpy as oracle
from .utils import container as cont
from .utils.log import backend_choice, container_summary

_CODECS = {Variant.WORD: word, Variant.BYTE: byte, Variant.ALIAS: byte,
           Variant.RANS64: rans64}
#: The ``backend=`` values that code on the host.
HOST_BACKENDS = ("numpy", "native")


def _codec(cfg: RansConfig):
    """The ops module coding ``cfg.variant``, after its config check."""
    mod = _CODECS[cfg.variant]
    mod.check_config(cfg)
    return mod


def _backend(backend) -> str | None:
    """``backend`` checked: None (the kernels on ``device``) or a host
    backend."""
    if backend is None or backend in HOST_BACKENDS:
        return backend
    raise ValueError(f"backend must be None (the kernels on `device`), "
                     f"'numpy' or 'native', not {backend!r}")


def _log_route(cfg: RansConfig, be: str | None, device, dev) -> None:
    """Log the host backend ``be``, or else the device ``dev`` that
    ``device`` named, as where the call codes."""
    backend_choice(cfg, f"backend={be}" if be else f"device={device}",
                   be or str(dev))


def _device(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels")
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {d}")
    return d


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytearray(data), np.uint8)
    arr = np.ascontiguousarray(data, np.uint8).reshape(-1)
    return arr if arr.flags.writeable else arr.copy()


def _block_slices(cfg: RansConfig, padded_len: int):
    off = 0
    for size in word.block_sizes(cfg.block_symbols, padded_len):
        yield off, size
        off += size


def _model(t: torch.Tensor, prob_bits: int):
    """Histogram where the data lies (one 256-count fetch), then the exact
    sequential normalization on the host."""
    counts = torch.bincount(t, minlength=256).cpu().numpy()
    return stats.build_model_from_counts(counts, prob_bits)


def _host_pool_map(fn, items):
    """Order-preserving map over independent blocks, on host threads when
    there are several cores and several items (the native core releases
    the GIL for each C call), else in this thread.  The results keep the
    items' order, so a container does not depend on the worker count."""
    workers = min(len(items), os.cpu_count() or 1)
    if workers <= 1:
        return [fn(it) for it in items]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(fn, items))


def _encode_payloads(cfg: RansConfig, padded, freqs, cum, device,
                     backend: str | None = None) -> list[list[np.ndarray]]:
    """Encode flat uint8 ``padded`` (a tensor or a host array, padded to a
    multiple of 4*n_lanes) -> per-block, per-substream word arrays on the
    host.

    With ``backend=None`` the kernels code it on ``device`` (``padded``
    goes there once, if it lies elsewhere); ``"numpy"`` or ``"native"``
    code its blocks on the host, native on host threads.  The blocks keep
    their order, so the words do not depend on the route."""
    if backend is None:
        codec = _codec(cfg)
        t = torch.as_tensor(padded).to(device)
        return [[w] for w in codec.encode(cfg, t, freqs, cum)]
    host = (padded.cpu().numpy() if isinstance(padded, torch.Tensor)
            else np.asarray(padded, np.uint8))
    chunks = [host[off:off + size]
              for off, size in _block_slices(cfg, host.size)]
    if backend == "numpy":
        return [oracle.encode(cfg, c, freqs, cum) for c in chunks]
    wdt = cont.word_dtype(cfg.variant)

    def enc_native(chunk):
        payload, words = native.encode(cfg, chunk, freqs, cum)
        return np.split(payload.view(wdt), np.cumsum(words)[:-1])
    return _host_pool_map(enc_native, chunks)


def _encode(cfg: RansConfig, t: torch.Tensor, device, backend):
    """Model, pad and encode flat uint8 ``t`` where it lies -> (freqs,
    per-block word arrays, padded length)."""
    with record_function("rans.model"):
        freqs, cum = _model(t, cfg.prob_bits)
    with record_function("rans.encode"):
        padded = word.pad_block(t, cfg.n_lanes, freqs)
        payloads = _encode_payloads(cfg, padded, freqs, cum, device, backend)
    return freqs, payloads, padded.numel()


def _decode_host(cfg: RansConfig, be: str, blocks, sizes, freqs,
                 cum) -> list[np.ndarray]:
    """Per-block lists of substream word arrays (padded symbol counts
    ``sizes``) -> per-block uint8 symbols, on host backend ``be``."""
    if be == "numpy":
        return [oracle.decode(cfg, blk, size, freqs, cum)
                for blk, size in zip(blocks, sizes)]

    def dec_native(args):
        blk, size = args
        payload = np.concatenate([s.view(np.uint8) for s in blk])
        words = np.array([s.size for s in blk], np.int64)
        return native.decode(cfg, payload, words, size, freqs, cum)
    return _host_pool_map(dec_native, list(zip(blocks, sizes)))


def _decode_payloads(cfg: RansConfig, payloads, sizes, freqs, cum,
                     raw=None, device="cuda",
                     backend: str | None = None) -> torch.Tensor:
    """Per-block payloads (padded symbol counts ``sizes``: equal but the
    last) -> their symbols as one flat uint8 tensor of ``sum(sizes)``, on
    ``device`` (the CPU for a host backend).

    The coded blocks are decoded by the kernels on ``device`` or, with
    ``backend``, on the host.  A block that ``raw`` marks (FLAG_RAW) is
    its stored bytes, zero-padded to its padded size."""
    codec = None if backend else _codec(cfg)
    dev = torch.device("cpu") if backend else torch.device(device)
    raw = (np.zeros(len(sizes), bool) if raw is None
           else np.asarray(raw, bool))
    coded = [i for i in range(len(sizes)) if not raw[i]]
    with record_function("rans.decode"):
        if backend:
            blocks = _decode_host(cfg, backend, [payloads[i] for i in coded],
                                  [sizes[i] for i in coded], freqs, cum)
            dec = torch.from_numpy(np.concatenate(blocks) if blocks
                                   else np.zeros(0, np.uint8))
        else:
            # the kernels' configs have one substream per block
            dec = codec.decode(cfg, [payloads[i][0] for i in coded],
                               [sizes[i] for i in coded], freqs, cum, dev)
    if not raw.any():
        return dec
    pieces, pos = [], 0
    for i, size in enumerate(sizes):
        if raw[i]:
            # stored verbatim and unpadded: zero-pad to the padded size
            b = np.asarray(payloads[i][0], np.uint8)
            if b.size > size:
                raise ValueError("container corrupt: raw block larger "
                                 "than its block")
            piece = torch.zeros(size, dtype=torch.uint8, device=dev)
            piece[:b.size] = torch.from_numpy(b.copy()).to(dev)
            pieces.append(piece)
        else:
            pieces.append(dec[pos:pos + size])
            pos += size
    return torch.cat(pieces)


def _raw_rule(cfg: RansConfig, payloads, lengths, fetch) -> np.ndarray:
    """The raw-block rule (rans_byte.h:28-35): block ``b``, whose words
    take at least its ``lengths[b]`` input bytes, is stored verbatim, its
    payload replaced by ``[fetch(b)]``.  Returns the raw flags."""
    wsize = np.dtype(cont.word_dtype(cfg.variant)).itemsize
    raw = np.zeros(len(payloads), bool)
    with record_function("rans.raw"):
        for b, n in enumerate(lengths):
            if sum(s.size for s in payloads[b]) * wsize >= n:
                raw[b] = True
                payloads[b] = [fetch(b)]
    return raw


def _pack_container(cfg: RansConfig, S: int, freqs, payloads,
                    padded_len: int, t: torch.Tensor | None,
                    host: np.ndarray | None) -> bytes:
    """Raw-block rule, CRCs and packing of ``S`` input bytes.  Raw blocks
    and CRCs take their bytes from ``host`` (the input on the host) or,
    when None, a raw block's bytes are fetched from ``t``."""
    slices = [(off, min(off + size, S))
              for off, size in _block_slices(cfg, padded_len)]

    def fetch(b):
        off, end = slices[b]
        return (host[off:end].copy() if host is not None
                else t[off:end].cpu().numpy())
    raw = _raw_rule(cfg, payloads, [end - off for off, end in slices], fetch)
    crcs = None
    if cfg.checksum:
        with record_function("rans.crc"):
            crcs = np.array([cont.crc32(host[off:end])
                             for off, end in slices], np.uint32)
    with record_function("rans.pack"):
        blob = cont.pack(cfg, S, freqs, payloads, crcs,
                         raw if raw.any() else None)
    container_summary(S, len(blob), len(payloads))
    return blob


def compress(data, cfg: RansConfig | None = None,
             device="cuda", backend: str | None = None) -> bytes:
    """Compress bytes / a uint8 array -> TRNS container bytes.

    With no ``cfg`` the shape adapts to the input size (RansConfig.auto).
    With ``backend=None`` the data goes to ``device`` once; histogram,
    padding, encode and compaction run there.  ``backend="native"`` or
    ``"numpy"`` codes on the host instead, for any config."""
    be = _backend(backend)
    dev = torch.device("cpu") if be else _device(device)
    data = _as_u8(data)
    cfg = cfg or RansConfig.auto(data.size)
    if data.size == 0:
        return cont.pack(cfg, 0, np.zeros(256, np.uint32), [], None)
    if not be:
        _codec(cfg)  # refuse the config before the data goes to the device
    _log_route(cfg, be, device, dev)
    # a host backend counts and pads a view of the host bytes
    t = torch.from_numpy(data).to(dev)
    return _pack_container(cfg, data.size, *_encode(cfg, t, dev, be), t,
                           data)


def compress_from_device(t: torch.Tensor,
                         cfg: RansConfig | None = None) -> bytes:
    """Compress a uint8 tensor where it lies -> TRNS container bytes,
    byte-identical to ``compress(t.cpu().numpy(), cfg)``.

    The host receives the 256-bin histogram and the compacted words.  CRCs
    cover the original bytes, which never visit the host here, so ``cfg``
    must have ``checksum=False`` (the default cfg does).  A block that does
    not shrink is still stored raw: only its bytes are fetched.  Only the
    kernels' configs are taken: for others, ``compress(...,
    backend=...)`` codes the data on the host."""
    if not isinstance(t, torch.Tensor) or t.dtype != torch.uint8:
        raise TypeError("compress_from_device takes a uint8 torch.Tensor")
    _device(t.device)
    t = t.reshape(-1)
    if cfg is None:
        cfg = dataclasses.replace(RansConfig.auto(t.numel()), checksum=False)
    if cfg.checksum:
        raise ValueError("compress_from_device requires checksum=False "
                         "(CRCs cover host-side original bytes)")
    if t.numel() == 0:
        return cont.pack(cfg, 0, np.zeros(256, np.uint32), [], None)
    t = t.contiguous()
    return _pack_container(cfg, t.numel(), *_encode(cfg, t, t.device,
                                                    None), t, None)


def _decode_container(c: cont.Container, dev: torch.device,
                      be: str | None = None) -> torch.Tensor:
    """All blocks of an unpacked container -> flat uint8 [orig_len] on
    ``dev``, decoded by the kernels there or, with ``be``, on the host
    (``dev`` is then the CPU)."""
    sizes = c.block_sizes()
    if len(c.payloads) != len(sizes):
        raise ValueError("container corrupt: block count does not match "
                         "orig_len")
    return _decode_payloads(c.cfg, c.payloads, sizes, c.freqs,
                            stats.calc_cum_freqs(c.freqs), c.raw, dev,
                            be)[:c.orig_len]


def _check_crc(c: cont.Container, block: int, data: np.ndarray) -> None:
    if c.crcs is not None and cont.crc32(data) != int(c.crcs[block]):
        raise ValueError(f"crc mismatch in block {block}")


def decompress(blob, device="cuda", backend: str | None = None) -> bytes:
    """Decompress a TRNS container -> original bytes, checking the
    per-block CRCs on the host.  ``backend="native"`` or ``"numpy"``
    decodes on the host, any container."""
    be = _backend(backend)
    dev = torch.device("cpu") if be else _device(device)
    with record_function("rans.unpack"):
        c = cont.unpack(blob)
    if c.orig_len == 0:
        return b""
    _log_route(c.cfg, be, device, dev)
    dec = _decode_container(c, dev, be)
    with record_function("rans.fetch"):
        out = dec.cpu().numpy()
    B = c.cfg.block_symbols
    with record_function("rans.crc"):
        for b in range(len(c.block_sizes())):
            off = b * B
            _check_crc(c, b, out[off:off + B])
    return out.tobytes()


def decompress_to_device(blob, device="cuda") -> torch.Tensor:
    """Decode a TRNS container into a uint8 tensor on ``device``.

    The container is parsed on the host, the words go to the device once,
    and the symbols stay there.  CRC contract: per-block CRCs cover the
    original bytes, which never visit the host here, so they are NOT
    checked; use decompress() for that, or CRC the tensor after use.  Only
    the kernels' configs are taken: ``decompress(..., backend=...)``
    decodes the others on the host."""
    dev = _device(device)
    with record_function("rans.unpack"):
        c = cont.unpack(blob)
    if c.orig_len == 0:
        return torch.empty(0, dtype=torch.uint8, device=dev)
    return _decode_container(c, dev)


def decompress_block(blob, block: int, device="cuda",
                     backend: str | None = None) -> bytes:
    """Random-access decode of ONE block of a TRNS container -> that
    block's original bytes (the last block may be short), CRC-checked.
    ``backend="native"`` or ``"numpy"`` decodes it on the host."""
    be = _backend(backend)
    dev = torch.device("cpu") if be else _device(device)
    c = cont.unpack(blob)
    cfg = c.cfg
    if not be:
        _codec(cfg)
    _log_route(cfg, be, device, dev)
    sizes = c.block_sizes()
    if len(c.payloads) != len(sizes):
        raise ValueError("container corrupt: block count does not match "
                         "orig_len")
    if not 0 <= block < len(sizes):
        raise IndexError(f"block {block} out of range [0, {len(sizes)})")
    off = block * cfg.block_symbols
    # a block of padding only (off past orig_len) holds no input bytes
    end = max(min(off + sizes[block], c.orig_len), off)
    out = _decode_payloads(
        cfg, c.payloads[block:block + 1], sizes[block:block + 1], c.freqs,
        stats.calc_cum_freqs(c.freqs),
        None if c.raw is None else c.raw[block:block + 1], dev,
        be).cpu().numpy()[:end - off]
    _check_crc(c, block, out)
    return out.tobytes()
