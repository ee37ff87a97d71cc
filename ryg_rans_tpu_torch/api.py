"""Public one-call API: compress / decompress on the card or the host.

Every entry point takes ``device="cuda"`` by default and runs the kernels
of the container's variant there, through the one loop of ``ops.codec``:
WORD (``ops.word``), BYTE and ALIAS (``ops.byte``) or RANS64
(``ops.rans64``).  ``device="cpu"`` runs the kernels' plain PyTorch
versions instead.  With no CUDA device the default raises, and a kernel
that fails to build or launch raises.  A config outside the kernels'
shapes raises NotImplementedError.

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

Each phase runs inside a span (``utils.profiling.span``) named
``rans.<phase>``: input, model, encode, raw, crc, pack, unpack, decode,
fetch, output, with the codecs' own spans and ``rans.wait`` / ``rans.put``
/ ``rans.fetch`` at every point where the host meets the device
(``utils.profiling.SPANS``).  So a profiler trace splits a call's wall
time by phase.  A span is a profiler annotation only while a profiler
runs: with none, it costs one check (0.4-0.6 us on an H100 machine's
8-core host, where an annotation entered with no profiler costs 10-11 us).

A payload byte is copied once into a container and not at all out of one:
``utils.container.unpack`` hands out views of the blob, read-only for a
``bytes`` blob.  The kernels' decode uploads a launch group's span of the
blob itself where its blocks lie back to back there (``ops.codec``'s
``stack_blocks``); every other path here joins the payloads into a new
array first.  ``to_device`` copies a read-only array even to the CPU, so
no tensor a call returns aliases the blob.  A decoded byte is
copied once on its way out: ``decompress`` and ``decompress_block`` make
their ``bytes`` first (``utils.profiling.host_bytes``) and ``to_host``
fills it, checked in place by the CRCs.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import native
from .config import RansConfig
from .models import stats
from .ops import codec
from .ops import reference_numpy as oracle
from .utils import container as cont
from .utils.log import backend_choice, container_summary
from .utils.profiling import host_bytes, span, to_device, to_host

#: The ``backend=`` values that code on the host.
HOST_BACKENDS = ("numpy", "native")


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
    for size in codec.block_sizes(cfg.block_symbols, padded_len):
        yield off, size
        off += size


def _model(t: torch.Tensor, prob_bits: int):
    """Histogram where the data lies (one 256-count fetch), then the exact
    sequential normalization on the host."""
    with span("rans.wait"):  # bincount reads the input's extent
        hist = torch.bincount(t, minlength=256)
    return stats.build_model_from_counts(to_host(hist), prob_bits)


def _host_pool_map(fn, items):
    """Order-preserving map over independent blocks, on host threads when
    there are several cores and several items (the native core and zlib
    release the GIL for each C call), else in this thread.  The results keep
    the items' order, so a container does not depend on the worker count."""
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
        codec.codec_of(cfg)
        if not (isinstance(padded, torch.Tensor)
                and padded.device.type == torch.device(device).type):
            padded = to_device(padded, device=device)
        return [[w] for w in codec.encode(cfg, padded, freqs, cum)]
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
    with span("rans.model"):
        freqs, cum = _model(t, cfg.prob_bits)
    with span("rans.encode"):
        with span("rans.stage"):
            padded = codec.pad_block(t, cfg.n_lanes, freqs)
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
    its stored bytes, zero-padded to its padded size.  The kernels refuse
    a config they do not take before anything goes to ``device``."""
    dev = torch.device("cpu") if backend else torch.device(device)
    raw = (np.zeros(len(sizes), bool) if raw is None
           else np.asarray(raw, bool))
    coded = [i for i in range(len(sizes)) if not raw[i]]
    with span("rans.decode"):
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
    with span("rans.raw"):
        # stored verbatim and unpadded: one upload, then each zero-padded
        # to its padded size
        stored = {i: np.asarray(payloads[i][0], np.uint8)
                  for i in range(len(sizes)) if raw[i]}
        if any(b.size > sizes[i] for i, b in stored.items()):
            raise ValueError("container corrupt: raw block larger than "
                             "its block")
        flat = to_device(np.concatenate(list(stored.values())), device=dev)
        pieces, pos, at = [], 0, 0
        for i, size in enumerate(sizes):
            if raw[i]:
                n = stored[i].size
                piece = torch.zeros(size, dtype=torch.uint8, device=dev)
                piece[:n] = flat[at:at + n]
                pieces.append(piece)
                at += n
            else:
                pieces.append(dec[pos:pos + size])
                pos += size
        # freed before the concatenation, so that a raw block's peak is
        # its piece and the output, as with one upload a block
        del flat
        return torch.cat(pieces)


def _block_crcs(data: np.ndarray, slices) -> np.ndarray:
    """CRC-32 of each ``data[off:end]`` of ``slices``, on host threads:
    zlib reads each block in place and releases the GIL while it does."""
    return np.array(_host_pool_map(lambda s: cont.crc32(data[s[0]:s[1]]),
                                   slices), np.uint32)


def _raw_rule(cfg: RansConfig, payloads, lengths, fetch) -> np.ndarray:
    """The raw-block rule (rans_byte.h:28-35): block ``b``, whose words
    take at least its ``lengths[b]`` input bytes, is stored verbatim, its
    payload replaced by ``[fetch(b)]``.  Returns the raw flags."""
    wsize = np.dtype(cont.word_dtype(cfg.variant)).itemsize
    raw = np.zeros(len(payloads), bool)
    with span("rans.raw"):
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
        # a view of the host bytes: pack copies it into the container
        return host[off:end] if host is not None else to_host(t[off:end])
    raw = _raw_rule(cfg, payloads, [end - off for off, end in slices], fetch)
    crcs = None
    if cfg.checksum:
        with span("rans.crc"):
            crcs = _block_crcs(host, slices)
    with span("rans.pack"):
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
    with span("rans.input"):
        data = _as_u8(data)
        cfg = cfg or RansConfig.auto(data.size)
        if data.size == 0:
            return cont.pack(cfg, 0, np.zeros(256, np.uint32), [], None)
        if not be:
            codec.codec_of(cfg)  # refuse the config before the upload
        _log_route(cfg, be, device, dev)
        # a host backend counts and pads a view of the host bytes
        t = torch.from_numpy(data) if be else to_device(data, device=dev)
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
                      be: str | None, first: int, n: int) -> torch.Tensor:
    """Blocks [first, first + n) of an unpacked container -> their original
    bytes, flat uint8 on ``dev``, decoded by the kernels there or, with
    ``be``, on the host (``dev`` is then the CPU)."""
    sizes = c.block_sizes()
    if len(c.payloads) != len(sizes):
        raise ValueError("container corrupt: block count does not match "
                         "orig_len")
    off, last = first * c.cfg.block_symbols, first + n
    # a block of padding only (off past orig_len) holds no input bytes
    end = max(min(off + sum(sizes[first:last]), c.orig_len), off)
    return _decode_payloads(
        c.cfg, c.payloads[first:last], sizes[first:last], c.freqs,
        stats.calc_cum_freqs(c.freqs),
        None if c.raw is None else c.raw[first:last], dev, be)[:end - off]


def _decompress_blocks(c: cont.Container, first: int, n: int,
                       dev: torch.device, be: str | None) -> bytes:
    """Blocks [first, first + n) of an unpacked container -> their
    original bytes as a new ``bytes``, filled straight from ``dev`` and
    checked against their CRCs."""
    dec = _decode_container(c, dev, be, first, n)
    with span("rans.output"):
        out, view = host_bytes(dec.numel())
    to_host(dec, out=view)
    with span("rans.crc"):
        _check_crcs(c, first, n, view)
    return out


def _check_crcs(c: cont.Container, first: int, n: int,
                data: np.ndarray) -> None:
    """Check the CRCs of the ``n`` blocks from ``first`` on, whose bytes
    ``data`` holds back to back (the last may be short or empty)."""
    if c.crcs is None:
        return
    B = c.cfg.block_symbols
    got = _block_crcs(data, [(i * B, (i + 1) * B) for i in range(n)])
    bad = np.flatnonzero(got != c.crcs[first:first + n])
    if bad.size:
        raise ValueError(f"crc mismatch in block {first + int(bad[0])}")


def decompress(blob, device="cuda", backend: str | None = None) -> bytes:
    """Decompress a TRNS container -> original bytes, checking the
    per-block CRCs on the host.  ``backend="native"`` or ``"numpy"``
    decodes on the host, any container."""
    be = _backend(backend)
    dev = torch.device("cpu") if be else _device(device)
    with span("rans.unpack"):
        c = cont.unpack(blob)
    if c.orig_len == 0:
        return b""
    _log_route(c.cfg, be, device, dev)
    return _decompress_blocks(c, 0, len(c.payloads), dev, be)


def decompress_to_device(blob, device="cuda") -> torch.Tensor:
    """Decode a TRNS container into a uint8 tensor on ``device``.

    The container is parsed on the host, the words go to the device once,
    and the symbols stay there.  CRC contract: per-block CRCs cover the
    original bytes, which never visit the host here, so they are NOT
    checked; use decompress() for that, or CRC the tensor after use.  Only
    the kernels' configs are taken: ``decompress(..., backend=...)``
    decodes the others on the host."""
    dev = _device(device)
    with span("rans.unpack"):
        c = cont.unpack(blob)
    if c.orig_len == 0:
        return torch.empty(0, dtype=torch.uint8, device=dev)
    return _decode_container(c, dev, None, 0, len(c.payloads))


def decompress_block(blob, block: int, device="cuda",
                     backend: str | None = None) -> bytes:
    """Random-access decode of ONE block of a TRNS container -> that
    block's original bytes (the last block may be short), CRC-checked.
    ``backend="native"`` or ``"numpy"`` decodes it on the host."""
    be = _backend(backend)
    dev = torch.device("cpu") if be else _device(device)
    with span("rans.unpack"):
        c = cont.unpack(blob)
    if not be:
        codec.codec_of(c.cfg)
    _log_route(c.cfg, be, device, dev)
    n_blocks = len(c.block_sizes())
    if not 0 <= block < n_blocks:
        raise IndexError(f"block {block} out of range [0, {n_blocks})")
    return _decompress_blocks(c, block, 1, dev, be)
