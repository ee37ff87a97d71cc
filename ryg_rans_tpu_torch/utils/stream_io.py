"""Bounded-memory file compression: stream blocks through the codec.

Counterpart of the reference package's ``utils/stream_io.py``.
``compress`` / ``decompress`` hold the whole input and container in memory;
these file variants code a batch of ``blocks_per_batch`` blocks at a time,
so host and device memory stay O(batch) whatever the file's size.  The
order-0 model is global (main.cpp:140), so compression reads the file
twice: a histogram pass, then the batches, whose payloads are spooled to a
temporary file beside ``dst`` and copied after the header.  The container
(docs/FORMAT.md) is the one ``compress`` writes for the same input and
``RansConfig``, byte for byte.

Every batch runs through ``api._encode_payloads`` / ``api._decode_payloads``:
with ``backend=None`` it goes to ``device`` once and the kernels code it
(``device="cuda"`` by default, raising without a card); ``backend="native"``
or ``"numpy"`` codes it on the host, for any config.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from .. import api
from ..config import RansConfig
from ..models import stats
from . import container as cont

_CHUNK = 1 << 24


def _hist_file(path: str) -> tuple[np.ndarray, int]:
    """256-bin histogram and length of the file at ``path``, counted with
    ``torch.bincount`` on views of 16 MiB reads."""
    counts = torch.zeros(256, dtype=torch.int64)
    total = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(_CHUNK)
            if not buf:
                break
            counts += torch.bincount(
                torch.frombuffer(bytearray(buf), dtype=torch.uint8),
                minlength=256)
            total += len(buf)
    return counts.numpy(), total


def _route(device, backend):
    """(device, backend) checked as the in-memory API checks them: a host
    backend runs only when named, else ``device`` must be usable."""
    be = api._backend(backend)
    return (torch.device("cpu") if be else api._device(device)), be


def _refuse_or_log(cfg: RansConfig, dev, device, be) -> None:
    """Without a host backend, the kernels' config check; then the log
    line of where the call codes."""
    if not be:
        api._codec(cfg)
    api._log_route(cfg, be, device, dev)


def compress_file(src: str, dst: str, cfg: RansConfig | None = None,
                  device="cuda", backend: str | None = None,
                  blocks_per_batch: int = 16) -> int:
    """Compress ``src`` into a TRNS container at ``dst`` with memory
    bounded by ``blocks_per_batch`` blocks.  Returns the container size in
    bytes."""
    if blocks_per_batch < 1:
        raise ValueError("blocks_per_batch must be at least 1")
    dev, be = _route(device, backend)
    counts, orig_len = _hist_file(src)
    # size-adaptive default, like api.compress (RansConfig.auto)
    cfg = cfg or RansConfig.auto(orig_len)
    if orig_len == 0:
        blob = cont.pack(cfg, 0, np.zeros(256, np.uint32), [], None)
        with open(dst, "wb") as f:
            f.write(blob)
        return len(blob)
    _refuse_or_log(cfg, dev, device, be)
    freqs, cum = stats.build_model_from_counts(counts, cfg.prob_bits)

    B = cfg.block_symbols
    step = 4 * cfg.n_lanes
    padded_len = -(-orig_len // step) * step
    fill = int(np.argmax(freqs))
    word_counts: list[list[int]] = []
    crcs: list[int] | None = [] if cfg.checksum else None
    raw_flags: list[bool] = []
    wdt = cont.word_dtype(cfg.variant)

    tmp_fd, tmp_path = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(dst)))
    try:
        with open(src, "rb") as fin, os.fdopen(tmp_fd, "wb") as ftmp:
            read = 0
            while read < padded_len:
                want = min(blocks_per_batch * B, padded_len - read)
                got = fin.read(min(want, max(orig_len - read, 0)))
                arr = np.full(want, fill, np.uint8)
                arr[:len(got)] = np.frombuffer(got, np.uint8)
                payloads = api._encode_payloads(cfg, arr, freqs, cum, dev,
                                                be)
                # input bytes of each block of the batch (padding excluded)
                lengths = [max(min(B, orig_len - read - i * B), 0)
                           for i in range(len(payloads))]
                raw = api._raw_rule(
                    cfg, payloads, lengths,
                    lambda i: arr[i * B:i * B + lengths[i]])
                for i, blk in enumerate(payloads):
                    raw_flags.append(bool(raw[i]))
                    if raw[i]:
                        word_counts.append(
                            [lengths[i]] + [0] * (cfg.n_streams - 1))
                        ftmp.write(blk[0].tobytes())
                    else:
                        word_counts.append([s.size for s in blk])
                        for s in blk:
                            ftmp.write(np.ascontiguousarray(s, wdt).tobytes())
                    if crcs is not None:
                        crcs.append(cont.crc32(
                            arr[i * B:i * B + lengths[i]]))
                read += want

        with open(dst, "wb") as fout:
            fout.write(cont.pack_header(
                cfg, orig_len, freqs, np.asarray(word_counts, np.uint32),
                None if crcs is None else np.asarray(crcs, np.uint32),
                np.asarray(raw_flags, bool)))
            with open(tmp_path, "rb") as ftmp:
                while buf := ftmp.read(_CHUNK):
                    fout.write(buf)
        return os.path.getsize(dst)
    finally:
        os.unlink(tmp_path)


def decompress_file(src: str, dst: str, device="cuda",
                    backend: str | None = None,
                    blocks_per_batch: int = 16) -> int:
    """Decompress a TRNS container file into ``dst``, ``blocks_per_batch``
    blocks at a time, checking the per-block CRCs.  Returns the number of
    bytes written."""
    if blocks_per_batch < 1:
        raise ValueError("blocks_per_batch must be at least 1")
    dev, be = _route(device, backend)
    with open(src, "rb") as f:
        meta, payload_off = cont.read_header(f)
        cfg = meta.cfg
        if meta.orig_len == 0:
            open(dst, "wb").close()
            return 0
        _refuse_or_log(cfg, dev, device, be)
        freqs = meta.freqs
        cum = stats.calc_cum_freqs(freqs)
        B = cfg.block_symbols
        sizes = meta.block_sizes()
        if meta.stream_words.shape[0] != len(sizes):
            raise ValueError("container corrupt: block count does not match "
                             "orig_len")
        wdt = cont.word_dtype(cfg.variant)

        f.seek(payload_off)
        written = 0
        with open(dst, "wb") as fout:
            for b0 in range(0, len(sizes), blocks_per_batch):
                batch = range(b0, min(b0 + blocks_per_batch, len(sizes)))
                raw = (None if meta.raw is None
                       else meta.raw[batch.start:batch.stop])
                payloads = []
                for bi in batch:
                    dt = np.uint8 if raw is not None and raw[bi - b0] else wdt
                    ws = np.dtype(dt).itemsize
                    blk = []
                    for s in range(cfg.n_streams):
                        n = int(meta.stream_words[bi, s])
                        buf = f.read(n * ws)
                        if len(buf) != n * ws:
                            raise ValueError("container truncated")
                        blk.append(np.frombuffer(buf, dt))
                    payloads.append(blk)
                out = api._decode_payloads(
                    cfg, payloads, sizes[batch.start:batch.stop], freqs, cum,
                    raw, dev, be).cpu().numpy()
                pos = 0
                for bi in batch:
                    off = bi * B
                    n = max(min(sizes[bi], meta.orig_len - off), 0)
                    piece = out[pos:pos + n]
                    pos += sizes[bi]
                    if meta.crcs is not None and \
                            cont.crc32(piece) != int(meta.crcs[bi]):
                        raise ValueError(f"crc mismatch in block {bi}")
                    fout.write(piece.tobytes())
                    written += n
        if f.read(1):
            raise ValueError("container size mismatch: bytes after the "
                             "last block")
        return written
