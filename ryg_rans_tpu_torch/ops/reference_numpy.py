"""Exact NumPy oracle for the lane-interleaved rANS stream format: the
``backend="numpy"`` of the API.

The port's own copy of the reference package's oracle, and the semantic
ground truth for any lane layout, including those the CUDA kernels and
their plain versions do not take.  It implements all four variants (BYTE /
WORD / RANS64 / ALIAS) for any lane count, vectorized across lanes with a
per-step Python loop, using plain integer division (the reference's "slow
path", rans_byte.h:83-90).  It stays NumPy: its arithmetic is ``uint64``,
which PyTorch on the CPU cannot compare or shift.

Stream format (see docs/FORMAT.md): symbols are dealt round-robin to
``n_lanes`` coder states; lanes are partitioned into substreams of
``lanes_per_stream`` lanes.  Each substream carries its lanes' flushed states
(lane-ascending, little-endian words) followed by renorm words in
(step-ascending, lane-ascending, within-lane reverse-emission) order -- the
order a forward-reading decoder consumes them.  With one substream and 1 or 2
lanes this is byte-for-byte the reference's plain / 2-way-interleaved layout
(encode loop main.cpp:222-246, decode loop main.cpp:255-285).

Encoding walks steps in reverse and conceptually writes backwards
(rans_byte.h:17-42 twists 1 and 2); because per-lane emission counts are
computed closed-form per step, the assembly below can build the
forward-order stream directly instead of reversing at the end.
"""

from __future__ import annotations

import numpy as np

from ..config import RansConfig, Variant
from ..models import alias as alias_mod
from ..models import stats as stats_mod

_U64 = np.uint64


def _deal(cfg: RansConfig, n_symbols: int):
    """Number of steps T and the (stream, lane) -> base symbol index map."""
    T = -(-n_symbols // cfg.n_lanes) if n_symbols else 0
    lane_pos = (
        np.arange(cfg.n_streams, dtype=np.int64)[:, None] * cfg.lanes_per_stream
        + np.arange(cfg.lanes_per_stream, dtype=np.int64)[None, :]
    )
    return T, lane_pos


def _word_dtype(word_bits: int):
    return {8: np.uint8, 16: np.uint16, 32: np.uint32}[word_bits]


class LaneCoder:
    """Shared per-variant constants and table lookups."""

    def __init__(self, cfg: RansConfig, freqs: np.ndarray, cum_freqs: np.ndarray):
        self.cfg = cfg
        self.spec = cfg.spec
        self.freqs = np.asarray(freqs, dtype=_U64)
        self.cum = np.asarray(cum_freqs, dtype=_U64)
        self.scale = cfg.prob_bits
        self.L = _U64(self.spec.L)
        self.mask = _U64((1 << self.scale) - 1)
        self.word_mask = _U64(self.spec.word_mask)
        self.word_bits = _U64(self.spec.word_bits)
        # Encoder renorm threshold multiplier: x_max = freq * x_max_mul
        # (rans_byte.h:64, rans64.h:83, rans_word_sse41.h:85).
        self.x_max_mul = _U64(
            (self.spec.L >> self.scale) << self.spec.word_bits)
        if cfg.variant == Variant.ALIAS:
            self.alias = alias_mod.make_alias_tables(
                freqs, cum_freqs, self.scale)
        else:
            self.alias = None
            # the linear cum2sym table is O(M) memory (main.cpp:145-148);
            # beyond 2^20 slots (RANS64 allows prob_bits 31) use a binary
            # search on cum instead -- same slot -> symbol map
            self.c2s = (stats_mod.cum2sym(cum_freqs, self.scale)
                        if self.scale <= 20 else None)

    # -- encode-side state transitions (vectorized over lanes) --

    def enc_renorm(self, x, freq, active):
        """Closed-form emission count + emitted words, high-word-first.

        Returns (x, words[max_renorm, lanes...], k[lanes...]) where words[r]
        is the r-th word in *forward/decoder* order (reverse emission order).
        """
        spec = self.spec
        x_max = freq * self.x_max_mul
        k = np.zeros(x.shape, np.int64)
        emitted = []  # emission order (low words first)
        for _ in range(spec.max_renorm):
            m = active & (x >= x_max)
            emitted.append((np.where(m, x & self.word_mask, 0), m))
            x = np.where(m, x >> self.word_bits, x)
            k += m
        words = np.stack([w for w, _ in reversed(emitted)])
        return x, words, k

    def enc_update(self, x, syms, active):
        freq = self.freqs[syms]
        start = self.cum[syms]
        if self.alias is not None:
            # x = (x/f)<<scale + alias_remap[(x%f) + cum[s]]
            # (main_alias.cpp:241-250)
            remap = self.alias.alias_remap.astype(_U64)
            idx = (x % np.maximum(freq, 1)) + start
            nx = ((x // np.maximum(freq, 1)) << _U64(self.scale)) + remap[
                np.minimum(idx, len(remap) - 1)]
        else:
            nx = ((x // np.maximum(freq, 1)) << _U64(self.scale)) \
                + (x % np.maximum(freq, 1)) + start
        return np.where(active, nx, x)

    # -- decode-side --

    def dec_symbol(self, x):
        """slot -> (symbol, advanced state before renorm)."""
        slot = x & self.mask
        if self.alias is not None:
            a = self.alias
            bucket = (slot >> _U64(self.scale - a.log2_nbuckets)).astype(np.int64)
            b2 = 2 * bucket + (slot < a.divider[bucket])
            nx = a.slot_freqs[b2] * (x >> _U64(self.scale)) + slot \
                - a.slot_adjust[b2]
            return a.sym_id[b2].astype(np.int64), nx
        if self.c2s is not None:
            s = self.c2s[slot.astype(np.int64)].astype(np.int64)
        else:
            # minimal s with cum[s+1] > slot (rank search; exact analog of
            # the table for any model incl. absent-symbol runs)
            s = np.searchsorted(self.cum[1:257].astype(np.uint64),
                                slot, side="right").astype(np.int64)
        nx = self.freqs[s] * (x >> _U64(self.scale)) + slot - self.cum[s]
        return s, nx

    def dec_need(self, x, active):
        """Closed-form renorm word count (0..max_renorm) per lane.

        Exact because post-advance x >= 1 and word_bits <= l_bits: the OR'd
        word can never lift a value across the L threshold on its own, so
        ``k = #{r : x << r*word_bits < L}`` matches the reference's
        read-as-you-go loop (rans_byte.h:307-318).
        """
        k = np.zeros(x.shape, np.int64)
        t = x.copy()
        for _ in range(self.spec.max_renorm):
            m = active & (t < self.L)
            k += m
            t = np.where(m, t << self.word_bits, t)
        return k


def encode(cfg: RansConfig, data: np.ndarray, freqs, cum_freqs) -> list[np.ndarray]:
    """Encode ``data`` (uint8) -> list of per-substream word arrays."""
    coder = LaneCoder(cfg, freqs, cum_freqs)
    spec = cfg.spec
    data = np.ascontiguousarray(data, dtype=np.uint8)
    S = data.size
    T, lane_pos = _deal(cfg, S)
    N = cfg.n_lanes

    x = np.full(lane_pos.shape, spec.L, dtype=_U64)
    # words per step, forward order, collected descending then reversed
    per_step: list[tuple[np.ndarray, np.ndarray]] = []

    padded = np.zeros(T * N, dtype=np.int64)
    padded[:S] = data
    sym_grid = padded.reshape(T, cfg.n_streams, cfg.lanes_per_stream)

    for t in range(T - 1, -1, -1):
        active = (t * N + lane_pos) < S
        syms = sym_grid[t]
        freq = coder.freqs[syms]
        x, words, k = coder.enc_renorm(x, np.where(active, freq, _U64(1)), active)
        x = coder.enc_update(x, syms, active)
        per_step.append((words, k))
    per_step.reverse()

    streams = []
    wdt = _word_dtype(spec.word_bits)
    for s in range(cfg.n_streams):
        chunks = []
        # flushed states, lane-ascending, little-endian words
        # (RansEncFlush rans_byte.h:93-105 / rans64.h:96-103)
        st = x[s]
        for g in range(cfg.lanes_per_stream):
            v = int(st[g])
            chunks.extend(
                (v >> (spec.word_bits * w)) & spec.word_mask
                for w in range(spec.state_words))
        head = np.array(chunks, dtype=wdt)
        body = []
        for words, k in per_step:
            # words: [max_renorm, n_streams, lpg] in forward order; for each
            # lane the valid forward words are the last k entries... they are
            # the first k of the reversed stack == rows where row index
            # >= max_renorm - k.  Build per-lane sequences lane-ascending.
            w = words[:, s, :]       # [max_renorm, lpg]
            kk = k[s]                # [lpg]
            if not kk.any():
                continue
            rows = np.arange(spec.max_renorm)[:, None]
            valid = rows >= (spec.max_renorm - kk[None, :])
            # column-major by lane: transpose to [lpg, max_renorm]
            sel = w.T[valid.T]
            body.append(sel.astype(wdt))
        streams.append(np.concatenate([head] + body) if body else head)
    return streams


def decode(cfg: RansConfig, streams: list[np.ndarray], n_symbols: int,
           freqs, cum_freqs) -> np.ndarray:
    """Decode per-substream word arrays -> uint8 symbols."""
    coder = LaneCoder(cfg, freqs, cum_freqs)
    spec = cfg.spec
    T, lane_pos = _deal(cfg, n_symbols)
    N = cfg.n_lanes
    lpg = cfg.lanes_per_stream

    # init states (RansDecInit rans_byte.h:109-122)
    x = np.zeros((cfg.n_streams, lpg), dtype=_U64)
    cursor = np.zeros(cfg.n_streams, dtype=np.int64)
    sdata = [np.asarray(st, dtype=_U64) for st in streams]
    if len(sdata) != cfg.n_streams or any(
            st.size < lpg * spec.state_words for st in sdata):
        raise ValueError("container corrupt: a substream is missing or "
                         "shorter than its lanes' states")
    for s in range(cfg.n_streams):
        head = sdata[s][:lpg * spec.state_words].reshape(lpg, spec.state_words)
        for w in range(spec.state_words):
            x[s] |= head[:, w] << _U64(spec.word_bits * w)
        cursor[s] = lpg * spec.state_words

    out = np.zeros((T, cfg.n_streams, lpg), dtype=np.uint8)
    for t in range(T):
        active = (t * N + lane_pos) < n_symbols
        syms, nx = coder.dec_symbol(x)
        x = np.where(active, nx, x)
        out[t] = np.where(active, syms, 0)
        k = coder.dec_need(x, active)
        for s in range(cfg.n_streams):
            ks = k[s]
            tot = int(ks.sum())
            if tot == 0:
                continue
            off = np.concatenate([[0], np.cumsum(ks)[:-1]]) + cursor[s]
            xs = x[s]
            for r in range(spec.max_renorm):
                m = ks > r
                idx = np.where(m, off + r, 0)
                w = sdata[s][np.minimum(idx, len(sdata[s]) - 1)]
                xs = np.where(m, (xs << coder.word_bits) | w, xs)
            x[s] = xs
            cursor[s] += tot

    return out.reshape(T * N)[:n_symbols] if T else np.zeros(0, np.uint8)


def roundtrip_payload_bytes(cfg: RansConfig, streams: list[np.ndarray]) -> int:
    """Total payload size in bytes (the reference's reported size metric,
    main.cpp:188 -- states + stream words, no container framing)."""
    return sum(s.nbytes for s in streams)
