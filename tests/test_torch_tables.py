"""The port's division-free encoder tables
(``ryg_rans_tpu_torch.models.tables``) against the reference package's
(``ryg_rans_tpu.models.tables``, and for RANS64 the kernel table of
``ryg_rans_tpu.ops.rans64_tpu``), field for field; each reciprocal
quotient against ``x // freq`` (BYTE for every frequency at prob_bits 16,
RANS64 at prob_bits 31, WORD for every frequency at prob_bits 15); and the
encode steps as K2, K4 and K6 (``csrc/word_encode.cu``, ``byte_encode.cu``,
``rans64_encode.cu``) compute them from their ``host_prep`` tables, in
NumPy, against the plain versions.  Exact equality throughout."""

import numpy as np
import pytest
import torch

from ryg_rans_tpu.models import tables as ref_tables
from ryg_rans_tpu.ops import rans64_tpu
from ryg_rans_tpu_torch.models import tables
from ryg_rans_tpu_torch.ops import byte, host_prep, rans64, word

U32 = (1 << 32) - 1


def synthetic_model(pb: int, seed: int, kind: str):
    """(freqs, cum_freqs[257]) summing to 2^pb: ``mixed`` has a quarter of
    its symbols at freq 1 and unused symbols between used ones; ``one`` is
    the one-symbol model (freq 2^pb); ``flat`` uses all 256 symbols."""
    rng = np.random.default_rng(seed)
    M = 1 << pb
    freqs = np.zeros(256, np.int64)
    if kind == "one":
        freqs[rng.integers(0, 256)] = M
    else:
        n = 256 if kind == "flat" else int(rng.integers(8, 200))
        used = rng.choice(256, n, replace=False)
        ones = used[:n // 4] if kind == "mixed" else used[:0]
        rest = used[n // 4:] if kind == "mixed" else used
        freqs[ones] = 1
        left = M - ones.size - rest.size
        freqs[rest] = 1 + rng.multinomial(left, np.full(rest.size,
                                                        1 / rest.size))
    assert freqs.sum() == M
    cum = np.concatenate([[0], np.cumsum(freqs)]).astype(np.int64)
    return freqs, cum


KINDS = ["mixed", "one", "flat"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pb", [9, 12, 14, 16])
def test_byte_enc_tables_match_reference(pb, kind):
    freqs, cum = synthetic_model(pb, pb, kind)
    if kind == "mixed":
        assert (freqs == 1).any()
    mine = tables.build_byte_enc_tables(freqs, cum, pb)
    theirs = ref_tables.build_byte_enc_tables(freqs, cum, pb)
    for field in ("x_max", "rcp_freq", "bias", "cmpl_freq", "rcp_shift"):
        a, b = getattr(mine, field), getattr(theirs, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pb", [9, 12, 14, 16, 24, 31])
def test_rans64_enc_tables_match_reference(pb, kind):
    freqs, cum = synthetic_model(pb, pb + 100, kind)
    mine = tables.build_rans64_enc_tables(freqs, cum, pb)
    theirs = ref_tables.build_rans64_enc_tables(freqs, cum, pb)
    for field in ("freq", "rcp_freq", "bias", "cmpl_freq", "rcp_shift"):
        a, b = getattr(mine, field), getattr(theirs, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


def quotients(x, rcp, shift):
    """mulhi32(x, rcp) >> shift, in uint64."""
    return ((x * rcp) >> np.uint64(32)) >> shift


@pytest.mark.parametrize("first", range(1, 1 << 16, 1 << 12))
def test_reciprocal_quotient_is_exact(first):
    """Every freq in [first, first + 4096) at prob_bits 16: the boundary
    states (2^23, x_max - 1, freq and freq +- 1) and 64 seeded random states
    below x_max = freq << 15, the largest state the encoder divides."""
    pb, M = 16, 1 << 16
    fs = np.arange(first, min(first + (1 << 12), M + 1), dtype=np.int64)
    rcp = np.zeros(fs.size, np.uint64)
    shift = np.zeros(fs.size, np.uint64)
    bias = np.zeros(fs.size, np.uint64)
    starts = np.random.default_rng(first).integers(0, M - fs + 1)
    for i in range(0, fs.size, 256):  # 256 symbols a table
        f, st = fs[i:i + 256], starts[i:i + 256]
        k = f.size
        t = tables.build_byte_enc_tables(np.pad(f, (0, 256 - k)),
                                         np.pad(st, (0, 256 - k)), pb)
        rcp[i:i + k] = t.rcp_freq[:k]
        shift[i:i + k] = t.rcp_shift[:k]
        bias[i:i + k] = t.bias[:k]
        assert np.array_equal(t.cmpl_freq[:k], M - f)
    x_max = fs << 15
    rng = np.random.default_rng(first + 1)
    states = [np.full(fs.size, 1 << 23), x_max - 1, fs - 1, fs, fs + 1] + [
        rng.integers(1, x_max) for _ in range(64)]
    f64 = fs.astype(np.uint64)
    st = starts.astype(np.uint64)
    for x in states:
        ok = (x >= 1) & (x < x_max)
        x = np.where(ok, x, 1).astype(np.uint64)
        q = quotients(x, rcp, shift)
        # BYTE: x + bias + q * cmpl_freq, mod 2^32, is the division's result
        byte_x = (x + bias + q * (np.uint64(M) - f64)) & np.uint64(U32)
        assert np.array_equal(byte_x, (x // f64 << np.uint64(pb))
                              + x % f64 + st)
        # ALIAS: the true quotient, with q = x at freq 1
        qa = np.where(f64 == 1, x, q)
        assert np.array_equal(qa, x // f64)
        assert np.array_equal(x - qa * f64, x % f64)
        assert np.array_equal(q[f64 > 1], (x // f64)[f64 > 1])


def emulate_k4(syms, table, remap, n_lanes, pb):
    """K4's step in NumPy from its table rows: renorm against x_max, then the
    reciprocal quotient (BYTE through bias and cmpl_freq, ALIAS through its
    remap with q = x at freq 1).  Returns (cells, states) as the kernel
    writes them."""
    rows = table.view(np.uint32).astype(np.uint64)
    nb, S = syms.shape
    T = S // n_lanes
    grid = syms.reshape(nb, T, n_lanes)
    x = np.full((nb, n_lanes), 1 << 23, np.uint64)
    cells = np.zeros((nb, T, n_lanes), np.uint64)
    for t in range(T - 1, -1, -1):
        e = rows[grid[:, t]]
        x_max, rcp, z = e[..., 0], e[..., 1], e[..., 2]
        shift = e[..., 3] >> np.uint64(24)
        low = e[..., 3] & np.uint64(0xFFFFFF)
        m1 = x >= x_max
        x1 = np.where(m1, x >> np.uint64(8), x)
        m2 = x1 >= x_max
        cells[:, t] = np.where(
            m2, (2 << 16) | ((x1 & np.uint64(255)) << np.uint64(8))
            | (x & np.uint64(255)),
            np.where(m1, (1 << 16) | ((x & np.uint64(255)) << np.uint64(8)),
                     0))
        xs = np.where(m2, x1 >> np.uint64(8), x1)
        q = quotients(xs, rcp, shift)
        if remap is None:
            x = (xs + z + q * low) & np.uint64(U32)
        else:
            q = np.where(z == 1, xs, q)
            x = (q << np.uint64(pb)) | remap[(xs - q * z + low).astype(
                np.int64)].astype(np.uint64)
    return (cells.reshape(nb, S).astype(np.uint32).view(np.int32),
            x.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("variant,pb", [("BYTE", 9), ("BYTE", 14),
                                        ("BYTE", 16), ("ALIAS", 12),
                                        ("ALIAS", 16)])
def test_k4_step_from_its_table_matches_plain(variant, pb, kind):
    """The arithmetic K4 runs on its table rows equals the plain version of
    K4 (the divide) on the same symbols, cell for cell and state for
    state."""
    freqs, cum = synthetic_model(pb, 7 * pb, kind)
    N, T, nb = 128, 24, 2
    rng = np.random.default_rng(pb)
    syms = rng.choice(256, (nb, T * N), p=freqs / freqs.sum()).astype(
        np.uint8)
    alias = variant == "ALIAS"
    table = host_prep.byte_enc_table(freqs, cum, pb, alias)
    assert table.dtype == np.int32 and table.shape == (256, 4)
    remap = host_prep.alias_remap(freqs, cum, pb) if alias else None
    cells, states = emulate_k4(
        syms, table, None if remap is None else remap.view(np.uint16), N, pb)
    f, st = (torch.from_numpy(a) for a in host_prep.enc_tables(freqs, cum))
    cells_r, states_r = byte.encode_blocks_ref(
        torch.from_numpy(syms), f, st,
        None if remap is None else torch.from_numpy(remap), N, pb)
    assert np.array_equal(cells, cells_r.numpy())
    assert np.array_equal(states, states_r.numpy())


# -- RANS64 (K6): the 64-bit reciprocal of rans64.h:167-247

U64 = np.uint64
M32 = U64(0xFFFFFFFF)


def mulhi64(a, b):
    """The high 64 bits of a * b for uint64 arrays, in 32-bit limbs."""
    a, b = np.asarray(a, U64), np.asarray(b, U64)
    a_lo, a_hi, b_lo, b_hi = a & M32, a >> U64(32), b & M32, b >> U64(32)
    lh, hl = a_lo * b_hi, a_hi * b_lo
    mid = ((a_lo * b_lo) >> U64(32)) + (lh & M32) + (hl & M32)
    return a_hi * b_hi + (lh >> U64(32)) + (hl >> U64(32)) + (mid >> U64(32))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pb", [9, 14, 16, 24, 31])
def test_rans64_enc_table_matches_pack_enc_tables_recip(pb, kind):
    """K6's rows hold the six fields of the reference package's RANS64
    kernel table: rcp lo, rcp hi, bias, cmpl_freq, rcp_shift, threshold."""
    freqs, cum = synthetic_model(pb, pb + 300, kind)
    mine = host_prep.rans64_enc_table(freqs, cum, pb)
    assert mine.dtype == np.int32 and mine.shape == (256, 8)
    theirs = rans64_tpu.pack_enc_tables_recip(freqs, cum, pb).reshape(6, 256)
    assert np.array_equal(mine[:, :6].T, theirs)
    assert not mine[:, 6:].any()


def rans64_rows(fs, starts, pb):
    """rans64_enc_table's fields (u64) for any number of freqs, 256 at a
    time: (rcp, bias, cmpl_freq, rcp_shift, thr)."""
    rows = []
    for i in range(0, fs.size, 256):
        f, st = fs[i:i + 256], starts[i:i + 256]
        k = f.size
        rows.append(host_prep.rans64_enc_table(
            np.pad(f, (0, 256 - k)), np.pad(st, (0, 256 - k)),
            pb)[:k].view(np.uint32).astype(U64))
    r = np.concatenate(rows)
    return r[:, 0] | (r[:, 1] << U64(32)), r[:, 2], r[:, 3], r[:, 4], r[:, 5]


def k6_freqs():
    """Every power of two in [1, 2^31] and its neighbours, then 4096 seeded
    freqs: the frequencies of the K6 quotient test at prob_bits 31."""
    pw = np.array([1 << k for k in range(32)], np.int64)
    edge = np.unique(np.concatenate([pw - 1, pw, pw + 1]))
    edge = edge[(edge >= 1) & (edge <= 1 << 31)]
    rng = np.random.default_rng(31)
    return np.concatenate([edge, rng.integers(1, (1 << 31) + 1, 4096)])


@pytest.mark.parametrize("part", range(4))
def test_rans64_reciprocal_quotient_is_exact(part):
    """K6's step at prob_bits 31: ``mulhi64(x, rcp) >> rcp_shift`` is ``x //
    freq`` (``x - 1`` at freq 1), and ``x + bias + q * cmpl_freq`` the
    division's result, at L = 2^31, x_max - 1 (x_max = freq << 32) and 64
    seeded states below x_max; freq 1, 2^31, every power of two and its
    neighbours, and 4096 seeded freqs, a quarter each part."""
    pb, M = 31, 1 << 31
    fs = k6_freqs()[part::4]
    starts = np.random.default_rng(part).integers(0, M - fs + 1)
    rcp, bias, cmpl, shift, thr = rans64_rows(fs, starts, pb)
    f64, st = fs.astype(U64), starts.astype(U64)
    assert np.array_equal(thr, f64)  # freq << (31 - pb)
    x_max = f64 << U64(32)
    rng = np.random.default_rng(part + 100)
    states = [np.full(fs.size, 1 << 31, U64), x_max - U64(1)] + [
        (rng.random(fs.size) * x_max.astype(np.float64)).astype(U64)
        for _ in range(64)]
    for x in states:
        x = np.clip(x, U64(1), x_max - U64(1))
        q = mulhi64(x, rcp) >> shift
        want_q = np.where(f64 == 1, x - U64(1), x // f64)
        assert np.array_equal(q, want_q)
        assert np.array_equal(x + bias + q * cmpl,
                              ((x // f64) << U64(pb)) + x % f64 + st)


def emulate_k6(syms, table, n_lanes):
    """K6's step in NumPy from its table rows: the high-word renorm test,
    then the reciprocal step.  Returns (cells, states) as int64, the bits
    the kernel writes."""
    rows = table.view(np.uint32).astype(U64)
    nb, S = syms.shape
    T = S // n_lanes
    grid = syms.reshape(nb, T, n_lanes)
    x = np.full((nb, n_lanes), 1 << 31, U64)
    cells = np.zeros((nb, T, n_lanes), U64)
    for t in range(T - 1, -1, -1):
        e = rows[grid[:, t]]
        rcp = e[..., 0] | (e[..., 1] << U64(32))
        hi = x >> U64(32)
        m = hi >= e[..., 5]
        cells[:, t] = np.where(m, (U64(1) << U64(32)) | (x & M32), U64(0))
        xs = np.where(m, hi, x)
        x = xs + e[..., 2] + (mulhi64(xs, rcp) >> e[..., 4]) * e[..., 3]
    return cells.reshape(nb, S).view(np.int64), x.view(np.int64)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pb", [9, 14, 16, 24, 31])
def test_k6_step_from_its_table_matches_plain(pb, kind):
    """The arithmetic K6 runs on its table rows equals the plain version of
    K6 (the divide), cell for cell and state for state."""
    freqs, cum = synthetic_model(pb, 5 * pb, kind)
    N, T, nb = 128, 24, 2
    syms = np.random.default_rng(pb).choice(
        256, (nb, T * N), p=freqs / freqs.sum()).astype(np.uint8)
    cells, states = emulate_k6(syms, host_prep.rans64_enc_table(freqs, cum,
                                                                 pb), N)
    f, st = (torch.from_numpy(a) for a in host_prep.enc_tables(freqs, cum))
    cells_r, states_r = rans64.encode_blocks_ref(torch.from_numpy(syms), f,
                                                 st, N, pb)
    assert np.array_equal(cells, cells_r.numpy())
    assert np.array_equal(states, states_r.numpy())


# -- WORD (K2): the 64-bit reciprocal of build_word_enc_tables


def word_rows(fs, starts, pb):
    """word_enc_table's fields (u64) for any number of freqs, 256 at a
    time: (x_max - 1, rcp, bias, cmpl_freq)."""
    rows = []
    for i in range(0, fs.size, 256):
        f, st = fs[i:i + 256], starts[i:i + 256]
        k = f.size
        rows.append(host_prep.word_enc_table(
            np.pad(f, (0, 256 - k)), np.pad(st, (0, 256 - k)),
            pb)[:k].view(np.uint32).astype(U64))
    r = np.concatenate(rows)
    return (r[:, 0], r[:, 1] | (r[:, 2] << U64(32)), r[:, 3] & U64(0xFFFF),
            r[:, 3] >> U64(16))


@pytest.mark.parametrize("first", range(1, 1 << 15, 1 << 12))
def test_word_quotient_is_exact(first):
    """Every freq in [first, first + 4096) at prob_bits 15 (all of [1,
    2^15] over the parts): K2's quotient ``mulhi64(x, rcp)`` is ``x //
    freq`` (``x - 1`` at freq 1) for the states 2^32 - 1, x_max - 1 (x_max
    = freq << 17), 2^31, 2^31 +- 1, 2^16, freq and freq +- 1 and 64 seeded
    states below 2^32; where ``x < x_max``, ``x + bias + q * cmpl_freq``
    mod 2^32 is the division's result."""
    pb, M = 15, 1 << 15
    fs = np.arange(first, min(first + (1 << 12), M + 1), dtype=np.int64)
    starts = np.random.default_rng(first).integers(0, M - fs + 1)
    x_max_m1, rcp, bias, cmpl = word_rows(fs, starts, pb)
    f64, st = fs.astype(U64), starts.astype(U64)
    x_max = f64 << U64(32 - pb)
    assert np.array_equal(x_max_m1, x_max - U64(1))
    assert np.array_equal(cmpl, U64(M) - f64)
    rng = np.random.default_rng(first + 1)
    states = [np.full(fs.size, v, U64) for v in
              (U32, 1 << 31, (1 << 31) - 1, (1 << 31) + 1, 1 << 16)]
    states += [x_max - U64(1), f64 - U64(1), f64, f64 + U64(1)]
    states += [rng.integers(1, 1 << 32, fs.size).astype(U64)
               for _ in range(64)]
    for x in states:
        x = np.clip(x, U64(1), U64(U32))
        q = mulhi64(x, rcp)
        assert np.array_equal(q, np.where(f64 == 1, x - U64(1), x // f64))
        ok = x < x_max
        step = (x + bias + q * cmpl) & U64(U32)
        want = ((x // f64) << U64(pb)) + x % f64 + st
        assert np.array_equal(step[ok], want[ok])


def emulate_k2(syms, table, n_lanes):
    """K2's step in NumPy from its table rows: renorm on x > x_max - 1,
    then the reciprocal step.  Returns (cells, states) as int32, the bits
    the kernel writes."""
    rows = table.view(np.uint32).astype(U64)
    nb, S = syms.shape
    T = S // n_lanes
    grid = syms.reshape(nb, T, n_lanes)
    x = np.full((nb, n_lanes), 1 << 16, U64)
    cells = np.zeros((nb, T, n_lanes), U64)
    for t in range(T - 1, -1, -1):
        e = rows[grid[:, t]]
        m = x > e[..., 0]
        cells[:, t] = np.where(m, (x & U64(0xFFFF)) | U64(0x10000), U64(0))
        xs = np.where(m, x >> U64(16), x)
        q = mulhi64(xs, e[..., 1] | (e[..., 2] << U64(32)))
        x = (xs + (e[..., 3] & U64(0xFFFF)) + q * (e[..., 3] >> U64(16))) \
            & U64(U32)
    return (cells.reshape(nb, S).astype(np.uint32).view(np.int32),
            x.astype(np.uint32).view(np.int32))


def dominant_syms(nb, T, N, seed):
    """One symbol of freq 2^15 - 3 and three of freq 1 (at prob_bits 15),
    the rare ones in the last step (coded first) of a few lanes: those
    lanes' states then stay above 2^31 while the dominant symbol is
    coded."""
    freqs = np.zeros(256, np.int64)
    freqs[[0x20, 0x61, 0xF0]] = 1
    freqs[0x41] = (1 << 15) - 3
    syms = np.full((nb, T, N), 0x41, np.uint8)
    lanes = np.random.default_rng(seed).choice(N, 24, replace=False)
    syms[:, -1, lanes] = np.resize(np.array([0x20, 0x61, 0xF0], np.uint8),
                                   24)
    cum = np.concatenate([[0], np.cumsum(freqs)]).astype(np.int64)
    return freqs, cum, syms.reshape(nb, T * N)


@pytest.mark.parametrize("pb,kind", [(pb, kind) for pb in (9, 12, 15)
                                     for kind in KINDS] + [(15, "dominant")])
def test_k2_step_from_its_table_matches_plain(pb, kind):
    """The arithmetic K2 runs on its table rows equals the plain version of
    K2 (the divide), cell for cell and state for state; the dominant model
    (prob_bits 15) drives states past 2^31."""
    N, T, nb = 128, 24, 2
    if kind == "dominant":
        freqs, cum, syms = dominant_syms(nb, T, N, pb)
    else:
        freqs, cum = synthetic_model(pb, 3 * pb, kind)
        syms = np.random.default_rng(pb).choice(
            256, (nb, T * N), p=freqs / freqs.sum()).astype(np.uint8)
    cells, states = emulate_k2(syms, host_prep.word_enc_table(freqs, cum,
                                                               pb), N)
    f, st = (torch.from_numpy(a) for a in host_prep.enc_tables(freqs, cum))
    cells_r, states_r = word.encode_blocks_ref(torch.from_numpy(syms), f,
                                               st, N, pb)
    assert np.array_equal(cells, cells_r.numpy())
    assert np.array_equal(states, states_r.numpy())
    if kind == "dominant":
        assert (states.view(np.uint32) > 1 << 31).sum() >= 24
