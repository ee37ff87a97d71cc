"""The port's division-free encoder tables
(``ryg_rans_tpu_torch.models.tables``) against the reference package's
(``ryg_rans_tpu.models.tables``), field for field; the reciprocal quotient against ``x // freq`` for every frequency at
prob_bits 16; and the BYTE/ALIAS encode step as K4 (``csrc/byte_encode.cu``)
computes it from ``host_prep.byte_enc_table``, in NumPy, against the plain
version of K4.  Exact equality throughout."""

import numpy as np
import pytest
import torch

from ryg_rans_tpu.models import tables as ref_tables
from ryg_rans_tpu_torch.models import tables
from ryg_rans_tpu_torch.ops import byte, host_prep

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
