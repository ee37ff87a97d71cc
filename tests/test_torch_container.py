"""ryg_rans_tpu_torch's TRNS container against the reference package's:
byte-identical packing, cross unpacking and the typed errors, on synthetic
payloads."""

import io
import zlib

import numpy as np
import pytest

from _torch_corpora import skewed
from ryg_rans_tpu.config import RansConfig as JConfig
from ryg_rans_tpu.config import Variant as JVariant
from ryg_rans_tpu.models import stats as jstats
from ryg_rans_tpu.utils import container as jcont
from ryg_rans_tpu_torch.config import RansConfig as TConfig
from ryg_rans_tpu_torch.config import Variant as TVariant
from ryg_rans_tpu_torch.utils import container as tcont

WORD_DT = {0: np.uint8, 1: np.uint16, 2: np.uint32, 3: np.uint8}


def _configs(variant=1, prob_bits=12, n_lanes=512, lanes_per_stream=None,
             block_symbols=1 << 13, checksum=True):
    kw = dict(prob_bits=prob_bits, n_lanes=n_lanes,
              lanes_per_stream=lanes_per_stream, block_symbols=block_symbols,
              checksum=checksum)
    return (JConfig(variant=JVariant(variant), **kw),
            TConfig(variant=TVariant(variant), **kw))


def _contents(cfg, orig_len, seed, one_symbol=False, raw_block=None):
    """A model and per-block, per-substream payloads of random words."""
    rng = np.random.default_rng(seed)
    if one_symbol:
        freqs, _ = jstats.build_model(np.full(100, 7, np.uint8),
                                      cfg.prob_bits)
    else:
        freqs, _ = jstats.build_model(skewed(4000, seed), cfg.prob_bits)
    step = 4 * cfg.n_lanes
    n_blocks = -(-(-(-orig_len // step) * step) // cfg.block_symbols)
    dt = WORD_DT[int(cfg.variant)]
    payloads = [[rng.integers(0, np.iinfo(dt).max, int(rng.integers(0, 90)),
                              dtype=dt) for _ in range(cfg.n_streams)]
                for _ in range(n_blocks)]
    raw = None
    if raw_block is not None:
        raw = np.zeros(n_blocks, bool)
        raw[raw_block] = True
        payloads[raw_block] = [rng.integers(0, 256, 50, dtype=np.uint8)]
    crcs = (rng.integers(0, 1 << 32, n_blocks, dtype=np.uint32)
            if cfg.checksum else None)
    return freqs, payloads, crcs, raw


CASES = [
    dict(),
    dict(checksum=False),
    dict(variant=0, prob_bits=14),
    dict(variant=2, prob_bits=20, checksum=False),
    dict(variant=3, prob_bits=16),
    dict(lanes_per_stream=128),
    dict(prob_bits=15, n_lanes=16384, block_symbols=1 << 16),
]


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("raw_block", [None, 1])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_pack_is_byte_identical(case, raw_block, version):
    jc, tc = _configs(**CASES[case])
    orig_len = 3 * jc.block_symbols - 5
    freqs, payloads, crcs, raw = _contents(jc, orig_len, case,
                                           raw_block=raw_block)
    jblob = jcont.pack(jc, orig_len, freqs, payloads, crcs, raw, version)
    tblob = tcont.pack(tc, orig_len, freqs, payloads, crcs, raw, version)
    assert tblob == jblob
    counts = np.array([[s.size for s in blk] + [0] * (jc.n_streams - len(blk))
                       for blk in payloads], np.uint32)
    assert tcont.pack_header(tc, orig_len, freqs, counts, crcs, raw,
                             version) == jcont.pack_header(
        jc, orig_len, freqs, counts, crcs, raw, version)


def _same_container(a, b):
    assert a.orig_len == b.orig_len
    assert (int(a.cfg.variant), a.cfg.prob_bits, a.cfg.n_lanes,
            a.cfg.lanes_per_stream, a.cfg.block_symbols, a.cfg.checksum) == (
        int(b.cfg.variant), b.cfg.prob_bits, b.cfg.n_lanes,
        b.cfg.lanes_per_stream, b.cfg.block_symbols, b.cfg.checksum)
    assert np.array_equal(a.freqs, b.freqs)
    assert np.array_equal(a.stream_words, b.stream_words)
    assert (a.crcs is None) == (b.crcs is None)
    if a.crcs is not None:
        assert np.array_equal(a.crcs, b.crcs)
    assert (a.raw is None) == (b.raw is None)
    if a.raw is not None:
        assert np.array_equal(a.raw, b.raw)
    assert a.block_sizes() == b.block_sizes()
    for pa, pb in zip(a.payloads, b.payloads, strict=True):
        for sa, sb in zip(pa, pb, strict=True):
            assert sa.dtype == sb.dtype and np.array_equal(sa, sb)


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("one_symbol", [False, True])
@pytest.mark.parametrize("case", [0, 2, 5])
def test_each_side_unpacks_the_other(case, one_symbol, version):
    jc, tc = _configs(**CASES[case])
    orig_len = 2 * jc.block_symbols + 17
    freqs, payloads, crcs, raw = _contents(jc, orig_len, case, one_symbol,
                                           raw_block=0)
    jblob = jcont.pack(jc, orig_len, freqs, payloads, crcs, raw, version)
    tblob = tcont.pack(tc, orig_len, freqs, payloads, crcs, raw, version)
    _same_container(tcont.unpack(jblob), jcont.unpack(jblob))
    _same_container(jcont.unpack(tblob), tcont.unpack(tblob))
    tmeta, toff = tcont.read_header(io.BytesIO(jblob))
    jmeta, joff = jcont.read_header(io.BytesIO(jblob))
    assert toff == joff
    assert np.array_equal(tmeta.freqs, jmeta.freqs)
    assert np.array_equal(tmeta.stream_words, jmeta.stream_words)
    if one_symbol:
        assert int(tmeta.freqs.max()) == 1 << jc.prob_bits


def test_empty_container_alike():
    jc, tc = _configs()
    z = np.zeros(256, np.uint32)
    blob = tcont.pack(tc, 0, z, [], None)
    assert blob == jcont.pack(jc, 0, z, [], None)
    c = tcont.unpack(blob)
    assert c.orig_len == 0 and c.payloads == [] and c.block_sizes() == []


@pytest.mark.parametrize("version", [1, 2])
def test_truncation_anywhere_is_typed_error(version):
    """Every prefix of a container raises ValueError, in unpack and, inside
    the metadata, in read_header.  (The reference's unpack raises
    IndexError for a prefix that ends inside the raw bitmap; the port's
    raises ValueError there too.)"""
    jc, tc = _configs(lanes_per_stream=256)
    orig_len = 2 * tc.block_symbols + 99
    freqs, payloads, crcs, raw = _contents(jc, orig_len, 3, raw_block=1)
    blob = tcont.pack(tc, orig_len, freqs, payloads, crcs, raw, version)
    meta_end = len(blob) - sum(s.nbytes for blk in payloads for s in blk)
    for cut in range(len(blob)):
        with pytest.raises(ValueError):
            tcont.unpack(blob[:cut])
        if cut < meta_end:
            with pytest.raises(ValueError):
                tcont.read_header(io.BytesIO(blob[:cut]))


@pytest.mark.parametrize("offset,value,match", [
    (0, 0x58, "TRNS"),          # magic
    (4, 9, "version"),          # version
    (5, 7, None),               # variant id
    (6, 17, "prob_bits"),       # prob_bits above WORD's maximum
    (6, 7, "prob_bits"),        # prob_bits below the alphabet
    (7, 20, "block_symbols"),   # 2^20 lanes > block_symbols
    (8, 3, None),               # lanes_per_stream 8: count rows misparse
])
def test_header_corruption_is_typed_error(offset, value, match):
    jc, tc = _configs()
    orig_len = 2 * tc.block_symbols
    freqs, payloads, crcs, raw = _contents(jc, orig_len, 5)
    blob = bytearray(tcont.pack(tc, orig_len, freqs, payloads, crcs))
    blob[offset] = value
    for mod in (tcont, jcont):
        with pytest.raises(ValueError, match=match):
            mod.unpack(bytes(blob))


def test_overlong_varint_counts_rejected():
    for bad in (b"\xff\xff\xff\xff\xff\x01", b"\xff\xff\xff\xff\x7f"):
        with pytest.raises(ValueError, match="corrupt in counts"):
            tcont._read_varints_mv(memoryview(bad), 0, 1)
        with pytest.raises(ValueError, match="corrupt in counts"):
            tcont._read_varints_file(io.BytesIO(bad), 1)
    ok = b"\xff\xff\xff\xff\x0f"
    vals, off = tcont._read_varints_mv(memoryview(ok), 0, 1)
    assert vals[0] == 0xFFFFFFFF and off == 5
    assert tcont._read_varints_file(io.BytesIO(ok), 1)[0] == 0xFFFFFFFF


def test_crc32_and_word_dtypes_alike():
    data = skewed(10_000, seed=9)
    assert tcont.crc32(data) == jcont.crc32(data)
    for v in JVariant:
        assert tcont.word_dtype(TVariant(int(v))) == jcont.word_dtype(v)


def _relaid(payloads, layout):
    """The same payload values in another memory layout: strided
    (non-contiguous), a wider dtype (``pack`` casts them back), or views
    into one larger array."""
    if layout == "strided":
        out = []
        for blk in payloads:
            row = []
            for s in blk:
                wide = np.zeros(2 * s.size, s.dtype)
                wide[::2] = s
                row.append(wide[::2])
            out.append(row)
        return out
    if layout == "wider":
        return [[s.astype(np.int64) for s in blk] for blk in payloads]
    out = []  # "views": a block's substreams, slices of one array
    for blk in payloads:
        big = np.concatenate([np.zeros(1, blk[0].dtype)] + blk)
        ends = 1 + np.cumsum([s.size for s in blk])
        out.append([big[e - s.size:e] for s, e in zip(blk, ends)])
    return out


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("raw_block", [None, 1])
@pytest.mark.parametrize("layout", ["strided", "wider", "views"])
@pytest.mark.parametrize("case", [0, 2, 3, 4])
def test_pack_is_byte_identical_for_any_layout(case, layout, raw_block,
                                               version):
    """``pack`` joins the payload arrays without an intermediate copy; the
    bytes stay the reference's for payloads that are non-contiguous, of a
    wider dtype, or views into a larger array."""
    jc, tc = _configs(**CASES[case])
    orig_len = 3 * jc.block_symbols - 5
    freqs, payloads, crcs, raw = _contents(jc, orig_len, case,
                                           raw_block=raw_block)
    relaid = _relaid(payloads, layout)
    jblob = jcont.pack(jc, orig_len, freqs, payloads, crcs, raw, version)
    assert tcont.pack(tc, orig_len, freqs, relaid, crcs, raw,
                      version) == jblob


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("case", [0, 2, 3, 4, 5])
def test_unpack_payloads_are_views_of_the_blob(case, version):
    """``unpack`` hands out views of the blob, equal to the reference's
    copies: read-only for a ``bytes`` blob, writable (and aliasing it) for
    a ``bytearray`` one."""
    jc, tc = _configs(**CASES[case])
    orig_len = 2 * jc.block_symbols + 17
    freqs, payloads, crcs, raw = _contents(jc, orig_len, case, raw_block=0)
    blob = tcont.pack(tc, orig_len, freqs, payloads, crcs, raw, version)
    c = tcont.unpack(blob)
    _same_container(c, jcont.unpack(blob))
    whole = np.frombuffer(blob, np.uint8)
    held = [s for blk in c.payloads for s in blk if s.size]
    assert held
    for s in held:
        assert np.shares_memory(s, whole)
        assert not s.flags.writeable
        with pytest.raises(ValueError):
            s[0] = 1
    mutable = bytearray(blob)
    s = next(s for blk in tcont.unpack(mutable).payloads for s in blk
             if s.size)
    at = s.ctypes.data - np.frombuffer(mutable, np.uint8).ctypes.data
    before = s[0]
    mutable[at] ^= 0xFF
    assert s[0] != before


CRC_INPUTS = {
    "empty": lambda rng: np.zeros(0, np.uint8),
    "odd_offset": lambda rng: rng.integers(0, 256, 10_001, np.uint8)[3:9_998],
    "odd_offset_1": lambda rng: rng.integers(0, 256, 4097, np.uint8)[1:],
    "strided": lambda rng: rng.integers(0, 256, 30_000, np.uint8)[::3],
    "column": lambda rng: rng.integers(0, 256, (500, 7), np.uint8)[:, 2],
    "2d": lambda rng: rng.integers(0, 256, (64, 33), np.uint8),
    "one_byte": lambda rng: rng.integers(0, 256, 1, np.uint8),
}


@pytest.mark.parametrize("name", sorted(CRC_INPUTS))
def test_crc32_reads_any_layout(name):
    """``crc32`` reads its array in place and agrees with the CRC of its
    bytes, and with the reference's, whatever the layout."""
    arr = CRC_INPUTS[name](np.random.default_rng(len(name)))
    want = zlib.crc32(arr.tobytes())
    assert tcont.crc32(arr) == want == jcont.crc32(arr)
