"""ryg_rans_tpu_torch.ops.word: the plain K1/K2 versions through the
encode/decode loop of ryg_rans_tpu_torch.ops.codec, against the reference
package's Pallas WORD kernels (interpret mode) and its NumPy oracle, by
exact equality; and the codec's per-variant records."""

import hashlib

import numpy as np
import pytest
import torch

from _torch_corpora import CORPORA
from ryg_rans_tpu.config import RansConfig as JConfig
from ryg_rans_tpu.config import Variant as JVariant
from ryg_rans_tpu.models import stats as jstats
from ryg_rans_tpu.ops import reference_numpy as oracle
from ryg_rans_tpu.ops import word_tpu
from ryg_rans_tpu_torch.config import RansConfig, Variant
from ryg_rans_tpu_torch.ops import byte, codec, host_prep, rans64, word
from ryg_rans_tpu_torch.utils.container import word_dtype

# (prob_bits, n_lanes, block_symbols, input bytes, corpus): every input
# spans two full blocks and a tail block.
CASES = [
    (9, 128, 1 << 13, 20_000, "skewed"),
    (10, 256, 1 << 13, 20_000, "random"),
    (11, 512, 1 << 14, 40_000, "skewed"),
    (12, 1024, 1 << 14, 40_000, "sparse"),
    (13, 128, 1 << 13, 20_000, "skewed"),
    (14, 256, 1 << 13, 20_000, "sparse"),
    (15, 512, 1 << 14, 40_000, "skewed"),
    # freq == 2^15 == M: the encode threshold freq << 17 needs 33 bits
    (15, 128, 1 << 12, 9_000, "one_symbol"),
]
IDS = [f"pb{c[0]}-N{c[1]}-{c[4]}" for c in CASES]


def _setup(case):
    pb, N, B, size, corpus = case
    cfg = RansConfig(prob_bits=pb, n_lanes=N, block_symbols=B)
    jcfg = JConfig(variant=JVariant.WORD, prob_bits=pb, n_lanes=N,
                   block_symbols=B)
    data = CORPORA[corpus](size, seed=pb)
    freqs, cum = jstats.build_model(data, pb)
    return cfg, jcfg, data, freqs, cum


def _port_encode(cfg, data, freqs, cum):
    padded = codec.pad_block(torch.from_numpy(data), cfg.n_lanes, freqs)
    return codec.encode(cfg, padded, freqs, cum), padded


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_encode_matches_pallas_and_oracle(case):
    cfg, jcfg, data, freqs, cum = _setup(case)
    blocks, padded = _port_encode(cfg, data, freqs, cum)
    jblocks, jpadded = word_tpu.encode(jcfg, data, freqs, cum,
                                       interpret=True)
    assert padded.numel() == jpadded
    assert len(blocks) == len(jblocks) == 3
    B = cfg.block_symbols
    padded_np = padded.numpy()
    for b, (mine, theirs) in enumerate(zip(blocks, jblocks)):
        assert mine.dtype == np.uint16
        assert np.array_equal(mine, theirs)
        ref = oracle.encode(jcfg, padded_np[b * B:(b + 1) * B], freqs, cum)
        assert np.array_equal(mine, ref[0])
    # the port decodes its own blocks back to the padded input
    sizes = codec.block_sizes(B, padded.numel())
    dec = codec.decode(cfg, blocks, sizes, freqs, cum, "cpu")
    assert torch.equal(dec, padded)


@pytest.mark.parametrize("pb", [9, 12, 15])
def test_decode_reads_oracle_stream(pb):
    """Format interop: the plain decoder consumes an oracle-encoded
    block."""
    N, B = 256, 1 << 12
    jcfg = JConfig(variant=JVariant.WORD, prob_bits=pb, n_lanes=N,
                   block_symbols=B)
    data = CORPORA["skewed"](B, seed=40 + pb)
    freqs, cum = jstats.build_model(data, pb)
    stream = oracle.encode(jcfg, data, freqs, cum)[0]
    cfg = RansConfig(prob_bits=pb, n_lanes=N, block_symbols=B)
    dec = codec.decode(cfg, [stream], [B], freqs, cum, "cpu")
    assert np.array_equal(dec.numpy(), data)


def test_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the wrappers return their plain versions' results and
    count no kernel launch."""
    pb, N = 12, 256
    data = CORPORA["skewed"](3 * 4 * N * 4, seed=1)
    freqs, cum = jstats.build_model(data, pb)
    f, st = (torch.from_numpy(a) for a in host_prep.enc_tables(freqs, cum))
    syms = torch.from_numpy(data).view(3, -1)
    word.encode_blocks.launches = word.decode_blocks.launches = 0
    cells, states = word.encode_blocks(syms, f, st, N, pb)
    cells_r, states_r = word.encode_blocks_ref(syms, f, st, N, pb)
    assert torch.equal(cells, cells_r) and torch.equal(states, states_r)
    assert cells.dtype == torch.int32 and states.dtype == torch.int32

    heads, body, counts = codec.compact_words(cells, states)
    blocks = []
    hn, bn = heads.numpy().view(np.uint16), body.numpy().view(np.uint16)
    ends = np.cumsum(counts.numpy())
    for b in range(3):
        blocks.append(np.concatenate([hn[b], bn[ends[b] - counts[b]:ends[b]]]))
    c2s, fd, cd = (torch.from_numpy(a)
                   for a in host_prep.dec_tables(freqs, cum, pb))
    stream = codec.CODECS[Variant.WORD].prep_decode(blocks, N, "cpu")
    out = word.decode_blocks(*stream, c2s, fd, cd, syms.shape[1], pb)
    assert torch.equal(out, word.decode_blocks_ref(*stream, c2s, fd, cd,
                                                   syms.shape[1], pb))
    assert torch.equal(out, syms)
    assert word.encode_blocks.launches == word.decode_blocks.launches == 0


def test_compaction_keeps_stream_order():
    """Cells are kept in [block, step, lane] order and heads are the final
    states lane-ascending as (lo, hi) u16."""
    cells = torch.tensor([[0, 0x10005, 0, 0x1FFFF, 0x10001, 0, 0, 0],
                          [0x10002, 0, 0, 0, 0, 0, 0, 0x10003]],
                         dtype=torch.int32)
    states = torch.tensor([[0x00020001, -1], [0x7FFF8000, 0x10000]],
                          dtype=torch.int32)
    heads, body, counts = codec.compact_words(cells, states)
    assert body.numpy().view(np.uint16).tolist() == [5, 0xFFFF, 1, 2, 3]
    assert counts.tolist() == [3, 2]
    assert heads.numpy().view(np.uint16).tolist() == [
        [1, 2, 0xFFFF, 0xFFFF], [0x8000, 0x7FFF, 0, 1]]


def test_pad_block_uses_first_argmax():
    freqs = np.zeros(256, np.uint32)
    freqs[[3, 9]] = 100
    t = torch.arange(10, dtype=torch.uint8)
    out = codec.pad_block(t, 128, freqs)
    assert out.numel() == 512 and torch.equal(out[:10], t)
    assert bool((out[10:] == 3).all())
    full = torch.zeros(1024, dtype=torch.uint8)
    assert codec.pad_block(full, 128, freqs) is full


def test_groups_bound_symbols_per_launch(monkeypatch):
    monkeypatch.setattr(codec, "GROUP_BYTES", 3 * 1024 * 4)
    cap = codec.CODECS[Variant.WORD].group_symbols
    assert cap == 3 * 1024
    sizes = [1024] * 7 + [512]
    assert list(codec.groups(sizes, cap)) == [(0, 3, 1024), (3, 3, 1024),
                                              (6, 1, 1024), (7, 1, 512)]
    assert list(codec.groups([8192, 4096], cap)) == [(0, 1, 8192),
                                                     (1, 1, 4096)]
    assert list(codec.groups([], cap)) == []


def test_grouped_encode_equals_one_launch(monkeypatch):
    """Coding blocks in several launch groups writes the same words."""
    cfg = RansConfig(prob_bits=12, n_lanes=128, block_symbols=1 << 11)
    data = CORPORA["skewed"](5 * (1 << 11) + 300, seed=7)
    freqs, cum = jstats.build_model(data, 12)
    whole, padded = _port_encode(cfg, data, freqs, cum)
    monkeypatch.setattr(codec, "GROUP_BYTES", (2 << 11) * 4)
    parts = codec.encode(cfg, padded, freqs, cum)
    assert all(np.array_equal(a, b) for a, b in zip(whole, parts,
                                                    strict=True))
    sizes = codec.block_sizes(cfg.block_symbols, padded.numel())
    assert torch.equal(codec.decode(cfg, parts, sizes, freqs, cum, "cpu"),
                       padded)


def test_truncated_body_decodes_without_fault():
    """Reads clamp to the block's words: a cut or empty body decodes to
    wrong symbols, never out of bounds."""
    cfg = RansConfig(prob_bits=12, n_lanes=128, block_symbols=1 << 12)
    data = CORPORA["skewed"](1 << 12, seed=2)
    freqs, cum = jstats.build_model(data, 12)
    blocks, _ = _port_encode(cfg, data, freqs, cum)
    for cut in (blocks[0].size - 1, 2 * 128):
        out = codec.decode(cfg, [blocks[0][:cut]], [1 << 12], freqs, cum,
                           "cpu")
        assert out.shape == (1 << 12,)
    with pytest.raises(ValueError, match="corrupt"):
        codec.decode(cfg, [blocks[0][:100]], [1 << 12], freqs, cum, "cpu")


@pytest.mark.parametrize("kwargs", [
    dict(variant=Variant.BYTE, prob_bits=8),
    dict(variant=Variant.ALIAS, n_lanes=64, block_symbols=1 << 12),
    dict(variant=Variant.RANS64, n_lanes=1024, lanes_per_stream=256),
    dict(prob_bits=16),
    dict(prob_bits=8),
    dict(n_lanes=64, block_symbols=1 << 12),
    dict(n_lanes=1024, lanes_per_stream=256),
    dict(n_lanes=1024, block_symbols=1024 * 6),
    dict(n_lanes=32768, block_symbols=1 << 17),
])
def test_configs_outside_the_slice_raise(kwargs):
    """Each variant's record refuses the shapes no kernel takes, naming the
    host backends that code them."""
    cfg = RansConfig(**kwargs)
    with pytest.raises(NotImplementedError,
                       match='backend="native" or backend="numpy"'):
        codec.codec_of(cfg)


@pytest.mark.parametrize("variant,ops,max_pb,cap,head", [
    (Variant.WORD, word, 15, 1 << 28, 2),
    (Variant.BYTE, byte, 16, 1 << 28, 4),
    (Variant.ALIAS, byte, 16, 1 << 28, 4),
    (Variant.RANS64, rans64, 31, 1 << 27, 2)],
    ids=["WORD", "BYTE", "ALIAS", "RANS64"])
def test_codec_of_each_variant(variant, ops, max_pb, cap, head):
    """``codec_of`` gives the variant's record: its wrappers' module, a
    group cap of 1 GiB of dense cells, head words a lane whose bytes are
    a lane state's, the container's word type, and its highest
    prob_bits; one more raises."""
    cfg = RansConfig(variant=variant, prob_bits=max_pb, n_lanes=128)
    rec = codec.codec_of(cfg)
    assert rec is codec.CODECS[variant] and rec.variant == variant
    assert rec.ops is ops and rec.max_prob_bits == max_pb
    assert rec.group_symbols == cap == codec.GROUP_BYTES // rec.cell_bytes
    assert rec.head_words == head
    assert rec.word_dtype == word_dtype(variant)
    assert head * np.dtype(rec.word_dtype).itemsize == \
        rec.state_dtype.itemsize
    # RansConfig refuses BYTE's, ALIAS's and RANS64's next prob_bits
    # itself, so the field is set past that check to reach the record's
    over = RansConfig(variant=variant, prob_bits=max_pb, n_lanes=128)
    object.__setattr__(over, "prob_bits", max_pb + 1)
    with pytest.raises(NotImplementedError, match=f"9-{max_pb}"):
        codec.codec_of(over)


#: sha256 (first 16 hex digits) of the heads and body that the per-variant
#: compactions of ``ops.word`` and ``ops.rans64`` gave before they became
#: ``codec.compact_words``, with their dtypes, shapes and counts, on the
#: plain encoders' cells of the input below.
COMPACTED = {
    Variant.WORD: (12, torch.int16, 3326, [1100, 1116, 1110],
                   "c7f070f597506b43", "5c0fd9196f826bb8"),
    Variant.RANS64: (20, torch.int32, 1500, [499, 507, 494],
                     "3d04b2e3952d66e8", "e184f5e2231f40ed"),
}


@pytest.mark.parametrize("variant", list(COMPACTED),
                         ids=lambda v: v.name)
def test_shared_compaction_matches_the_per_variant_ones(variant):
    """WORD's and RANS64's one compaction gives the heads, body and counts
    the two per-variant functions gave, byte for byte."""
    pb, dtype, total, counts_want, heads_sha, body_sha = COMPACTED[variant]
    N = 256
    data = CORPORA["skewed"](3 * 4 * N * 4, seed=1)
    freqs, cum = jstats.build_model(data, pb)
    f, st = (torch.from_numpy(a) for a in host_prep.enc_tables(freqs, cum))
    ops = codec.CODECS[variant].ops
    cells, states = ops.encode_blocks_ref(torch.from_numpy(data).view(3, -1),
                                          f, st, N, pb)
    heads, body, counts = codec.compact_words(cells, states)

    def sha(t):
        return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]
    assert heads.dtype == body.dtype == dtype and counts.dtype == torch.int64
    assert heads.shape == (3, 2 * N) and body.shape == (total,)
    assert counts.tolist() == counts_want
    assert (sha(heads), sha(body)) == (heads_sha, body_sha)
