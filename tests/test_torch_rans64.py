"""ryg_rans_tpu_torch.ops.rans64: the plain K5/K6 versions through the
encode/decode loop of ryg_rans_tpu_torch.ops.codec, against the reference
package's NumPy oracle per block and its Pallas RANS64 encoder (interpret
mode), by exact equality, over prob_bits 9-31: the cum2sym path up to 16,
the binary search above, and the one-symbol model whose encode threshold
is 2^63."""

import numpy as np
import pytest
import torch

from _torch_corpora import CORPORA
from ryg_rans_tpu.config import RansConfig as JConfig
from ryg_rans_tpu.config import Variant as JVariant
from ryg_rans_tpu.models import stats as jstats
from ryg_rans_tpu.ops import rans64_tpu
from ryg_rans_tpu.ops import reference_numpy as oracle
from ryg_rans_tpu_torch.config import RansConfig, Variant
from ryg_rans_tpu_torch.ops import codec, host_prep, rans64

# (prob_bits, n_lanes, block_symbols, input bytes, corpus, seed): every
# input spans two full blocks and a tail block.
CASES = [
    (9, 128, 1 << 12, 9_000, "skewed", 1),
    (14, 256, 1 << 13, 20_000, "sparse", 2),
    (16, 512, 1 << 13, 20_000, "skewed", 3),
    (17, 128, 1 << 12, 9_000, "random", 4),
    (24, 256, 1 << 13, 20_000, "skewed", 5),
    (31, 512, 1 << 13, 20_000, "skewed", 6),
    # freq == 2^31 == M: the encode threshold freq << 32 is 2^63
    (31, 128, 1 << 12, 9_000, "one_symbol", 0),
]
IDS = [f"pb{c[0]}-N{c[1]}-{c[4]}" for c in CASES]
#: the cases that also run the reference's Pallas kernels in interpret mode
PALLAS = [1, 4, 6]


def setup(case):
    pb, N, Bs, size, corpus, seed = case
    cfg = RansConfig(variant=Variant.RANS64, prob_bits=pb, n_lanes=N,
                     block_symbols=Bs)
    jcfg = JConfig(variant=JVariant.RANS64, prob_bits=pb, n_lanes=N,
                   block_symbols=Bs)
    data = CORPORA[corpus](size, seed=seed)
    freqs, cum = jstats.build_model(data, pb)
    return cfg, jcfg, data, freqs, cum


def port_encode(cfg, data, freqs, cum):
    padded = codec.pad_block(torch.from_numpy(data), cfg.n_lanes, freqs)
    return codec.encode(cfg, padded, freqs, cum), padded


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_encode_matches_oracle(case):
    cfg, jcfg, data, freqs, cum = setup(case)
    blocks, padded = port_encode(cfg, data, freqs, cum)
    assert len(blocks) == 3
    Bs = cfg.block_symbols
    padded_np = padded.numpy()
    for b, mine in enumerate(blocks):
        assert mine.dtype == np.uint32
        ref = oracle.encode(jcfg, padded_np[b * Bs:(b + 1) * Bs], freqs, cum)
        assert np.array_equal(mine, ref[0])
    sizes = codec.block_sizes(Bs, padded.numel())
    dec = codec.decode(cfg, blocks, sizes, freqs, cum, "cpu")
    assert torch.equal(dec, padded)


@pytest.mark.parametrize("case", [CASES[i] for i in PALLAS],
                         ids=[IDS[i] for i in PALLAS])
def test_encode_matches_pallas(case):
    cfg, jcfg, data, freqs, cum = setup(case)
    blocks, padded = port_encode(cfg, data, freqs, cum)
    jblocks, jpadded = rans64_tpu.encode(jcfg, data, freqs, cum,
                                         interpret=True)
    assert padded.numel() == jpadded and len(blocks) == len(jblocks)
    for mine, theirs in zip(blocks, jblocks):
        assert np.array_equal(mine, theirs)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_decode_reads_oracle_stream(case):
    """Format interop: the plain decoder consumes oracle-encoded blocks."""
    cfg, jcfg, data, freqs, cum = setup(case)
    padded = codec.pad_block(torch.from_numpy(data), cfg.n_lanes,
                             freqs).numpy()
    Bs = cfg.block_symbols
    sizes = codec.block_sizes(Bs, padded.size)
    streams = [oracle.encode(jcfg, padded[b * Bs:b * Bs + s], freqs, cum)[0]
               for b, s in enumerate(sizes)]
    dec = codec.decode(cfg, streams, sizes, freqs, cum, "cpu")
    assert np.array_equal(dec.numpy(), padded)


@pytest.mark.parametrize("pb", [12, 20])
def test_wrappers_take_the_plain_version_on_cpu(pb):
    """On CPU tensors the wrappers return their plain versions' results and
    count no kernel launch."""
    N = 256
    data = CORPORA["skewed"](3 * 4 * N * 4, seed=1)
    freqs, cum = jstats.build_model(data, pb)
    f, st = (torch.from_numpy(a) for a in host_prep.enc_tables(freqs, cum))
    syms = torch.from_numpy(data).view(3, -1)
    rans64.encode_blocks.launches = rans64.decode_blocks.launches = 0
    cells, states = rans64.encode_blocks(syms, f, st, N, pb)
    cells_r, states_r = rans64.encode_blocks_ref(syms, f, st, N, pb)
    assert torch.equal(cells, cells_r) and torch.equal(states, states_r)
    assert cells.dtype == torch.int64 and states.dtype == torch.int64

    heads, body, counts = codec.compact_words(cells, states)
    blocks = codec.assemble_blocks(heads.numpy().view(np.uint32),
                                   body.numpy().view(np.uint32),
                                   counts.numpy())
    cfg = RansConfig(variant=Variant.RANS64, prob_bits=pb, n_lanes=N)
    rec = codec.codec_of(cfg)
    tables = rec.dec_tables(freqs, cum, pb, "cpu")
    assert (tables[0] is None) == (pb > 16)
    stream = rec.prep_decode(blocks, N, "cpu")
    out = rans64.decode_blocks(*stream, *tables, syms.shape[1], pb)
    assert torch.equal(out, rans64.decode_blocks_ref(
        *stream, *tables, syms.shape[1], pb))
    assert torch.equal(out, syms)
    assert rans64.encode_blocks.launches == rans64.decode_blocks.launches == 0


def test_compaction_keeps_stream_order():
    """Cells are kept in [block, step, lane] order and heads are the final
    states lane-ascending as (lo, hi) u32 words."""
    one = 1 << 32
    cells = torch.tensor([[0, one | 5, 0, one | 0xFFFFFFFF],
                          [one, 0, 0, one | 7]], dtype=torch.int64)
    states = torch.tensor([[0x0000000200000001, 0x7FFFFFFF80000000],
                           [1 << 31, 3]], dtype=torch.int64)
    heads, body, counts = codec.compact_words(cells, states)
    assert body.numpy().view(np.uint32).tolist() == [5, 0xFFFFFFFF, 0, 7]
    assert counts.tolist() == [2, 2]
    assert heads.numpy().view(np.uint32).tolist() == [
        [1, 2, 0x80000000, 0x7FFFFFFF], [0x80000000, 0, 3, 0]]


def test_grouped_encode_equals_one_launch(monkeypatch):
    """Coding blocks in several launch groups writes the same words."""
    cfg = RansConfig(variant=Variant.RANS64, prob_bits=20, n_lanes=128,
                     block_symbols=1 << 11)
    data = CORPORA["skewed"](5 * (1 << 11) + 300, seed=7)
    freqs, cum = jstats.build_model(data, 20)
    whole, padded = port_encode(cfg, data, freqs, cum)
    monkeypatch.setattr(codec, "GROUP_BYTES", (2 << 11) * 8)
    parts = codec.encode(cfg, padded, freqs, cum)
    assert all(np.array_equal(a, b) for a, b in zip(whole, parts,
                                                    strict=True))
    sizes = codec.block_sizes(cfg.block_symbols, padded.numel())
    assert torch.equal(codec.decode(cfg, parts, sizes, freqs, cum, "cpu"),
                       padded)


def test_truncated_body_decodes_without_fault():
    """Reads clamp to the block's words: a cut or empty body decodes to
    wrong symbols, never out of bounds."""
    cfg = RansConfig(variant=Variant.RANS64, prob_bits=14, n_lanes=128,
                     block_symbols=1 << 12)
    data = CORPORA["skewed"](1 << 12, seed=2)
    freqs, cum = jstats.build_model(data, 14)
    blocks, _ = port_encode(cfg, data, freqs, cum)
    for cut in (blocks[0].size - 1, 2 * 128):
        out = codec.decode(cfg, [blocks[0][:cut]], [1 << 12], freqs, cum,
                           "cpu")
        assert out.shape == (1 << 12,)
    with pytest.raises(ValueError, match="corrupt"):
        codec.decode(cfg, [blocks[0][:100]], [1 << 12], freqs, cum, "cpu")
