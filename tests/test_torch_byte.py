"""ryg_rans_tpu_torch.ops.byte: the plain K3/K4 versions through the
encode/decode loop of ryg_rans_tpu_torch.ops.codec, against the reference
package's NumPy oracle per block and its Pallas BYTE/ALIAS encoder
(interpret mode), by exact equality.  The interpret-mode calls are slow
(ALIAS encode takes seconds even at 128 lanes), so a few cases carry them
and the oracle the rest."""

import numpy as np
import pytest
import torch

from _torch_corpora import CORPORA
from ryg_rans_tpu.config import RansConfig as JConfig
from ryg_rans_tpu.config import Variant as JVariant
from ryg_rans_tpu.models import stats as jstats
from ryg_rans_tpu.ops import byte_tpu
from ryg_rans_tpu.ops import reference_numpy as oracle
from ryg_rans_tpu_torch.config import RansConfig, Variant
from ryg_rans_tpu_torch.ops import byte, codec, host_prep

B, A = Variant.BYTE, Variant.ALIAS
# (variant, prob_bits, n_lanes, block_symbols, input bytes, corpus, seed):
# every input spans two full blocks and a tail block.
CASES = [
    (B, 9, 128, 1 << 12, 9_000, "skewed", 1),
    (B, 12, 256, 1 << 13, 20_000, "sparse", 2),
    (B, 14, 512, 1 << 13, 20_000, "skewed", 3),
    (B, 15, 128, 1 << 12, 9_000, "random", 4),
    (B, 16, 256, 1 << 13, 20_000, "skewed", 5),
    # freq == 2^16 == M: the encode threshold freq << 15 is 2^31
    (B, 16, 128, 1 << 12, 9_000, "one_symbol", 0),
    (A, 9, 128, 1 << 12, 9_000, "skewed", 6),
    (A, 12, 512, 1 << 13, 20_000, "sparse", 7),
    (A, 16, 256, 1 << 13, 20_000, "skewed", 8),
    (A, 16, 128, 1 << 12, 9_000, "one_symbol", 0),
    # slot adjusts outside [0, 2^16): the u32 subtract must wrap
    (A, 16, 128, 1 << 13, 20_000, "random", 3),
]
IDS = [f"{c[0].name}-pb{c[1]}-N{c[2]}-{c[5]}" for c in CASES]
#: the cases that also run the reference's Pallas kernels in interpret mode
PALLAS = [2, 5, 10]


def setup(case):
    variant, pb, N, Bs, size, corpus, seed = case
    cfg = RansConfig(variant=variant, prob_bits=pb, n_lanes=N,
                     block_symbols=Bs)
    jcfg = JConfig(variant=JVariant(int(variant)), prob_bits=pb, n_lanes=N,
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
        assert mine.dtype == np.uint8
        ref = oracle.encode(jcfg, padded_np[b * Bs:(b + 1) * Bs], freqs, cum)
        assert np.array_equal(mine, ref[0])
    # the port decodes its own blocks back to the padded input
    sizes = codec.block_sizes(Bs, padded.numel())
    dec = codec.decode(cfg, blocks, sizes, freqs, cum, "cpu")
    assert torch.equal(dec, padded)


@pytest.mark.parametrize("case", [CASES[i] for i in PALLAS],
                         ids=[IDS[i] for i in PALLAS])
def test_encode_matches_pallas(case):
    cfg, jcfg, data, freqs, cum = setup(case)
    blocks, padded = port_encode(cfg, data, freqs, cum)
    jblocks, jpadded = byte_tpu.encode(jcfg, data, freqs, cum,
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


@pytest.mark.parametrize("variant", [B, A])
def test_wrappers_take_the_plain_version_on_cpu(variant):
    """On CPU tensors the wrappers return their plain versions' results and
    count no kernel launch."""
    pb, N = 12, 256
    data = CORPORA["skewed"](3 * 4 * N * 4, seed=1)
    freqs, cum = jstats.build_model(data, pb)
    f, st = (torch.from_numpy(a) for a in host_prep.enc_tables(freqs, cum))
    remap = (torch.from_numpy(host_prep.alias_remap(freqs, cum, pb))
             if variant == A else None)
    syms = torch.from_numpy(data).view(3, -1)
    byte.encode_blocks.launches = byte.decode_blocks.launches = 0
    cells, states = byte.encode_blocks(syms, f, st, remap, N, pb)
    cells_r, states_r = byte.encode_blocks_ref(syms, f, st, remap, N, pb)
    assert torch.equal(cells, cells_r) and torch.equal(states, states_r)
    assert cells.dtype == torch.int32 and states.dtype == torch.int32

    heads, body, counts = byte.compact_emissions(cells, states)
    blocks = codec.assemble_blocks(heads.numpy(), body.numpy(),
                                   counts.numpy())
    cfg = RansConfig(variant=variant, prob_bits=pb, n_lanes=N)
    rec = codec.codec_of(cfg)
    tables = rec.dec_tables(freqs, cum, pb, "cpu")
    stream = rec.prep_decode(blocks, N, "cpu")
    out = byte.decode_blocks(*stream, tables, syms.shape[1], pb,
                             variant == A)
    assert torch.equal(out, byte.decode_blocks_ref(
        *stream, tables, syms.shape[1], pb, variant == A))
    assert torch.equal(out, syms)
    assert byte.encode_blocks.launches == byte.decode_blocks.launches == 0


def test_compaction_keeps_stream_order():
    """Cells are kept in [block, step, lane] order, each cell's bytes most
    significant first, and heads are the final states lane-ascending as 4
    little-endian bytes."""
    cells = torch.tensor([[0, 0x10500, 0, 0x2ABCD, 0x10100, 0, 0, 0],
                          [0x20201, 0, 0, 0, 0, 0, 0, 0x10300]],
                         dtype=torch.int32)
    states = torch.tensor([[0x04030201, -1], [0x7FFF8000, 0x00800000]],
                          dtype=torch.int32)
    heads, body, counts = byte.compact_emissions(cells, states)
    assert body.tolist() == [5, 0xAB, 0xCD, 1, 2, 1, 3]
    assert counts.tolist() == [4, 3]
    assert heads.tolist() == [[1, 2, 3, 4, 0xFF, 0xFF, 0xFF, 0xFF],
                              [0x00, 0x80, 0xFF, 0x7F, 0, 0, 0x80, 0]]


def test_grouped_encode_equals_one_launch(monkeypatch):
    """Coding blocks in several launch groups writes the same bytes."""
    cfg = RansConfig(variant=A, prob_bits=12, n_lanes=128,
                     block_symbols=1 << 11)
    data = CORPORA["skewed"](5 * (1 << 11) + 300, seed=7)
    freqs, cum = jstats.build_model(data, 12)
    whole, padded = port_encode(cfg, data, freqs, cum)
    monkeypatch.setattr(codec, "GROUP_BYTES", (2 << 11) * 4)
    parts = codec.encode(cfg, padded, freqs, cum)
    assert all(np.array_equal(a, b) for a, b in zip(whole, parts,
                                                    strict=True))
    sizes = codec.block_sizes(cfg.block_symbols, padded.numel())
    assert torch.equal(codec.decode(cfg, parts, sizes, freqs, cum, "cpu"),
                       padded)


@pytest.mark.parametrize("variant", [B, A])
def test_truncated_body_decodes_without_fault(variant):
    """Reads clamp to the block's bytes: a cut or empty body decodes to
    wrong symbols, never out of bounds."""
    cfg = RansConfig(variant=variant, prob_bits=12, n_lanes=128,
                     block_symbols=1 << 12)
    data = CORPORA["skewed"](1 << 12, seed=2)
    freqs, cum = jstats.build_model(data, 12)
    blocks, _ = port_encode(cfg, data, freqs, cum)
    for cut in (blocks[0].size - 1, 4 * 128):
        out = codec.decode(cfg, [blocks[0][:cut]], [1 << 12], freqs, cum,
                           "cpu")
        assert out.shape == (1 << 12,)
    with pytest.raises(ValueError, match="corrupt"):
        codec.decode(cfg, [blocks[0][:100]], [1 << 12], freqs, cum, "cpu")
