"""The kernels on the card (WORD K1/K2, BYTE/ALIAS K3/K4, RANS64 K5/K6)
against their plain PyTorch versions, and the entry points on the card
against ``device="cpu"``.  Exact equality throughout: the codec has no
tolerance.

Needs an NVIDIA GPU with nvcc (sm_90a); run there with

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports JAX, which a machine
set up for the port need not have; this file imports nothing of JAX.)
Elsewhere every test skips inside its body.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from _torch_corpora import CORPORA, dominant, random_bytes, skewed
import ryg_rans_tpu_torch as rt
from ryg_rans_tpu_torch.models import stats
from ryg_rans_tpu_torch.ops import byte, codec, host_prep, rans64, word

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m cuda "
                    "--noconftest tests/test_torch_cuda.py` on the H100")
    return torch.device("cuda")


def _kernel_vs_plain(dev, data, N, pb, B):
    freqs, cum = stats.build_model(data, pb)
    f, st = (torch.from_numpy(a).to(dev)
             for a in host_prep.enc_tables(freqs, cum))
    syms = torch.from_numpy(data).to(dev).view(-1, B)
    before = word.encode_blocks.launches
    cells, states = word.encode_blocks(syms, f, st, N, pb)
    assert word.encode_blocks.launches == before + 1
    cells_r, states_r = word.encode_blocks_ref(syms, f, st, N, pb)
    torch.cuda.synchronize()
    assert torch.equal(cells, cells_r) and torch.equal(states, states_r)

    cfg = rt.RansConfig(prob_bits=pb, n_lanes=N, block_symbols=B)
    blocks = codec.encode(cfg, syms.view(-1), freqs, cum)
    c2s, fd, cd = (torch.from_numpy(a).to(dev)
                   for a in host_prep.dec_tables(freqs, cum, pb))
    stream = codec.codec_of(cfg).prep_decode(blocks, N, dev)
    before = word.decode_blocks.launches
    out = word.decode_blocks(*stream, c2s, fd, cd, B, pb)
    assert word.decode_blocks.launches == before + 1
    out_r = word.decode_blocks_ref(*stream, c2s, fd, cd, B, pb)
    torch.cuda.synchronize()
    assert torch.equal(out, out_r) and torch.equal(out, syms)
    return blocks, stream, (c2s, fd, cd)


@pytest.mark.parametrize("N", [128, 256, 512, 1024, 2048, 4096, 8192, 16384])
@pytest.mark.parametrize("pb", [9, 12, 15])
def test_kernels_every_lane_count(dev, N, pb):
    B = 16 * N
    _kernel_vs_plain(dev, skewed(3 * B, seed=N + pb), N, pb, B)


def test_kernels_full_width(dev):
    cfg = rt.RansConfig.auto(16 << 20)
    assert (cfg.n_lanes, cfg.prob_bits, cfg.block_symbols) == (
        16384, 11, 1 << 23)
    _kernel_vs_plain(dev, skewed(2 << 23, seed=1), cfg.n_lanes,
                     cfg.prob_bits, cfg.block_symbols)


@pytest.mark.parametrize("corpus", ["one_symbol", "random", "sparse"])
def test_kernels_edge_models(dev, corpus):
    _kernel_vs_plain(dev, CORPORA[corpus](3 << 16, seed=2), 4096, 15,
                     1 << 16)


def test_truncated_body_kernel_matches_plain(dev):
    """Clamped reads: the kernel and its plain version decode a cut body to
    the same wrong symbols, without a fault."""
    N, pb, B = 1024, 12, 1 << 15
    blocks, _, tables = _kernel_vs_plain(dev, skewed(B, seed=3), N, pb, B)
    for cut in (blocks[0].size - 7, 2 * N + 5, 2 * N):
        stream = codec.CODECS[rt.Variant.WORD].prep_decode(
            [blocks[0][:cut]], N, dev)
        out = word.decode_blocks(*stream, *tables, B, pb)
        out_r = word.decode_blocks_ref(*stream, *tables, B, pb)
        torch.cuda.synchronize()
        assert torch.equal(out, out_r)


def _byte_kernel_vs_plain(dev, data, variant, N, pb, B):
    freqs, cum = stats.build_model(data, pb)
    f, st = (torch.from_numpy(a).to(dev)
             for a in host_prep.enc_tables(freqs, cum))
    alias = variant == rt.Variant.ALIAS
    remap = (torch.from_numpy(host_prep.alias_remap(freqs, cum, pb)).to(dev)
             if alias else None)
    syms = torch.from_numpy(data).to(dev).view(-1, B)
    before = byte.encode_blocks.launches
    cells, states = byte.encode_blocks(syms, f, st, remap, N, pb)
    assert byte.encode_blocks.launches == before + 1
    cells_r, states_r = byte.encode_blocks_ref(syms, f, st, remap, N, pb)
    torch.cuda.synchronize()
    assert torch.equal(cells, cells_r) and torch.equal(states, states_r)

    cfg = rt.RansConfig(variant=variant, prob_bits=pb, n_lanes=N,
                        block_symbols=B)
    blocks = codec.encode(cfg, syms.view(-1), freqs, cum)
    rec = codec.codec_of(cfg)
    tables = rec.dec_tables(freqs, cum, pb, dev)
    stream = rec.prep_decode(blocks, N, dev)
    before = byte.decode_blocks.launches
    out = byte.decode_blocks(*stream, tables, B, pb, alias)
    assert byte.decode_blocks.launches == before + 1
    out_r = byte.decode_blocks_ref(*stream, tables, B, pb, alias)
    torch.cuda.synchronize()
    assert torch.equal(out, out_r) and torch.equal(out, syms)
    return blocks, tables


def _rans64_kernel_vs_plain(dev, data, N, pb, B):
    freqs, cum = stats.build_model(data, pb)
    f, st = (torch.from_numpy(a).to(dev)
             for a in host_prep.enc_tables(freqs, cum))
    syms = torch.from_numpy(data).to(dev).view(-1, B)
    before = rans64.encode_blocks.launches
    cells, states = rans64.encode_blocks(syms, f, st, N, pb)
    assert rans64.encode_blocks.launches == before + 1
    cells_r, states_r = rans64.encode_blocks_ref(syms, f, st, N, pb)
    torch.cuda.synchronize()
    assert torch.equal(cells, cells_r) and torch.equal(states, states_r)

    cfg = rt.RansConfig(variant=rt.Variant.RANS64, prob_bits=pb, n_lanes=N,
                        block_symbols=B)
    blocks = codec.encode(cfg, syms.view(-1), freqs, cum)
    rec = codec.codec_of(cfg)
    tables = rec.dec_tables(freqs, cum, pb, dev)
    stream = rec.prep_decode(blocks, N, dev)
    before = rans64.decode_blocks.launches
    out = rans64.decode_blocks(*stream, *tables, B, pb)
    assert rans64.decode_blocks.launches == before + 1
    out_r = rans64.decode_blocks_ref(*stream, *tables, B, pb)
    torch.cuda.synchronize()
    assert torch.equal(out, out_r) and torch.equal(out, syms)
    return blocks, tables


LANES = [128, 256, 512, 1024, 2048, 4096, 8192, 16384]


@pytest.mark.parametrize("N", LANES)
@pytest.mark.parametrize("variant,pb", [
    (rt.Variant.BYTE, 9), (rt.Variant.BYTE, 14), (rt.Variant.BYTE, 16),
    (rt.Variant.ALIAS, 9), (rt.Variant.ALIAS, 16)],
    ids=["BYTE-pb9", "BYTE-pb14", "BYTE-pb16", "ALIAS-pb9", "ALIAS-pb16"])
def test_byte_kernels_every_lane_count(dev, variant, pb, N):
    B = 16 * N
    _byte_kernel_vs_plain(dev, skewed(3 * B, seed=N + pb), variant, N, pb, B)


@pytest.mark.parametrize("N", LANES)
@pytest.mark.parametrize("pb", [9, 14, 16, 24, 31])
def test_rans64_kernels_every_lane_count(dev, pb, N):
    B = 16 * N
    _rans64_kernel_vs_plain(dev, skewed(3 * B, seed=N + pb), N, pb, B)


@pytest.mark.parametrize("variant,pb", [
    (rt.Variant.BYTE, 16), (rt.Variant.ALIAS, 16), (rt.Variant.RANS64, 16),
    (rt.Variant.RANS64, 31)])
@pytest.mark.parametrize("corpus", ["one_symbol", "random", "sparse"])
def test_new_kernels_edge_models(dev, corpus, variant, pb):
    """One-symbol models (freq = 2^prob_bits), and at ALIAS pb 16 the
    random model whose slot adjusts wrap."""
    data = CORPORA[corpus](3 << 16, seed=3)
    if variant == rt.Variant.RANS64:
        _rans64_kernel_vs_plain(dev, data, 4096, pb, 1 << 16)
    else:
        _byte_kernel_vs_plain(dev, data, variant, 4096, pb, 1 << 16)


def test_new_kernels_full_width(dev):
    data = skewed(2 << 23, seed=1)
    for v in (rt.Variant.BYTE, rt.Variant.ALIAS, rt.Variant.RANS64):
        cfg = rt.RansConfig.auto(16 << 20, v)
        assert (cfg.n_lanes, cfg.block_symbols) == (16384, 1 << 23)
        if v == rt.Variant.RANS64:
            _rans64_kernel_vs_plain(dev, data, 16384, cfg.prob_bits, 1 << 23)
        else:
            _byte_kernel_vs_plain(dev, data, v, 16384, cfg.prob_bits,
                                  1 << 23)


@pytest.mark.parametrize("variant", [rt.Variant.BYTE, rt.Variant.ALIAS,
                                     rt.Variant.RANS64])
def test_new_kernels_truncated_body_match_plain(dev, variant):
    N, pb, B = 1024, 12, 1 << 15
    data = skewed(B, seed=3)
    if variant == rt.Variant.RANS64:
        blocks, tables = _rans64_kernel_vs_plain(dev, data, N, pb, B)
        head, mod, args = 2 * N, rans64, tables
    else:
        blocks, tables = _byte_kernel_vs_plain(dev, data, variant, N, pb, B)
        head, mod = 4 * N, byte
        args = (tables,)
    for cut in (blocks[0].size - 7, head + 5, head):
        stream = codec.CODECS[variant].prep_decode([blocks[0][:cut]], N,
                                                   dev)
        tail = (B, pb) if mod is rans64 else (B, pb,
                                              variant == rt.Variant.ALIAS)
        out = mod.decode_blocks(*stream, *args, *tail)
        out_r = mod.decode_blocks_ref(*stream, *args, *tail)
        torch.cuda.synchronize()
        assert torch.equal(out, out_r)


@pytest.mark.parametrize("variant,pb", [
    (rt.Variant.BYTE, None), (rt.Variant.ALIAS, None),
    (rt.Variant.RANS64, None), (rt.Variant.RANS64, 31)],
    ids=["BYTE", "ALIAS", "RANS64", "RANS64-pb31"])
@pytest.mark.parametrize("size", [20_000, (9 << 20) + 12_345])
def test_new_variants_entry_points_on_card_match_cpu(dev, size, variant, pb):
    data = skewed(size, seed=size)
    cfg = rt.RansConfig.auto(size, variant)
    if pb is not None:
        cfg = dataclasses.replace(cfg, prob_bits=pb)
    mod = rans64 if variant == rt.Variant.RANS64 else byte
    mod.encode_blocks.launches = mod.decode_blocks.launches = 0
    blob = rt.compress(data, cfg)
    assert blob == rt.compress(data, cfg, device="cpu")
    assert rt.decompress(blob) == data.tobytes()
    t = torch.from_numpy(data).to(dev)
    assert torch.equal(rt.decompress_to_device(blob), t)
    nocrc = dataclasses.replace(cfg, checksum=False)
    assert rt.compress_from_device(t, nocrc) == rt.compress(data, nocrc,
                                                            device="cpu")
    assert rt.decompress_block(blob, 0) == data[:cfg.block_symbols] \
        .tobytes()
    assert mod.encode_blocks.launches >= 2
    assert mod.decode_blocks.launches >= 2


@pytest.mark.parametrize("size", [20_000, 70_001, (9 << 20) + 12_345])
def test_entry_points_on_card_match_cpu(dev, size):
    data = skewed(size, seed=size)
    word.encode_blocks.launches = word.decode_blocks.launches = 0
    blob = rt.compress(data)
    assert blob == rt.compress(data, device="cpu")
    assert rt.decompress(blob) == data.tobytes()
    t = torch.from_numpy(data).to(dev)
    assert torch.equal(rt.decompress_to_device(blob), t)
    nocrc = dataclasses.replace(rt.RansConfig.auto(size), checksum=False)
    assert rt.compress_from_device(t) == rt.compress(data, nocrc,
                                                     device="cpu")
    assert rt.decompress_block(blob, 0) == data[:nocrc.block_symbols] \
        .tobytes()
    assert word.encode_blocks.launches >= 2
    assert word.decode_blocks.launches >= 2


@pytest.mark.parametrize("variant", [None, rt.Variant.BYTE, rt.Variant.ALIAS,
                                     rt.Variant.RANS64],
                         ids=["WORD", "BYTE", "ALIAS", "RANS64"])
def test_native_backend_matches_card_full_width(dev, variant):
    """At the full-width auto shape (16384 lanes, a 2^23-symbol block and a
    tail) the C++ host core writes the card's container, and each side
    decodes the other's."""
    size = (9 << 20) + 12_345
    data = skewed(size, seed=size + 1)
    cfg = rt.RansConfig.auto(size, variant)
    assert cfg.n_lanes == 16384
    mod = {None: word, rt.Variant.RANS64: rans64}.get(variant, byte)
    mod.encode_blocks.launches = mod.decode_blocks.launches = 0
    blob = rt.compress(data, cfg)
    assert rt.compress(data, cfg, backend="native") == blob
    assert rt.decompress(blob, backend="native") == data.tobytes()
    assert rt.decompress(rt.compress(data, cfg, backend="native")) == \
        data.tobytes()
    assert mod.encode_blocks.launches >= 1
    assert mod.decode_blocks.launches >= 1


def test_raw_blocks_on_card(dev):
    cfg = rt.RansConfig(prob_bits=12, n_lanes=128, block_symbols=1 << 12)
    data = np.concatenate([skewed(1 << 12, seed=4), random_bytes(1 << 12, 5),
                           skewed(99, seed=6)])
    blob = rt.compress(data, cfg)
    assert blob == rt.compress(data, cfg, device="cpu")
    assert rt.decompress(blob) == data.tobytes()
    assert torch.equal(rt.decompress_to_device(blob),
                       torch.from_numpy(data).to(dev))


# -- the cluster decoders K1, K3 and K5 (one thread-block cluster per block,
# the stream staged in shared memory): shapes that stress the plan and the
# ring

def _module(variant):
    return codec.CODECS[variant].ops


def _encode_blocks(dev, data, variant, N, pb, B):
    """Container blocks of ``data`` and the decode tables, on the card."""
    cfg = rt.RansConfig(variant=variant, prob_bits=pb, n_lanes=N,
                        block_symbols=B)
    freqs, cum = stats.build_model(data, pb)
    syms = torch.from_numpy(data).to(dev)
    tables = codec.codec_of(cfg).dec_tables(freqs, cum, pb, dev)
    return codec.encode(cfg, syms, freqs, cum), tables


def _decode_vs_plain(dev, variant, blocks, tables, N, pb, B, plan=None):
    """Decode ``blocks`` as one launch group with the kernel and with its
    plain version; assert they agree; return the kernel's output."""
    rec = codec.CODECS[variant]
    stream = rec.prep_decode(blocks, N, dev)
    args = rec.decode_args(tables, B, pb)
    before = rec.ops.decode_blocks.launches
    out = rec.ops.decode_blocks(*stream, *args, plan=plan)
    assert rec.ops.decode_blocks.launches == before + 1
    out_r = rec.ops.decode_blocks_ref(*stream, *args)
    torch.cuda.synchronize()
    assert torch.equal(out, out_r)
    return out


CLUSTER_VARIANTS = [(rt.Variant.BYTE, 14), (rt.Variant.ALIAS, 16),
                    (rt.Variant.RANS64, 14), (rt.Variant.RANS64, 31),
                    (rt.Variant.WORD, 11), (rt.Variant.WORD, 15)]
CLUSTER_IDS = ["BYTE-pb14", "ALIAS-pb16", "RANS64-pb14", "RANS64-pb31",
               "WORD-pb11", "WORD-pb15"]
HEAD_UNITS = {rt.Variant.WORD: 2, rt.Variant.RANS64: 2}  # else 4 bytes


def _plan_changes():
    """Lane counts on either side of each change of the plan's C."""
    from ryg_rans_tpu_torch.ops import decode_plan as dp
    ns = set()
    for lo, hi in zip(dp.LANE_COUNTS, dp.LANE_COUNTS[1:]):
        if dp.plan("BYTE", lo, 12).cluster != dp.plan("BYTE", hi,
                                                      12).cluster:
            ns |= {lo, hi}
    return sorted(ns)


@pytest.mark.parametrize("variant,pb", CLUSTER_VARIANTS, ids=CLUSTER_IDS)
def test_cluster_decoders_full_width_truncated_and_empty_body(dev, variant,
                                                              pb):
    """16384 lanes: a cut body, a body cut to nothing beside a whole one
    (one launch group), both against the plain version."""
    N, B = 16384, 64 * 16384
    blocks, tables = _encode_blocks(dev, skewed(2 * B, seed=7), variant, N,
                                    pb, B)
    head = HEAD_UNITS.get(variant, 4) * N
    whole = _decode_vs_plain(dev, variant, blocks, tables, N, pb, B)
    assert torch.equal(whole.view(-1).cpu(),
                       torch.from_numpy(skewed(2 * B, seed=7)))
    for cut in (blocks[0].size - 7, head + (blocks[0].size - head) // 2,
                head + 5):
        _decode_vs_plain(dev, variant, [blocks[0][:cut]], tables, N, pb, B)
    _decode_vs_plain(dev, variant, [blocks[0][:head], blocks[1]], tables, N,
                     pb, B)


@pytest.mark.parametrize("variant,pb", [(rt.Variant.BYTE, 16),
                                        (rt.Variant.RANS64, 31),
                                        (rt.Variant.WORD, 15)],
                         ids=["BYTE-pb16", "RANS64-pb31", "WORD-pb15"])
def test_cluster_decoders_random_bytes_full_width(dev, variant, pb):
    """Near-incompressible input refills about a unit a lane a step: the
    ring's lead over the cursor is at its thinnest."""
    data = random_bytes(2 << 23, 11)
    if variant == rt.Variant.WORD:
        _kernel_vs_plain(dev, data, 16384, pb, 1 << 23)
    elif variant == rt.Variant.RANS64:
        _rans64_kernel_vs_plain(dev, data, 16384, pb, 1 << 23)
    else:
        _byte_kernel_vs_plain(dev, data, variant, 16384, pb, 1 << 23)


@pytest.mark.parametrize("variant,pb", CLUSTER_VARIANTS, ids=CLUSTER_IDS)
def test_cluster_decoders_launch_group_of_eight_blocks(dev, variant, pb):
    N, B = 16384, 1 << 20
    data = skewed(8 * B, seed=8)
    blocks, tables = _encode_blocks(dev, data, variant, N, pb, B)
    assert len(blocks) == 8
    out = _decode_vs_plain(dev, variant, blocks, tables, N, pb, B)
    assert torch.equal(out.view(-1).cpu(), torch.from_numpy(data))


@pytest.mark.parametrize("N", _plan_changes())
@pytest.mark.parametrize("variant,pb", CLUSTER_VARIANTS, ids=CLUSTER_IDS)
def test_cluster_decoders_where_the_plan_changes(dev, variant, pb, N):
    B = 32 * N
    data = skewed(3 * B, seed=N)
    blocks, tables = _encode_blocks(dev, data, variant, N, pb, B)
    out = _decode_vs_plain(dev, variant, blocks, tables, N, pb, B)
    assert torch.equal(out.view(-1).cpu(), torch.from_numpy(data))


@pytest.mark.parametrize("variant,pb", CLUSTER_VARIANTS, ids=CLUSTER_IDS)
def test_cluster_decoders_every_cluster_size(dev, variant, pb):
    """Every C the plan allows at 16384 lanes decodes as the plain version
    does, and the card can schedule its clusters."""
    from ryg_rans_tpu_torch.ops import decode_plan as dp
    N, B = 16384, 32 * 16384
    data = skewed(2 * B, seed=9)
    blocks, tables = _encode_blocks(dev, data, variant, N, pb, B)
    mod = _module(variant)
    for c in dp.cluster_sizes(N):
        plan = dp.plan(variant.name, N, pb, cluster=c)
        assert mod.max_active_clusters(plan, dev) >= 1
        out = _decode_vs_plain(dev, variant, blocks, tables, N, pb, B, plan)
        assert torch.equal(out.view(-1).cpu(), torch.from_numpy(data))


# -- K4 (BYTE/ALIAS encode: symbols staged in shared memory, the reciprocal
# in place of the divide, the ALIAS remap in shared memory)

def _k4_vs_plain(dev, syms, freqs, cum, variant, N, pb):
    alias = variant == rt.Variant.ALIAS
    f, st = (torch.from_numpy(a).to(dev)
             for a in host_prep.enc_tables(freqs, cum))
    remap = (torch.from_numpy(host_prep.alias_remap(freqs, cum, pb)).to(dev)
             if alias else None)
    table = torch.from_numpy(host_prep.byte_enc_table(freqs, cum, pb,
                                                      alias)).to(dev)
    before = byte.encode_blocks.launches
    cells, states = byte.encode_blocks(syms, f, st, remap, N, pb, table)
    assert byte.encode_blocks.launches == before + 1
    cells_r, states_r = byte.encode_blocks_ref(syms, f, st, remap, N, pb)
    torch.cuda.synchronize()
    assert torch.equal(cells, cells_r) and torch.equal(states, states_r)


@pytest.mark.parametrize("variant,pb", [(rt.Variant.BYTE, 16),
                                        (rt.Variant.ALIAS, 16),
                                        (rt.Variant.BYTE, 12),
                                        (rt.Variant.ALIAS, 12)],
                         ids=["BYTE-pb16", "ALIAS-pb16", "BYTE-pb12",
                              "ALIAS-pb12"])
@pytest.mark.parametrize("corpus", ["sparse", "one_symbol", "random"])
def test_k4_edge_models(dev, corpus, variant, pb):
    """freq == 1 symbols (sparse), the one-symbol model (freq = 2^pb) and,
    at ALIAS pb 16, the random model whose slot adjusts wrap."""
    data = CORPORA[corpus](3 << 16, seed=12)
    freqs, cum = stats.build_model(data, pb)
    if corpus == "sparse":
        assert (np.asarray(freqs) == 1).any()
    if corpus == "one_symbol":
        assert np.asarray(freqs).max() == 1 << pb
    syms = torch.from_numpy(data).to(dev).view(-1, 1 << 16)
    _k4_vs_plain(dev, syms, freqs, cum, variant, 4096, pb)


@pytest.mark.parametrize("variant,pb", [(rt.Variant.BYTE, 14),
                                        (rt.Variant.ALIAS, 16)],
                         ids=["BYTE-pb14", "ALIAS-pb16"])
def test_k4_launch_groups_of_one_and_four_blocks_and_a_tail(dev, variant,
                                                             pb):
    """Full width (16384 lanes): one block, four blocks in one launch, a
    tail block whose steps are not a whole tile, and symbols that do not
    start on a 16-byte boundary."""
    N, B = 16384, 1 << 20
    data = skewed(5 * B + 12 * N, seed=13)
    freqs, cum = stats.build_model(data, pb)
    t = torch.from_numpy(data).to(dev)
    _k4_vs_plain(dev, t[:B].view(1, B), freqs, cum, variant, N, pb)
    _k4_vs_plain(dev, t[:4 * B].view(4, B), freqs, cum, variant, N, pb)
    _k4_vs_plain(dev, t[4 * B:].view(1, -1), freqs, cum, variant, N, pb)
    _k4_vs_plain(dev, t[1:1 + 8 * N].view(1, -1), freqs, cum, variant, N,
                 pb)


# -- K2 and K6 (WORD and RANS64 encode on csrc/enc_tiles.cuh: symbols staged
# in shared memory, division-free steps from their host_prep tables)

K2_K6 = [(rt.Variant.WORD, 9), (rt.Variant.WORD, 12), (rt.Variant.WORD, 15),
         (rt.Variant.RANS64, 9), (rt.Variant.RANS64, 14),
         (rt.Variant.RANS64, 16), (rt.Variant.RANS64, 24),
         (rt.Variant.RANS64, 31)]
K2_K6_IDS = [f"{v.name}-pb{pb}" for v, pb in K2_K6]


def _enc_vs_plain(dev, syms, freqs, cum, variant, N, pb, table=True):
    """K2 or K6 on ``syms`` against its plain version; ``table=False``
    leaves the table to the wrapper.  Returns the kernel's states."""
    mod = word if variant == rt.Variant.WORD else rans64
    make = (host_prep.word_enc_table if variant == rt.Variant.WORD
            else host_prep.rans64_enc_table)
    f, st = (torch.from_numpy(a).to(dev)
             for a in host_prep.enc_tables(freqs, cum))
    kw = ({"table": torch.from_numpy(make(freqs, cum, pb)).to(dev)}
          if table else {})
    before = mod.encode_blocks.launches
    cells, states = mod.encode_blocks(syms, f, st, N, pb, **kw)
    assert mod.encode_blocks.launches == before + 1
    cells_r, states_r = mod.encode_blocks_ref(syms, f, st, N, pb)
    torch.cuda.synchronize()
    assert torch.equal(cells, cells_r) and torch.equal(states, states_r)
    return states


@pytest.mark.parametrize("N", LANES)
@pytest.mark.parametrize("variant,pb", K2_K6, ids=K2_K6_IDS)
def test_k2_k6_every_lane_count(dev, variant, pb, N):
    """Two blocks of 40 steps (a whole tile and 8 steps) in one launch with
    the table, and one block with the table left to the wrapper."""
    B = 40 * N
    data = skewed(2 * B, seed=N + pb)
    freqs, cum = stats.build_model(data, pb)
    syms = torch.from_numpy(data).to(dev).view(2, B)
    _enc_vs_plain(dev, syms, freqs, cum, variant, N, pb)
    _enc_vs_plain(dev, syms[1:], freqs, cum, variant, N, pb, table=False)


@pytest.mark.parametrize("variant,pb", [
    (rt.Variant.WORD, 12), (rt.Variant.WORD, 15), (rt.Variant.RANS64, 16),
    (rt.Variant.RANS64, 31)],
    ids=["WORD-pb12", "WORD-pb15", "RANS64-pb16", "RANS64-pb31"])
@pytest.mark.parametrize("corpus", ["sparse", "one_symbol", "random"])
def test_k2_k6_edge_models(dev, corpus, variant, pb):
    """freq == 1 symbols (sparse) and the one-symbol model (freq = 2^pb:
    WORD's x_max is 2^32 there, RANS64's threshold 2^31 at pb 31)."""
    data = CORPORA[corpus](3 << 16, seed=14)
    freqs, cum = stats.build_model(data, pb)
    if corpus == "sparse" and pb <= 16:  # above, every freq scales past 1
        assert (np.asarray(freqs) == 1).any()
    if corpus == "one_symbol":
        assert np.asarray(freqs).max() == 1 << pb
    syms = torch.from_numpy(data).to(dev).view(-1, 1 << 16)
    _enc_vs_plain(dev, syms, freqs, cum, variant, 4096, pb)


def test_k2_dominant_symbol_full_width(dev):
    """WORD prob_bits 15 at full width (16384 lanes, two 2^23-symbol blocks
    and a tail) on a model with one symbol of freq 2^15 - 3: the states run
    past 2^31, where rans_byte.h's 31-bit reciprocal is not exact."""
    N, B, pb = 16384, 1 << 23, 15
    data = dominant((2 << 23) + 12 * N, seed=15)
    freqs, cum = stats.build_model(data, pb)
    assert np.asarray(freqs).max() == (1 << 15) - 3
    t = torch.from_numpy(data).to(dev)
    states = _enc_vs_plain(dev, t[:2 * B].view(2, B), freqs, cum,
                           rt.Variant.WORD, N, pb)
    assert int((states.to(torch.int64) & 0xFFFFFFFF).max()) >= 1 << 31
    _enc_vs_plain(dev, t[2 * B:].view(1, -1), freqs, cum, rt.Variant.WORD,
                  N, pb)


@pytest.mark.parametrize("variant,pb", [
    (rt.Variant.WORD, 11), (rt.Variant.WORD, 15), (rt.Variant.RANS64, 14),
    (rt.Variant.RANS64, 31)],
    ids=["WORD-pb11", "WORD-pb15", "RANS64-pb14", "RANS64-pb31"])
def test_k2_k6_launch_groups_of_one_and_four_blocks_and_a_tail(dev, variant,
                                                                pb):
    """Full width (16384 lanes): one block, four blocks in one launch, a
    tail block whose steps are not a whole tile, symbols that do not start
    on a 16-byte boundary, and the table left to the wrapper."""
    N, B = 16384, 1 << 20
    data = skewed(5 * B + 12 * N, seed=16)
    freqs, cum = stats.build_model(data, pb)
    t = torch.from_numpy(data).to(dev)
    _enc_vs_plain(dev, t[:B].view(1, B), freqs, cum, variant, N, pb)
    _enc_vs_plain(dev, t[:4 * B].view(4, B), freqs, cum, variant, N, pb)
    _enc_vs_plain(dev, t[4 * B:].view(1, -1), freqs, cum, variant, N, pb)
    _enc_vs_plain(dev, t[1:1 + 8 * N].view(1, -1), freqs, cum, variant, N,
                  pb)
    _enc_vs_plain(dev, t[:4 * B].view(4, B), freqs, cum, variant, N, pb,
                  table=False)


# -- the file path, the process layer and the lane coder on the card


@pytest.mark.parametrize("variant", [None, rt.Variant.BYTE, rt.Variant.ALIAS,
                                     rt.Variant.RANS64],
                         ids=["WORD", "BYTE", "ALIAS", "RANS64"])
def test_compress_file_on_card_matches_compress(dev, tmp_path, variant):
    """At a small auto shape (2048 lanes) cut to 2^19-symbol blocks (3
    blocks and a tail), 2 blocks a batch: the file container is
    compress's, and every batch reaches the variant's kernels."""
    from ryg_rans_tpu_torch.utils import stream_io

    size = (3 << 19) + 12_345
    data = skewed(size, seed=21)
    cfg = dataclasses.replace(rt.RansConfig.auto(size, variant),
                              block_symbols=1 << 19)
    mod = {None: word, rt.Variant.RANS64: rans64}.get(variant, byte)
    src, dst, back = tmp_path / "in", tmp_path / "out", tmp_path / "back"
    src.write_bytes(data.tobytes())
    n_blocks = -(-size // cfg.block_symbols)
    mod.encode_blocks.launches = mod.decode_blocks.launches = 0
    stream_io.compress_file(str(src), str(dst), cfg, blocks_per_batch=2)
    assert stream_io.decompress_file(str(dst), str(back),
                                     blocks_per_batch=2) == size
    # a batch of a full block and the tail takes two launches
    batches = -(-n_blocks // 2)
    assert batches <= mod.encode_blocks.launches <= n_blocks
    assert batches <= mod.decode_blocks.launches <= n_blocks
    assert dst.read_bytes() == rt.compress(data, cfg)
    assert back.read_bytes() == data.tobytes()


def test_two_rank_gloo_group_on_one_card(dev, tmp_path):
    """Two spawned ranks over gloo, both on cuda:0: each rank's
    roundtrip_step of the four variants and its multi-process round trip
    are exact (checked in the rank), both gather the single-process
    payloads, whose container is compress's, and both ranks launched
    every kernel."""
    import _torch_parallel_worker as worker
    from ryg_rans_tpu_torch import api

    world = 2
    worker.spawn(worker.run, world, (str(tmp_path / "store"), str(tmp_path),
                                     "cuda"), timeout=600)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    data = worker.multihost_input(world)
    cfg = rt.RansConfig(prob_bits=12, n_lanes=worker.LANES,
                        block_symbols=worker.BLOCK)
    freqs, cum = stats.build_model(data, 12)
    padded = codec.pad_block(torch.from_numpy(data), cfg.n_lanes, freqs)
    # the single-process payloads, before the raw-block rule
    want = [p[0] for p in api._encode_payloads(cfg, padded, freqs, cum,
                                                dev)]
    for r in ranks:
        assert int(r["mh_n"]) == len(want)
        got = [r[f"mh_p{b}"] for b in range(len(want))]
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        assert (r["launches"] > 0).all(), r["launches"]
    blob = api._pack_container(cfg, data.size, freqs, [[g] for g in got],
                               padded.numel(), None, data)
    assert blob == rt.compress(data, cfg)


@pytest.mark.parametrize("variant,pb", [
    (rt.Variant.BYTE, 14), (rt.Variant.WORD, 12), (rt.Variant.RANS64, 14),
    (rt.Variant.RANS64, 31)], ids=["BYTE", "WORD", "RANS64", "RANS64-pb31"])
def test_coder_reciprocal_paths_on_card(dev, variant, pb):
    """At 16384 lanes on the card: the division-free enc_put_symbol equals
    enc_put and the CPU's values, and the state words the coder flushes
    decode back with dec_init."""
    from ryg_rans_tpu_torch.ops import coder

    spec = rt.RansConfig(variant=variant, prob_bits=pb).spec
    data = np.concatenate([skewed(1 << 16, seed=pb),
                           np.arange(256, dtype=np.uint8)])
    freqs, cum = stats.build_model(data, pb)
    rng = np.random.default_rng(pb)
    n = 16384
    x = rng.integers(spec.L, spec.L << spec.word_bits, n, dtype=np.uint64)
    x = torch.from_numpy(x.view(np.int64).copy())
    sym = torch.from_numpy(rng.choice(np.nonzero(freqs)[0], n))
    esyms = coder.enc_symbol_init(freqs, cum, pb, spec, device=dev)
    fast = coder.enc_put_symbol(x.to(dev), sym.to(dev), esyms, spec, pb)
    slow = coder.enc_put(x.to(dev), sym.to(dev), freqs, cum, spec, pb)
    cpu = coder.enc_put_symbol(
        x, sym, coder.enc_symbol_init(freqs, cum, pb, spec, device="cpu"),
        spec, pb)
    for a, b, c in zip(fast, slow, cpu):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)
    head = coder.enc_flush(fast[0], spec)
    assert torch.equal(coder.dec_init(head, spec), fast[0])


@pytest.mark.parametrize("variant,pb", [(rt.Variant.BYTE, 14),
                                        (rt.Variant.WORD, 12),
                                        (rt.Variant.RANS64, 31)])
def test_coder_stream_on_card_matches_oracle(dev, variant, pb):
    """A block coded lane by lane with coder.enc_put_symbol on the card
    (128 lanes, 64 steps) gives the NumPy oracle's stream."""
    from ryg_rans_tpu_torch.ops import coder
    from ryg_rans_tpu_torch.ops import reference_numpy as oracle

    N, T = 128, 64
    cfg = rt.RansConfig(variant=variant, prob_bits=pb, n_lanes=N,
                        block_symbols=N * T)
    spec = cfg.spec
    data = skewed(N * T, seed=pb)
    freqs, cum = stats.build_model(data, pb)
    esyms = coder.enc_symbol_init(freqs, cum, pb, spec, device=dev)
    x = coder.enc_init((N,), spec, device=dev)
    grid = torch.from_numpy(data.astype(np.int64)).to(dev).view(T, N)
    steps = []
    for t in reversed(range(T)):
        x, words, k = coder.enc_put_symbol(x, grid[t], esyms, spec, pb)
        steps.append((words, k))
    # order: step, then lane, then word within the lane
    out = []
    for words, k in reversed(steps):
        w = words.T.cpu().numpy()
        kk = k.cpu().numpy()
        for lane in range(N):
            out.extend(w[lane, spec.max_renorm - kk[lane]:])
    stream = np.concatenate([coder.enc_flush(x, spec).cpu().numpy()
                             .reshape(-1), np.array(out, np.int64)])
    ref = oracle.encode(cfg, data, freqs, cum)[0]
    assert np.array_equal(stream, ref.astype(np.int64))


def _drain_sites() -> dict[str, list[tuple[int, int]]]:
    """{file: [(first line, last line)]} of the package's code that may
    drain the card's stream: each ``with span("rans.wait")`` block, and the
    copy helpers of ``utils/profiling.py``."""
    import ast
    from pathlib import Path

    def is_wait(e):
        return (isinstance(e, ast.Call) and getattr(e.func, "id", None) in
                ("span", "record_function") and e.args
                and isinstance(e.args[0], ast.Constant)
                and e.args[0].value == "rans.wait")

    sites = {}
    for path in Path(rt.__file__).resolve().parent.rglob("*.py"):
        ranges = []
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.With) and any(
                    is_wait(i.context_expr) for i in node.items):
                ranges.append((node.lineno, node.end_lineno))
            elif (path.name == "profiling.py"
                    and isinstance(node, ast.FunctionDef) and node.name in
                    ("_drain", "_copies", "to_device", "to_host")):
                ranges.append((node.lineno, node.end_lineno))
        sites[str(path)] = ranges
    return sites


@pytest.mark.parametrize("traced", [False, True], ids=["plain", "traced"])
@pytest.mark.parametrize("variant", [rt.Variant.WORD, rt.Variant.BYTE,
                                     rt.Variant.ALIAS, rt.Variant.RANS64],
                         ids=lambda v: v.name)
def test_every_sync_is_a_marked_drain(dev, variant, traced):
    """Each entry point, on text (coded, two launch groups) and on random
    bytes (stored raw), under ``torch.cuda.set_sync_debug_mode("warn")``:
    the package's innermost frame at every synchronisation lies in a copy
    helper or a ``rans.wait`` block, with and without a profiler."""
    import traceback
    import warnings
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    sites = _drain_sites()
    root = str(Path(rt.__file__).resolve().parent)
    cfg = rt.RansConfig.auto(3 << 20, variant)
    inputs = [skewed((3 << 20) + 4321, seed=3), random_bytes(1 << 20, 4)]
    blobs = [rt.compress(x, cfg) for x in inputs]
    dev_in = [torch.from_numpy(x).to(dev) for x in inputs]
    cfg_dev = dataclasses.replace(cfg, checksum=False)
    torch.cuda.synchronize()
    syncs, stray = [], []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()
                  if f.filename.startswith(root)]
        syncs.append(frames)
        if not frames or not any(
                a <= frames[-1].lineno <= b
                for a, b in sites.get(frames[-1].filename, [])):
            stray.append(frames[-1] if frames else "outside the package")

    outs = []
    prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            if traced else contextlib.nullcontext())
    with prof, warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for x, t, blob in zip(inputs, dev_in, blobs):
                outs.append((rt.compress(x.tobytes(), cfg),
                             rt.compress_from_device(t, cfg_dev),
                             rt.decompress(blob),
                             rt.decompress_to_device(blob),
                             rt.decompress_block(blob, 0)))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert syncs and not stray, stray
    for x, blob, (c, cd, d, dd, db) in zip(inputs, blobs, outs):
        assert c == blob and d == x.tobytes()
        assert cd == rt.compress(x, cfg_dev)
        assert torch.equal(dd.cpu(), torch.from_numpy(x))
        assert db == x[:cfg.block_symbols].tobytes()


# --- to_host's pinned staging ----------------------------------------------

def _staging():
    from ryg_rans_tpu_torch.utils import profiling
    return profiling


def _counting_stage(monkeypatch):
    """Count the staged fetches ``to_host`` makes from here on."""
    profiling = _staging()
    stage, n = profiling._stage, []

    def counted(*args):
        n.append(1)
        return stage(*args)
    monkeypatch.setattr(profiling, "_stage", counted)
    return n


def _staging_sizes():
    """The edges of the plain path and of the chunks, at the start of the
    staged range and beyond it."""
    p = _staging()
    C, S = p.CHUNK, p.STAGE_MIN
    return sorted({0, 1, S - 1, S, C - 1, C, C + 1, 5 * C // 2, S + C - 1,
                   S + C, S + C + 1, S + 5 * C // 2, 10**8})


@pytest.mark.parametrize("with_out", [False, True], ids=["new", "out"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int64],
                         ids=str)
@pytest.mark.parametrize("nbytes", _staging_sizes())
def test_staged_to_host_matches_cpu_numpy(dev, monkeypatch, nbytes, dtype,
                                          with_out):
    p = _staging()
    staged = _counting_stage(monkeypatch)
    size = torch.empty(0, dtype=dtype).element_size()
    t = torch.randint(0, 256, (nbytes - nbytes % size,), dtype=torch.uint8,
                      device=dev).view(dtype)
    n = t.numel()
    want = t.cpu().numpy()
    out = np.full(t.numel() * t.element_size(), 0xCD, np.uint8) \
        if with_out else None
    got = p.to_host(t, out=out)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    if with_out:
        assert out.tobytes() == want.tobytes()
    assert len(staged) == (n * t.element_size() >= p.STAGE_MIN)


@pytest.mark.parametrize("with_out", [False, True], ids=["new", "out"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int64],
                         ids=str)
def test_staged_to_host_of_an_offset_slice_and_a_strided_view(
        dev, monkeypatch, dtype, with_out):
    p = _staging()
    staged = _counting_stage(monkeypatch)
    size = torch.empty(0, dtype=dtype).element_size()
    n = (p.STAGE_MIN + 3 * p.CHUNK + 4099) // size
    base = torch.randint(0, 256, ((n + 1000) * size,), dtype=torch.uint8,
                         device=dev).view(dtype)
    sliced = base[777:777 + n]  # contiguous at an offset: staged
    strided = base[:n - n % 64].view(-1, 64)[:, ::2]  # plain path
    for t, stages in ((sliced, 1), (strided, 0)):
        want = t.cpu().numpy()
        out = np.empty(t.numel() * size, np.uint8) if with_out else None
        before = len(staged)
        got = p.to_host(t, out=out)
        assert got.shape == want.shape and np.array_equal(got, want)
        if with_out:
            assert out.tobytes() == want.tobytes()
        assert len(staged) - before == stages


def _straddling_sizes():
    """Either side of a chunk's and a block's (2^23) edge, plain and
    staged."""
    C, S, B = _staging().CHUNK, _staging().STAGE_MIN, 1 << 23
    return [B - 1, B + 1, S + C - 1, S + C + 1, S + 2 * B,
            S + 3 * C + 12_345]


@pytest.mark.parametrize("checksum", [True, False], ids=["crc", "nocrc"])
@pytest.mark.parametrize("size", _straddling_sizes())
def test_decompress_returns_bytes_across_chunk_and_block_edges(dev, size,
                                                               checksum):
    data = skewed(size, seed=size % 1009)
    cfg = dataclasses.replace(rt.RansConfig.auto(size), checksum=checksum)
    blob = rt.compress(data, cfg)
    out = rt.decompress(blob)
    assert type(out) is bytes and out == data.tobytes()
    B = cfg.block_symbols
    last = -(-size // B) - 1
    for b in {0, last}:
        blk = rt.decompress_block(blob, b)
        assert type(blk) is bytes and blk == data[b * B:(b + 1) * B].tobytes()


def test_staged_decompress_still_fails_a_flipped_payload_byte(dev):
    from ryg_rans_tpu_torch.utils import container as tcont

    size = _staging().STAGE_MIN + _staging().CHUNK + 999
    cfg = rt.RansConfig.auto(size)
    blob = rt.compress(skewed(size, seed=12), cfg)
    c = tcont.unpack(blob)
    bad = bytearray(blob)
    start = len(blob) - sum(s.nbytes for blk in c.payloads for s in blk)
    bad[start + 4 * cfg.n_lanes + 100] ^= 0x10  # an early body word
    with pytest.raises(ValueError, match="crc mismatch in block 0"):
        rt.decompress(bytes(bad))


def test_two_threads_decode_through_one_ring(dev):
    import threading

    size = _staging().STAGE_MIN + _staging().CHUNK // 2 + 17
    datas = [skewed(size, seed=21), skewed(size + 4096, seed=22)]
    blobs = [rt.compress(x) for x in datas]
    results = [[], []]
    go = threading.Barrier(2)

    def work(i):
        go.wait(timeout=60)
        for _ in range(6):
            results[i].append(rt.decompress(blobs[i]))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
        assert not th.is_alive()
    for x, got in zip(datas, results):
        assert len(got) == 6 and all(g == x.tobytes() for g in got)


@pytest.mark.parametrize("size,pinned", [(10**8, 1), (1024, 0)])
def test_decompress_records_one_pinned_span_per_large_fetch(dev, size,
                                                            pinned):
    from torch.profiler import ProfilerActivity, profile

    data = skewed(size, seed=31)
    blob = rt.compress(data)
    rt.decompress(blob)  # the ring is made outside the profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = rt.decompress(blob)
    assert out == data.tobytes()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU]
    assert names.count("rans.pinned") == pinned
    assert names.count("rans.fetch") == 1


# --- stack_blocks: a launch group's words straight from the blob ----------

STAGE_CASES = [(rt.Variant.WORD, 11, 12), (rt.Variant.BYTE, 14, 5),
               (rt.Variant.ALIAS, 14, 5), (rt.Variant.RANS64, 14, 5)]


def _stage_blob(variant, pb, n_blocks):
    """``n_blocks`` blocks of 2^18 (the last 100,003 bytes), every one
    coded: the full blocks make one launch group, the tail another."""
    cfg = rt.RansConfig(variant=variant, prob_bits=pb, n_lanes=1024,
                        block_symbols=1 << 18)
    data = skewed(((n_blocks - 1) << 18) + 100_003, seed=n_blocks + pb)
    blob = rt.compress(data, cfg)
    return cfg, data, blob


@pytest.mark.parametrize("variant,pb,n_blocks", STAGE_CASES,
                         ids=[v.name for v, _, _ in STAGE_CASES])
def test_decode_groups_upload_the_blobs_span(dev, monkeypatch, variant, pb,
                                             n_blocks):
    """Every entry point of the card decodes a ``bytes`` blob byte-equal,
    each launch group uploading the blob's own span (no host join), and
    returns nothing that aliases the blob."""
    cfg, data, blob = _stage_blob(variant, pb, n_blocks)
    assert rt.utils.container.unpack(blob).raw is None
    runs, run_of = [], codec.run_of

    def spy(arrays):
        runs.append(run_of(arrays))
        return runs[-1]
    monkeypatch.setattr(codec, "run_of", spy)
    whole = np.frombuffer(blob, np.uint8)
    B = cfg.block_symbols
    assert rt.decompress(blob) == data.tobytes()
    t = rt.decompress_to_device(blob)
    assert t.device.type == dev.type
    assert torch.equal(t.cpu(), torch.from_numpy(data))
    for b in (n_blocks // 2, n_blocks - 1):
        assert rt.decompress_block(blob, b) == data[b * B:(b + 1) * B] \
            .tobytes()
    # two groups for decompress and decompress_to_device, one a block
    assert len(runs) == 6
    assert all(r is not None and np.shares_memory(r, whole) for r in runs)


def test_traced_decompress_keeps_one_wait_and_put_per_group(dev):
    """A traced ``decompress`` of the 12-block WORD container: the tables'
    wait and upload, one wait and one upload per launch group (the full
    blocks, the tail), and the fetch's wait."""
    from torch.profiler import ProfilerActivity, profile

    _, data, blob = _stage_blob(rt.Variant.WORD, 11, 12)
    rt.decompress(blob)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = rt.decompress(blob)
    assert out == data.tobytes()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU]
    assert names.count("rans.stage") == 2
    assert names.count("rans.wait") == 4
    assert names.count("rans.put") == 3
    assert names.count("rans.fetch") == 1
