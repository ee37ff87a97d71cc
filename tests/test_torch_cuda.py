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

import dataclasses

import numpy as np
import pytest
import torch

from _torch_corpora import CORPORA, dominant, random_bytes, skewed
import ryg_rans_tpu_torch as rt
from ryg_rans_tpu_torch.models import stats
from ryg_rans_tpu_torch.ops import byte, host_prep, rans64, word

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
    blocks = word.encode(cfg, syms.view(-1), freqs, cum)
    c2s, fd, cd = (torch.from_numpy(a).to(dev)
                   for a in host_prep.dec_tables(freqs, cum, pb))
    stream = word.prep_decode(blocks, N, dev)
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
        stream = word.prep_decode([blocks[0][:cut]], N, dev)
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
    blocks = byte.encode(cfg, syms.view(-1), freqs, cum)
    tables = byte.dec_tables(cfg, freqs, cum, dev)
    stream = byte.prep_decode(blocks, N, dev)
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
    blocks = rans64.encode(cfg, syms.view(-1), freqs, cum)
    tables = rans64.dec_tables(cfg, freqs, cum, dev)
    stream = rans64.prep_decode(blocks, N, dev)
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
        stream = mod.prep_decode([blocks[0][:cut]], N, dev)
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
    return {rt.Variant.WORD: word, rt.Variant.RANS64: rans64}.get(variant,
                                                                  byte)


def _encode_blocks(dev, data, variant, N, pb, B):
    """Container blocks of ``data`` and the decode tables, on the card."""
    cfg = rt.RansConfig(variant=variant, prob_bits=pb, n_lanes=N,
                        block_symbols=B)
    mod = _module(variant)
    freqs, cum = stats.build_model(data, pb)
    syms = torch.from_numpy(data).to(dev)
    if variant == rt.Variant.WORD:
        tables = tuple(torch.from_numpy(a).to(dev)
                       for a in host_prep.dec_tables(freqs, cum, pb))
    else:
        tables = mod.dec_tables(cfg, freqs, cum, dev)
    return mod.encode(cfg, syms, freqs, cum), tables


def _decode_vs_plain(dev, variant, blocks, tables, N, pb, B, plan=None):
    """Decode ``blocks`` as one launch group with the kernel and with its
    plain version; assert they agree; return the kernel's output."""
    if variant == rt.Variant.WORD:
        stream = word.prep_decode(blocks, N, dev)
        before = word.decode_blocks.launches
        out = word.decode_blocks(*stream, *tables, B, pb, plan=plan)
        assert word.decode_blocks.launches == before + 1
        out_r = word.decode_blocks_ref(*stream, *tables, B, pb)
    elif variant == rt.Variant.RANS64:
        stream = rans64.prep_decode(blocks, N, dev)
        before = rans64.decode_blocks.launches
        out = rans64.decode_blocks(*stream, *tables, B, pb, plan=plan)
        assert rans64.decode_blocks.launches == before + 1
        out_r = rans64.decode_blocks_ref(*stream, *tables, B, pb)
    else:
        alias = variant == rt.Variant.ALIAS
        stream = byte.prep_decode(blocks, N, dev)
        before = byte.decode_blocks.launches
        out = byte.decode_blocks(*stream, tables, B, pb, alias, plan=plan)
        assert byte.decode_blocks.launches == before + 1
        out_r = byte.decode_blocks_ref(*stream, tables, B, pb, alias)
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
    padded = word.pad_block(torch.from_numpy(data), cfg.n_lanes, freqs)
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
