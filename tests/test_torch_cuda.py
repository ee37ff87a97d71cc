"""The WORD kernels on the card against their plain PyTorch versions, and
the entry points on the card against ``device="cpu"``.  Exact equality
throughout: the codec has no tolerance.

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

from _torch_corpora import CORPORA, random_bytes, skewed
import ryg_rans_tpu_torch as rt
from ryg_rans_tpu_torch.models import stats
from ryg_rans_tpu_torch.ops import host_prep, word

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


def test_raw_blocks_on_card(dev):
    cfg = rt.RansConfig(prob_bits=12, n_lanes=128, block_symbols=1 << 12)
    data = np.concatenate([skewed(1 << 12, seed=4), random_bytes(1 << 12, 5),
                           skewed(99, seed=6)])
    blob = rt.compress(data, cfg)
    assert blob == rt.compress(data, cfg, device="cpu")
    assert rt.decompress(blob) == data.tobytes()
    assert torch.equal(rt.decompress_to_device(blob),
                       torch.from_numpy(data).to(dev))
