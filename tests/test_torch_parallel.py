"""The port's process-parallel layer (``ryg_rans_tpu_torch.parallel``)
against the JAX package: block ownership, the single-process gather, and
one spawned gloo group of 4 CPU ranks running the reference's multi-device
dry run (``__graft_entry__.dryrun_multichip``: the four variants, n + 1
ragged blocks) and a ragged multi-process round trip, every container
equal to the reference's ``compress(..., backend="numpy")``."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_parallel_worker as worker
from ryg_rans_tpu.api import compress as ref_compress
from ryg_rans_tpu.config import RansConfig as RefConfig, Variant as RefVariant
from ryg_rans_tpu.models import stats as ref_stats
from ryg_rans_tpu.ops import reference_numpy as ref_oracle
from ryg_rans_tpu.parallel import multihost as ref_multihost
from ryg_rans_tpu_torch import api
from ryg_rans_tpu_torch.config import RansConfig, Variant
from ryg_rans_tpu_torch.models import stats
from ryg_rans_tpu_torch.ops import word
from ryg_rans_tpu_torch.parallel import mesh as pmesh
from ryg_rans_tpu_torch.parallel import multihost

WORLD = 4


def _ref_cfg(cfg: RansConfig) -> RefConfig:
    return RefConfig(variant=RefVariant(int(cfg.variant)),
                     prob_bits=cfg.prob_bits, n_lanes=cfg.n_lanes,
                     lanes_per_stream=cfg.lanes_per_stream,
                     block_symbols=cfg.block_symbols, checksum=cfg.checksum)


@pytest.mark.parametrize("n_blocks,P", [(8, 3), (5, 2), (9, 8), (3, 5),
                                        (7, 1), (16, 4)])
def test_block_range_of_matches_reference(n_blocks, P):
    """Ragged ownership: contiguous, ordered, covering [0, n_blocks), the
    first n_blocks % P processes one block more -- the reference's
    spans."""
    spans = [multihost.block_range_of(n_blocks, p, P) for p in range(P)]
    assert spans == [ref_multihost.block_range_of(n_blocks, p, P)
                     for p in range(P)]
    assert spans[0][0] == 0 and spans[-1][1] == n_blocks
    base, rem = divmod(n_blocks, P)
    assert [b - a for a, b in spans] == [base + (p < rem) for p in range(P)]


def test_single_process_ownership_and_gather():
    """With no process group: one process owning every block, and the
    gather hands the payloads back."""
    assert not dist.is_initialized()
    assert (multihost.process_count(), multihost.process_index()) == (1, 0)
    assert multihost.local_block_range(8) == (0, 8)
    ps = [np.arange(5, dtype=np.uint16), np.arange(3, dtype=np.uint16)]
    got = multihost.allgather_payloads(ps, cap_words=16)
    assert all(np.array_equal(a, b) for a, b in zip(got, ps))


def test_local_block_range_ragged(monkeypatch):
    monkeypatch.setattr(multihost, "process_count", lambda group=None: 3)
    monkeypatch.setattr(multihost, "process_index", lambda group=None: 0)
    assert multihost.local_block_range(8) == (0, 3)
    monkeypatch.setattr(multihost, "process_index", lambda group=None: 2)
    assert multihost.local_block_range(8) == (6, 8)


@pytest.mark.parametrize("tail", [0, 1000])
def test_single_process_multihost_matches_reference(tail):
    """compress_multihost / decompress_multihost in one process, on the
    plain versions: the reference's payloads, and its container once
    packed."""
    cfg = RansConfig(prob_bits=12, n_lanes=128, block_symbols=2048)
    data = worker.skewed(4 * 2048 + tail, 3)
    freqs, cum = stats.build_model(data, 12)
    padded = word.pad_block(torch.from_numpy(data), 128, freqs).numpy()
    payloads = multihost.compress_multihost(padded, cfg, freqs, cum,
                                            device="cpu")
    assert len(payloads) == 4 + (tail > 0)
    out = multihost.decompress_multihost(payloads, cfg, padded.size, freqs,
                                         cum, device="cpu")
    assert np.array_equal(out, padded)
    ref = _ref_cfg(cfg)
    B = cfg.block_symbols
    for b, p in enumerate(payloads):
        want = ref_oracle.encode(ref, padded[b * B:(b + 1) * B], freqs, cum)
        assert np.array_equal(p, want[0])
    blob = api._pack_container(cfg, data.size, freqs,
                               [[p] for p in payloads], padded.size, None,
                               data)
    assert blob == ref_compress(data.tobytes(), ref, backend="numpy")


def test_make_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.make_mesh(1, "cpu")


def test_four_rank_gloo_group_matches_reference(tmp_path):
    """4 spawned CPU ranks over gloo: the sharded model equals the
    single-process one, each rank's roundtrip_step is exact (checked in
    the rank), the gathered blocks give the reference's containers, and
    the ragged multi-process round trip is exact on every rank."""
    worker.spawn(worker.run, WORLD,
                 (str(tmp_path / "store"), str(tmp_path), "cpu"), timeout=240)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(WORLD)]

    for i, (name, pb, data) in enumerate(worker.dryrun_inputs(WORLD)):
        cfg = RansConfig(variant=Variant[name], prob_bits=pb,
                         n_lanes=worker.LANES, block_symbols=worker.BLOCK)
        ref = _ref_cfg(cfg)
        freqs, cum = ref_stats.build_model(data, pb)
        blocks = []
        for r in ranks:
            assert np.array_equal(r[f"dry{i}_freqs"], freqs)
            for g in range(int(r[f"dry{i}_groups"])):
                heads = r[f"dry{i}_g{g}_heads"]
                blocks += word.assemble_blocks(
                    heads, r[f"dry{i}_g{g}_body"], r[f"dry{i}_g{g}_counts"])
        n_blocks = data.size // worker.BLOCK
        assert len(blocks) == n_blocks  # ragged: world + 1 over world
        wdt = {Variant.WORD: np.uint16, Variant.RANS64: np.uint32}.get(
            cfg.variant, np.uint8)
        payloads = [[b.view(wdt)] for b in blocks]
        # random bytes: the container stores the blocks raw, so the words
        # are held against the reference's oracle block by block
        B = worker.BLOCK
        for b, (p,) in enumerate(payloads):
            want = ref_oracle.encode(ref, data[b * B:(b + 1) * B], freqs, cum)
            assert np.array_equal(p, want[0]), (name, b)
        blob = api._pack_container(cfg, data.size, freqs, payloads,
                                   data.size, None, data)
        assert blob == ref_compress(data.tobytes(), ref, backend="numpy"), \
            name

    data = worker.multihost_input(WORLD)
    cfg = RansConfig(prob_bits=12, n_lanes=worker.LANES,
                     block_symbols=worker.BLOCK)
    freqs, _ = ref_stats.build_model(data, 12)
    n = int(ranks[0]["mh_n"])
    assert n == 2 * WORLD + 1
    first = [ranks[0][f"mh_p{b}"] for b in range(n)]
    for r in ranks:
        assert np.array_equal(r["mh_freqs"], freqs)
        assert all(np.array_equal(r[f"mh_p{b}"], first[b]) for b in range(n))
    padded = -(-data.size // (4 * worker.LANES)) * 4 * worker.LANES
    blob = api._pack_container(cfg, data.size, freqs, [[p] for p in first],
                               padded, None, data)
    assert blob == ref_compress(data.tobytes(), _ref_cfg(cfg),
                                backend="numpy")
