"""The launch plan of the cluster decoders K1 (WORD), K3 (BYTE, ALIAS) and K5
(RANS64), ``ryg_rans_tpu_torch.ops.decode_plan``, at every shape the kernels
take.
The plan is plain Python, so it is checked here without a card; the
kernels check it again on the card (``tests/test_torch_cuda.py``)."""

import pytest

from ryg_rans_tpu_torch.ops import decode_plan as dp

SHAPES = [(v, n, pb) for v in dp.VARIANTS for n in dp.LANE_COUNTS
          for pb in range(9, dp.MAX_PROB_BITS[v] + 1)]


def check_plan(p: dp.DecodePlan) -> None:
    # the CTAs cover the N lanes exactly, in rank order
    ranges = p.lane_ranges()
    assert len(ranges) == p.cluster
    assert ranges[0][0] == 0 and ranges[-1][1] == p.n_lanes
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(end - first == p.threads * p.lanes_per_thread
               for first, end in ranges)
    # C a power of two, at most 16; whole warps; L a power of two <= 16
    assert p.cluster in (1, 2, 4, 8, 16)
    assert p.threads % 32 == 0 and 32 <= p.threads <= dp.MAX_THREADS
    assert p.lanes_per_thread in (1, 2, 4, 8, 16)
    # the ring holds at least two windows of one step's maximum: 2 bytes a
    # lane (BYTE, ALIAS), one 2-byte word a lane (WORD) or one 4-byte word a
    # lane (RANS64)
    unit = 4 if p.variant == "RANS64" else 2
    assert p.window_bytes == unit * p.n_lanes
    assert p.ring_bytes >= 2 * p.window_bytes
    assert p.ring_bytes == dp.RING_CHUNKS * p.chunk_bytes
    assert 4 * p.chunk_bytes == p.window_bytes
    assert p.chunk_bytes % 16 == 0  # whole cp.async pieces
    assert p.chunk_bytes & (p.chunk_bytes - 1) == 0
    # dynamic shared memory: ring and tables, within what a CTA may use
    # with the kernels' static arrays beside it
    assert p.smem_bytes == p.ring_bytes + p.table_bytes
    assert p.smem_bytes + dp.STATIC_SHARED <= 232_448
    assert p.ring_bytes % 16 == 0  # the tables start aligned
    assert p.c_args() == (p.cluster, p.threads, p.chunk_bytes, p.smem_bytes)


@pytest.mark.parametrize("variant,n_lanes,prob_bits", SHAPES,
                         ids=[f"{v}-{n}-pb{pb}" for v, n, pb in SHAPES])
def test_default_plan(variant, n_lanes, prob_bits):
    p = dp.plan(variant, n_lanes, prob_bits)
    assert (p.variant, p.n_lanes, p.prob_bits) == (variant, n_lanes,
                                                   prob_bits)
    check_plan(p)
    # the default is portable (at most 8) and spreads a full-width block
    assert p.cluster <= 8
    assert p.cluster == max(1, min(8, n_lanes // dp.LANES_PER_CTA))


@pytest.mark.parametrize("variant", dp.VARIANTS)
@pytest.mark.parametrize("n_lanes", dp.LANE_COUNTS)
def test_every_cluster_size(variant, n_lanes):
    sizes = dp.cluster_sizes(n_lanes)
    assert sizes == sorted(sizes) and dp.plan(variant, n_lanes,
                                              12).cluster in sizes
    for c in sizes:
        top = 15 if variant == "WORD" else 16
        for pb in (9, 12, top) + ((24, 31) if variant == "RANS64" else ()):
            p = dp.plan(variant, n_lanes, pb, cluster=c)
            assert p.cluster == c
            check_plan(p)


def test_full_width_spreads_over_a_cluster():
    for v in dp.VARIANTS:
        p = dp.plan(v, 16384, 14)
        assert p.cluster == 8 and p.threads * p.lanes_per_thread == 2048
        assert 16 in dp.cluster_sizes(16384)
    assert dp.plan("BYTE", 16384, 16).ring_bytes == 73_728
    assert dp.plan("RANS64", 16384, 16).smem_bytes == 215_056
    word = dp.plan("WORD", 16384, 15)
    assert (word.ring_bytes, word.smem_bytes) == (73_728, 107_520)


@pytest.mark.parametrize("args", [
    ("WORD", 1024, 16), ("BYTE", 64, 12), ("BYTE", 3000, 12),
    ("BYTE", 32768, 12), ("BYTE", 1024, 8), ("ALIAS", 1024, 17),
    ("RANS64", 1024, 32)])
def test_plan_rejects_shapes_the_kernels_do_not_take(args):
    with pytest.raises(ValueError):
        dp.plan(*args)


@pytest.mark.parametrize("n_lanes,cluster", [(128, 2), (16384, 32),
                                             (16384, 1), (1024, 3)])
def test_plan_rejects_cluster_sizes_outside_the_shape(n_lanes, cluster):
    with pytest.raises(ValueError):
        dp.plan("BYTE", n_lanes, 12, cluster=cluster)


@pytest.mark.parametrize("variant", dp.VARIANTS)
def test_for_shape_takes_the_default_or_a_plan_of_the_shape(variant):
    assert dp.for_shape(None, variant, 16384, 12) == dp.plan(variant, 16384,
                                                             12)
    other_c = dp.plan(variant, 16384, 12, cluster=16)
    assert dp.for_shape(other_c, variant, 16384, 12) is other_c
    for lanes, pb in ((8192, 12), (16384, 13)):
        with pytest.raises(ValueError, match="is not for"):
            dp.for_shape(other_c, variant, lanes, pb)
    wrong = "BYTE" if variant != "BYTE" else "ALIAS"
    with pytest.raises(ValueError, match="is not for"):
        dp.for_shape(other_c, wrong, 16384, 12)
