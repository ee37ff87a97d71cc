"""The metric arithmetic on synthetic records: the tail over all calls,
the union of device intervals, the gaps' attribution, and roofline bytes
read from a container."""

import statistics

import numpy as np
import pytest

from portbench import harness, readers, roofline
from portbench.reference import codec, container
from portbench.reference.config import Shape
from portbench.trace import WINDOW, Trace


def test_p90_is_the_inclusive_quantile_over_every_call():
    rng = np.random.default_rng(3)
    for n in (1, 2, 10, 101, 150):
        v = list(rng.exponential(size=n))
        want = v[0] if n == 1 else statistics.quantiles(
            v, n=10, method="inclusive")[8]
        assert readers.quantile(v, 0.9) == pytest.approx(want)


def _ctx(calls, **kw):
    base = dict(direction="decode", calls=calls, window_s=2.0, setup_s=9.0,
                on_card=True, device_kind="NVIDIA H100 80GB HBM3",
                kernels=harness.load_kernels())
    base.update(kw)
    return harness.Context(**base)


def test_end_to_end_metrics_count_every_call():
    calls = [harness.Call("decode", i % 3, 10**8, 0.1 * (i + 1), i != 4)
             for i in range(10)]
    ctx = _ctx(calls, peaks=[2**20 * (i + 1) for i in range(3)][::-1])
    assert readers.gbps(ctx, "decode") == pytest.approx(9 * 10**8 / 2 / 1e9)
    assert readers.gbps(ctx, "encode") is None
    p90 = harness.load_module("metrics", "call_p90_ms").read(ctx)
    assert p90 == pytest.approx(readers.quantile(
        [0.1 * (i + 1) for i in range(10)], 0.9) * 1e3)  # failed one too
    assert harness.load_module("metrics", "peak_mem_MiB").read(ctx) == 3


def _trace():
    host = [("portbench.decode", 0, 40), ("rans.unpack", 1, 10),
            ("rans.decode", 10, 30), ("rans.crc", 30, 39),
            ("portbench.decode", 50, 90), ("rans.unpack", 51, 60)]
    device = [("k", 12, 20), ("Memcpy HtoD (Pageable -> Device)", 15, 25),
              ("k", 60, 70), ("Memset (Device)", 95, 130)]
    return Trace(host, device, (0, 100))


def test_union_idle_share_and_gaps():
    t = _trace()
    assert t.busy() == [(12, 25), (60, 70), (95, 100)]
    assert t.busy_s() == pytest.approx(28e-6)
    assert t.window_s == pytest.approx(100e-6)
    ctx = _ctx([harness.Call("decode", 0, 1, 1, True)] * 2, trace=t)
    assert readers.idle_share(ctx, "decode") == pytest.approx(72.0)
    assert readers.copy_ms_per_call(ctx, "decode") == pytest.approx(5e-3)
    assert readers.host_ms_per_call(ctx, "decode", ("rans.unpack",
                                                    "rans.crc")) \
        == pytest.approx((9 + 9 + 9) / 2 * 1e-3)
    b = t.breakdown()
    assert b["device_ops"][0] == ["k", pytest.approx(18e-6)]
    gaps = dict(b["idle_gaps"])
    assert gaps["rans.unpack"] == pytest.approx(12e-6)  # 0-12
    assert gaps["harness"] == pytest.approx(35e-6)      # 25-60
    assert gaps["call outside rans spans"] == pytest.approx(25e-6)  # 70-95


def test_roofline_bytes_from_a_container_with_a_raw_block():
    rng = np.random.default_rng(0)
    text = rng.integers(65, 69, 9000, dtype=np.uint8)
    noise = rng.integers(0, 256, 4096, dtype=np.uint8)
    data = np.concatenate([text[:4096], noise, text[4096:]])
    blob = codec.compress(data, Shape("WORD", 10, 128, 4096, True))
    h = container.read_header(blob)
    assert list(h.raw) == [False, True, False, False]
    assert h.block_sizes() == [4096, 4096, 4096, 1024]
    assert h.counts[1] == 4096  # the raw block's bytes
    coded = [(s, int(c)) for s, c, r in zip(h.block_sizes(), h.counts, h.raw)
             if not r]
    assert roofline.decode_bytes(h) == 2048 + sum(s + 2 * c
                                                  for s, c in coded)
    assert roofline.encode_bytes(h) == roofline.decode_bytes(h) + 4096 + 4096
    assert all(2 * c >= 4 * 128 for _, c in coded)  # heads are in counts


def test_roofline_share_reads_kernel_time_and_skips_unknown_cards():
    h = container.read_header(codec.compress(
        np.full(5000, 7, np.uint8), Shape("WORD", 10, 128, 4096, False)))
    call = harness.Call("decode", 0, 5000, 1.0, True, header=h)
    t = Trace([], [("void word_decode_kernel<2>(Args)", 0, 10)], (0, 20))
    ctx = _ctx([call], trace=t)
    share = readers.roofline_share(ctx, "word_decode")
    assert share == pytest.approx(100 * roofline.decode_bytes(h)
                                  / 3.35e12 / 10e-6)
    assert readers.roofline_share(ctx, "word_encode") is None
    assert readers.roofline_share(
        _ctx([call], trace=t, device_kind="cpu"), "word_decode") is None


def test_launches_per_call_sum_the_direction_kernels():
    ctx = _ctx([harness.Call("encode", 0, 1, 1, True)] * 4,
               direction="encode", trace=_trace(),
               launches={"word_encode": 6, "byte_encode": 2,
                         "word_decode": 100})
    assert readers.launches_per_call(ctx, "encode") == 2.0


def test_window_span_is_required():
    class E:
        def __init__(self):
            from torch.autograd import DeviceType
            self.name, self.device_type = "rans.crc", DeviceType.CPU
            self.time_range = type("R", (), {"start": 0, "end": 1})()
    from portbench.trace import from_profiler
    with pytest.raises(RuntimeError, match=WINDOW):
        from_profiler([E()])
