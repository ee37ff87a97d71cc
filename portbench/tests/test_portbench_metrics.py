"""The metric arithmetic on synthetic records: the tail over all calls,
the union of device intervals, the gaps' attribution, and roofline bytes
read from a container."""

import dataclasses
import statistics

import numpy as np
import pytest

from portbench import harness, readers
from portbench.program import Program
from portbench.reference import codec, container
from portbench.reference.config import Shape
from portbench.trace import WINDOW, Trace

KERNELS = harness.load_kernels()
ENCODE_BYTES = readers.byte_rule("word_encode", KERNELS["word_encode"])
DECODE_BYTES = readers.byte_rule("word_decode", KERNELS["word_decode"])


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


def test_traced_compress_p90_reads_the_traced_encode_calls_alone():
    """``api.call_p90_ms.compress`` is ``call_p90_ms`` of the traced
    passes: every encode call, failed ones too; nothing untraced."""
    lat = [0.2, 0.25, 0.21, 0.4, 0.22, 0.23, 0.3, 0.24]
    calls = [harness.Call("encode", i % 4, 10**8, v, i != 3)
             for i, v in enumerate(lat)]
    reader = harness.load_module("metrics", "api.call_p90_ms.compress")
    traced = _ctx(calls, direction="encode", trace=_trace())
    assert reader.read(traced) == pytest.approx(
        readers.quantile(lat, 0.9) * 1e3)
    assert reader.read(_ctx(calls, direction="encode")) is None
    assert reader.read(_ctx([], direction="encode", trace=_trace())) is None
    assert harness.load_module("metrics", "call_p90_ms").read(traced) is None


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
    assert DECODE_BYTES(h) == 2048 + sum(s + 2 * c for s, c in coded)
    assert ENCODE_BYTES(h) == DECODE_BYTES(h) + 4096 + 4096
    assert all(2 * c >= 4 * 128 for _, c in coded)  # heads are in counts


def test_roofline_share_reads_kernel_time_and_skips_unknown_cards():
    h = container.read_header(codec.compress(
        np.full(5000, 7, np.uint8), Shape("WORD", 10, 128, 4096, False)))
    call = harness.Call("decode", 0, 5000, 1.0, True, header=h)
    t = Trace([], [("void word_decode_kernel<2>(Args)", 0, 10)], (0, 20))
    ctx = _ctx([call], trace=t)
    share = readers.roofline_share(ctx, "word_decode")
    assert share == pytest.approx(100 * DECODE_BYTES(h) / 3.35e12 / 10e-6)
    assert readers.roofline_share(ctx, "word_encode") is None
    assert readers.roofline_share(
        _ctx([call], trace=t, device_kind="cpu"), "word_decode") is None


def test_launches_per_call_sum_the_direction_kernels():
    ctx = _ctx([harness.Call("encode", 0, 1, 1, True)] * 4,
               direction="encode", trace=_trace(),
               launches={"word_encode": 6, "byte_encode": 2,
                         "word_decode": 100})
    assert readers.launches_per_call(ctx, "encode") == 2.0


@pytest.mark.parametrize("crc_launches", [40, None])
def test_launches_per_call_count_the_direction_coders_alone(crc_launches):
    """A kernel of both directions stays out of ``ops.launches_per_call.*``
    whether or not the program keeps its counter, and a coder that the
    program keeps no counter of leaves the metric unread."""
    kernels = dict(KERNELS, crc_check={
        "symbol": "crc_kernel", "direction": "both",
        "variants": ["WORD"], "counter": "ryg_rans_tpu_torch.ops.crc:f"})
    calls = [harness.Call("encode", 0, 1, 1, True)] * 4
    ctx = _ctx(calls, direction="encode", trace=_trace(), kernels=kernels,
               launches={"word_encode": 6, "byte_encode": 2,
                         "word_decode": 100, "crc_check": crc_launches})
    assert harness.load_module(
        "metrics", "ops.launches_per_call.compress").read(ctx) == 2.0
    ctx.launches["byte_encode"] = None
    assert readers.launches_per_call(ctx, "encode") is None


def test_a_missing_counter_reads_none(tmp_path, monkeypatch):
    """A counter whose module or function the program lacks gives None;
    a module that is there but fails to import still raises."""
    assert Program.launches("ryg_rans_tpu_torch.ops.word:encode_blocks") \
        >= 0
    assert Program.launches("ryg_rans_tpu_torch.ops.crc:check_blocks") is None
    assert Program.launches("ryg_rans_tpu_torch.ops.word:check_blocks") \
        is None
    assert Program.launches("no_such_package.ops:check_blocks") is None
    (tmp_path / "pb_broken_module.py").write_text(
        "import pb_no_such_dependency\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    with pytest.raises(ModuleNotFoundError, match="pb_no_such_dependency"):
        Program.launches("pb_broken_module:check_blocks")


def _header(variant, pb, lanes, block_symbols, orig_len, counts, raw, crc):
    return container.Header(variant, pb, lanes, block_symbols, orig_len,
                            np.array(counts, np.int64), np.array(raw, bool),
                            crc)


#: Fixed headers (coded blocks, a raw block, a tail) and the bytes that the
#: coder rules counted as ``roofline.encode_bytes`` / ``decode_bytes``
#: before they moved to ``rooflines/``.
FIXED = [
    (_header("WORD", 11, 16384, 1 << 23, 10**8,
             [2_500_000 + 1000 * i for i in range(11)] + [500_000],
             [False] * 4 + [True] + [False] * 7, True),
     153_615_984, 142_723_376),
    (_header("BYTE", 12, 1024, 1 << 15, 70_000, [20_000, 32_768, 4_000],
             [False, True, False], False), 132_544, 67_008),
    (_header("RANS64", 14, 2048, 1 << 20, 8191, [3000], [False], False),
     22_240, 22_240),
]


@pytest.mark.parametrize("h,encode,decode", FIXED)
def test_coder_rules_count_the_bytes_they_always_did(h, encode, decode):
    assert (ENCODE_BYTES(h), DECODE_BYTES(h)) == (encode, decode)
    assert ENCODE_BYTES(dataclasses.replace(h, crc=not h.crc)) == encode


@pytest.mark.parametrize("checksum", [True, False])
def test_header_crc_follows_the_flag(checksum):
    blob = codec.compress(np.arange(3000, dtype=np.uint8) % 7,
                          Shape("WORD", 10, 128, 4096, checksum))
    assert blob[9] & container.FLAG_CRC == checksum
    assert container.read_header(blob).crc is checksum


def test_an_idle_gap_goes_to_the_innermost_span_however_far_back():
    """Fifteen spans start between ``rans.encode`` and a gap inside it and
    none of them holds the gap: it still goes to ``rans.encode``."""
    host = [("portbench.encode", 0, 300), ("rans.encode", 1, 250)]
    host += [("rans.wait", 10 + 10 * i, 15 + 10 * i) for i in range(12)]
    host += [("rans.compact", 140, 190), ("rans.wait", 141, 142),
             ("rans.put", 143, 144)]
    device = [("k", 0, 150), ("k", 170, 205), ("k", 215, 300),
              ("k", 320, 400)]
    gaps = dict(Trace(host, device, (0, 400)).breakdown()["idle_gaps"])
    assert gaps == {"rans.compact": pytest.approx(20e-6),  # 150-170
                    "rans.encode": pytest.approx(10e-6),   # 205-215
                    "harness": pytest.approx(20e-6)}       # 300-320


def test_window_span_is_required():
    class E:
        def __init__(self):
            from torch.autograd import DeviceType
            self.name, self.device_type = "rans.crc", DeviceType.CPU
            self.time_range = type("R", (), {"start": 0, "end": 1})()
    from portbench.trace import from_profiler
    with pytest.raises(RuntimeError, match=WINDOW):
        from_profiler([E()])
