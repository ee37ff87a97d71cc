"""The port's spans on the CPU: which spans each entry point records, how
they nest, that every blocking copy follows a drain of the stream, how
many drains a call makes, and that with no profiler running no span is
entered at all.

The device path runs here on ``device="cpu"`` (the kernels' plain
versions) and records the same spans as on the card: a ``rans.wait`` marks
the point where the card's stream drains, though on the CPU it drains
nothing.  ``tests/test_torch_cuda.py`` checks on the card that every
synchronisation falls inside one.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_corpora import random_bytes, skewed
import ryg_rans_tpu_torch as rt
from ryg_rans_tpu_torch.utils import container as tcont
from ryg_rans_tpu_torch.utils import profiling

VARIANTS = [rt.Variant.WORD, rt.Variant.BYTE, rt.Variant.ALIAS,
            rt.Variant.RANS64]
ENTRIES = ["compress", "compress_from_device", "decompress",
           "decompress_to_device", "decompress_block"]
OPS_SPANS = {"rans.tables", "rans.stage", "rans.launch", "rans.compact",
             "rans.assemble"}
B = 4096


def _data(shape: str) -> np.ndarray:
    """``tail``: two full blocks and a short one, no raw block, so encode
    and decode make two launch groups each.  ``raw``: a block of random
    bytes between two text blocks, stored raw; the coded blocks still
    make two decode groups."""
    if shape == "tail":
        return skewed(2 * B + 3500, seed=5)
    return np.concatenate([skewed(B, seed=6), random_bytes(B, seed=7),
                           skewed(3500, seed=8)])


#: rans.wait spans per call, by shape and entry point, for every variant:
#: compress: input 1, model 2 (bincount, the histogram's fetch), tables 1,
#: each encode group 2 (the select, the fetch); decode: tables 1, each
#: decode group 1, the raw blocks' upload 1, the output's fetch 1;
#: compress_from_device fetches each raw block's bytes (1 each).
WAITS = {
    ("tail", "compress"): 8, ("tail", "compress_from_device"): 7,
    ("tail", "decompress"): 4, ("tail", "decompress_to_device"): 3,
    ("tail", "decompress_block"): 3,
    ("raw", "compress"): 8, ("raw", "compress_from_device"): 8,
    ("raw", "decompress"): 5, ("raw", "decompress_to_device"): 4,
    ("raw", "decompress_block"): 3,
}


def _cfg(variant) -> rt.RansConfig:
    return rt.RansConfig(variant=variant, prob_bits=11, n_lanes=128,
                         block_symbols=B, checksum=False)


def _call(entry: str, data: np.ndarray, cfg, blob: bytes):
    """One call of ``entry`` on ``data`` (or its container ``blob``) and
    what it should return.  decompress_block decodes the middle block,
    the raw one in the ``raw`` shape."""
    if entry == "compress":
        return (lambda: rt.compress(data.tobytes(), cfg, device="cpu"),
                blob)
    if entry == "compress_from_device":
        return (lambda: rt.compress_from_device(torch.from_numpy(data),
                                                cfg), blob)
    if entry == "decompress":
        return lambda: rt.decompress(blob, device="cpu"), data.tobytes()
    if entry == "decompress_to_device":
        return (lambda: rt.decompress_to_device(blob, device="cpu").numpy()
                .tobytes(), data.tobytes())
    return (lambda: rt.decompress_block(blob, 1, device="cpu"),
            data[B:2 * B].tobytes())


def _spans(fn):
    """(fn's result, its rans.* spans as (start, end, name) by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events() if e.name.startswith("rans."))


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("shape", ["tail", "raw"])
@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: v.name)
def test_span_structure(variant, entry, shape):
    data, cfg = _data(shape), _cfg(variant)
    blob = rt.compress(data, cfg, device="cpu")
    assert (tcont.unpack(blob).raw is not None) == (shape == "raw")
    fn, want = _call(entry, data, cfg, blob)
    out, spans = _spans(fn)
    assert out == want
    names = [n for _, _, n in spans]
    assert set(names) <= set(profiling.SPANS)
    coders = [s for s in spans if s[2] in ("rans.encode", "rans.decode")]
    for s in spans:
        if s[2] in OPS_SPANS:
            assert any(_inside(s, c) for c in coders), s
    for i, s in enumerate(spans):
        if s[2] in ("rans.put", "rans.fetch"):
            # the span just before is the drain, and it has ended
            assert spans[i - 1][2] == "rans.wait" and spans[i - 1][1] <= s[0]
    assert names.count("rans.wait") == WAITS[shape, entry], names
    if entry.startswith("compress"):
        assert names.count("rans.launch") == 2
        assert names.count("rans.compact") == names.count("rans.assemble")


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: v.name)
def test_no_span_is_entered_without_a_profiler(variant, monkeypatch):
    data, cfg = _data("raw"), _cfg(variant)
    blob = rt.compress(data, cfg, device="cpu")

    def refuse(self):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.autograd.profiler.record_function,
                        "__enter__", refuse)
    with pytest.raises(AssertionError, match="no profiler"):
        with torch.profiler.record_function("rans.x"):
            pass
    assert rt.compress(data.tobytes(), cfg, device="cpu") == blob
    assert rt.compress_from_device(torch.from_numpy(data), cfg) == blob
    assert rt.decompress(blob, device="cpu") == data.tobytes()
    assert torch.equal(rt.decompress_to_device(blob, device="cpu"),
                       torch.from_numpy(data))
    assert rt.decompress_block(blob, 1, device="cpu") == \
        data[B:2 * B].tobytes()


def test_copy_helpers_batch_their_copies_under_one_wait():
    a, b = np.arange(5, dtype=np.int32), np.ones(3, np.uint8)
    (ta, none, tb), spans = _spans(
        lambda: profiling.to_device(a, None, b, device="cpu"))
    assert none is None and ta.tolist() == a.tolist() and tb.dtype == \
        torch.uint8
    assert [n for _, _, n in spans] == ["rans.wait", "rans.put"]
    (ha, hb), spans = _spans(lambda: profiling.to_host(ta, tb))
    assert isinstance(ha, np.ndarray) and ha.tolist() == a.tolist()
    assert [n for _, _, n in spans] == ["rans.wait", "rans.fetch"]
    one, spans = _spans(lambda: profiling.to_host(ta))
    assert isinstance(one, np.ndarray) and len(spans) == 2


@pytest.mark.parametrize("entry", ENTRIES)
def test_no_cpu_call_stages_through_the_pinned_ring(entry):
    """``rans.pinned`` is a span of the package, and only a CUDA tensor's
    fetch records it: no call on the CPU does."""
    assert "rans.pinned" in profiling.SPANS
    data, cfg = _data("raw"), _cfg(rt.Variant.WORD)
    blob = rt.compress(data, cfg, device="cpu")
    fn, want = _call(entry, data, cfg, blob)
    out, spans = _spans(fn)
    assert out == want
    names = [n for _, _, n in spans]
    assert ("rans.fetch" in names) == (entry != "decompress_to_device")
    assert "rans.pinned" not in names


def test_span_is_a_shared_no_op_without_a_profiler():
    assert profiling.span("rans.encode") is profiling.span("rans.decode")
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("rans.encode") is not \
            profiling.span("rans.encode")
