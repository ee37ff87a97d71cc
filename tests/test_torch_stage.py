"""``ops.codec.stack_blocks`` on the CPU: a launch group whose blocks lie
back to back in the blob ``unpack`` parsed uploads the blob's own span;
any other group is joined on the host first, as before.  Both give the
same four tensors, and neither hands out memory of the blob."""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_corpora import random_bytes, skewed
import ryg_rans_tpu_torch as rt
from ryg_rans_tpu_torch.models import stats
from ryg_rans_tpu_torch.ops import codec
from ryg_rans_tpu_torch.utils import container as tcont
from ryg_rans_tpu_torch.utils import profiling

B = 4096
VARIANTS = [rt.Variant.WORD, rt.Variant.BYTE, rt.Variant.ALIAS,
            rt.Variant.RANS64]


def _cfg(variant) -> rt.RansConfig:
    return rt.RansConfig(variant=variant, prob_bits=11, n_lanes=128,
                         block_symbols=B)


def _blob(variant, version: int, data=None) -> tuple[np.ndarray, bytes]:
    """Five full blocks and a tail, coded on the CPU; ``version`` 1 repacks
    the container, whose payload then starts at a multiple of 4."""
    data = skewed(5 * B + 3500, seed=int(variant) + 3) if data is None \
        else data
    blob = rt.compress(data, _cfg(variant), device="cpu")
    if version == 1:
        c = tcont.unpack(blob)
        blob = tcont.pack(c.cfg, c.orig_len, c.freqs, c.payloads, c.crcs,
                          c.raw, version=1)
    return data, blob


def _payload_start(blob: bytes) -> int:
    c = tcont.unpack(blob)
    return len(blob) - sum(s.nbytes for blk in c.payloads for s in blk)


def _spy(monkeypatch) -> list:
    """Record the words array of every ``to_device`` call of the codec."""
    seen = []

    def spy(*arrays, device):
        seen.append(arrays[0])
        return profiling.to_device(*arrays, device=device)
    monkeypatch.setattr(codec, "to_device", spy)
    return seen


def _in_blob(blob: bytes, ptr: int, nbytes: int) -> bool:
    """Whether [ptr, ptr + nbytes) overlaps the blob's memory."""
    lo = np.frombuffer(blob, np.uint8).ctypes.data
    return ptr < lo + len(blob) and lo < ptr + nbytes


def _stack(rec, blocks, n_lanes=128):
    return codec.stack_blocks(blocks, rec.head_words * n_lanes,
                              rec.word_dtype, "cpu")


@pytest.mark.parametrize("version", [1, 2], ids=["v1-aligned", "v2-odd"])
@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: v.name)
def test_unpacked_group_uploads_the_blobs_span(monkeypatch, variant,
                                               version):
    """``unpack``'s payloads of consecutive coded blocks: the array handed
    to the upload is the blob's own span, and the tensors equal the
    join's, whether the payload starts word-aligned (v1) or at an odd
    byte of the blob (v2's packed freqs and varint counts)."""
    data, blob = _blob(variant, version)
    start = _payload_start(blob)
    assert start % 2 == (version == 2)
    rec = codec.CODECS[variant]
    c = tcont.unpack(blob)
    assert c.raw is None
    blocks = [p[0] for p in c.payloads]
    assert len(blocks) == 6
    seen = _spy(monkeypatch)
    got = _stack(rec, blocks)
    want = _stack(rec, [b.copy() for b in blocks])
    span, joined = seen
    assert np.shares_memory(span, np.frombuffer(blob, np.uint8))
    assert span.ctypes.data == np.frombuffer(blob, np.uint8).ctypes.data \
        + start
    assert not np.shares_memory(joined, np.frombuffer(blob, np.uint8))
    assert span.tobytes() == joined.tobytes()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    words = got[0]
    assert words.dtype == {1: torch.uint8, 2: torch.int16,
                           4: torch.int32}[np.dtype(rec.word_dtype).itemsize]
    assert not _in_blob(blob, words.data_ptr(),
                        words.numel() * words.element_size())
    assert rt.decompress(blob, device="cpu") == data.tobytes()


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: v.name)
@pytest.mark.parametrize("layout", ["raw_between", "separate", "gap"])
def test_blocks_not_back_to_back_are_joined(monkeypatch, variant, layout):
    """A raw block between two coded ones, arrays of separate allocations,
    and views of one blob with a gap between them: the join, and the same
    bytes decoded."""
    if layout == "raw_between":
        data = np.concatenate([skewed(B, seed=6), random_bytes(B, 7),
                               skewed(2 * B + 99, seed=8)])
        data, blob = _blob(variant, 2, data)
        c = tcont.unpack(blob)
        assert c.raw.tolist() == [False, True, False, False, True]
        blocks = [c.payloads[0][0], c.payloads[2][0]]
    else:
        data, blob = _blob(variant, 2)
        c = tcont.unpack(blob)
        blocks = [p[0] for p in c.payloads[:3]]
        if layout == "separate":
            blocks = [b.copy() for b in blocks]
        else:
            blocks = [blocks[0], blocks[2]]
    rec = codec.CODECS[variant]
    seen = _spy(monkeypatch)
    got = _stack(rec, blocks)
    assert not np.shares_memory(seen[0], np.frombuffer(blob, np.uint8))
    assert seen[0].tobytes() == np.concatenate(blocks).tobytes()
    words, heads, body_off, body_len = got
    lens = np.array([b.size for b in blocks])
    n_head = rec.head_words * 128
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    assert body_off.tolist() == (offs + n_head).tolist()
    assert body_len.tolist() == (lens - n_head).tolist()
    for k, o in enumerate(offs):
        assert torch.equal(heads[k], words[o:o + n_head])
    assert rt.decompress(blob, device="cpu") == data.tobytes()
    out = codec.decode(c.cfg, blocks, [B] * len(blocks), c.freqs,
                       stats.calc_cum_freqs(c.freqs), "cpu")
    picked = {"raw_between": [0, 2], "separate": [0, 1, 2],
              "gap": [0, 2]}[layout]
    assert out.numpy().tobytes() == b"".join(
        data[b * B:(b + 1) * B].tobytes() for b in picked)


def test_run_needs_one_owner_not_touching_memory():
    """Arrays that touch in memory but are views of different objects are
    no run; views of one object, back to back and in order, are."""
    buf = bytearray(64)
    a = np.frombuffer(buf, np.uint16, 8)
    b = np.ctypeslib.as_array((ctypes.c_uint16 * 8).from_buffer(buf, 16))
    assert b.ctypes.data == a.ctypes.data + a.nbytes
    assert codec.run_of([a, b]) is None
    c = np.frombuffer(buf, np.uint16, 8, offset=16)
    run = codec.run_of([a, c])
    assert run is not None and run.dtype == np.uint8 and run.size == 32
    assert not run.flags.writeable
    assert np.shares_memory(run, np.frombuffer(buf, np.uint8))
    assert codec.run_of([c, a]) is None  # out of order
    assert codec.run_of([a[::2]]) is None  # not C-contiguous
    assert codec.run_of([np.frombuffer(buf, np.uint16, 4, offset=1),
                         np.frombuffer(buf, np.uint16, 4, offset=9)]).size \
        == 16  # an odd byte offset


@pytest.mark.parametrize("writable", [False, True], ids=["bytes", "array"])
def test_to_device_copies_a_read_only_array_even_to_the_cpu(writable):
    """A read-only array reaches the CPU as a copy; a writable one as
    before."""
    blob = bytes(range(200))
    host = np.frombuffer(blob, np.uint8)[3:103]
    if writable:
        host = host.copy()
    t = profiling.to_device(host, device="cpu")
    assert t.numpy().tobytes() == host.tobytes()
    assert np.shares_memory(t.numpy(), host) == writable


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: v.name)
def test_decompress_to_device_of_bytes_does_not_alias_the_blob(variant):
    data, blob = _blob(variant, 2)
    t = rt.decompress_to_device(blob, device="cpu")
    assert t.numpy().tobytes() == data.tobytes()
    assert not _in_blob(blob, t.data_ptr(), t.numel())


def test_bytes_blob_decodes_without_warnings_in_a_new_process():
    """PyTorch warns of a read-only array once a process: a new process
    with every warning an error decodes a ``bytes`` blob of every variant
    through each entry point, the span path among them."""
    tests = Path(__file__).resolve().parent
    code = f"""
import sys
import warnings
sys.path.insert(0, {str(tests)!r})
import numpy as np
import ryg_rans_tpu_torch as rt
from ryg_rans_tpu_torch.ops import codec
from _torch_corpora import skewed

warnings.simplefilter("error")
runs = []
run_of = codec.run_of
codec.run_of = lambda arrays: runs.append(run_of(arrays)) or runs[-1]
for v in (rt.Variant.WORD, rt.Variant.BYTE, rt.Variant.ALIAS,
          rt.Variant.RANS64):
    cfg = rt.RansConfig(variant=v, prob_bits=11, n_lanes=128,
                        block_symbols={B})
    data = skewed(3 * {B} + 77, seed=int(v))
    blob = rt.compress(data, cfg, device="cpu")
    assert rt.decompress(blob, device="cpu") == data.tobytes()
    assert rt.decompress_block(blob, 1, device="cpu") == \\
        data[{B}:2 * {B}].tobytes()
    t = rt.decompress_to_device(blob, device="cpu")
    assert t.numpy().tobytes() == data.tobytes()
assert runs and all(r is not None for r in runs), runs
print("clean", len(runs))
"""
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(
                   [str(tests.parent)]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    # the 77-byte tail is stored raw: one coded group a call, three calls
    # a variant
    assert res.stdout.split() == ["clean", "12"]


def test_threads_leave_the_warning_filters_as_they_were():
    """``to_device`` silences PyTorch's warning under a lock: four threads
    uploading read-only arrays at once, taking turns between bytecodes,
    leave the process's filters as they found them."""
    import threading
    import warnings

    blob = bytes(range(256)) * 64
    before = list(warnings.filters)
    go = threading.Barrier(4)
    bad = []

    def work(k):
        go.wait(timeout=60)
        for i in range(400):
            host = np.frombuffer(blob, np.uint8)[k + i % 7:k + 4096]
            if profiling.to_device(host, device="cpu").numpy().tobytes() \
                    != host.tobytes():
                bad.append(i)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(switch)
    assert not bad
    assert warnings.filters == before
