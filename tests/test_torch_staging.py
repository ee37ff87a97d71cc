"""The pieces of ``to_host``'s pinned staging that run without a card: the
chunk plan, the threaded host copy, the staging loop on CPU slots with
events that log what they are asked, the ``bytes`` made to be filled,
``to_host(..., out=...)`` on CPU tensors, and ``decompress`` /
``decompress_block`` on the CPU and the host backends returning ``bytes``
equal to the input.  ``tests/test_torch_cuda.py`` holds the staged path on
the card against ``t.cpu().numpy()``."""

import numpy as np
import pytest
import torch

from _torch_corpora import random_bytes, skewed
import ryg_rans_tpu_torch as rt
from ryg_rans_tpu_torch.utils import container as tcont
from ryg_rans_tpu_torch.utils import profiling

C = profiling.CHUNK
PIECE = profiling._PIECE_MIN


@pytest.mark.parametrize("n", [0, 1, C - 1, C, C + 1, 2 * C, 5 * C // 2,
                               5 * C + 3])
def test_chunk_plan_covers_the_bytes_in_turns(n):
    plan = profiling.chunk_plan(n)
    assert len(plan) == -(-n // C)
    assert [off for off, _, _ in plan] == [k * C for k in range(len(plan))]
    assert all(ln == C for _, ln, _ in plan[:-1])
    assert sum(ln for _, ln, _ in plan) == n
    assert all(0 < ln <= C for _, ln, _ in plan)
    assert [s for _, _, s in plan] == [k % 2 for k in range(len(plan))]


@pytest.mark.parametrize("n", [0, 1, PIECE - 1, PIECE, 3 * PIECE + 5,
                               9 * PIECE + 7])
def test_host_copy_is_exact_over_the_threads(n):
    src = random_bytes(n, seed=n % 97)
    dst = np.full(n + 2, 7, np.uint8)
    profiling._host_copy(dst[1:n + 1], src)
    assert np.array_equal(dst[1:n + 1], src)
    assert dst[0] == 7 and dst[-1] == 7  # nothing written around it


class _Event:
    def __init__(self, log, slot):
        self.log, self.slot = log, slot

    def record(self, stream):
        self.log.append(("record", self.slot))

    def synchronize(self):
        self.log.append(("wait", self.slot))


class _CpuRing:
    """A ring of CPU slots of ``chunk`` bytes whose events log their calls,
    and whose host copies log which slot they read."""

    def __init__(self, chunk, log):
        self.slots = [torch.zeros(chunk, dtype=torch.uint8) for _ in range(2)]
        self.views = [s.numpy() for s in self.slots]
        self.events = [_Event(log, s) for s in range(2)]


@pytest.mark.parametrize("k_chunks", [0.5, 1, 2, 2.5, 7])
def test_stage_refills_a_slot_only_after_its_chunk_left(monkeypatch,
                                                        k_chunks):
    chunk = 1024
    monkeypatch.setattr(profiling, "CHUNK", chunk)
    log = []
    ring = _CpuRing(chunk, log)
    copy = profiling._host_copy

    def logged_copy(dst, src):
        slot = next(s for s in range(2)
                    if np.shares_memory(src, ring.views[s]))
        log.append(("copy", slot))
        copy(dst, src)
    monkeypatch.setattr(profiling, "_host_copy", logged_copy)
    n = int(k_chunks * chunk)
    src = torch.from_numpy(skewed(n, seed=3))
    dst = np.zeros(n, np.uint8)
    profiling._stage(src, dst, ring, None)
    assert np.array_equal(dst, src.numpy())
    k = -(-n // chunk)
    want = [("record", s) for s in range(min(2, k))]
    for i in range(k):
        want += [("wait", i % 2), ("copy", i % 2)]
        if i + 2 < k:
            want.append(("record", i % 2))
    assert log == want


def test_stage_waits_for_both_slots_when_a_copy_fails(monkeypatch):
    chunk = 1024
    monkeypatch.setattr(profiling, "CHUNK", chunk)
    log = []
    ring = _CpuRing(chunk, log)

    def failing_copy(dst, src):
        log.append(("copy", None))
        raise KeyboardInterrupt
    monkeypatch.setattr(profiling, "_host_copy", failing_copy)
    src = torch.from_numpy(skewed(3 * chunk, seed=4))
    with pytest.raises(KeyboardInterrupt):
        profiling._stage(src, np.zeros(3 * chunk, np.uint8), ring, None)
    assert log == [("record", 0), ("record", 1), ("wait", 0),
                   ("copy", None), ("wait", 0), ("wait", 1)]


@pytest.mark.parametrize("n", [0, 1, 2, 4097, (1 << 20) + 3])
def test_host_bytes_is_a_bytes_filled_through_its_view(n):
    out, view = profiling.host_bytes(n)
    assert type(out) is bytes and len(out) == n
    assert view.dtype == np.uint8 and view.shape == (n,)
    fill = random_bytes(n, seed=n)
    view[:] = fill
    assert out == fill.tobytes()
    if n:
        assert view.flags.writeable and view.ctypes.data == \
            np.frombuffer(out, np.uint8).ctypes.data
        # the view keeps the bytes alive on its own
        del out
        assert bytes(view) == fill.tobytes()


def test_host_bytes_are_new_each_time():
    a, va = profiling.host_bytes(64)
    b, vb = profiling.host_bytes(64)
    va[:] = 1
    vb[:] = 2
    assert a == b"\x01" * 64 and b == b"\x02" * 64


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int64])
@pytest.mark.parametrize("view", ["whole", "offset", "strided", "empty"])
def test_to_host_fills_out_from_a_cpu_tensor(dtype, view):
    base = torch.from_numpy(random_bytes(4096 * 8, seed=1)).view(dtype)
    t = {"whole": base, "offset": base[37:1037],
         "strided": base.view(64, -1)[:, ::3].T, "empty": base[:0]}[view]
    want = t.numpy()
    out = np.full(t.numel() * t.element_size(), 0xAB, np.uint8)
    got = profiling.to_host(t, out=out)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    assert np.shares_memory(got, out) or out.size == 0
    assert out.tobytes() == want.tobytes()
    plain = profiling.to_host(t)
    assert np.array_equal(plain, want)


def test_to_host_refuses_an_out_it_cannot_fill():
    t = torch.arange(8, dtype=torch.int16)
    for bad in (np.zeros(15, np.uint8), np.zeros(8, np.int16),
                np.zeros(32, np.uint8)[::2],
                np.frombuffer(bytes(16), np.uint8)):
        with pytest.raises(ValueError, match="out"):
            profiling.to_host(t, out=bad)
    with pytest.raises(ValueError, match="one tensor"):
        profiling.to_host(t, t, out=np.zeros(16, np.uint8))


B = 4096
SHAPES = {"tail": 2 * B + 3500, "edge": 3 * B, "short": 100}


def _cfg(variant, checksum):
    return rt.RansConfig(variant=variant, prob_bits=11, n_lanes=128,
                         block_symbols=B, checksum=checksum)


@pytest.mark.parametrize("backend", [None, "native", "numpy"])
@pytest.mark.parametrize("checksum", [True, False])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_decompress_returns_bytes_equal_to_the_input(backend, checksum,
                                                     shape):
    data = skewed(SHAPES[shape], seed=len(shape))
    cfg = _cfg(rt.Variant.WORD, checksum)
    blob = rt.compress(data, cfg, device="cpu")
    kw = {"backend": backend} if backend else {"device": "cpu"}
    out = rt.decompress(blob, **kw)
    assert type(out) is bytes and out == data.tobytes()
    for b in range(len(tcont.unpack(blob).payloads)):
        blk = rt.decompress_block(blob, b, **kw)
        assert type(blk) is bytes
        assert blk == data[b * B:(b + 1) * B].tobytes()


@pytest.mark.parametrize("variant", [rt.Variant.BYTE, rt.Variant.RANS64])
def test_decompress_returns_bytes_with_a_raw_block(variant):
    data = np.concatenate([skewed(B, seed=6), random_bytes(B, seed=7),
                           skewed(1000, seed=8)])
    blob = rt.compress(data, _cfg(variant, True), device="cpu")
    assert tcont.unpack(blob).raw is not None
    out = rt.decompress(blob, device="cpu")
    assert type(out) is bytes and out == data.tobytes()
    assert rt.decompress_block(blob, 1, device="cpu") == \
        data[B:2 * B].tobytes()


def test_a_flipped_payload_byte_still_fails_the_crc():
    data = skewed(2 * B + 3500, seed=9)
    blob = bytearray(rt.compress(data, _cfg(rt.Variant.WORD, True),
                                 device="cpu"))
    blob[-40] ^= 0x10  # inside the last block's words
    with pytest.raises(ValueError, match="crc mismatch"):
        rt.decompress(bytes(blob), device="cpu")
