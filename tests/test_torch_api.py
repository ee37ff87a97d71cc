"""ryg_rans_tpu_torch's one-call API on the CPU against the reference
package's ``compress(data, backend="numpy")``: byte-identical containers,
and each side decodes the other's."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from _torch_corpora import CORPORA, random_bytes, skewed
from ryg_rans_tpu import api as japi
from ryg_rans_tpu.config import RansConfig as JConfig
from ryg_rans_tpu.config import Variant as JVariant
from ryg_rans_tpu.utils import container as jcont
import ryg_rans_tpu_torch as rt
from ryg_rans_tpu_torch.utils import container as tcont


def _jcfg(cfg):
    return JConfig(variant=JVariant(int(cfg.variant)),
                   **{k: v for k, v in dataclasses.asdict(cfg).items()
                      if k != "variant"})


def _both(data, cfg=None):
    """(port container, reference container) for the same input."""
    mine = rt.compress(data, cfg, device="cpu")
    theirs = japi.compress(data, None if cfg is None else _jcfg(cfg),
                           backend="numpy")
    return mine, theirs


# (input maker, size, config or None for RansConfig.auto)
SMALL = [
    ("skewed", 1, None),
    ("skewed", 5_000, None),
    ("sparse", 70_001, None),
    ("skewed", 30_000, rt.RansConfig(prob_bits=9, n_lanes=256,
                                     block_symbols=1 << 13)),
    ("skewed", 30_000, rt.RansConfig(prob_bits=15, n_lanes=128,
                                     block_symbols=1 << 12, checksum=False)),
    ("random", 12_000, rt.RansConfig(prob_bits=12, n_lanes=128,
                                     block_symbols=1 << 12)),
    ("one_symbol", 10_000, rt.RansConfig(prob_bits=15, n_lanes=512,
                                         block_symbols=1 << 12)),
]


@pytest.mark.parametrize("corpus,size,cfg", SMALL,
                         ids=[f"{c}-{n}-{'auto' if g is None else g.prob_bits}"
                              for c, n, g in SMALL])
def test_container_matches_reference(corpus, size, cfg):
    data = CORPORA[corpus](size, seed=size)
    mine, theirs = _both(data, cfg)
    assert mine == theirs
    assert rt.decompress(theirs, device="cpu") == data.tobytes()
    assert japi.decompress(mine, backend="numpy") == data.tobytes()


def test_full_width_auto_matches_reference():
    """The shape users of the default get: >= 8 MiB gives 16384 lanes,
    prob_bits 11 and 2^23-symbol blocks (a full block and a tail)."""
    data = skewed((9 << 20) + 12_345, seed=11)
    cfg = rt.RansConfig.auto(data.size)
    assert (cfg.n_lanes, cfg.prob_bits, cfg.block_symbols) == (
        16384, 11, 1 << 23)
    mine, theirs = _both(data)
    assert mine == theirs
    c = tcont.unpack(mine)
    assert len(c.payloads) == 2 and c.raw is None
    assert rt.decompress(theirs, device="cpu") == data.tobytes()
    assert japi.decompress(mine, backend="numpy") == data.tobytes()


def test_empty_input():
    mine, theirs = _both(b"")
    assert mine == theirs
    assert rt.decompress(mine, device="cpu") == b""
    assert rt.decompress_to_device(mine, device="cpu").numel() == 0
    assert rt.compress_from_device(torch.zeros(0, dtype=torch.uint8)) == mine


def test_incompressible_blocks_are_stored_raw():
    cfg = rt.RansConfig(prob_bits=12, n_lanes=128, block_symbols=1 << 12)
    data = np.concatenate([skewed(1 << 12, seed=1), random_bytes(1 << 12, 2),
                           skewed(3000, seed=3)])
    mine, theirs = _both(data, cfg)
    assert mine == theirs
    assert tcont.unpack(mine).raw.tolist() == [False, True, False]
    assert rt.decompress(mine, device="cpu") == data.tobytes()
    assert torch.equal(rt.decompress_to_device(mine, device="cpu"),
                       torch.from_numpy(data))
    all_raw, _ = _both(random_bytes(5000, 4), cfg)
    assert tcont.unpack(all_raw).raw.all()
    assert rt.decompress(all_raw, device="cpu") == random_bytes(5000,
                                                                4).tobytes()


def test_decompress_block_each_block():
    cfg = rt.RansConfig(prob_bits=11, n_lanes=256, block_symbols=1 << 12)
    data = np.concatenate([skewed(2 << 12, seed=5), random_bytes(1 << 12, 6),
                           skewed(777, seed=7)])
    blob = rt.compress(data, cfg, device="cpu")
    B = cfg.block_symbols
    for b in range(4):
        part = data[b * B:(b + 1) * B].tobytes()
        assert rt.decompress_block(blob, b, device="cpu") == part
        assert japi.decompress_block(blob, b, backend="numpy") == part
    with pytest.raises(IndexError):
        rt.decompress_block(blob, 4, device="cpu")


def test_corrupt_payload_fails_crc():
    cfg = rt.RansConfig(prob_bits=12, n_lanes=128, block_symbols=1 << 12)
    data = skewed(3 << 12, seed=8)
    blob = bytearray(rt.compress(data, cfg, device="cpu"))
    blob[-700] ^= 0x10  # a body word of the last block
    with pytest.raises(ValueError, match="crc mismatch in block 2"):
        rt.decompress(bytes(blob), device="cpu")
    with pytest.raises(ValueError, match="crc mismatch in block 2"):
        rt.decompress_block(bytes(blob), 2, device="cpu")
    assert rt.decompress_block(bytes(blob), 0, device="cpu") == \
        data[:1 << 12].tobytes()
    # the device-resident path does not check CRCs: it returns the garbage
    out = rt.decompress_to_device(bytes(blob), device="cpu")
    assert out.numel() == data.size and not torch.equal(
        out, torch.from_numpy(data))


def test_device_resident_pair_on_cpu_tensors():
    data = skewed(50_000, seed=9)
    t = torch.from_numpy(data.copy())
    blob = rt.compress_from_device(t)
    cfg = dataclasses.replace(rt.RansConfig.auto(data.size), checksum=False)
    assert blob == rt.compress(data, cfg, device="cpu")
    assert blob == japi.compress(data, _jcfg(cfg), backend="numpy")
    assert torch.equal(rt.decompress_to_device(blob, device="cpu"), t)
    with pytest.raises(ValueError, match="checksum=False"):
        rt.compress_from_device(t, rt.RansConfig.auto(data.size))
    with pytest.raises(TypeError):
        rt.compress_from_device(data)


def test_input_kinds_agree():
    data = skewed(6000, seed=10)
    ref = rt.compress(data, device="cpu")
    ro = data.copy()
    ro.flags.writeable = False
    for x in (data.tobytes(), bytearray(data.tobytes()),
              memoryview(data.tobytes()), ro, data.reshape(60, 100)):
        assert rt.compress(x, device="cpu") == ref


def test_v1_container_decodes():
    cfg = JConfig(variant=JVariant.WORD, prob_bits=12, n_lanes=256,
                  block_symbols=1 << 12)
    data = skewed(10_000, seed=12)
    c = jcont.unpack(japi.compress(data, cfg, backend="numpy"))
    v1 = jcont.pack(cfg, c.orig_len, c.freqs, c.payloads, c.crcs, c.raw,
                    version=1)
    assert rt.decompress(v1, device="cpu") == data.tobytes()


def test_containers_outside_the_slice_raise():
    """What no kernel takes raises NotImplementedError naming the host
    backends, for every variant: several substreams per block, prob_bits
    8, WORD prob_bits 16 and fewer than 128 lanes.  The same blobs and
    configs go through backend="native"."""
    data = skewed(5000, seed=13)
    multi = JConfig(variant=JVariant.BYTE, prob_bits=14, n_lanes=512,
                    lanes_per_stream=128)
    multi_blob = japi.compress(data, multi, backend="numpy")
    hint = 'backend="native" or backend="numpy"'
    for call in (lambda: rt.decompress(multi_blob, device="cpu"),
                 lambda: rt.decompress_block(multi_blob, 0, device="cpu"),
                 lambda: rt.decompress_to_device(multi_blob, device="cpu")):
        with pytest.raises(NotImplementedError, match=hint):
            call()
    assert rt.decompress(multi_blob, backend="native") == data.tobytes()
    assert rt.decompress_block(multi_blob, 0, backend="native") == \
        data.tobytes()
    for cfg in (rt.RansConfig(n_lanes=512, lanes_per_stream=128),
                rt.RansConfig(variant=rt.Variant.RANS64, n_lanes=512,
                              lanes_per_stream=256),
                rt.RansConfig(variant=rt.Variant.ALIAS, prob_bits=8),
                rt.RansConfig(prob_bits=8),
                rt.RansConfig(prob_bits=16),
                rt.RansConfig(variant=rt.Variant.BYTE, n_lanes=64,
                              block_symbols=1 << 12)):
        with pytest.raises(NotImplementedError, match=hint):
            rt.compress(data, cfg, device="cpu")
        with pytest.raises(NotImplementedError, match=hint):
            rt.compress_from_device(torch.from_numpy(data),
                                    dataclasses.replace(cfg,
                                                        checksum=False))
        blob = rt.compress(data, cfg, backend="native")
        assert blob == japi.compress(data, _jcfg(cfg), backend="numpy")
        assert rt.decompress(blob, backend="native") == data.tobytes()
    with pytest.raises(ValueError, match="device"):
        rt.compress(data, device="meta")


@pytest.mark.parametrize("backend", [None, "numpy", "native"])
@pytest.mark.parametrize("variant,prob_bits", [
    (rt.Variant.WORD, 12), (rt.Variant.BYTE, 12), (rt.Variant.ALIAS, 12),
    (rt.Variant.RANS64, 14)], ids=["WORD", "BYTE", "ALIAS", "RANS64"])
def test_bytes_blob_decodes_without_warnings(variant, prob_bits, backend):
    """``unpack`` hands out read-only views of a ``bytes`` blob; no path
    gives one to PyTorch (which warns on a non-writable array), whole,
    block by block and, on the kernels' route, into a tensor.  The middle
    block is stored raw."""
    cfg = rt.RansConfig(variant=variant, prob_bits=prob_bits, n_lanes=128,
                        block_symbols=1 << 12)
    data = np.concatenate([skewed(1 << 12, seed=14),
                           random_bytes(1 << 12, 15), skewed(3001, seed=16)])
    blob = rt.compress(data, cfg, device="cpu")
    assert isinstance(blob, bytes)
    assert tcont.unpack(blob).raw.tolist() == [False, True, False]
    route = ({"device": "cpu"} if backend is None
             else {"backend": backend})
    B = cfg.block_symbols
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert rt.decompress(blob, **route) == data.tobytes()
        for b in range(3):
            assert rt.decompress_block(blob, b, **route) == \
                data[b * B:(b + 1) * B].tobytes()
        if backend is None:
            assert torch.equal(rt.decompress_to_device(blob, device="cpu"),
                               torch.from_numpy(data))


def test_crc_mismatch_names_the_first_bad_block():
    """The blocks' CRCs are computed together; the error still names the
    first block whose bytes do not match."""
    cfg = rt.RansConfig(prob_bits=12, n_lanes=128, block_symbols=1 << 12)
    data = skewed(4 << 12, seed=17)
    blob = rt.compress(data, cfg, device="cpu")
    c = tcont.unpack(blob)
    bad = bytearray(blob)
    for b in (1, 3):  # an early body word of blocks 1 and 3
        start = len(blob) - sum(s.nbytes for blk in c.payloads[b:]
                                for s in blk)
        bad[start + 4 * cfg.n_lanes + 100] ^= 0x10
    with pytest.raises(ValueError, match="crc mismatch in block 1"):
        rt.decompress(bytes(bad), device="cpu")
    with pytest.raises(ValueError, match="crc mismatch in block 3"):
        rt.decompress_block(bytes(bad), 3, device="cpu")
    assert rt.decompress_block(bytes(bad), 2, device="cpu") == \
        data[2 << 12:3 << 12].tobytes()
