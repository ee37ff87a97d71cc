"""ryg_rans_tpu_torch's one-call API on the CPU for BYTE, ALIAS and RANS64,
against the reference package's ``compress(data, backend="numpy")``:
byte-identical containers at the full-width auto shape and at small
shapes, each side decoding the other's, raw blocks, random access and the
device-resident pair on CPU tensors."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_corpora import CORPORA, random_bytes, skewed
from ryg_rans_tpu import api as japi
from ryg_rans_tpu.config import RansConfig as JConfig
from ryg_rans_tpu.config import Variant as JVariant
import ryg_rans_tpu_torch as rt
from ryg_rans_tpu_torch.utils import container as tcont

VARIANTS = [rt.Variant.BYTE, rt.Variant.ALIAS, rt.Variant.RANS64]


def _jcfg(cfg):
    return JConfig(variant=JVariant(int(cfg.variant)),
                   **{k: v for k, v in dataclasses.asdict(cfg).items()
                      if k != "variant"})


def _both(data, cfg):
    """(port container, reference container) for the same input."""
    return (rt.compress(data, cfg, device="cpu"),
            japi.compress(data, _jcfg(cfg), backend="numpy"))


def _cross_decode(mine, theirs, data):
    assert rt.decompress(theirs, device="cpu") == data.tobytes()
    assert japi.decompress(mine, backend="numpy") == data.tobytes()


@pytest.mark.parametrize("variant,prob_bits", [
    (rt.Variant.BYTE, 14), (rt.Variant.ALIAS, 16), (rt.Variant.RANS64, 14),
    (rt.Variant.RANS64, 31)], ids=["BYTE", "ALIAS", "RANS64", "RANS64-pb31"])
def test_full_width_auto_matches_reference(variant, prob_bits):
    """RansConfig.auto(n, variant) from 8 MiB up: 16384 lanes, 2^23-symbol
    blocks and the reference demos' prob_bits (a full block and a tail);
    RANS64 also at prob_bits 31, the precision that defines it."""
    data = skewed((9 << 20) + 12_345, seed=11)
    cfg = rt.RansConfig.auto(data.size, variant)
    assert (cfg.n_lanes, cfg.block_symbols) == (16384, 1 << 23)
    cfg = dataclasses.replace(cfg, prob_bits=prob_bits)
    mine, theirs = _both(data, cfg)
    assert mine == theirs
    c = tcont.unpack(mine)
    assert len(c.payloads) == 2 and c.raw is None
    _cross_decode(mine, theirs, data)


# (variant, corpus, size, prob_bits, n_lanes, block_symbols)
SMALL = [
    (rt.Variant.BYTE, "skewed", 30_000, 9, 256, 1 << 13),
    (rt.Variant.BYTE, "sparse", 30_000, 16, 128, 1 << 12),
    (rt.Variant.BYTE, "one_symbol", 10_000, 16, 512, 1 << 12),
    (rt.Variant.ALIAS, "skewed", 30_000, 12, 128, 1 << 12),
    (rt.Variant.ALIAS, "one_symbol", 10_000, 16, 256, 1 << 12),
    (rt.Variant.RANS64, "sparse", 30_000, 9, 128, 1 << 12),
    (rt.Variant.RANS64, "skewed", 30_000, 20, 256, 1 << 13),
    (rt.Variant.RANS64, "one_symbol", 10_000, 31, 512, 1 << 12),
]


@pytest.mark.parametrize("variant,corpus,size,pb,N,B", SMALL,
                         ids=[f"{v.name}-{c}-pb{p}" for v, c, _, p, _, _
                              in SMALL])
def test_container_matches_reference(variant, corpus, size, pb, N, B):
    data = CORPORA[corpus](size, seed=size + pb)
    cfg = rt.RansConfig(variant=variant, prob_bits=pb, n_lanes=N,
                        block_symbols=B)
    mine, theirs = _both(data, cfg)
    assert mine == theirs
    _cross_decode(mine, theirs, data)


@pytest.mark.parametrize("variant", VARIANTS, ids=[v.name for v in VARIANTS])
def test_auto_small_inputs_match_reference(variant):
    """The small auto shapes: 1024 lanes, blocks sized to the input."""
    for size in (1, 5_000):
        data = skewed(size, seed=size)
        mine, theirs = _both(data, rt.RansConfig.auto(size, variant))
        assert mine == theirs
        _cross_decode(mine, theirs, data)


@pytest.mark.parametrize("variant", VARIANTS, ids=[v.name for v in VARIANTS])
def test_incompressible_blocks_are_stored_raw(variant):
    """The raw rule compares payload bytes (words times the variant's word
    size) with the block's bytes, as the reference does."""
    cfg = rt.RansConfig(variant=variant, prob_bits=12, n_lanes=128,
                        block_symbols=1 << 12)
    data = np.concatenate([skewed(1 << 12, seed=1), random_bytes(1 << 12, 2),
                           skewed(3000, seed=3)])
    mine, theirs = _both(data, cfg)
    assert mine == theirs
    assert tcont.unpack(mine).raw.tolist() == [False, True, False]
    assert rt.decompress(mine, device="cpu") == data.tobytes()
    assert torch.equal(rt.decompress_to_device(mine, device="cpu"),
                       torch.from_numpy(data))


@pytest.mark.parametrize("variant", VARIANTS, ids=[v.name for v in VARIANTS])
def test_decompress_block_each_block(variant):
    cfg = rt.RansConfig(variant=variant, prob_bits=11, n_lanes=256,
                        block_symbols=1 << 12)
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


@pytest.mark.parametrize("variant", VARIANTS, ids=[v.name for v in VARIANTS])
def test_corrupt_payload_fails_crc(variant):
    cfg = rt.RansConfig(variant=variant, prob_bits=12, n_lanes=128,
                        block_symbols=1 << 12)
    data = skewed(3 << 12, seed=8)
    blob = bytearray(rt.compress(data, cfg, device="cpu"))
    blob[-700] ^= 0x10  # a body byte of the last block
    with pytest.raises(ValueError, match="crc mismatch in block 2"):
        rt.decompress(bytes(blob), device="cpu")
    assert rt.decompress_block(bytes(blob), 0, device="cpu") == \
        data[:1 << 12].tobytes()


@pytest.mark.parametrize("variant", VARIANTS, ids=[v.name for v in VARIANTS])
def test_device_resident_pair_on_cpu_tensors(variant):
    data = skewed(50_000, seed=9)
    t = torch.from_numpy(data.copy())
    cfg = dataclasses.replace(rt.RansConfig.auto(data.size, variant),
                              checksum=False)
    blob = rt.compress_from_device(t, cfg)
    assert blob == rt.compress(data, cfg, device="cpu")
    assert blob == japi.compress(data, _jcfg(cfg), backend="numpy")
    assert torch.equal(rt.decompress_to_device(blob, device="cpu"), t)
