"""The port's host backends (``backend="numpy"``, the NumPy oracle, and
``backend="native"``, the C++ host core) against the reference package:
for every variant and for the layouts the kernels do not take, the port's
two backends and the reference's ``numpy`` and ``native`` backends write
the same container, byte for byte, and each port backend decodes it.
Synthetic corpora from seeds; the NumPy oracle stays at a few KB where a
block has 1-2 lanes."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_corpora import dominant, one_symbol, random_bytes, skewed
from ryg_rans_tpu import api as japi
from ryg_rans_tpu.config import RansConfig as JConfig
from ryg_rans_tpu.config import Variant as JVariant
import ryg_rans_tpu_torch as rt
from ryg_rans_tpu_torch.utils import container as tcont

V = rt.Variant
VARIANTS = [V.BYTE, V.WORD, V.RANS64, V.ALIAS]


def _jcfg(cfg):
    return JConfig(variant=JVariant(int(cfg.variant)),
                   **{k: v for k, v in dataclasses.asdict(cfg).items()
                      if k != "variant"})


def _all_four(data, cfg):
    """The port's numpy and native containers, after checking that they
    equal the reference's numpy and native ones."""
    mine = {be: rt.compress(data, cfg, backend=be)
            for be in ("numpy", "native")}
    for be in ("numpy", "native"):
        assert japi.compress(data, _jcfg(cfg), backend=be) == mine["numpy"], \
            f"reference {be} differs ({cfg})"
    assert mine["native"] == mine["numpy"], cfg
    return mine["numpy"]


def _decodes(blob, data, cfg):
    """Each port backend decodes ``blob`` whole and block by block; the
    four containers are the same bytes, so one blob stands for all."""
    for be in ("numpy", "native"):
        assert rt.decompress(blob, backend=be) == data.tobytes(), (be, cfg)
    B = cfg.block_symbols
    n_blocks = len(tcont.unpack(blob).payloads)
    for b in {0, n_blocks - 1}:
        for be in ("numpy", "native"):
            assert rt.decompress_block(blob, b, backend=be) == \
                data[b * B:(b + 1) * B].tobytes(), (be, b, cfg)


def _cfg(variant, n_lanes, lanes_per_stream=None, prob_bits=None,
         block_symbols=None, checksum=True):
    pb = prob_bits or {V.WORD: 12, V.ALIAS: 16}.get(variant, 14)
    return rt.RansConfig(variant=variant, prob_bits=pb, n_lanes=n_lanes,
                         lanes_per_stream=lanes_per_stream,
                         block_symbols=block_symbols or 64 * n_lanes,
                         checksum=checksum)


# (id, config maker over the variant, input size, corpus): every layout
# the kernels refuse, with tails (sizes off the 4*n_lanes grid) and
# several blocks where the size allows
LAYOUTS = [
    ("reference-1", lambda v: rt.RansConfig.reference(v, 1), 3001, skewed),
    ("reference-2", lambda v: rt.RansConfig.reference(v, 2), 5003, skewed),
    ("512-lanes-128-a-substream",
     lambda v: _cfg(v, 512, 128, block_symbols=1 << 14), 20_005, skewed),
    ("512-lanes-256-a-substream-no-crc",
     lambda v: _cfg(v, 512, 256, block_symbols=1 << 14, checksum=False),
     30_001, skewed),
    ("pb8", lambda v: _cfg(v, 256, prob_bits=8), 20_001, skewed),
    ("64-lanes", lambda v: _cfg(v, 64), 3_333, skewed),
    ("32768-lanes", lambda v: _cfg(v, 32768, block_symbols=1 << 20),
     (1 << 20) + 50_001, skewed),
    # a 6N block holds 4N (8N for RANS64) bytes of states: only a
    # low-entropy input codes smaller than that
    ("block-6N", lambda v: _cfg(v, 128, block_symbols=6 * 128), 4_001,
     dominant),
]


@pytest.mark.parametrize("variant", VARIANTS, ids=[v.name for v in VARIANTS])
@pytest.mark.parametrize("make,size,corpus", [l[1:] for l in LAYOUTS],
                         ids=[l[0] for l in LAYOUTS])
def test_layouts_outside_the_kernels(make, size, corpus, variant):
    cfg = make(variant)
    data = corpus(size, seed=size + int(variant))
    blob = _all_four(data, cfg)
    c = tcont.unpack(blob)
    head = cfg.n_lanes * cfg.spec.state_bits // 8
    if head < cfg.block_symbols:  # else every block is stored raw
        assert c.raw is None or not c.raw.all(), "no block was coded"
    _decodes(blob, data, cfg)


@pytest.mark.parametrize("cfg", [
    rt.RansConfig.reference(V.WORD, 8),
    rt.RansConfig(prob_bits=16, n_lanes=256, block_symbols=1 << 14),
    rt.RansConfig(prob_bits=16, n_lanes=512, lanes_per_stream=64,
                  block_symbols=1 << 14, checksum=False),
], ids=["reference-8", "pb16", "pb16-64-a-substream"])
def test_word_only_layouts(cfg):
    data = skewed(30_001, seed=21)
    blob = _all_four(data, cfg)
    _decodes(blob, data, cfg)


@pytest.mark.parametrize("variant", VARIANTS, ids=[v.name for v in VARIANTS])
def test_raw_blocks_with_several_substreams(variant):
    """Random bytes do not shrink: blocks are stored raw, a raw block of a
    multi-substream container has its bytes in substream 0."""
    cfg = _cfg(variant, 256, 64, block_symbols=1 << 14)
    data = np.concatenate([skewed(1 << 14, seed=1), random_bytes(1 << 14, 2),
                           skewed(9000, seed=3)])
    blob = _all_four(data, cfg)
    c = tcont.unpack(blob)
    assert c.raw.tolist() == [False, True, False]
    assert [s.size for s in c.payloads[1]] == [1 << 14, 0, 0, 0]
    _decodes(blob, data, cfg)
    all_raw = _all_four(random_bytes(5000, 4), cfg)
    assert tcont.unpack(all_raw).raw.all()
    _decodes(all_raw, random_bytes(5000, 4), cfg)


@pytest.mark.parametrize("variant", VARIANTS, ids=[v.name for v in VARIANTS])
@pytest.mark.parametrize("data", [
    np.zeros(0, np.uint8), np.array([7], np.uint8), one_symbol(3000)],
    ids=["empty", "one-byte", "one-symbol"])
def test_edge_inputs(data, variant):
    cfg = rt.RansConfig.reference(variant, 2)
    blob = _all_four(data, cfg)
    for be in ("numpy", "native"):
        assert rt.decompress(blob, backend=be) == data.tobytes()


@pytest.mark.parametrize("variant", VARIANTS, ids=[v.name for v in VARIANTS])
def test_block_of_padding_only(variant):
    """700 bytes at 128 lanes pad to 1024 symbols; with 768-symbol blocks
    the second block holds padding only, and is stored raw and empty."""
    cfg = _cfg(variant, 128, block_symbols=6 * 128)
    data = dominant(700, seed=4)
    blob = _all_four(data, cfg)
    c = tcont.unpack(blob)
    assert c.block_sizes() == [768, 256] and c.raw[1]
    assert c.payloads[1][0].size == 0
    _decodes(blob, data, cfg)


@pytest.mark.parametrize("variant,pb", [
    (V.WORD, 11), (V.BYTE, 14), (V.ALIAS, 16), (V.RANS64, 14),
    (V.RANS64, 31)], ids=["WORD", "BYTE", "ALIAS", "RANS64", "RANS64-pb31"])
def test_kernel_shape_configs_match_device_cpu(variant, pb):
    """Where the kernels take the config, the host backends write the
    container ``device="cpu"`` (the kernels' plain versions) writes, and
    each side decodes the other's."""
    cfg = rt.RansConfig(variant=variant, prob_bits=pb, n_lanes=256,
                        block_symbols=1 << 14)
    data = np.concatenate([skewed(40_000, seed=pb),
                           random_bytes(1 << 14, 5)])
    blob = rt.compress(data, cfg, device="cpu")
    assert rt.compress(data, cfg, backend="native") == blob
    assert rt.compress(data, cfg, backend="numpy") == blob
    assert rt.decompress(blob, backend="native") == data.tobytes()
    assert torch.equal(rt.decompress_to_device(blob, device="cpu"),
                       torch.from_numpy(data))


def test_reference_containers_decode():
    """Containers the reference writes (v2 and v1) decode on both port
    backends."""
    cfg = JConfig(variant=JVariant.BYTE, prob_bits=12, n_lanes=512,
                  lanes_per_stream=128, block_symbols=1 << 12)
    data = skewed(10_000, seed=12)
    from ryg_rans_tpu.utils import container as jcont
    c = jcont.unpack(japi.compress(data, cfg, backend="native"))
    for version in (1, 2):
        blob = jcont.pack(cfg, c.orig_len, c.freqs, c.payloads, c.crcs,
                          c.raw, version=version)
        for be in ("numpy", "native"):
            assert rt.decompress(blob, backend=be) == data.tobytes()


def test_corrupt_payload_fails_crc_on_host():
    cfg = _cfg(V.BYTE, 256, 64, block_symbols=1 << 12)
    data = skewed(3 << 12, seed=8)
    blob = bytearray(rt.compress(data, cfg, backend="native"))
    blob[-700] ^= 0x10  # a body byte of the last block
    for be in ("numpy", "native"):
        with pytest.raises(ValueError, match="crc mismatch in block 2"):
            rt.decompress(bytes(blob), backend=be)
        with pytest.raises(ValueError, match="crc mismatch in block 2"):
            rt.decompress_block(bytes(blob), 2, backend=be)
        assert rt.decompress_block(bytes(blob), 0, backend=be) == \
            data[:1 << 12].tobytes()


@pytest.mark.parametrize("backend", ["auto", "tpu", "cuda", "NUMPY", ""])
def test_other_backend_values_raise(backend):
    data = skewed(1000, seed=1)
    blob = rt.compress(data, device="cpu")
    for call in (lambda: rt.compress(data, backend=backend),
                 lambda: rt.decompress(blob, backend=backend),
                 lambda: rt.decompress_block(blob, 0, backend=backend)):
        with pytest.raises(ValueError, match="'numpy' or 'native'"):
            call()


def test_host_backends_need_no_card_and_log_their_choice(caplog):
    """With a host backend the default device="cuda" is not used: the call
    runs where there is no card, and the log names the backend."""
    data = skewed(3000, seed=2)
    cfg = rt.RansConfig.reference(V.RANS64, 1)
    with caplog.at_level("DEBUG", logger="ryg_rans_tpu_torch"):
        blob = rt.compress(data, cfg, backend="native")
        assert rt.decompress(blob, backend="numpy") == data.tobytes()
    msgs = [r.getMessage() for r in caplog.records]
    assert any("coding on native (requested backend=native)" in m
               for m in msgs), msgs
    assert any("coding on numpy (requested backend=numpy)" in m
               for m in msgs), msgs
