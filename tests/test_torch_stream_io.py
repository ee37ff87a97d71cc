"""The port's bounded-memory file path (``ryg_rans_tpu_torch.utils.stream_io``)
against its own in-memory API and the JAX package's ``compress_file``:
byte-identical containers, on the CPU (``device="cpu"``, the kernels'
plain versions) and through the host backends; the analogs of
tests/test_stream_io.py on synthetic corpora."""

import numpy as np
import pytest
import torch

from _torch_corpora import random_bytes, skewed
import ryg_rans_tpu_torch as rt
from ryg_rans_tpu.api import compress as ref_compress
from ryg_rans_tpu.config import RansConfig as RefConfig, Variant as RefVariant
from ryg_rans_tpu.utils import stream_io as ref_stream_io
from ryg_rans_tpu_torch.config import RansConfig, Variant
from ryg_rans_tpu_torch.ops import byte, rans64, word
from ryg_rans_tpu_torch.utils import container as cont
from ryg_rans_tpu_torch.utils import stream_io

CPU = "cpu"


def _cfg(**kw):
    d = dict(variant=Variant.WORD, prob_bits=12, n_lanes=128,
             lanes_per_stream=128, block_symbols=8192)
    d.update(kw)
    return RansConfig(**d)


def _ref_cfg(cfg: RansConfig) -> RefConfig:
    return RefConfig(variant=RefVariant(int(cfg.variant)),
                     prob_bits=cfg.prob_bits, n_lanes=cfg.n_lanes,
                     lanes_per_stream=cfg.lanes_per_stream,
                     block_symbols=cfg.block_symbols, checksum=cfg.checksum)


def _write(tmp_path, data: np.ndarray, name="in.bin"):
    src = tmp_path / name
    src.write_bytes(data.tobytes())
    return src


def _roundtrip(tmp_path, data, cfg, batch, **route):
    """compress_file -> decompress_file; returns the container bytes."""
    src = _write(tmp_path, data)
    dst = tmp_path / "out.trns"
    n = stream_io.compress_file(str(src), str(dst), cfg,
                                blocks_per_batch=batch, **route)
    blob = dst.read_bytes()
    assert n == len(blob)
    back = tmp_path / "back.bin"
    assert stream_io.decompress_file(str(dst), str(back),
                                     blocks_per_batch=batch,
                                     **route) == data.size
    assert back.read_bytes() == data.tobytes()
    return blob


@pytest.mark.parametrize("n_blocks_plus", [(1, 100), (3, 0), (6, 777)],
                         ids=["1-block-tail", "3-blocks", "6-blocks-tail"])
@pytest.mark.parametrize("batch", [1, 3, 100])
def test_file_matches_memory_api_and_reference(tmp_path, batch,
                                               n_blocks_plus):
    """The file container equals the port's compress and the reference's
    compress_file (numpy backend), at batches of 1, 3 and 100 blocks."""
    nb, tail = n_blocks_plus
    cfg = _cfg()
    data = skewed(nb * cfg.block_symbols + tail, seed=nb + batch)
    blob = _roundtrip(tmp_path, data, cfg, batch, device=CPU)
    assert blob == rt.compress(data, cfg, device=CPU)
    ref = tmp_path / "ref.trns"
    ref_stream_io.compress_file(str(tmp_path / "in.bin"), str(ref),
                                _ref_cfg(cfg), backend="numpy",
                                blocks_per_batch=batch)
    assert blob == ref.read_bytes()


def test_file_default_config_is_auto(tmp_path):
    """With no config the file path takes RansConfig.auto of the file's
    size, as compress does."""
    data = skewed(70_000, seed=3)
    src = _write(tmp_path, data)
    dst = tmp_path / "out.trns"
    stream_io.compress_file(str(src), str(dst), device=CPU,
                            blocks_per_batch=2)
    blob = dst.read_bytes()
    assert blob == rt.compress(data, device=CPU)
    assert cont.unpack(blob).cfg == RansConfig.auto(data.size)


def test_file_empty(tmp_path):
    src = _write(tmp_path, np.zeros(0, np.uint8), "empty")
    dst = tmp_path / "e.trns"
    stream_io.compress_file(str(src), str(dst), _cfg(), device=CPU)
    assert dst.read_bytes() == rt.compress(b"", _cfg(), device=CPU)
    back = tmp_path / "rt"
    assert stream_io.decompress_file(str(dst), str(back), device=CPU) == 0
    assert back.read_bytes() == b""


def test_file_crc_detects_corruption(tmp_path):
    data = skewed(20_000, seed=4)
    src = _write(tmp_path, data)
    dst = tmp_path / "out.trns"
    stream_io.compress_file(str(src), str(dst), _cfg(), device=CPU)
    blob = bytearray(dst.read_bytes())
    blob[1100] ^= 0x20  # inside the first block's payload
    bad = tmp_path / "bad.trns"
    bad.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="crc mismatch"):
        stream_io.decompress_file(str(bad), str(tmp_path / "x"), device=CPU)


def test_file_truncated_container_raises(tmp_path):
    data = skewed(20_000, seed=5)
    dst = tmp_path / "out.trns"
    stream_io.compress_file(str(_write(tmp_path, data)), str(dst), _cfg(),
                            device=CPU)
    cut = tmp_path / "cut.trns"
    cut.write_bytes(dst.read_bytes()[:-10])
    with pytest.raises(ValueError, match="truncated"):
        stream_io.decompress_file(str(cut), str(tmp_path / "x"), device=CPU)


@pytest.mark.parametrize("variant,pb", [(Variant.ALIAS, 16),
                                        (Variant.BYTE, 14),
                                        (Variant.RANS64, 20)])
def test_other_variants_file(tmp_path, variant, pb):
    data = skewed(3 * 8192 + 999, seed=pb)
    cfg = _cfg(variant=variant, prob_bits=pb)
    blob = _roundtrip(tmp_path, data, cfg, 2, device=CPU)
    assert blob == rt.compress(data, cfg, device=CPU)
    assert blob == ref_compress(data.tobytes(), _ref_cfg(cfg),
                                backend="numpy")


def test_file_roundtrip_raw_blocks(tmp_path):
    """Incompressible blocks go through the raw-block rule in the batch
    writer and reader; the container stays the in-memory API's."""
    cfg = _cfg()
    B = cfg.block_symbols
    data = np.concatenate([random_bytes(2 * B, 6), skewed(B + B // 3, 6)])
    blob = _roundtrip(tmp_path, data, cfg, 2, device=CPU)
    assert blob == rt.compress(data, cfg, device=CPU)
    c = cont.unpack(blob)
    assert c.raw is not None and c.raw[:2].all() and not c.raw[2:].any()
    assert blob == ref_compress(data.tobytes(), _ref_cfg(cfg),
                                backend="numpy")


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_host_backends_file(tmp_path, backend):
    """A host backend codes any config: here 8 lanes of 2 substreams of 4,
    which no kernel takes."""
    cfg = _cfg(n_lanes=8, lanes_per_stream=4, block_symbols=4096)
    data = skewed(2 * 4096 + 555, seed=7)[:None if backend == "native"
                                          else 9000]
    blob = _roundtrip(tmp_path, data, cfg, 1, backend=backend)
    assert blob == rt.compress(data, cfg, backend=backend)
    assert blob == ref_compress(data.tobytes(), _ref_cfg(cfg),
                                backend="numpy")


def _count_calls(monkeypatch, mod, name, counts):
    orig = getattr(mod, name)

    def counted(*a, **k):
        counts[f"{mod.__name__.rsplit('.', 1)[1]}.{name}"] += 1
        return orig(*a, **k)
    monkeypatch.setattr(mod, name, counted)


@pytest.mark.parametrize("variant,mod", [(Variant.WORD, word),
                                         (Variant.BYTE, byte),
                                         (Variant.RANS64, rans64)])
def test_every_batch_reaches_the_plain_versions(tmp_path, monkeypatch,
                                                variant, mod):
    """With 2 blocks a batch, 5 blocks take 3 batches: one encode and one
    decode call of the variant's module a batch."""
    cfg = _cfg(variant=variant, prob_bits=12)
    data = skewed(4 * cfg.block_symbols + 4000, seed=8)
    counts = {}
    stem = mod.__name__.rsplit(".", 1)[1]
    for name in ("encode_blocks_ref", "decode_blocks_ref"):
        counts[f"{stem}.{name}"] = 0
        _count_calls(monkeypatch, mod, name, counts)
    _roundtrip(tmp_path, data, cfg, 2, device=CPU)
    assert set(counts.values()) == {3}


def test_no_fallback(tmp_path):
    """The file path defaults to the card and raises without one; a config
    no kernel takes raises naming the host backends; "auto" is no
    backend."""
    src = _write(tmp_path, skewed(5000))
    dst = str(tmp_path / "o.trns")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stream_io.compress_file(str(src), dst, _cfg())
    with pytest.raises(NotImplementedError, match='backend="native"'):
        stream_io.compress_file(str(src), dst, _cfg(n_lanes=8), device=CPU)
    with pytest.raises(ValueError, match="backend"):
        stream_io.compress_file(str(src), dst, _cfg(), backend="auto")
    stream_io.compress_file(str(src), dst, _cfg(n_lanes=8), backend="native")
    with pytest.raises(NotImplementedError, match='backend="native"'):
        stream_io.decompress_file(dst, str(tmp_path / "x"), device=CPU)
    assert not list(tmp_path.glob("tmp*"))  # the spool is removed
