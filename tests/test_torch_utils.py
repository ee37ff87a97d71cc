"""The port's debug and profiling utilities against the JAX package's, its
examples on the CPU at a small size, and the README's port snippets run on
the CPU (the analogs of tests/test_utils.py and examples/readme_check.py,
on synthetic corpora)."""

import importlib.util
import logging
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_corpora import skewed
from ryg_rans_tpu.config import RansConfig as RefConfig, Variant as RefVariant
from ryg_rans_tpu.utils import debug as ref_debug
from ryg_rans_tpu.utils import profiling as ref_profiling
from ryg_rans_tpu_torch.config import (BYTE_SPEC, RANS64_SPEC, WORD_SPEC,
                                       RansConfig, Variant)
from ryg_rans_tpu_torch.models import stats
from ryg_rans_tpu_torch.ops import reference_numpy as oracle
from ryg_rans_tpu_torch.utils import debug, profiling

ROOT = Path(__file__).resolve().parents[1]


def _ref_cfg(cfg: RansConfig) -> RefConfig:
    return RefConfig(variant=RefVariant(int(cfg.variant)),
                     prob_bits=cfg.prob_bits, n_lanes=cfg.n_lanes,
                     lanes_per_stream=cfg.lanes_per_stream,
                     block_symbols=cfg.block_symbols, checksum=cfg.checksum)


def test_poison_buffer():
    p = debug.poison(16)
    assert (p == 0xCC).all()
    assert np.array_equal(p, ref_debug.poison(16))


@pytest.mark.parametrize("variant,pb,spec", [
    (Variant.WORD, 12, WORD_SPEC), (Variant.BYTE, 14, BYTE_SPEC),
    (Variant.RANS64, 20, RANS64_SPEC)])
def test_state_invariants_on_oracle_streams(variant, pb, spec):
    """Flushed states parsed from an oracle stream's head equal the
    reference's parse and pass the invariant."""
    cfg = RansConfig(variant=variant, prob_bits=pb, n_lanes=8,
                     block_symbols=4096)
    data = skewed(4096, seed=pb)
    freqs, cum = stats.build_model(data, pb)
    streams = oracle.encode(cfg, data, freqs, cum)
    x = debug.decode_states_from_head(cfg, streams[0])
    assert np.array_equal(x, ref_debug.decode_states_from_head(
        _ref_cfg(cfg), streams[0]))
    debug.check_state_invariants(x, spec)
    ref_debug.check_state_invariants(x, _ref_cfg(cfg).spec)


def test_state_invariants_catch_bad_state():
    for bad in (np.array([1], np.uint64), np.array([1 << 33], np.uint64)):
        with pytest.raises(AssertionError, match="outside") as got:
            debug.check_state_invariants(bad, BYTE_SPEC)
        with pytest.raises(AssertionError) as want:
            ref_debug.check_state_invariants(bad, _ref_cfg(
                RansConfig(variant=Variant.BYTE)).spec)
        assert str(got.value) == str(want.value)


def test_check_stream_counts():
    cfg = RansConfig(variant=Variant.BYTE, prob_bits=14, n_lanes=4,
                     lanes_per_stream=2, block_symbols=4096)
    data = skewed(4096, seed=1)
    freqs, cum = stats.build_model(data, cfg.prob_bits)
    streams = oracle.encode(cfg, data, freqs, cum)
    debug.check_stream_counts(cfg, [streams])
    ref_debug.check_stream_counts(_ref_cfg(cfg), [streams])
    for bad in ([[streams[0][:2], streams[1]]], [streams[:1]]):
        with pytest.raises(AssertionError) as got:
            debug.check_stream_counts(cfg, bad)
        with pytest.raises(AssertionError) as want:
            ref_debug.check_stream_counts(_ref_cfg(cfg), bad)
        assert str(got.value) == str(want.value)


def test_timed_runs_and_report():
    best, times = profiling.timed_runs(lambda: 42, runs=3)
    assert len(times) == 3 and best <= max(times)
    _, times = profiling.timed_runs(lambda: torch.zeros(4), runs=2)
    assert len(times) == 2
    for args in (("decode", 1 << 20, 0.001), ("encode", 0, 0.0),
                 ("x", 12345, 2.5)):
        line = profiling.report_line(*args)
        assert line == ref_profiling.report_line(*args)
    assert "MiB/s" in line and "ns/symbol" in line


def test_dispatch_slope_linear():
    def make(reps):
        return lambda: time.sleep(0.002 * reps)

    per = profiling.dispatch_slope(make, lo=1, hi=5, tries=2)
    assert 0.001 < per < 0.004


def test_trace_writes_a_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        torch.arange(1000).sum()
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0


def test_logging_names_the_route(caplog):
    import ryg_rans_tpu_torch as rt

    cfg = RansConfig(prob_bits=12, n_lanes=128, block_symbols=4096)
    with caplog.at_level(logging.DEBUG, logger="ryg_rans_tpu_torch"):
        rt.compress(skewed(5000).tobytes(), cfg, device="cpu")
    assert "device=cpu" in caplog.text
    assert "container:" in caplog.text and "blocks" in caplog.text


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,argv,expect", [
    ("torch_device_pipeline", ["--size", "200000", "--device", "cpu"],
     "device-side compress"),
    ("torch_float_compress", ["--elements", "4096", "--device", "cpu"],
     "bfloat16:"),
    ("torch_precision_sweep", ["--size", "16384", "--device", "cpu"],
     "RANS64    31"),
    ("torch_precision_sweep", ["--size", "16384", "--backend", "native"],
     "ALIAS     16"),
])
def test_examples_run_on_the_cpu(capsys, name, argv, expect):
    _example(name).main(argv)
    out = capsys.readouterr().out
    assert expect in out


def test_example_device_pipeline_reads_a_file(tmp_path, capsys):
    p = tmp_path / "in.bin"
    p.write_bytes(skewed(600_000, seed=2).tobytes())  # two blocks
    _example("torch_device_pipeline").main([str(p), "--device", "cpu"])
    assert "random-access block 1" in capsys.readouterr().out


def _port_snippets() -> list[str]:
    text = (ROOT / "README.md").read_text()
    port = text[text.index("## The PyTorch/CUDA port"):]
    blocks = re.findall(r"```python\n(.*?)```", port, re.S)
    return [b for b in blocks if 'DEVICE = "cuda"' in b]


def test_readme_has_device_snippets():
    assert len(_port_snippets()) == 2


@pytest.mark.parametrize("index", [0, 1])
def test_readme_port_snippets_run_on_the_cpu(index):
    """The README's port snippets, as written but for DEVICE = "cpu"."""
    code = _port_snippets()[index].replace('DEVICE = "cuda"',
                                           'DEVICE = "cpu"', 1)
    exec(compile(code, f"README.md port snippet {index}", "exec"), {})
