"""The port's CLI (``python -m ryg_rans_tpu_torch``) against the JAX
package's: the same files and printouts for the same flags, the port on
``--device cpu`` or a host backend, the reference on ``--backend numpy``;
the analogs of tests/test_cli.py on synthetic corpora."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from _torch_corpora import skewed
from ryg_rans_tpu.__main__ import main as ref_main
from ryg_rans_tpu_torch.__main__ import main
from ryg_rans_tpu_torch.utils import container as cont

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def src(tmp_path):
    p = tmp_path / "in.bin"
    p.write_bytes(skewed(20_000, seed=11).tobytes())
    return p


def _both(tmp_path, capsys, argv_port, argv_ref, out_name):
    """Run the port's and the reference's main on the same input; returns
    both outputs' bytes and both printouts."""
    port_out = tmp_path / f"port_{out_name}"
    ref_out = tmp_path / f"ref_{out_name}"
    assert main([*argv_port[:2], str(port_out), *argv_port[2:]]) == 0
    port_print = capsys.readouterr().out
    assert ref_main([*argv_ref[:2], str(ref_out), *argv_ref[2:]]) == 0
    ref_print = capsys.readouterr().out
    return port_out.read_bytes(), ref_out.read_bytes(), port_print, ref_print


@pytest.mark.parametrize("variant", ["word", "byte", "alias", "rans64"])
def test_cli_compress_matches_reference(tmp_path, capsys, src, variant):
    flags = ["--variant", variant, "--lanes", "128", "--block-symbols",
             "8192"]
    port, ref, printed, _ = _both(
        tmp_path, capsys, ["compress", str(src), *flags, "--device", "cpu"],
        ["compress", str(src), *flags, "--backend", "numpy"], "out.trns")
    assert port == ref
    assert printed.startswith(f"20000 -> {len(port)} bytes (")


def test_cli_roundtrip_and_info(tmp_path, capsys, src):
    blob, dec = tmp_path / "out.trns", tmp_path / "dec.bin"
    assert main(["compress", str(src), str(blob), "--variant", "word",
                 "--lanes", "128", "--block-symbols", "8192",
                 "--device", "cpu"]) == 0
    capsys.readouterr()
    assert main(["info", str(blob)]) == 0
    out = capsys.readouterr().out
    assert "WORD" in out and "orig_len         20000" in out
    assert ref_main(["info", str(blob)]) == 0
    assert capsys.readouterr().out == out  # the reference's lines
    assert main(["decompress", str(blob), str(dec), "--device", "cpu"]) == 0
    assert dec.read_bytes() == src.read_bytes()
    dec2 = tmp_path / "dec2.bin"
    assert main(["decompress", str(blob), str(dec2), "--backend",
                 "numpy"]) == 0
    assert dec2.read_bytes() == src.read_bytes()


def test_cli_decompresses_reference_container(tmp_path, capsys, src):
    """A container the reference's CLI wrote (a layout no kernel takes:
    64 lanes) decompresses through the port's host backend."""
    blob, dec = tmp_path / "ref.trns", tmp_path / "dec.bin"
    assert ref_main(["compress", str(src), str(blob), "--lanes", "64",
                     "--block-symbols", "8192", "--backend", "numpy"]) == 0
    assert main(["decompress", str(blob), str(dec), "--backend",
                 "native"]) == 0
    assert dec.read_bytes() == src.read_bytes()


def test_cli_bench_smoke(tmp_path, capsys):
    p = tmp_path / "in.bin"
    p.write_bytes(skewed(8192, seed=12).tobytes())
    rc = main(["bench", str(p), "--variant", "byte", "--lanes", "128",
               "--block-symbols", "4096", "--runs", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "decode ok!" in out and "bits/byte" in out
    assert out.count("encode:") == 1 and out.count("decode:") == 1


def test_cli_bench_runs_and_native(tmp_path, capsys):
    p = tmp_path / "in.bin"
    p.write_bytes(skewed(8192, seed=13).tobytes())
    assert main(["bench", str(p), "--lanes", "8", "--runs", "2",
                 "--backend", "native"]) == 0
    out = capsys.readouterr().out
    assert out.count("encode:") == 2 and "decode ok!" in out
    assert "backend=native" in out


def test_cli_auto_shape_keeps_lanes_per_stream(tmp_path, capsys, src):
    """--lanes-per-stream without --lanes (the size-adaptive shape) keeps
    the requested substream layout; only a host backend codes it."""
    port, ref, _, _ = _both(
        tmp_path, capsys,
        ["compress", str(src), "--lanes-per-stream", "64", "--backend",
         "native"],
        ["compress", str(src), "--lanes-per-stream", "64", "--backend",
         "numpy"], "out.trns")
    assert port == ref
    assert cont.unpack(port).cfg.lanes_per_stream == 64
    dec = tmp_path / "dec.bin"
    assert main(["decompress", str(tmp_path / "port_out.trns"), str(dec),
                 "--backend", "native"]) == 0
    assert dec.read_bytes() == src.read_bytes()
    with pytest.raises(NotImplementedError, match='backend="native"'):
        main(["compress", str(src), str(tmp_path / "x"),
              "--lanes-per-stream", "64", "--device", "cpu"])


def test_cli_no_fallback(tmp_path, src):
    """The device defaults to cuda and raises without a card; the
    reference's auto and tpu backends are not choices."""
    with pytest.raises(SystemExit):
        main(["compress", str(src), str(tmp_path / "x"), "--backend",
              "auto"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["compress", str(src), str(tmp_path / "x")])


def test_python_dash_m_info(tmp_path, src):
    """``python -m ryg_rans_tpu_torch`` runs the same interface."""
    blob = tmp_path / "out.trns"
    assert main(["compress", str(src), str(blob), "--lanes", "128",
                 "--device", "cpu"]) == 0
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", "ryg_rans_tpu_torch", "info",
                          str(blob)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "n_lanes          128" in out.stdout
