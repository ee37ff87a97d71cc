"""The judgement: sound runs of every cell come out correct, and the
control and each planted fault come out not correct.  The harness runs on
the CPU here, past its look for a card, at tiny sizes; the card's runs are
in test_portbench_card.py."""

import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import control, harness
from portbench.program import Program

from ._cells import CELLS, ROOT, tiny


def _run(workload, seed, what=None, traced=False):
    cell = tiny(workload)
    prog = Program(cell.config, "cpu")
    if what:
        prog = control.replaced(prog, cell.config, what)
    return harness.run(cell, seed, 0.3, traced, prog, "cpu",
                       time.perf_counter())


@pytest.mark.parametrize("workload", CELLS)
def test_sound_runs_are_correct(workload):
    for seed, traced in ((11, False), (2**31 + 5, True)):
        r = _run(workload, seed, traced=traced)
        assert r["correct"], r["checks"]
        assert r["failed"] == 0 and r["attempted"] > 0
        assert list(r)[-1] == "checks"
        assert r["judged"]["window_outputs"] > 0
        if traced:
            assert set(r["metrics"]) <= {m["name"]
                                         for m in tiny(workload).per_layer}
            assert {"busy_s", "window_s"} <= set(r["device"])


@pytest.mark.parametrize("what", ["control", "altered", "half", "stale"])
@pytest.mark.parametrize("workload", CELLS)
def test_control_and_faults_are_not_correct(workload, what):
    r = _run(workload, 23, what)
    assert not r["correct"], r["checks"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def _run_py(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "text-zipf82-1e8.compress", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=600)


def test_run_refuses_without_a_card():
    """Exit 1 and no result where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _run_py(ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "needs 1 CUDA card" in p.stderr


def test_run_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the harness it
    cannot run, card or no card."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


EXPLICIT = {"rule": "explicit", "variant": "WORD", "prob_bits": 10,
            "n_lanes": 256, "block_symbols": 1 << 14, "checksum": True}


@pytest.mark.parametrize("spec,backend", [
    (EXPLICIT, None), ({"rule": "auto", "checksum": True}, "numpy"),
    (dict(EXPLICIT, checksum=False), "numpy")])
@pytest.mark.parametrize("what", [None, "control"])
def test_a_config_file_alone_sets_shape_and_backend(spec, backend, what):
    """A configuration that states a shape or a backend needs no code:
    the program and the reference both read it, sound runs come out
    correct and the control does not."""
    cell = tiny("text-zipf82-1e8.compress")
    cell.config = dict(cell.config, rans_config=spec, backend=backend)
    prog = Program(cell.config, "cpu")
    assert prog._cfg is None or prog._cfg.n_lanes == 256
    if what:
        prog = control.replaced(prog, cell.config, what)
    r = harness.run(cell, 31, 0.3, False, prog, "cpu", time.perf_counter())
    assert r["correct"] is (what is None), r["checks"]


def test_a_backend_is_refused_on_device_inputs():
    cell = tiny("ckpt-dsv2lite-layer.save")
    with pytest.raises(ValueError, match="backend"):
        Program(dict(cell.config, backend="numpy"), "cpu")


def test_the_window_reads_no_memory_statistics(monkeypatch):
    """Memory is read in a pass of one call an input after the window:
    as many readings as inputs, however many calls the window made."""
    begun = []

    class Counting(harness.Memory):
        def begin(self):
            begun.append(1)
            return super().begin()

    monkeypatch.setattr(harness, "Memory", Counting)
    cell = tiny("ckpt-dsv2lite-layer.load")
    r = _run("ckpt-dsv2lite-layer.load", 5)
    assert r["correct"] and r["attempted"] > 0
    n_inputs = len(harness.load_module("gen", "bf16_planes").make(
        cell.config, 5, "cpu"))
    assert len(begun) == n_inputs
