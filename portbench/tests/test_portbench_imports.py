"""Nothing the benchmark runs loads JAX, a JAX library or the JAX package,
compared by whole top-level names: ``ryg_rans_tpu_torch`` is the port."""

import subprocess
import sys

from portbench import harness

from ._cells import ROOT

CODE = """
import sys
sys.path.insert(0, {root!r})
import portbench.run, portbench.control, portbench.harness
from portbench.harness import load_cell, load_kernels, load_module
from portbench.program import Program
cell = load_cell(portbench.run.ROOT, "ckpt-dsv2lite-layer.load")
Program(cell.config, "cpu")
for m in cell.end_to_end + cell.per_layer:
    load_module("metrics", m["name"])
load_module("gen", "text_zipf"); load_module("gen", "bf16_planes")
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_benchmark_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", CODE.format(root=str(ROOT))],
                         capture_output=True, text=True, check=True).stdout
    tops = set(eval(out))
    assert "ryg_rans_tpu_torch" in tops  # the program is loaded ...
    assert not tops & {"jax", "jaxlib", "flax", "ryg_rans_tpu"}  # ... alone


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ryg_rans_tpu_torch_x", sys)
    assert harness.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "ryg_rans_tpu.api", sys)
    assert "ryg_rans_tpu" in harness.forbidden_modules()
