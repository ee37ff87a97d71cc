"""ryg_rans_tpu_torch stands alone: it imports neither JAX nor the
reference package, not on the card's path nor on its host backends (the
C++ core ``native`` and the NumPy oracle ``ops.reference_numpy``), nor in
the file path, the CLI, the lane coder, the utilities or the process
layer, and it never falls back to the CPU on its own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ryg_rans_tpu_torch.ops import byte, rans64, word

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "ryg_rans_tpu_torch"

_PROBE = """
import os
import sys
import tempfile
import numpy as np
import torch
import ryg_rans_tpu_torch as rt
from ryg_rans_tpu_torch import __main__ as cli
from ryg_rans_tpu_torch.config import BYTE_SPEC
from ryg_rans_tpu_torch.models import stats
from ryg_rans_tpu_torch.ops import coder
from ryg_rans_tpu_torch.parallel import mesh, multihost
from ryg_rans_tpu_torch.utils import debug, profiling, stream_io
data = (np.arange(20000) % 7).astype(np.uint8).tobytes()
blob = rt.compress(data, device="cpu")
assert rt.decompress(blob, device="cpu") == data
# the host backends run with no card and import nothing of JAX either
for be in ("native", "numpy"):
    assert rt.compress(data, backend=be) == blob
    assert rt.decompress(blob, backend=be) == data
# the file path, the CLI, the coder, the utilities and the process layer
tmp = tempfile.mkdtemp()
src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
with open(src, "wb") as f:
    f.write(data)
stream_io.compress_file(src, dst, device="cpu", blocks_per_batch=1)
with open(dst, "rb") as f:
    assert f.read() == blob
assert cli.main(["info", dst]) == 0
freqs, cum = stats.build_model(np.frombuffer(data, np.uint8), 12)
e = coder.enc_symbol_init(freqs, cum, 12, BYTE_SPEC, device="cpu")
x = coder.enc_init((4,), BYTE_SPEC, device="cpu")
coder.enc_put_symbol(x, torch.tensor([0, 1, 2, 3]), e, BYTE_SPEC, 12)
debug.poison(4)
profiling.timed_runs(lambda: None, 1)
assert multihost.process_count() == 1 and mesh.DATA_AXIS == "data"
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "ryg_rans_tpu" or m.startswith("ryg_rans_tpu."))
assert not bad, bad
try:
    rt.compress(b"abc")
except RuntimeError as e:
    assert "no CUDA device" in str(e), e
else:
    raise AssertionError("compress without a card did not raise")
print("ok")
"""


def test_subprocess_round_trip_loads_no_jax():
    # an empty CUDA_VISIBLE_DEVICES hides any card, so the default device
    # must raise here as on a host without one
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("\nok")  # after the info lines


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module)
    return roots


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py", "decode_probe.py"]
    + [p.relative_to(ROOT).as_posix()
       for p in (ROOT / "examples").glob("torch_*.py")]))
def test_source_imports_no_jax(path):
    for mod in _imported_roots(ROOT / path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "ryg_rans_tpu"), (path, mod)


def test_wrappers_refuse_other_devices():
    syms = torch.zeros((1, 512), dtype=torch.uint8, device="meta")
    tab = torch.zeros(256, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no WORD encode kernel"):
        word.encode_blocks(syms, tab, tab, 128, 12)
    x0 = torch.zeros((1, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no WORD decode kernel"):
        word.decode_blocks(
            x0, torch.zeros(300, dtype=torch.int16, device="meta"),
            torch.zeros(1, dtype=torch.int64, device="meta"),
            torch.zeros(1, dtype=torch.int32, device="meta"),
            torch.zeros(4096, dtype=torch.uint8, device="meta"), tab, tab,
            512, 12)


def test_new_variant_wrappers_refuse_other_devices():
    def meta(n, dtype=torch.int32):
        return torch.zeros(n, dtype=dtype, device="meta")

    syms = torch.zeros((1, 512), dtype=torch.uint8, device="meta")
    tab = meta(256)
    with pytest.raises(ValueError, match="no BYTE/ALIAS encode kernel"):
        byte.encode_blocks(syms, tab, tab, None, 128, 12)
    with pytest.raises(ValueError, match="no RANS64 encode kernel"):
        rans64.encode_blocks(syms, tab, tab, 128, 20)
    stream = (meta((1, 128)), meta(900, torch.uint8), meta(1, torch.int64),
              meta(1))
    alias = (meta(256), meta(512), meta(512), meta(512))
    with pytest.raises(ValueError, match="no BYTE/ALIAS decode kernel"):
        byte.decode_blocks(*stream, alias, 512, 12, True)
    with pytest.raises(ValueError, match="no RANS64 decode kernel"):
        rans64.decode_blocks(meta((1, 128), torch.int64), meta(300),
                             meta(1, torch.int64), meta(1), None, tab,
                             meta(257), 512, 20)


def test_default_device_raises_without_a_card():
    """Runs here, where there is no card; where there is one the default
    device is the card and the subprocess test covers the refusal."""
    import ryg_rans_tpu_torch as rt

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    byte_cfg = rt.RansConfig.auto(3, rt.Variant.BYTE)
    for call in (lambda: rt.compress(b"abc"),
                 lambda: rt.compress(b"abc", byte_cfg),
                 lambda: rt.decompress(b"TRNS"),
                 lambda: rt.decompress_to_device(b"TRNS"),
                 lambda: rt.decompress_block(b"TRNS", 0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
