"""The port's C++ host core (``ryg_rans_tpu_torch.native``): its build,
its refusal to fall back, its engines and its threaded block coding, held
against the port's NumPy oracle and its own Python alias builder."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_corpora import random_bytes, skewed
import ryg_rans_tpu_torch as rt
from ryg_rans_tpu_torch import native
from ryg_rans_tpu_torch.models import alias as alias_mod
from ryg_rans_tpu_torch.models import stats
from ryg_rans_tpu_torch.ops import reference_numpy as oracle

ROOT = Path(__file__).resolve().parents[1]
V = rt.Variant


def test_library_builds_inside_the_package():
    lib = native.load()
    assert native.load() is lib
    so = native._lib_path("g++")
    assert so.exists() and so.parent.parent == native.BUILD_ROOT
    assert native.BUILD_ROOT == ROOT / "ryg_rans_tpu_torch" / "_build" / \
        "host"


def test_library_path_covers_the_build_hosts_cpu(monkeypatch):
    """-march=native code may not run on another CPU: another flags line
    is another library."""
    here = native._lib_path("g++")
    monkeypatch.setattr(native, "_cpu_flags", lambda: "flags\t: fpu sse2")
    assert native._lib_path("g++") != here


def test_no_gxx_raises_on_every_call(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    data = skewed(2000, seed=1)
    cfg = rt.RansConfig.reference(V.BYTE, 1)
    for _ in range(2):  # no cached failure: each call tries and raises
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            rt.compress(data, cfg, backend="native")
    blob = rt.compress(data, cfg, backend="numpy")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        rt.decompress(blob, backend="native")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        rt.decompress_block(blob, 0, backend="native")


def test_failed_build_raises_with_the_compilers_output(monkeypatch,
                                                       tmp_path):
    bad = tmp_path / "rans_core.cpp"
    bad.write_text("int trans_encode( {\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    for _ in range(2):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
            native.load()
        assert "rans_core.cpp" in str(e.value) and "error" in str(e.value)
    assert not list((tmp_path / "build").rglob("*.so"))


_BUILD = """
import sys
from pathlib import Path
from ryg_rans_tpu_torch import native
native.BUILD_ROOT = Path(sys.argv[1])
native.load()
print(native.build_seconds is not None)
"""


def test_concurrent_builds_agree(tmp_path):
    """Two processes building the same library at once each write their
    own temporary file and move it into place."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        assert out.strip() == "True"
    # no temporary file is left behind
    libs = list(tmp_path.rglob("*.so"))
    assert [p.name for p in libs] == ["rans_core.so"]


@pytest.mark.parametrize("variant", [V.BYTE, V.WORD, V.RANS64, V.ALIAS],
                         ids=["BYTE", "WORD", "RANS64", "ALIAS"])
def test_worker_count_does_not_change_the_container(variant, monkeypatch):
    """Blocks code on host threads in any order, and land in block
    order."""
    cfg = rt.RansConfig(variant=variant,
                        prob_bits=16 if variant == V.ALIAS else 12,
                        n_lanes=64, block_symbols=4096)
    data = skewed(40_000, seed=int(variant))
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    one = rt.compress(data, cfg, backend="native")
    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    four = rt.compress(data, cfg, backend="native")
    assert one == four == rt.compress(data, cfg, backend="numpy")
    assert rt.decompress(four, backend="native") == data.tobytes()


@pytest.mark.parametrize("variant,pb", [
    (V.BYTE, 14), (V.WORD, 12), (V.RANS64, 14), (V.ALIAS, 16),
    (V.BYTE, 16), (V.BYTE, 9), (V.WORD, 15), (V.ALIAS, 12), (V.RANS64, 20)])
def test_avx2_engines_match_the_scalar_engine(variant, pb, monkeypatch):
    """RANS_CORE_NO_AVX2 forces the scalar engine (read on each call): its
    streams and symbols equal the AVX2 engines' at 256 lanes of 64 a
    substream, on an odd length that leaves a partial last step."""
    cfg = rt.RansConfig(variant=variant, prob_bits=pb, n_lanes=256,
                        lanes_per_stream=64, block_symbols=1 << 18)
    data = skewed((1 << 16) - 37, seed=pb)
    freqs, cum = stats.build_model(data, pb)
    payload, words = native.encode(cfg, data, freqs, cum)
    dec_simd = native.decode(cfg, payload, words, data.size, freqs, cum)
    monkeypatch.setenv("RANS_CORE_NO_AVX2", "1")
    p2, w2 = native.encode(cfg, data, freqs, cum)
    dec_scalar = native.decode(cfg, payload, words, data.size, freqs, cum)
    assert bytes(payload) == bytes(p2) and np.array_equal(words, w2)
    assert np.array_equal(dec_simd, data) and np.array_equal(dec_scalar,
                                                             data)
    streams = oracle.encode(cfg, data, freqs, cum)
    assert payload.tobytes() == b"".join(s.tobytes() for s in streams)
    assert oracle.roundtrip_payload_bytes(cfg, streams) == payload.size


@pytest.mark.parametrize("pb", [8, 12, 16])
@pytest.mark.parametrize("corpus", ["skewed", "random"])
def test_alias_builder_matches_python(pb, corpus):
    data = (skewed if corpus == "skewed" else random_bytes)(50_000, seed=pb)
    freqs, cum = stats.build_model(data, pb)
    t_py = alias_mod.make_alias_tables(freqs, cum, pb)
    t_c = native.build_alias_tables(pb, freqs, cum)
    assert np.array_equal(t_c["divider"], t_py.divider)
    assert np.array_equal(t_c["slot_freqs"], t_py.slot_freqs)
    assert np.array_equal(t_c["slot_adjust"], t_py.slot_adjust)
    assert np.array_equal(t_c["sym_id"], t_py.sym_id.astype(np.uint8))
    assert np.array_equal(t_c["alias_remap"], t_py.alias_remap)


@pytest.mark.parametrize("variant", [V.BYTE, V.WORD, V.RANS64, V.ALIAS],
                         ids=["BYTE", "WORD", "RANS64", "ALIAS"])
def test_corrupt_streams_decode_in_bounds(variant):
    """Counts that do not describe the payload, or a substream shorter than
    its states, raise; a payload of zeros (states 0, which never reach L)
    decodes the same on both backends, each reading only its buffer."""
    cfg = rt.RansConfig(variant=variant,
                        prob_bits=16 if variant == V.ALIAS else 12,
                        n_lanes=8, lanes_per_stream=4, block_symbols=4096)
    data = skewed(4096, seed=5)
    freqs, cum = stats.build_model(data, cfg.prob_bits)
    payload, words = native.encode(cfg, data, freqs, cum)
    with pytest.raises(ValueError, match="corrupt"):
        native.decode(cfg, payload[:-4], words, data.size, freqs, cum)
    head = 4 * cfg.spec.state_words
    short = np.array([head - 1, int(words.sum()) - head + 1], np.int64)
    with pytest.raises(ValueError, match="corrupt"):
        native.decode(cfg, payload, short, data.size, freqs, cum)
    wdt = {1: np.uint8, 2: np.uint16, 4: np.uint32}[payload.size //
                                                    int(words.sum())]
    with pytest.raises(ValueError, match="corrupt"):
        oracle.decode(cfg, [np.zeros(head - 1, wdt), np.zeros(head, wdt)],
                      data.size, freqs, cum)
    # states of 0 stay 0: each step reads max_renorm words (of zeros) and
    # the lanes decode the slot-0 symbol, on both backends alike
    zeros = np.zeros_like(payload)
    out = native.decode(cfg, zeros, words, data.size, freqs, cum)
    streams = np.split(zeros.view(wdt), np.cumsum(words)[:-1])
    ref = oracle.decode(cfg, streams, data.size, freqs, cum)
    assert np.array_equal(out, ref)
    assert (out == np.argmax(np.asarray(freqs) > 0)).all()
