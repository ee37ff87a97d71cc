"""``portbench/reference`` writes the containers of the port's plain
PyTorch versions (``device="cpu"``) at small sizes, and imports nothing of
the port."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import ryg_rans_tpu_torch as rt
from portbench.reference import codec, config
from ryg_rans_tpu_torch import RansConfig, Variant

from ._cells import ROOT


def _text(n, seed):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 83) ** 1.1
    idx = np.searchsorted(np.cumsum(p / p.sum()), rng.random(n))
    return (32 + np.minimum(idx, 81)).astype(np.uint8)


@pytest.mark.parametrize("n", [1, 1000, 70_000, 600_000])
def test_auto_shape_matches_the_port(n):
    data = _text(n, n)
    assert codec.compress(data) == rt.compress(data, device="cpu")
    assert codec.compress(data, checksum=False) == rt.compress_from_device(
        torch.from_numpy(data.copy()))


def test_auto_rule_matches_the_port():
    for n in (1, 511, 2**20, 5 * 2**20 + 3, 10**8, 2**31):
        c, s = RansConfig.auto(n), config.auto(n)
        assert (c.variant.name, c.prob_bits, c.n_lanes, c.block_symbols) \
            == (s.variant, s.prob_bits, s.n_lanes, s.block_symbols)


@pytest.mark.parametrize("pb", [9, 12, 15])
def test_blocks_tail_and_raw_blocks_match_the_port(pb):
    rng = np.random.default_rng(pb)
    data = np.concatenate([_text(20_000, 1), rng.integers(
        0, 256, 9000, dtype=np.uint8), _text(3333, 2)])
    cfg = RansConfig(variant=Variant.WORD, prob_bits=pb, n_lanes=128,
                     block_symbols=4096)
    shape = config.Shape("WORD", pb, 128, 4096, True)
    assert codec.compress(data, shape) == rt.compress(data, cfg,
                                                      device="cpu")


def test_one_symbol_and_two_symbol_inputs_match_the_port():
    for data in (np.full(5000, 200, np.uint8),
                 np.array([0, 255] * 3000, np.uint8)):
        assert codec.compress(data) == rt.compress(data, device="cpu")


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.codec as c, numpy as np\n"
            "c.compress(np.arange(100, dtype=np.uint8))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    tops = eval(out)
    assert "ryg_rans_tpu_torch" not in tops and "torch" not in tops
    assert "ryg_rans_tpu" not in tops and "jax" not in tops
