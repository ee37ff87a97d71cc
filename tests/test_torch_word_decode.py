"""The plain K1 version through ryg_rans_tpu_torch.ops.codec.decode against
the reference package's Pallas WORD decoder (interpret mode), symbol for
symbol, on the prob_bits 9-12 cases of test_torch_word (the others are in
test_torch_word_decode_hi, so that each file stays short)."""

import numpy as np
import pytest

from ryg_rans_tpu.ops import word_tpu
from ryg_rans_tpu_torch.ops import codec
from test_torch_word import CASES, IDS, _port_encode, _setup


def check_decode_matches_pallas(case):
    cfg, jcfg, data, freqs, cum = _setup(case)
    blocks, padded = _port_encode(cfg, data, freqs, cum)
    sizes = codec.block_sizes(cfg.block_symbols, padded.numel())
    mine = codec.decode(cfg, blocks, sizes, freqs, cum, "cpu").numpy()
    theirs = word_tpu.decode(jcfg, blocks, padded.numel(), freqs, cum,
                             interpret=True)
    assert mine.dtype == theirs.dtype == np.uint8
    assert np.array_equal(mine, theirs)
    assert np.array_equal(mine[:data.size], data)


@pytest.mark.parametrize("case", CASES[:4], ids=IDS[:4])
def test_decode_matches_pallas(case):
    check_decode_matches_pallas(case)
