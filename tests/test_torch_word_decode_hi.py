"""The plain K1 version against the reference package's Pallas WORD
decoder (interpret mode) on the prob_bits 13-15 cases of test_torch_word."""

import pytest

from test_torch_word import CASES, IDS
from test_torch_word_decode import check_decode_matches_pallas


@pytest.mark.parametrize("case", CASES[4:], ids=IDS[4:])
def test_decode_matches_pallas(case):
    check_decode_matches_pallas(case)
