"""ryg_rans_tpu_torch.models.alias against the reference package's
make_alias_tables, field for field: the remap decides the ALIAS bitstream,
so the port's own copy must build the same tables."""

import dataclasses

import numpy as np
import pytest

from _torch_corpora import CORPORA, random_bytes
from ryg_rans_tpu.models import alias as jalias
from ryg_rans_tpu.models import stats as jstats
from ryg_rans_tpu_torch.models import alias as talias
from ryg_rans_tpu_torch.ops import host_prep


def _both(data, pb):
    freqs, cum = jstats.build_model(data, pb)
    return (talias.make_alias_tables(freqs, cum, pb),
            jalias.make_alias_tables(freqs, cum, pb), freqs, cum)


def _assert_same(mine, theirs):
    for field in dataclasses.fields(theirs):
        a, b = getattr(mine, field.name), getattr(theirs, field.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), field.name
        else:
            assert a == b, field.name


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("pb", range(9, 17))
def test_tables_match_reference(pb, corpus):
    mine, theirs, _, _ = _both(CORPORA[corpus](30_000, seed=pb), pb)
    _assert_same(mine, theirs)


def test_wrapped_adjust_model_matches_reference():
    """A near-uniform model whose slot adjusts leave [0, 2^16): stored as
    wrapped u32 negatives, or exactly 2^16."""
    mine, theirs, freqs, cum = _both(random_bytes(20_000, 3), 16)
    _assert_same(mine, theirs)
    adj = theirs.slot_adjust.astype(np.int64)
    assert adj.max() >= 1 << 16
    # the decode tables carry the true signed value
    _, _, _, sadj = host_prep.alias_dec_tables(freqs, cum, 16)
    assert np.array_equal(sadj.astype(np.int64) & 0xFFFFFFFF, adj)
    assert sadj.min() > -(1 << 16) and sadj.max() <= 1 << 16


def test_remap_is_a_bijection_onto_each_bucket():
    data = CORPORA["skewed"](30_000, seed=1)
    freqs, cum = jstats.build_model(data, 14)
    remap = host_prep.alias_remap(freqs, cum, 14).view(np.uint16)
    assert np.array_equal(np.sort(remap), np.arange(1 << 14))
