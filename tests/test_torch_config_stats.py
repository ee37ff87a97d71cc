"""ryg_rans_tpu_torch config and order-0 model against the reference
package's, on synthetic corpora."""

import dataclasses

import numpy as np
import pytest

from _torch_corpora import CORPORA
from ryg_rans_tpu import config as jcfg
from ryg_rans_tpu.models import stats as jstats
from ryg_rans_tpu_torch import config as tcfg
from ryg_rans_tpu_torch import convert
from ryg_rans_tpu_torch.models import stats as tstats
from ryg_rans_tpu_torch.ops import host_prep

AUTO_SIZES = [0, 1, 4095, 4096, 65536, 1 << 20, (1 << 20) + 1, 2 << 20,
              4 << 20, (8 << 20) - 1, 8 << 20, 9 << 20, 16 << 20,
              (16 << 20) + 7, 32 << 20, 64 << 20]


def _fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["variant"] = int(d["variant"])
    return d


@pytest.mark.parametrize("n_bytes", AUTO_SIZES)
def test_auto_matches_reference(n_bytes):
    assert _fields(tcfg.RansConfig.auto(n_bytes)) == _fields(
        jcfg.RansConfig.auto(n_bytes))
    for v in jcfg.Variant:
        assert _fields(tcfg.RansConfig.auto(n_bytes, tcfg.Variant(int(v)))) \
            == _fields(jcfg.RansConfig.auto(n_bytes, v))


def test_auto_full_width_shape():
    cfg = tcfg.RansConfig.auto((8 << 20) + 1)
    assert (cfg.variant, cfg.prob_bits, cfg.n_lanes, cfg.block_symbols) == (
        tcfg.Variant.WORD, 11, 16384, 1 << 23)


def test_specs_and_defaults_match_reference():
    for v in jcfg.Variant:
        tv = tcfg.Variant(int(v))
        assert tv.name == v.name
        js, ts = jcfg.SPECS[v], tcfg.SPECS[tv]
        assert (js.state_bits, js.word_bits, js.l_bits, js.max_prob_bits,
                js.max_renorm, js.L, js.word_mask, js.state_words) == (
            ts.state_bits, ts.word_bits, ts.l_bits, ts.max_prob_bits,
            ts.max_renorm, ts.L, ts.word_mask, ts.state_words)
        assert jcfg.DEFAULT_PROB_BITS[v] == tcfg.DEFAULT_PROB_BITS[tv]
        assert _fields(tcfg.RansConfig.reference(tv, 2)) == _fields(
            jcfg.RansConfig.reference(v, 2))


@pytest.mark.parametrize("kwargs", [
    dict(n_lanes=0), dict(n_lanes=96), dict(block_symbols=0),
    dict(prob_bits=7), dict(prob_bits=17), dict(n_lanes=64, block_symbols=96),
    dict(lanes_per_stream=24)])
def test_invalid_configs_rejected_alike(kwargs):
    with pytest.raises(ValueError):
        jcfg.RansConfig(**kwargs)
    with pytest.raises(ValueError):
        tcfg.RansConfig(**kwargs)


def test_config_from_reference_roundtrip():
    ref = jcfg.RansConfig(variant=jcfg.Variant.WORD, prob_bits=13,
                          n_lanes=2048, block_symbols=1 << 16, checksum=False)
    got = convert.config_from_reference(dataclasses.asdict(ref))
    assert _fields(got) == _fields(ref)


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("pb", [9, 11, 12, 15, 16])
def test_model_matches_reference(corpus, pb):
    data = CORPORA[corpus](50_000, seed=pb)
    jf, jc = jstats.build_model(data, pb)
    tf, tc = tstats.build_model(data, pb)
    assert tf.dtype == jf.dtype and tc.dtype == jc.dtype
    assert np.array_equal(tf, jf) and np.array_equal(tc, jc)
    assert np.array_equal(tstats.count_freqs(data), jstats.count_freqs(data))
    assert np.array_equal(tstats.cum2sym(tc, pb), jstats.cum2sym(jc, pb))
    counts = np.bincount(data, minlength=256)
    tf2, tc2 = tstats.build_model_from_counts(counts, pb)
    assert np.array_equal(tf2, jf) and np.array_equal(tc2, jc)
    # the reference's model crosses over unchanged
    mf, mc = convert.model_from_reference(jf, jc)
    assert np.array_equal(mf, tf) and np.array_equal(mc, tc)


def test_one_symbol_model_is_degenerate():
    data = CORPORA["one_symbol"](1000)
    f, c = tstats.build_model(data, 15)
    assert int(f[0x41]) == 1 << 15 and int(f.sum()) == 1 << 15
    assert np.array_equal(tstats.cum2sym(c, 15), np.full(1 << 15, 0x41))


def test_empty_model_rejected():
    with pytest.raises(ValueError, match="empty"):
        tstats.normalize_freqs(np.zeros(256, np.uint32), 1 << 12)


def test_model_from_reference_rejects_broken_model():
    f, c = jstats.build_model(CORPORA["skewed"](4000), 12)
    bad = c.copy()
    bad[100] += 1
    with pytest.raises(ValueError):
        convert.model_from_reference(f, bad)
    with pytest.raises(ValueError):
        convert.model_from_reference(f[:255], c)
    with pytest.raises(ValueError):
        convert.model_from_reference(f.astype(np.float64), c)


@pytest.mark.parametrize("pb", [9, 12, 15])
def test_word_tables(pb):
    """The kernels' tables: slot -> symbol and the per-symbol freq/cum."""
    data = CORPORA["skewed"](20_000, seed=3)
    f, c = tstats.build_model(data, pb)
    c2s, fd, cd = host_prep.dec_tables(f, c, pb)
    assert c2s.dtype == np.uint8 and c2s.size == 1 << pb
    slots = np.arange(1 << pb)
    assert np.all((cd[c2s] <= slots) & (slots < cd[c2s] + fd[c2s]))
    fe, st = host_prep.enc_tables(f, c)
    assert np.array_equal(fe, f.astype(np.int32))
    assert np.array_equal(st, c[:256].astype(np.int32))
