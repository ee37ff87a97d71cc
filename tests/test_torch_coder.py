"""The port's lane-coder API (``ryg_rans_tpu_torch.ops.coder``) against the
JAX package's ``ops.coder``: every function on the same inputs, RANS64
under ``jax.enable_x64``, exact equality; plus the analogs of
tests/test_coder.py and tests/test_stream_twists.py on synthetic corpora
(the reference's versions take book1).  Everything runs on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_corpora import skewed
from ryg_rans_tpu.config import (BYTE_SPEC as J_BYTE, RANS64_SPEC as J_R64,
                                 WORD_SPEC as J_WORD)
from ryg_rans_tpu.ops import coder as jcoder
from ryg_rans_tpu_torch.config import (BYTE_SPEC, RANS64_SPEC, WORD_SPEC,
                                       RansConfig, Variant)
from ryg_rans_tpu_torch.models import stats
from ryg_rans_tpu_torch.ops import coder
from ryg_rans_tpu_torch.ops import reference_numpy as oracle

CPU = "cpu"
SPECS = {"BYTE": (BYTE_SPEC, J_BYTE, 14), "WORD": (WORD_SPEC, J_WORD, 12),
         "RANS64": (RANS64_SPEC, J_R64, 14),
         "RANS64-pb31": (RANS64_SPEC, J_R64, 31)}


def _model(sb, n=8192, seed=0):
    """A skewed corpus with every byte value once more: at prob_bits 14
    and below the rare values get freq 1 (rans_byte.h:199-228)."""
    data = np.concatenate([skewed(4 * n, seed),
                           np.arange(256, dtype=np.uint8)])
    freqs, cum = stats.build_model(data, sb)
    return data[:n], freqs, cum


def _c2s(cum, slots: np.ndarray) -> np.ndarray:
    """The symbol of each slot, by a search on ``cum`` (a cum2sym table
    would take 2^31 entries at prob_bits 31)."""
    return np.searchsorted(np.asarray(cum, np.int64)[1:],
                           np.asarray(slots, np.int64), side="right")


def _np(a) -> np.ndarray:
    """A port tensor or a JAX array as int64 values (u64 as bits)."""
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int64) if a.dtype == np.uint64 else a.astype(np.int64)


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert np.array_equal(_np(a), _np(b))


def _x64(spec):
    """JAX's 64-bit mode for RANS64, as the reference's tests run it."""
    return jax.enable_x64(spec.state_bits == 64)


def _states(rng, spec, n):
    """Renormalized states, L <= x < b*L, as u64 values."""
    hi = spec.L << spec.word_bits
    return rng.integers(spec.L, hi, n, dtype=np.uint64)


def _jstate(x, spec):
    return jnp.asarray(x.astype(np.uint32) if spec.state_bits == 32 else x)


def _tstate(x):
    return torch.from_numpy(x.view(np.int64).copy())


FUNCS = ["enc_init", "enc_renorm", "enc_put", "enc_put_raw", "enc_flush",
         "dec_init", "dec_get", "dec_advance_step", "dec_renorm",
         "dec_advance", "enc_symbol_init", "dec_symbol_init", "_mulhi",
         "enc_put_symbol", "dec_advance_symbol", "dec_advance_symbol_step"]


@pytest.mark.parametrize("variant", list(SPECS))
@pytest.mark.parametrize("name", FUNCS)
def test_function_matches_jax_coder(name, variant):
    """Each of the 16 functions gives the JAX coder's values on the same
    inputs."""
    spec, jspec, sb = SPECS[variant]
    rng = np.random.default_rng(FUNCS.index(name))
    n = 257
    _, freqs, cum = _model(sb)
    used = np.nonzero(freqs)[0]
    sym = rng.choice(used, n).astype(np.int32)
    x = _states(rng, spec, n)
    mask = (1 << sb) - 1
    words = rng.integers(0, 1 << spec.word_bits, 3 * n, dtype=np.uint64)
    wdt = {8: np.uint8, 16: np.uint16, 32: np.uint32}[spec.word_bits]
    stream = words.astype(wdt)
    with _x64(jspec):
        jx, tx = _jstate(x, spec), _tstate(x)
        jsym, tsym = jnp.asarray(sym), torch.from_numpy(sym)
        if name == "enc_init":
            got = coder.enc_init((n,), spec, device=CPU)
            want = jcoder.enc_init((n,), jspec)
        elif name == "enc_renorm":
            f = freqs[sym]
            got = coder.enc_renorm(tx, torch.from_numpy(f.astype(np.int64)),
                                   spec, sb)
            want = jcoder.enc_renorm(jx, jnp.asarray(f), jspec, sb)
        elif name == "enc_put":
            got = coder.enc_put(tx, tsym, freqs, cum, spec, sb)
            want = jcoder.enc_put(jx, jsym, freqs, cum, jspec, sb)
        elif name == "enc_put_raw":
            f, st = freqs[sym], cum[sym]
            got = coder.enc_put_raw(tx, torch.from_numpy(st.astype(np.int64)),
                                    torch.from_numpy(f.astype(np.int64)),
                                    spec, sb)
            want = jcoder.enc_put_raw(jx, jnp.asarray(st), jnp.asarray(f),
                                      jspec, sb)
        elif name == "enc_flush":
            got = coder.enc_flush(tx, spec)
            want = jcoder.enc_flush(jx, jspec)
        elif name == "dec_init":
            head = np.asarray(jcoder.enc_flush(jx, jspec))
            got = coder.dec_init(torch.from_numpy(head.astype(np.int64)),
                                 spec)
            want = jcoder.dec_init(jnp.asarray(head), jspec)
        elif name == "dec_get":
            got = coder.dec_get(tx, sb)
            want = jcoder.dec_get(jx, sb)
        elif name in ("dec_advance_step", "dec_advance"):
            s = _c2s(cum, x & np.uint64(mask))
            tst, tf = (torch.from_numpy(a[s].astype(np.int64))
                       for a in (cum, freqs))
            jst, jf = jnp.asarray(cum[s]), jnp.asarray(freqs[s])
            if name == "dec_advance_step":
                got = coder.dec_advance_step(tx, tst, tf, sb)
                want = jcoder.dec_advance_step(jx, jst, jf, sb)
            else:
                got = coder.dec_advance(tx, torch.from_numpy(stream), 5, tst,
                                        tf, spec, sb)
                want = jcoder.dec_advance(jx, jnp.asarray(stream),
                                          jnp.int32(5), jst, jf, jspec, sb)
        elif name == "dec_renorm":
            # states below L as a decode step leaves them
            y = x >> np.uint64(spec.word_bits + 1)
            got = coder.dec_renorm(_tstate(y), torch.from_numpy(stream), 7,
                                   spec)
            want = jcoder.dec_renorm(_jstate(y, spec), jnp.asarray(stream),
                                     jnp.int32(7), jspec)
        elif name == "enc_symbol_init":
            e = coder.enc_symbol_init(freqs, cum, sb, spec, device=CPU)
            j = jcoder.enc_symbol_init(freqs, cum, sb, jspec)
            got = (e.x_max, e.rcp_freq, e.bias, e.cmpl_freq, e.rcp_shift)
            want = (j.x_max, j.rcp_freq, j.bias, j.cmpl_freq, j.rcp_shift)
            assert e.state_bits == j.state_bits
        elif name == "dec_symbol_init":
            got = coder.dec_symbol_init(freqs, cum, device=CPU)
            want = jcoder.dec_symbol_init(freqs, cum)
        elif name == "_mulhi":
            b = rng.integers(0, 1 << 63, n, dtype=np.uint64) * np.uint64(2) \
                + np.uint64(1)
            b[:3] = [0, 1, 2**64 - 1]
            if spec.state_bits == 32:
                b &= np.uint64(0xFFFFFFFF)
            got = coder._mulhi(tx, _tstate(b), spec.state_bits)
            want = jcoder._mulhi(jx, _jstate(b, spec), jspec.state_bits)
        elif name == "enc_put_symbol":
            e = coder.enc_symbol_init(freqs, cum, sb, spec, device=CPU)
            j = jcoder.enc_symbol_init(freqs, cum, sb, jspec)
            got = coder.enc_put_symbol(tx, tsym, e, spec, sb)
            want = jcoder.enc_put_symbol(jx, jsym, j, jspec, sb)
        else:
            s = _c2s(cum, x & np.uint64(mask)).astype(np.int32)
            ts, tf = coder.dec_symbol_init(freqs, cum, device=CPU)
            js, jf = jcoder.dec_symbol_init(freqs, cum)
            if name == "dec_advance_symbol":
                got = coder.dec_advance_symbol(
                    tx, torch.from_numpy(stream), 0, ts, tf,
                    torch.from_numpy(s), spec, sb)
                want = jcoder.dec_advance_symbol(
                    jx, jnp.asarray(stream), jnp.int32(0), js, jf,
                    jnp.asarray(s), jspec, sb)
            else:
                got = coder.dec_advance_symbol_step(tx, ts, tf,
                                                    torch.from_numpy(s), sb)
                want = jcoder.dec_advance_symbol_step(jx, js, jf,
                                                      jnp.asarray(s), sb)
        _same(got, want)


@pytest.mark.parametrize("bits", [32, 64])
def test_mulhi_matches_python_integers(bits):
    """The high half of every product, at the corners where a partial
    product overflows int64's sign, equals Python's exact product."""
    top = (1 << bits) - 1
    vals = [0, 1, 2, 3, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**33 + 5,
            2**62, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 2, 2**64 - 1]
    vals = sorted({v & top for v in vals} | set(
        np.random.default_rng(1).integers(0, 2**63, 40).tolist()) if bits
        == 64 else {v & top for v in vals})
    a, b = np.meshgrid(np.array(vals, np.uint64), np.array(vals, np.uint64))
    got = coder._mulhi(_tstate(a.ravel().copy()), _tstate(b.ravel().copy()),
                       bits).numpy().view(np.uint64)
    want = [(int(p) * int(q)) >> bits for p, q in zip(a.ravel(), b.ravel())]
    assert got.tolist() == want


@pytest.mark.parametrize("variant", ["BYTE", "WORD"])
def test_enc_put_symbol_matches_slow_path(variant):
    """Division-free reciprocal encode == slow division encode over random
    valid states, including freq=1 symbols (rans_byte.h:199-228)."""
    spec, _, sb = SPECS[variant]
    rng = np.random.default_rng(713)
    _, freqs, cum = _model(sb)
    rare = np.where(freqs == 1)[0]
    assert rare.size  # the freq-1 path is exercised
    esyms = coder.enc_symbol_init(freqs, cum, sb, spec, device=CPU)
    syms = np.concatenate([rng.choice(np.where(freqs > 0)[0], 1000),
                           np.repeat(rare[:4], 8)])
    x = _tstate(_states(rng, spec, syms.size))
    fast = coder.enc_put_symbol(x, torch.from_numpy(syms), esyms, spec, sb)
    slow = coder.enc_put(x, torch.from_numpy(syms), freqs, cum, spec, sb)
    _same(fast, slow)


@pytest.mark.parametrize("sb", [14, 31])
def test_enc_put_symbol_matches_slow_path_rans64(sb):
    """64-bit reciprocal path (Rans64EncPutSymbol) == slow division, over
    states up to 2^63 - 1 and every used symbol."""
    spec = RANS64_SPEC
    rng = np.random.default_rng(714)
    _, freqs, cum = _model(sb)
    esyms = coder.enc_symbol_init(freqs, cum, sb, spec, device=CPU)
    syms = rng.choice(np.where(freqs > 0)[0], 2000)
    x = _states(rng, spec, syms.size)
    x[:4] = [spec.L, 2**63 - 1, 2**62, 2**62 + 12345]
    x = _tstate(x)
    fast = coder.enc_put_symbol(x, torch.from_numpy(syms), esyms, spec, sb)
    slow = coder.enc_put(x, torch.from_numpy(syms), freqs, cum, spec, sb)
    _same(fast, slow)


def _coder_encode(data, freqs, cum, spec, sb, N):
    """Assemble a stream with the low-level ops (forward layout)."""
    T = data.size // N
    esyms = coder.enc_symbol_init(freqs, cum, sb, spec, device=CPU)
    x = coder.enc_init((N,), spec, device=CPU)
    per_step = []
    for t in reversed(range(T)):
        syms = torch.from_numpy(data[t * N:(t + 1) * N].astype(np.int64))
        x, words, k = coder.enc_put_symbol(x, syms, esyms, spec, sb)
        per_step.append((words.numpy(), k.numpy()))
    per_step.reverse()
    head = coder.enc_flush(x, spec).numpy().reshape(-1)
    body = []
    for words, k in per_step:
        for lane in range(N):
            for r in range(spec.max_renorm - k[lane], spec.max_renorm):
                body.append(words[r, lane])
    return np.concatenate([head, np.array(body, np.int64)])


def _coder_decode(stream, n_symbols, freqs, cum, spec, sb, N):
    T = n_symbols // N
    starts, fr = coder.dec_symbol_init(freqs, cum, device=CPU)
    head = torch.from_numpy(stream[:N * spec.state_words].reshape(
        N, spec.state_words))
    x = coder.dec_init(head, spec)
    st = torch.from_numpy(stream)
    base = N * spec.state_words
    out = np.zeros(n_symbols, np.uint8)
    for t in range(T):
        sym = torch.from_numpy(_c2s(cum, coder.dec_get(x, sb).numpy()))
        out[t * N:(t + 1) * N] = sym.numpy()
        x = coder.dec_advance_symbol_step(x, starts, fr, sym, sb)
        x, base = coder.dec_renorm(x, st, base, spec)
    return out


@pytest.mark.parametrize("variant,sb,N", [
    (Variant.BYTE, 14, 4), (Variant.WORD, 12, 4), (Variant.RANS64, 14, 4),
    (Variant.RANS64, 31, 4), (Variant.ALIAS, 16, 128)],
    ids=["BYTE", "WORD", "RANS64", "RANS64-pb31", "ALIAS-quotient-128"])
def test_coder_stream_matches_oracle_and_roundtrips(variant, sb, N):
    """A stream assembled from the low-level ops equals the oracle's stream
    for the same lane config (ALIAS: its BYTE state machine, which the
    coder models), and decodes back via the Step/Renorm split (the
    interleave template, SURVEY.md §3.3)."""
    spec = RansConfig(variant=variant, prob_bits=sb).spec
    data, freqs, cum = _model(sb)
    data = data[:64 * N]
    stream = _coder_encode(data, freqs, cum, spec, sb, N)
    v = Variant.BYTE if variant == Variant.ALIAS else variant
    cfg = RansConfig(variant=v, prob_bits=sb, n_lanes=N,
                     lanes_per_stream=N, block_symbols=4 * N)
    ref = oracle.encode(cfg, data, freqs, cum)[0]
    assert np.array_equal(stream, ref.astype(np.int64))
    assert np.array_equal(
        _coder_decode(stream, data.size, freqs, cum, spec, sb, N), data)


def test_coder_rans64_roundtrip_every_state_word():
    """RANS64 over a one-symbol model at prob_bits 31: the renorm threshold
    freq << (63 - sb) is 2^63, the high head words pass 2^31, and the
    stream still equals the oracle's and decodes."""
    spec, sb, N = RANS64_SPEC, 31, 4
    data = np.full(64 * N, 0x41, np.uint8)
    freqs, cum = stats.build_model(data, sb)
    assert int(freqs.max()) == 1 << sb
    stream = _coder_encode(data, freqs, cum, spec, sb, N)
    cfg = RansConfig(variant=Variant.RANS64, prob_bits=sb, n_lanes=N,
                     block_symbols=4 * N)
    assert np.array_equal(stream, oracle.encode(cfg, data, freqs,
                                                cum)[0].astype(np.int64))
    assert np.array_equal(
        _coder_decode(stream, data.size, freqs, cum, spec, sb, N), data)


@pytest.mark.parametrize("variant", list(SPECS))
def test_coder_ops_any_lane_shape(variant):
    """The hot ops take a lane tensor of any shape (here [4, 16]) and give
    the values of the flat lanes (the JAX coder's jit test's analog)."""
    spec, _, sb = SPECS[variant]
    rng = np.random.default_rng(3)
    _, freqs, cum = _model(sb)
    esyms = coder.enc_symbol_init(freqs, cum, sb, spec, device=CPU)
    syms = torch.from_numpy(rng.choice(np.nonzero(freqs)[0], 64))
    x = _tstate(_states(rng, spec, 64))
    flat = coder.enc_put_symbol(x, syms, esyms, spec, sb)
    grid = coder.enc_put_symbol(x.view(4, 16), syms.view(4, 16), esyms, spec,
                                sb)
    assert grid[0].shape == (4, 16) and grid[1].shape == (spec.max_renorm,
                                                          4, 16)
    _same(tuple(g.reshape(-1) for g in grid),
          tuple(f.reshape(-1) for f in flat))
    starts, fr = coder.dec_symbol_init(freqs, cum, device=CPU)
    stream = torch.from_numpy(rng.integers(0, 1 << spec.word_bits, 256))
    y = coder.dec_advance_symbol_step(flat[0], starts, fr, syms, sb)
    yf, bf = coder.dec_renorm(y, stream, 0, spec)
    yg, bg = coder.dec_renorm(y.view(4, 16), stream, 0, spec)
    assert yg.shape == (4, 16) and int(bf) == int(bg)
    assert torch.equal(yg.reshape(-1), yf)


def test_word_threshold_wraps_as_u32_at_full_frequency():
    """At WORD freq 2^scale_bits the renorm threshold (L >> sb << 16) * freq
    is 2^32, 0 in u32: the port's coder keeps u32 arithmetic, as the JAX
    coder does, so every lane emits."""
    spec, sb = WORD_SPEC, 12
    freqs, cum = stats.build_model(np.full(1000, 7, np.uint8), sb)
    x = np.array([spec.L, 2**20, 2**32 - 1], np.uint64)
    got = coder.enc_put(_tstate(x), torch.tensor([7, 7, 7]), freqs, cum,
                        spec, sb)
    want = jcoder.enc_put(_jstate(x, spec), jnp.array([7, 7, 7]), freqs, cum,
                          J_WORD, sb)
    _same(got, want)
    assert got[2].tolist() == [1, 1, 1]


def test_tensor_makers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    freqs, cum = stats.build_model(skewed(1000), 12)
    for call in (lambda: coder.enc_init((4,), BYTE_SPEC),
                 lambda: coder.enc_symbol_init(freqs, cum, 12, BYTE_SPEC),
                 lambda: coder.dec_symbol_init(freqs, cum)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# -- stream twist #3 (rans_byte.h:28-35), the analog of
# tests/test_stream_twists.py


def _encode_phase(x, syms, freqs, cum, spec, sb):
    """Encode one phase (reverse symbol order, single lane); returns
    (x, words in DECODE order)."""
    step_words = []
    for s in reversed(syms.tolist()):
        x, w, k = coder.enc_put(x, torch.tensor([s]), freqs, cum, spec, sb)
        kk = int(k[0])
        # rows are most-significant-first; the fired rounds are the last kk
        step_words.append([int(w[r, 0]) for r in range(w.shape[0] - kk,
                                                       w.shape[0])])
    out = []
    for ws in reversed(step_words):  # first encoded decodes last
        out.extend(ws)
    return x, out


def _decode_phase(x, stream, base, n, freqs, cum, spec, sb):
    c2s = stats.cum2sym(np.asarray(cum, np.uint32), sb)
    starts, fr = coder.dec_symbol_init(freqs, cum, device=CPU)
    out = []
    for _ in range(n):
        s = int(c2s[int(coder.dec_get(x, sb)[0])])
        out.append(s)
        x, base = coder.dec_advance(x, stream, base, starts[[s]], fr[[s]],
                                    spec, sb)
    return x, base, np.array(out, np.uint8)


def test_midstream_raw_bytes_and_model_switch():
    """Raw bytes spliced into a coded stream with no marker, and the model
    switched mid-stream; the decoder reads head -> phase A -> raw -> phase
    B forward with one shared cursor."""
    sb = 14
    spec = RansConfig(variant=Variant.BYTE, prob_bits=sb).spec
    rng = np.random.default_rng(42)
    phase_a = skewed(96, seed=9)                      # text, model A
    raw = rng.integers(0, 256, 37, dtype=np.uint8)    # spliced verbatim
    phase_b = rng.integers(0, 8, 96, dtype=np.uint8)  # other stats, model B
    freqs_a, cum_a = stats.build_model(phase_a, sb)
    freqs_b, cum_b = stats.build_model(phase_b, sb)

    x = coder.enc_init((1,), spec, device=CPU)
    x, words_b = _encode_phase(x, phase_b, freqs_b, cum_b, spec, sb)
    x, words_a = _encode_phase(x, phase_a, freqs_a, cum_a, spec, sb)
    head = coder.enc_flush(x, spec).reshape(1, -1)
    stream = torch.tensor(words_a + raw.tolist() + words_b, dtype=torch.int64)

    x = coder.dec_init(head, spec)
    x, base, dec_a = _decode_phase(x, stream, 0, phase_a.size, freqs_a,
                                   cum_a, spec, sb)
    assert np.array_equal(dec_a, phase_a)
    b0 = int(base)
    assert np.array_equal(stream[b0:b0 + raw.size].numpy().astype(np.uint8),
                          raw)
    base = base + raw.size
    x, base, dec_b = _decode_phase(x, stream, base, phase_b.size, freqs_b,
                                   cum_b, spec, sb)
    assert np.array_equal(dec_b, phase_b)
    assert int(base) == stream.numel()  # every word consumed, in order


def test_midstream_twist_matches_jax_coder():
    """The same twist's stream, built by the JAX coder's ``enc_put``: the
    words and the head are the port's."""
    sb = 14
    spec = RansConfig(variant=Variant.BYTE, prob_bits=sb).spec
    phase = skewed(64, seed=10)
    freqs, cum = stats.build_model(phase, sb)
    x = coder.enc_init((1,), spec, device=CPU)
    x, words = _encode_phase(x, phase, freqs, cum, spec, sb)
    jx = jcoder.enc_init((1,), J_BYTE)
    jwords = []
    for s in reversed(phase.tolist()):
        jx, w, k = jcoder.enc_put(jx, jnp.asarray([s]), jnp.asarray(freqs),
                                  jnp.asarray(cum), J_BYTE, sb)
        kk = int(k[0])
        jwords.append([int(w[r, 0]) for r in range(w.shape[0] - kk,
                                                   w.shape[0])])
    assert words == [w for ws in reversed(jwords) for w in ws]
    _same(coder.enc_flush(x, spec), jcoder.enc_flush(jx, J_BYTE))
