#!/usr/bin/env python3
"""What sets the step time of the cluster decoders K1, K3 and K5 and of the
dense encoders K2, K4 and K6, on one GPU.

    python3 decode_probe.py [--out DIR] [--part all|decode|encode]

Builds the decoders (``csrc/word_decode.cu``, ``csrc/byte_decode.cu``,
``csrc/rans64_decode.cu``) several times, each from a copy of ``csrc/``
with one part of the decode step taken out, and times each build on the
same full-width launch groups (16384 lanes, 2^23-symbol blocks: WORD
prob_bits 11 on 8 blocks, the main path's group; BYTE prob_bits 14, ALIAS
16, RANS64 14 and 31 on 4 blocks) at cluster sizes 8 and 16.  The gap
between two builds is what the part costs on the step's chain.  Builds,
from the whole step down:

- ``kernel``: the sources as they are (exact: checked against the input);
- ``barrier``: the exchange of CTA totals through one cluster barrier a
  step, split into ``barrier.cluster.arrive.release`` and
  ``wait.acquire`` around the symbol stores, in place of the tagged posts;
- ``no_exchange``: each CTA takes its peers' totals to equal its own, so
  no CTA waits for another (the cursor still advances about as far);
- ``no_exchange_scan``: also no CTA-wide scan (a thread's rank is its
  count times its index; no barrier);
- ``no_exchange_scan_wait``: also no wait for the stream ring's copies.

Only ``kernel`` and ``barrier`` decode correctly; the others time a step
that skips work the decode needs.

Then builds the dense encoders K2 (``csrc/word_encode.cu``), K4
(``byte_encode.cu``) and K6 (``rans64_encode.cu``), which share the loop
of ``csrc/enc_tiles.cuh``, the same way, and times each build against the
plain version's cells and states on K2's WORD prob_bits 11 (8 blocks of
2^23 symbols, the main path's group), K4's BYTE prob_bits 14 and ALIAS 16
and K6's RANS64 prob_bits 14 and 31 (4 blocks each), all at 16384 lanes.
A build of the loop runs for all three encoders, a build of a step for its
own:

- ``kernel``: the sources as they are;
- ``global_symbols``: each step loads its symbol from device memory, with
  no tiles staged in shared memory;
- ``const_symbol``: no symbol load at all (each lane codes one symbol);
- ``no_prefetch``: each step loads its symbol and table row itself, on the
  chain, in place of the software pipeline that loads them a step ahead;
- ``hw_divide``: the quotient by the hardware's divide in place of the
  reciprocal (K2 and K4 u32 ``/``, K6 native u64 ``/``; K2 and K6 read
  freq from a table the probe builds, :func:`divide_table`);
- ``gm_reciprocal``: K2's quotient by the Granlund-Montgomery form (a
  32-bit multiplier with an add-back) in place of ``__umul64hi(x,
  ceil(2^64 / freq))``, from a table the probe builds
  (:func:`word_gm_table`);
- ``shift_divide``: K4's quotient as a shift (no divide, no reciprocal);
- ``global_remap``: ALIAS reads its remap from device memory through the
  read-only cache instead of shared memory;
- ``no_remap``: ALIAS skips the remap lookup;
- ``lanes2`` / ``lanes4``: 2 or 4 lanes a thread in place of 1 (256 or
  128 threads a CTA of 512 lanes);
- ``cta256`` / ``cta1024``: CTAs of 256 or 1024 lanes in place of 512.

All but ``const_symbol``, ``shift_divide`` and ``no_remap`` encode
exactly (K4's ``hw_divide`` only where no symbol has freq 1).  The copies
of ``csrc/`` go to ``DIR/probe_src/`` (default ``smoke_out/``, ignored by
git); the build goes to the package's ``_build/``.  Prints the card's name
and power limit, one line per (build, shape, C), and the same lines as JSON
to ``DIR/decode_probe.json``.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke

BARRIER_EXCHANGE = '''  __device__ __forceinline__ void post(int total, int t) const {
    if (static_cast<int>(threadIdx.x) < size)
      *cg::this_cluster().map_shared_rank(&slots[t & 1][rank],
                                          threadIdx.x) =
          static_cast<uint32_t>(total);
    asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: "memory");
  }

  __device__ __forceinline__ int collect(int t, int& sum) const {
    asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");
    int below = 0;
    sum = 0;
    for (int q = 0; q < size; ++q) {
      const int v = static_cast<int>(static_cast<uint32_t>(slots[t & 1][q]));
      sum += v;
      if (q < rank) below += v;
    }
    return below;
  }
};'''


def _sub(text: str, pattern: str, repl: str, flags=re.S) -> str:
    out, n = re.subn(pattern, lambda _: repl, text, count=1, flags=flags)
    if n != 1:
        raise RuntimeError(f"decode_probe: no match for {pattern!r}: the "
                           "sources changed, update the probe")
    return out


def patch(src: Path, dst: Path, build: str) -> None:
    """Copy ``src`` (csrc/) to ``dst`` with the parts of ``build`` taken
    out."""
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
    cs = dst / "cluster_stream.cuh"
    ls = dst / "lane_scan.cuh"
    text = cs.read_text()
    if build == "barrier":
        text = _sub(text, r"  __device__ __forceinline__ void post\(.*?\n};",
                    BARRIER_EXCHANGE)
    if build.startswith("no_exchange"):
        text = _sub(text, r"(void post\(int total, int t\) const \{\n)",
                    "void post(int total, int t) const {\n"
                    "    peek = total;\n    return;\n")
        text = _sub(text, r"(int collect\(int t, int& sum\) const \{\n)",
                    "int collect(int t, int& sum) const {\n"
                    "    sum = size * peek;\n    return rank * peek;\n")
        text = _sub(text, r"(  int rank, size;\n)",
                    "  int rank, size;\n  mutable int peek = 0;\n")
    if build.endswith("wait"):
        text = _sub(text, r"(void wait_for\(long long cursor\) const \{\n)",
                    "void wait_for(long long cursor) const {\n    return;\n")
    cs.write_text(text)
    if "scan" in build:
        ls.write_text(_sub(ls.read_text(),
                           r"(int& total\) \{\n)",
                           "int& total) {\n  total = count * blockDim.x;\n"
                           "  return count * threadIdx.x;\n"))


#: The encoder builds: (file in csrc/, pattern, replacement) each.  A build
#: that patches enc_tiles.cuh, the loop K2, K4 and K6 share, is built and
#: timed for all three; any other for the encoders whose sources it
#: patches.
ENCODE_PATCHES = {
    "global_symbols": [
        ("enc_tiles.cuh", r"  const int per_row = a\.cta_lanes >> 4;",
         "  return;  // no tiles\n  const int per_row = a.cta_lanes >> 4;"),
        ("enc_tiles.cuh",
         r"return tile\[\(\(t > lo \? t : lo\) - lo\) \* a\.cta_lanes "
         r"\+ k \* nthreads\];",
         "return src[static_cast<size_t>(t > lo ? t : lo) * a.n_lanes + "
         "tid + k * nthreads];")],
    "const_symbol": [
        ("enc_tiles.cuh", r"  const int per_row = a\.cta_lanes >> 4;",
         "  return;  // no tiles\n  const int per_row = a.cta_lanes >> 4;"),
        ("enc_tiles.cuh",
         r"return tile\[\(\(t > lo \? t : lo\) - lo\) \* a\.cta_lanes "
         r"\+ k \* nthreads\];",
         "return 32 + ((tid + k) & 63);")],
    "no_prefetch": [
        ("enc_tiles.cuh", r"step\(x\[k\], e\[k\]\)",
         "step(x[k], step.row(symbol(t, k)))")],
    "hw_divide": [
        ("byte_encode.cu", r"__umulhi\(xs, e\.y\) >> shift;", "xs / freq;"),
        ("byte_encode.cu", r"\(__umulhi\(xs, e\.y\) >> shift\)",
         "(xs / ((1u << pb) - low))"),
        # K2 and K6: q = x / freq, less one at freq 1 (the table's bias
        # folds it back), with freq in the reciprocal's place
        # (divide_table)
        ("word_encode.cu",
         r"const uint32_t q = static_cast<uint32_t>\(\n"
         r"        __umul64hi\(xs, \(static_cast<uint64_t>\(e\.z\) << 32\) "
         r"\| e\.y\)\);",
         "const uint32_t q = xs / e.y - (e.y == 1u);"),
        ("rans64_encode.cu",
         r"const uint64_t q = __umul64hi\(xs, rcp\) >> e\.b\.x;",
         "const uint64_t q = xs / rcp - (rcp == 1ull);")],
    # K2's quotient by the Granlund-Montgomery form, a 32-bit multiplier m
    # with an add-back, from the table of word_gm_table (x_max - 1, m, sh2,
    # bias | cmpl_freq << 16)
    "gm_reciprocal": [
        ("word_encode.cu",
         r"const uint32_t q = static_cast<uint32_t>\(\n"
         r"        __umul64hi\(xs, \(static_cast<uint64_t>\(e\.z\) << 32\) "
         r"\| e\.y\)\);",
         "const uint32_t t = __umulhi(xs, e.y);\n"
         "    const uint32_t q = (t + ((xs - t) >> 1)) >> e.z;")],
    "shift_divide": [  # the remap index masked to stay in the table
        ("byte_encode.cu", r"__umulhi\(xs, e\.y\) >> shift;", "xs >> shift;"),
        ("byte_encode.cu", r"\(__umulhi\(xs, e\.y\) >> shift\)",
         "(xs >> shift)"),
        ("byte_encode.cu", r"s_remap\[xs - q \* freq \+ low\]",
         "s_remap[(xs - q * freq + low) & ((1u << pb) - 1)]")],
    "global_remap": [
        ("byte_encode.cu", r"s_remap\[xs - q \* freq \+ low\]",
         "__ldg(remap + xs - q * freq + low)"),
        ("byte_encode.cu",
         r"for \(int i = tid; i < \(1 << pb\) / 8; i \+= nthreads\) "
         r"s\[i\] = g\[i\];", "(void)g;"),
        ("byte_encode.cu", r"\(remap \? sizeof\(uint16_t\) << prob_bits : 0\)",
         "0")],
    "no_remap": [
        ("byte_encode.cu", r"s_remap\[xs - q \* freq \+ low\]",
         "(xs - q * freq + low)")],
    "lanes2": [("enc_tiles.cuh", r"kLanesPerThread = 1;",
                "kLanesPerThread = 2;")],
    "lanes4": [("enc_tiles.cuh", r"kLanesPerThread = 1;",
                "kLanesPerThread = 4;")],
    "cta256": [("enc_tiles.cuh", r"kCtaLanes = 512;", "kCtaLanes = 256;")],
    "cta1024": [("enc_tiles.cuh", r"kCtaLanes = 512;", "kCtaLanes = 1024;")],
}
ENCODERS = {"word_encode.cu": "word_encode", "byte_encode.cu": "byte_encode",
            "rans64_encode.cu": "rans64_encode"}


def encoders_of(build: str) -> set[str]:
    """The encoder entry points a build patches (all three for the loop)."""
    files = {f for f, _, _ in ENCODE_PATCHES.get(build, [])}
    if not files or "enc_tiles.cuh" in files:
        return set(ENCODERS.values())
    return {ENCODERS[f] for f in files}


def patch_encoder(src: Path, dst: Path, build: str) -> None:
    """Copy ``src`` (csrc/) to ``dst`` with the encoder sources patched as
    ``build`` says."""
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
    for name, pattern, repl in ENCODE_PATCHES.get(build, []):
        f = dst / name
        f.write_text(_sub(f.read_text(), pattern, repl))


def word_gm_table(freqs, cum, pb: int) -> np.ndarray:
    """K2's table for the ``gm_reciprocal`` build: per symbol (x_max - 1,
    m, sh2, bias | cmpl_freq << 16) with, for freq >= 2, l =
    ceil(log2(freq)), m = floor(2^32 (2^l - freq) / freq) + 1 and sh2 = l -
    1, so that t = mulhi32(x, m), q = (t + ((x - t) >> 1)) >> sh2 is x /
    freq for every 32-bit x; at freq 1, m = 2^32 - 1 and sh2 = 0 (q = x -
    1, which the bias folds back)."""
    from ryg_rans_tpu_torch.ops import host_prep

    out = host_prep.word_enc_table(freqs, cum, pb).view(np.uint32).copy()
    for s, f in enumerate(int(f) for f in freqs):
        l = (f - 1).bit_length()
        m, sh2 = ((1 << 32) - 1, 0) if f < 2 else (
            ((1 << 32) * ((1 << l) - f)) // f + 1, l - 1)
        out[s, 1], out[s, 2] = m, sh2
    return out.view(np.int32)


def divide_table(table: np.ndarray, freqs) -> np.ndarray:
    """K2's or K6's table (int32 [256, 4] or [256, 8]) for the
    ``hw_divide`` build: freq in place of the 64-bit reciprocal (K2's
    columns 1-2, K6's 0-1; high word 0)."""
    out = table.copy()
    lo = 1 if out.shape[1] == 4 else 0
    out[:, lo] = np.asarray(freqs, np.int64).astype(np.uint32).view(np.int32)
    out[:, lo + 1] = 0
    return out


def probe_encoder(out_dir: Path, csrc: Path, _kernels, ops, stats,
                  host_prep, RansConfig, Variant) -> list[dict]:
    """The encoder builds on K2's WORD pb 11 (8 blocks), K4's BYTE pb 14
    and ALIAS pb 16 and K6's RANS64 pb 14 and 31 (4 blocks); one row per
    (build, shape)."""
    import torch

    N, B = 16384, 1 << 23
    data = chip_smoke.skewed(np.random.default_rng(2), 8 * B)
    syms8 = torch.from_numpy(data).cuda().view(8, B)
    shapes = []  # (label, entry, n_blocks, encode(build), want)

    def launcher(mod, syms, args, tabs):
        """encode(build): a call of ``mod.encode_blocks`` with the build's
        table (``tabs``, by build; default ``tabs["kernel"]``)."""
        def encode(build):
            table = tabs.get(build, tabs["kernel"])
            return lambda: mod.encode_blocks(syms, *args, table=table)
        return encode

    freqs, cum = stats.build_model(data, 11)
    f, st = (torch.from_numpy(a).cuda()
             for a in host_prep.enc_tables(freqs, cum))
    table = host_prep.word_enc_table(freqs, cum, 11)
    tabs = {"kernel": table, "hw_divide": divide_table(table, freqs),
            "gm_reciprocal": word_gm_table(freqs, cum, 11)}
    shapes.append(("WORD pb11", "word_encode", 8,
                   launcher(ops.word, syms8, (f, st, N, 11),
                            {k: torch.from_numpy(v).cuda()
                             for k, v in tabs.items()}),
                   ops.word.encode_blocks_ref(syms8, f, st, N, 11)))
    syms4 = syms8[:4]
    for v, pb in [(Variant.BYTE, 14), (Variant.ALIAS, 16),
                  (Variant.RANS64, 14), (Variant.RANS64, 31)]:
        cfg = RansConfig(variant=v, prob_bits=pb, n_lanes=N, block_symbols=B)
        freqs, cum = stats.build_model(data[:4 * B], pb)
        rec = ops.codec.codec_of(cfg)
        *model, table = rec.enc_tables(freqs, cum, pb, "cuda")
        tabs = {"kernel": table}
        if v == Variant.RANS64:
            tabs["hw_divide"] = torch.from_numpy(divide_table(
                table.cpu().numpy(), freqs)).cuda()
        shapes.append((f"{v.name} pb{pb}", f"{chip_smoke.kernel_stem(cfg)}"
                       "_encode", 4,
                       launcher(rec.ops, syms4, (*model, N, pb), tabs),
                       rec.ops.encode_blocks_ref(syms4, *model, N, pb)))
    rows = []
    for build in ("kernel",) + tuple(ENCODE_PATCHES):
        entries = encoders_of(build)
        src = out_dir / "probe_src" / f"encode_{build}"
        patch_encoder(csrc, src, build)
        _kernels.CSRC = src.resolve()
        _kernels._libs.clear()
        _kernels.load(sorted(entries))
        for label, entry, nb, encode, (cells_r, states_r) in shapes:
            if entry not in entries or (build in ("global_remap", "no_remap")
                                        and not label.startswith("ALIAS")):
                continue
            fn = encode(build)
            cells, states = fn()
            torch.cuda.synchronize()
            exact = bool(torch.equal(cells, cells_r)
                         and torch.equal(states, states_r))
            del cells, states
            ms = chip_smoke.cuda_ms(fn, 20)
            row = {"build": f"encode {build}", "shape": label, "ms": ms,
                   "ns_per_step": ms * 1e6 / (B // N), "exact": exact}
            rows.append(row)
            print(f"encode {build} {label}: {ms:.4f} ms for {nb} blocks, "
                  f"{row['ns_per_step']:.1f} ns a step, exact={exact}",
                  flush=True)
    return rows


def probe_decoders(out_dir: Path, csrc: Path, _kernels, ops, stats,
                   host_prep, RansConfig, Variant) -> list[dict]:
    """The decoder builds on every shape at C = 8 and 16; one row per
    (build, shape, C)."""
    import torch

    from ryg_rans_tpu_torch.ops import decode_plan

    N, B = 16384, 1 << 23
    data = chip_smoke.skewed(np.random.default_rng(1), 8 * B)
    shapes = []
    # WORD: the main path's 8-block group
    cfg = RansConfig(prob_bits=11, n_lanes=N, block_symbols=B)
    freqs, cum = stats.build_model(data, 11)
    syms = torch.from_numpy(data).cuda().view(8, B)
    cases = [(cfg, freqs, cum, syms)]
    for v, pb in [(Variant.BYTE, 14), (Variant.ALIAS, 16),
                  (Variant.RANS64, 14), (Variant.RANS64, 31)]:
        cfg = RansConfig(variant=v, prob_bits=pb, n_lanes=N,
                         block_symbols=B)
        cases.append((cfg, *stats.build_model(data[:4 * B], pb), syms[:4]))
    for cfg, freqs, cum, want in cases:
        rec = ops.codec.codec_of(cfg)
        pb = cfg.prob_bits
        tables = rec.dec_tables(freqs, cum, pb, "cuda")
        stream = rec.prep_decode(ops.codec.encode(cfg, want.reshape(-1),
                                                  freqs, cum), N, "cuda")
        shapes.append((f"{cfg.variant.name} pb{pb}", cfg.variant.name, pb,
                       want.shape[0],
                       lambda plan, rec=rec, stream=stream, tables=tables,
                       cfg=cfg: rec.decode_blocks(stream, tables, B, cfg,
                                                  plan=plan), want))
    rows = []
    for build in ("kernel", "barrier", "no_exchange", "no_exchange_scan",
                  "no_exchange_scan_wait"):
        src = out_dir / "probe_src" / build
        patch(csrc, src, build)
        _kernels.CSRC = src.resolve()
        _kernels._libs.clear()
        _kernels.load(["word_decode", "byte_decode", "rans64_decode"])
        for label, variant, pb, nb, decode, want in shapes:
            for C in (8, 16):
                p = decode_plan.plan(variant, N, pb, cluster=C)
                out = decode(p)
                torch.cuda.synchronize()
                exact = bool(torch.equal(out, want))
                del out
                ms = chip_smoke.cuda_ms(lambda: decode(p), 20)
                row = {"build": build, "shape": label, "cluster": C,
                       "ms": ms, "us_per_step": ms * 1e3 / (B // N),
                       "exact": exact}
                rows.append(row)
                print(f"{build} {label} C={C}: {ms:.4f} ms for {nb} blocks, "
                      f"{row['us_per_step']:.3f} us a step, exact={exact}",
                      flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="smoke_out")
    ap.add_argument("--part", choices=("all", "decode", "encode"),
                    default="all", help="probe the decoders, the encoders, or both")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("decode_probe: no CUDA device available", file=sys.stderr)
        return 1

    from ryg_rans_tpu_torch import _kernels, ops
    from ryg_rans_tpu_torch.config import RansConfig, Variant
    from ryg_rans_tpu_torch.models import stats
    from ryg_rans_tpu_torch.ops import host_prep

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    out_dir = Path(args.out)
    csrc = _kernels.CSRC
    rows = []
    probes = {"decode": probe_decoders, "encode": probe_encoder}
    for part, probe in probes.items():
        if args.part in ("all", part):
            rows += probe(out_dir, csrc, _kernels, ops, stats, host_prep,
                          RansConfig, Variant)
    _kernels.CSRC = csrc
    _kernels._libs.clear()
    (out_dir / "decode_probe.json").write_text(json.dumps(
        {"device": smi.splitlines()[0], "rows": rows}, indent=1))
    bad = [r for r in rows if r["build"] in ("kernel", "barrier",
                                             "encode kernel")
           and not r["exact"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
