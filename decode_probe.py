#!/usr/bin/env python3
"""What sets the step time of the cluster decoders K3 and K5, on one GPU.

    python3 decode_probe.py [--out DIR]

Builds the decoders (``csrc/byte_decode.cu``, ``csrc/rans64_decode.cu``)
several times, each from a copy of ``csrc/`` with one part of the decode
step taken out, and times each build on the same full-width launch groups
(4 blocks of 2^23 symbols, 16384 lanes: BYTE prob_bits 14, ALIAS 16,
RANS64 14 and 31) at cluster sizes 8 and 16.  The gap between two builds is
what the part costs on the step's chain.  Builds, from the whole step down:

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
that skips work the decode needs.  The copies of ``csrc/`` go to
``DIR/probe_src/`` (default ``smoke_out/``, ignored by git); the build goes
to the package's ``_build/``.  Prints the card's name and power limit, one
line per (build, shape, C), and the same lines as JSON to
``DIR/decode_probe.json``.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="smoke_out")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("decode_probe: no CUDA device available", file=sys.stderr)
        return 1

    from ryg_rans_tpu_torch import _kernels, ops
    from ryg_rans_tpu_torch.config import RansConfig, Variant
    from ryg_rans_tpu_torch.models import stats
    from ryg_rans_tpu_torch.ops import decode_plan, host_prep

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    out_dir = Path(args.out)
    N, B, nb = 16384, 1 << 23, 4
    data = chip_smoke.skewed(np.random.default_rng(1), nb * B)
    shapes = []
    for v, pb in [(Variant.BYTE, 14), (Variant.ALIAS, 16),
                  (Variant.RANS64, 14), (Variant.RANS64, 31)]:
        cfg = RansConfig(variant=v, prob_bits=pb, n_lanes=N,
                         block_symbols=B)
        freqs, cum = stats.build_model(data, pb)
        c = chip_smoke.Codec(ops, host_prep, cfg, freqs, cum, "cuda")
        syms = torch.from_numpy(data).cuda().view(nb, B)
        blocks = c.mod.encode(cfg, syms.view(-1), freqs, cum)
        shapes.append((f"{v.name} pb{pb}", c,
                       c.mod.prep_decode(blocks, N, "cuda"), syms))
    csrc = _kernels.CSRC
    rows = []
    for build in ("kernel", "barrier", "no_exchange", "no_exchange_scan",
                  "no_exchange_scan_wait"):
        src = out_dir / "probe_src" / build
        patch(csrc, src, build)
        _kernels.CSRC = src.resolve()
        _kernels._libs.clear()
        _kernels.load(["byte_decode", "rans64_decode"])
        for label, c, stream, syms in shapes:
            for C in (8, 16):
                p = decode_plan.plan(c.variant, N, c.pb, cluster=C)
                out = c.decode(stream, B, plan=p)
                torch.cuda.synchronize()
                exact = bool(torch.equal(out, syms))
                ms = chip_smoke.cuda_ms(lambda: c.decode(stream, B, plan=p),
                                        20)
                row = {"build": build, "shape": label, "cluster": C,
                       "ms": ms, "us_per_step": ms * 1e3 / (B // N),
                       "exact": exact}
                rows.append(row)
                print(f"{build} {label} C={C}: {ms:.4f} ms for {nb} blocks, "
                      f"{row['us_per_step']:.3f} us a step, exact={exact}",
                      flush=True)
    _kernels.CSRC = csrc
    _kernels._libs.clear()
    (out_dir / "decode_probe.json").write_text(json.dumps(
        {"device": smi.splitlines()[0], "rows": rows}, indent=1))
    bad = [r for r in rows if r["build"] in ("kernel", "barrier")
           and not r["exact"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
