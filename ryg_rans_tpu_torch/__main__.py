"""Command-line interface: compress / decompress / info / bench.

Counterpart of the reference package's CLI, on the port: the same
subcommands, flags, defaults and printouts, where ``--device {cuda,cpu}``
(default ``cuda``: the kernels on the card, raising without one) and
``--backend {native,numpy}`` (default: none, the device codes) replace the
reference's ``--backend auto|tpu|native|numpy``.  ``compress`` and
``decompress`` stream the file through ``utils.stream_io``, a batch of
blocks at a time.

    python -m ryg_rans_tpu_torch compress  in.bin out.trns --variant word
    python -m ryg_rans_tpu_torch decompress out.trns roundtrip.bin
    python -m ryg_rans_tpu_torch info out.trns
    python -m ryg_rans_tpu_torch bench in.bin --variant word --runs 5

The package installs the same interface as the ``ryg-rans-tpu-torch`` script.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from . import api
from .config import DEFAULT_PROB_BITS, RansConfig, Variant
from .utils import container as cont

_VARIANTS = {v.name.lower(): v for v in Variant}


def _cfg_from_args(args, n_bytes: int = 0) -> RansConfig:
    variant = _VARIANTS[args.variant]
    if args.lanes == 0:
        # size-adaptive shape, like api.compress with no config; an
        # explicit --lanes-per-stream must keep its substream layout
        auto = RansConfig.auto(n_bytes, variant)
        return RansConfig(
            variant=variant,
            prob_bits=args.prob_bits or auto.prob_bits,
            n_lanes=auto.n_lanes,
            lanes_per_stream=args.lanes_per_stream or auto.n_lanes,
            block_symbols=args.block_symbols or auto.block_symbols,
            checksum=not args.no_crc,
        )
    return RansConfig(
        variant=variant,
        prob_bits=args.prob_bits or DEFAULT_PROB_BITS[variant],
        n_lanes=args.lanes,
        lanes_per_stream=args.lanes_per_stream or args.lanes,
        block_symbols=args.block_symbols or (1 << 19),
        checksum=not args.no_crc,
    )


def _add_route_flags(p: argparse.ArgumentParser):
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda = the kernels on the card; cpu = their plain "
                        "PyTorch versions")
    p.add_argument("--backend", choices=("native", "numpy"), default=None,
                   help="code on the host instead of --device: the C++ "
                        "core or the NumPy oracle (any config)")


def _add_codec_flags(p: argparse.ArgumentParser):
    p.add_argument("--variant", choices=sorted(_VARIANTS), default="word")
    p.add_argument("--prob-bits", type=int, default=0,
                   help="0 = variant default (14/12/14/16)")
    p.add_argument("--lanes", type=int, default=0,
                   help="interleaved coder states (power of two); "
                        "0 = size-adaptive (RansConfig.auto)")
    p.add_argument("--lanes-per-stream", type=int, default=0,
                   help="0 = one substream (the kernels' layout)")
    p.add_argument("--block-symbols", type=int, default=0,
                   help="0 = size-adaptive default")
    p.add_argument("--no-crc", action="store_true")
    _add_route_flags(p)


def cmd_compress(args) -> int:
    from .utils import stream_io
    n_in = os.path.getsize(args.input)
    cfg = _cfg_from_args(args, n_in)
    t0 = time.perf_counter()
    n_out = stream_io.compress_file(args.input, args.output, cfg,
                                    device=args.device, backend=args.backend)
    dt = time.perf_counter() - t0
    print(f"{n_in} -> {n_out} bytes "
          f"({8 * n_out / max(n_in, 1):.3f} bits/byte) "
          f"in {dt * 1e3:.1f} ms ({n_in / dt / 1048576:.1f} MiB/s)")
    return 0


def cmd_decompress(args) -> int:
    from .utils import stream_io
    n_in = os.path.getsize(args.input)
    t0 = time.perf_counter()
    n_out = stream_io.decompress_file(args.input, args.output,
                                      device=args.device,
                                      backend=args.backend)
    dt = time.perf_counter() - t0
    print(f"{n_in} -> {n_out} bytes in {dt * 1e3:.1f} ms "
          f"({n_out / dt / 1048576:.1f} MiB/s)")
    return 0


def cmd_info(args) -> int:
    with open(args.input, "rb") as f:
        c = cont.unpack(f.read())
    cfg = c.cfg
    used = int(np.count_nonzero(c.freqs))
    wsize = np.dtype(cont.word_dtype(cfg.variant)).itemsize
    counts = c.stream_words.astype(np.int64)
    if c.raw is not None:
        # raw blocks count bytes, coded blocks count variant words
        per_block = counts.sum(axis=1)
        payload = int(np.where(c.raw, per_block, per_block * wsize).sum())
        n_raw = int(np.count_nonzero(c.raw))
    else:
        payload = int(counts.sum() * wsize)
        n_raw = 0
    print(f"variant          {cfg.variant.name}")
    print(f"prob_bits        {cfg.prob_bits}")
    print(f"n_lanes          {cfg.n_lanes}")
    print(f"lanes_per_stream {cfg.lanes_per_stream}")
    print(f"block_symbols    {cfg.block_symbols}")
    print(f"blocks           {len(c.payloads)}")
    print(f"raw_blocks       {n_raw}")
    print(f"orig_len         {c.orig_len}")
    print(f"payload_bytes    {payload}")
    print(f"symbols_used     {used}")
    print(f"crc              {'yes' if c.crcs is not None else 'no'}")
    return 0


def cmd_bench(args) -> int:
    """Reference-style harness: timed runs each way, then a memcmp verify
    (main.cpp:164-214)."""
    with open(args.input, "rb") as f:
        data = f.read()
    cfg = _cfg_from_args(args, len(data))
    n = len(data)
    route = (f"backend={args.backend}" if args.backend
             else f"device={args.device}")
    print(f"{cfg.variant.name.lower()} rANS encode/decode "
          f"(prob_bits={cfg.prob_bits}, lanes={cfg.n_lanes}, {route}):")

    if args.backend is None and args.device == "cuda" and n < (8 << 20):
        print("note: wall-clock on small inputs is dominated by per-call "
              "host<->device transfer/sync, not codec speed; use a larger "
              "input or chip_smoke.py's kernel timings for device-rate "
              "numbers", file=sys.stderr)

    blob = None
    for _ in range(args.runs):
        t0 = time.perf_counter()
        blob = api.compress(data, cfg, device=args.device,
                            backend=args.backend)
        dt = time.perf_counter() - t0
        print(f"encode: {dt * 1e9 / max(n, 1):.1f} ns/symbol "
              f"({n / dt / 1048576:.1f} MiB/s)")
    print(f"rANS: {n} bytes -> {len(blob)} bytes "
          f"({8 * len(blob) / max(n, 1):.2f} bits/byte)")

    out = None
    for _ in range(args.runs):
        t0 = time.perf_counter()
        out = api.decompress(blob, device=args.device, backend=args.backend)
        dt = time.perf_counter() - t0
        print(f"decode: {dt * 1e9 / max(n, 1):.1f} ns/symbol "
              f"({n / dt / 1048576:.1f} MiB/s)")

    if out == data:
        print("decode ok!")
        return 0
    print("ERROR: bad decoder!")
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ryg_rans_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("compress", help="file -> TRNS container")
    p.add_argument("input")
    p.add_argument("output")
    _add_codec_flags(p)
    p.set_defaults(fn=cmd_compress)

    p = sub.add_parser("decompress", help="TRNS container -> file")
    p.add_argument("input")
    p.add_argument("output")
    _add_route_flags(p)
    p.set_defaults(fn=cmd_decompress)

    p = sub.add_parser("info", help="dump container header")
    p.add_argument("input")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("bench", help="reference-style 5-run timing")
    p.add_argument("input")
    p.add_argument("--runs", type=int, default=5)
    _add_codec_flags(p)
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
