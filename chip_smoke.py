#!/usr/bin/env python3
"""Smoke run of ryg_rans_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py [--seed N] [--out DIR]

Phases, each fatal on failure:

1. build the WORD kernels (``csrc/*.cu``) with nvcc for sm_90a;
2. hold each kernel against its plain PyTorch version on the card, by exact
   equality of cells, states and symbols, launch group by launch group: at
   the main path's shapes (16384 lanes, prob_bits 11, eight 2^23-symbol
   blocks and a tail block), at prob_bits 12 with 1024 lanes, and on a
   prob_bits-15 one-symbol input;
3. drive the main path through the user entry points on a seeded skewed
   input of 64 MiB plus a tail (8 full blocks and a tail block):
   ``compress`` -> ``decompress`` byte-exact, the container equal to the one
   ``device="cpu"`` writes, then ``decompress_to_device`` and
   ``compress_from_device`` on the same container and data; launch counts
   are zeroed just before and read just after;
4. time each kernel (CUDA events) and its plain version at the main path's
   shapes, and the warm wall time of each entry point; then trace one
   ``compress`` and one ``decompress`` with torch.profiler.

It prints the card's name and power limit, the measurements, one
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.
Exits non-zero with no result when there is no CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

#: Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and the
#: float32 rate outside the tensor cores, taken as the rate of 32-bit
#: integer operations (Hopper's int32 rate is lower, so the bound errs low).
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12

MAIN_LEN = (64 << 20) + 1_234_567  # 8 full 2^23 blocks + a tail block


def skewed(rng: np.random.Generator, n: int) -> np.ndarray:
    """Text-like bytes: Zipf(1.1) over 82 printable symbols."""
    alphabet = np.arange(32, 32 + 82, dtype=np.uint8)
    p = 1.0 / np.arange(1, 83) ** 1.1
    cdf = np.cumsum(p / p.sum())
    idx = np.minimum(np.searchsorted(cdf, rng.random(n, np.float32)), 81)
    return alphabet[idx]


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: int, n_ops: int) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a, b) -> int:
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def check_kernels(rt_word, stats, host_prep, RansConfig, data_main):
    """Phase 2: each kernel against its plain version, launch group by
    launch group as the main path cuts the input, at three shapes."""
    import torch

    dev = torch.device("cuda")
    cases = [
        ("main path", RansConfig.auto(MAIN_LEN), data_main),
        ("pb12 1024 lanes",
         RansConfig(prob_bits=12, n_lanes=1024, block_symbols=1 << 16),
         data_main[:(3 << 16) + 4567]),
        ("pb15 one symbol",
         RansConfig(prob_bits=15, n_lanes=4096, block_symbols=1 << 16),
         np.full(3 << 16, 0x41, np.uint8)),
    ]
    worst = {"word_encode": 0, "word_decode": 0}
    for label, cfg, data in cases:
        N, pb = cfg.n_lanes, cfg.prob_bits
        freqs, cum = stats.build_model(data, pb)
        f, st = (torch.from_numpy(a).to(dev)
                 for a in host_prep.enc_tables(freqs, cum))
        c2s, fd, cd = (torch.from_numpy(a).to(dev)
                       for a in host_prep.dec_tables(freqs, cum, pb))
        padded = rt_word.pad_block(torch.from_numpy(data).to(dev), N, freqs)
        sizes = rt_word.block_sizes(cfg.block_symbols, padded.numel())
        shapes, e_enc, e_dec, pos = [], 0, 0, 0
        for _, nb, size in rt_word.groups(sizes):
            syms = padded[pos:pos + nb * size].view(nb, size)
            pos += nb * size
            shapes.append(f"{nb}x{size}")
            cells, states = rt_word.encode_blocks(syms, f, st, N, pb)
            cells_r, states_r = rt_word.encode_blocks_ref(syms, f, st, N, pb)
            torch.cuda.synchronize()
            e_enc = max(e_enc, max_abs_err(cells, cells_r),
                        max_abs_err(states, states_r))
            del cells, cells_r

            blocks = rt_word.encode(cfg, syms.view(-1), freqs, cum)
            stream = rt_word.prep_decode(blocks, N, dev)
            out = rt_word.decode_blocks(*stream, c2s, fd, cd, size, pb)
            out_r = rt_word.decode_blocks_ref(*stream, c2s, fd, cd, size, pb)
            torch.cuda.synchronize()
            e_dec = max(e_dec, max_abs_err(out, out_r),
                        max_abs_err(out, syms))
        print(f"kernel check {label}: n_lanes={N} prob_bits={pb} "
              f"launch groups (blocks x symbols) {shapes} encode "
              f"max_abs_err={e_enc} decode max_abs_err={e_dec} "
              f"(tolerance 0: exact)", flush=True)
        if e_enc or e_dec:
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"({label})")
        worst["word_encode"] = max(worst["word_encode"], e_enc)
        worst["word_decode"] = max(worst["word_decode"], e_dec)
    return worst


def profile(out_dir: Path, calls: dict) -> None:
    """End of phase 4: one warm call of each entry point under torch.profiler.
    Prints the wall time, the device-busy share (the summed device time of
    kernels, copies and fills over the wall time) and the host time of each
    ``rans.<phase>`` span of the API; the full op table goes to
    ``out_dir/profile_<name>.txt``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t
        device, spans = {}, {}
        for e in prof.events():
            if e.device_type == DeviceType.CPU and e.name.startswith("rans."):
                spans[e.name[5:]] = round(
                    spans.get(e.name[5:], 0.0) + e.cpu_time_total / 1e3, 3)
            # skip the profiler's own buffer setup and the device-side
            # copies of the rans.* spans, which enclose the work
            elif (e.device_type == DeviceType.CUDA
                    and e.name != "Activity Buffer Request"
                    and not e.name.startswith("rans.")):
                kind = ("copy" if "Memcpy" in e.name else
                        "fill" if "Memset" in e.name else "kernel")
                device[kind] = device.get(kind, 0.0) + \
                    e.time_range.elapsed_us() / 1e3
        busy = sum(device.values())
        print(f"profile {name}: wall {wall_s * 1e3:.3f} ms, device busy "
              f"{busy:.3f} ms ({100 * busy / 1e3 / wall_s:.2f} %) "
              f"{ {k: round(v, 3) for k, v in device.items()} }; host ms "
              f"per span {spans}", flush=True)
        (out_dir / f"profile_{name}.txt").write_text(
            prof.key_averages().table(sort_by="cpu_time_total",
                                      row_limit=40))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--out", default="smoke_out",
                    help="directory for the build log and profiles")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    import ryg_rans_tpu_torch as rt
    from ryg_rans_tpu_torch import _kernels
    from ryg_rans_tpu_torch.config import RansConfig
    from ryg_rans_tpu_torch.models import stats
    from ryg_rans_tpu_torch.ops import host_prep
    from ryg_rans_tpu_torch.ops import word as rt_word
    from ryg_rans_tpu_torch.utils import container as cont

    here = Path(__file__).resolve().parent
    if Path(rt.__file__).resolve().parent.parent != here:
        print(f"chip_smoke: ryg_rans_tpu_torch was imported from "
              f"{rt.__file__}, not from the checkout at {here}",
              file=sys.stderr)
        return 1

    smi =subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    _kernels.load()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(per source: {_kernels.build_seconds or 'cached'})", flush=True)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke_build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in _kernels.build_log.items()))
    for stem, log in _kernels.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {stem}: {line.strip()}", flush=True)

    rng = np.random.default_rng(args.seed)
    data = skewed(rng, MAIN_LEN)

    # -- phase 2: kernels against their plain versions ------------------------
    worst = check_kernels(rt_word, stats, host_prep, RansConfig, data)

    # -- phase 3: the main path through the user entry points ----------------
    cfg = RansConfig.auto(data.size)
    cfg_nocrc = dataclasses.replace(cfg, checksum=False)
    data_dev = torch.from_numpy(data).cuda()
    per_call = {}

    def counted(name, fn):
        before = (rt_word.encode_blocks.launches,
                  rt_word.decode_blocks.launches)
        result = fn()
        per_call[name] = (rt_word.encode_blocks.launches - before[0],
                          rt_word.decode_blocks.launches - before[1])
        return result

    torch.cuda.synchronize()
    rt_word.encode_blocks.launches = 0
    rt_word.decode_blocks.launches = 0
    blob = counted("compress", lambda: rt.compress(data))
    restored = counted("decompress", lambda: rt.decompress(blob))
    on_card = counted("decompress_to_device",
                      lambda: rt.decompress_to_device(blob))
    blob_dev = counted("compress_from_device",
                       lambda: rt.compress_from_device(data_dev))
    torch.cuda.synchronize()
    launches = {"word_encode": rt_word.encode_blocks.launches,
                "word_decode": rt_word.decode_blocks.launches}
    print(f"main path: cfg={cfg} launches={launches} per entry point "
          f"(word_encode, word_decode): {per_call}", flush=True)
    if restored != data.tobytes():
        raise AssertionError("decompress(compress(data)) != data")
    if not torch.equal(on_card, data_dev):
        raise AssertionError("decompress_to_device(blob) != data")
    if blob_dev != rt.compress(data, cfg_nocrc):
        raise AssertionError("compress_from_device differs from compress")
    if rt.decompress(blob_dev) != restored:
        raise AssertionError("compress_from_device container does not "
                             "round-trip")
    t0 = time.perf_counter()
    blob_cpu = rt.compress(data, device="cpu")
    t_cpu = time.perf_counter() - t0
    if blob_cpu != blob:
        raise AssertionError("container differs from the device='cpu' one")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    bpb = 8 * len(blob) / data.size
    print(f"round trip ok: {data.size} bytes -> {len(blob)} bytes "
          f"({bpb:.4f} bits/byte); device='cpu' container identical "
          f"(cpu compress {t_cpu:.2f} s)", flush=True)

    # -- phase 4: timing -------------------------------------------------------
    def wall(fn, reps=7):
        """Median and min of ``reps`` warm calls, in seconds."""
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return float(np.median(times)), min(times)

    gb = data.size / 1e9
    for name, fn in [
            ("compress", lambda: rt.compress(data)),
            ("decompress", lambda: rt.decompress(blob)),
            ("compress_from_device", lambda: rt.compress_from_device(data_dev)),
            ("decompress_to_device", lambda: rt.decompress_to_device(blob))]:
        med, low = wall(fn)
        print(f"{name} wall median {med * 1e3:.3f} ms ({gb / med:.4f} GB/s), "
              f"min {low * 1e3:.3f} ms [7 warm calls, host clock around "
              f"synchronize, {data.size} bytes]", flush=True)

    # kernels at the main path's full-block group: 8 blocks of 2^23
    N, pb, B = cfg.n_lanes, cfg.prob_bits, cfg.block_symbols
    nb = data.size // B
    freqs, cum = stats.build_model(data, pb)
    padded = rt_word.pad_block(data_dev, N, freqs)
    syms = padded[:nb * B].view(nb, B)
    f, st = (torch.from_numpy(a).cuda()
             for a in host_prep.enc_tables(freqs, cum))
    enc_ms = cuda_ms(lambda: rt_word.encode_blocks(syms, f, st, N, pb), 20)
    enc_plain_ms = cuda_ms(
        lambda: rt_word.encode_blocks_ref(syms, f, st, N, pb), 1)
    cells, _ = rt_word.encode_blocks(syms, f, st, N, pb)
    emitted = int((cells >= 0x10000).sum())
    del cells
    S = nb * B
    # bytes: symbols in, 4-byte cells and the states out, tables in; ops:
    # compare, divide, modulo, shift and two adds per symbol, and a mask
    # and a shift per emitted word
    enc_bound = bound_ms(S * (1 + 4) + nb * N * 4 + 2 * 256 * 4,
                         6 * S + 2 * emitted)

    c = cont.unpack(blob)
    blocks = [c.payloads[i][0] for i in range(nb)]
    stream = rt_word.prep_decode(blocks, N, "cuda")
    c2s, fd, cd = (torch.from_numpy(a).cuda()
                   for a in host_prep.dec_tables(c.freqs, cum, pb))
    dec_ms = cuda_ms(lambda: rt_word.decode_blocks(*stream, c2s, fd, cd, B,
                                                   pb), 20)
    dec_plain_ms = cuda_ms(lambda: rt_word.decode_blocks_ref(
        *stream, c2s, fd, cd, B, pb), 1)
    # one block is one CTA: if one block takes as long as nb of them, the
    # kernel's time is one CTA's chain of dependent steps, not the card's
    # throughput
    stream1 = rt_word.prep_decode(blocks[:1], N, "cuda")
    dec1_ms = cuda_ms(lambda: rt_word.decode_blocks(*stream1, c2s, fd, cd,
                                                    B, pb), 20)
    n_words = sum(int(b.size) for b in blocks)
    renorms = n_words - nb * 2 * N
    # bytes: the words in, symbols out, tables in; ops: mask, shift,
    # multiply, add, subtract and compare per symbol, and a shift and an
    # or per refill
    dec_bound = bound_ms(S + 2 * n_words + (1 << pb) + 2 * 256 * 4,
                         6 * S + 2 * renorms)
    print(f"encode kernel {enc_ms:.4f} ms ({S / enc_ms / 1e6:.3f} GB/s), "
          f"plain {enc_plain_ms:.2f} ms, bound {enc_bound[0]:.4f} ms "
          f"({enc_bound[1]}); decode kernel {dec_ms:.4f} ms "
          f"({S / dec_ms / 1e6:.3f} GB/s), plain {dec_plain_ms:.2f} ms, "
          f"bound {dec_bound[0]:.4f} ms ({dec_bound[1]}) "
          f"[{nb} blocks x {B} symbols, {N} lanes, prob_bits {pb}]; "
          f"decode kernel on 1 block (1 CTA) {dec1_ms:.4f} ms",
          flush=True)

    profile(out_dir, {"compress": lambda: rt.compress(data),
                      "decompress": lambda: rt.decompress(blob)})

    kernels = [
        {"name": "word_encode", "route": "cuda",
         "source": "ryg_rans_tpu_torch/csrc/word_encode.cu",
         "replaces": "ryg_rans_tpu/ops/word_tpu.py:318",
         "launches": launches["word_encode"],
         "max_abs_err": worst["word_encode"], "ms": enc_ms,
         "plain_ms": enc_plain_ms, "bound_ms": enc_bound[0],
         "bound_by": enc_bound[1], "library_ms": None},
        {"name": "word_decode", "route": "cuda",
         "source": "ryg_rans_tpu_torch/csrc/word_decode.cu",
         "replaces": "ryg_rans_tpu/ops/word_tpu.py:116",
         "launches": launches["word_decode"],
         "max_abs_err": worst["word_decode"], "ms": dec_ms,
         "plain_ms": dec_plain_ms, "bound_ms": dec_bound[0],
         "bound_by": dec_bound[1], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
