#!/usr/bin/env python3
"""Smoke run of ryg_rans_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py [--seed N] [--out DIR]

Phases, each fatal on failure:

1. build all six kernels (``csrc/*.cu``) with nvcc for sm_90a, in parallel,
   and the C++ host core (``csrc/rans_core.cpp``) with g++;
2. hold each kernel against its plain PyTorch version on the card, by exact
   equality of cells, states and symbols, launch group by launch group.
   WORD (K1/K2): at the main path's shapes (16384 lanes, prob_bits 11,
   eight 2^23-symbol blocks and a tail block), at prob_bits 12 with 1024
   lanes, on a prob_bits-15 one-symbol input, and at full width
   (prob_bits 15, two 2^23-symbol blocks and a tail) on uniform random
   bytes and on a model whose dominant symbol has freq 2^15 - 3 (encoder
   states past 2^31).  BYTE/ALIAS (K3/K4) and
   RANS64 (K5/K6): at their full-width auto shapes (16384 lanes, 2^23-symbol
   blocks, BYTE prob_bits 14, ALIAS 16, RANS64 14 and 31; four full blocks
   and a tail), at BYTE prob_bits 16 (the 64 KB cum2sym), at RANS64
   prob_bits 24 and on a prob_bits-31 one-symbol input, on an ALIAS model
   whose slot adjusts wrap, at prob_bits 12 with 1024 lanes, and on uniform
   random bytes at full width (BYTE prob_bits 16, RANS64 31: about a refill
   a lane a step, the thinnest lead of the decoders' stream ring);
3. drive each variant's path through the user entry points on seeded skewed
   input: WORD on 64 MiB plus a tail (8 full blocks and a tail block) with
   no config, BYTE, ALIAS and RANS64 on 32 MiB plus a tail (4 full blocks
   and a tail block) at ``RansConfig.auto(n, variant)``.  ``compress`` ->
   ``decompress`` byte-exact, the container equal to the one ``device="cpu"``
   writes, then ``decompress_to_device`` and ``compress_from_device`` (and,
   for the new variants, ``decompress_block``) on the same container and
   data; all launch counts are zeroed just before each path and read just
   after it.  Then the host backends beside the card: on each path's input
   ``compress(..., backend="native")`` equals the card's container and each
   side decodes the other's; ``RansConfig.reference(v)`` at 1 and 2 lanes
   for every variant (1 MiB) and 16384 lanes of 2048 a substream (8 MiB)
   round-trip through ``native``, ``backend="numpy"`` writes the same
   container (at 16 KB and 1 MiB), and the card's ``decompress`` of them
   raises NotImplementedError naming the host backends.  Then the file
   path on each path's input (``compress_file`` / ``decompress_file``, 2
   blocks a batch: the container equals ``compress``'s, every batch
   reaches the kernels, and on the WORD main path each file call's peak
   device memory is at most half its in-memory counterpart's), the CLI
   (``python -m ryg_rans_tpu_torch`` compress, info, decompress and bench
   as subprocesses), two spawned ranks over gloo on cuda:0 (the sharded
   model, ``compress_multihost`` / ``decompress_multihost`` against the
   single-process container, ``roundtrip_step`` of every variant at its
   auto shape), a one-rank NCCL group's ``allgather_payloads``, and the
   lane-coder API at 16384 lanes on the card;
4. time each kernel (CUDA events) and its plain version on the full-block
   launch group of its path, and the warm wall time of each entry point of
   each path, and of native ``compress`` / ``decompress`` on each path's
   input (median of 5, beside the host's CPU model and core count), and
   the native core alone on one block on one thread; for
   the cluster decoders K1 (WORD), K3 (BYTE, ALIAS) and K5
   (RANS64 prob_bits 14 and 31), print the launch plan's cluster size C,
   the CTAs (SMs at most) a launch group uses,
   ``cudaOccupancyMaxActiveClusters``, and the group's and one block's time
   at every C the plan allows; for the encoders, the time a step; then
   trace one WORD ``compress`` and ``decompress``, on the card and
   through the native backend, with torch.profiler.

It prints the card's name and power limit, the measurements, one
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.
Exits non-zero with no result when there is no CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import platform
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

#: Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and the
#: float32 rate outside the tensor cores, taken as the rate of 32-bit
#: integer operations (Hopper's int32 rate is lower, so the bound errs low).
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12

MAIN_LEN = (64 << 20) + 1_234_567  # 8 full 2^23 blocks + a tail block
NEW_LEN = (32 << 20) + 1_234_567   # 4 full 2^23 blocks + a tail block


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


def random_full_width() -> np.ndarray:
    """Two 2^23-symbol blocks and a tail of uniform random bytes: about a
    refill a lane a step, the thinnest lead of the decoders' stream ring."""
    return np.random.default_rng(5).integers(0, 256, (2 << 23) + 4567,
                                             dtype=np.uint8)


def dominant_full_width() -> np.ndarray:
    """Two 2^23-symbol blocks and a tail of one symbol with three rare ones
    512 times each: at prob_bits 15 the model gives the rare ones freq 1
    and the dominant one 2^15 - 3, so a WORD lane that codes a rare symbol
    runs its state past 2^31 while it codes the dominant one, where
    rans_byte.h's 31-bit reciprocal is not exact."""
    n = (2 << 23) + 4567
    rng = np.random.default_rng(6)
    out = np.full(n, 0x41, np.uint8)
    out[rng.integers(0, n, 3 * 512)] = np.repeat(
        np.array([0x20, 0x61, 0xF0], np.uint8), 512)
    return out


def host_cpu() -> str:
    """The host's CPU: the first ``model name`` of /proc/cpuinfo (or that
    it shows none), the machine type, and whether its flags have AVX2 (the
    native core's vector engines)."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        lines = []
    model = next((ln.split(":", 1)[1].strip() for ln in lines
                  if ln.startswith("model name")), "model not shown")
    flags = next((ln.split() for ln in lines if ln.startswith("flags")), [])
    return (f"{model} ({platform.machine()}, AVX2 "
            f"{'yes' if 'avx2' in flags else 'no'})")


def check_host_backends(rt, RansConfig, Variant, paths, data_main) -> None:
    """The host backends beside the card.  ``paths`` maps each path's name
    to (cfg, input, the card's container): the native container equals the
    card's, and each side decodes the other's.  Then the layouts the card
    refuses round-trip through native, numpy writes the same container,
    and the card's decompress of them raises naming the host backends."""
    for name, (cfg, data, card_blob) in paths.items():
        blob = rt.compress(data, cfg, backend="native")
        if blob != card_blob:
            raise AssertionError(f"{name}: the native container differs "
                                 "from the card's")
        if rt.decompress(card_blob, backend="native") != data.tobytes():
            raise AssertionError(f"{name}: native does not decode the "
                                 "card's container")
        if rt.decompress(blob) != data.tobytes():
            raise AssertionError(f"{name}: the card does not decode the "
                                 "native container")
        print(f"host backends, {name} path: native container equal to the "
              f"card's ({len(blob)} bytes), each decodes the other's",
              flush=True)
    refused = [RansConfig.reference(v, n) for v in Variant for n in (1, 2)]
    refused.append(RansConfig(prob_bits=11, n_lanes=16384,
                              lanes_per_stream=2048, block_symbols=1 << 23))
    for cfg in refused:
        wide = cfg.n_lanes > 2
        data = data_main[:(8 << 20) + 12_345 if wide else 1 << 20]
        t0 = time.perf_counter()
        blob = rt.compress(data, cfg, backend="native")
        t_enc = time.perf_counter() - t0
        if rt.decompress(blob, backend="native") != data.tobytes():
            raise AssertionError(f"native round trip failed: {cfg}")
        # the NumPy oracle steps in Python: 16 KB at 1-2 lanes
        small = data[:1 << 20 if wide else 16 << 10]
        ref = rt.compress(small, cfg, backend="numpy")
        if ref != rt.compress(small, cfg, backend="native"):
            raise AssertionError(f"numpy and native containers differ: {cfg}")
        if rt.decompress(ref, backend="numpy") != small.tobytes():
            raise AssertionError(f"numpy round trip failed: {cfg}")
        try:
            rt.decompress(blob)
        except NotImplementedError as e:
            if 'backend="native"' not in str(e):
                raise AssertionError(f"the refusal names no host backend: "
                                     f"{e}") from None
        else:
            raise AssertionError(f"the card decoded a layout no kernel "
                                 f"takes: {cfg}")
        print(f"host backends, {cfg.variant.name} n_lanes={cfg.n_lanes} "
              f"lanes_per_stream={cfg.lanes_per_stream} prob_bits="
              f"{cfg.prob_bits}: native round trip of {data.size} bytes -> "
              f"{len(blob)} bytes (compress {t_enc * 1e3:.1f} ms); numpy "
              f"container equal at {small.size} bytes; the card refuses it, "
              f"naming the host backends", flush=True)


def check_kernels(rt_word, stats, host_prep, RansConfig, data_main):
    """Phase 2: each kernel against its plain version, launch group by
    launch group as the main path cuts the input, at five shapes."""
    import torch

    dev = torch.device("cuda")
    cases = [
        ("main path", RansConfig.auto(MAIN_LEN), data_main),
        ("pb15 random full width",
         RansConfig(prob_bits=15, n_lanes=16384, block_symbols=1 << 23),
         random_full_width()),
        ("pb12 1024 lanes",
         RansConfig(prob_bits=12, n_lanes=1024, block_symbols=1 << 16),
         data_main[:(3 << 16) + 4567]),
        ("pb15 one symbol",
         RansConfig(prob_bits=15, n_lanes=4096, block_symbols=1 << 16),
         np.full(3 << 16, 0x41, np.uint8)),
        ("pb15 dominant symbol full width",
         RansConfig(prob_bits=15, n_lanes=16384, block_symbols=1 << 23),
         dominant_full_width()),
    ]
    worst = {"word_encode": 0, "word_decode": 0}
    for label, cfg, data in cases:
        N, pb = cfg.n_lanes, cfg.prob_bits
        freqs, cum = stats.build_model(data, pb)
        f, st = (torch.from_numpy(a).to(dev)
                 for a in host_prep.enc_tables(freqs, cum))
        table = torch.from_numpy(host_prep.word_enc_table(freqs, cum,
                                                          pb)).to(dev)
        c2s, fd, cd = (torch.from_numpy(a).to(dev)
                       for a in host_prep.dec_tables(freqs, cum, pb))
        padded = rt_word.pad_block(torch.from_numpy(data).to(dev), N, freqs)
        sizes = rt_word.block_sizes(cfg.block_symbols, padded.numel())
        shapes, e_enc, e_dec, pos, x_top = [], 0, 0, 0, 0
        for _, nb, size in rt_word.groups(sizes):
            syms = padded[pos:pos + nb * size].view(nb, size)
            pos += nb * size
            shapes.append(f"{nb}x{size}")
            cells, states = rt_word.encode_blocks(syms, f, st, N, pb, table)
            cells_r, states_r = rt_word.encode_blocks_ref(syms, f, st, N, pb)
            torch.cuda.synchronize()
            e_enc = max(e_enc, max_abs_err(cells, cells_r),
                        max_abs_err(states, states_r))
            x_top = max(x_top, int((states.to(torch.int64)
                                    & 0xFFFFFFFF).max()))
            del cells, cells_r

            blocks = rt_word.encode(cfg, syms.view(-1), freqs, cum)
            stream = rt_word.prep_decode(blocks, N, dev)
            out = rt_word.decode_blocks(*stream, c2s, fd, cd, size, pb)
            out_r = rt_word.decode_blocks_ref(*stream, c2s, fd, cd, size, pb)
            torch.cuda.synchronize()
            e_dec = max(e_dec, max_abs_err(out, out_r),
                        max_abs_err(out, syms))
        print(f"kernel check {label}: n_lanes={N} prob_bits={pb} "
              f"max freq {int(np.max(freqs))} launch groups (blocks x "
              f"symbols) {shapes} encode max_abs_err={e_enc} decode "
              f"max_abs_err={e_dec} (tolerance 0: exact); largest final "
              f"encoder state {x_top}", flush=True)
        if e_enc or e_dec:
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"({label})")
        if "dominant" in label and (int(np.max(freqs)) != (1 << 15) - 3
                                    or x_top < 1 << 31):
            raise AssertionError("the dominant-symbol case does not reach "
                                 "states past 2^31 at freq 2^15 - 3")
        worst["word_encode"] = max(worst["word_encode"], e_enc)
        worst["word_decode"] = max(worst["word_decode"], e_dec)
    return worst


class Codec:
    """Uniform calls into ops.byte (BYTE, ALIAS) or ops.rans64 (RANS64)."""

    def __init__(self, ops, host_prep, cfg, freqs, cum, dev):
        import torch

        self.variant = cfg.variant.name
        self.mod = ops.rans64 if self.variant == "RANS64" else ops.byte
        self.N, self.pb = cfg.n_lanes, cfg.prob_bits
        f, st = (torch.from_numpy(a).to(dev)
                 for a in host_prep.enc_tables(freqs, cum))
        if self.variant == "RANS64":
            self.enc_tabs = (f, st)
            self.enc_kw = {"table": torch.from_numpy(
                host_prep.rans64_enc_table(freqs, cum, self.pb)).to(dev)}
            self.head_units = 2 * self.N  # u32 words
        else:
            remap = (torch.from_numpy(host_prep.alias_remap(
                freqs, cum, self.pb)).to(dev)
                if self.variant == "ALIAS" else None)
            self.enc_tabs = (f, st, remap)
            self.enc_kw = {"table": torch.from_numpy(host_prep.byte_enc_table(
                freqs, cum, self.pb, self.variant == "ALIAS")).to(dev)}
            self.head_units = 4 * self.N  # bytes
        self.dec_tabs = self.mod.dec_tables(cfg, freqs, cum, dev)

    def encode(self, syms, ref=False):
        if ref:
            return self.mod.encode_blocks_ref(syms, *self.enc_tabs, self.N,
                                              self.pb)
        return self.mod.encode_blocks(syms, *self.enc_tabs, self.N, self.pb,
                                      **self.enc_kw)

    def decode(self, stream, size, ref=False, plan=None):
        if ref:
            fn = self.mod.decode_blocks_ref
        else:
            def fn(*args):
                return self.mod.decode_blocks(*args, plan=plan)
        if self.variant == "RANS64":
            return fn(*stream, *self.dec_tabs, size, self.pb)
        return fn(*stream, self.dec_tabs, size, self.pb,
                  self.variant == "ALIAS")

    def emitted(self, cells) -> int:
        """Renorm units (bytes or words) the dense cells hold."""
        if self.variant == "RANS64":
            return int((cells != 0).sum())
        return int(((cells >> 16) & 3).sum())


def new_cases(RansConfig, Variant, data_main):
    """Phase-2 shapes of the BYTE, ALIAS and RANS64 kernels."""
    full = data_main[:NEW_LEN]
    small = data_main[:(3 << 16) + 4567]
    # a near-uniform model whose ALIAS slot adjusts leave [0, 2^16): the
    # histogram of these 20000 bytes, repeated (the same model)
    wrapped = np.tile(np.random.default_rng(3).integers(
        0, 256, 20000, dtype=np.uint8), 10)
    B, A, R = Variant.BYTE, Variant.ALIAS, Variant.RANS64

    def cfg(v, pb, n, bs=1 << 16):
        return RansConfig(variant=v, prob_bits=pb, n_lanes=n,
                          block_symbols=bs)

    r64 = RansConfig.auto(NEW_LEN, R)
    rnd = random_full_width()
    return [
        ("BYTE full width", RansConfig.auto(NEW_LEN, B), full),
        ("ALIAS full width", RansConfig.auto(NEW_LEN, A), full),
        ("RANS64 full width", r64, full),
        ("RANS64 pb31 full width", dataclasses.replace(r64, prob_bits=31),
         full),
        ("BYTE pb16", cfg(B, 16, 4096), small),
        ("RANS64 pb24", cfg(R, 24, 4096), small),
        ("RANS64 pb31 one symbol", cfg(R, 31, 4096),
         np.full(3 << 16, 0x41, np.uint8)),
        ("ALIAS pb16 wrapped adjust", cfg(A, 16, 1024), wrapped),
        ("BYTE pb12 1024 lanes", cfg(B, 12, 1024), small),
        ("ALIAS pb12 1024 lanes", cfg(A, 12, 1024), small),
        ("RANS64 pb12 1024 lanes", cfg(R, 12, 1024), small),
        ("BYTE pb16 random full width", cfg(B, 16, 16384, 1 << 23), rnd),
        ("RANS64 pb31 random full width", cfg(R, 31, 16384, 1 << 23), rnd),
    ]


def check_new_kernels(ops, stats, host_prep, cases):
    """Phase 2 for K3-K6: each kernel against its plain version, launch
    group by launch group as the entry points cut the input."""
    import torch

    dev = torch.device("cuda")
    worst = dict.fromkeys(["byte_encode", "byte_decode", "rans64_encode",
                           "rans64_decode"], 0)
    for label, cfg, data in cases:
        freqs, cum = stats.build_model(data, cfg.prob_bits)
        c = Codec(ops, host_prep, cfg, freqs, cum, dev)
        note = ""
        if label.startswith("ALIAS pb16 wrapped"):
            adj = host_prep.alias_dec_tables(freqs, cum, 16)[3]
            if not (adj.min() < 0 or adj.max() >= 1 << 16):
                raise AssertionError("the wrapped-adjust model does not wrap")
            note = f" slot adjust range [{adj.min()}, {adj.max()}]"
        padded = ops.word.pad_block(torch.from_numpy(data).to(dev), c.N,
                                    freqs)
        sizes = ops.word.block_sizes(cfg.block_symbols, padded.numel())
        shapes, e_enc, e_dec, pos = [], 0, 0, 0
        for _, nb, size in ops.word.groups(sizes, c.mod.GROUP_SYMBOLS):
            syms = padded[pos:pos + nb * size].view(nb, size)
            pos += nb * size
            shapes.append(f"{nb}x{size}")
            cells, states = c.encode(syms)
            cells_r, states_r = c.encode(syms, ref=True)
            torch.cuda.synchronize()
            e_enc = max(e_enc, max_abs_err(cells, cells_r),
                        max_abs_err(states, states_r))
            del cells, cells_r

            blocks = c.mod.encode(cfg, syms.view(-1), freqs, cum)
            stream = c.mod.prep_decode(blocks, c.N, dev)
            out = c.decode(stream, size)
            out_r = c.decode(stream, size, ref=True)
            torch.cuda.synchronize()
            e_dec = max(e_dec, max_abs_err(out, out_r),
                        max_abs_err(out, syms))
        print(f"kernel check {label}: {cfg.variant.name} n_lanes={c.N} "
              f"prob_bits={c.pb} launch groups (blocks x symbols) {shapes} "
              f"encode max_abs_err={e_enc} decode max_abs_err={e_dec} "
              f"(tolerance 0: exact){note}", flush=True)
        if e_enc or e_dec:
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"({label})")
        stem = "rans64" if cfg.variant.name == "RANS64" else "byte"
        worst[f"{stem}_encode"] = max(worst[f"{stem}_encode"], e_enc)
        worst[f"{stem}_decode"] = max(worst[f"{stem}_decode"], e_dec)
    return worst


def plan_report(variant, mod, N, pb, nb, B, decode, stream, stream1,
                dec_ms, dec1_ms) -> None:
    """Print a cluster decoder's launch plan, the CTAs its ``nb``-block group
    uses, ``cudaOccupancyMaxActiveClusters``, and its group's and one
    block's time at every cluster size C the plan allows.  ``decode(stream,
    plan)`` launches the kernel once."""
    import torch

    from ryg_rans_tpu_torch.ops import decode_plan

    plan = decode_plan.plan(variant, N, pb)
    sweep = []
    for C in decode_plan.cluster_sizes(N):
        p = decode_plan.plan(variant, N, pb, cluster=C)
        occ = mod.max_active_clusters(p, "cuda")
        t_nb = cuda_ms(lambda: decode(stream, p), 20)
        t_1 = cuda_ms(lambda: decode(stream1, p), 20)
        sweep.append(f"C={C} ({p.threads} threads x {p.lanes_per_thread} "
                     f"lanes, {p.smem_bytes} B shared, max active clusters "
                     f"{occ}): {t_nb:.4f} ms, one block {t_1:.4f} ms")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"{variant} prob_bits {pb} decode plan: C={plan.cluster}, "
          f"{plan.threads} threads x {plan.lanes_per_thread} lanes a CTA, "
          f"ring {plan.ring_bytes} B, {plan.smem_bytes} B dynamic shared; "
          f"{nb} blocks -> {nb * plan.cluster} CTAs (SMs used, at most; the "
          f"card has {n_sm}), cudaOccupancyMaxActiveClusters "
          f"{mod.max_active_clusters(plan, 'cuda')}; "
          f"{nb}-block group {dec_ms:.4f} ms, one block {dec1_ms:.4f} ms "
          f"({dec_ms * 1e3 / (B // N):.3f} us a step); per C: "
          + "; ".join(sweep), flush=True)


def time_new_kernels(ops, stats, host_prep, cfg, data, data_dev) -> dict:
    """Phase 4 for K3-K6: encode and decode kernel on the full-block launch
    group of ``cfg``'s path, their plain versions, and their bounds; the
    decoder's launch plan and its times at every cluster size it allows."""
    N, pb, B = cfg.n_lanes, cfg.prob_bits, cfg.block_symbols
    nb = data.size // B
    S = nb * B
    freqs, cum = stats.build_model(data, pb)
    c = Codec(ops, host_prep, cfg, freqs, cum, "cuda")
    syms = ops.word.pad_block(data_dev, N, freqs)[:S].view(nb, B)
    enc_ms = cuda_ms(lambda: c.encode(syms), 20)
    enc_plain_ms = cuda_ms(lambda: c.encode(syms, ref=True), 1)
    cells, _ = c.encode(syms)
    emitted = c.emitted(cells)
    del cells
    blocks = c.mod.encode(cfg, syms.view(-1), freqs, cum)
    stream = c.mod.prep_decode(blocks, N, "cuda")
    dec_ms = cuda_ms(lambda: c.decode(stream, B), 20)
    dec_plain_ms = cuda_ms(lambda: c.decode(stream, B, ref=True), 1)
    # one block alone against nb blocks: equal times mean the time is one
    # block's chain of steps, not the card's throughput
    stream1 = c.mod.prep_decode(blocks[:1], N, "cuda")
    dec1_ms = cuda_ms(lambda: c.decode(stream1, B), 20)
    plan_report(c.variant, c.mod, N, pb, nb, B,
                lambda s, p: c.decode(s, B, plan=p), stream, stream1, dec_ms,
                dec1_ms)
    units = sum(int(b.size) for b in blocks)
    M = 1 << pb
    # bytes: symbols in, dense cells and states out, tables in (decode:
    # the stream in, symbols out, tables in).  ops: per symbol, encode
    # compares, selects, multiplies high, shifts, multiplies and adds twice
    # (7), decode
    # masks, shifts, multiplies, adds, subtracts and compares (7; ALIAS
    # adds a shift, a compare and an add for the bucket half, RANS64 above
    # prob_bits 16 an 8-step search of a compare and an add each); 2 per
    # renorm unit (mask or shift, shift or or)
    if c.variant == "RANS64":
        wb, cell_b, state_b = 4, 8, 8
        enc_tab = 256 * 32
        dec_tab = (256 + 257) * 4 + (M if pb <= 16 else 0)
        dec_ops = 7 + (16 if pb > 16 else 0)
    else:
        wb, cell_b, state_b = 1, 4, 4
        enc_tab = 256 * 16 + (2 * M if c.variant == "ALIAS" else 0)
        dec_tab = ((256 + 3 * 512) * 4 if c.variant == "ALIAS"
                   else M + 2 * 256 * 4)
        dec_ops = 10 if c.variant == "ALIAS" else 7
    enc_bound = bound_ms(S * (1 + cell_b) + nb * N * state_b + enc_tab,
                         7 * S + 2 * emitted)
    renorms = units - nb * c.head_units
    dec_bound = bound_ms(S + wb * units + dec_tab, dec_ops * S + 2 * renorms)
    print(f"{c.variant} prob_bits {pb}: encode kernel {enc_ms:.4f} ms "
          f"({S / enc_ms / 1e6:.3f} GB/s, {enc_ms * 1e6 / (B // N):.1f} ns "
          f"a step), plain {enc_plain_ms:.2f} ms, "
          f"bound {enc_bound[0]:.4f} ms ({enc_bound[1]}); decode kernel "
          f"{dec_ms:.4f} ms ({S / dec_ms / 1e6:.3f} GB/s), plain "
          f"{dec_plain_ms:.2f} ms, bound {dec_bound[0]:.4f} ms "
          f"({dec_bound[1]}) [{nb} blocks x {B} symbols, {N} lanes]; "
          f"decode kernel on 1 block {dec1_ms:.4f} ms", flush=True)
    return {"enc": (enc_ms, enc_plain_ms, enc_bound),
            "dec": (dec_ms, dec_plain_ms, dec_bound)}


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


FILE_BATCH = 2  # blocks a batch on the file path: 2 of the main path's 9


def peak_call(fn):
    """(result, peak device bytes of ``fn`` above what was allocated when
    it began): tensors left alive by earlier phases count for neither
    side of a comparison."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def wall(fn, reps: int = 7) -> tuple[float, float]:
    """Median and min of ``reps`` warm calls, host clock around
    synchronize, in seconds."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return float(np.median(times)), min(times)


def check_file_path(rt, stream_io, counters, paths, tmp: Path) -> dict:
    """The file path on each path's input: ``compress_file`` (2 blocks a
    batch) writes ``compress``'s container, ``decompress_file`` gives the
    input back, every batch reaches the variant's kernels, and the peak
    device memory of each file call beside its in-memory counterpart (on
    the WORD main path at most half).  ``paths`` maps a name to (cfg or
    None, input, ``compress``'s container).  Returns the launches of each
    kernel over the file calls."""
    total = dict.fromkeys(counters, 0)
    for name, (cfg, data, blob) in paths.items():
        src, dst, back = (tmp / f"{name}.{ext}" for ext in ("in", "trns",
                                                             "back"))
        src.write_bytes(data.tobytes())
        c = cfg or rt.RansConfig.auto(data.size)
        step = 4 * c.n_lanes
        n_blocks = -(-(-(-data.size // step) * step) // c.block_symbols)
        batches = -(-n_blocks // FILE_BATCH)
        stem = {"WORD": "word", "RANS64": "rans64"}.get(c.variant.name,
                                                       "byte")
        launches, peaks = {}, {}
        for call, fn in [
                ("compress_file", lambda: stream_io.compress_file(
                    str(src), str(dst), cfg, blocks_per_batch=FILE_BATCH)),
                ("decompress_file", lambda: stream_io.decompress_file(
                    str(dst), str(back), blocks_per_batch=FILE_BATCH))]:
            for k in counters.values():
                k.launches = 0
            _, peaks[call] = peak_call(fn)
            launches[call] = {k: f.launches for k, f in counters.items()
                              if f.launches}
            for k, v in launches[call].items():
                total[k] += v
        if dst.read_bytes() != blob:
            raise AssertionError(f"{name}: compress_file's container "
                                 "differs from compress's")
        if back.read_bytes() != data.tobytes():
            raise AssertionError(f"{name}: decompress_file does not give "
                                 "the input back")
        enc = launches["compress_file"].get(f"{stem}_encode", 0)
        dec = launches["decompress_file"].get(f"{stem}_decode", 0)
        if enc < batches or dec < batches:
            raise AssertionError(f"{name}: {batches} batches but "
                                 f"{enc} encode / {dec} decode launches")
        _, peaks["compress"] = peak_call(lambda: rt.compress(data, cfg))
        _, peaks["decompress"] = peak_call(lambda: rt.decompress(blob))
        walls = {
            "compress_file": wall(lambda: stream_io.compress_file(
                str(src), str(dst), cfg, blocks_per_batch=FILE_BATCH), 3),
            "decompress_file": wall(lambda: stream_io.decompress_file(
                str(dst), str(back), blocks_per_batch=FILE_BATCH), 3),
            "compress": wall(lambda: rt.compress(data, cfg), 3),
            "decompress": wall(lambda: rt.decompress(blob), 3)}
        ratio_c = peaks["compress_file"] / peaks["compress"]
        ratio_d = peaks["decompress_file"] / peaks["decompress"]
        mib = {k: round(v / 2**20, 3) for k, v in peaks.items()}
        ms = {k: round(v[0] * 1e3, 3) for k, v in walls.items()}
        print(f"file path {name}: {data.size} bytes, {n_blocks} blocks in "
              f"{batches} batches of {FILE_BATCH}; container equal to "
              f"compress's, round trip exact; launches {launches}; peak "
              f"device MiB above the call's start {mib} (file / in-memory: "
              f"compress {ratio_c:.4f}, decompress {ratio_d:.4f}); wall "
              f"medians of 3, ms {ms}", flush=True)
        if name == "WORD" and (ratio_c > 0.5 or ratio_d > 0.5):
            raise AssertionError("the file path's peak device memory is "
                                 "above half the in-memory path's")
    return total


def check_cli(here: Path, tmp: Path, file_blob: bytes, data) -> None:
    """``python -m ryg_rans_tpu_torch`` compress, info, decompress and
    bench as subprocesses on the WORD main path's file: the container is
    ``compress_file``'s (``--prob-bits 11`` gives the auto config of
    ``compress(data)``), the round trip is exact, bench prints decode
    ok!."""
    env = dict(os.environ, PYTHONPATH=str(here))
    src, out, back = (str(tmp / n) for n in ("WORD.in", "cli.trns",
                                             "cli.back"))

    def cli(*args) -> str:
        t = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "ryg_rans_tpu_torch", *args], cwd=here,
            env=env, capture_output=True, text=True, timeout=300)
        if run.returncode:
            raise AssertionError(f"cli {args[0]} exited {run.returncode}: "
                                 f"{run.stderr[-2000:]}")
        lines = run.stdout.strip().splitlines()
        print(f"cli {args[0]} ({time.perf_counter() - t:.2f} s with the "
              f"interpreter's start): " + " | ".join(lines), flush=True)
        return run.stdout

    cli("compress", src, out, "--prob-bits", "11")
    if Path(out).read_bytes() != file_blob:
        raise AssertionError("the CLI's container differs from "
                             "compress_file's")
    if f"orig_len         {data.size}" not in cli("info", out):
        raise AssertionError("cli info does not show orig_len")
    cli("decompress", out, back)
    if Path(back).read_bytes() != data.tobytes():
        raise AssertionError("the CLI's round trip is not exact")
    if "decode ok!" not in cli("bench", src, "--prob-bits", "11", "--runs",
                               "3"):
        raise AssertionError("cli bench did not print decode ok!")


def rank_main(rank: int, world: int, store: str, tmp: str) -> None:
    """One of the spawned ranks: a gloo group through a ``file://`` store,
    every rank on cuda:0.  On the WORD main path's input the sharded model
    equals the single-process one, ``compress_multihost`` gives the
    single-process container's payloads block for block,
    ``decompress_multihost`` round-trips, and ``roundtrip_step`` is exact
    for every variant at its auto shape.  Writes its launch counts to
    ``tmp/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from ryg_rans_tpu_torch.config import RansConfig, Variant
    from ryg_rans_tpu_torch.models import stats
    from ryg_rans_tpu_torch.ops import byte, rans64, word
    from ryg_rans_tpu_torch.parallel import mesh as pmesh
    from ryg_rans_tpu_torch.parallel import multihost
    from ryg_rans_tpu_torch.utils import container as cont

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        t0 = time.perf_counter()
        mesh = pmesh.make_mesh(world, "cuda")
        data = np.fromfile(Path(tmp) / "WORD.in", np.uint8)
        blob = (Path(tmp) / "WORD.trns").read_bytes()
        cfg = RansConfig.auto(data.size)
        freqs, cum = pmesh.build_model_sharded(mesh, data, cfg.prob_bits)
        want_f, _ = stats.build_model(data, cfg.prob_bits)
        if not np.array_equal(freqs, want_f):
            raise AssertionError(f"rank {rank}: the sharded model differs")
        counters = {"word_encode": word.encode_blocks,
                    "word_decode": word.decode_blocks,
                    "byte_encode": byte.encode_blocks,
                    "byte_decode": byte.decode_blocks,
                    "rans64_encode": rans64.encode_blocks,
                    "rans64_decode": rans64.decode_blocks}
        for k in counters.values():
            k.launches = 0
        padded = word.pad_block(torch.from_numpy(data), cfg.n_lanes,
                                freqs).numpy()
        payloads = multihost.compress_multihost(padded, cfg, freqs, cum)
        c = cont.unpack(blob)
        if c.raw is not None or len(payloads) != len(c.payloads) or not all(
                np.array_equal(p, q[0]) for p, q in zip(payloads,
                                                        c.payloads)):
            raise AssertionError(f"rank {rank}: compress_multihost differs "
                                 "from the single-process container")
        out = multihost.decompress_multihost(payloads, cfg, padded.size,
                                             freqs, cum)
        if not np.array_equal(out[:data.size], data):
            raise AssertionError(f"rank {rank}: decompress_multihost")
        lo, hi = multihost.local_block_range(len(payloads))
        mh = {k: f.launches for k, f in counters.items()}
        for v in Variant:
            n = MAIN_LEN if v == Variant.WORD else NEW_LEN
            vcfg = RansConfig.auto(n) if v == Variant.WORD else \
                RansConfig.auto(n, v)
            vf, vc = pmesh.build_model_sharded(mesh, data[:n],
                                               vcfg.prob_bits)
            vpad = word.pad_block(torch.from_numpy(data[:n]), vcfg.n_lanes,
                                  vf).numpy()
            dec, _ = pmesh.roundtrip_step(mesh, vcfg, vpad, vf, vc)
            if not np.array_equal(dec.cpu().numpy(),
                                  pmesh.local_slice(mesh, vcfg, vpad)):
                raise AssertionError(f"rank {rank}: roundtrip_step {v.name}")
        torch.cuda.synchronize()
        result = {"rank": rank, "blocks": [lo, hi], "multihost": mh,
                  "all": {k: f.launches for k, f in counters.items()},
                  "seconds": time.perf_counter() - t0}
        print(f"processes: rank {rank} of {world} (gloo, cuda:0) owns "
              f"blocks {lo}-{hi - 1} of the WORD main path; its launches "
              f"in compress_multihost / decompress_multihost {mh}, and "
              f"with roundtrip_step of every variant {result['all']}; "
              f"{result['seconds']:.2f} s in the rank", flush=True)
        (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def nccl_main(rank: int, world: int, store: str, tmp: str) -> None:
    """A one-rank NCCL group: ``allgather_payloads`` through NCCL on the
    card (the route a machine with several cards takes)."""
    import torch
    import torch.distributed as dist

    from ryg_rans_tpu_torch.parallel import multihost

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        if str(multihost.comm_device()) != "cuda:0":
            raise AssertionError("NCCL's tensors are not on the card")
        local = [np.arange(n, dtype=np.uint16) for n in (5, 3, 9)]
        got = multihost.allgather_payloads(local, cap_words=16)
        if len(got) != 3 or not all(np.array_equal(a, b)
                                    for a, b in zip(got, local)):
            raise AssertionError("allgather_payloads through NCCL")
        (Path(tmp) / "nccl.json").write_text(json.dumps({"ok": True}))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args: tuple, timeout: float) -> None:
    """``fn(rank, world, *args)`` in ``world`` spawned processes (a fork
    after CUDA initialises fails); a rank's exception raises here, as does
    a group not done in ``timeout`` seconds, whose processes are killed."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(world, *args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"ranks not done after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)


def check_processes(tmp: Path) -> None:
    """Two ranks over gloo on cuda:0 (``rank_main``), then a one-rank NCCL
    group (``nccl_main``)."""
    t0 = time.perf_counter()
    spawn(rank_main, 2, (str(tmp / "store"), str(tmp)), timeout=600)
    for r in range(2):
        res = json.loads((tmp / f"rank{r}.json").read_text())
        if not (res["multihost"]["word_encode"]
                and res["multihost"]["word_decode"]):
            raise AssertionError(f"rank {r} launched no WORD kernel")
        if not all(res["all"].values()):
            raise AssertionError(f"rank {r}: a kernel was not launched")
    print(f"processes: 2 ranks exact (sharded model, compress_multihost "
          f"payloads equal to the single-process container's, "
          f"decompress_multihost, roundtrip_step of WORD, BYTE, ALIAS, "
          f"RANS64) in {time.perf_counter() - t0:.2f} s with spawning",
          flush=True)
    spawn(nccl_main, 1, (str(tmp / "nccl_store"), str(tmp)), timeout=300)
    print("processes: a one-rank NCCL group gathered payloads on the card",
          flush=True)


def check_coder(coder, stats, oracle, RansConfig, Variant, data) -> None:
    """The lane-coder API on the card at 16384 lanes: ``enc_put_symbol``
    equals ``enc_put`` (BYTE, WORD, RANS64 at prob_bits 14 and 31), and a
    block of 16 steps coded with ``enc_put`` gives the NumPy oracle's
    stream and decodes back through ``dec_advance_symbol_step`` /
    ``dec_renorm``."""
    import torch

    dev = torch.device("cuda")
    N, T = 16384, 16
    rng = np.random.default_rng(17)
    for v, pb in ((Variant.BYTE, 14), (Variant.WORD, 12),
                  (Variant.RANS64, 14), (Variant.RANS64, 31)):
        cfg = RansConfig(variant=v, prob_bits=pb, n_lanes=N,
                         block_symbols=N * T)
        spec = cfg.spec
        blk = data[:N * T]
        freqs, cum = stats.build_model(blk, pb)
        x = rng.integers(spec.L, spec.L << spec.word_bits, N,
                         dtype=np.uint64)
        x = torch.from_numpy(x.view(np.int64).copy()).to(dev)
        sym = torch.from_numpy(rng.choice(np.nonzero(freqs)[0], N)).to(dev)
        esyms = coder.enc_symbol_init(freqs, cum, pb, spec)
        fast = coder.enc_put_symbol(x, sym, esyms, spec, pb)
        slow = coder.enc_put(x, sym, freqs, cum, spec, pb)
        if not all(torch.equal(a, b) for a, b in zip(fast, slow)):
            raise AssertionError(f"coder {v.name} pb {pb}: enc_put_symbol "
                                 "differs from enc_put")
        # a block through enc_put, step by step from the last
        grid = torch.from_numpy(blk.astype(np.int64)).to(dev).view(T, N)
        x = coder.enc_init((N,), spec)
        steps = []
        for t in reversed(range(T)):
            x, words, k = coder.enc_put(x, grid[t], freqs, cum, spec, pb)
            steps.append((words, k))
        R = spec.max_renorm
        col = torch.arange(R, device=dev)
        body = [w.T[col >= R - k.view(-1, 1)] for w, k in reversed(steps)]
        stream = torch.cat([coder.enc_flush(x, spec).reshape(-1), *body])
        ref = oracle.encode(cfg, blk, freqs, cum)[0].astype(np.int64)
        if not np.array_equal(stream.cpu().numpy(), ref):
            raise AssertionError(f"coder {v.name} pb {pb}: enc_put's "
                                 "stream differs from the oracle's")
        starts, fr = coder.dec_symbol_init(freqs, cum)
        cum_t = torch.from_numpy(cum.astype(np.int64)).to(dev)
        y = coder.dec_init(stream[:N * spec.state_words].view(N, -1), spec)
        base = N * spec.state_words
        for t in range(T):
            s = torch.searchsorted(cum_t[1:], coder.dec_get(y, pb),
                                   right=True)
            if not torch.equal(s, grid[t]):
                raise AssertionError(f"coder {v.name} pb {pb}: decode")
            y = coder.dec_advance_symbol_step(y, starts, fr, s, pb)
            y, base = coder.dec_renorm(y, stream, base, spec)
        if int(base) != stream.numel():
            raise AssertionError(f"coder {v.name} pb {pb}: stream not "
                                 "consumed")
        print(f"coder {v.name} prob_bits {pb}, {N} lanes on the card: "
              f"enc_put_symbol equals enc_put; enc_put over {T} steps gives "
              f"the oracle's stream ({stream.numel()} words), which decodes "
              f"back", flush=True)


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
    from ryg_rans_tpu_torch import _kernels, native, ops
    from ryg_rans_tpu_torch.config import RansConfig
    from ryg_rans_tpu_torch.models import stats
    from ryg_rans_tpu_torch.config import Variant
    from ryg_rans_tpu_torch.ops import byte, host_prep, rans64
    from ryg_rans_tpu_torch.ops import coder
    from ryg_rans_tpu_torch.ops import reference_numpy as oracle
    from ryg_rans_tpu_torch.ops import word as rt_word
    from ryg_rans_tpu_torch.utils import container as cont
    from ryg_rans_tpu_torch.utils import stream_io

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
    t0 = time.perf_counter()
    native.load()
    gxx = ("cached" if native.build_seconds is None
           else f"{native.build_seconds:.2f} s")
    print(f"host core build (g++ {' '.join(native.GXX_FLAGS)}): "
          f"{time.perf_counter() - t0:.2f} s (g++ run: {gxx})", flush=True)

    rng = np.random.default_rng(args.seed)
    data = skewed(rng, MAIN_LEN)

    # -- phase 2: kernels against their plain versions ------------------------
    worst = check_kernels(rt_word, stats, host_prep, RansConfig, data)
    worst.update(check_new_kernels(ops, stats, host_prep,
                                   new_cases(RansConfig, Variant, data)))

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

    # the BYTE, ALIAS and RANS64 paths, each with the counts zeroed before
    # it and read after it
    counters = {"word_encode": rt_word.encode_blocks,
                "word_decode": rt_word.decode_blocks,
                "byte_encode": byte.encode_blocks,
                "byte_decode": byte.decode_blocks,
                "rans64_encode": rans64.encode_blocks,
                "rans64_decode": rans64.decode_blocks}
    data_new = data[:NEW_LEN]
    data_new_dev = data_dev[:NEW_LEN]
    new_paths = {}
    for name in ("BYTE", "ALIAS", "RANS64"):
        vcfg = RansConfig.auto(NEW_LEN, Variant[name])
        vnocrc = dataclasses.replace(vcfg, checksum=False)
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        vblob = rt.compress(data_new, vcfg)
        vrestored = rt.decompress(vblob)
        von_card = rt.decompress_to_device(vblob)
        vblob_dev = rt.compress_from_device(data_new_dev, vnocrc)
        vblock = rt.decompress_block(vblob, 1)
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in counters.items()}
        stem = "rans64" if name == "RANS64" else "byte"
        print(f"{name} path: cfg={vcfg} launches={counts}", flush=True)
        if vrestored != data_new.tobytes():
            raise AssertionError(f"{name}: decompress(compress(data)) != data")
        if not torch.equal(von_card, data_new_dev):
            raise AssertionError(f"{name}: decompress_to_device != data")
        B = vcfg.block_symbols
        if vblock != data_new[B:2 * B].tobytes():
            raise AssertionError(f"{name}: decompress_block(blob, 1) != "
                                 "its block")
        if vblob_dev != rt.compress(data_new, vnocrc):
            raise AssertionError(f"{name}: compress_from_device differs "
                                 "from compress")
        t0 = time.perf_counter()
        vblob_cpu = rt.compress(data_new, vcfg, device="cpu")
        t_cpu = time.perf_counter() - t0
        if vblob_cpu != vblob:
            raise AssertionError(f"{name}: container differs from the "
                                 "device='cpu' one")
        if min(counts[f"{stem}_encode"], counts[f"{stem}_decode"]) < 1:
            raise AssertionError(f"{name}: a kernel was not launched: "
                                 f"{counts}")
        print(f"{name} round trip ok: {data_new.size} bytes -> {len(vblob)} "
              f"bytes ({8 * len(vblob) / data_new.size:.4f} bits/byte); "
              f"device='cpu' container identical (cpu compress "
              f"{t_cpu:.2f} s)", flush=True)
        new_paths[name] = (vcfg, vnocrc, vblob, counts)
        launches.update({k: launches.get(k, 0) + v for k, v in counts.items()
                         if k.startswith(stem)})

    check_host_backends(
        rt, RansConfig, Variant,
        {"WORD": (cfg, data, blob),
         **{name: (vcfg, data_new, vblob)
            for name, (vcfg, _, vblob, _) in new_paths.items()}}, data)

    # the file path, the CLI and the process layer on each path's input,
    # then the lane-coder API on the card
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        file_launches = check_file_path(
            rt, stream_io, counters,
            {"WORD": (None, data, blob),
             **{name: (vcfg, data_new, vblob)
                for name, (vcfg, _, vblob, _) in new_paths.items()}}, tmp)
        check_cli(here, tmp, (tmp / "WORD.trns").read_bytes(), data)
        check_processes(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check_coder(coder, stats, oracle, RansConfig, Variant, data)
    launches = {k: launches.get(k, 0) + file_launches[k] for k in counters}

    # -- phase 4: timing -------------------------------------------------------
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
    gb_new = data_new.size / 1e9
    for vname, (vcfg, vnocrc, vblob, _) in new_paths.items():
        for name, fn in [
                ("compress", lambda: rt.compress(data_new, vcfg)),
                ("decompress", lambda: rt.decompress(vblob)),
                ("compress_from_device",
                 lambda: rt.compress_from_device(data_new_dev, vnocrc)),
                ("decompress_to_device",
                 lambda: rt.decompress_to_device(vblob))]:
            med, low = wall(fn)
            print(f"{vname} {name} wall median {med * 1e3:.3f} ms "
                  f"({gb_new / med:.4f} GB/s), min {low * 1e3:.3f} ms "
                  f"[7 warm calls, host clock around synchronize, "
                  f"{data_new.size} bytes]", flush=True)

    host = (f"host CPU {host_cpu()}, os.cpu_count() {os.cpu_count()}; card "
            f"{smi.splitlines()[0]}")
    for vname, vcfg, vdata, vblob in [
            ("WORD", cfg, data, blob),
            *((n, c, data_new, b) for n, (c, _, b, _) in new_paths.items())]:
        for name, fn in [
                ("compress", lambda: rt.compress(vdata, vcfg,
                                                 backend="native")),
                ("decompress", lambda: rt.decompress(vblob,
                                                     backend="native"))]:
            med, low = wall(fn, reps=5)
            print(f"{vname} native {name} wall median {med * 1e3:.3f} ms "
                  f"({vdata.size / 1e9 / med:.4f} GB/s), min "
                  f"{low * 1e3:.3f} ms [5 calls, host clock, {vdata.size} "
                  f"bytes; {host}]", flush=True)

    # the native core alone on one 2^23-symbol block, on one thread
    freqs, cum = stats.build_model(data, cfg.prob_bits)
    blk = data[:cfg.block_symbols]
    payload, words = native.encode(cfg, blk, freqs, cum)
    enc1, _ = wall(lambda: native.encode(cfg, blk, freqs, cum), reps=5)
    dec1, _ = wall(lambda: native.decode(cfg, payload, words, blk.size,
                                         freqs, cum), reps=5)
    print(f"WORD native core on one {blk.size}-symbol block, one thread: "
          f"encode median {enc1 * 1e3:.3f} ms ({blk.size / enc1 / 1e9:.4f} "
          f"GB/s), decode median {dec1 * 1e3:.3f} ms "
          f"({blk.size / dec1 / 1e9:.4f} GB/s) [5 calls; {host}]",
          flush=True)

    # kernels at the main path's full-block group: 8 blocks of 2^23
    N, pb, B = cfg.n_lanes, cfg.prob_bits, cfg.block_symbols
    nb = data.size // B
    freqs, cum = stats.build_model(data, pb)
    padded = rt_word.pad_block(data_dev, N, freqs)
    syms = padded[:nb * B].view(nb, B)
    f, st = (torch.from_numpy(a).cuda()
             for a in host_prep.enc_tables(freqs, cum))
    table = torch.from_numpy(host_prep.word_enc_table(freqs, cum, pb)).cuda()
    enc_ms = cuda_ms(lambda: rt_word.encode_blocks(syms, f, st, N, pb, table),
                     20)
    enc_plain_ms = cuda_ms(
        lambda: rt_word.encode_blocks_ref(syms, f, st, N, pb), 1)
    cells, _ = rt_word.encode_blocks(syms, f, st, N, pb, table)
    emitted = int((cells >= 0x10000).sum())
    del cells
    S = nb * B
    # bytes: symbols in, 4-byte cells and the states out, the table in;
    # ops: 7 per symbol, as time_new_kernels counts K4 and K6 (compare, two
    # selects, multiply high, multiply, two adds), and a mask and a shift
    # per emitted word
    enc_bound = bound_ms(S * (1 + 4) + nb * N * 4 + 256 * 16,
                         7 * S + 2 * emitted)

    c = cont.unpack(blob)
    blocks = [c.payloads[i][0] for i in range(nb)]
    stream = rt_word.prep_decode(blocks, N, "cuda")
    c2s, fd, cd = (torch.from_numpy(a).cuda()
                   for a in host_prep.dec_tables(c.freqs, cum, pb))
    dec_ms = cuda_ms(lambda: rt_word.decode_blocks(*stream, c2s, fd, cd, B,
                                                   pb), 20)
    dec_plain_ms = cuda_ms(lambda: rt_word.decode_blocks_ref(
        *stream, c2s, fd, cd, B, pb), 1)
    # one block against nb blocks: equal times mean the time is one block's
    # chain of dependent steps, not the card's throughput
    stream1 = rt_word.prep_decode(blocks[:1], N, "cuda")
    dec1_ms = cuda_ms(lambda: rt_word.decode_blocks(*stream1, c2s, fd, cd,
                                                    B, pb), 20)
    plan_report("WORD", rt_word, N, pb, nb, B,
                lambda s, p: rt_word.decode_blocks(*s, c2s, fd, cd, B, pb,
                                                   plan=p),
                stream, stream1, dec_ms, dec1_ms)
    n_words = sum(int(b.size) for b in blocks)
    renorms = n_words - nb * 2 * N
    # bytes: the words in, symbols out, tables in; ops: mask, shift,
    # multiply, add, subtract and compare per symbol, and a shift and an
    # or per refill
    dec_bound = bound_ms(S + 2 * n_words + (1 << pb) + 2 * 256 * 4,
                         6 * S + 2 * renorms)
    print(f"encode kernel {enc_ms:.4f} ms ({S / enc_ms / 1e6:.3f} GB/s, "
          f"{enc_ms * 1e6 / (B // N):.1f} ns a step), "
          f"plain {enc_plain_ms:.2f} ms, bound {enc_bound[0]:.4f} ms "
          f"({enc_bound[1]}); decode kernel {dec_ms:.4f} ms "
          f"({S / dec_ms / 1e6:.3f} GB/s), plain {dec_plain_ms:.2f} ms, "
          f"bound {dec_bound[0]:.4f} ms ({dec_bound[1]}) "
          f"[{nb} blocks x {B} symbols, {N} lanes, prob_bits {pb}]; "
          f"decode kernel on 1 block {dec1_ms:.4f} ms",
          flush=True)

    # K3/K4 on the BYTE and the ALIAS path, K5/K6 on the RANS64 path (the
    # kernels line gives BYTE and RANS64 prob_bits 14), and RANS64 at
    # prob_bits 31, where the decoder searches instead of a table lookup
    times = {name: time_new_kernels(ops, stats, host_prep, vcfg, data_new,
                                    data_new_dev)
             for name, (vcfg, *_) in new_paths.items()}
    time_new_kernels(ops, stats, host_prep,
                     dataclasses.replace(new_paths["RANS64"][0],
                                         prob_bits=31),
                     data_new, data_new_dev)

    profile(out_dir, {
        "compress": lambda: rt.compress(data),
        "decompress": lambda: rt.decompress(blob),
        "native_compress": lambda: rt.compress(data, backend="native"),
        "native_decompress": lambda: rt.decompress(blob, backend="native")})

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
    for name, path, src, line, key in [
            ("byte_encode", "BYTE", "byte_encode.cu", "byte_tpu.py:418",
             "enc"),
            ("byte_decode", "BYTE", "byte_decode.cu", "byte_tpu.py:215",
             "dec"),
            ("rans64_encode", "RANS64", "rans64_encode.cu",
             "rans64_tpu.py:369", "enc"),
            ("rans64_decode", "RANS64", "rans64_decode.cu",
             "rans64_tpu.py:141", "dec")]:
        ms, plain, (bound, by) = times[path][key]
        kernels.append(
            {"name": name, "route": "cuda",
             "source": f"ryg_rans_tpu_torch/csrc/{src}",
             "replaces": f"ryg_rans_tpu/ops/{line}",
             "launches": launches[name], "max_abs_err": worst[name],
             "ms": ms, "plain_ms": plain, "bound_ms": bound,
             "bound_by": by, "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
