"""Example: compressed data feeding a consumer on the card (PyTorch port).

The serving pattern the codec is built for: a corpus is stored compressed
(TRNS container); a consumer computes directly on the decompressed tensor
on the card -- the kernels decode there, and only the (much smaller)
compressed payload crosses from the host.

Run: `python examples/torch_device_pipeline.py [path] [--size BYTES]
[--device cuda|cpu]` (default: 8 MiB of seeded text-like bytes on the
card; ``--device cpu`` runs the kernels' plain PyTorch versions).
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def corpus(n: int, seed: int = 0) -> bytes:
    """Text-like bytes: Zipf(1.1) over 82 printable symbols."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 83) ** 1.1
    idx = np.searchsorted(np.cumsum(p / p.sum()), rng.random(n))
    return (32 + np.minimum(idx, 81)).astype(np.uint8).tobytes()


def main(argv=None):
    import torch

    import ryg_rans_tpu_torch as rt
    from ryg_rans_tpu_torch.config import RansConfig, Variant

    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="?", help="input file (default: a "
                    "seeded text-like corpus of --size bytes)")
    ap.add_argument("--size", type=int, default=8 << 20)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.path:
        with open(args.path, "rb") as f:
            raw = f.read()
    else:
        raw = corpus(args.size)
    dev = args.device

    # lane-count tradeoff: more lanes = faster decode, but each lane's
    # flushed state costs 4 bytes per block; 2048 lanes suits MB-scale
    # files, 8192 suits bulk data (see docs/FORMAT.md)
    cfg = RansConfig(variant=Variant.ALIAS, prob_bits=16, n_lanes=2048,
                     block_symbols=1 << 19)
    blob = rt.compress(raw, cfg, device=dev)
    print(f"stored: {len(raw)} -> {len(blob)} bytes "
          f"({8 * len(blob) / len(raw):.2f} bits/byte)")

    # the consumer: any computation over the decompressed bytes
    def consume(u8):
        x = u8.to(torch.float32)
        return x.mean(), x.std(), torch.bincount(u8, minlength=256).argmax()

    t0 = time.perf_counter()
    device_bytes = rt.decompress_to_device(blob, device=dev)
    mean, std, mode = consume(device_bytes)
    mean = float(mean)  # waits for the card
    dt = time.perf_counter() - t0

    assert device_bytes.cpu().numpy().tobytes() == raw
    print(f"decompressed on {device_bytes.device} and consumed in "
          f"{dt * 1e3:.1f} ms (cold): mean={mean:.2f} "
          f"std={float(std):.2f} mode=byte {int(mode)}")

    # random access: pull one block without decoding the rest
    if len(raw) > cfg.block_symbols:
        b1 = rt.decompress_block(blob, 1, device=dev)
        assert b1 == raw[cfg.block_symbols:2 * cfg.block_symbols]
        print(f"random-access block 1: {len(b1)} bytes ok")

    # the reverse direction: data born on the card is compressed there;
    # only the (smaller) payload crosses to the host
    cfg2 = RansConfig(variant=Variant.ALIAS, prob_bits=16, n_lanes=2048,
                      block_symbols=1 << 19, checksum=False)
    blob2 = rt.compress_from_device(device_bytes, cfg2)
    assert rt.decompress(blob2, device=dev) == raw
    print(f"device-side compress: {len(raw)} -> {len(blob2)} bytes, "
          "round-trip ok")


if __name__ == "__main__":
    main()
