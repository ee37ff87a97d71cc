"""Example: compression ratio vs prob_bits, approaching the entropy floor
(PyTorch port).

The reference's selling point for rans64 is scale_bits up to 31 --
"precision almost as good as 64-bit arithmetic coders" (rans64.h README
lines 10-11).  This sweep shows the coded size closing in on the order-0
entropy floor as prob_bits grows, for each variant over the prob_bits its
kernels take.

Run: `python examples/torch_precision_sweep.py [path] [--size BYTES]
[--device cuda|cpu] [--backend native|numpy]` (default: 1 MiB of seeded
text-like bytes on the card, 128 lanes; a host backend codes it on the
host instead).
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def corpus(n: int, seed: int = 0) -> bytes:
    """Text-like bytes: Zipf(1.1) over 82 printable symbols."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 83) ** 1.1
    idx = np.searchsorted(np.cumsum(p / p.sum()), rng.random(n))
    return (32 + np.minimum(idx, 81)).astype(np.uint8).tobytes()


def main(argv=None):
    import ryg_rans_tpu_torch as rt
    from ryg_rans_tpu_torch.config import RansConfig, Variant

    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="?", help="input file (default: a "
                    "seeded text-like corpus of --size bytes)")
    ap.add_argument("--size", type=int, default=1 << 20)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("native", "numpy"), default=None)
    args = ap.parse_args(argv)
    if args.path:
        with open(args.path, "rb") as f:
            data = f.read()
    else:
        data = corpus(args.size)
    arr = np.frombuffer(data, np.uint8)
    counts = np.bincount(arr, minlength=256)
    p = counts[counts > 0] / arr.size
    entropy = float(-(p * np.log2(p)).sum())
    floor = int(np.ceil(entropy * arr.size / 8))
    print(f"{args.path or 'corpus'}: {len(data)} bytes, order-0 entropy "
          f"{entropy:.3f} bits/byte -> floor {floor} bytes\n")

    # few lanes and no CRC: isolate the coding precision from the layout's
    # overhead (128 lanes: the fewest the kernels take)
    print(f"{'variant':8s} {'pb':>3s} {'bytes':>9s} {'bits/byte':>9s} "
          f"{'over floor':>10s}")
    for variant, pbs in ((Variant.RANS64, (10, 12, 14, 16, 20, 24, 31)),
                         (Variant.BYTE, (10, 12, 14, 16)),
                         (Variant.WORD, (10, 12, 15)),
                         (Variant.ALIAS, (10, 12, 14, 16))):
        for pb in pbs:
            cfg = RansConfig(variant=variant, prob_bits=pb, n_lanes=128,
                             block_symbols=1 << 20, checksum=False)
            blob = rt.compress(data, cfg, device=args.device,
                               backend=args.backend)
            assert rt.decompress(blob, device=args.device,
                                 backend=args.backend) == data
            bb = 8 * len(blob) / len(data)
            over = 100 * (len(blob) - floor) / floor
            print(f"{variant.name:8s} {pb:3d} {len(blob):9d} {bb:9.4f} "
                  f"{over:+9.2f}%")
        print()


if __name__ == "__main__":
    main()
