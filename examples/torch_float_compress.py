"""Example: compressing float tensors on the card (byte-plane split, PyTorch
port).

Raw float bits are near-incompressible as a byte stream (mantissa bytes
are ~uniform), but the bytes at each position within an element are NOT:
exponent/sign bytes of trained-weight-like distributions carry only a few
bits of entropy.  Splitting a tensor into per-position byte planes and
entropy-coding each plane separately -- the standard trick in production
float compressors -- makes rANS effective on checkpoint-shaped data, and
the whole pipeline (bit view, plane split, histogram, encode) runs on the
card via compress_from_device; only coded payloads reach the host.

Run: `python examples/torch_float_compress.py [--elements N]
[--device cuda|cpu]` (default: 3 x 2^20 weights per dtype on the card;
``--device cpu`` runs the kernels' plain PyTorch versions).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    import torch

    import ryg_rans_tpu_torch as rt
    from ryg_rans_tpu_torch.config import RansConfig, Variant

    ap = argparse.ArgumentParser()
    ap.add_argument("--elements", type=int, default=1 << 20,
                    help="weights per layer scale (three scales)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    dev = torch.device(args.device)

    # weight-shaped data: layer-scaled normals, like a trained checkpoint
    gen = torch.Generator().manual_seed(7)
    w32 = torch.cat([torch.randn(args.elements, generator=gen) * s
                     for s in (0.02, 0.08, 0.5)]).to(dev)
    w16 = w32.to(torch.bfloat16)

    cfg = RansConfig(variant=Variant.WORD, prob_bits=12, n_lanes=1024,
                     block_symbols=1 << 19, checksum=False)

    def plane_compress(arr, width):
        """bit-view as bytes on the card, split into per-position planes,
        compress each plane there; returns (blobs, total_bytes)."""
        u8 = arr.view(torch.uint8).view(-1, width)
        blobs = [rt.compress_from_device(u8[:, i].contiguous(), cfg)
                 for i in range(width)]
        return blobs, sum(len(b) for b in blobs)

    def plane_decompress(blobs, dtype):
        planes = [rt.decompress_to_device(b, device=dev) for b in blobs]
        return torch.stack(planes, dim=-1).view(dtype).view(-1)

    for name, arr, width in (("float32", w32, 4), ("bfloat16", w16, 2)):
        nbytes = arr.numel() * width
        t0 = time.perf_counter()
        blobs, out = plane_compress(arr, width)
        dt = time.perf_counter() - t0
        back = plane_decompress(blobs, arr.dtype)
        assert torch.equal(back.view(torch.uint8), arr.view(torch.uint8)), \
            "round-trip!"
        # whole-stream baseline: same codec, no plane split
        whole = rt.compress_from_device(arr.view(torch.uint8), cfg)
        print(f"{name}: {nbytes} B -> planes {out} B "
              f"({8 * out / nbytes:.3f} bits/byte, "
              f"{nbytes / out:.2f}x) vs whole-stream {len(whole)} B "
              f"({nbytes / len(whole):.2f}x); lossless, "
              f"{dt * 1e3:.0f} ms cold")


if __name__ == "__main__":
    main()
