"""One rank of the process-parallel tests of ryg_rans_tpu_torch.parallel.

``run`` is the target of ``torch.multiprocessing`` spawns: each rank joins
a gloo group through a ``file://`` store, builds a one-dimensional
``"data"`` mesh over its device type, and runs the dry run of the
reference's ``__graft_entry__.dryrun_multichip`` (the four variants at 1024
lanes and 8192-symbol blocks, RANS64 at prob_bits 20, then n + 1 ragged
blocks on n ranks) and a ragged ``compress_multihost`` /
``decompress_multihost`` round trip.  It checks its own blocks and writes
what it holds to ``out_dir/rank<r>.npz`` for the parent to hold against
the reference package.  Imports nothing of JAX.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from _torch_corpora import random_bytes, skewed

#: (variant name, prob_bits) of __graft_entry__.py:58-59
DRYRUN = (("WORD", 12), ("BYTE", 14), ("ALIAS", 16), ("RANS64", 20))
LANES, BLOCK = 1024, 8192


def spawn(fn, world: int, args: tuple, timeout: float) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes; a
    child's exception raises here, and so does a group that has not
    finished after ``timeout`` seconds (its processes are killed)."""
    ctx = mp.start_processes(fn, args=(world, *args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"process group not done after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)


def dryrun_inputs(world: int):
    """(name, prob_bits, data) of the dry run: one block a rank for each
    variant, then WORD on world + 1 blocks (ragged)."""
    out = [(v, pb, random_bytes(world * BLOCK, seed=i))
           for i, (v, pb) in enumerate(DRYRUN)]
    out.append(("WORD", 12, random_bytes((world + 1) * BLOCK, seed=9)))
    return out


def multihost_input(world: int) -> np.ndarray:
    """2 * world full blocks and a half block of skewed bytes, padded to a
    multiple of 4 * LANES as the caller of compress_multihost pads it."""
    return skewed(2 * world * BLOCK + 3000, seed=world)


def run(rank: int, world: int, store: str, out_dir: str,
        device_type: str) -> None:
    from ryg_rans_tpu_torch.config import RansConfig, Variant
    from ryg_rans_tpu_torch.models import stats
    from ryg_rans_tpu_torch.ops import codec
    from ryg_rans_tpu_torch.parallel import mesh as pmesh
    from ryg_rans_tpu_torch.parallel import multihost

    if device_type == "cuda":
        torch.cuda.set_device(0)  # every rank on the one card
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        try:
            pmesh.make_mesh(world + 1, device_type)
        except ValueError:
            pass
        else:
            raise AssertionError("make_mesh took a wrong device count")
        mesh = pmesh.make_mesh(world, device_type)
        dev = pmesh.mesh_device(mesh)
        saved = {}
        counters = _counters()
        for i, (name, pb, data) in enumerate(dryrun_inputs(world)):
            cfg = RansConfig(variant=Variant[name], prob_bits=pb,
                             n_lanes=LANES, block_symbols=BLOCK)
            freqs, cum = pmesh.build_model_sharded(
                mesh, torch.from_numpy(data).to(dev), pb)
            out, compacted = pmesh.roundtrip_step(mesh, cfg, data, freqs, cum)
            if not np.array_equal(out.cpu().numpy(),
                                  pmesh.local_slice(mesh, cfg, data)):
                raise AssertionError(f"rank {rank}: {name} round trip")
            saved[f"dry{i}_freqs"] = freqs
            for g, (heads, body, counts) in enumerate(compacted):
                saved[f"dry{i}_g{g}_heads"] = heads.cpu().numpy()
                saved[f"dry{i}_g{g}_body"] = body.cpu().numpy()
                saved[f"dry{i}_g{g}_counts"] = counts.cpu().numpy()
            saved[f"dry{i}_groups"] = np.array(len(compacted))

        data = multihost_input(world)
        cfg = RansConfig(prob_bits=12, n_lanes=LANES, block_symbols=BLOCK)
        padded = codec.pad_block(torch.from_numpy(data), LANES,
                                 stats.build_model(data, 12)[0]).numpy()
        freqs, cum = pmesh.build_model_sharded(mesh, padded[:data.size], 12)
        payloads = multihost.compress_multihost(padded, cfg, freqs, cum,
                                                device=dev)
        out = multihost.decompress_multihost(payloads, cfg, padded.size,
                                             freqs, cum, device=dev)
        if not np.array_equal(out, padded):
            raise AssertionError(f"rank {rank}: multihost round trip")
        saved["mh_freqs"] = freqs
        saved["mh_n"] = np.array(len(payloads))
        for b, p in enumerate(payloads):
            saved[f"mh_p{b}"] = p
        saved["launches"] = np.array([c.launches for c in counters])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **saved)
    finally:
        dist.destroy_process_group()


def _counters():
    from ryg_rans_tpu_torch.ops import byte, rans64, word

    return [m.encode_blocks for m in (word, byte, rans64)] + \
        [m.decode_blocks for m in (word, byte, rans64)]
