"""Mesh-level data parallelism: block-sharded encode and decode.

Counterpart of the reference package's ``parallel/mesh.py``.  There a mesh
is one process over many devices; here it is one process per device, over
a ``torch.distributed.device_mesh.DeviceMesh`` with one dimension named
``"data"``.  The caller initialises the process group (its address, world
size and rank) and each process sets its device before ``make_mesh``.

Scale-out is pure data parallelism over independent blocks: the frequency
table is tiny and the same everywhere, and each process codes the blocks
it owns (``multihost.block_range_of``: contiguous, the first ``n mod P``
processes one block more) with no communication while it codes.
Collectives appear only in the model build (one all-reduce of the
per-shard histograms).  Every function takes the same padded input on
every process, and returns what this process's blocks give.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import api
from ..config import RansConfig, Variant
from ..models import stats
from ..ops import byte, host_prep, rans64, word
from .multihost import block_range_of, comm_device

DATA_AXIS = "data"


def make_mesh(n_devices: int | None = None, device_type: str = "cuda",
              axis: str = DATA_AXIS) -> DeviceMesh:
    """One-dimensional mesh over the initialised process group, one process
    per device of ``device_type``.  Raises when no group is initialised or
    its world size is not ``n_devices``; ``"cuda"`` raises without a
    card."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "process group, one process per device")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"need {n_devices} processes, one per device; the "
                         f"group has {world}")
    if device_type == "cuda":
        api._device("cuda")
    elif device_type != "cpu":
        raise ValueError(f"unsupported device type {device_type!r}")
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This process's device of ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_range(mesh: DeviceMesh, n: int) -> tuple[int, int]:
    """The interval of ``n`` items (blocks or bytes) this process owns."""
    return block_range_of(n, mesh.get_local_rank(), mesh.size())


def build_model_sharded(mesh: DeviceMesh, data, prob_bits: int):
    """Histogram of this process's shard of ``data`` (flat uint8, the same
    on every process) with ``torch.bincount`` on its device, an all-reduce
    over the mesh, then the exact normalization on the host (sequential
    integer logic on 257 values, main.cpp:75-129) -> (freqs, cum)."""
    t = torch.as_tensor(data).reshape(-1)
    lo, hi = local_range(mesh, t.numel())
    counts = torch.bincount(t[lo:hi].to(mesh_device(mesh)), minlength=256)
    group = mesh.get_group(DATA_AXIS)
    counts = counts.to(comm_device(group))
    dist.all_reduce(counts, group=group)
    return stats.build_model_from_counts(counts.cpu().numpy(), prob_bits)


class _Kernels:
    """The encode and decode kernels of ``cfg.variant``, with the model's
    tables on ``device``."""

    def __init__(self, cfg: RansConfig, freqs, cum, device):
        self.codec = api._codec(cfg)
        self.cfg = cfg
        pb = cfg.prob_bits
        f, st = (torch.from_numpy(a).to(device)
                 for a in host_prep.enc_tables(freqs, cum))
        if cfg.variant == Variant.WORD:
            self.enc_args = (f, st)
            table = host_prep.word_enc_table(freqs, cum, pb)
            self.dec_args = tuple(torch.from_numpy(a).to(device) for a in
                                  host_prep.dec_tables(freqs, cum, pb))
        elif cfg.variant == Variant.RANS64:
            self.enc_args = (f, st)
            table = host_prep.rans64_enc_table(freqs, cum, pb)
            self.dec_args = rans64.dec_tables(cfg, freqs, cum, device)
        else:
            alias = cfg.variant == Variant.ALIAS
            remap = (torch.from_numpy(host_prep.alias_remap(freqs, cum, pb))
                     .to(device) if alias else None)
            self.enc_args = (f, st, remap)
            table = host_prep.byte_enc_table(freqs, cum, pb, alias)
            self.dec_args = (byte.dec_tables(cfg, freqs, cum, device),)
        self.table = torch.from_numpy(table).to(device)

    def encode(self, syms: torch.Tensor):
        return self.codec.encode_blocks(syms, *self.enc_args,
                                        self.cfg.n_lanes, self.cfg.prob_bits,
                                        table=self.table)

    def decode(self, heads: torch.Tensor, body: torch.Tensor,
               counts: torch.Tensor, n_symbols: int) -> torch.Tensor:
        """Decode a launch group straight from its compaction: the heads
        are the final states' bits, each block's body follows the last."""
        x0 = heads.view(torch.int64 if self.cfg.variant == Variant.RANS64
                        else torch.int32)
        stream = (x0, body, torch.cumsum(counts, 0) - counts,
                  counts.to(torch.int32))
        extra = ((self.cfg.variant == Variant.ALIAS,)
                 if self.codec is byte else ())
        return self.codec.decode_blocks(*stream, *self.dec_args, n_symbols,
                                        self.cfg.prob_bits, *extra)


def _local_groups(mesh: DeviceMesh, cfg: RansConfig, n_padded: int):
    """This process's first block and its launch groups (first block
    relative to it, block count, block size) over ``n_padded`` symbols."""
    if n_padded % (4 * cfg.n_lanes):
        raise ValueError("data must be padded to a multiple of 4*n_lanes")
    sizes = word.block_sizes(cfg.block_symbols, n_padded)
    lo, hi = local_range(mesh, len(sizes))
    return lo, list(word.groups(sizes[lo:hi],
                                api._codec(cfg).GROUP_SYMBOLS))


def encode_blocks_sharded(mesh: DeviceMesh, cfg: RansConfig, data, freqs,
                          cum) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Dense encode of this process's blocks of ``data`` (flat uint8 padded
    to a multiple of 4*n_lanes, the same on every process) on its device:
    one (cells, states) pair per launch group."""
    dev = mesh_device(mesh)
    kern = _Kernels(cfg, freqs, cum, dev)
    t = torch.as_tensor(data).reshape(-1)
    lo, groups = _local_groups(mesh, cfg, t.numel())
    pos = lo * cfg.block_symbols
    local = t[pos:pos + sum(nb * size for _, nb, size in groups)].to(dev)
    out, pos = [], 0
    for _, nb, size in groups:
        out.append(kern.encode(local[pos:pos + nb * size].view(nb, size)))
        pos += nb * size
    return out


def compact_sharded(cfg: RansConfig, encoded):
    """Per-process compaction of ``encode_blocks_sharded``'s groups, on
    their device: one (heads, body, counts) triple per launch group."""
    codec = api._codec(cfg)
    return [codec.compact_emissions(cells, states)
            for cells, states in encoded]


def decode_blocks_sharded(mesh: DeviceMesh, cfg: RansConfig, compacted,
                          n_symbols_padded: int, freqs,
                          cum) -> torch.Tensor:
    """Decode this process's blocks from their compaction (the groups
    ``compact_sharded`` returns for an input of ``n_symbols_padded``) ->
    their symbols, one flat uint8 tensor on its device."""
    dev = mesh_device(mesh)
    kern = _Kernels(cfg, freqs, cum, dev)
    _, groups = _local_groups(mesh, cfg, n_symbols_padded)
    if len(groups) != len(compacted):
        raise ValueError("compacted groups do not match this process's "
                         "blocks")
    parts = [kern.decode(heads, body, counts, size).view(-1)
             for (heads, body, counts), (_, _, size) in zip(compacted,
                                                             groups)]
    if not parts:
        return torch.empty(0, dtype=torch.uint8, device=dev)
    return torch.cat(parts)


def roundtrip_step(mesh: DeviceMesh, cfg: RansConfig, data_u8, freqs,
                   cum_freqs):
    """One full sharded encode -> compact -> decode step (the framework's
    analog of a training step for the multi-device dry run), for every
    variant (WORD / BYTE / ALIAS / RANS64), all of it on this process's
    device.

    ``data_u8`` is the same flat uint8 input on every process, padded to a
    multiple of 4*n_lanes.  Ragged block counts need no padding: a process
    owns ``local_range(mesh, n_blocks)``, possibly no block.  Returns (this
    process's decoded symbols, its compacted groups)."""
    t = torch.as_tensor(data_u8).reshape(-1)
    encoded = encode_blocks_sharded(mesh, cfg, t, freqs, cum_freqs)
    compacted = compact_sharded(cfg, encoded)
    del encoded
    out = decode_blocks_sharded(mesh, cfg, compacted, t.numel(), freqs,
                                cum_freqs)
    return out, compacted


def local_slice(mesh: DeviceMesh, cfg: RansConfig, data) -> np.ndarray:
    """This process's blocks of host array ``data`` (what
    ``roundtrip_step`` gives back on it)."""
    data = np.asarray(data).reshape(-1)
    B = cfg.block_symbols
    lo, hi = local_range(mesh, len(word.block_sizes(B, data.size)))
    return data[lo * B:min(hi * B, data.size)]
