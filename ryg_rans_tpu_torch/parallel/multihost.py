"""Multi-process orchestration: per-process block ownership + ordered gather.

Counterpart of the reference package's ``parallel/multihost.py``, on
``torch.distributed``.  Scale-out across processes is pure data
parallelism over container blocks:

* the 256-entry frequency table is built from per-shard histograms with one
  all-reduce (``parallel.mesh.build_model_sharded``) and is the same on
  every process;
* each process codes the blocks it owns, on its own device, with no
  communication while it codes;
* payloads cross between processes once, through a fixed-capacity padded
  all-gather (variable-length streams plus counts).

The process group is the caller's: ``torch.distributed.init_process_group``
with its own address, world size and rank.  Its tensors go where the
group's backend takes them: the CPU for gloo, the process's current card
for NCCL.  With no group initialised there is one process, which owns
every block, and the gather hands its payloads back unchanged.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import api
from ..config import RansConfig
from ..ops import word

#: Word dtypes of a payload, by item size.
_WORD_DTYPES = {1: np.uint8, 2: np.uint16, 4: np.uint32}


def process_count(group=None) -> int:
    """World size of ``group`` (the default group), or 1 when no group is
    initialised."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def process_index(group=None) -> int:
    """This process's rank in ``group``, or 0 when no group is
    initialised."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def block_range_of(n_blocks: int, pi: int, np_: int) -> tuple[int, int]:
    """Contiguous block interval owned by process ``pi`` of ``np_``.

    Ragged counts are allowed: the first ``n_blocks mod np_`` processes own
    one extra block, so ownership stays contiguous and block-major (the
    gather is order-preserving).  Deterministic from (n_blocks, np_), so
    every process can compute every other process's slice without
    communication."""
    base, rem = divmod(n_blocks, np_)
    lo = pi * base + min(pi, rem)
    return lo, lo + base + (1 if pi < rem else 0)


def local_block_range(n_blocks: int, group=None) -> tuple[int, int]:
    """Block interval owned by THIS process (see block_range_of)."""
    return block_range_of(n_blocks, process_index(group),
                          process_count(group))


def comm_device(group=None) -> torch.device:
    """Where ``group``'s collectives take their tensors: the current card
    for NCCL, the CPU otherwise (gloo)."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def allgather_payloads(local_payloads: list[np.ndarray], cap_words: int,
                       group=None) -> list[np.ndarray]:
    """Gather per-block word arrays from every process of ``group`` in
    block order (process order).

    Streams are variable-length, so they travel as (counts, padded buffer)
    through one all-gather each; the capacity is the static per-block worst
    case (the same bound the kernels use).  Returns the full ordered block
    list on every process.
    """
    if not dist.is_initialized():
        return list(local_payloads)
    dev = comm_device(group)
    n_local = len(local_payloads)
    size = local_payloads[0].dtype.itemsize if local_payloads else 0
    if any(p.size > cap_words for p in local_payloads):
        raise ValueError(f"a payload holds more than cap_words={cap_words}")
    # Ragged ownership: processes may hold different block counts, but the
    # gather needs one shape -- pad the row dimension to the global max and
    # mark pad rows with count -1.  A process with no blocks learns the
    # word size from the others.
    shape = torch.tensor([n_local, size], dtype=torch.int64, device=dev)
    dist.all_reduce(shape, op=dist.ReduceOp.MAX, group=group)
    n_rows, size = (int(v) for v in shape.cpu())
    dt = _WORD_DTYPES[size]
    counts = np.full(n_rows, -1, np.int64)
    counts[:n_local] = [p.size for p in local_payloads]
    buf = np.zeros((n_rows, cap_words), dt)
    for i, p in enumerate(local_payloads):
        buf[i, :p.size] = p
    all_counts = torch.cat(_all_gather(torch.from_numpy(counts).to(dev),
                                       group)).cpu().numpy()
    all_buf = torch.cat(_all_gather(
        torch.from_numpy(buf.view(np.uint8)).to(dev), group)).cpu().numpy()
    all_buf = all_buf.view(dt).reshape(-1, cap_words)
    return [all_buf[i, :int(c)].copy()
            for i, c in enumerate(all_counts) if c >= 0]


def _check_padded(cfg: RansConfig, n_symbols: int) -> None:
    if n_symbols % (4 * cfg.n_lanes):
        raise ValueError("data must be padded to a multiple of 4*n_lanes "
                         "(whole blocks, or whole blocks and a tail)")


def compress_multihost(data: np.ndarray, cfg: RansConfig, freqs, cum,
                       device="cuda", group=None) -> list[np.ndarray]:
    """Encode ``data`` (the same host array on every process, padded to a
    multiple of 4*n_lanes: whole blocks and at most a short last one) with
    this process coding its contiguous block slice through the kernels on
    ``device``; returns the full ordered per-block payload list on every
    process."""
    codec = api._codec(cfg)
    dev = api._device(device)
    data = np.ascontiguousarray(data, np.uint8).reshape(-1)
    _check_padded(cfg, data.size)
    B = cfg.block_symbols
    n_blocks = len(word.block_sizes(B, data.size))
    lo, hi = local_block_range(n_blocks, group)
    if hi > lo:
        local = torch.from_numpy(data[lo * B:min(hi * B, data.size)])
        blocks = codec.encode(cfg, local.to(dev), freqs, cum)
    else:  # ragged: more processes than blocks -> this one owns none
        blocks = []
    spec = cfg.spec
    cap = B * spec.max_renorm + cfg.n_lanes * spec.state_words
    return allgather_payloads(blocks, cap, group)


def decompress_multihost(payloads: list[np.ndarray], cfg: RansConfig,
                         n_symbols_padded: int, freqs, cum, device="cuda",
                         group=None) -> np.ndarray:
    """Decode with per-process block ownership on ``device``; returns the
    full symbol array (``n_symbols_padded``) on every process, gathered in
    block order."""
    codec = api._codec(cfg)
    dev = api._device(device)
    _check_padded(cfg, n_symbols_padded)
    B = cfg.block_symbols
    sizes = word.block_sizes(B, n_symbols_padded)
    if len(payloads) != len(sizes):
        raise ValueError("payloads do not match n_symbols_padded")
    n_blocks = len(sizes)
    lo, hi = local_block_range(n_blocks, group)
    if hi > lo:
        out = codec.decode(cfg, payloads[lo:hi], sizes[lo:hi], freqs, cum,
                           dev)
    else:  # ragged: this process owns no blocks
        out = torch.empty(0, dtype=torch.uint8, device=dev)
    if not dist.is_initialized():
        return out.cpu().numpy()
    # one gather capacity for all (ragged ownership => per-process sizes
    # differ); reassemble by each process's deterministic block span
    P = process_count(group)
    per_max = -(-n_blocks // P)
    buf = torch.zeros(B * per_max, dtype=torch.uint8,
                      device=comm_device(group))
    buf[:out.numel()] = out.to(buf.device)
    gathered = _all_gather(buf, group)
    parts = []
    for p in range(P):
        plo, phi = block_range_of(n_blocks, p, P)
        n_syms = max(0, min(phi * B, n_symbols_padded) - plo * B)
        parts.append(gathered[p][:n_syms].cpu().numpy())
    return np.concatenate(parts)
