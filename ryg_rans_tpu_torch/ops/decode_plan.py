"""Launch plan of the cluster decoders K1 (``csrc/word_decode.cu``, WORD), K3
(``csrc/byte_decode.cu``, BYTE and ALIAS) and K5 (``csrc/rans64_decode.cu``,
RANS64).

A container block of N lanes decodes on one thread-block cluster of C CTAs
(``csrc/cluster_stream.cuh``): CTA rank r owns lanes [r N / C, (r + 1) N /
C), each of its threads L consecutive lanes.  Each CTA stages the block's
stream in a shared-memory ring of 9 chunks of a quarter window, where a
window is what one step can consume at most: 2N bytes for BYTE and ALIAS
(two renorm bytes a lane), N u16 words = 2N bytes for WORD and N u32 words =
4N bytes for RANS64 (one word a lane).  The tables sit after the ring.  The plan depends on the shape alone; the wrappers pass it
to the C entry, which checks it again.
"""

from __future__ import annotations

import dataclasses

#: Shared memory one CTA may use on the H100 (227 KB); the plan leaves
#: STATIC_SHARED of it to what the kernels declare statically (warp totals
#: and the cluster's slots, 512 bytes).
MAX_SHARED = 232_448
STATIC_SHARED = 1024
#: Chunks in the ring; a chunk is a quarter window, so the ring holds 2.25
#: windows: the one read now, the next, and the chunk being refilled
#: (``kRingChunks`` in ``csrc/cluster_stream.cuh``).
RING_CHUNKS = 9
#: Cluster sizes: powers of two, 16 being the largest the H100 schedules
#: (above 8 only with the non-portable attribute).
CLUSTER_SIZES = (1, 2, 4, 8, 16)
#: The default plan gives each CTA this many lanes (C = N / 2048, at most
#: 8, the portable size) and at most this many threads.
LANES_PER_CTA = 2048
MAX_THREADS = 512
#: Fewest lanes a CTA takes: four warps of one lane a thread.
MIN_LANES_PER_CTA = 128
VARIANTS = ("WORD", "BYTE", "ALIAS", "RANS64")
#: Largest prob_bits each decoder takes.
MAX_PROB_BITS = {"WORD": 15, "BYTE": 16, "ALIAS": 16, "RANS64": 31}
LANE_COUNTS = tuple(1 << k for k in range(7, 15))  # 128 .. 16384


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    variant: str
    n_lanes: int
    prob_bits: int
    cluster: int            # C, CTAs per container block
    threads: int            # threads per CTA
    lanes_per_thread: int   # L
    window_bytes: int       # what one step consumes at most
    chunk_bytes: int        # window / 4
    ring_bytes: int         # RING_CHUNKS chunks
    table_bytes: int
    smem_bytes: int         # dynamic shared memory: ring + tables

    def lane_ranges(self) -> list[tuple[int, int]]:
        """[first, end) lanes of each CTA, by rank."""
        per = self.n_lanes // self.cluster
        return [(r * per, (r + 1) * per) for r in range(self.cluster)]

    def c_args(self) -> tuple[int, int, int, int]:
        """The plan's arguments of the C entry."""
        return self.cluster, self.threads, self.chunk_bytes, self.smem_bytes


def table_bytes(variant: str, prob_bits: int) -> int:
    """Shared-memory bytes of the decoder's tables (as the kernels lay them
    out)."""
    if variant == "ALIAS":
        return (256 + 3 * 512) * 4  # divider, then sym, freq, adjust
    if variant == "BYTE":
        return 2 * 256 * 4 + (1 << prob_bits)  # freq, cum, cum2sym
    if variant == "WORD":
        return 256 * 4 + (1 << prob_bits)  # freq << 16 | cum, cum2sym
    # freq, cum[257] padded to 260, and cum2sym up to prob_bits 16
    return (256 + 260) * 4 + ((1 << prob_bits) if prob_bits <= 16 else 0)


def cluster_sizes(n_lanes: int) -> list[int]:
    """The cluster sizes a plan may take at ``n_lanes``: at least
    MIN_LANES_PER_CTA lanes a CTA, and at most MAX_THREADS threads of 16
    lanes."""
    return [c for c in CLUSTER_SIZES
            if MIN_LANES_PER_CTA <= n_lanes // c <= 16 * MAX_THREADS]


def plan(variant: str, n_lanes: int, prob_bits: int,
         cluster: int | None = None) -> DecodePlan:
    """The launch plan of ``variant`` (one of :data:`VARIANTS`) at
    ``n_lanes`` and ``prob_bits``; ``cluster`` overrides C (one of
    :func:`cluster_sizes`), for measuring the other sizes."""
    if variant not in VARIANTS:
        raise ValueError(f"no cluster decoder for {variant}")
    max_pb = MAX_PROB_BITS[variant]
    if n_lanes not in LANE_COUNTS or not 9 <= prob_bits <= max_pb:
        raise ValueError(f"{variant} decode takes 128-16384 lanes (a power "
                         f"of two) and prob_bits 9-{max_pb}, not "
                         f"{n_lanes} lanes at prob_bits {prob_bits}")
    if cluster is None:
        cluster = min(8, max(1, n_lanes // LANES_PER_CTA))
    if cluster not in cluster_sizes(n_lanes):
        raise ValueError(f"cluster {cluster} not in "
                         f"{cluster_sizes(n_lanes)} at {n_lanes} lanes")
    per_cta = n_lanes // cluster
    threads = min(per_cta, MAX_THREADS)
    window = (4 if variant == "RANS64" else 2) * n_lanes
    chunk = window // 4
    ring = RING_CHUNKS * chunk
    tables = table_bytes(variant, prob_bits)
    p = DecodePlan(variant, n_lanes, prob_bits, cluster, threads,
                   per_cta // threads, window, chunk, ring, tables,
                   ring + tables)
    if p.smem_bytes > MAX_SHARED - STATIC_SHARED:
        raise ValueError(f"plan needs {p.smem_bytes} bytes of shared memory")
    return p


def for_shape(given: DecodePlan | None, variant: str, n_lanes: int,
              prob_bits: int) -> DecodePlan:
    """``given``, or the default plan when it is None; raise ValueError when
    ``given`` is for another variant or shape than the launch's."""
    if given is None:
        return plan(variant, n_lanes, prob_bits)
    if (given.variant, given.n_lanes, given.prob_bits) != (variant, n_lanes,
                                                           prob_bits):
        raise ValueError(f"plan {given} is not for {variant} at {n_lanes} "
                         f"lanes, prob_bits {prob_bits}")
    return given
