"""One run of one cell: set-up, the measured window (or the traced passes),
the judgement against the reference, and the metrics.

A cell ``<config>.<mix>`` is resolved by name: ``BENCHMARK.json`` names the
configuration's file and the metrics that the cell reports,
``traffic/<mix>.json`` the mix, ``gen/<generator>.py`` the inputs,
``metrics/<metric>.py`` each metric's reader, ``kernels/<kernel>.json``
a kernel and ``rooflines/<kernel>.py`` the bytes it counts, where it is no
coder.
Nothing here names a configuration, a mix, a metric or a kernel.

The loop is closed, with one caller: a call starts when the last returned,
as in a pipeline that waits for each reply.  The inputs are made from the
seed and visited in a seeded order, every input once a pass, pass after
pass.  The window holds the calls and their clock readings alone; the
memory each call takes is read in a pass of its own after the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import random
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import trace as trace_mod
from .readers import quantile
from .reference import codec, container
from .reference.config import shape_of

HERE = Path(__file__).resolve().parent


def load_json(path: Path):
    return json.loads(Path(path).read_text())


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the harness, loaded by its file name
    (names hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.name} in {HERE}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}._{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_kernels() -> dict[str, dict]:
    """Every ``kernels/<name>.json`` by name.  A file states the kernel's
    ``symbol`` in the device trace, its ``direction`` (``encode`` or
    ``decode`` for a coder, ``both`` for any other kernel), the
    ``variants`` it serves and its wrapper's launch ``counter``."""
    return {p.stem: load_json(p)
            for p in sorted((HERE / "kernels").glob("*.json"))}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell named ``workload`` in ``root/BENCHMARK.json``, with the
    metrics it reports: the end-to-end metrics that list it or list no
    cells, and the per-layer metrics that list it (each lists its cells)."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json "
                       f"(cells: {', '.join(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    per_layer = [m for m in bench["per_layer"] if workload in m["workloads"]]
    return Cell(workload, w["chips"], config, traffic, e2e, per_layer)


@dataclasses.dataclass
class Call:
    direction: str
    index: int              # which input
    nbytes: int             # its uncompressed bytes
    latency_s: float
    ok: bool
    header: container.Header | None = None  # traced runs: for rooflines


@dataclasses.dataclass
class Context:
    """What the metric readers see."""
    direction: str
    calls: list[Call]
    window_s: float
    setup_s: float
    on_card: bool
    device_kind: str
    kernels: dict
    trace: trace_mod.Trace | None = None
    launches: dict | None = None
    peaks: list[int] | None = None  # the memory pass: bytes a call took


class Memory:
    """Device memory readings; on the CPU (the tests) none are taken.

    A call's reading is the peak of the bytes its tensors requested above
    those in use when it began: the caching allocator's rounding and the
    slack of a split block, which depend on the order of earlier calls
    (up to 1 MiB a block), are left out.  ``high`` is the process's peak
    of allocated bytes, slack included."""

    def __init__(self, device: torch.device):
        self.device = device
        self.card = device.type == "cuda"
        self.high = 0

    def _stats(self):
        return torch.cuda.memory_stats_as_nested_dict(self.device)

    def begin(self) -> int:
        if not self.card:
            return 0
        torch.cuda.reset_peak_memory_stats(self.device)
        return self._stats()["requested_bytes"]["all"]["current"]

    def peak(self) -> int:
        if not self.card:
            return 0
        s = self._stats()
        self.high = max(self.high, s["allocated_bytes"]["all"]["peak"])
        return s["requested_bytes"]["all"]["peak"]


class Reservoir:
    """A uniform sample of at most ``k`` of the offered items, drawn from
    ``rng`` as they come, so that a window of any length keeps ``k``."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.n, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.n + 1)
            if j < self.k:
                self.items[j] = item
        self.n += 1


def host_bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.frombuffer(x, np.uint8)


def _nbytes(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else len(x)


def _same(out, expected: np.ndarray) -> bool:
    got = host_bytes(out)
    return got.shape == expected.shape and bool(np.array_equal(got,
                                                               expected))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: Cell, seed: int, seconds: float, traced: bool, program,
        device: torch.device, t_start: float, log=sys.stderr) -> dict:
    """Set up, measure (or trace) and judge one run; returns the result
    line's object, with ``checks`` last."""
    device = torch.device(device)
    traffic, config = cell.traffic, cell.config
    direction = traffic["direction"]
    rng_order = random.Random(f"order:{seed}")
    rng_judge = random.Random(f"judge:{seed}")
    mem = Memory(device)

    # --- set-up: inputs from the seed, containers to decode, warm-up ---
    gen = load_module("gen", config["data"]["generator"])
    inputs = [x for _, x in gen.make(config, seed, device)]
    sizes = [_nbytes(x) for x in inputs]
    order = list(range(len(inputs)))
    rng_order.shuffle(order)
    errors: list[str] = []
    untimed_failed = 0

    def guarded(fn, x, what: str):
        """A call outside the window: one that raises is counted, not
        fatal."""
        nonlocal untimed_failed
        try:
            return fn(x)
        except Exception as e:  # counted; the judgement fails the run
            untimed_failed += 1
            if len(errors) < 3:
                errors.append(f"{what}: {e!r}")
            return None

    if direction == "decode":
        work = [guarded(program.encode, x, "set-up encode") for x in inputs]
        call = program.decode
    else:
        work = inputs
        call = program.encode
    seen: dict[int, int] = {}
    for i, size in enumerate(sizes):  # warm every size this mix uses
        if seen.get(size, 0) < traffic["warm_per_size"]:
            seen[size] = seen.get(size, 0) + 1
            guarded(call, work[i], "warm-up")
    _sync(device)
    mem.peak()
    setup_s = time.perf_counter() - t_start

    # --- the window: timed calls for `seconds`, or whole traced passes ---
    biggest = max(range(len(inputs)), key=lambda i: (sizes[i], -i))
    sample = Reservoir(traffic["judge_calls"], rng_judge)
    latest_big = None
    calls: list[Call] = []

    def one(i: int) -> None:
        nonlocal latest_big
        idx = order[i % len(order)]
        c0 = time.perf_counter()
        try:
            with span():
                out = call(work[idx])
            ok = True
        except Exception as e:  # a failed call counts, and the run goes on
            out, ok = None, False
            if len(errors) < 3:
                errors.append(f"call {i} on input {idx}: {e!r}")
        c1 = time.perf_counter()
        c = Call(direction, idx, sizes[idx], c1 - c0, ok)
        calls.append(c)
        if ok:
            if traced:
                c.header = container.read_header(
                    out if direction == "encode" else work[idx])
            sample.offer((idx, out))
            if idx == biggest:
                latest_big = (idx, out)

    trace = launches = peaks = None
    span = ((lambda: record_function(f"portbench.{direction}")) if traced
            else contextlib.nullcontext)
    if traced:
        n_calls = traffic["trace_passes"] * len(order)
        kernels = load_kernels()
        before = {k: program.launches(v["counter"])
                  for k, v in kernels.items()}
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            with record_function(trace_mod.WINDOW):
                t0 = time.perf_counter()
                for i in range(n_calls):
                    one(i)
                _sync(device)
                window_s = time.perf_counter() - t0
        # a kernel whose counter the program lacks keeps None
        launches = {k: None if before[k] is None
                    else program.launches(v["counter"]) - before[k]
                    for k, v in kernels.items()}
        trace = trace_mod.from_profiler(prof.events())
        del prof
    else:
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            one(i)
            i += 1
        window_s = time.perf_counter() - t0
        mem.peak()  # the window's peak, before the pass resets it
        # every input once more, outside the window, for the memory each
        # call takes: the allocator's statistics cost the small calls time
        peaks = []
        for idx in order:
            base = mem.begin()
            guarded(call, work[idx], "memory pass")
            _sync(device)
            peaks.append(mem.peak() - base)
    mem.peak()
    memory_peak = mem.high

    # --- judgement: after the window, program state freed first ---
    t_judge = time.perf_counter()
    judged = sample.items + ([latest_big] if latest_big else [])
    need = {idx for idx, _ in judged}
    setup_judged: list[int] = []
    if direction == "decode":
        k = min(traffic["judge_setup"], len(inputs))
        rng_setup = random.Random(f"setup:{seed}")
        setup_judged = sorted(set(rng_setup.sample(range(len(inputs)), k))
                              | {biggest})
        need |= set(setup_judged)
    host = {i: host_bytes(inputs[i]) for i in sorted(need)}
    del inputs
    if direction == "encode":
        del work
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref_idx = sorted({idx for idx, _ in judged} if direction == "encode"
                     else setup_judged)
    with ThreadPoolExecutor(max(1, min(4, len(ref_idx)))) as pool:
        ref = dict(zip(ref_idx, pool.map(
            lambda i: codec.compress(
                host[i], shape_of(config["rans_config"], host[i].size),
                threads=2),
            ref_idx)))
    calls_failed = sum(not c.ok for c in calls)
    checks = {"calls_failed": calls_failed + untimed_failed}
    if direction == "encode":
        wrong = sum(out != ref[idx] for idx, out in judged)
        checks["containers_wrong"] = wrong
    else:
        checks["containers_wrong"] = sum(work[i] != ref[i]
                                         for i in setup_judged)
        wrong = sum(not _same(out, host[idx]) for idx, out in judged)
        checks["outputs_wrong"] = wrong
    correct = bool(calls) and bool(judged) and all(
        v == 0 for v in checks.values())
    judge_s = time.perf_counter() - t_judge
    for e in errors:
        print(f"portbench: {e}", file=log)

    # --- metrics ---
    ctx = Context(direction, calls, window_s, setup_s,
                  device.type == "cuda",
                  torch.cuda.get_device_name(device)
                  if device.type == "cuda" else "cpu",
                  load_kernels(), trace, launches, peaks)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = load_module("metrics", m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": ctx.device_kind,
           "count": 1,
           "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": len(calls),
              "failed": calls_failed + wrong, "metrics": metrics,
              "device": dev,
              "judged": {"window_outputs": len(judged),
                         "setup_containers": len(setup_judged),
                         "seconds": judge_s}}
    if calls and not traced:
        lat = [c.latency_s * 1e3 for c in calls]
        result["latency_ms"] = {"min": min(lat), "p50": quantile(lat, 0.5),
                                "p90": quantile(lat, 0.9), "max": max(lat)}
    if traced:
        dev["busy_s"] = trace.busy_s() if ctx.on_card else 0.0
        dev["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": 0}
                        for k, v in checks.items()}
    return result


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's, a JAX
    library's or the JAX package's: whole names, so ``ryg_rans_tpu_torch``
    is not ``ryg_rans_tpu``."""
    bad = {"jax", "jaxlib", "flax", "ryg_rans_tpu"}
    return sorted({m.split(".")[0] for m in sys.modules} & bad)

