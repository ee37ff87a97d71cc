"""The benchmark grows by new files and new BENCHMARK.json entries alone.

A copy of BENCHMARK.json and ``portbench/`` gets a fifth cell (text kept
on the device, with a generator and a cut of its own), a kernel file whose
counter the program does not have, of both directions, with a byte rule
of its own, and readers that use the rule and the count; the new cell's
name goes at the end of the cells that ``call_p90_ms`` lists.
The copy then runs the new cell and an old one, traced, on the CPU, with
no file that it had changed.
"""

import hashlib
import json
import shutil
import subprocess
import sys
import time

from portbench import harness
from portbench.program import Program

from ._cells import ROOT, tiny

NEW = "text-zipf82-1e8-dev.decompress"
OLD = "text-zipf82-1e8.decompress"
SEED = 2**31 + 41
TINY_BYTES = 30000

CONFIG = {
    "name": "text-zipf82-1e8-dev",
    "source": "http://mattmahoney.net/dc/text.html",
    "reduced": [],
    "inputs_on": "device",
    "entry_points": {"encode": "compress_from_device",
                     "decode": "decompress_to_device"},
    "rans_config": {"rule": "auto", "checksum": False},
    "data": {"generator": "text_zipf_dev", "buffers": 4,
             "bytes": 100000000, "alphabet_first": 32, "alphabet_size": 82,
             "zipf_exponent": 1.1},
}

FILES = {
    "portbench/configs/text-zipf82-1e8-dev.json": json.dumps(CONFIG),
    "portbench/gen/text_zipf_dev.py": f'''
import copy

import torch


def make(config, seed, device):
    p = config["data"]
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 64))
    k = torch.arange(1, p["alphabet_size"] + 1, dtype=torch.float64)
    w = k ** -p["zipf_exponent"]
    cdf = torch.cumsum(w / w.sum(), 0).to(torch.float32).to(device)
    out = []
    for b in range(p["buffers"]):
        u = torch.rand(p["bytes"], generator=g, device=device)
        idx = torch.searchsorted(cdf, u, out_int32=True)
        idx.clamp_(max=p["alphabet_size"] - 1).add_(p["alphabet_first"])
        out.append((f"buffer{{b}}", idx.to(torch.uint8)))
    return out


def tiny(config):
    c = copy.deepcopy(config)
    c["data"].update(buffers=2, bytes={TINY_BYTES})
    return c
''',
    "portbench/kernels/crc_check.json": json.dumps({
        "source": "a device CRC-32 that the program does not have",
        "symbol": "crc32_check_kernel", "direction": "both",
        "variants": ["WORD"],
        "counter": "ryg_rans_tpu_torch.ops.crc:check_blocks"}),
    "portbench/rooflines/crc_check.py": '''
def nbytes(h):
    """The original bytes read once, and 4 B a block where the container
    holds CRCs."""
    return h.orig_len + (4 * len(h.counts) if h.crc else 0)
''',
    "portbench/metrics/check.bytes_per_call.py": '''
from portbench import readers


def read(ctx):
    k = ctx.kernels["crc_check"]
    rule = readers.byte_rule("crc_check", k)
    hs = [c.header for c in ctx.calls if c.ok and c.header is not None
          and c.header.variant in k["variants"]]
    return sum(map(rule, hs)) / len(hs) if hs else None
''',
    "portbench/metrics/check.launches_per_call.py": '''
def read(ctx):
    n = sum(c.direction == ctx.direction for c in ctx.calls)
    v = None if ctx.launches is None else ctx.launches["crc_check"]
    return None if v is None or not n else v / n
''',
}

METRICS = [
    {"name": "check.bytes_per_call", "unit": "B", "better": "lower",
     "source": "program_counter", "layer": "kernels",
     "moves": "call_p90_ms", "workloads": [NEW]},
    {"name": "check.launches_per_call", "unit": "count", "better": "lower",
     "source": "program_counter", "layer": "ops", "moves": "call_p90_ms",
     "workloads": [NEW]},
]

RUN = """
import json, sys, time
sys.path[:0] = [{copy!r}, {root!r}]
from portbench import harness
from portbench.program import Program
from portbench.tests._cells import CELLS, tiny
cell = harness.load_cell(harness.HERE.parent, {new!r})
out = {{"cells": list(CELLS), "chips": cell.chips,
       "inputs_on": cell.config["inputs_on"],
       "end_to_end": [m["name"] for m in cell.end_to_end],
       "per_layer": [m["name"] for m in cell.per_layer]}}
for w in ({new!r}, {old!r}):
    c = tiny(w)
    r = harness.run(c, {seed}, 0.3, True, Program(c.config, "cpu"), "cpu",
                    time.perf_counter())
    out[w] = {{"correct": r["correct"], "checks": r["checks"],
              "metrics": {{k: v["value"] for k, v in r["metrics"].items()}}}}
print(json.dumps(out))
"""

#: Per-layer metrics that count rather than time: equal in two runs.
COUNTS = ("ops.launches_per_call.", "device.syncs_per_call.")


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_kernel_rule_and_reader_are_added_as_files(tmp_path):
    copy = tmp_path / "bench"
    copy.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", copy)
    shutil.copytree(ROOT / "portbench", copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(copy)
    bench_before = json.loads((copy / "BENCHMARK.json").read_text())

    for rel, text in FILES.items():
        assert not (copy / rel).exists()
        (copy / rel).write_text(text)
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": CONFIG["name"], "source": CONFIG["source"],
        "file": "portbench/configs/text-zipf82-1e8-dev.json", "reduced": [],
        "why": "the text shard kept on the card"})
    bench["workloads"].append({
        "name": NEW, "config": CONFIG["name"], "traffic": "decompress",
        "chips": 1, "why": "decompress_to_device of containers made on "
                           "the card"})
    bench["per_layer"] += METRICS
    for m in bench["end_to_end"]:
        if m["name"] == "call_p90_ms":
            m["workloads"].append(NEW)
    (copy / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))

    p = subprocess.run(
        [sys.executable, "-c", RUN.format(copy=str(copy), root=str(ROOT),
                                          new=NEW, old=OLD, seed=SEED)],
        cwd=copy, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])

    # the copy's own tests see the fifth cell; load_cell resolves it
    assert out["cells"][-1] == NEW and len(out["cells"]) == \
        len(bench_before["workloads"]) + 1
    assert (out["chips"], out["inputs_on"]) == (1, "device")
    assert set(out["end_to_end"]) == {"call_p90_ms", "peak_mem_MiB",
                                      "setup_s"}
    assert out["per_layer"] == [m["name"] for m in METRICS]

    # the new cell comes out correct; the rule's bytes are read, and the
    # count of the kernel the program lacks is left out
    new = out[NEW]
    assert new["correct"], new["checks"]
    assert new["metrics"] == {"check.bytes_per_call": TINY_BYTES}

    # the old cell reports what it reports without the additions
    cell = tiny(OLD)
    plain = harness.run(cell, SEED, 0.3, True, Program(cell.config, "cpu"),
                        "cpu", time.perf_counter())
    old = out[OLD]
    assert old["correct"] and plain["correct"], old["checks"]
    assert set(old["metrics"]) == set(plain["metrics"])
    counts = {k for k in plain["metrics"] if k.startswith(COUNTS)}
    assert counts
    assert {k: old["metrics"][k] for k in counts} == \
        {k: plain["metrics"][k]["value"] for k in counts}

    # nothing that the copy had was edited: its files are as they were,
    # and BENCHMARK.json only gained entries, and the new cell's name in
    # an existing metric's list of cells
    after = _digests(copy)
    changed = {k for k in before if after.get(k) != before[k]}
    assert changed == {"BENCHMARK.json"}
    assert set(after) - set(before) == set(FILES)
    for key, value in bench_before.items():
        if isinstance(value, list):
            assert [_without(e, NEW) for e in bench[key][:len(value)]] \
                == value
        else:
            assert bench[key] == value


def _without(entry, name):
    """``entry`` less ``name`` at the end of its ``workloads``: a new cell
    is appended to the cells an existing metric lists."""
    w = entry.get("workloads") if isinstance(entry, dict) else None
    if not w or w[-1] != name:
        return entry
    return {**entry, "workloads": w[:-1]}
