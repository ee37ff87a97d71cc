"""Benchmark of ryg_rans_tpu_torch: one run of one cell, one JSON line.

    python3 portbench/run.py --workload <config>.<mix> --seed N \\
        --seconds S --trace 0|1

Run from the root of a checkout that holds the package and
``BENCHMARK.json``, on a machine with a CUDA card.  With ``--trace 0`` the
run measures the cell's end-to-end metrics over a window of ``--seconds``;
with ``--trace 1`` it profiles a fixed number of whole passes over the
inputs and reports the per-layer metrics.  Either way it judges what the
program returned against ``reference/`` and prints, as its last lines on
standard error, each number compared beside its limit, then the result as
the last line on standard output.  It exits 1 without a result when it
finds no card, too few cards, or JAX (or the JAX package) loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness
    from portbench.program import Program

    cell = harness.load_cell(ROOT, args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); this machine has {cards}", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         Program(cell.config, device), device, T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded after the window: {', '.join(bad)}",
              file=sys.stderr)
        return 1
    result["device"]["power_limit"] = power_limit()
    checks = result.pop("checks")
    result["checks"] = checks  # last in the line
    for name, c in checks.items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
