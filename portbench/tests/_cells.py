"""Cells of BENCHMARK.json cut to sizes the plain PyTorch versions code in
a moment on the CPU: the same files, mixes and metrics, tiny inputs.  The
cells are BENCHMARK.json's, in its order, and each is cut by its
generator's own ``tiny``."""

import json

from portbench import harness

ROOT = harness.HERE.parent
CELLS = tuple(w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"])


def tiny(workload: str) -> harness.Cell:
    cell = harness.load_cell(ROOT, workload)
    gen = harness.load_module("gen", cell.config["data"]["generator"])
    cell.config = gen.tiny(cell.config)
    return cell
