"""On the card: one short run of each cell through ``run.py``, correct,
with every end-to-end metric; and the control on the card's timed sizes.
Each test skips inside its body where there is no card."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness

from ._cells import CELLS, ROOT


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_card(workload):
    _card()
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "4294967311", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    e2e = {m["name"] for m in harness.load_cell(ROOT, workload).end_to_end}
    assert {"setup_s", "peak_mem_MiB"} <= e2e <= set(r["metrics"])
    assert all(v["value"] > 0 for v in r["metrics"].values())
