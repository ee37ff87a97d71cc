"""The control and the planted faults, which the judgement has to fail.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \\
        --seconds 5 --what control|altered|half|stale

runs the cell as ``run.py --trace 0`` does, with the program replaced, and
prints one line per seed with the numbers compared.  The benchmark's own
runs never run it; ``portbench/tests/test_portbench_judge.py`` runs each
at a small size on the CPU.

- ``control``: the reference in the program's place, coding at prob_bits - 1,
  the next coarser model: the step that would tempt a later change (tables
  half the size, a ratio a little worse).  Decoding stays the program's, on
  the control's containers.
- ``altered``: one byte of each answer changed where it is produced.
- ``half``: each call does half its work: it encodes the first half of its
  input, or leaves the second half of its output zero.
- ``stale``: each call returns the previous call's answer, its state left
  as it was.
"""

import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench.harness import host_bytes  # noqa: E402
from portbench.reference import codec, config as ref_config  # noqa: E402


class Control:
    def __init__(self, program, config: dict):
        self.program = program
        self.spec = config["rans_config"]
        self.launches = program.launches

    def encode(self, x) -> bytes:
        data = host_bytes(x)
        shape = ref_config.shape_of(self.spec, data.size)
        return codec.compress(data, dataclasses.replace(
            shape, prob_bits=shape.prob_bits - 1))

    def decode(self, blob):
        return self.program.decode(blob)


class Fault:
    def __init__(self, program, kind: str):
        if kind not in ("altered", "half", "stale"):
            raise ValueError(f"no fault {kind!r}")
        self.program, self.kind, self.last = program, kind, None
        self.launches = program.launches

    def encode(self, x) -> bytes:
        if self.kind == "half":
            n = len(x) if isinstance(x, bytes) else x.numel()
            return self.program.encode(x[:n // 2])
        return self._spoil(self.program.encode(x))

    def decode(self, blob):
        return self._spoil(self.program.decode(blob))

    def _spoil(self, out):
        if self.kind == "stale":
            out, self.last = (self.last if self.last is not None else out,
                              out)
        elif isinstance(out, torch.Tensor):
            out = out.clone()
            if self.kind == "altered":
                out[out.numel() // 2] ^= 1
            else:
                out[out.numel() // 2:] = 0
        elif self.kind == "altered":
            b = bytearray(out)
            b[len(b) // 2] ^= 1
            out = bytes(b)
        else:
            out = out[:len(out) // 2] + bytes(len(out) - len(out) // 2)
        return out


def replaced(program, config: dict, what: str):
    return Control(program, config) if what == "control" \
        else Fault(program, what)


def main(argv=None) -> int:
    import argparse

    from portbench import harness
    from portbench.program import Program

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--what", default="control",
                    choices=("control", "altered", "half", "stale"))
    args = ap.parse_args(argv)
    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        prog = replaced(Program(cell.config, device), cell.config, args.what)
        r = harness.run(cell, seed, args.seconds, False, prog, device,
                        time.perf_counter())
        print(json.dumps({"workload": args.workload, "what": args.what,
                          "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"],
                          "judged": r["judged"], "checks": r["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
