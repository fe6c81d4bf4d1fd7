"""The readings that the limits of ``ocpbench/limits/<cell>.json`` are set
from, at the cell's own size, in one process:

- the program as the configuration states it, on each of ``--seeds``: a
  short window that solves the whole pool once (every distinct instance a
  run compares), judged as a run judges it;
- the control on each of ``--control-seeds``: the program's own float32
  path (``dtype=torch.float32``, the precision below the configuration's
  float64), judged the same way; each line also gives the numbers over
  every answer, whatever its status (``every_answer``).

    python3 ocpbench/control.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9

One JSON line per run, then a summary line: per number, the largest
reading of the program (the lower) and the smallest of the control (the
upper). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(cell, seed: int, dtype=None, device="cuda", calls=None):
    from ocpbench import run

    calls = int(cell.traffic["pool"]) if calls is None else calls
    from ocpbench import judge

    result, per_instance, values = run.run_cell(cell, seed, 0.0, False, device=device,
                                                dtype=dtype, min_calls=calls)
    return {"seed": seed, "dtype": str(dtype or cell.config.get("dtype", "float64")),
            "calls": calls, "attempted": result["attempted"], "failed": result["failed"],
            "numbers": values,
            "every_answer": judge.readings(per_instance, every_answer=True)}


def summary(program: list, control: list) -> dict:
    return {k: {"lower": max(r["numbers"][k] for r in program),
                "upper": min(r["numbers"][k] for r in control) if control else None}
            for k in program[0]["numbers"]}


def main(argv=None) -> int:
    import torch

    from ocpbench import run, spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control-calls", type=int, default=None,
                    help="calls of each control run (default: the pool)")
    args = ap.parse_args(argv)
    run.cache_env(ROOT)
    if not torch.cuda.is_available():
        print("ocpbench.control: needs a CUDA device", file=sys.stderr)
        return 3
    cell = spec.resolve(args.workload, ROOT)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    program, control = [], []
    for s in seeds:
        program.append(readings(cell, s))
        print(json.dumps({"run": "program", **program[-1]}), flush=True)
    for s in cseeds:
        control.append(readings(cell, s, dtype=torch.float32, calls=args.control_calls))
        print(json.dumps({"run": "control", **control[-1]}), flush=True)
    if program:
        print(json.dumps({"summary": args.workload, "seeds": seeds, "control_seeds": cseeds,
                          "numbers": summary(program, control)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
