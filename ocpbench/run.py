"""Runs one cell of the benchmark once and prints its result line.

    python3 ocpbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the configuration's problem and solver, draws the traffic's
pool from the seed and warms up on the cell's own shapes. The window then
runs calls back to back, closed loop with one caller, until ``--seconds``
have passed and the call in flight has returned. ``--trace 1`` then
profiles ``trace_calls`` more calls. After the window the answers are
judged against the plain reference. The last line on standard output is
one JSON object; the numbers compared, each beside its limit, are the last
lines on standard error and the last key of that object.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names a run must not have loaded, compared whole
BANNED = frozenset({"jax", "jaxlib", "flax", "lpopc_tpu"})
CACHE = ".ocpbench_cache"      # build and kernel caches, inside the checkout


def process_age() -> float:
    """Seconds since this process started (Linux), else since this module
    was first imported."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), time.perf_counter() - T_IMPORT)
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)


def cache_env(root: str):
    """Caches of the libraries the program may use, at fixed paths in the
    checkout (the program's own kernels build into ``lpopc_tpu_torch/build``),
    and one host thread for the numerical libraries: the sweeps and the hp
    loop are issued from one Python thread, and idle worker threads only
    contend with it for the cores the card's host shares (one thread read
    about 10 % more solves/s on the H100's host)."""
    base = os.path.join(root, CACHE)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"


@dataclass
class Readings:
    """What a metric's reader reads (``metrics/<name>.py``)."""

    mode: str
    batch: int
    n: int
    elem_size: int
    setup_s: float
    window_s: float
    calls: int
    attempted: int
    solved: int
    counters: dict
    block_threshold: float
    answers: object = None                          # the mode's answers (hp: one per solve)
    profile: object = None                          # profiling.Profile of a traced run


def block_threshold(config: dict) -> float:
    so = config.get("solve_options", {})
    mode = so.get("block_kkt", "auto")
    return float(so.get("block_kkt_threshold", 700)) if mode == "auto" else (
        0.0 if mode == "on" else float("inf"))


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda", dtype=None,
             start_age: float = 0.0, inspect=None, min_calls: int = 1):
    """One run of ``cell``: returns (result without ``correct``/``checks``,
    per-instance numbers, values compared). ``device="cpu"`` runs the
    program's plain kernels (tests); ``dtype`` overrides the configuration's
    (the control); ``inspect(program)`` is called once the program is built;
    the window makes at least ``min_calls`` calls."""
    import torch

    from ocpbench import judge, profiling, program, spec, traffic
    from ocpbench.reference import ocp

    t_setup = time.perf_counter() - start_age
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    dtype = dtype or program.DTYPES[cell.config.get("dtype", "float64")]
    tr = cell.traffic
    mode = tr["mode"]
    pool = traffic.draw(tr, seed, cell.reference)
    prog = cell.mode.Program(cell.config, tr, device, dtype)
    if inspect is not None:
        inspect(prog)
    inputs = [prog.inputs(p) for p in pool]
    prog.run(inputs[0])                     # warm-up: the cell's own shapes

    # the window: calls back to back until `seconds` have passed
    prog.reset_counters()
    results, used, solved = [], [], 0
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - t_setup
    while True:
        k = len(used) % len(pool)
        res, ok = prog.run(inputs[k])
        results.append(res)
        used.append(k)
        solved += ok
        if time.perf_counter() - t0 >= seconds and len(used) >= min_calls:
            break
    sync()
    window_s = time.perf_counter() - t0
    counters = prog.counters()
    calls = len(used)
    attempted = calls * int(tr["batch"])

    prof = None
    if trace:
        prog.reset_counters()

        def traced_calls():
            for j in range(int(tr.get("trace_calls", 1))):
                prog.run(inputs[(calls + j) % len(pool)])

        prof = profiling.trace(traced_calls, sync, cuda)
        prof.counters = prog.counters()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    answers = prog.answers(results)
    prog.close()
    del results, inputs, prog
    if cuda:
        torch.cuda.empty_cache()

    n = ocp.transcription(cell.reference, tr["mesh"]).n
    r = Readings(mode=mode, batch=int(tr["batch"]), n=n,
                 elem_size=torch.empty((), dtype=dtype).element_size(), setup_s=setup_s,
                 window_s=window_s, calls=calls, attempted=attempted, solved=solved,
                 counters=counters, block_threshold=block_threshold(cell.config),
                 answers=answers, profile=prof)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(cell.root, m["name"])(r)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if prof is not None:
        dev.update(busy_s=prof.busy_s, window_s=prof.window_s)
    result = {"attempted": attempted, "failed": attempted - solved,
              "metrics": metrics, "device": dev}
    if prof is not None:
        result["breakdown"] = {"device_ops": prof.device_ops, "idle_gaps": prof.idle_gaps}
    per_instance = cell.mode.numbers(cell, answers, pool, used)
    return result, per_instance, judge.readings(per_instance)


def card_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    start_age = process_age()
    cache_env(ROOT)
    try:
        from ocpbench import judge, spec

        cell = spec.resolve(args.workload, ROOT)
        import torch

        torch.set_num_threads(1)
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"ocpbench: {args.workload} needs {cell.chips} CUDA device(s); "
                  f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        import lpopc_tpu_torch  # noqa: F401  (fails here where the program is absent)

        result, _, values = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                     start_age=start_age)
    except Exception:
        traceback.print_exc()
        return 1
    found = banned_modules()
    if found:
        print(f"ocpbench: the run loaded {found}, which it must not", file=sys.stderr)
        return 4
    correct, checks = judge.decide(cell, values)
    line = {"correct": correct, **result}
    card = card_line()
    if card:
        line["card"] = card
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
