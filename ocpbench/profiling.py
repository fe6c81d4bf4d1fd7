"""The traced sub-window: ``torch.profiler`` over whole calls, read in
memory (no file is written), and reduced to what the per-layer readers and
the result's ``breakdown`` need.

Device operations are the trace's GPU-side events (kernels, copies, sets).
The device is busy while one runs; an idle gap is a stretch of the traced
window with none, labelled by the innermost CPU operation of the calling
thread that was running at its midpoint ("python" where none was).
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Profile:
    window_s: float                        # host clock over the traced calls
    busy_s: float                          # union of device operations
    kernels: list = field(default_factory=list)     # (name, seconds) of each kernel
    device_ops: list = field(default_factory=list)  # top 10 (name, seconds)
    idle_gaps: list = field(default_factory=list)   # top 10 (label, seconds)
    counters: dict = field(default_factory=dict)    # what the caller counted meanwhile

    def kernel_seconds(self, match) -> float:
        return sum(s for name, s in self.kernels if match(name))


def short(name: str, width: int = 96) -> str:
    """A kernel's name without its argument list, at most ``width`` letters."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0].strip()
    return name if len(name) <= width else name[: width - 3] + "..."


def _activity(e) -> str:
    """"kernel", "gpu_memcpy", "gpu_memset", "annotation" or "cpu_op"
    (older PyTorch has no ``activity_type``: read the device and the name)."""
    try:
        if e.is_user_annotation():
            return "annotation"
    except (AttributeError, RuntimeError):
        pass
    try:
        act = str(e.activity_type())
    except (AttributeError, RuntimeError):
        act = ""
    if act:
        return "annotation" if "annotation" in act else act
    if "cuda" not in str(e.device_type()).lower():
        return "cpu_op"
    name = e.name()
    return ("gpu_memcpy" if name.startswith("Memcpy") else
            "gpu_memset" if name.startswith("Memset") else "kernel")


def trace(calls, synchronize, cuda: bool = True) -> Profile:
    """Run ``calls()`` under the profiler (CPU, and CUDA where ``cuda``) and
    reduce it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        synchronize()
        t0 = time.perf_counter()
        calls()
        synchronize()
        window_s = time.perf_counter() - t0
    return reduce(prof.profiler.kineto_results.events(), window_s)


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events, window_s: float) -> Profile:
    dev, cpu = [], []
    threads = defaultdict(int)
    for e in events:
        act = _activity(e)
        if act in DEVICE_ACTIVITIES:
            dev.append((e.start_ns(), e.end_ns(), act, e.name()))
        elif act == "cpu_op":
            cpu.append((e.start_ns(), e.end_ns(), e.start_thread_id(), e.name()))
            threads[e.start_thread_id()] += 1
    by_name = defaultdict(float)
    kernels = []
    for s, e, act, name in dev:
        sec = (e - s) * 1e-9
        by_name[short(name) if act == "kernel" else act] += sec
        if act == "kernel":
            kernels.append((name, sec))
    busy = _union([(s, e) for s, e, _, _ in dev])
    busy_s = sum(e - s for s, e in busy) * 1e-9
    # idle gaps between device operations, by what the calling thread ran
    main = max(threads, key=threads.get) if threads else None
    ops = sorted((s, e, n) for s, e, t, n in cpu if t == main)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if ops and busy:
        gaps = [(ops[0][0], busy[0][0])] + gaps + [(busy[-1][1], max(o[1] for o in ops))]
    idle = defaultdict(float)
    stack, k = [], 0
    for s, e in sorted(g for g in gaps if g[1] > g[0]):
        mid = (s + e) // 2
        while k < len(ops) and ops[k][0] <= mid:
            while stack and stack[-1][1] <= ops[k][0]:
                stack.pop()
            stack.append(ops[k])
            k += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        idle[stack[-1][2] if stack else "python"] += (e - s) * 1e-9
    top = lambda d: [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return Profile(window_s=window_s, busy_s=busy_s, kernels=kernels,
                   device_ops=top(by_name), idle_gaps=top(idle))
