"""Call tracing hooks.

Counterpart of the reference's RAII ``LP_DBG_START_FUN`` tracer
(``Lpopc/src/Common/LpDebug.hpp:36-43``: every method logs
"-> Calling to:" / "<- Returning from:" to ``lpopc-dbg-msg.txt`` when
``LPOPC_REPORT_DBG_MSG`` is defined). Here: a decorator + context manager
enabled by ``LPOPC_TPU_TRACE=1`` (or :func:`enable_trace`), writing to the
"lpopc_tpu_torch.trace" logger; :func:`scope` also labels the block in a
``torch.profiler`` trace, and :func:`device_profile` captures one (the JAX
package's ``jax.profiler`` helper) as a Chrome trace JSON file.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import time

import torch

from .device import resolve_device

_trace_logger = logging.getLogger("lpopc_tpu_torch.trace")
_ENABLED = bool(os.environ.get("LPOPC_TPU_TRACE"))
_DEPTH = 0

if _ENABLED:
    # env-var activation must actually emit: give the logger a level and a
    # stderr handler (DEBUG records would otherwise be dropped by the root
    # logger's WARNING default / lastResort handler)
    _trace_logger.setLevel(logging.DEBUG)
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(message)s"))
    _trace_logger.addHandler(_h)


def enable_trace(path: str | None = None, level=logging.DEBUG):
    """Turn on call tracing; optionally also log to ``path`` (the analog of
    the reference's ``lpopc-dbg-msg.txt`` file sink)."""
    global _ENABLED
    _ENABLED = True
    _trace_logger.setLevel(level)
    handler = (
        logging.FileHandler(path) if path else logging.StreamHandler()
    )
    handler.setFormatter(logging.Formatter("%(message)s"))
    _trace_logger.addHandler(handler)


def disable_trace():
    global _ENABLED
    _ENABLED = False


def traced(fn):
    """Decorator: logs entry/exit + wall time when tracing is enabled."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        global _DEPTH
        if not _ENABLED:
            return fn(*args, **kwargs)
        pad = "  " * _DEPTH
        _trace_logger.debug("%s-> Calling to: %s", pad, fn.__qualname__)
        _DEPTH += 1
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            _DEPTH -= 1
            _trace_logger.debug(
                "%s<- Returning from: %s (%.3fs)", pad, fn.__qualname__,
                time.perf_counter() - t0,
            )

    return wrapper


@contextlib.contextmanager
def scope(name: str):
    """Host-side timing scope + a ``torch.profiler`` label for the block."""
    global _DEPTH
    if _ENABLED:
        pad = "  " * _DEPTH
        _trace_logger.debug("%s-> %s", pad, name)
        _DEPTH += 1
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if _ENABLED:
            _DEPTH -= 1
            _trace_logger.debug("%s<- %s (%.3fs)", "  " * _DEPTH, name,
                                time.perf_counter() - t0)


@contextlib.contextmanager
def device_profile(logdir: str, *, device=None):
    """``torch.profiler`` trace capture around a block, written under
    ``logdir`` as a Chrome trace JSON file (open it in Perfetto or
    ``chrome://tracing``).

    Host (CPU) activity is always recorded, CUDA activity when ``device`` is
    a CUDA device (``None`` means ``"cuda"``, and raises without one). The
    :func:`scope` spans appear in the trace by name. Yields the
    ``torch.profiler.profile`` object (``key_averages()`` after the block);
    its ``trace_path`` attribute names the file once the block has ended.
    """
    from torch.profiler import ProfilerActivity, profile

    device = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)
    prof.trace_path = path
