"""Tracing / profiling hooks (SURVEY.md §5: the reference has none built
in; this engine provides JAX profiler traces + per-stage timers).

Usage:
    from libavif_tpu.utils.trace import stage, timings, reset_timings
    with stage("entropy.encode"):
        ...
    print(timings())

    with device_trace("/tmp/jax-trace"):   # opens in TensorBoard/XProf
        encode(...)
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

_lock = threading.Lock()
_acc: dict[str, list] = defaultdict(lambda: [0, 0.0])  # name -> [count, secs]
_enabled = True


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


@contextlib.contextmanager
def stage(name: str):
    """Accumulating wall-clock timer for a pipeline stage."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            ent = _acc[name]
            ent[0] += 1
            ent[1] += dt


def timings() -> dict[str, dict]:
    with _lock:
        return {
            k: {"count": v[0], "total_s": round(v[1], 6)} for k, v in _acc.items()
        }


def reset_timings() -> None:
    with _lock:
        _acc.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """JAX profiler trace (view with TensorBoard/XProf)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
