"""Profiling & timing (reference §2.9/§5.1).

Reference: ``profile/CppTimers.hpp`` (tick/tock ms), CUDA event timers
(``cuda/profile/CudaTimers.cuh``), per-launch labeled profiling with
``source_location`` threaded through every policy call.

Re-design: device timing must account for async dispatch —
:class:`Timer` blocks on results; :func:`bench` is the measurement loop used
by ``bench.py`` (warmup + median, ``block_until_ready``);
:func:`trace` wraps ``jax.profiler`` for XLA-level traces (the
tensorboard-compatible replacement for the reference's per-kernel prints).
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable, Optional

import jax

__all__ = ["Timer", "bench", "trace"]


class Timer:
    """tick/tock timer (CppTimer analog); blocks on device work."""

    def __init__(self, label: str = ""):
        self.label = label
        self._t0 = None
        self.elapsed_ms = 0.0

    def tick(self):
        self._t0 = time.perf_counter()
        return self

    def tock(self, result=None, echo: bool = True) -> float:
        if result is not None:
            jax.block_until_ready(result)
        self.elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        if echo:
            print(f"[timer] {self.label}: {self.elapsed_ms:.3f} ms")
        return self.elapsed_ms

    def __enter__(self):
        return self.tick()

    def __exit__(self, *exc):
        self.tock()


def bench(fn: Callable, *args, warmup: int = 2, iters: int = 10,
          label: Optional[str] = None, echo: bool = False) -> float:
    """Median wall-clock ms of ``fn(*args)`` with device sync.

    The measurement harness for BASELINE configs (BASELINE.md).
    """
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    if echo:
        print(f"[bench] {label or getattr(fn, '__name__', '?')}: "
              f"{med:.3f} ms (min {min(times):.3f})")
    return med


@contextlib.contextmanager
def trace(logdir: str = "/tmp/zpc_tpu_trace"):
    """XLA profiler trace region (view with tensorboard / xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def memory_stats(device=None) -> dict:
    """Device memory snapshot (reference ``Resource`` allocation records,
    resource/Resource.h:306-315 — XLA owns allocation, so the records come
    from the runtime)."""
    import jax

    dev = device or jax.local_devices()[0]
    stats = dev.memory_stats() or {}
    return {
        "bytes_in_use": stats.get("bytes_in_use", -1),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use", -1),
        "bytes_limit": stats.get("bytes_limit", -1),
        "raw": stats,
    }
