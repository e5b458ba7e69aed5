"""Execution policies on XLA.

The reference's central abstraction is the execution policy
(``include/zensim/execution/ExecutionPolicy.hpp:99-127`` CRTP interface;
``seq_exec()/omp_exec()/cuda_exec()`` constructors) through which every kernel
is launched: ``policy(range, functor)`` plus pattern free-functions
(``for_each/reduce/scan/sort``).  Policies carry fluent settings:
``.sync(bool)``, ``.profile(bool)``, ``.device(i)``, ``.stream(i)``.

Re-design: a *kernel launch* is a traced, XLA-compiled pure function, so a
policy becomes an :class:`Executor` value object that decides

* **backend** — ``jit`` (compiled; the cuda/omp analog) or ``interp``
  (eager, op-by-op; the ``seq_exec`` serial-reference analog, used as the test
  oracle), mirroring reference layer 3's backend dispatch;
* **checkify** bounds checking — the analog of the reference's
  ``ZS_ENABLE_OFB_ACCESS_CHECK`` out-of-bounds instrumentation
  (``container/Vector.hpp:472-504``);
* **profiling** — labeled wall-clock timing with call-site attribution,
  mirroring the reference's ``source_location``-threaded policy profiling
  (``execution/ExecutionPolicy.hpp:143``, ``cuda/execution/ExecutionPolicy.cuh:412``);
* **device / mesh** — placement; multi-chip launches go through
  :mod:`zpc_tpu.parallel.mesh` shardings rather than explicit streams (streams
  and cross-stream events have no analog under XLA's single-program model —
  XLA's async scheduler owns overlap).

``.sync(bool)`` maps to ``block_until_ready`` on results (JAX dispatch is
async like CUDA streams); ``.stream(i)``/``.shmem(b)`` have no XLA analog
and are intentionally absent.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import time
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

__all__ = [
    "Executor",
    "seq_exec",
    "tpu_exec",
    "jit_exec",
]


def _call_site(depth: int = 2) -> str:
    """Best-effort caller file:line label (reference ``source_location`` idiom)."""
    try:
        fr = inspect.stack()[depth]
        return f"{fr.filename.rsplit('/', 1)[-1]}:{fr.lineno}"
    except Exception:  # pragma: no cover
        return "<unknown>"


@dataclasses.dataclass(frozen=True)
class Executor:
    """Value-semantic execution policy (fluent setters return new values)."""

    backend: str = "jit"  # "jit" | "interp"
    profile_flag: bool = False
    sync_flag: bool = False
    check_flag: bool = False
    device: Optional[Any] = None

    # -- fluent setters (reference ExecutionPolicyInterface) ------------------
    def profile(self, on: bool = True) -> "Executor":
        return dataclasses.replace(self, profile_flag=on)

    def sync(self, on: bool = True) -> "Executor":
        return dataclasses.replace(self, sync_flag=on)

    def check(self, on: bool = True) -> "Executor":
        """Enable index bounds checking (OFB-access-check analog)."""
        return dataclasses.replace(self, check_flag=on)

    def on(self, device) -> "Executor":
        return dataclasses.replace(self, device=device)

    @property
    def is_sequential(self) -> bool:
        return self.backend == "interp"

    # -- launching ------------------------------------------------------------
    def compile(self, fn: Callable, *, static_argnums=(), donate_argnums=()) -> Callable:
        """Return the launchable form of ``fn`` under this policy.

        jit backend: ``jax.jit``; interp backend: eager tracing (op-by-op),
        the serial-reference oracle.
        """
        if self.check_flag:
            from jax.experimental import checkify

            inner = fn
            errs = checkify.index_checks | checkify.nan_checks

            @functools.wraps(fn)
            def checked(*args, **kw):
                err, out = checkify.checkify(inner, errors=errs)(*args, **kw)
                err.throw()
                return out

            fn = checked
        if self.backend == "interp":
            @functools.wraps(fn)
            def eager(*args, **kw):
                with jax.disable_jit():
                    return fn(*args, **kw)

            return eager
        return jax.jit(fn, static_argnums=static_argnums,
                       donate_argnums=donate_argnums, device=self.device)

    def run(self, fn: Callable, *args, label: Optional[str] = None, **kwargs):
        """Launch ``fn(*args)`` under this policy, honoring profile/sync."""
        launch = self.compile(fn)
        if self.profile_flag:
            where = label or getattr(fn, "__name__", "<fn>")
            site = _call_site()
            t0 = time.perf_counter()
            out = launch(*args, **kwargs)
            out = jax.block_until_ready(out)
            dt = (time.perf_counter() - t0) * 1e3
            print(f"[zpc_tpu exec | {site}] {where}: {dt:.3f} ms")
            return out
        out = launch(*args, **kwargs)
        if self.sync_flag:
            out = jax.block_until_ready(out)
        return out

    def foreach(self, fn: Callable, n: int, *args):
        """``policy(range(n), f)`` analog: apply ``fn(i, *args)`` for all i.

        Functional: returns the stacked results of ``fn`` (pure); batched via
        ``vmap`` so XLA vectorizes onto the VPU instead of the reference's
        grid-stride thread loop (``cuda/Cuda.h:324-381``).
        """
        idx = jnp.arange(n)
        batched = jax.vmap(lambda i: fn(i, *args))
        return self.run(batched, idx, label=getattr(fn, "__name__", "foreach"))

    def map(self, fn: Callable, *arrays):
        """Elementwise map over leading axis (``transform`` pattern)."""
        return self.run(jax.vmap(fn), *arrays,
                        label=getattr(fn, "__name__", "map"))

    @contextlib.contextmanager
    def scope(self, label: str):
        """Profile a region (reference ``CppTimer`` tick/tock)."""
        if not self.profile_flag:
            yield
            return
        t0 = time.perf_counter()
        yield
        dt = (time.perf_counter() - t0) * 1e3
        print(f"[zpc_tpu scope | {_call_site()}] {label}: {dt:.3f} ms")


def seq_exec() -> Executor:
    """Serial reference policy (eager, bounds-checked) — the test oracle.

    Mirrors ``zs::seq_exec()`` (execution/ExecutionPolicy.hpp) whose serial
    implementations are the ground truth every backend is tested against.
    """
    return Executor(backend="interp", check_flag=True)


def jit_exec() -> Executor:
    """Compiled policy (``cuda_exec()``/``omp_exec()`` analog): jit on JAX's
    default backend (the GPU when present, else the CPU)."""
    return Executor(backend="jit")


# the original name of jit_exec, kept as an API alias
tpu_exec = jit_exec


def par_exec(*launches):
    """Launch several (policy, fn, args...) tuples; returns their results.

    API parity with the reference's nested multi-policy ``par_exec``
    (ExecutionPolicy.hpp:218-236, :628-654).  Under XLA the launches are
    dispatched asynchronously and the scheduler overlaps them — explicit
    streams are unnecessary.
    """
    outs = []
    for pol, fn, *args in launches:
        outs.append(pol.run(fn, *args))
    return tuple(outs)
