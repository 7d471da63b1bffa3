"""Tracing, timing, and metrics (SURVEY.md §5.1/§5.5).

The reference's only instrumentation is ad-hoc wall-clock prints around the
geometry precompute and the frame pool (utils/compute_optical_flow.py:44,
94-96, 160-182, 368-369). Here:

  * `span(name)` / `Timer` — structured wall-clock spans with a process-wide
    registry; `report()` returns {name: {count, total_s, mean_s}}.
  * `trace(log_dir)` — context manager around `jax.profiler` device traces
    (view in TensorBoard / XProf) for kernel-level device profiling.
  * `frames_per_second(n_frames, fn, *args)` — the framework's first-class
    throughput metric: compile-excluded best-of-k timing of a jitted callable
    with `block_until_ready`.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from dataclasses import dataclass, field

logger = logging.getLogger("manifold_flow_tpu")

_REGISTRY: dict[str, list[float]] = defaultdict(list)


@contextlib.contextmanager
def span(name: str, log: bool = False):
    """Time a code span; durations accumulate in the process registry."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _REGISTRY[name].append(dt)
        if log:
            logger.info("%s: %.3f s", name, dt)


def report() -> dict:
    return {
        name: {
            "count": len(vals),
            "total_s": sum(vals),
            "mean_s": sum(vals) / len(vals),
        }
        for name, vals in _REGISTRY.items()
    }


def reset() -> None:
    _REGISTRY.clear()


@dataclass
class Timer:
    """Reusable named timer: `with timer: ...`; totals in `.total_s`."""

    name: str = "timer"
    total_s: float = 0.0
    count: int = 0
    _t0: float = field(default=0.0, repr=False)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.total_s += dt
        self.count += 1
        return False

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)


@contextlib.contextmanager
def trace(log_dir: str, host_profiling: bool = False):
    """Capture a jax.profiler device trace (TensorBoard 'profile' plugin).

    Wrap the steady-state region only (exclude compiles) for readable traces.
    """
    import jax

    jax.profiler.start_trace(log_dir,
                             create_perfetto_link=False,
                             create_perfetto_trace=host_profiling)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def frames_per_second(n_frames: int, fn, *args, repeats: int = 3) -> float:
    """Best-of-`repeats` frames/s of `fn(*args)` after one warmup call.

    `fn` must return a jax array (or pytree with a `.block_until_ready`
    leaf-compatible structure via jax.block_until_ready).
    """
    import jax

    jax.block_until_ready(fn(*args))  # compile + warmup
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return n_frames / best
