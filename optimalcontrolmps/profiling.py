"""Tracing, timing and propagation accounting.

The reference has no profiling framework — just clock()/gettimeofday timers
(main/TestRuntimes.cpp:16-23) and the Nprop propagation counter appended to
ProgressCache.txt (src/BH_nlp.cpp:311-317). This module provides the
JAX equivalents (SURVEY.md §5): jax.profiler traces viewable in
TensorBoard/XProf, wall-clock timers that block on device work, and a
propagation counter with the reference's exact accounting formula.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import jax

__all__ = ["trace", "DeviceTimer", "PropagationCounter", "annotate",
           "enable_compile_cache"]


# fixed, so that every process of a checkout (bench, drivers, tests)
# finds the programs its predecessors compiled: the path is part of the
# cache key, and a moving directory never hits
DEFAULT_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Enable JAX's persistent XLA compilation cache; returns its dir.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already keeps its cache
    there and nothing is changed. Otherwise the cache goes to
    `<checkout>/.jax_cache`. Compiles of any length are cached: the
    workloads are compile-bound scans, run by many short processes."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE)
    # -1 is the documented "no size restriction" value (0 is the
    # 'backend override' sentinel)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return DEFAULT_COMPILE_CACHE


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture an XLA profiler trace (open with TensorBoard's profile
    plugin / xprof). Wraps jax.profiler.trace."""
    with jax.profiler.trace(log_dir):
        yield


def annotate(name: str):
    """Named region that shows up on the device timeline
    (jax.profiler.TraceAnnotation)."""
    return jax.profiler.TraceAnnotation(name)


class DeviceTimer:
    """Wall-clock timer that blocks until device work completes, so timings
    include the actual device execution (the analogue of get_wall_time around
    blocking ITensor calls, TestRuntimes.cpp:16-23,55-71)."""

    def __init__(self):
        self.laps = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, *outputs):
        if outputs:
            jax.block_until_ready(outputs)
        dt = time.perf_counter() - self._t0
        self.laps.append(dt)
        return dt

    @property
    def total(self):
        return sum(self.laps)

    @property
    def mean(self):
        return self.total / len(self.laps) if self.laps else 0.0


@dataclass
class PropagationCounter:
    """Propagation-count bookkeeping matching ProgressCache.txt's Nprop
    column (src/BH_nlp.cpp:311-317): each cost/grad costs N_t rollout steps
    per sweep; an exact Hessian adds N_t(N_t-1)/2."""
    n_steps: int
    count: int = 0
    history: list = field(default_factory=list)

    def add_cost(self):
        self.count += self.n_steps
        return self

    def add_gradient(self):
        self.count += 2 * self.n_steps
        return self

    def add_hessian(self):
        self.count += self.n_steps * (self.n_steps - 1) // 2
        return self

    def add_iteration(self, ls_trials: int = 0, exact_hessian: bool = False):
        n = self.n_steps * (2 + ls_trials)
        if exact_hessian:
            n += self.n_steps * (self.n_steps - 1) // 2
        self.count += n
        self.history.append(self.count)
        return n
