"""Profiling and timing utilities.

The reference's introspection story is structural (the trace IS the record;
criterion benches with committed medians — SURVEY.md §5 "Tracing/profiling").
This build adds the runtime side: a JAX-profiler context for device
traces viewable in TensorBoard/Perfetto, and a steady-state timing helper
that separates compile time from execution time — the discipline every bench
in this repo follows (first call compiles, subsequent calls measure).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict

import jax
import numpy as np


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a device trace (XLA ops, fusion boundaries, HBM traffic) for
    the enclosed block; open the result with TensorBoard or Perfetto."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclass
class Timing:
    compile_s: float
    mean_s: float
    std_s: float
    reps: int

    def __repr__(self):
        return (
            f"Timing(compile={self.compile_s*1e3:.1f}ms, "
            f"run={self.mean_s*1e3:.3f}±{self.std_s*1e3:.3f}ms x{self.reps})"
        )


def time_jit(fn: Callable, *args, reps: int = 10, **kwargs) -> Timing:
    """Time a jit-able callable: first call (compile) separately from the
    steady-state mean over ``reps`` executions (block_until_ready'd)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    compile_s = time.perf_counter() - t0

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return Timing(
        compile_s=compile_s,
        mean_s=float(np.mean(times)),
        std_s=float(np.std(times)),
        reps=reps,
    )


def cost_summary(fn: Callable, *args) -> Dict[str, Any]:
    """XLA cost analysis of the compiled program (FLOPs, bytes accessed) —
    the compiler's own estimate of where the roofline sits."""
    lowered = jax.jit(fn).lower(*args)
    compiled = lowered.compile()
    try:
        analysis = compiled.cost_analysis()
        if isinstance(analysis, (list, tuple)):
            analysis = analysis[0]
        return dict(analysis or {})
    except Exception:
        return {}
