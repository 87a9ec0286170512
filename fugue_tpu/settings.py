"""Global dtype / precision policy.

The reference is f64 end-to-end (Rust ``f64``). The device path defaults to
f32: it halves memory traffic, and the tensor-core paths take bf16 and TF32.
The H100 runs f64 natively (34 TFLOP/s against 67 TFLOP/s of f32 on the SXM
part, NVIDIA data sheet); an x64 device mode is not measured yet. Policy
(SURVEY.md §7 hard part 5):

- positions / samples: ``real_dtype`` (default float32)
- log-weight accumulators: ``accum_dtype`` (default float32; promote to
  float64 only when x64 is enabled, e.g. for CPU-based statistical parity
  tests)
- integers: int32 by default (int64 requires x64)

These are functions, not constants, so that flipping ``jax_enable_x64`` in a
test conftest is respected.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import config as _jax_config


def x64_enabled() -> bool:
    return bool(_jax_config.jax_enable_x64)


def real_dtype():
    return jnp.float64 if x64_enabled() else jnp.float32


def accum_dtype():
    """Dtype for log-weight accumulators (log_prior/log_likelihood/log_factors)."""
    return jnp.float64 if x64_enabled() else jnp.float32


def int_dtype():
    return jnp.int64 if x64_enabled() else jnp.int32


def counting_dtype():
    """Dtype for unbounded counts (reference u64/i64 sites)."""
    return jnp.int64 if x64_enabled() else jnp.int32


# Accumulation policy for large observation plates (SURVEY.md §7 hard part
# 5): per-site log-prob sums of >= COMPENSATED_SUM_THRESHOLD elements use
# blocked-Kahan compensated f32 summation (core.numerics.compensated_sum) —
# error ~2·eps·|S| instead of O(n·eps·|S|), at the cost of one short scan
# over n/4096 partials. Below the threshold a single XLA reduce is both
# exact enough and fastest, so small/medium models pay nothing. Under x64
# (CPU parity tests) accumulators are f64 and the compensation is merely
# redundant. Override with FUGUE_TPU_COMPENSATED_SUM=<n> (0 disables).
COMPENSATED_SUM_THRESHOLD = 1 << 16


def compensated_sum_threshold() -> int:
    import os

    v = os.environ.get("FUGUE_TPU_COMPENSATED_SUM")
    if v is None or v == "":
        return COMPENSATED_SUM_THRESHOLD
    n = int(v)
    return n if n > 0 else (1 << 62)
