"""Stable log-space numerics as pure JAX ops.

Capability parity with the reference numerics module
(reference: src/core/numerical.rs — log_sum_exp:15, weighted_log_sum_exp:51,
normalize_log_probs:87, log1p_exp:101, safe_ln:123, log_gamma:140), rebuilt as
vectorized, jit-able array functions. Everything accepts batched inputs and an
``axis`` argument because on the device these run over whole chain/particle batches
at once rather than one Vec<f64> at a time.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln as log_gamma  # noqa: F401  (re-export)
from jax.scipy.special import betaln as log_beta  # noqa: F401


def log_sum_exp(x, axis=-1, keepdims=False):
    """log(sum(exp(x))) with the max-shift trick; -inf-safe.

    Reference: numerical.rs:15. Empty or all -inf inputs return -inf rather
    than nan.
    """
    x = jnp.asarray(x)
    m = jnp.max(x, axis=axis, keepdims=True)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    out = m_safe + jnp.log(jnp.sum(jnp.exp(x - m_safe), axis=axis, keepdims=True))
    out = jnp.where(jnp.isfinite(m), out, m)  # all -inf -> -inf; +inf -> +inf
    if not keepdims:
        out = jnp.squeeze(out, axis=axis)
    return out


def weighted_log_sum_exp(x, log_w, axis=-1, keepdims=False):
    """log(sum(w_i * exp(x_i))) given log-weights (reference: numerical.rs:51)."""
    return log_sum_exp(jnp.asarray(x) + jnp.asarray(log_w), axis=axis, keepdims=keepdims)


def normalize_log_probs(log_p, axis=-1):
    """Normalize log-probabilities to probabilities summing to 1.

    Reference: numerical.rs:87. All--inf input normalizes to zeros (the
    reference returns an empty/zero vector in the degenerate case).
    """
    log_p = jnp.asarray(log_p)
    lse = log_sum_exp(log_p, axis=axis, keepdims=True)
    p = jnp.exp(log_p - jnp.where(jnp.isfinite(lse), lse, 0.0))
    return jnp.where(jnp.isfinite(lse), p, jnp.zeros_like(p))


def log1p_exp(x):
    """log(1 + exp(x)), stable for large |x| (reference: numerical.rs:101)."""
    x = jnp.asarray(x)
    return jnp.where(x > 0, x + jnp.log1p(jnp.exp(-x)), jnp.log1p(jnp.exp(x)))


def safe_log(x, floor=0.0):
    """log(max(x, tiny)): returns -inf for x <= 0 instead of nan.

    Reference: safe_ln (numerical.rs:123).
    """
    x = jnp.asarray(x)
    return jnp.where(x > floor, jnp.log(jnp.where(x > floor, x, 1.0)), -jnp.inf)


def logit(p):
    p = jnp.asarray(p)
    return jnp.log(p) - jnp.log1p(-p)


def log_expm1(x):
    """log(exp(x) - 1), stable for small and large x (softplus inverse)."""
    x = jnp.asarray(x)
    return jnp.where(x > 20.0, x, jnp.log(jnp.expm1(jnp.where(x > 20.0, 1.0, x))))


def softplus(x):
    return jax.nn.softplus(x)


def inv_softplus(y):
    """Inverse of softplus; y must be positive."""
    return log_expm1(y)


def compensated_sum(x, block: int = 4096):
    """Blocked-Kahan full-array sum: near-f64 accuracy in f32, vectorized.

    The f32 accumulation policy for huge observation plates (SURVEY.md §7
    hard part 5). Naive ``jnp.sum`` over 10^6 f32 log-probs carries
    O(n·eps·|S|) worst-case error (~units of log-density at |S|≈10^6);
    Kahan-compensating the whole array would serialize the reduction. This
    does both levels right for the hardware: XLA reduces dense ``block``-
    sized chunks at full VPU throughput (each partial's running magnitude —
    and hence its rounding error — is ~n/block smaller than the total), then
    a short ``lax.scan`` Kahan pass over the n/block partials removes the
    accumulation error of the long dimension, leaving ~2·eps·|S| plus the
    negligible in-block term.

    Gradients flow through (all ops are linear; d/dx_i = 1 exactly), so it
    is safe inside HMC/NUTS potentials. For arrays of ≤ ``block`` elements
    it is exactly ``jnp.sum``.
    """
    x = jnp.ravel(x)
    n = x.size
    if n <= block:
        return jnp.sum(x)
    m = -(-n // block)
    pad = m * block - n
    if pad:
        x = jnp.pad(x, (0, pad))
    partials = jnp.sum(x.reshape(m, block), axis=1)

    def neumaier(carry, v):
        # Neumaier's variant of Kahan: also exact when |v| exceeds the
        # running sum (classic Kahan drops the swamped term there)
        s, c = carry
        t = s + v
        c = c + jnp.where(
            jnp.abs(s) >= jnp.abs(v), (s - t) + v, (v - t) + s
        )
        return (t, c), None

    zero = jnp.zeros((), partials.dtype)
    (s, c), _ = jax.lax.scan(neumaier, (zero, zero), partials)
    return s + c
