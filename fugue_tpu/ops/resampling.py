"""Particle resampling kernels.

Capability parity with the reference resamplers (reference:
src/inference/smc.rs:255-349 — systematic, stratified, multinomial index
draws). Accelerator form: each scheme is a vectorized array program —
normalized-weight cumsum (associative scan) + ``searchsorted`` — O(N log N)
with no sequential host loop, vmap/shard-safe. Ancestor indices are returned
so callers gather any particle pytree with one ``jnp.take``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.numerics import log_sum_exp


def normalize_log_weights(log_weights):
    """log-weights → (normalized weights, log of the normalizer)."""
    lse = log_sum_exp(log_weights, axis=-1)
    return jnp.exp(log_weights - lse[..., None]), lse


def effective_sample_size(log_weights):
    """ESS = 1 / sum(normalized_w^2) in log space (reference: smc.rs:230-233)."""
    lse1 = log_sum_exp(log_weights, axis=-1)
    lse2 = log_sum_exp(2.0 * log_weights, axis=-1)
    return jnp.exp(2.0 * lse1 - lse2)


def _indices_from_uniforms(weights, us):
    """Invert the weight CDF at sorted uniforms ``us``."""
    cdf = jnp.cumsum(weights, axis=-1)
    cdf = cdf / cdf[..., -1:]  # guard tiny normalization drift
    return jnp.clip(
        jnp.searchsorted(cdf, us, side="left"), 0, weights.shape[-1] - 1
    )


def systematic_resample(key, log_weights, n: int = None):
    """Systematic resampling: one uniform, stratified comb (smc.rs:317)."""
    N = log_weights.shape[-1]
    n = n or N
    w, _ = normalize_log_weights(log_weights)
    u0 = jax.random.uniform(key, ())
    us = (jnp.arange(n) + u0) / n
    return _indices_from_uniforms(w, us)


def stratified_resample(key, log_weights, n: int = None):
    """Stratified resampling: independent uniform per stratum (smc.rs:331)."""
    N = log_weights.shape[-1]
    n = n or N
    w, _ = normalize_log_weights(log_weights)
    us = (jnp.arange(n) + jax.random.uniform(key, (n,))) / n
    return _indices_from_uniforms(w, us)


def multinomial_resample(key, log_weights, n: int = None):
    """Multinomial resampling via Gumbel-topless categorical (smc.rs:343)."""
    N = log_weights.shape[-1]
    n = n or N
    return jax.random.categorical(key, log_weights, shape=(n,))


RESAMPLERS = {
    "systematic": systematic_resample,
    "stratified": stratified_resample,
    "multinomial": multinomial_resample,
}
