"""MCMC estimation utilities: ESS, Geweke, diminishing adaptation.

Capability parity with the reference (reference: src/inference/mcmc_utils.rs —
``DiminishingAdaptation`` Roberts-Rosenthal per-site scales :30-175; canonical
normalized ESS with Geyer initial-positive-monotone truncation, single- and
Vehtari multi-chain pooled-variance normalization, lag cap 2048 — FG-01/35/37
:195-339; Geweke z with spectral SE :354-421).

Array-program re-design: every estimator is a batched, jit-able array program —
autocovariances for ALL lags/chains/parameters at once via FFT (O(n log n)
instead of the reference's O(n·lag) nested loops), adaptation state is a
pytree of per-site arrays updated functionally inside the sampling ``scan``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

MAX_LAG = 2048  # reference lag cap (mcmc_utils.rs FG-37)


# ---------------------------------------------------------------------------
# Autocovariance / ESS  (reference: mcmc_utils.rs:195-339)
# ---------------------------------------------------------------------------


def autocovariance(x, max_lag: Optional[int] = None):
    """Biased (1/n) autocovariance of ``x`` along the last axis, all lags at
    once via FFT. Shape (..., n) → (..., L+1)."""
    x = jnp.asarray(x)
    n = x.shape[-1]
    if max_lag is None:
        max_lag = min(n - 1, MAX_LAG)
    xc = x - jnp.mean(x, axis=-1, keepdims=True)
    # next power of two >= 2n for linear (non-circular) autocorrelation
    m = int(2 ** np.ceil(np.log2(max(2 * n, 2))))
    f = jnp.fft.rfft(xc, n=m, axis=-1)
    acov = jnp.fft.irfft(f * jnp.conj(f), n=m, axis=-1)[..., : max_lag + 1]
    return jnp.real(acov) / n


def _geyer_tau(rho):
    """Integrated autocorrelation time from normalized autocorrelations via
    Geyer's initial positive + monotone sequence (reference: FG-35/37).

    ``rho``: (..., L+1) with rho[..., 0] == 1. Returns (...,) tau >= 1.
    Fully vectorized: pair sums Γ_k = rho_{2k} + rho_{2k+1}; keep while
    positive; enforce monotone non-increase via a running cumulative min.
    """
    L = rho.shape[-1]
    n_pairs = L // 2
    pair = rho[..., 0 : 2 * n_pairs : 2] + rho[..., 1 : 2 * n_pairs : 2]
    positive = pair > 0
    # first non-positive pair index truncates the sum (initial positive seq)
    keep = jnp.cumprod(positive, axis=-1).astype(bool)
    # monotone: running minimum over kept prefix
    pair_mono = jax.lax.associative_scan(jnp.minimum, pair, axis=-1)
    contrib = jnp.where(keep, pair_mono, 0.0)
    # tau = -1 + 2 * sum Γ_k  (Γ_0 includes rho_0 = 1)
    tau = -1.0 + 2.0 * jnp.sum(contrib, axis=-1)
    return jnp.maximum(tau, 1e-12)


def ess(x, max_lag: Optional[int] = None):
    """Single-chain effective sample size along the last axis.

    Reference: canonical normalized ESS (mcmc_utils.rs:195-252, FG-01):
    ESS = n / tau with Geyer truncation. Batched over leading axes.
    """
    x = jnp.asarray(x, jnp.result_type(x, jnp.float32))
    n = x.shape[-1]
    acov = autocovariance(x, max_lag)
    var0 = acov[..., :1]
    rho = jnp.where(var0 > 0, acov / jnp.where(var0 > 0, var0, 1.0), 0.0)
    tau = _geyer_tau(rho)
    out = n / jnp.maximum(tau, 1e-12)
    out = jnp.where(var0[..., 0] > 0, out, 0.0)
    return jnp.minimum(out, float(n))


def ess_multichain(chains, max_lag: Optional[int] = None):
    """Vehtari multi-chain ESS: per-chain autocovariances normalized by the
    pooled W+B variance estimate (reference: mcmc_utils.rs:253-339, FG-36).

    ``chains``: (..., m, n) — m chains of length n. Returns (...,).
    """
    x = jnp.asarray(chains, jnp.result_type(chains, jnp.float32))
    m, n = x.shape[-2], x.shape[-1]
    chain_means = jnp.mean(x, axis=-1)
    chain_vars = jnp.var(x, axis=-1, ddof=1)
    w = jnp.mean(chain_vars, axis=-1)  # within
    b = n * jnp.var(chain_means, axis=-1, ddof=1) if m > 1 else jnp.zeros_like(w)
    var_plus = (n - 1) / n * w + b / n
    acov = autocovariance(x, max_lag)  # (..., m, L+1)
    mean_acov = jnp.mean(acov, axis=-2)  # average over chains
    # rho_t = 1 - (W - mean_acov_t) / var_plus   (Vehtari 2021 eq. 10)
    rho = 1.0 - (w[..., None] - mean_acov) / jnp.where(var_plus[..., None] > 0,
                                                       var_plus[..., None], 1.0)
    rho = rho.at[..., 0].set(1.0)
    tau = _geyer_tau(rho)
    total = m * n
    out = total / jnp.maximum(tau, 1e-12)
    out = jnp.where(var_plus > 0, out, 0.0)
    return jnp.minimum(out, float(total))


# ---------------------------------------------------------------------------
# R-hat (classic + split; reference: diagnostics.rs:218-259)
# ---------------------------------------------------------------------------


def r_hat(chains):
    """Classic Gelman-Rubin potential scale reduction.

    ``chains``: (..., m, n). Returns (...,).
    """
    x = jnp.asarray(chains, jnp.result_type(chains, jnp.float32))
    m, n = x.shape[-2], x.shape[-1]
    chain_means = jnp.mean(x, axis=-1)
    w = jnp.mean(jnp.var(x, axis=-1, ddof=1), axis=-1)
    b = n * jnp.var(chain_means, axis=-1, ddof=1)
    var_plus = (n - 1) / n * w + b / n
    return jnp.sqrt(var_plus / jnp.where(w > 0, w, 1.0))


def split_r_hat(chains):
    """Split-R-hat (Vehtari 2021): halve each chain, then Gelman-Rubin over
    2m half-chains (reference: diagnostics.rs:218-259, FG-36)."""
    x = jnp.asarray(chains)
    n = x.shape[-1]
    half = n // 2
    first = x[..., :half]
    second = x[..., n - half : n]
    split = jnp.concatenate([first, second], axis=-2)
    return r_hat(split)


def _rank_normalize(chains):
    """Map pooled draws to normal scores: r_i = rank over ALL chains'
    draws, z_i = Phi^-1((r_i - 3/8) / (S + 1/4)) (Blom offsets; Vehtari
    et al. 2021 eq. 14). Vectorized argsort-of-argsort ranking, jit-safe."""
    from jax.scipy.special import ndtri

    x = jnp.asarray(chains, jnp.result_type(chains, jnp.float32))
    shape = x.shape
    flat = x.reshape(shape[:-2] + (shape[-2] * shape[-1],))
    order = jnp.argsort(flat, axis=-1)
    ranks = jnp.argsort(order, axis=-1).astype(flat.dtype) + 1.0
    s = flat.shape[-1]
    z = ndtri((ranks - 0.375) / (s + 0.25))
    return z.reshape(shape)


def rank_normalized_split_r_hat(chains):
    """Rank-normalized split-R̂ (Vehtari, Gelman, Simpson, Carpenter &
    Bürkner 2021) — the modern convergence standard, robust where the
    classic statistic is blind:

    - **bulk-R̂**: split-R̂ of the rank-normal scores — heavy tails or
      infinite variance cannot fake convergence;
    - **tail-R̂**: split-R̂ of the rank-normal scores of the FOLDED draws
      |x − median| — catches chains agreeing in location but not scale.

    Beyond-parity addition (the reference implements the 2021 *split*
    statistic only, diagnostics.rs:218-259). Returns
    ``max(bulk, tail)`` — the paper's recommended reporting value;
    ``chains``: (..., m, n) → (...,).
    """
    x = jnp.asarray(chains, jnp.result_type(chains, jnp.float32))
    bulk = split_r_hat(_rank_normalize(x))
    med = jnp.median(
        x.reshape(x.shape[:-2] + (-1,)), axis=-1
    )[..., None, None]
    tail = split_r_hat(_rank_normalize(jnp.abs(x - med)))
    return jnp.maximum(bulk, tail)


# ---------------------------------------------------------------------------
# Geweke diagnostic (reference: mcmc_utils.rs:354-421, FG-39)
# ---------------------------------------------------------------------------


def _spectral_var(x):
    """Autocorrelation-consistent (spectral-density-at-zero) variance of the
    mean estimator, via the same Geyer-truncated autocovariance sum."""
    n = x.shape[-1]
    acov = autocovariance(x)
    var0 = acov[..., :1]
    rho = jnp.where(var0 > 0, acov / jnp.where(var0 > 0, var0, 1.0), 0.0)
    tau = _geyer_tau(rho)
    return var0[..., 0] * tau / n


def geweke(x, first: float = 0.1, last: float = 0.5):
    """Geweke convergence z-score comparing early vs late segment means with
    spectral standard errors (reference: mcmc_utils.rs:354-421).

    ``x``: (..., n). Returns z (...,). |z| < 2 indicates stationarity.
    """
    x = jnp.asarray(x, jnp.result_type(x, jnp.float32))
    n = x.shape[-1]
    na = max(int(n * first), 2)
    nb = max(int(n * last), 2)
    a = x[..., :na]
    b = x[..., n - nb :]
    mean_a, mean_b = jnp.mean(a, axis=-1), jnp.mean(b, axis=-1)
    var_a = _spectral_var(a)
    var_b = _spectral_var(b)
    denom = jnp.sqrt(var_a + var_b)
    return (mean_a - mean_b) / jnp.where(denom > 0, denom, 1.0)


# ---------------------------------------------------------------------------
# Diminishing adaptation (reference: mcmc_utils.rs:30-175, FG-38)
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclass
class AdaptationState:
    """Per-site proposal-scale adaptation state as arrays (one slot per
    site — or per (chain, site) when batched).

    Functional analog of the reference's ``DiminishingAdaptation`` map:
    log-scales nudged toward a target acceptance rate with a Robbins-Monro
    decayed step, guaranteeing diminishing adaptation (Roberts-Rosenthal).
    """

    log_scale: Any
    t: Any  # adaptation step count (per slot)

    @staticmethod
    def init(n_sites: int, initial_scale: float = 1.0, batch_shape=()):
        shape = tuple(batch_shape) + (n_sites,)
        return AdaptationState(
            log_scale=jnp.full(shape, jnp.log(initial_scale)),
            t=jnp.zeros(shape),
        )

    def scale(self):
        return jnp.exp(self.log_scale)


def adapt_update(
    state: AdaptationState,
    site_mask,
    accepted,
    target: float = 0.44,
    decay: float = 0.6,
    max_log_step: float = 1.0,
    frozen=False,
):
    """One diminishing-adaptation update.

    ``site_mask``: one-hot (or boolean) over sites selecting the slot(s) that
    moved this transition; ``accepted``: boolean/float acceptance outcome.
    Reference math: log-scale += step * (acc - target), step = min(max,
    t^-decay) (mcmc_utils.rs:88-150). ``frozen=True`` is the post-warmup
    no-op (FG-57).
    """
    mask = jnp.asarray(site_mask, state.log_scale.dtype)
    acc = jnp.asarray(accepted, state.log_scale.dtype)
    if jnp.ndim(acc) == jnp.ndim(mask) - 1:
        acc = acc[..., None]  # per-chain acceptance → broadcast over sites
    t_new = state.t + mask
    step = jnp.minimum(max_log_step, jnp.power(jnp.maximum(t_new, 1.0), -decay))
    delta = mask * step * (acc - target)
    new_log_scale = state.log_scale + jnp.where(frozen, 0.0, delta)
    new_t = jnp.where(frozen, state.t, t_new)
    return AdaptationState(log_scale=new_log_scale, t=new_t)
