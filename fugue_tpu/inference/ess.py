"""Elliptical slice sampling: tuning-free inference for Gaussian priors.

Murray, Adams & MacKay (AISTATS 2010). For targets of the form
p(f) ∝ N(f; μ, Σ) · L(f) — latent-Gaussian models, the GP-regression /
non-centered-hierarchical shape — the transition draws ν from the prior,
then slice-samples an angle θ on the ellipse through (f, ν):

    f' = μ + (f − μ)·cos θ + (ν − μ)·sin θ

shrinking the bracket toward θ = 0 until log L(f') clears the slice level.
Every accepted point is exactly prior-correlated, so the sampler has NO
step size, NO mass matrix, and NO trajectory length — nothing to adapt.
No reference counterpart (fugue samples such models with adapted MH/HMC,
src/inference/mh.rs / hmc.rs); this is a capability extension.

Array shape: the shrinkage loop is a bounded ``while_loop`` vmapped over
chains (masked lock-step — typically 1–4 likelihood evaluations, and the
ellipse contracts to f itself so the bound cannot bias the invariant
distribution: θ → 0 reproduces f exactly). Each likelihood evaluation is
one staged model replay scoring only the non-prior accumulators
(``log_likelihood + log_factors``) — the prior term is handled exactly by
the ellipse geometry.

Contract (audited at staging time, double-replay): every continuous latent
site's prior must be ``Normal`` or ``MultivariateNormal`` with parameters
that do NOT depend on other latent sites (use the non-centered form for
hierarchies — ``theta_raw ~ N(0,1)``, scale outside the prior). Discrete
sites are held fixed (compose with Gibbs sweeps as for HMC).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import settings
from ..core.distributions import MultivariateNormal, Normal
from ..core.rng import chain_keys
from ..errors import ErrorCode, StagingError
from ..runtime.handler import Handler, run
from ..runtime.staging import StagedModel, stage
from ..runtime.trace import Trace


class _PriorAudit(Handler):
    """Replay with pinned values while recording each site's prior
    distribution instance (the trace stores values, not dists)."""

    def __init__(self, values: Dict[str, Any]):
        self.values = values
        self.dists: Dict[str, Any] = {}

    def on_sample(self, addr, dist, sample_shape):
        self.dists[str(addr)] = dist
        return self.values[str(addr)]

    def on_observe(self, addr, dist, value):
        return value

    def on_factor(self, log_weight):
        pass

    def finish(self) -> Trace:
        return Trace()


def _gaussian_prior_means(staged: StagedModel) -> jnp.ndarray:
    """Audit every continuous latent prior: must be Normal/MVN with
    latent-independent parameters. Returns the flat prior-mean vector in
    the constrained flat layout. Raises typed StagingError otherwise."""
    base = staged._discovery_trace.latents()
    audit = _PriorAudit(staged.merge_discrete(base))
    run(audit, staged.model_fn, *staged.args, **staged.kwargs)

    # pass 1: every continuous prior must be Gaussian (checked BEFORE the
    # dependence probe — a shifted replay through a non-Gaussian model can
    # trip unrelated validation errors first)
    for s in staged.continuous_sites:
        d1 = audit.dists[s.address]
        if not isinstance(d1, (Normal, MultivariateNormal)):
            raise StagingError(
                ErrorCode.NOT_STAGEABLE,
                f"elliptical slice sampling requires Normal/MultivariateNormal "
                f"priors; site {s.address!r} has {type(d1).__name__} — "
                "use HMC/NUTS/ChEES for general priors",
                {"site": s.address},
            )

    # pass 2 (dependence probe): shift every continuous latent and re-audit
    # — a Gaussian prior whose params move with other latents (centered
    # hierarchy) violates the ESS contract. A downstream validator may
    # reject the shifted values (e.g. a probability computed from a
    # latent); retry with a tiny shift before giving up.
    audit2 = None
    for shift in (1.0, 1e-3):
        shifted = dict(staged.merge_discrete(base))
        for s in staged.continuous_sites:
            shifted[s.address] = jnp.asarray(shifted[s.address]) + shift
        try:
            audit2 = _PriorAudit(shifted)
            run(audit2, staged.model_fn, *staged.args, **staged.kwargs)
            break
        except Exception:
            audit2 = None
    if audit2 is None:
        raise StagingError(
            ErrorCode.NOT_STAGEABLE,
            "could not verify that Gaussian prior parameters are "
            "independent of other latents (shifted replays failed "
            "validation); elliptical slice sampling needs that audit",
            {},
        )

    means = []
    for s in staged.continuous_sites:
        d1 = audit.dists[s.address]
        d2 = audit2.dists[s.address]
        if isinstance(d1, Normal):
            p1 = (np.asarray(d1.loc), np.asarray(d1.scale))
            p2 = (np.asarray(d2.loc), np.asarray(d2.scale))
        else:
            p1 = (np.asarray(d1.loc), np.asarray(d1._scale_tril))
            p2 = (np.asarray(d2.loc), np.asarray(d2._scale_tril))
        loc = jnp.broadcast_to(
            jnp.asarray(d1.loc, settings.real_dtype()), s.shape
        )
        if not all(np.allclose(a, b) for a, b in zip(p1, p2)):
            raise StagingError(
                ErrorCode.NOT_STAGEABLE,
                f"prior parameters of site {s.address!r} depend on other "
                "latent sites (centered hierarchy); rewrite in non-centered "
                "form (theta_raw ~ N(0,1), scale applied outside the prior) "
                "for elliptical slice sampling",
                {"site": s.address},
            )
        means.append(jnp.ravel(loc))
    if not means:
        raise StagingError(
            ErrorCode.NOT_STAGEABLE,
            "model has no continuous latent sites; use MH",
            {},
        )
    return jnp.concatenate(means)


@dataclass(frozen=True)
class ESSConfig:
    max_shrink: int = 30  # bracket-shrink bound; θ→0 degrades to f (exact)


@dataclass
class ESSResult:
    samples: Dict[str, Any]  # addr -> (n_chains, n_samples, ...)
    log_lik: Any  # (n_chains, n_samples) — non-prior accumulators at samples
    mean_shrink_iters: float  # likelihood evals per transition (cost metric)
    final_flat: Any  # (n_chains, d) constrained flat positions


def make_ess_transition(staged: StagedModel, mu, config: ESSConfig,
                        discrete: Optional[Dict[str, Any]] = None):
    """One elliptical-slice transition for a single chain (vmap over
    chains). Operates on the CONSTRAINED flat layout (all sites are real
    support by the Gaussian-prior contract)."""
    two_pi = 2.0 * np.pi

    def loglik(flat):
        lat = staged.unflatten_constrained(flat)
        parts = staged.log_density_parts(staged.merge_discrete(lat, discrete))
        return parts.log_likelihood + parts.log_factors

    def transition(f, key):
        dt = f.dtype
        k_nu, k_u, k_theta, k_loop = jax.random.split(key, 4)
        nu_lat = staged.sample_prior(k_nu)
        nu = staged.flatten_constrained(nu_lat).astype(dt)
        log_y = loglik(f) + jnp.log(
            jax.random.uniform(k_u, (), dt, 1e-38, 1.0)
        )
        theta0 = jax.random.uniform(k_theta, (), dt, 0.0, two_pi)

        def point(theta):
            return mu + (f - mu) * jnp.cos(theta) + (nu - mu) * jnp.sin(theta)

        def cond(carry):
            _, _, _, _, done, it, _ = carry
            return (~done) & (it < config.max_shrink)

        def body(carry):
            theta, lo, hi, _, _, it, k = carry
            fp = point(theta)
            ok = loglik(fp) > log_y
            # shrink toward 0 on reject (Murray et al. fig. 2)
            lo_new = jnp.where(ok, lo, jnp.where(theta < 0, theta, lo))
            hi_new = jnp.where(ok, hi, jnp.where(theta < 0, hi, theta))
            k, k_t = jax.random.split(k)
            theta_new = jnp.where(
                ok, theta,
                jax.random.uniform(k_t, (), dt, lo_new, hi_new),
            )
            return (theta_new, lo_new, hi_new, fp, ok, it + 1, k)

        carry0 = (
            theta0, theta0 - two_pi, theta0,
            f, jnp.asarray(False), jnp.asarray(0, jnp.int32), k_loop,
        )
        theta_f, _, _, fp, ok, iters, _ = jax.lax.while_loop(
            cond, body, carry0
        )
        # exhausted bracket: keep the current state (θ=0 limit — exact)
        f_new = jnp.where(ok, fp, f)
        return f_new, loglik(f_new), iters

    return transition


def ess_chain(
    key,
    model_fn: Optional[Callable] = None,
    n_samples: int = 1000,
    n_warmup: int = 200,
    config: ESSConfig = ESSConfig(),
    *,
    n_chains: int = 64,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    discrete: Optional[Dict[str, Any]] = None,
) -> ESSResult:
    """Elliptical slice sampling over the Gaussian-prior latents.

    ``n_warmup`` is plain burn-in (nothing adapts). Vectorized over
    ``n_chains``; the audit (Gaussian priors, latent-independent params)
    runs once at staging time and raises typed errors on violation.
    """
    if staged is None:
        staged = stage(model_fn, *model_args)
    dt = settings.real_dtype()
    # audit once per staged model (typed errors for non-Gaussian or
    # latent-dependent priors), cache the flat prior-mean vector
    mu = staged.cached_kernel(
        ("ess_mu",), lambda: _gaussian_prior_means(staged).astype(dt)
    )
    transition = make_ess_transition(staged, mu, config, discrete)

    def drive(key):
        k_init, k_run = jax.random.split(jax.random.fold_in(key, 31))
        f0 = jax.vmap(
            lambda k: staged.flatten_constrained(staged.sample_prior(k))
        )(chain_keys(k_init, n_chains)).astype(dt)

        vstep = jax.vmap(transition, in_axes=(0, 0))

        def body(f, k):
            keys = jax.random.split(k, n_chains)
            f_new, ll, iters = vstep(f, keys)
            return f_new, (f_new, ll, iters)

        keys = jax.random.split(k_run, n_warmup + n_samples)
        f_f, (fs, lls, iters) = jax.lax.scan(body, f0, keys)
        return f_f, fs[n_warmup:], lls[n_warmup:], iters

    jit_drive = staged.cached_kernel(
        ("ess", config, n_chains, n_samples, n_warmup,
         _discrete_key(discrete)),
        lambda: jax.jit(drive),
    )
    f_f, fs, lls, iters = jit_drive(key)

    positions = jnp.moveaxis(fs, 0, 1)  # (chains, samples, d)
    unflat = staged.cached_kernel(
        ("ess_unflatten",),
        lambda: jax.jit(jax.vmap(jax.vmap(staged.unflatten_constrained))),
    )
    samples = unflat(positions)
    return ESSResult(
        samples=samples,
        log_lik=jnp.moveaxis(lls, 0, 1),
        mean_shrink_iters=float(np.asarray(jnp.mean(iters.astype(dt)))),
        final_flat=f_f,
    )


def _discrete_key(discrete):
    # Content-keyed (hmc.py's _discrete_cache_key): the discrete VALUES are
    # closed over in the jitted drive via make_ess_transition; an id()-based
    # key can be recycled after gc and reuse stale conditioning (ADVICE r3).
    from .hmc import _discrete_cache_key

    return _discrete_cache_key(discrete)
