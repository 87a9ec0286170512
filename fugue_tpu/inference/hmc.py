"""Hamiltonian Monte Carlo over staged models.

Capability parity with the reference HMC engine (reference:
src/inference/hmc.rs — leapfrog with force reuse :353-407, dual-averaging
step size (Hoffman-Gelman Alg 5) :141-184, reasonable-epsilon search (Alg 4)
:479-535, diagonal mass adaptation via Welford at warmup midpoint + epsilon
re-tune :187-233,885-908, divergence = non-finite force/log-joint → always
reject :445-458, discrete sites held fixed (Metropolis-within-Gibbs) :69-71,
incremental ``HmcSession`` :643-920, ``hmc_chain`` wrapper :566).

Array-program re-design (SURVEY.md §3.3):
- forces come from ONE ``jax.grad`` of the staged log-density — replacing the
  reference's (L+1)·2d finite-difference model runs per proposal
  (hmc.rs:301-329) with (L+1) gradient evaluations *independent of d*;
- the leapfrog trajectory is a ``lax.scan`` vmapped over chains: every chain
  advances in lock-step inside one compiled kernel, positions laid out as a
  (chains, d) matrix so the VPU sees full lanes;
- dual-averaging and mass adaptation are CROSS-CHAIN: the acceptance
  statistic and Welford moments are reduced over the chain axis
  (``jnp.mean`` on one chip, ``lax.pmean`` when the chain axis is sharded
  across a mesh) — hundreds of chains adapt a shared kernel in a fraction of
  the reference's single-chain warmup;
- the sampler runs on the *unconstrained* flat position space provided by
  staging (log/logit/affine transforms with exact Jacobians — the
  reparameterization the reference leaves to the user, hmc.rs:62-66).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import settings
from ..core.rng import chain_keys
from ..runtime.staging import StagedModel, stage


# ---------------------------------------------------------------------------
# Config (reference: HMCConfig, hmc.rs:105-135)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HMCConfig:
    step_size: Optional[float] = None  # None → reasonable-epsilon search
    n_leapfrog: int = 32
    target_accept: float = 0.8
    adapt_step_size: bool = True
    adapt_mass: bool = True
    max_delta_energy: float = 1000.0  # divergence threshold
    # per-transition step-size jitter eps·U(1-jitter, 1): breaks the periodic
    # resonance of fixed-length trajectories on near-Gaussian targets (the
    # fixed-L pathology NUTS avoids; see nuts.py for the full fix)
    jitter: float = 0.2
    # "uniform": z0 ~ U(-2, 2)^d in unconstrained space (Stan's default —
    # robust to heavy-tailed priors whose extreme draws strand chains in
    # divergent regions); "prior": unconstrained prior draw
    init: str = "uniform"
    # "diag": diagonal mass from cross-chain variances; "dense": full
    # covariance mass (Cholesky-based kinetic energy) — for strongly
    # correlated posteriors where diagonal preconditioning is not enough
    mass: str = "diag"
    # lax.scan unroll factor for the leapfrog loop. Measured on-chip
    # (eight-schools, 1024 chains, L=32): unroll 8 gave only +5% over 1
    # (0.0965 s vs 0.1017 s) and 16 was slower — the cost is per-op latency
    # of the tiny-tensor gradient, not loop overhead — so the default stays
    # 1; the knob exists for larger-body models where unrolling can fuse.
    unroll: int = 1


# ---------------------------------------------------------------------------
# Dual averaging (Hoffman & Gelman Alg 5; reference: hmc.rs:141-184)
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclass
class DualAveragingState:
    log_eps: Any
    log_eps_bar: Any
    h_bar: Any
    mu: Any
    t: Any  # adaptation step counter

    @staticmethod
    def init(eps0):
        eps0 = jnp.asarray(eps0, settings.real_dtype())
        return DualAveragingState(
            log_eps=jnp.log(eps0),
            log_eps_bar=jnp.zeros_like(eps0),
            h_bar=jnp.zeros_like(eps0),
            mu=jnp.log(10.0 * eps0),
            t=jnp.zeros_like(eps0),
        )


def dual_averaging_update(
    state: DualAveragingState,
    accept_prob,
    target: float = 0.8,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
) -> DualAveragingState:
    """One Nesterov dual-averaging step (math identical to hmc.rs:141-184).
    ``accept_prob`` is the cross-chain mean acceptance statistic."""
    m = state.t + 1.0
    eta_h = 1.0 / (m + t0)
    h_bar = (1.0 - eta_h) * state.h_bar + eta_h * (target - accept_prob)
    log_eps = state.mu - jnp.sqrt(m) / gamma * h_bar
    eta = jnp.power(m, -kappa)
    log_eps_bar = eta * log_eps + (1.0 - eta) * state.log_eps_bar
    return DualAveragingState(
        log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar, mu=state.mu, t=m
    )


# ---------------------------------------------------------------------------
# Welford moments for mass adaptation (reference: hmc.rs:187-233)
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclass
class WelfordState:
    count: Any
    mean: Any
    m2: Any

    @staticmethod
    def init(dim: int, dense: bool = False):
        dt = settings.real_dtype()
        m2_shape = (dim, dim) if dense else (dim,)
        return WelfordState(
            count=jnp.zeros((), dt),
            mean=jnp.zeros((dim,), dt),
            m2=jnp.zeros(m2_shape, dt),
        )


def welford_push_batch(state: WelfordState, batch) -> WelfordState:
    """Fold a (n_chains, d) batch of positions into the moments (Chan
    parallel update) — the cross-chain form of the reference's scalar
    Welford.push (hmc.rs:187-233). ``m2`` tracks elementwise squares (diag)
    or full outer products (dense)."""
    n_b = jnp.asarray(batch.shape[0], state.mean.dtype)
    mean_b = jnp.mean(batch, axis=0)
    centered = batch - mean_b
    n_new = state.count + n_b
    delta = mean_b - state.mean
    mean_new = state.mean + delta * (n_b / n_new)
    w = state.count * n_b / n_new
    if state.m2.ndim == 2:
        m2_b = centered.T @ centered
        m2_new = state.m2 + m2_b + w * jnp.outer(delta, delta)
    else:
        m2_b = jnp.sum(centered**2, axis=0)
        m2_new = state.m2 + m2_b + w * delta**2
    return WelfordState(count=n_new, mean=mean_new, m2=m2_new)


def welford_push_masked(state: WelfordState, batch, mask) -> WelfordState:
    """``welford_push_batch`` with a per-row boolean ``mask``: only rows
    where ``mask`` is True are folded into the moments. Used by the
    asynchronous NUTS drive, where each loop iteration completes a
    transition for an arbitrary subset of chains. A zero-mask batch is a
    no-op."""
    w = mask.astype(state.mean.dtype)
    n_b = jnp.sum(w)
    safe_n = jnp.maximum(n_b, 1.0)
    mean_b = jnp.sum(batch * w[:, None], axis=0) / safe_n
    centered = (batch - mean_b) * w[:, None]
    n_new = state.count + n_b
    delta = mean_b - state.mean
    mean_new = state.mean + delta * (n_b / jnp.maximum(n_new, 1.0))
    wgt = state.count * n_b / jnp.maximum(n_new, 1.0)
    if state.m2.ndim == 2:
        m2_new = state.m2 + centered.T @ centered + wgt * jnp.outer(delta, delta)
    else:
        m2_new = state.m2 + jnp.sum(centered**2, axis=0) + wgt * delta**2
    empty = n_b == 0
    return WelfordState(
        count=jnp.where(empty, state.count, n_new),
        mean=jnp.where(empty, state.mean, mean_new),
        m2=jnp.where(empty, state.m2, m2_new),
    )


def welford_variance(state: WelfordState, regularize: bool = True):
    var = state.m2 / jnp.maximum(state.count - 1.0, 1.0)
    if regularize:  # Stan-style shrinkage toward unit for small counts
        n = state.count
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return jnp.maximum(var, 1e-10)


def welford_covariance(state: WelfordState, regularize: bool = True):
    """Dense covariance estimate with Stan-style shrinkage toward a scaled
    identity (keeps the mass matrix positive definite at small counts)."""
    cov = state.m2 / jnp.maximum(state.count - 1.0, 1.0)
    if regularize:
        n = state.count
        d = cov.shape[0]
        cov = (n / (n + 5.0)) * cov + 1e-3 * (5.0 / (n + 5.0)) * jnp.eye(
            d, dtype=cov.dtype
        )
    return cov + 1e-8 * jnp.eye(cov.shape[0], dtype=cov.dtype)


def welford_merge_across(state: WelfordState, axis_name: str) -> WelfordState:
    """Merge per-shard Welford moments across a named mesh axis (Chan
    parallel combine via psum) — the collective form of cross-chain mass
    adaptation for sharded chain batches."""
    total = jax.lax.psum(state.count, axis_name)
    mean_g = jax.lax.psum(state.count * state.mean, axis_name) / jnp.maximum(
        total, 1.0
    )
    delta = state.mean - mean_g
    if state.m2.ndim == 2:
        corr = state.count * jnp.outer(delta, delta)
    else:
        corr = state.count * delta**2
    m2_g = jax.lax.psum(state.m2 + corr, axis_name)
    return WelfordState(count=total, mean=mean_g, m2=m2_g)


# ---------------------------------------------------------------------------
# Mass-matrix algebra: ``inv_mass`` is either a (d,) vector (diagonal) or a
# (d, d) covariance estimate Σ (dense). Velocity = Σp, kinetic = ½ pᵀΣp,
# momentum ~ N(0, Σ⁻¹) drawn via the Cholesky of Σ.
# ---------------------------------------------------------------------------


def mass_velocity(inv_mass, p):
    if inv_mass.ndim == 1:
        return inv_mass * p
    return inv_mass @ p


def mass_kinetic(inv_mass, p):
    return 0.5 * jnp.sum(p * mass_velocity(inv_mass, p))


def mass_draw_momentum(key, inv_mass, shape, dtype):
    z = jax.random.normal(key, shape, dtype)
    if inv_mass.ndim == 1:
        return z / jnp.sqrt(inv_mass)
    chol = jnp.linalg.cholesky(inv_mass)  # Σ = L Lᵀ → p = L⁻ᵀ z ~ N(0, Σ⁻¹)
    return jax.scipy.linalg.solve_triangular(chol.T, z, lower=False)


# ---------------------------------------------------------------------------
# Leapfrog (reference: hmc.rs:353-407)
# ---------------------------------------------------------------------------


def leapfrog(grad_fn, q, p, eps, n_steps: int, inv_mass, unroll: int = 1):
    """L leapfrog steps with force reuse: L+1 gradient evaluations
    (reference: hmc.rs:353-407 — but each "gradient" here is one reverse-mode
    sweep, not 2d model runs). ``lax.scan`` keeps the trajectory on-chip;
    ``unroll`` replicates the body to amortize per-iteration loop overhead
    on latency-bound small-d models (HMCConfig.unroll)."""
    g = grad_fn(q)

    def body(carry, _):
        q, p, g = carry
        p_half = p - 0.5 * eps * g
        q_new = q + eps * mass_velocity(inv_mass, p_half)
        g_new = grad_fn(q_new)
        p_new = p_half - 0.5 * eps * g_new
        return (q_new, p_new, g_new), None

    (q_new, p_new, g_new), _ = jax.lax.scan(
        body, (q, p, g), None, length=n_steps,
        unroll=min(max(int(unroll), 1), max(int(n_steps), 1)),
    )
    return q_new, p_new


def leapfrog_recorded(grad_fn, potential_fn, q, p, eps, n_steps: int, inv_mass):
    """Leapfrog that records the full trajectory (positions + Hamiltonians)
    for diagnostics/animation (reference: step_recorded, hmc.rs:811-817)."""
    g = grad_fn(q)

    def body(carry, _):
        q, p, g = carry
        p_half = p - 0.5 * eps * g
        q_new = q + eps * mass_velocity(inv_mass, p_half)
        g_new = grad_fn(q_new)
        p_new = p_half - 0.5 * eps * g_new
        h = potential_fn(q_new) + mass_kinetic(inv_mass, p_new)
        return (q_new, p_new, g_new), (q_new, h)

    (q_new, p_new, _), (qs, hs) = jax.lax.scan(body, (q, p, g), None, length=n_steps)
    return q_new, p_new, qs, hs


# ---------------------------------------------------------------------------
# One HMC transition (per chain; vmap over chains)
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclass
class HmcStepInfo:
    """Per-transition metadata (reference: HmcStepInfo, hmc.rs:586-602)."""

    accept_prob: Any
    accepted: Any
    divergent: Any
    energy: Any


def hmc_transition(
    potential_fn: Callable,
    q,
    key,
    eps,
    n_leapfrog: int,
    inv_mass,
    max_delta_energy: float = 1000.0,
    unroll: int = 1,
):
    """One HMC proposal + MH correction for a single chain position ``q``.

    Divergences (non-finite energy or |ΔH| > threshold) are always rejected
    (reference: hmc.rs:445-458).
    """
    k_mom, k_acc = jax.random.split(key)
    grad_fn = jax.grad(potential_fn)
    p = mass_draw_momentum(k_mom, inv_mass, q.shape, q.dtype)
    u0 = potential_fn(q)
    h0 = u0 + mass_kinetic(inv_mass, p)
    q_new, p_new = leapfrog(grad_fn, q, p, eps, n_leapfrog, inv_mass, unroll)
    u1 = potential_fn(q_new)
    h1 = u1 + mass_kinetic(inv_mass, p_new)
    delta = h0 - h1
    finite = jnp.isfinite(delta) & jnp.isfinite(u1)
    divergent = (~finite) | (-delta > max_delta_energy)
    accept_prob = jnp.where(
        divergent, 0.0, jnp.minimum(1.0, jnp.exp(jnp.minimum(delta, 50.0)))
    )
    log_u = jnp.log(jax.random.uniform(k_acc, (), q.dtype, 1e-38, 1.0))
    accepted = (~divergent) & (log_u < delta)
    q_out = jnp.where(accepted, q_new, q)
    info = HmcStepInfo(
        accept_prob=accept_prob,
        accepted=accepted,
        divergent=divergent,
        energy=jnp.where(accepted, h1, h0),
    )
    return q_out, info


# ---------------------------------------------------------------------------
# Reasonable epsilon (Hoffman & Gelman Alg 4; reference: hmc.rs:479-535)
# ---------------------------------------------------------------------------


def find_reasonable_epsilon(
    potential_fn, q, key, inv_mass, max_iters: int = 60, n_steps: int = 1
):
    """Double/halve eps until the acceptance of an ``n_steps`` trajectory
    crosses 0.5. ``n_steps=1`` is Hoffman-Gelman Alg 4 (used with dual
    averaging); pass the real trajectory length for un-adapted sessions."""
    dt = q.dtype
    grad_fn = jax.grad(potential_fn)
    p = mass_draw_momentum(key, inv_mass, q.shape, dt)
    h0 = potential_fn(q) + mass_kinetic(inv_mass, p)

    def log_accept(eps):
        q1, p1 = leapfrog(grad_fn, q, p, eps, n_steps, inv_mass)
        h1 = potential_fn(q1) + mass_kinetic(inv_mass, p1)
        la = h0 - h1
        return jnp.where(jnp.isfinite(la), la, -jnp.inf)

    eps0 = jnp.asarray(1.0, dt)
    la0 = log_accept(eps0)
    # direction: +1 double while accept > 0.5, -1 halve while accept < 0.5
    direction = jnp.where(la0 > jnp.log(0.5), 1.0, -1.0)

    def cond(carry):
        eps, la, it = carry
        keep = jnp.where(
            direction > 0, la > jnp.log(0.5), la < jnp.log(0.5)
        )
        return keep & (it < max_iters) & (eps > 1e-10) & (eps < 1e7)

    def body(carry):
        eps, _, it = carry
        eps_new = eps * jnp.where(direction > 0, 2.0, 0.5)
        return (eps_new, log_accept(eps_new), it + 1)

    eps, _, _ = jax.lax.while_loop(cond, body, (eps0, la0, 0))
    # doubling exits one step PAST the crossing (accept just fell below
    # 0.5); step back so the returned eps is on the stable side
    eps = jnp.where(direction > 0, eps * 0.5, eps)
    return jnp.clip(eps, 1e-8, 1e6)


# ---------------------------------------------------------------------------
# Full chain driver (reference: hmc_chain, hmc.rs:566; warmup schedule
# :880-908 — Welford mass at warmup midpoint + epsilon re-search)
# ---------------------------------------------------------------------------


def _discrete_cache_key(discrete):
    """Content-keyed cache key for a discrete-conditioning dict.

    The discrete VALUES are baked into compiled drive closures as
    constants, so the key must distinguish different conditioning values.
    Keyed by CONTENT (address, dtype, shape, bytes), not ``id()``: an
    id-keyed entry is only sound while something pins the dict alive, and a
    gc'd dict's id can be recycled by a new dict — silently returning a
    stale compiled kernel with the old baked values (ADVICE r3). Content
    keys also let two equal dicts share one executable.
    """
    if discrete is None:
        return None
    return tuple(
        (a, str(np.asarray(v).dtype), np.asarray(v).shape,
         np.asarray(v).tobytes())
        for a, v in sorted(discrete.items())
    )


def initial_positions(staged: StagedModel, key, n_chains: int, init: str):
    """Batch of unconstrained starting positions."""
    dt = settings.real_dtype()
    if init == "uniform":
        return jax.random.uniform(key, (n_chains, staged.dim), dt, -2.0, 2.0)
    return jax.vmap(staged.initial_position)(chain_keys(key, n_chains)).astype(dt)


def _warm_start_batch(staged, key, n_chains, init_position, init_jitter):
    """(d,) point → jittered (n_chains, d) batch; (n_chains, d) → as-is."""
    dt = settings.real_dtype()
    q = jnp.asarray(init_position, dt)
    if q.ndim == 1:
        if q.shape[0] != staged.dim:
            raise ValueError(f"init_position dim {q.shape[0]} != {staged.dim}")
        noise = jax.random.normal(key, (n_chains, staged.dim), dt)
        return q[None, :] + init_jitter * noise
    if q.shape != (n_chains, staged.dim):
        raise ValueError(
            f"init_position {q.shape} != (n_chains={n_chains}, d={staged.dim})"
        )
    return q


def constrain_positions(staged: StagedModel, positions):
    """(chains, samples, d) unconstrained → per-site constrained arrays,
    via a cached jitted kernel."""
    f = staged.cached_kernel(
        ("constrain_batch2",),
        lambda: jax.jit(
            jax.vmap(jax.vmap(lambda z: staged.constrain(z)[0]))
        ),
    )
    return f(positions)


def make_hmc_drive(
    staged: StagedModel,
    config: HMCConfig,
    n_chains: int,
    n_samples: int,
    n_warmup: int,
    *,
    discrete: Optional[Dict[str, Any]] = None,
    chain_axis: Optional[str] = None,
    inv_mass_init=None,
):
    """Build the pure warmup+sampling program ``(q0, k_eps, k_run) → arrays``.

    A module-level factory so the SAME program runs (a) jitted on one chip
    with a vmapped chain batch, or (b) inside ``shard_map`` with the chain
    batch sharded over mesh axis ``chain_axis`` — where the adaptation
    statistics (acceptance pmean, initial epsilon, Welford mass moments)
    become mesh collectives (parallel/sharded.py).
    """
    dt = settings.real_dtype()
    d = staged.dim

    def potential(z):
        return staged.potential(z, discrete)

    def cross_mean(x):
        if chain_axis is not None:
            return jax.lax.pmean(jnp.mean(x), chain_axis)
        return jnp.mean(x)

    dense = config.mass == "dense"
    if inv_mass_init is not None:
        inv_mass0 = jnp.asarray(inv_mass_init, dt)
    else:
        inv_mass0 = jnp.eye(d, dtype=dt) if dense else jnp.ones((d,), dt)

    def drive(q0, k_eps, k_run, eps_over=None, inv_mass_over=None):
        # ``eps_over``/``inv_mass_over``: runtime (traced) overrides so resume
        # paths don't bake arrays into the jitted closure (one executable
        # serves every resumed step size / mass matrix).
        im0 = inv_mass0 if inv_mass_over is None else jnp.asarray(inv_mass_over, dt)
        if eps_over is not None:
            eps0 = jnp.asarray(eps_over, dt)
        elif config.step_size is not None:
            eps0 = jnp.asarray(config.step_size, dt)
        else:
            eps0 = find_reasonable_epsilon(potential, q0[0], k_eps, im0)
            if chain_axis is not None:
                # consensus initial step size across shards
                eps0 = jnp.exp(jax.lax.pmean(jnp.log(eps0), chain_axis))
        da0 = DualAveragingState.init(eps0)

        def jittered_step(q, k, eps, im):
            k_j, k_t = jax.random.split(k)
            if config.jitter > 0:
                eps = eps * jax.random.uniform(
                    k_j, (), dt, 1.0 - config.jitter, 1.0
                )
            return hmc_transition(
                potential, q, k_t, eps, config.n_leapfrog, im,
                config.max_delta_energy, config.unroll,
            )

        vstep = jax.vmap(jittered_step, in_axes=(0, 0, None, None))

        def warm_body(carry, k):
            q, da, welford, inv_mass, ema = carry
            eps = jnp.exp(da.log_eps) if config.adapt_step_size else jnp.exp(da.mu - jnp.log(10.0))
            keys = jax.random.split(k, n_chains)
            q_new, info = vstep(q, keys, eps, inv_mass)
            a_mean = cross_mean(info.accept_prob)
            da_new = dual_averaging_update(da, a_mean, config.target_accept)
            welford_new = welford_push_batch(welford, q_new)
            ema_new = 0.9 * ema + 0.1 * info.accept_prob
            return (q_new, da_new, welford_new, inv_mass, ema_new), a_mean

        def rescue_stuck(q, ema, k):
            """Warmup-only cross-chain rescue: a chain whose acceptance EMA
            collapsed (stranded on a gradient cliff where every proposal
            diverges) copies the position of a donor chain drawn with
            probability ∝ its EMA. Affects only warmup, so the stationary
            phase is untouched; with many chains this makes the warmup
            robust to heavy-tailed inits the way a single chain can't be."""
            donors = jax.random.categorical(
                k, jnp.log(ema + 1e-6), shape=(n_chains,)
            )
            stuck = ema < 0.1
            return jnp.where(stuck[:, None], q[donors], q)

        n_half = n_warmup // 2

        carry = (q0, da0, WelfordState.init(d, dense), im0,
                 jnp.full((n_chains,), 0.5, dt))
        if n_warmup > 0:
            warm_keys1 = jax.random.split(jax.random.fold_in(k_run, 0), max(n_half, 1))
            carry, _ = jax.lax.scan(warm_body, carry, warm_keys1)
            q1, da1, welford1, _, ema1 = carry
            q1 = rescue_stuck(q1, ema1, jax.random.fold_in(k_run, 91))
            if config.adapt_mass:
                # midpoint: mass ← regularized variances; epsilon re-tune
                # (reference: hmc.rs:885-908). Sharded: merge shard moments
                # first so every device adopts the same mass matrix.
                if chain_axis is not None:
                    welford1 = welford_merge_across(welford1, chain_axis)
                inv_mass1 = (
                    welford_covariance(welford1) if dense
                    else welford_variance(welford1)
                )
                da1 = DualAveragingState.init(jnp.exp(da1.log_eps_bar))
            else:
                inv_mass1 = im0
            carry = (q1, da1, WelfordState.init(d, dense), inv_mass1,
                     jnp.full((n_chains,), 0.5, dt))
            warm_keys2 = jax.random.split(
                jax.random.fold_in(k_run, 1), max(n_warmup - n_half, 1)
            )
            carry, _ = jax.lax.scan(warm_body, carry, warm_keys2)
            q2, da2, w2, im2, ema2 = carry
            q2 = rescue_stuck(q2, ema2, jax.random.fold_in(k_run, 92))
            carry = (q2, da2, w2, im2, ema2)

        q_w, da_w, _, inv_mass_f, _ = carry
        # adaptation off -> the CONFIGURED eps; da.log_eps is updated by the
        # warmup scan regardless (shared body), so reading it here when
        # adapt_step_size=False returned runaway garbage (scale-tier bug r3)
        eps_final = (
            jnp.exp(da_w.log_eps_bar)
            if (config.adapt_step_size and n_warmup > 0)
            else eps0
        )

        def sample_body(q, k):
            keys = jax.random.split(k, n_chains)
            q_new, info = vstep(q, keys, eps_final, inv_mass_f)
            lj = jax.vmap(lambda z: -potential(z))(q_new)
            return q_new, (q_new, lj, info.accept_prob, info.divergent)

        sample_keys = jax.random.split(jax.random.fold_in(k_run, 2), n_samples)
        q_f, (qs, ljs, aps, divs) = jax.lax.scan(sample_body, q_w, sample_keys)
        return q_f, qs, ljs, aps, divs, eps_final, inv_mass_f

    return drive


@dataclass
class HMCResult:
    samples: Dict[str, Any]  # constrained, addr -> (n_chains, n_samples, ...)
    positions: Any  # unconstrained (n_chains, n_samples, d)
    log_joint: Any  # (n_chains, n_samples) — log p + log|J| at samples
    accept_prob: Any  # (n_samples, ) cross-chain mean per step
    divergences: Any  # (n_chains, n_samples) bool
    step_size: float
    inv_mass: Any
    final_positions: Any


def hmc_chain(
    key,
    model_fn: Optional[Callable] = None,
    n_samples: int = 1000,
    n_warmup: int = 1000,
    config: HMCConfig = HMCConfig(),
    *,
    n_chains: int = 1,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    discrete: Optional[Dict[str, Any]] = None,
    chain_axis: Optional[str] = None,
    resume: Optional["HMCResult"] = None,
    init_position: Optional[Any] = None,
    init_jitter: float = 0.05,
) -> HMCResult:
    """Run HMC with cross-chain warmup adaptation.

    ``resume``: a previous ``HMCResult`` (or any object with
    ``final_positions``, ``step_size``, ``inv_mass``) — sampling continues
    from its final state with the warmed kernel (warmup skipped). Combine
    with runtime.checkpoint for long-run persistence.

    ``init_position``: warm-start unconstrained position(s) — a ``(d,)``
    point (e.g. ``MAPResult.z``) broadcast to all chains with per-chain
    Gaussian jitter of scale ``init_jitter``, or an explicit
    ``(n_chains, d)`` batch used as-is. Warmup still runs (unlike
    ``resume``).

    ``chain_axis``: when set, the chain batch axis is a named mesh axis
    (inside ``shard_map``) and adaptation statistics reduce with
    ``lax.pmean`` over it; when None, plain ``jnp.mean`` (single chip).

    Discrete sites are held fixed (reference: hmc.rs:69-71) at their
    discovery values or at ``discrete``; compose with MH/Gibbs sweeps for
    mixed models (see inference.gibbs).
    """
    if staged is None:
        staged = stage(model_fn, *model_args)
    dt = settings.real_dtype()
    if staged.dim == 0:
        raise ValueError("model has no continuous latent sites; use MH")

    if resume is not None and init_position is not None:
        raise ValueError(
            "pass either resume= or init_position=, not both — resume "
            "continues from its own final positions and would silently "
            "ignore the warm start"
        )

    if resume is not None:
        # adaptation off; eps/mass/positions flow in as runtime arguments so
        # repeated resumes share ONE compiled executable (no baked arrays)
        config = replace(
            config, step_size=None, adapt_step_size=False, adapt_mass=False
        )
        n_warmup = 0
        q_resume = jnp.asarray(resume.final_positions, dt)
        if q_resume.shape != (n_chains, staged.dim):
            raise ValueError(
                f"resume positions {q_resume.shape} do not match "
                f"(n_chains={n_chains}, d={staged.dim})"
            )
        mode = "resume"
    elif init_position is not None:
        init_q = jnp.asarray(init_position, dt)
        mode = ("warm", init_q.ndim, float(init_jitter))
    else:
        mode = "fresh"

    # large stage() data arguments flow in as TRACED jit arguments instead
    # of baked closure constants (StagedModel.data_leaves — keeps giant
    # design matrices out of the serialized compile payload)
    data = staged.data_leaves()

    def build_drive():
        inner = make_hmc_drive(
            staged, config, n_chains, n_samples, n_warmup,
            discrete=discrete, chain_axis=chain_axis,
        )

        if mode == "resume":
            def full(k, q0, eps0, im0, *dl):
                with staged.bind_data(dl):
                    _, k_eps, k_run = jax.random.split(
                        jax.random.fold_in(k, 7), 3
                    )
                    return inner(q0, k_eps, k_run, eps_over=eps0,
                                 inv_mass_over=im0)
        elif mode == "fresh":
            def full(k, *dl):
                with staged.bind_data(dl):
                    k_init, k_eps, k_run = jax.random.split(
                        jax.random.fold_in(k, 7), 3
                    )
                    q0 = initial_positions(
                        staged, k_init, n_chains, config.init
                    )
                    return inner(q0, k_eps, k_run)
        else:
            def full(k, q_init, *dl):
                with staged.bind_data(dl):
                    k_init, k_eps, k_run = jax.random.split(
                        jax.random.fold_in(k, 7), 3
                    )
                    q0 = _warm_start_batch(
                        staged, k_init, n_chains, q_init, init_jitter
                    )
                    return inner(q0, k_eps, k_run)

        return jax.jit(full)

    drive = staged.cached_kernel(
        ("hmc_drive", config, n_chains, n_samples, n_warmup, chain_axis,
         _discrete_cache_key(discrete), mode),
        build_drive,
    )
    if mode == "resume":
        out = drive(
            key, q_resume, jnp.asarray(resume.step_size, dt),
            jnp.asarray(resume.inv_mass, dt), *data,
        )
    elif mode == "fresh":
        out = drive(key, *data)
    else:
        out = drive(key, init_q, *data)
    q_f, qs, ljs, aps, divs, eps_final, inv_mass_f = out

    # constrain positions -> per-site sample arrays (n_chains, n_samples, ...)
    positions = jnp.moveaxis(qs, 0, 1)  # (n_chains, n_samples, d)
    samples = constrain_positions(staged, positions)
    return HMCResult(
        samples=samples,
        positions=positions,
        log_joint=jnp.moveaxis(ljs, 0, 1),
        accept_prob=jnp.mean(aps, axis=-1),
        divergences=jnp.moveaxis(divs, 0, 1),
        step_size=float(np.asarray(eps_final)),
        inv_mass=inv_mass_f,
        final_positions=q_f,
    )


# ---------------------------------------------------------------------------
# Incremental session (reference: HmcSession, hmc.rs:643-920)
# ---------------------------------------------------------------------------


class HmcSession:
    """Stateful incremental HMC: step-by-step transitions with live control,
    trajectory recording, and state inspection — parity with the reference's
    ``HmcSession`` (hmc.rs:643-920) used by the browser bindings.

    Holds (position, step_size, inv_mass, key) as device arrays; each call is
    one jit-compiled transition, so interactive use stays fast.
    """

    def __init__(
        self,
        key,
        model_fn: Optional[Callable] = None,
        config: HMCConfig = HMCConfig(),
        *,
        staged: Optional[StagedModel] = None,
        model_args: tuple = (),
    ):
        self.staged = staged if staged is not None else stage(model_fn, *model_args)
        if self.staged.dim == 0:
            raise ValueError("model has no continuous latent sites")
        self.config = config
        k_init, k_eps, self._key = jax.random.split(key, 3)
        self._q = self.staged.initial_position(k_init).astype(settings.real_dtype())
        self.inv_mass = jnp.ones((self.staged.dim,), settings.real_dtype())
        if config.step_size is not None:
            self.step_size = float(config.step_size)
        else:
            # search along the session's real trajectory length: no dual
            # averaging runs afterwards, so the one-step Alg-4 estimate can
            # be unstable at L steps
            self.step_size = float(
                np.asarray(
                    find_reasonable_epsilon(
                        self.staged.potential, self._q, k_eps, self.inv_mass,
                        n_steps=config.n_leapfrog,
                    )
                )
            )
        self.n_leapfrog = config.n_leapfrog
        self._jit_step = jax.jit(
            lambda q, k, eps, im, L: hmc_transition(
                self.staged.potential, q, k, eps, L, im, config.max_delta_energy
            ),
            static_argnums=(4,),
        )

        def _recorded(q, k, eps, im, L):
            k_mom, k_acc = jax.random.split(k)
            grad_fn = jax.grad(self.staged.potential)
            p = mass_draw_momentum(k_mom, im, q.shape, q.dtype)
            h0 = self.staged.potential(q) + mass_kinetic(im, p)
            q_new, p_new, qs, hs = leapfrog_recorded(
                grad_fn, self.staged.potential, q, p, eps, L, im
            )
            h1 = self.staged.potential(q_new) + mass_kinetic(im, p_new)
            delta = h0 - h1
            finite = jnp.isfinite(delta)
            divergent = (~finite) | (-delta > config.max_delta_energy)
            log_u = jnp.log(jax.random.uniform(k_acc, (), q.dtype, 1e-38, 1.0))
            accepted = (~divergent) & (log_u < delta)
            q_out = jnp.where(accepted, q_new, q)
            ap = jnp.where(divergent, 0.0, jnp.minimum(1.0, jnp.exp(jnp.minimum(delta, 50.0))))
            return q_out, accepted, divergent, ap, qs, hs, h0

        self._jit_recorded = jax.jit(_recorded, static_argnums=(4,))

    def warmup(self, n_steps: int = 100) -> None:
        """Adapt the step size in place with dual averaging (the session
        analog of the chain driver's warmup phase)."""
        da = DualAveragingState.init(jnp.asarray(self.step_size))
        for _ in range(n_steps):
            info = self.step()
            da = dual_averaging_update(
                da, info.accept_prob, self.config.target_accept
            )
            self.step_size = float(np.exp(np.asarray(da.log_eps)))
        self.step_size = float(np.exp(np.asarray(da.log_eps_bar)))

    # live control (reference: set_step_size / set_n_leapfrog, hmc.rs:871-880)
    def set_step_size(self, eps: float) -> None:
        self.step_size = float(eps)

    def set_n_leapfrog(self, n: int) -> None:
        self.n_leapfrog = int(n)

    @property
    def position(self):
        return self._q

    def current_trace(self):
        """Constrained values + density parts at the current position."""
        cont, _ = self.staged.constrain(self._q)
        return self.staged.replay_trace(self.staged.merge_discrete(cont))

    def step(self) -> HmcStepInfo:
        self._key, k = jax.random.split(self._key)
        q_new, info = self._jit_step(
            self._q, k, self.step_size, self.inv_mass, self.n_leapfrog
        )
        self._q = q_new
        return info

    def step_recorded(self):
        """One transition returning the full trajectory (positions and
        Hamiltonians per leapfrog step) for animation/diagnostics
        (reference: step_recorded, hmc.rs:811-817)."""
        self._key, k = jax.random.split(self._key)
        q_out, accepted, divergent, ap, qs, hs, h0 = self._jit_recorded(
            self._q, k, self.step_size, self.inv_mass, self.n_leapfrog
        )
        self._q = q_out
        return {
            "accepted": bool(np.asarray(accepted)),
            "divergent": bool(np.asarray(divergent)),
            "accept_prob": float(np.asarray(ap)),
            "trajectory": np.asarray(qs),
            "hamiltonians": np.asarray(hs),
            "initial_energy": float(np.asarray(h0)),
        }
