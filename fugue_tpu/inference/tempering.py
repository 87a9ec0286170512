"""Parallel tempering (replica exchange) over a vectorized temperature axis.

Beyond-parity engine (no reference counterpart; the closest
reference machinery is likelihood tempering inside SMC, smc.rs:455-580 —
here the whole β ladder runs SIMULTANEOUSLY as one more batch axis).
Multimodal posteriors defeat single-temperature HMC (chains cannot cross
low-density barriers); replica exchange runs K tempered copies
π_β ∝ prior · likelihood^β and lets states migrate from the hot, flattened
ladder rungs down to β = 1.

Array shape: positions are one (K·C, d) batch — every rung × every chain
leapfrogs in the same vmapped HMC transition (the device sees one big
batch, K× the work of plain HMC for far super-K× mixing on multimodal
targets). Swaps are the classic deterministic even/odd neighbor scheme:
each phase proposes ALL disjoint adjacent pairs at once as a masked gather
(no host loop, no sequential pair scan), with the exact exchange acceptance
log α = (β_k − β_{k+1}) · (ll_{k+1} − ll_k). Per-rung step sizes adapt
independently during warmup (log-ε Robbins-Monro toward 0.8 acceptance,
cross-chain mean), since hot rungs tolerate much larger steps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import settings
from ..runtime.staging import StagedModel, stage
from .hmc import (
    _discrete_cache_key,
    constrain_positions,
    hmc_transition,
    initial_positions,
)


@dataclass(frozen=True)
class PTConfig:
    n_temps: int = 8
    beta_min: float = 0.02  # hottest rung; ladder is geometric down to 1.0
    n_leapfrog: int = 16
    step_size: float = 0.2  # initial per-rung ε (adapted during warmup)
    target_accept: float = 0.8
    swap_every: int = 1  # HMC transitions between swap phases
    init: str = "prior"


@dataclass
class PTResult:
    samples: Dict[str, Any]  # β=1 chain samples: (n_chains, n_samples, ...)
    positions: Any  # (n_chains, n_samples, d) at β=1
    betas: Any  # (K,)
    swap_rate: Any  # (K-1,) mean exchange acceptance per adjacent pair
    accept_prob: Any  # (K,) mean HMC acceptance per rung
    step_size: Any  # (K,) adapted ε per rung
    final_positions: Any  # (K, n_chains, d)


def geometric_ladder(n_temps: int, beta_min: float):
    """β_K−1 = 1 down to β_0 = beta_min, geometrically spaced — the standard
    ladder for likelihood tempering (constant expected swap rate when the
    log-likelihood scale is roughly constant)."""
    if n_temps < 2:
        return jnp.ones((1,), settings.real_dtype())
    r = np.exp(np.linspace(np.log(beta_min), 0.0, n_temps))
    return jnp.asarray(r, settings.real_dtype())


def make_pt_drive(
    staged: StagedModel,
    config: PTConfig,
    n_chains: int,
    n_samples: int,
    n_warmup: int,
    *,
    discrete: Optional[Dict[str, Any]] = None,
    chain_axis: Optional[str] = None,
):
    """Pure ``key → arrays`` replica-exchange program — the
    ``make_hmc_drive`` factory contract, so the one program jits on a chip
    OR runs inside ``shard_map`` with the CHAIN axis sharded over
    ``chain_axis`` (the β ladder is replicated per shard; swaps are
    rung-axis gathers, chain-local, so no collective moves positions — only
    the per-rung ε adaptation statistic reduces with ``pmean``)."""
    dt = settings.real_dtype()
    K, C, d = config.n_temps, n_chains, staged.dim
    betas = geometric_ladder(K, config.beta_min)

    def parts_at(z):
        parts, logdet = staged.log_density_parts_unconstrained(z, discrete)
        lik = parts.log_likelihood + parts.log_factors
        return parts.log_prior + logdet, lik

    def u_beta(z, beta):
        base, lik = parts_at(z)
        return -(base + beta * lik)

    def lik_of(z):
        return parts_at(z)[1]

    def cmean_chains(x):
        # mean over the chain axis (axis 1 of (K, C)), cross-shard when
        # the chain batch is a named mesh axis
        m = jnp.mean(x, axis=1)
        if chain_axis is not None:
            m = jax.lax.pmean(m, chain_axis)
        return m

    def build():
        inv_mass = jnp.ones((d,), dt)

        def hmc_phase(q, eps, k):
            # one vmapped transition over ALL rungs × chains
            keys = jax.random.split(k, K * C)
            keys = keys.reshape((K, C) + keys.shape[1:])

            def one(qi, ki, beta, eps_k):
                return hmc_transition(
                    lambda z: u_beta(z, beta), qi, ki,
                    eps_k, config.n_leapfrog, inv_mass,
                )

            q_new, info = jax.vmap(  # over rungs
                jax.vmap(one, in_axes=(0, 0, None, None)),  # over chains
                in_axes=(0, 0, 0, 0),
            )(q, keys, betas, eps)
            return q_new, info

        ks = jnp.arange(K)

        def swap_phase(q, ll, parity, k):
            # disjoint adjacent pairs (k, k+1) with k ≡ parity (mod 2)
            left = (ks % 2 == parity) & (ks + 1 < K)
            right = jnp.roll(left, 1) & (ks > 0)
            partner = jnp.where(left, ks + 1, jnp.where(right, ks - 1, ks))
            log_a = (betas[ks] - betas[partner])[:, None] * (
                jnp.take(ll, partner, axis=0) - ll
            )  # (K, C); symmetric across the pair by construction
            pair_left = jnp.where(right, ks - 1, ks)
            u = jax.random.uniform(k, (K, C), dt, 1e-38, 1.0)
            u_shared = jnp.take(u, pair_left, axis=0)  # one draw per pair
            accept = (jnp.log(u_shared) < log_a) & (partner != ks)[:, None]
            src = jnp.where(accept, partner[:, None], ks[:, None])  # (K, C)
            q_sw = jnp.take_along_axis(q, src[:, :, None], axis=0)
            ll_sw = jnp.take_along_axis(ll, src, axis=0)
            # exchange acceptance per adjacent pair (left index k → pair k)
            pair_acc = jnp.where(
                left[:, None], accept.astype(dt), jnp.nan
            )
            return q_sw, ll_sw, pair_acc

        def step(carry, inputs):
            q, eps, ll = carry
            k_step, t, adapting = inputs
            k_hmc, k_swap = jax.random.split(k_step)
            q, info = hmc_phase(q, eps, k_hmc)
            ll = jax.vmap(jax.vmap(lik_of))(q)
            q, ll, pair_acc = swap_phase(q, ll, t % 2, k_swap)
            # per-rung Robbins-Monro ε adaptation (warmup only); the
            # acceptance statistic is cross-chain (and cross-shard) so
            # every device adapts the same per-rung kernel
            acc_k = cmean_chains(info.accept_prob)  # (K,)
            gain = jnp.where(adapting, jnp.power(t + 1.0, -0.6), 0.0)
            eps = eps * jnp.exp(gain * (acc_k - config.target_accept))
            return (q, eps, ll), (q[-1], acc_k, pair_acc)

        def drive(k, q_over=None, eps_over=None):
            # ``q_over``/``eps_over``: runtime (traced) resume overrides —
            # the full inter-transition state of PT is (ladder positions,
            # per-rung ε); passing them as jit ARGUMENTS lets one compiled
            # executable serve every resumed state (hmc drive convention)
            k_init, k_run = jax.random.split(jax.random.fold_in(k, 23))
            if q_over is not None:
                q0 = jnp.asarray(q_over, dt)
            else:
                q0 = initial_positions(staged, k_init, K * C, config.init)
                q0 = q0.reshape(K, C, d).astype(dt)
            if eps_over is not None:
                eps0 = jnp.asarray(eps_over, dt)
            else:
                eps0 = jnp.full((K,), config.step_size, dt)
                # hot rungs tolerate bigger steps: scale ε by β^-1/2 initially
                eps0 = eps0 / jnp.sqrt(betas)
            ll0 = jax.vmap(jax.vmap(lik_of))(q0)

            n_total = n_warmup + n_samples
            keys = jax.random.split(k_run, n_total)
            ts = jnp.arange(n_total)
            adapting = ts < n_warmup
            (q_f, eps_f, _), (q1s, accs, pair_accs) = jax.lax.scan(
                step, (q0, eps0, ll0), (keys, ts, adapting)
            )
            return q_f, eps_f, q1s[n_warmup:], accs[n_warmup:], pair_accs[n_warmup:]

        return drive

    return build()


def _pt_result(staged, betas, q_f, eps_f, q1s, accs, pair_accs) -> PTResult:
    positions = jnp.moveaxis(q1s, 0, 1)  # (C, n_samples, d)
    # drop the last rung (never a pair-left index; all-NaN) BEFORE nanmean
    swap_rate = np.nanmean(np.asarray(pair_accs)[:, :-1, :], axis=(0, 2))
    return PTResult(
        samples=constrain_positions(staged, positions),
        positions=positions,
        betas=betas,
        swap_rate=jnp.asarray(swap_rate),
        accept_prob=jnp.mean(accs, axis=0),
        step_size=eps_f,
        final_positions=q_f,
    )


def pt_chain(
    key,
    model_fn: Optional[Callable] = None,
    n_samples: int = 1000,
    n_warmup: int = 1000,
    config: PTConfig = PTConfig(),
    *,
    n_chains: int = 8,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    discrete: Optional[Dict[str, Any]] = None,
    resume: Optional["PTResult"] = None,
) -> PTResult:
    """Replica-exchange HMC. Returns β=1 samples; hot rungs are machinery.

    Exactness: each rung's HMC transition is π_β-invariant, and the swap
    move satisfies detailed balance for the product measure Π_k π_{β_k}, so
    the β=1 marginal is the exact posterior regardless of ladder quality —
    a bad ladder only costs mixing speed.

    ``resume``: a previous ``PTResult`` (or any object with
    ``final_positions`` of shape (K, n_chains, d) and ``step_size`` of
    shape (K,)) — sampling continues from the full ladder state with the
    warmed per-rung kernels (warmup skipped, ε adaptation frozen; the
    reference's all-state-in-a-value discipline, hmc.rs:604-642). The
    state flows in as runtime arguments, so repeated resumes share one
    compiled executable.

    Sharded variant: ``fugue_tpu.parallel.sharded_pt_chain`` runs this
    drive inside ``shard_map`` with the chain batch on a mesh axis.
    """
    if staged is None:
        staged = stage(model_fn, *model_args)
    if staged.dim == 0:
        raise ValueError("model has no continuous latent sites; use MH")

    mode = "fresh"
    if resume is not None:
        n_warmup = 0
        q_resume = jnp.asarray(
            resume.final_positions, settings.real_dtype()
        )
        K = config.n_temps
        if q_resume.shape != (K, n_chains, staged.dim):
            raise ValueError(
                f"resume ladder positions {q_resume.shape} do not match "
                f"(K={K}, n_chains={n_chains}, d={staged.dim})"
            )
        eps_resume = jnp.asarray(resume.step_size, settings.real_dtype())
        if eps_resume.shape != (K,):
            raise ValueError(
                f"resume step sizes {eps_resume.shape} do not match (K={K},)"
            )
        mode = "resume"

    def build():
        inner = make_pt_drive(
            staged, config, n_chains, n_samples, n_warmup,
            discrete=discrete,
        )
        if mode == "resume":
            return jax.jit(lambda k, q0, e0: inner(
                k, q_over=q0, eps_over=e0))
        return jax.jit(inner)

    drive = staged.cached_kernel(
        ("pt_drive", config, n_chains, n_samples, n_warmup, mode,
         # content-keyed: discrete VALUES are baked into the drive closure
         # (hmc.py _discrete_cache_key convention)
         _discrete_cache_key(discrete)),
        build,
    )
    if mode == "resume":
        out = drive(key, q_resume, eps_resume)
    else:
        out = drive(key)
    betas = geometric_ladder(config.n_temps, config.beta_min)
    return _pt_result(staged, betas, *out)
