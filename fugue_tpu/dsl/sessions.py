"""Incremental sampler sessions + visualization utilities.

Capability parity with the reference's wasm façades (reference:
crates/fugue-wasm/src — ``WasmMh`` incremental multi-chain MH with per-chain
seeded adaptation + capped history + optional pinned proposal scale
(mh.rs:16-80); ``WasmHmc`` returning recorded trajectories for animation
(hmc.rs:16-75); 1-D bootstrap particle filter on a random-walk state-space
model (pf.rs:1-70); one-shot ``wasm_smc_run`` (smc.rs:30); 2-D posterior
``log_joint_grid`` heatmaps (grid.rs:22)).

Device-resident: each session holds device-resident state and every ``step`` is a
jit-compiled kernel; chains within a session are vmapped (the reference
round-robins ≤16 chains in one thread — here any count runs in lock-step).
``HmcSession`` (inference/hmc.py) already provides the recorded-trajectory
API; it is re-exported here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import settings
from ..core.rng import chain_keys
from ..inference.hmc import HmcSession  # noqa: F401  (re-export)
from ..inference.mh import init_mh_state, mh_step
from ..inference.smc import SMCConfig, adaptive_smc
from ..ops.resampling import (
    effective_sample_size,
    normalize_log_weights,
    systematic_resample,
)
from ..runtime.staging import StagedModel, stage


class MhSession:
    """Incremental adaptive-MH over n independent chains
    (reference: WasmMh, mh.rs:16-80)."""

    def __init__(
        self,
        key,
        model_fn: Optional[Callable] = None,
        *,
        n_chains: int = 4,
        history_cap: int = 4096,
        pinned_scale: Optional[float] = None,
        staged: Optional[StagedModel] = None,
        model_args: tuple = (),
    ):
        self.staged = staged if staged is not None else stage(model_fn, *model_args)
        self.n_chains = n_chains
        self.history_cap = history_cap
        self.pinned = pinned_scale is not None
        k_init, self._key = jax.random.split(key)
        self._state = jax.vmap(
            lambda k: init_mh_state(
                self.staged, k,
                pinned_scale if pinned_scale is not None else 0.5,
            )
        )(chain_keys(k_init, n_chains))
        self._step = jax.jit(
            jax.vmap(
                lambda st, k: mh_step(
                    self.staged, st, k, not self.pinned
                )
            )
        )
        self.history: List[Dict[str, np.ndarray]] = []
        self._accepts = 0
        self._steps = 0

    def step(self, n: int = 1) -> Dict[str, np.ndarray]:
        """Advance all chains n transitions; returns latest values
        (addr → (n_chains,...) array)."""
        for _ in range(n):
            self._key, k = jax.random.split(self._key)
            keys = jax.random.split(k, self.n_chains)
            self._state, accepted = self._step(self._state, keys)
            self._accepts += int(np.asarray(accepted).sum())
            self._steps += self.n_chains
            snap = {
                a: np.asarray(v) for a, v in self._state.latents.items()
            }
            self.history.append(snap)
            if len(self.history) > self.history_cap:
                self.history.pop(0)
        return self.history[-1]

    @property
    def accept_rate(self) -> float:
        return self._accepts / max(self._steps, 1)

    def chain_values(self, address: str) -> np.ndarray:
        """(n_steps, n_chains) history for one site."""
        return np.stack([h[str(address)] for h in self.history])


class ParticleFilter:
    """1-D bootstrap particle filter on a Gaussian random-walk state-space
    model (reference: pf.rs:1-70): x_t = x_{t-1} + N(0, q); y_t ~ N(x_t, r).

    Each ``observe`` is one jit-compiled predict-update-resample kernel over
    the particle vector."""

    def __init__(self, key, n_particles: int = 512, process_sd: float = 0.3,
                 obs_sd: float = 0.5, init_sd: float = 1.0):
        self.n = n_particles
        self.process_sd = process_sd
        self.obs_sd = obs_sd
        k0, self._key = jax.random.split(key)
        dt = settings.real_dtype()
        self.particles = init_sd * jax.random.normal(k0, (n_particles,), dt)
        self.log_weights = jnp.zeros((n_particles,), dt)

        def _step(particles, log_w, y, k):
            k1, k2 = jax.random.split(k)
            prop = particles + process_sd * jax.random.normal(k1, particles.shape, dt)
            lw = log_w + (
                -0.5 * ((y - prop) / obs_sd) ** 2
                - jnp.log(obs_sd)
                - 0.5 * jnp.log(2 * jnp.pi)
            )
            ess = effective_sample_size(lw)
            idx = systematic_resample(k2, lw)
            resampled = jnp.take(prop, idx)
            do_res = ess < 0.5 * n_particles
            particles_new = jnp.where(do_res, resampled, prop)
            lw_new = jnp.where(do_res, jnp.zeros_like(lw), lw)
            w, _ = normalize_log_weights(lw_new)
            mean = jnp.sum(w * particles_new)
            var = jnp.sum(w * (particles_new - mean) ** 2)
            return particles_new, lw_new, mean, var, ess

        self._jit_step = jax.jit(_step)
        self.estimates: List[Dict[str, float]] = []

    def observe(self, y: float) -> Dict[str, float]:
        self._key, k = jax.random.split(self._key)
        self.particles, self.log_weights, mean, var, ess = self._jit_step(
            self.particles, self.log_weights, jnp.asarray(float(y)), k
        )
        est = {
            "mean": float(np.asarray(mean)),
            "var": float(np.asarray(var)),
            "ess": float(np.asarray(ess)),
        }
        self.estimates.append(est)
        return est


def smc_run(
    key,
    model_fn: Optional[Callable] = None,
    n_particles: int = 512,
    config: SMCConfig = SMCConfig(),
    **kw,
) -> Dict[str, Any]:
    """One-shot SMC returning a JSON-able summary
    (reference: wasm_smc_run, smc.rs:30)."""
    res = adaptive_smc(key, n_particles, model_fn, config, **kw)
    out: Dict[str, Any] = {
        "log_evidence": res.log_evidence,
        "n_stages": res.n_stages,
        "ess": res.ess,
        "posterior_means": {},
        "posterior_vars": {},
    }
    for a in res.particles:
        out["posterior_means"][a] = np.asarray(res.posterior_mean(a)).tolist()
        out["posterior_vars"][a] = np.asarray(res.posterior_var(a)).tolist()
    return out


def log_joint_grid(
    model_fn: Callable,
    x_address: str,
    y_address: str,
    x_range,
    y_range,
    resolution: int = 64,
    *,
    staged: Optional[StagedModel] = None,
    fixed: Optional[Dict[str, Any]] = None,
    model_args: tuple = (),
) -> Dict[str, Any]:
    """2-D log-joint heatmap with two scalar sites swept and the rest pinned
    (reference: log_joint_grid, grid.rs:22). The whole grid evaluates as ONE
    vmapped jit program (resolution² density evaluations in a single kernel —
    the reference loops them one ScoreGivenTrace run at a time)."""
    if staged is None:
        staged = stage(model_fn, *model_args)
    base = dict(staged.sample_prior(jax.random.PRNGKey(0)))
    if fixed:
        base.update({str(a): jnp.asarray(v) for a, v in fixed.items()})

    xs = jnp.linspace(x_range[0], x_range[1], resolution)
    ys = jnp.linspace(y_range[0], y_range[1], resolution)

    @jax.jit
    def grid():
        def at(xv, yv):
            latents = dict(base)
            latents[str(x_address)] = jnp.asarray(xv, settings.real_dtype())
            latents[str(y_address)] = jnp.asarray(yv, settings.real_dtype())
            return staged.log_joint(latents)

        return jax.vmap(lambda yv: jax.vmap(lambda xv: at(xv, yv))(xs))(ys)

    z = grid()
    return {
        "x": np.asarray(xs),
        "y": np.asarray(ys),
        "log_joint": np.asarray(z),  # (resolution_y, resolution_x)
    }
