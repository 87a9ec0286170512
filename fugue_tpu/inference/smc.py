"""Likelihood-tempered adaptive Sequential Monte Carlo.

Capability parity with the reference SMC engine (reference:
src/inference/smc.rs — prior particles weighted by likelihood only, prior
cancels (FG-03) :756-790; adaptive beta ladder by ESS bisection (Jasra)
:588-622; unbiased log-evidence accumulation (FG-58) :505-529;
systematic/stratified/multinomial resampling :255-349; pi_beta-invariant
single-site MH rejuvenation that does NOT touch weights (FG-13) :624-713; no
terminal resample (FG-43) :531-560; zero-rejuvenation shortcut = single
importance reweight :484-493; MAX_STEPS safety net :499).

Array-program re-design (SURVEY.md §3.4): particles are a leading batch axis of
one latents pytree — initialization is a vmapped prior draw, tempering and
reweighting are elementwise ops over the weight vector, the beta ladder is a
bounded ``lax.while_loop`` with a fixed 64-iteration ESS bisection (the
reference already fixes 64, smc.rs:612-619), resampling is cumsum +
searchsorted (ops/resampling.py), and rejuvenation is the vectorized
single-site MH kernel retargeted at pi_beta with CROSS-PARTICLE shared
adaptive scales. The whole run is a single jit-compiled program; when the
particle axis is sharded across a mesh, ESS/evidence reductions become
``psum`` collectives (parallel module).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import settings
from ..core.numerics import log_sum_exp
from ..core.rng import chain_keys
from ..ops.resampling import RESAMPLERS, effective_sample_size
from ..runtime.staging import StagedModel, stage
from .mcmc_utils import AdaptationState, adapt_update
from .mh import MHState, mh_step

MAX_STAGES = 64  # safety net (reference: MAX_STEPS, smc.rs:499)


def _ring_gather(latents_local, ancestors_global, axis_name, n_shards):
    """Fetch particles by GLOBAL ancestor index over a bidirectional
    ``ppermute`` ring — the particle pytree is never all-gathered
    (SURVEY.md §7 hard part 4: cross-shard resampling without gathering all
    particles to one device).

    Each shard's output slot ``j`` needs global particle ``a_j``; only the
    small (N,) weight vector was gathered to compute ``a_j``. Particle
    blocks rotate around the ring in both directions simultaneously
    (``D//2`` steps); each arriving block contributes the slots whose
    ancestor lives in it via a masked local take. Peak memory is O(3·local
    block); traffic is nearest-neighbor, with no (N, ...) buffer ever
    materialized on any device.
    """
    n_local = jax.tree_util.tree_leaves(latents_local)[0].shape[0]
    idx = jax.lax.axis_index(axis_name)
    src_block = ancestors_global // n_local  # block holding each ancestor
    pos = ancestors_global % n_local  # index within that block

    def take_from(out, block, block_src):
        sel = src_block == block_src  # (n_local,) bool

        def upd(o, x):
            v = jnp.take(x, pos, axis=0)
            return jnp.where(sel.reshape(sel.shape + (1,) * (v.ndim - 1)), v, o)

        return jax.tree_util.tree_map(upd, out, block)

    out = jax.tree_util.tree_map(jnp.zeros_like, latents_local)
    out = take_from(out, latents_local, idx)
    if n_shards == 1:
        return out

    fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    bwd = [((i + 1) % n_shards, i) for i in range(n_shards)]

    def body(t, carry):
        out, buf_r, buf_l = carry
        # buf_r rotated forward t times → holds block (idx - t)
        buf_r = jax.lax.ppermute(buf_r, axis_name, fwd)
        out = take_from(out, buf_r, (idx - t) % n_shards)
        # buf_l rotated backward t times → holds block (idx + t); skip the
        # final step for even D (it would duplicate block idx - D/2)
        buf_l = jax.lax.ppermute(buf_l, axis_name, bwd)
        out_l = take_from(out, buf_l, (idx + t) % n_shards)
        out = jax.tree_util.tree_map(
            lambda a, b: jnp.where(t <= (n_shards - 1) // 2, b, a), out, out_l
        )
        return out, buf_r, buf_l

    out, _, _ = jax.lax.fori_loop(
        1, n_shards // 2 + 1, body, (out, latents_local, latents_local)
    )
    return out


@dataclass(frozen=True)
class SMCConfig:
    """Reference: SMCConfig (smc.rs:172-189)."""

    ess_threshold: float = 0.5  # resample/temper when ESS < threshold * N
    rejuvenation_steps: int = 3
    # "mh": single-site MH moves (reference semantics, works for any site
    # types); "hmc": gradient-based moves on the unconstrained flat space —
    # far better particle diversity per step on continuous models
    # (SURVEY.md §7 step 6: "HMC moves instead of single-site MH")
    rejuvenation: str = "mh"
    hmc_leapfrog: int = 8
    resampling: str = "systematic"
    initial_scale: float = 0.5
    target_accept: float = 0.44
    # stop after this many TOTAL ladder stages (cumulative across resumed
    # runs) even if beta < 1 — the checkpointable-long-run knob: the result
    # then has converged=False and its ``state`` can be passed back as
    # ``resume=`` to continue the ladder exactly where it stopped
    # (bitwise identical to an uninterrupted run). None -> run to beta = 1
    # (bounded by the MAX_STAGES safety net).
    max_stages: Optional[int] = None


@dataclass
class SMCResult:
    """Reference: SMCResult (smc.rs:361-373). ``particles`` is a latents
    pytree with a leading particle axis; ``weights`` are normalized."""

    particles: Dict[str, Any]
    log_weights: Any
    weights: Any
    log_evidence: float
    n_stages: int
    ess: float
    # inverse-temperature reached (1.0 = the full posterior); < 1 when the
    # run stopped at config.max_stages
    beta: float = 1.0
    converged: bool = True
    # full inter-stage state (particles, log-weights, log-liks, beta, logZ,
    # adaptation, loop key, stage counter) — pass the result as ``resume=``
    # to continue the ladder (the reference's all-state-in-a-value
    # discipline, hmc.rs:604-642)
    state: Any = None

    def posterior_mean(self, address: str):
        vals = jnp.asarray(self.particles[str(address)], settings.real_dtype())
        w = self.weights.reshape(self.weights.shape + (1,) * (vals.ndim - 1))
        return jnp.sum(w * vals, axis=0)

    def posterior_var(self, address: str):
        vals = jnp.asarray(self.particles[str(address)], settings.real_dtype())
        w = self.weights.reshape(self.weights.shape + (1,) * (vals.ndim - 1))
        m = jnp.sum(w * vals, axis=0)
        return jnp.sum(w * (vals - m) ** 2, axis=0)


def _next_beta(beta, log_w, ll, target_ess):
    """ESS search for the next temperature (reference: smc.rs:588-622).

    Finds beta' in (beta, 1] such that the ESS of log_w + (beta'-beta)*ll
    hits ``target_ess``; returns 1.0 when the full jump keeps ESS above
    target.

    Array-program form: the reference's 64-iteration bisection is 64
    SEQUENTIAL (N,)-reductions — ~400 dependent tiny ops of pure latency on
    a device that would rather do one big batched one. ESS(beta') is
    monotone non-increasing in beta', so a two-level VECTORIZED grid search
    — evaluate all 64 coarse candidates as one (64, N) batch, pick the
    bracket, refine with 64 more inside it — needs just 2 batched
    reductions for a bracket of width (1-beta)/64^2 ~= 2.4e-4, far tighter
    than the ESS heuristic warrants (the ladder spacing only shapes
    efficiency; any schedule keeps the estimator unbiased, FG-58)."""
    G = 64
    dt = log_w.dtype

    def ess_batch(bs):
        # (G,) candidate betas -> (G,) ESS values, one batched reduction
        lw = log_w[None, :] + (bs[:, None] - beta) * ll[None, :]
        m = jnp.max(lw, axis=1, keepdims=True)
        w = jnp.exp(lw - m)
        s1 = jnp.sum(w, axis=1)
        s2 = jnp.sum(w * w, axis=1)
        return s1 * s1 / jnp.maximum(s2, 1e-38)

    full = effective_sample_size(log_w + (1.0 - beta) * ll)

    grid1 = beta + (1.0 - beta) * jnp.arange(1, G + 1, dtype=dt) / G
    ok1 = ess_batch(grid1) >= target_ess
    # largest candidate still meeting the target (grid1[0] as fallback)
    i1 = jnp.where(jnp.any(ok1), jnp.max(jnp.where(ok1, jnp.arange(G), -1)), 0)
    lo1 = jnp.where(jnp.any(ok1), grid1[i1], beta)
    step1 = (1.0 - beta) / G

    grid2 = lo1 + step1 * jnp.arange(1, G + 1, dtype=dt) / G
    ok2 = ess_batch(grid2) >= target_ess
    i2 = jnp.where(jnp.any(ok2), jnp.max(jnp.where(ok2, jnp.arange(G), -1)), 0)
    out = jnp.where(jnp.any(ok2), grid2[i2], lo1)

    out = jnp.where(full >= target_ess, 1.0, out)
    # guarantee ladder progress so the while_loop cannot stall short of 1
    return jnp.minimum(jnp.maximum(out, beta + 1e-4), 1.0)


def adaptive_smc(
    key,
    n_particles: int,
    model_fn: Optional[Callable] = None,
    config: SMCConfig = SMCConfig(),
    *,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    mesh=None,
    resume: Optional[SMCResult] = None,
) -> SMCResult:
    """Likelihood-tempered adaptive SMC (reference driver: smc.rs:455-580).

    ``resume``: a previous ``SMCResult`` whose ladder stopped short of
    beta = 1 (``config.max_stages``) — the run continues from its full
    inter-stage state (particles, weights, beta, logZ, adaptation, loop
    key) and is BITWISE identical to an uninterrupted run, because the
    while-loop carry IS the checkpoint. ``log_evidence`` keeps
    accumulating across resumes.

    ``mesh``: optional device mesh; the run then executes inside
    ``shard_map`` with the particle axis sharded over the mesh's chain axis.
    Per stage only the (N,) log-weight/log-likelihood VECTORS are gathered
    (so the β bisection and systematic ancestor draw are bit-identical to
    the single-device run); the particle pytree itself moves via a
    nearest-neighbor ``ppermute`` ring and is never all-gathered
    (``_ring_gather``; SURVEY.md §7 hard part 4)."""
    if staged is None:
        staged = stage(model_fn, *model_args)
    if config.rejuvenation == "hmc" and staged.discrete_sites:
        raise ValueError(
            "HMC rejuvenation requires continuous latents only; use "
            "rejuvenation='mh' for models with discrete sites "
            f"(discrete: {[s.address for s in staged.discrete_sites]})"
        )
    N = n_particles
    dt = settings.real_dtype()
    resampler = RESAMPLERS[config.resampling]

    if mesh is not None:
        from ..parallel.mesh import CHAIN_AXIS as _CA

        axis_name = _CA if _CA in mesh.axis_names else mesh.axis_names[0]
        n_shards = int(mesh.shape[axis_name])
        if N % n_shards:
            raise ValueError(
                f"n_particles={N} not divisible by mesh axis size {n_shards}"
            )
    else:
        axis_name, n_shards = None, 1
    n_local = N // n_shards

    def gathered(x):
        """(n_local,) shard vector → full (N,) vector (identity unsharded)."""
        if axis_name is None:
            return x
        return jax.lax.all_gather(x, axis_name, tiled=True)

    def pmean(x):
        return jax.lax.pmean(x, axis_name) if axis_name is not None else x

    def loglik(latents):
        parts = staged.log_density_parts(latents)
        return parts.log_likelihood + parts.log_factors

    def tempered(latents, beta):
        parts = staged.log_density_parts(latents)
        return parts.log_prior + beta * (parts.log_likelihood + parts.log_factors)

    k_init, k_loop = jax.random.split(jax.random.fold_in(key, 3))

    def init_state(k_init, k_loop):
        # Stage 0: prior particles, weights = 1/N; the prior cancels in the
        # importance weight so only (tempered) likelihood enters (FG-03).
        if axis_name is not None:
            # distinct per-shard prior streams, deterministic per layout
            k_init = jax.random.fold_in(k_init, jax.lax.axis_index(axis_name))
        latents0 = jax.vmap(staged.sample_prior)(chain_keys(k_init, n_local))
        ll0 = jax.vmap(loglik)(latents0)
        log_w0 = jnp.zeros((n_local,), dt)
        adapt0 = AdaptationState.init(len(staged.sites), config.initial_scale)
        return (
            latents0,
            log_w0,
            ll0,
            jnp.zeros((), dt),
            jnp.zeros((), dt),
            adapt0,
            k_loop,
            jnp.zeros((), jnp.int32),
        )

    def continue_drive(init):
        # ladder loop from an arbitrary inter-stage state — fresh runs pass
        # init_state(...), resumed runs pass the previous result's carry, so
        # split runs are BITWISE identical to uninterrupted ones (the loop
        # key and stage counter live in the carry)
        latents0, log_w0, ll0 = init[0], init[1], init[2]
        target_ess = config.ess_threshold * N
        stage_cap = (MAX_STAGES if config.max_stages is None
                     else min(MAX_STAGES, config.max_stages))

        def cond(carry):
            latents, log_w, ll, beta, log_z, adapt_st, k, stage_i = carry
            return (beta < 1.0) & (stage_i < stage_cap)

        def body(carry):
            latents, log_w, ll, beta, log_z, adapt_st, k, stage_i = carry
            k, k_res, k_rej = jax.random.split(k, 3)
            if axis_name is not None:
                k_rej = jax.random.fold_in(
                    k_rej, jax.lax.axis_index(axis_name)
                )

            # the (N,) weight/log-lik VECTORS are gathered so bisection,
            # evidence and ancestor draws replicate the single-device math
            # exactly; the particle pytree itself is never gathered
            lwg, llg = gathered(log_w), gathered(ll)
            beta_new = _next_beta(beta, lwg, llg, target_ess)
            delta = beta_new - beta

            # unbiased log-evidence increment under current normalized
            # weights (FG-58): log sum_i wbar_i exp(delta*ll_i)
            log_wbar = lwg - log_sum_exp(lwg)
            log_z = log_z + log_sum_exp(log_wbar + delta * llg)
            log_w = log_w + delta * ll

            def resample_and_rejuvenate(args):
                latents, log_w, ll, adapt_st = args
                idx = resampler(k_res, lwg + delta * llg)
                if axis_name is not None:
                    # my output slots' global ancestors → ppermute ring fetch
                    start = jax.lax.axis_index(axis_name) * n_local
                    mine = jax.lax.dynamic_slice_in_dim(idx, start, n_local)
                    latents = _ring_gather(latents, mine, axis_name, n_shards)
                else:
                    latents = jax.tree_util.tree_map(
                        lambda x: jnp.take(x, idx, axis=0), latents
                    )
                log_w = jnp.zeros_like(log_w)

                # pi_beta-invariant rejuvenation; weights untouched (FG-13)
                def rejuv_body_mh(m, inner):
                    latents, adapt_st = inner
                    lj = jax.vmap(lambda l: tempered(l, beta_new))(latents)
                    states = MHState(latents=latents, log_joint=lj, adapt=adapt_st)

                    def one(particle_state, kk):
                        # shared (particle-broadcast) adaptation state
                        return mh_step(
                            staged,
                            particle_state,
                            kk,
                            False,  # adaptation handled collectively below
                            config.target_accept,
                            log_density_fn=lambda l: tempered(l, beta_new),
                        )

                    kks = jax.random.split(
                        jax.random.fold_in(k_rej, m), n_local
                    )
                    new_states, accepted = jax.vmap(
                        one, in_axes=(MHState(latents=0, log_joint=0, adapt=None), 0)
                    )(states, kks)
                    # cross-particle (and cross-shard) shared scale adaptation
                    acc_mean = pmean(jnp.mean(accepted.astype(dt)))
                    ones = jnp.ones((len(staged.sites),), dt) / len(staged.sites)
                    adapt_new = adapt_update(
                        adapt_st, ones, acc_mean, target=config.target_accept
                    )
                    return (new_states.latents, adapt_new)

                def rejuv_body_hmc(m, inner):
                    """Gradient-based pi_beta-invariant moves on the flat
                    unconstrained space; step size adapted from the
                    cross-particle acceptance between inner steps. The
                    AdaptationState's slot 0 carries log(eps)."""
                    from .hmc import hmc_transition

                    latents, adapt_st = inner

                    def u_beta(z):
                        parts, logdet = (
                            staged.log_density_parts_unconstrained(z)
                        )
                        return -(
                            parts.log_prior + logdet
                            + beta_new * (parts.log_likelihood + parts.log_factors)
                        )

                    zs = jax.vmap(staged.unconstrain)(latents)
                    eps = jnp.exp(adapt_st.log_scale[0])
                    kks = jax.random.split(
                        jax.random.fold_in(k_rej, m), n_local
                    )
                    z_new, info = jax.vmap(
                        lambda z, kk: hmc_transition(
                            u_beta, z, kk, eps, config.hmc_leapfrog,
                            jnp.ones((staged.dim,), dt),
                        )
                    )(zs, kks)
                    acc_mean = pmean(jnp.mean(info.accept_prob))
                    new_log_eps = adapt_st.log_scale.at[0].add(
                        0.5 * (acc_mean - 0.8)
                    )
                    adapt_new = AdaptationState(
                        log_scale=new_log_eps, t=adapt_st.t
                    )
                    new_latents = jax.vmap(
                        lambda z: staged.constrain(z)[0]
                    )(z_new)
                    # carry discrete sites through unchanged (hmc mode
                    # requires none; guarded at entry)
                    return (new_latents, adapt_new)

                rejuv_body = (
                    rejuv_body_hmc if config.rejuvenation == "hmc"
                    else rejuv_body_mh
                )
                if config.rejuvenation_steps > 0:
                    latents, adapt_st = jax.lax.fori_loop(
                        0, config.rejuvenation_steps, rejuv_body,
                        (latents, adapt_st),
                    )
                ll = jax.vmap(loglik)(latents)
                return latents, log_w, ll, adapt_st

            # no terminal resample (FG-43): only resample when beta_new < 1
            latents, log_w, ll, adapt_st = jax.lax.cond(
                beta_new < 1.0,
                resample_and_rejuvenate,
                lambda args: args,
                (latents, log_w, ll, adapt_st),
            )
            return (latents, log_w, ll, beta_new, log_z, adapt_st, k, stage_i + 1)

        if config.rejuvenation_steps == 0 and config.ess_threshold <= 0.0:
            # zero-rejuvenation shortcut: single importance reweight by the
            # full likelihood (reference: smc.rs:484-493)
            log_w = ll0
            log_z = log_sum_exp(gathered(log_w)) - jnp.log(jnp.asarray(N, dt))
            one = jnp.ones((), jnp.int32)
            carry = (latents0, log_w, ll0, jnp.ones((), dt), log_z,
                     init[5], init[6], one)
            return _finish(carry)

        carry = jax.lax.while_loop(cond, body, init)
        return _finish(carry)

    def _finish(carry):
        latents, log_w, _ll, beta, log_z, _ad, _k, stage_i = carry
        # normalized weights + scalar stats computed INSIDE the compiled
        # drive and the scalars PACKED into one array: each separate host
        # conversion is one device round trip
        lwg = gathered(log_w)
        lse = log_sum_exp(lwg)
        weights = jnp.exp(log_w - lse)
        packed = jnp.stack([
            log_z, stage_i.astype(dt), effective_sample_size(lwg), beta,
        ])
        return carry, weights, packed

    def fresh_drive(k_init, k_loop):
        return continue_drive(init_state(k_init, k_loop))

    def _specs():
        from jax.sharding import PartitionSpec as _P

        latent_specs = {
            s.address: _P(axis_name, *([None] * len(s.shape)))
            for s in staged.sites
        }
        # carry = (latents, log_w, ll, beta, log_z, adapt, key, stage_i);
        # the adaptation pytree / key / scalars are replicated (P() prefix)
        carry_specs = (latent_specs, _P(axis_name), _P(axis_name),
                       _P(), _P(), _P(), _P(), _P())
        return carry_specs

    def build_drive():
        if mesh is None:
            return jax.jit(fresh_drive)
        from jax.sharding import PartitionSpec as _P
        from ..parallel.sharded import _shard_map

        carry_specs = _specs()
        mapped = _shard_map(
            fresh_drive,
            mesh,
            in_specs=(_P(), _P()),
            out_specs=(carry_specs, _P(axis_name), _P()),
        )
        return jax.jit(mapped)

    def build_resume_drive():
        if mesh is None:
            return jax.jit(continue_drive)
        from jax.sharding import PartitionSpec as _P
        from ..parallel.sharded import _shard_map

        carry_specs = _specs()
        mapped = _shard_map(
            continue_drive,
            mesh,
            in_specs=(carry_specs,),
            out_specs=(carry_specs, _P(axis_name), _P()),
        )
        return jax.jit(mapped)

    if resume is not None:
        if resume.state is None:
            raise ValueError(
                "resume= needs an SMCResult carrying its state (older "
                "checkpoints saved without state cannot be resumed). "
                "Zero-rejuvenation shortcut results DO carry state; "
                "resuming one re-runs the idempotent one-shot reweight."
            )
        # state leaves are GLOBAL arrays (the sharded path returns them
        # with their shardings; shard_map re-splits them on entry)
        n_res = jax.tree_util.tree_leaves(resume.state)[0].shape[0]
        if n_res != N:
            raise ValueError(
                f"resume state holds {n_res} particles; this run is "
                f"configured for {N}"
            )
        jit_drive = staged.cached_kernel(
            ("smc_resume", N, config, None if mesh is None else id(mesh)),
            build_resume_drive,
        )
        carry, weights, packed = jit_drive(resume.state)
    else:
        jit_drive = staged.cached_kernel(
            ("smc_drive", N, config, None if mesh is None else id(mesh)),
            build_drive,
        )
        carry, weights, packed = jit_drive(k_init, k_loop)
    latents, log_w = carry[0], carry[1]
    packed = np.asarray(packed)  # ONE host transfer for all scalar stats
    return SMCResult(
        particles=latents,
        log_weights=log_w,
        weights=weights,
        log_evidence=float(packed[0]),
        n_stages=int(packed[1]),
        ess=float(packed[2]),
        beta=float(packed[3]),
        converged=bool(packed[3] >= 1.0),
        state=carry,
    )


def importance_reweight(key, n_particles: int, model_fn=None, *, staged=None,
                        model_args: tuple = ()):
    """Plain prior-proposal importance sampling (the zero-rejuvenation
    shortcut as a first-class entry point, smc.rs:484-493)."""
    cfg = SMCConfig(rejuvenation_steps=0, ess_threshold=0.0)
    return adaptive_smc(
        key, n_particles, model_fn, cfg, staged=staged, model_args=model_args
    )
