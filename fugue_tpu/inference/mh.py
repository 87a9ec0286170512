"""Adaptive single-site Metropolis-Hastings, vectorized over chains.

Capability parity with the reference MH engine (reference:
src/inference/mh.rs — support-detected proposal kinds :146-161, per-type
proposals (GaussianWalk:181, LogSpaceWalk with exact Hastings:199-224,
ReflectionWalk:230, Flip:261, DiscreteWalk reflected about -1/2 FG-41
:283-295), single-model-run-per-transition handler :324-617, cached site list
+ cached current score FG-11/12 :959-1011, frozen scales after warmup FG-57,
driver ``adaptive_mcmc_chain`` :921-1011).

Array-program design: one transition is ONE jit-compiled array program evaluated
for ALL chains at once:

1. draw a target site index per chain;
2. compute candidate values for every site elementwise (cheap VPU work), then
   masked-merge so only the drawn site changes — this keeps the "exactly one
   log-density evaluation per transition" contract (the staged analog of the
   reference's one-model-run-per-transition, mh.rs:60-69) while remaining
   branch-free for XLA;
3. accept/reject with the per-site Hastings correction selected by the same
   mask;
4. update per-(chain, site) diminishing-adaptation scales (frozen after
   warmup).

The whole chain is a ``lax.scan`` over transitions of a ``vmap``-over-chains
step — thousands of chains cost one kernel launch per sweep.

Structure-varying (open-universe) models cannot be staged into static XLA;
for those, ``adaptive_mcmc_chain_dynamic`` runs the reference's trace-based
algorithm (RJMCMC birth/death via the Reconciling handler) as a host loop —
capability parity at reference-like speed (SURVEY.md §7 hard part 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import settings
from ..core.distributions import Support
from ..core.rng import chain_keys
from ..runtime.staging import StagedModel, stage
from .mcmc_utils import AdaptationState, adapt_update

TARGET_ACCEPT = 0.44  # classic single-site target (Roberts-Rosenthal)


# ---------------------------------------------------------------------------
# Per-support proposal kernels (reference: mh.rs:146-295)
# Each returns (proposed_value, hastings_correction = log q(x'→x) - log q(x→x')).
# ---------------------------------------------------------------------------


def _propose_real(key, x, scale):
    """Gaussian random walk (mh.rs:181). Symmetric → correction 0."""
    eps = jax.random.normal(key, jnp.shape(x), x.dtype)
    return x + scale * eps, jnp.zeros((), x.dtype)


def _propose_positive(key, x, scale):
    """Log-space walk with exact Hastings = ln x' - ln x (mh.rs:199-224)."""
    eps = jax.random.normal(key, jnp.shape(x), x.dtype)
    x_new = x * jnp.exp(scale * eps)
    corr = jnp.sum(jnp.log(x_new) - jnp.log(x))
    return x_new, corr


def _reflect_into(y, lo, hi):
    """Fold y into [lo, hi] by reflection."""
    width = hi - lo
    t = jnp.mod(y - lo, 2 * width)
    return lo + jnp.minimum(t, 2 * width - t)


def _propose_interval(key, x, scale, lo, hi):
    """Reflection walk inside (lo, hi) (mh.rs:230). Symmetric."""
    eps = jax.random.normal(key, jnp.shape(x), x.dtype)
    x_new = _reflect_into(x + scale * (hi - lo) * eps, lo, hi)
    return x_new, jnp.zeros((), x.dtype)


def _propose_flip(key, x):
    """Deterministic flip (mh.rs:261). Symmetric."""
    del key
    return jnp.logical_not(x), jnp.zeros((), settings.real_dtype())


def _propose_discrete_walk(key, x, scale, lo, hi):
    """Integer random walk reflected about lo - 1/2 (and hi + 1/2 when
    bounded) — symmetric by reflection (mh.rs:283-295, FG-41)."""
    k1, k2 = jax.random.split(key)
    width = jnp.maximum(jnp.round(scale), 1.0).astype(x.dtype)
    mag = jax.random.randint(k1, jnp.shape(x), 1, jnp.int32(1) + width.astype(jnp.int32))
    sign = jnp.where(jax.random.bernoulli(k2, 0.5, jnp.shape(x)), 1, -1)
    y = x + (sign * mag).astype(x.dtype)
    if lo is not None:
        # reflect about lo - 1/2: y < lo → 2*lo - 1 - y
        y = jnp.where(y < lo, 2 * lo - 1 - y, y)
    if hi is not None:
        y = jnp.where(y > hi, 2 * hi + 1 - y, y)
    if lo is not None:
        y = jnp.where(y < lo, lo, y)  # extreme overshoot guard
    if hi is not None:
        y = jnp.where(y > hi, hi, y)
    return y, jnp.zeros((), settings.real_dtype())


def _propose_categorical(key, x, k: int):
    """Uniform resample over the k categories (symmetric)."""
    y = jax.random.randint(key, jnp.shape(x), 0, k).astype(x.dtype)
    return y, jnp.zeros((), settings.real_dtype())


def make_site_proposal(support: Support) -> Callable:
    """Support-detected proposal kind (reference: mh.rs:146-161, FG-42)."""
    kind = support.kind
    if kind == "real":
        return lambda key, x, scale: _propose_real(key, x, scale)
    if kind == "positive":
        return lambda key, x, scale: _propose_positive(key, x, scale)
    if kind == "unit":
        return lambda key, x, scale: _propose_interval(key, x, scale, 0.0, 1.0)
    if kind == "interval" and support.low is not None:
        lo, hi = support.low, support.high
        return lambda key, x, scale: _propose_interval(key, x, scale, lo, hi)
    if kind == "interval":
        return lambda key, x, scale: _propose_real(key, x, scale)
    if kind == "boolean":
        return lambda key, x, scale: _propose_flip(key, x)
    if kind == "categorical":
        k = support.size
        return lambda key, x, scale: _propose_categorical(key, x, k)
    if kind in ("count", "int_range"):
        lo = support.low if support.low is not None else (0 if kind == "count" else None)
        hi = support.high
        return lambda key, x, scale: _propose_discrete_walk(key, x, scale, lo, hi)
    return lambda key, x, scale: _propose_real(key, x, scale)


# ---------------------------------------------------------------------------
# The vectorized kernel
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclass
class MHState:
    """Per-chain sampler state (pytree; add a leading chain axis via vmap)."""

    latents: Dict[str, Any]
    log_joint: Any
    adapt: AdaptationState


def init_mh_state(staged: StagedModel, key, initial_scale=0.5) -> MHState:
    """``initial_scale``: float, or an ``{address: scale}`` dict of per-site
    overrides (the reference's ``SiteProposal`` override maps,
    mh.rs:938-944) — unlisted sites use 0.5."""
    latents = staged.sample_prior(key)
    lj = staged.log_joint(latents)
    if isinstance(initial_scale, dict):
        scales = jnp.log(jnp.asarray(
            [float(initial_scale.get(s.address, 0.5)) for s in staged.sites],
            settings.real_dtype(),
        ))
        adapt = AdaptationState(
            log_scale=scales, t=jnp.zeros_like(scales)
        )
    else:
        adapt = AdaptationState.init(len(staged.sites), initial_scale)
    return MHState(latents=latents, log_joint=lj, adapt=adapt)


def _packed_meta(staged: StagedModel):
    """Static per-coordinate proposal metadata over the continuous flat
    layout: owning-site index, kind masks, interval bounds. Computed once
    per staged model (numpy, trace-time constants)."""
    meta = getattr(staged, "_mh_packed_meta", None)
    if meta is not None:
        return meta
    dim = staged.constrained_dim
    site_of = np.zeros(dim, np.int32)
    is_pos = np.zeros(dim, bool)
    is_int = np.zeros(dim, bool)
    lo = np.zeros(dim, np.float64)
    hi = np.ones(dim, np.float64)
    for s in staged.continuous_sites:
        a, b = staged._offsets[s.address]
        site_of[a:b] = staged.site_index[s.address]
        kind = s.support.kind
        if kind == "positive":
            is_pos[a:b] = True
        elif kind == "unit":
            is_int[a:b] = True
        elif (
            kind == "interval"
            and s.support.low is not None
            and s.support.high is not None
        ):
            is_int[a:b] = True
            shape = s.shape if s.shape else ()
            lo[a:b] = np.ravel(np.broadcast_to(np.asarray(s.support.low, np.float64), shape))
            hi[a:b] = np.ravel(np.broadcast_to(np.asarray(s.support.high, np.float64), shape))
    meta = (site_of, is_pos, is_int, lo, hi)
    staged._mh_packed_meta = meta
    return meta


def mh_step(
    staged: StagedModel,
    state: MHState,
    key,
    adapt: bool,
    target_accept: float = TARGET_ACCEPT,
    log_density_fn=None,
) -> MHState:
    """One single-site MH transition (one log-density evaluation).

    Per-chain function — ``vmap`` it over a batch of states/keys.
    ``log_density_fn`` overrides the target (e.g. SMC's tempered
    pi_beta = prior + beta * likelihood); defaults to the full joint.

    Proposals for ALL continuous sites are packed into one flat-vector op
    (one normal draw + fused elementwise candidate/selection math, constant
    op count in #sites); only discrete sites loop. This is the array-program analog of
    the reference's per-site proposal dispatch (mh.rs:146-295) — the drawn
    site still changes alone, so the single-site kernel and its Hastings
    terms are unchanged.
    """
    target = log_density_fn if log_density_fn is not None else staged.log_joint
    sites = staged.sites
    n_sites = len(sites)
    d_sites = staged.discrete_sites
    k_site, k_acc, k_cont, *k_disc = jax.random.split(key, 3 + len(d_sites))
    idx = jax.random.randint(k_site, (), 0, n_sites)
    scales = state.adapt.scale()

    proposed: Dict[str, Any] = dict(state.latents)
    hastings = jnp.zeros((), settings.real_dtype())

    if staged.constrained_dim > 0:
        site_of, is_pos, is_int, lo, hi = _packed_meta(staged)
        z = staged.flatten_constrained(state.latents)
        dt = z.dtype
        s_coord = scales[site_of]  # static-index gather: per-coordinate scale
        eps = jax.random.normal(k_cont, (staged.constrained_dim,), dt)
        width = jnp.asarray(np.where(is_int, hi - lo, 1.0), dt)
        cand = z + s_coord * width * eps  # Gaussian walk (mh.rs:181)
        # log-space walk for positive supports (mh.rs:199-224)
        z_safe = jnp.where(is_pos, z, jnp.ones((), dt))
        cand_pos = z_safe * jnp.exp(s_coord * eps)
        # reflection walk inside intervals (mh.rs:230)
        cand_ref = _reflect_into(cand, jnp.asarray(lo, dt), jnp.asarray(hi, dt))
        cand = jnp.where(is_pos, cand_pos, jnp.where(is_int, cand_ref, cand))
        sel = jnp.asarray(site_of) == idx
        z_new = jnp.where(sel, cand, z)
        # exact Hastings for the log-space walk: ln x' - ln x (FG-41 kin)
        corr = jnp.where(
            jnp.logical_and(sel, is_pos),
            jnp.log(jnp.where(is_pos, cand_pos, jnp.ones((), dt))) - jnp.log(z_safe),
            jnp.zeros((), dt),
        )
        hastings = hastings + jnp.sum(corr)
        proposed.update(staged.unflatten_constrained(z_new))

    for j_local, s in enumerate(d_sites):
        j = staged.site_index[s.address]
        cur = state.latents[s.address]
        prop_fn = make_site_proposal(s.support)
        cand, corr = prop_fn(k_disc[j_local], cur, scales[j])
        sel = idx == j
        proposed[s.address] = jnp.where(sel, cand, cur)
        hastings = hastings + jnp.where(sel, jnp.sum(corr), 0.0)

    new_lj = target(proposed)
    log_alpha = new_lj - state.log_joint + hastings
    log_u = jnp.log(jax.random.uniform(k_acc, (), new_lj.dtype, 1e-38, 1.0))
    accept = log_u < log_alpha

    latents = {
        a: jnp.where(accept, proposed[a], state.latents[a])
        for a in state.latents
    }
    log_joint = jnp.where(accept, new_lj, state.log_joint)

    one_hot = jax.nn.one_hot(idx, n_sites, dtype=scales.dtype)
    new_adapt = adapt_update(
        state.adapt,
        one_hot,
        accept.astype(scales.dtype),
        target=target_accept,
        frozen=jnp.logical_not(adapt),
    )
    return MHState(latents=latents, log_joint=log_joint, adapt=new_adapt), accept


@dataclass
class MHResult:
    """Posterior samples + trajectory metadata."""

    samples: Dict[str, Any]  # addr -> (n_chains, n_samples, *site_shape)
    log_joint: Any  # (n_chains, n_samples)
    accept_rate: Any  # (n_chains,)
    final_state: MHState


def adaptive_mcmc_chain(
    key,
    model_fn: Optional[Callable] = None,
    n_samples: int = 1000,
    n_warmup: int = 0,
    *,
    n_chains: int = 1,
    model_args: tuple = (),
    initial_scale: float = 0.5,
    target_accept: float = TARGET_ACCEPT,
    staged: Optional[StagedModel] = None,
    mesh=None,
) -> MHResult:
    """Adaptive single-site random-scan MH (reference driver: mh.rs:921-1011),
    vectorized over ``n_chains`` chains.

    Warmup transitions adapt per-site proposal scales; post-warmup the kernel
    is frozen (FG-57). Model-evaluation contract preserved per chain:
    exactly ``1 + n_warmup + n_samples`` log-density evaluations
    (reference efficiency test: mh.rs:1186-1202).

    ``mesh``: optional device mesh — the chain axis is annotated with a
    sharding constraint and XLA distributes the fully chain-parallel kernel
    (MH adaptation is per-chain, so no collectives are needed; this is pure
    DP over the mesh).
    """
    if staged is None:
        staged = stage(model_fn, *model_args)

    def build_drive():
        step_adapt = jax.vmap(
            lambda st, k: mh_step(staged, st, k, True, target_accept)
        )
        step_frozen = jax.vmap(
            lambda st, k: mh_step(staged, st, k, False, target_accept)
        )

        def warm_body(state, k):
            keys = jax.random.split(k, n_chains)
            new, _ = step_adapt(state, keys)
            return new, None

        def sample_body(state, k):
            keys = jax.random.split(k, n_chains)
            new, accepted = step_frozen(state, keys)
            return new, (new.latents, new.log_joint, accepted)

        def shard_chains(tree):
            if mesh is None:
                return tree
            from jax.sharding import NamedSharding, PartitionSpec as _P
            from ..parallel.mesh import CHAIN_AXIS as _CA

            def put(x):
                spec = _P(_CA, *([None] * (jnp.ndim(x) - 1)))
                return jax.lax.with_sharding_constraint(
                    x, NamedSharding(mesh, spec)
                )

            return jax.tree_util.tree_map(put, tree)

        def drive(k_all):
            init_keys = chain_keys(jax.random.fold_in(k_all, 0), n_chains)
            rk = jax.random.fold_in(k_all, 1)
            states = shard_chains(jax.vmap(
                lambda k: init_mh_state(staged, k, initial_scale)
            )(init_keys))
            if n_warmup > 0:
                warm_keys = jax.random.split(jax.random.fold_in(rk, 0), n_warmup)
                states, _ = jax.lax.scan(warm_body, states, warm_keys)
            sample_keys = jax.random.split(jax.random.fold_in(rk, 1), n_samples)
            final, (lat, lj, acc) = jax.lax.scan(sample_body, states, sample_keys)
            return final, lat, lj, acc

        return jax.jit(drive)

    scale_key = (
        tuple(sorted(initial_scale.items()))
        if isinstance(initial_scale, dict)
        else initial_scale
    )
    drive = staged.cached_kernel(
        ("mh_drive", n_chains, n_samples, n_warmup, scale_key, target_accept,
         None if mesh is None else id(mesh)),
        build_drive,
    )
    final, lat, lj, acc = drive(key)
    # (n_samples, n_chains, ...) -> (n_chains, n_samples, ...)
    samples = {a: jnp.moveaxis(v, 0, 1) for a, v in lat.items()}
    return MHResult(
        samples=samples,
        log_joint=jnp.moveaxis(lj, 0, 1),
        accept_rate=jnp.mean(acc.astype(settings.real_dtype()), axis=0),
        final_state=final,
    )
