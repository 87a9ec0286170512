"""Sharded inference drivers: chains/particles across a device mesh.

Two complementary SPMD strategies, both idiomatic JAX:

1. **shard_map + explicit collectives** (HMC/NUTS): the chain batch is a
   named mesh axis; warmup adaptation — acceptance pmean, initial-epsilon
   consensus, Welford mass merge — runs as mesh collectives so EVERY device
   adapts the same kernel (``make_hmc_drive(chain_axis=...)``). This is the
   cross-chain adaptation structure SURVEY.md §2.3 calls for; the reference
   has nothing to port (single-threaded Rust).

2. **jit + sharding constraints** (SMC): particle arrays carry a
   ``with_sharding_constraint`` on the particle axis and XLA auto-inserts
   psum/all-gather for the ESS bisection, log-evidence reductions, and
   resampling gathers (the scaling-book recipe: annotate, let XLA place
   collectives).

Both paths compile and run identically on a virtual CPU mesh
(``--xla_force_host_platform_device_count``) and real GPUs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import settings
from ..runtime.staging import StagedModel, stage
from .distributed import flat_axis_index
from .mesh import CHAIN_AXIS, make_chain_mesh


def _shard_map(f, mesh, in_specs, out_specs):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                         check_vma=False)


def _sharded_discrete_key(discrete):
    # Content-keyed (hmc.py's _discrete_cache_key): discrete values are
    # baked into the shard-mapped drive closure, and an id()-based key can
    # be recycled after gc, silently reusing stale conditioning (ADVICE r3).
    from ..inference.hmc import _discrete_cache_key

    return _discrete_cache_key(discrete)


def _resolve_chain_axes(mesh: Mesh, chain_axes) -> tuple:
    """Default chain axes: the named CHAIN_AXIS when present, else EVERY
    mesh axis (the multi-host layout: chains sharded over hosts x local devices)."""
    if chain_axes is None:
        if CHAIN_AXIS in mesh.axis_names:
            chain_axes = (CHAIN_AXIS,)
        else:
            chain_axes = tuple(mesh.axis_names)
    return tuple(chain_axes)


def _chain_spec_element(chain_axes: tuple):
    """PartitionSpec element for the chain dim: a bare name for one axis, a
    tuple for a multi-axis (hosts x local devices) split."""
    return chain_axes[0] if len(chain_axes) == 1 else tuple(chain_axes)


def sharded_hmc_chain(
    key,
    model_fn: Optional[Callable] = None,
    n_samples: int = 1000,
    n_warmup: int = 1000,
    config=None,
    *,
    n_chains: int = 8,
    mesh: Optional[Mesh] = None,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    discrete: Optional[Dict[str, Any]] = None,
    chain_axes=None,
):
    """HMC with the chain batch sharded across ``mesh``'s chain axes.

    ``n_chains`` is the GLOBAL chain count (must divide evenly by the product
    of the chain-axis sizes). ``chain_axes`` selects which mesh axes split
    the batch — default: the ``CHAIN_AXIS`` if the mesh has one, otherwise
    ALL axes (the hosts x devices layout from ``make_pod_chain_mesh``, where
    adaptation collectives reduce over hosts AND local devices). Returns the
    same ``HMCResult`` as the single-chip driver with global (n_chains, ...)
    arrays.
    """
    from ..inference.hmc import HMCConfig, HMCResult, make_hmc_drive

    if config is None:
        config = HMCConfig()
    if staged is None:
        staged = stage(model_fn, *model_args)
    if mesh is None:
        mesh = make_chain_mesh()
    chain_axes = _resolve_chain_axes(mesh, chain_axes)
    ax_el = _chain_spec_element(chain_axes)
    n_dev = int(np.prod([mesh.shape[a] for a in chain_axes]))
    if n_chains % n_dev:
        raise ValueError(f"n_chains={n_chains} not divisible by mesh size {n_dev}")
    per_shard = n_chains // n_dev
    dt = settings.real_dtype()

    from ..inference.hmc import initial_positions

    k_init, k_eps, k_run = jax.random.split(jax.random.fold_in(key, 7), 3)
    q0 = initial_positions(staged, k_init, n_chains, config.init)
    q0 = jax.device_put(q0, NamedSharding(mesh, P(ax_el, None)))

    drive = make_hmc_drive(
        staged, config, per_shard, n_samples, n_warmup,
        discrete=discrete, chain_axis=ax_el,
    )
    # large stage() data arguments enter the shard-mapped program as traced
    # inputs, replicated across shards (StagedModel.data_leaves — keeps
    # giant design matrices out of the compiled program on meshes too)
    data = staged.data_leaves()

    def shard_fn(q0_local, k_eps, k_run, *dl):
        # distinct per-shard sampling streams, deterministic per layout
        with staged.bind_data(dl):
            idx = flat_axis_index(mesh, chain_axes)
            k_run_local = jax.random.fold_in(k_run, idx)
            return drive(q0_local, k_eps, k_run_local)

    def build_mapped():
        mapped = _shard_map(
            shard_fn,
            mesh,
            in_specs=(P(ax_el, None), P(), P())
            + tuple(P() for _ in data),
            out_specs=(
                P(ax_el, None),          # q_f (chains, d)
                P(None, ax_el, None),    # qs (n_samples, chains, d)
                P(None, ax_el),          # ljs
                P(None, ax_el),          # per-chain accept probs
                P(None, ax_el),          # divergences
                P(),                     # eps_final (consensus, replicated)
                P(None,) if config.mass != "dense" else P(None, None),  # inv_mass
            ),
        )
        return jax.jit(mapped)

    from ..inference.hmc import constrain_positions

    jit_mapped = staged.cached_kernel(
        ("sharded_hmc", config, n_chains, n_samples, n_warmup, id(mesh),
         chain_axes, _sharded_discrete_key(discrete)),
        build_mapped,
    )
    q_f, qs, ljs, aps, divs, eps_final, inv_mass_f = jit_mapped(
        q0, k_eps, k_run, *data
    )

    positions = jnp.moveaxis(qs, 0, 1)

    return HMCResult(
        samples=constrain_positions(staged, positions),
        positions=positions,
        log_joint=jnp.moveaxis(ljs, 0, 1),
        accept_prob=jnp.mean(aps, axis=-1),
        divergences=jnp.moveaxis(divs, 0, 1),
        step_size=float(np.asarray(eps_final)),
        inv_mass=inv_mass_f,
        final_positions=q_f,
    )


def sharded_nuts_chain(
    key,
    model_fn: Optional[Callable] = None,
    n_samples: int = 1000,
    n_warmup: int = 1000,
    config=None,
    *,
    n_chains: int = 8,
    mesh: Optional[Mesh] = None,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    discrete: Optional[Dict[str, Any]] = None,
    chain_axes=None,
):
    """NUTS with the chain batch sharded across ``mesh``'s chain axes.

    Same SPMD structure as ``sharded_hmc_chain``: per-shard tree building,
    cross-shard collectives for the warmup adaptation (dual-averaging
    acceptance pmean, initial-epsilon consensus, Welford mass merge), so
    every device runs the identical adapted kernel. ``chain_axes`` defaults
    to the ``CHAIN_AXIS`` when present, else all mesh axes (multi-host layout)."""
    from ..inference.nuts import NUTSConfig, NUTSResult, make_nuts_drive

    if config is None:
        config = NUTSConfig()
    if staged is None:
        staged = stage(model_fn, *model_args)
    if mesh is None:
        mesh = make_chain_mesh()
    chain_axes = _resolve_chain_axes(mesh, chain_axes)
    ax_el = _chain_spec_element(chain_axes)
    n_dev = int(np.prod([mesh.shape[a] for a in chain_axes]))
    if n_chains % n_dev:
        raise ValueError(f"n_chains={n_chains} not divisible by mesh size {n_dev}")
    per_shard = n_chains // n_dev

    from ..inference.hmc import constrain_positions, initial_positions

    k_init, k_eps, k_run = jax.random.split(jax.random.fold_in(key, 13), 3)
    q0 = initial_positions(staged, k_init, n_chains, config.init)
    q0 = jax.device_put(q0, NamedSharding(mesh, P(ax_el, None)))

    drive = make_nuts_drive(
        staged, config, per_shard, n_samples, n_warmup,
        discrete=discrete, chain_axis=ax_el,
    )
    data = staged.data_leaves()  # traced data args, replicated per shard

    def shard_fn(q0_local, k_eps, k_run, *dl):
        with staged.bind_data(dl):
            idx = flat_axis_index(mesh, chain_axes)
            k_run_local = jax.random.fold_in(k_run, idx)
            return drive(q0_local, k_eps, k_run_local)

    def build_mapped():
        mapped = _shard_map(
            shard_fn,
            mesh,
            in_specs=(P(ax_el, None), P(), P())
            + tuple(P() for _ in data),
            out_specs=(
                P(ax_el, None),          # q_f (chains, d)
                P(None, ax_el, None),    # qs (n_samples, chains, d)
                P(None, ax_el),          # per-chain accept probs
                P(None, ax_el),          # divergences
                P(None, ax_el),          # tree depths
                P(),                     # eps_final (consensus, replicated)
                P(None,) if config.mass != "dense" else P(None, None),
                P(ax_el),                # per-chain leapfrog counts
            ),
        )
        return jax.jit(mapped)

    jit_mapped = staged.cached_kernel(
        ("sharded_nuts", config, n_chains, n_samples, n_warmup, id(mesh),
         chain_axes, _sharded_discrete_key(discrete)),
        build_mapped,
    )
    q_f, qs, aps, divs, depths, eps_final, inv_mass_f, n_leaps = jit_mapped(
        q0, k_eps, k_run, *data
    )

    positions = jnp.moveaxis(qs, 0, 1)
    return NUTSResult(
        samples=constrain_positions(staged, positions),
        positions=positions,
        accept_prob=jnp.mean(aps, axis=-1),
        divergences=jnp.moveaxis(divs, 0, 1),
        tree_depths=jnp.moveaxis(depths, 0, 1),
        step_size=float(np.asarray(eps_final)),
        inv_mass=inv_mass_f,
        final_positions=q_f,
        n_leapfrogs=int(np.asarray(n_leaps, np.int64).sum()),
    )


def sharded_chees_chain(
    key,
    model_fn: Optional[Callable] = None,
    n_samples: int = 1000,
    n_warmup: int = 1000,
    config=None,
    *,
    n_chains: int = 8,
    mesh: Optional[Mesh] = None,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    discrete: Optional[Dict[str, Any]] = None,
    chain_axes=None,
):
    """ChEES-HMC with the chain batch sharded across ``mesh``'s chain axes.

    The ChEES trajectory-length gradient is a cross-chain expectation —
    under ``shard_map`` it reduces over the mesh with ``pmean`` alongside
    the acceptance statistic and Welford mass moments, so the learned
    (ε, T) kernel is identical on every device and the per-iteration
    leapfrog trip count stays lock-step across the whole slice."""
    from ..inference.chees import ChEESConfig, ChEESResult, make_chees_drive

    if config is None:
        config = ChEESConfig()
    if staged is None:
        staged = stage(model_fn, *model_args)
    if mesh is None:
        mesh = make_chain_mesh()
    chain_axes = _resolve_chain_axes(mesh, chain_axes)
    ax_el = _chain_spec_element(chain_axes)
    n_dev = int(np.prod([mesh.shape[a] for a in chain_axes]))
    if n_chains % n_dev:
        raise ValueError(f"n_chains={n_chains} not divisible by mesh size {n_dev}")
    per_shard = n_chains // n_dev

    from ..inference.hmc import constrain_positions, initial_positions

    k_init, k_eps, k_run = jax.random.split(jax.random.fold_in(key, 17), 3)
    q0 = initial_positions(staged, k_init, n_chains, config.init)
    q0 = jax.device_put(q0, NamedSharding(mesh, P(ax_el, None)))

    drive = make_chees_drive(
        staged, config, per_shard, n_samples, n_warmup,
        discrete=discrete, chain_axis=ax_el,
    )
    data = staged.data_leaves()  # traced data args, replicated per shard

    def shard_fn(q0_local, k_eps, k_run, *dl):
        with staged.bind_data(dl):
            idx = flat_axis_index(mesh, chain_axes)
            k_run_local = jax.random.fold_in(k_run, idx)
            return drive(q0_local, k_eps, k_run_local)

    def build_mapped():
        mapped = _shard_map(
            shard_fn,
            mesh,
            in_specs=(P(ax_el, None), P(), P())
            + tuple(P() for _ in data),
            out_specs=(
                P(ax_el, None),          # q_f (chains, d)
                P(None, ax_el, None),    # qs (n_samples, chains, d)
                P(None, ax_el),          # ljs
                P(None,),                # accept prob (cross-chain mean, replicated)
                P(None, ax_el),          # divergences
                P(),                     # eps_final (consensus, replicated)
                P(),                     # T_final (consensus, replicated)
                P(),                     # mean leapfrog count (replicated)
                P(None,),                # inv_mass (replicated)
                P(),                     # n_leapfrogs (psum'd, replicated)
            ),
        )
        return jax.jit(mapped)

    jit_mapped = staged.cached_kernel(
        ("sharded_chees", config, n_chains, n_samples, n_warmup, id(mesh),
         chain_axes, _sharded_discrete_key(discrete)),
        build_mapped,
    )
    (q_f, qs, ljs, aps, divs, eps_f, T_f, mean_L, inv_mass_f,
     n_leaps) = jit_mapped(
        q0, k_eps, k_run, *data
    )

    positions = jnp.moveaxis(qs, 0, 1)
    T_float = float(np.asarray(T_f))
    t_cap = 2.0 * np.pi * config.max_trajectory_periods
    return ChEESResult(
        samples=constrain_positions(staged, positions),
        positions=positions,
        log_joint=jnp.moveaxis(ljs, 0, 1),
        accept_prob=aps,
        divergences=jnp.moveaxis(divs, 0, 1),
        step_size=float(np.asarray(eps_f)),
        trajectory_length=T_float,
        trajectory_cap_reached=bool(
            config.adapt_mass and n_warmup > 0
            and T_float >= t_cap * (1.0 - 1e-5)
        ),
        mean_leapfrog=float(np.asarray(mean_L)),
        # per-chain scalar (consensus kernel: identical on every shard)
        # x GLOBAL chain count, in host ints
        n_leapfrogs=int(np.asarray(n_leaps, np.int64)) * n_chains,
        inv_mass=inv_mass_f,
        final_positions=q_f,
        criterion=config.criterion,
    )


def sharded_smc(
    key,
    n_particles: int,
    model_fn: Optional[Callable] = None,
    config=None,
    *,
    mesh: Optional[Mesh] = None,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    resume=None,
):
    """Tempered SMC inside ``shard_map`` with explicit collectives: per
    stage only the (N,) weight/log-lik vectors are all-gathered (β
    bisection + ancestor draw bit-identical to single-device); the particle
    pytree moves via a nearest-neighbor ``ppermute`` ring and is NEVER
    all-gathered (``inference.smc._ring_gather`` — SURVEY.md §7 hard part
    4; SURVEY.md §3.4 translation)."""
    from ..inference.smc import SMCConfig, adaptive_smc

    if config is None:
        config = SMCConfig()
    if mesh is None:
        mesh = make_chain_mesh()
    return adaptive_smc(
        key, n_particles, model_fn, config,
        model_args=model_args, staged=staged, mesh=mesh, resume=resume,
    )


def sharded_pt_chain(
    key,
    model_fn: Optional[Callable] = None,
    n_samples: int = 1000,
    n_warmup: int = 1000,
    config=None,
    *,
    n_chains: int = 8,
    mesh: Optional[Mesh] = None,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    discrete: Optional[Dict[str, Any]] = None,
    chain_axes=None,
):
    """Replica-exchange HMC with the CHAIN batch sharded across ``mesh``.

    The β ladder is replicated on every shard (swaps are rung-axis gathers
    between a shard's own chains — chain-local, zero collectives); only the
    per-rung ε-adaptation acceptance statistic reduces over the mesh with
    ``pmean``, so every device adapts the same per-rung kernel
    (VERDICT r2 item 7)."""
    from ..inference.tempering import (
        PTConfig, _pt_result, geometric_ladder, make_pt_drive,
    )

    if config is None:
        config = PTConfig()
    if staged is None:
        staged = stage(model_fn, *model_args)
    if mesh is None:
        mesh = make_chain_mesh()
    chain_axes = _resolve_chain_axes(mesh, chain_axes)
    ax_el = _chain_spec_element(chain_axes)
    n_dev = int(np.prod([mesh.shape[a] for a in chain_axes]))
    if n_chains % n_dev:
        raise ValueError(f"n_chains={n_chains} not divisible by mesh size {n_dev}")
    per_shard = n_chains // n_dev

    drive = make_pt_drive(
        staged, config, per_shard, n_samples, n_warmup,
        discrete=discrete, chain_axis=ax_el,
    )

    def shard_fn(k):
        idx = flat_axis_index(mesh, chain_axes)
        return drive(jax.random.fold_in(k, idx))

    def build_mapped():
        mapped = _shard_map(
            shard_fn,
            mesh,
            in_specs=(P(),),
            out_specs=(
                P(None, ax_el, None),   # q_f (K, chains, d)
                P(None,),               # eps_f (K,) — pmean-consensus
                P(None, ax_el, None),   # q1s (n_samples, chains, d) at beta=1
                P(None, None),          # accs (n_samples, K) — cross-shard mean
                P(None, None, ax_el),   # pair_accs (n_samples, K, chains)
            ),
        )
        return jax.jit(mapped)

    jit_mapped = staged.cached_kernel(
        ("sharded_pt", config, n_chains, n_samples, n_warmup, id(mesh),
         chain_axes, _sharded_discrete_key(discrete)),
        build_mapped,
    )
    out = jit_mapped(key)
    betas = geometric_ladder(config.n_temps, config.beta_min)
    return _pt_result(staged, betas, *out)


def sharded_ess_chain(
    key,
    model_fn: Optional[Callable] = None,
    n_samples: int = 1000,
    n_warmup: int = 200,
    config=None,
    *,
    n_chains: int = 64,
    mesh: Optional[Mesh] = None,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    discrete: Optional[Dict[str, Any]] = None,
    chain_axes=None,
):
    """Elliptical slice sampling with chains sharded across ``mesh``.

    ESS is tuning-free (nothing adapts), so chains are embarrassingly
    parallel: the only cross-shard discipline is the per-shard key fold,
    which keeps draw streams independent of the sharding layout
    (VERDICT r2 item 7)."""
    from ..inference.ess import (
        ESSConfig, ESSResult, _gaussian_prior_means, make_ess_transition,
    )
    from ..core.rng import chain_keys as _chain_keys

    if config is None:
        config = ESSConfig()
    if staged is None:
        staged = stage(model_fn, *model_args)
    if mesh is None:
        mesh = make_chain_mesh()
    chain_axes = _resolve_chain_axes(mesh, chain_axes)
    ax_el = _chain_spec_element(chain_axes)
    n_dev = int(np.prod([mesh.shape[a] for a in chain_axes]))
    if n_chains % n_dev:
        raise ValueError(f"n_chains={n_chains} not divisible by mesh size {n_dev}")
    per_shard = n_chains // n_dev
    dt = settings.real_dtype()

    mu = staged.cached_kernel(
        ("ess_mu",), lambda: _gaussian_prior_means(staged).astype(dt)
    )
    transition = make_ess_transition(staged, mu, config, discrete)

    def shard_fn(key):
        idx = flat_axis_index(mesh, chain_axes)
        k_init, k_run = jax.random.split(
            jax.random.fold_in(jax.random.fold_in(key, 31), idx)
        )
        f0 = jax.vmap(
            lambda k: staged.flatten_constrained(staged.sample_prior(k))
        )(_chain_keys(k_init, per_shard)).astype(dt)
        vstep = jax.vmap(transition, in_axes=(0, 0))

        def body(f, k):
            keys = jax.random.split(k, per_shard)
            f_new, ll, iters = vstep(f, keys)
            return f_new, (f_new, ll, iters)

        keys = jax.random.split(k_run, n_warmup + n_samples)
        f_f, (fs, lls, iters) = jax.lax.scan(body, f0, keys)
        return f_f, fs[n_warmup:], lls[n_warmup:], iters

    def build_mapped():
        mapped = _shard_map(
            shard_fn,
            mesh,
            in_specs=(P(),),
            out_specs=(
                P(ax_el, None),         # f_f (chains, d)
                P(None, ax_el, None),   # fs (n_samples, chains, d)
                P(None, ax_el),         # lls
                P(None, ax_el),         # iters (n_total, chains)
            ),
        )
        return jax.jit(mapped)

    jit_mapped = staged.cached_kernel(
        ("sharded_ess", config, n_chains, n_samples, n_warmup, id(mesh),
         chain_axes, _sharded_discrete_key(discrete)),
        build_mapped,
    )
    f_f, fs, lls, iters = jit_mapped(key)

    positions = jnp.moveaxis(fs, 0, 1)
    unflat = staged.cached_kernel(
        ("ess_unflatten",),
        lambda: jax.jit(jax.vmap(jax.vmap(staged.unflatten_constrained))),
    )
    return ESSResult(
        samples=unflat(positions),
        log_lik=jnp.moveaxis(lls, 0, 1),
        mean_shrink_iters=float(np.asarray(jnp.mean(iters.astype(dt)))),
        final_flat=f_f,
    )


def sharded_gibbs_chain(
    key,
    model_fn: Optional[Callable] = None,
    n_samples: int = 1000,
    n_warmup: int = 500,
    config=None,
    *,
    n_chains: int = 8,
    mesh: Optional[Mesh] = None,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    discrete_scale: float = 1.0,
    chain_axes=None,
):
    """HMC-within-Gibbs with the chain batch sharded across ``mesh``
    (completes the VERDICT r2 item-7 engine set: every drive runs under
    ``shard_map``). The dual-averaging acceptance statistic and the
    initial-ε search reduce with ``pmean`` so every shard adapts the same
    continuous-block kernel; discrete MH sweeps are chain-local."""
    from ..inference.gibbs import GibbsResult, make_gibbs_drive
    from ..inference.hmc import HMCConfig

    if config is None:
        config = HMCConfig(n_leapfrog=16)
    if staged is None:
        staged = stage(model_fn, *model_args)
    if mesh is None:
        mesh = make_chain_mesh()
    chain_axes = _resolve_chain_axes(mesh, chain_axes)
    ax_el = _chain_spec_element(chain_axes)
    n_dev = int(np.prod([mesh.shape[a] for a in chain_axes]))
    if n_chains % n_dev:
        raise ValueError(f"n_chains={n_chains} not divisible by mesh size {n_dev}")
    per_shard = n_chains // n_dev

    drive = make_gibbs_drive(
        staged, config, per_shard, n_samples, n_warmup,
        discrete_scale=discrete_scale, chain_axis=ax_el,
    )

    def shard_fn(k_init, k_eps, k_run):
        idx = flat_axis_index(mesh, chain_axes)
        return drive(
            jax.random.fold_in(k_init, idx), k_eps,
            jax.random.fold_in(k_run, idx),
        )

    cont_specs = {
        s.address: P(None, ax_el, *([None] * len(s.shape)))
        for s in staged.continuous_sites
    }
    disc_specs = {
        s.address: P(None, ax_el, *([None] * len(s.shape)))
        for s in staged.discrete_sites
    }

    def build_mapped():
        mapped = _shard_map(
            shard_fn,
            mesh,
            in_specs=(P(), P(), P()),
            out_specs=(
                cont_specs,              # (n_samples, chains, ...)
                disc_specs,
                P(None, ax_el),          # hmc accept prob
                P(None, ax_el),          # discrete accept rate
                P(),                     # eps (pmean consensus, replicated)
                (P(ax_el), {             # final sweep state (resume)
                    s.address: P(ax_el, *([None] * len(s.shape)))
                    for s in staged.discrete_sites
                }),
            ),
        )
        return jax.jit(mapped)

    jit_mapped = staged.cached_kernel(
        ("sharded_gibbs", config, n_chains, n_samples, n_warmup,
         discrete_scale, id(mesh), chain_axes),
        build_mapped,
    )
    k_init, k_eps, k_run = jax.random.split(jax.random.fold_in(key, 13), 3)
    cont, disc, aps, dacc, eps_f, state_f = jit_mapped(k_init, k_eps, k_run)
    z_f, disc_f = state_f
    samples = {a: jnp.moveaxis(v, 0, 1) for a, v in {**cont, **disc}.items()}
    return GibbsResult(
        samples=samples,
        accept_prob_hmc=jnp.mean(aps, axis=0),
        accept_rate_discrete=jnp.mean(dacc),
        step_size=float(np.asarray(eps_f)),
        final_positions=z_f,
        final_discrete=disc_f,
    )


def sharded_abc_rejection(
    key,
    model_fn: Optional[Callable] = None,
    observed=None,
    distance=None,
    epsilon: float = 1.0,
    n_samples: int = 100,
    *,
    mesh: Optional[Mesh] = None,
    max_attempts: int = 1_000_000,
    batch_size: int = 8192,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
):
    """Likelihood-free rejection with the SIMULATION batch sharded across
    ``mesh`` (completes the ABC artifact set, VERDICT r3 weak #3; reference
    engine: abc.rs:283-325). Each shard simulates ``batch_size/n_shards``
    candidates with a per-shard folded key, decides acceptance locally,
    compacts its accepted rows to the front (stable argsort), and
    all-gathers only the top ``cap`` rows per shard — the full candidate
    batch never crosses shards or reaches the host."""
    from ..inference.abc import ABCResult, _stage_exhausted, euclidean_distance
    from ..core.rng import chain_keys

    if distance is None:
        distance = euclidean_distance
    if staged is None:
        staged = stage(model_fn, *model_args)
    if mesh is None:
        mesh = make_chain_mesh()
    chain_axes = _resolve_chain_axes(mesh, None)
    ax_el = _chain_spec_element(chain_axes)
    n_dev = int(np.prod([mesh.shape[a] for a in chain_axes]))
    if batch_size % n_dev:
        raise ValueError(
            f"batch_size={batch_size} not divisible by mesh size {n_dev}")
    local_batch = batch_size // n_dev
    observed = jnp.asarray(observed)
    cap = min(n_samples, local_batch)

    def shard_fn(k, obs):
        idx = flat_axis_index(mesh, chain_axes)
        keys = chain_keys(jax.random.fold_in(k, idx), local_batch)

        def one(kk):
            data, latents = staged.simulate(kk)
            return latents, distance(data, obs)

        latents, d = jax.vmap(one)(keys)
        ok = d <= epsilon
        # top_k on the acceptance mask (any accepted rows; exchangeable)
        # instead of a full argsort of the batch
        _, take = jax.lax.top_k(ok.astype(jnp.float32), cap)
        top = {a: jnp.take(v, take, axis=0) for a, v in latents.items()}
        d_top = jnp.take(d, take)
        n_ok = jnp.minimum(jnp.sum(ok.astype(jnp.int32)), cap)
        # gather every shard's top block; output is replicated
        top_g = jax.tree_util.tree_map(
            lambda x: _flat_all_gather(x, chain_axes), top)
        return (top_g, _flat_all_gather(d_top, chain_axes),
                _flat_all_gather(n_ok[None], chain_axes))

    def _flat_all_gather(x, axes):
        for ax in reversed(axes):
            x = jax.lax.all_gather(x, ax, tiled=True)
        return x

    def build():
        mapped = _shard_map(
            shard_fn, mesh, in_specs=(P(), P()),
            out_specs=({s.address: P() for s in staged.sites}, P(), P()),
        )
        return jax.jit(mapped)

    jit_batch = staged.cached_kernel(
        ("sharded_abc", batch_size, cap, float(epsilon),
         getattr(distance, "__qualname__", repr(distance)),
         # id() disambiguates distinct closures sharing a __qualname__
         # (e.g. two lambdas with different closed-over weights); the
         # cached jitted closure keeps `distance` alive, so the id is
         # never recycled while the cache entry exists (ADVICE r4)
         id(distance),
         observed.shape, str(observed.dtype), id(mesh), chain_axes),
        build,
    )

    collected, dists = [], []
    n_acc, attempts, i = 0, 0, 0
    while n_acc < n_samples:
        if attempts >= max_attempts:
            raise _stage_exhausted(0, n_acc, n_samples, attempts)
        top, d_top, counts = jit_batch(jax.random.fold_in(key, i), observed)
        i += 1
        attempts += batch_size
        counts = np.asarray(counts)
        d_np = np.asarray(d_top)
        for s_i, c in enumerate(counts):
            n_take = min(int(c), n_samples - n_acc)
            if n_take <= 0:
                continue
            sl = slice(s_i * cap, s_i * cap + n_take)
            collected.append({a: np.asarray(v)[sl] for a, v in top.items()})
            dists.append(d_np[sl])
            n_acc += n_take

    particles = {
        a: jnp.asarray(
            np.concatenate([c[a] for c in collected], axis=0)[:n_samples])
        for a in collected[0]
    }
    return ABCResult(
        particles=particles,
        distances=jnp.asarray(np.concatenate(dists)[:n_samples]),
        log_weights=jnp.zeros((n_samples,), settings.real_dtype()),
        n_attempts=attempts,
    )


def sharded_vi(
    key,
    model_fn: Optional[Callable] = None,
    config=None,
    *,
    mesh: Optional[Mesh] = None,
    guide: str = "meanfield",
    shard: str = "auto",
    factors: str = "replicated",
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    chain_axes=None,
    resume=None,
):
    """Device-parallel VI: the whole optimization runs as ONE shard-mapped
    SPMD program over ``mesh`` (VERDICT r4 missing #1 — the last engine
    joins the mesh; reference engine: vi.rs:784-864).

    Two complementary sharding modes (``shard=``):

    - ``"data"`` — the staged model's data leaves are split on axis 0
      across the mesh (the sharded-plate / context-parallel analog,
      SURVEY.md §2.3 SP row). Every shard draws the SAME reparameterized
      guide samples (replicated params + un-folded keys), scores its local
      data slice, and the pathwise ELBO gradient is ``psum``-reduced before
      each Adam step — so parameters stay bit-replicated while the
      likelihood work scales with devices. Requires the likelihood to
      decompose over the sharded axis and all latents to be global
      (no per-row latent sites).
    - ``"samples"`` — each shard draws ``config.n_samples`` INDEPENDENT MC
      samples with a per-shard folded key; the psum'd loss/gradient is the
      mean over ``n_samples x n_shards`` global draws (lower-variance
      gradients at unchanged wall-clock). Works for any model.
    - ``"auto"`` (default) — ``"data"`` when every data leaf's axis 0
      divides evenly by the shard count (and there is at least one data
      leaf), else ``"samples"``.

    ``factors=``: how ``ft.factor`` terms are reduced in data mode —
    ``"replicated"`` (default; factors do not depend on the sharded data,
    counted once) or ``"sharded"`` (per-shard factors summed with the
    likelihood; use when the likelihood enters through ``factor``).

    ``guide=``: ``"meanfield"`` (support-matched families, falling back to
    the unconstrained diagonal guide exactly like ``optimize_meanfield_vi``)
    or ``"fullrank"`` (ADVI with full covariance).

    Returns the same ``VIResult`` as the single-device drivers; ``resume=``
    continues from a previous result's parameters.
    """
    import optax

    from ..core.rng import chain_keys
    from ..inference.vi import (
        FullRankGuide,
        UnconstrainedMeanFieldGuide,
        VIConfig,
        _drive_vi,
        _make_vi_program,
        _meanfield_guide_for,
    )

    if config is None:
        config = VIConfig()
    if staged is None:
        staged = stage(model_fn, *model_args)
    if mesh is None:
        mesh = make_chain_mesh()
    chain_axes = _resolve_chain_axes(mesh, chain_axes)
    ax_el = _chain_spec_element(chain_axes)
    n_dev = int(np.prod([mesh.shape[a] for a in chain_axes]))
    # the data-sharded mode must see EVERY array leaf as a jit argument
    # (min_bytes=0), not just the >=1 MiB ones — sharding a plate only
    # works if the plate actually flows in as a traced, shardable input
    data = staged.data_leaves(0)

    # Identify the PLATE leaves: only array arguments whose leading axis
    # equals the LARGEST leading axis are sharded; every other leaf (small
    # per-latent constants, hyperparameter vectors) is replicated. Sharding
    # every divisible leaf corrupted models whose non-plate constants
    # happened to divide by the device count (r5 review finding: a (8,)
    # prior-mean argument on an 8-device mesh silently became per-shard
    # length-1 slices).
    lead = [x.shape[0] for x in data if getattr(x, "ndim", 0) >= 1]
    n_plate = max(lead, default=None)
    plate_divides = n_plate is not None and n_plate % n_dev == 0
    if shard == "auto":
        # engage data mode only for an unambiguous plate: the largest
        # leading axis divides the shard count AND is plate-sized
        # (>= 8 rows per shard)
        shard = ("data" if plate_divides and n_plate >= 8 * n_dev
                 else "samples")
    if shard == "data":
        if n_plate is None:
            raise ValueError(
                "shard='data' needs at least one staged data leaf "
                "(pass the dataset as a stage()/model_args argument)"
            )
        if not plate_divides:
            raise ValueError(
                f"largest data leaf axis 0 ({n_plate}) does not split "
                f"evenly over {n_dev} shards"
            )
        data_specs = tuple(
            P(ax_el) if (getattr(x, "ndim", 0) >= 1
                         and x.shape[0] == n_plate) else P()
            for x in data
        )
    elif shard == "samples":
        data_specs = tuple(P() for _ in data)
    else:
        raise ValueError(f"unknown shard mode {shard!r}")

    mode = "fresh" if resume is None else "resume"
    dt = settings.real_dtype()

    def build():
        if guide == "fullrank":
            g = FullRankGuide(staged)
        elif guide == "meanfield":
            g = _meanfield_guide_for(staged)
        else:
            raise ValueError(f"unknown guide {guide!r}")
        # same optimizer selection as optimize_meanfield_vi (annealed Adam
        # default, Robbins-Monro SGD when configured)
        if config.optimizer == "adam":
            t0 = max(config.n_iterations / 10.0, 1.0)
            schedule = lambda t: config.learning_rate * jnp.power(
                1.0 + t / t0, -0.6)
            tx = optax.adam(schedule)
        elif config.decay > 0:
            tx = optax.sgd(lambda t: config.learning_rate * jnp.power(
                t + 1.0, -config.decay))
        else:
            tx = optax.sgd(config.learning_rate)
        z_space = isinstance(g, (FullRankGuide, UnconstrainedMeanFieldGuide))

        def draw_parts(kk, p):
            """Per-draw (prior_side, likelihood) split for the psum layout."""
            if z_space:
                z = g.sample_z(kk, p)
                parts, logdet = staged.log_density_parts_unconstrained(z)
                prior_side = parts.log_prior + logdet
            else:
                latents = g.sample_latents(kk, p)
                parts = staged.log_density_parts(latents)
                prior_side = parts.log_prior
            if factors == "sharded":
                return prior_side, parts.log_likelihood + parts.log_factors
            return prior_side + parts.log_factors, parts.log_likelihood

        if shard == "data":
            # same key on every shard -> identical guide draws; only the
            # bound data slice (and hence the likelihood term) is local
            def loss_fn(p, k):
                pr, lik = jax.vmap(lambda kk: draw_parts(kk, p))(
                    chain_keys(k, config.n_samples)
                )
                # global neg-ELBO = psum over shards of this contribution:
                # prior + entropy counted once (divided by n_dev), local
                # likelihood partial sums added across shards
                return (
                    -(jnp.mean(pr) + g.entropy(p)) / n_dev - jnp.mean(lik)
                ).astype(dt)
        else:
            def loss_fn(p, k):
                k = jax.random.fold_in(k, flat_axis_index(mesh, chain_axes))
                pr, lik = jax.vmap(lambda kk: draw_parts(kk, p))(
                    chain_keys(k, config.n_samples)
                )
                # psum averages the n_dev independent local MC means
                return (
                    -(jnp.mean(pr + lik) + g.entropy(p)) / n_dev
                ).astype(dt)

        return g, tx, _make_vi_program(
            g, tx, loss_fn, config, staged=staged,
            resume_mode=(mode == "resume"), mesh=mesh,
            chain_axes=chain_axes, data_specs=data_specs, data_min_bytes=0,
        )

    g, tx, run = staged.cached_kernel(
        ("sharded_vi", guide, config, mode, shard, factors, id(mesh),
         chain_axes),
        build,
    )
    return _drive_vi(run, g, tx, key, staged=staged, resume=resume,
                     data_min_bytes=0)
