"""Approximate Bayesian Computation: rejection + importance-weighted ABC-SMC.

Capability parity with the reference ABC engine (reference:
src/inference/abc.rs — ``DistanceFunction`` trait :97-109 (Euclidean :130,
Manhattan :166, weighted SummaryStats :183-226); ``abc_rejection`` with
bounded attempts :283-325; importance-weighted ABC-SMC (Beaumont/Toni, FG-09):
weight-proportional base draw, Gaussian kernel bandwidth = sqrt(2 * weighted
variance) :744-771, prior-support rejection, weights pi(theta)/sum_j w_j
K(theta|theta_j) via log-sum-exp :604-640; typed ABCError with attempt
budgets (FG-34) :403-455; ``abc_smc_weighted`` :520 / equal-weight
``abc_smc`` :696 / ``abc_scalar_summary`` :882).

Array-program design: the simulator is the staged model's prior execution —
``staged.simulate(key) → (dataset, latents)`` — so candidate draws,
simulations, and distances for a whole batch run as ONE vmapped jit program.
Acceptance bookkeeping (how many collected so far) lives on host between
batches; each batch is fixed-shape, so nothing recompiles.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import settings
from ..core.numerics import log_sum_exp
from ..core.rng import chain_keys
from ..errors import ErrorCode, FugueError
from ..runtime.staging import StagedModel, stage


class ABCError(FugueError):
    """Attempt budget exhausted / empty population (reference: abc.rs:403-455,
    FG-34)."""


def _stage_exhausted(stage_idx: int, accepted: int, needed: int, attempts: int):
    return ABCError(
        ErrorCode.UNEXPECTED_MODEL_STRUCTURE,
        f"ABC stage {stage_idx} exhausted its attempt budget",
        {"accepted": accepted, "needed": needed, "attempts": attempts},
    )


# ---------------------------------------------------------------------------
# Distance functions (reference: abc.rs:97-226)
# ---------------------------------------------------------------------------


def euclidean_distance(a, b):
    return jnp.sqrt(jnp.sum((jnp.asarray(a) - jnp.asarray(b)) ** 2))


def manhattan_distance(a, b):
    return jnp.sum(jnp.abs(jnp.asarray(a) - jnp.asarray(b)))


@dataclass
class SummaryStatsDistance:
    """Weighted distance over user summary statistics
    (reference: abc.rs:183-226)."""

    summary: Callable[[Any], Any]
    weights: Optional[Any] = None

    def __call__(self, a, b):
        sa = jnp.atleast_1d(jnp.asarray(self.summary(a), settings.real_dtype()))
        sb = jnp.atleast_1d(jnp.asarray(self.summary(b), settings.real_dtype()))
        w = (
            jnp.ones_like(sa)
            if self.weights is None
            else jnp.asarray(self.weights, sa.dtype)
        )
        return jnp.sqrt(jnp.sum(w * (sa - sb) ** 2))


# ---------------------------------------------------------------------------
# ABC rejection (reference: abc.rs:283-325)
# ---------------------------------------------------------------------------


@dataclass
class ABCResult:
    particles: Dict[str, Any]  # addr -> (n, *site_shape)
    distances: Any
    log_weights: Any  # uniform for rejection; importance weights for SMC
    n_attempts: int

    def posterior_mean(self, address: str):
        w = jnp.exp(self.log_weights - log_sum_exp(self.log_weights))
        vals = jnp.asarray(self.particles[str(address)], settings.real_dtype())
        w = w.reshape(w.shape + (1,) * (vals.ndim - 1))
        return jnp.sum(w * vals, axis=0)


def abc_rejection(
    key,
    model_fn: Optional[Callable] = None,
    observed=None,
    distance: Callable = euclidean_distance,
    epsilon: float = 1.0,
    n_samples: int = 100,
    *,
    max_attempts: int = 100_000,
    batch_size: int = 1024,
    inner_batches: int = 1,
    rng_impl: Optional[str] = None,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
) -> ABCResult:
    """Likelihood-free rejection sampling with a bounded attempt budget
    (reference: abc.rs:283-325). The model's RETURN VALUE is the simulated
    dataset; observes/likelihood terms are ignored by construction (the model
    should be written prior-only for ABC).

    ``inner_batches``: sub-batches simulated per DISPATCH (a ``lax.scan``
    on device). Each host round trip then covers
    ``inner_batches * batch_size`` simulations — on a dispatch/fetch-bound
    device this is the difference between latency-bound and device-bound
    rejection.

    ``rng_impl``: ``"rbg"`` draws each candidate's simulator randomness
    with JAX's ``rbg`` generator instead of threefry (its speed on the GPU
    is not measured yet). Candidate keys are still derived by threefry
    splitting from ``key``, so runs stay deterministic per (key,
    layout)."""
    if staged is None:
        staged = stage(model_fn, *model_args)
    observed = jnp.asarray(observed)
    # Per-batch host transfer is capped at ``cap`` rows: acceptance is
    # decided ON DEVICE and accepted rows are compacted to the front with a
    # stable argsort, so each batch fetches one scalar count + cap rows
    # instead of the full (batch_size, ...) latents (same single-transfer
    # discipline as SMC's packed stats).
    cap = min(n_samples, batch_size)
    K = max(1, int(inner_batches))

    def sub_batch(k, obs):
        def one(kk):
            if rng_impl == "rbg":
                kd = jax.random.key_data(
                    jax.random.split(kk, 2)
                ).ravel().astype(jnp.uint32)
                kk = jax.random.wrap_key_data(kd, impl="rbg")
            data, latents = staged.simulate(kk)
            return latents, distance(data, obs)

        latents, d = jax.vmap(one)(chain_keys(k, batch_size))
        ok = d <= epsilon
        # top_k on the acceptance mask (any accepted rows; exchangeable)
        # instead of a full argsort of the batch
        _, take = jax.lax.top_k(ok.astype(jnp.float32), cap)
        top = {a: jnp.take(v, take, axis=0) for a, v in latents.items()}
        return top, jnp.take(d, take), jnp.minimum(
            jnp.sum(ok.astype(jnp.int32)), cap)

    def batch_fn(k, obs):
        if K == 1:
            top, d_top, n_ok = sub_batch(k, obs)
            return (
                jax.tree_util.tree_map(lambda x: x[None], top),
                d_top[None], n_ok[None],
            )

        def body(_, kk):
            return None, sub_batch(kk, obs)

        _, (tops, d_tops, n_oks) = jax.lax.scan(
            body, None, jax.random.split(k, K)
        )
        return tops, d_tops, n_oks  # (K, cap, ...) / (K, cap) / (K,)

    # cached per staged model (CLAUDE.md: no fresh jit closure per call);
    # observed flows in as a traced argument so same-shape datasets share
    # the executable
    jit_batch = staged.cached_kernel(
        ("abc_rejection", batch_size, cap, K, rng_impl, float(epsilon),
         getattr(distance, "__qualname__", repr(distance)),
         # id() disambiguates distinct closures sharing a __qualname__
         # (e.g. two lambdas with different closed-over weights); the
         # cached jitted closure keeps `distance` alive, so the id is
         # never recycled while the cache entry exists (ADVICE r4)
         id(distance),
         observed.shape, str(observed.dtype)),
        lambda: jax.jit(batch_fn),
    )

    def batch(k):
        return jit_batch(k, observed)

    collected: List[Any] = []
    dists: List[Any] = []
    n_acc = 0
    attempts = 0
    i = 0
    while n_acc < n_samples:
        if attempts >= max_attempts:
            raise _stage_exhausted(0, n_acc, n_samples, attempts)
        tops, d_tops, n_oks = batch(jax.random.fold_in(key, i))
        i += 1
        attempts += K * batch_size
        n_oks = np.asarray(n_oks)
        d_np = np.asarray(d_tops)
        tops_np = {a: np.asarray(v) for a, v in tops.items()}
        for ki in range(K):
            n_take = min(int(n_oks[ki]), cap, n_samples - n_acc)
            if n_take <= 0:
                continue
            collected.append(
                {a: v[ki, :n_take] for a, v in tops_np.items()}
            )
            dists.append(d_np[ki, :n_take])
            n_acc += n_take

    particles = {
        a: jnp.asarray(
            np.concatenate([c[a] for c in collected], axis=0)[:n_samples]
        )
        for a in collected[0]
    }
    distances = jnp.asarray(np.concatenate(dists)[:n_samples])
    return ABCResult(
        particles=particles,
        distances=distances,
        log_weights=jnp.zeros((n_samples,), settings.real_dtype()),
        n_attempts=attempts,
    )


# ---------------------------------------------------------------------------
# Importance-weighted ABC-SMC (Beaumont/Toni; reference: abc.rs:520-694)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ABCSMCConfig:
    """Reference: ABCSMCConfig (abc.rs:392-401)."""

    epsilons: Tuple[float, ...] = (2.0, 1.0, 0.5)
    n_particles: int = 256
    max_attempts_per_stage: int = 100_000
    batch_size: int = 1024


def abc_smc_weighted(
    key,
    model_fn: Optional[Callable] = None,
    observed=None,
    distance: Callable = euclidean_distance,
    config: ABCSMCConfig = ABCSMCConfig(),
    *,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    param_addresses: Optional[Sequence[str]] = None,
) -> ABCResult:
    """Correct importance-weighted ABC-SMC (reference FG-09, abc.rs:520-694):

    stage 0: rejection at epsilons[0], uniform weights;
    stage t: draw base particle with probability ∝ weight, perturb with a
    Gaussian kernel of bandwidth sqrt(2 · weighted variance) per dimension
    (abc.rs:744-771), reject outside prior support, accept if distance <=
    epsilon_t, weight = pi(theta) / sum_j wbar_j K(theta | theta_j).

    ``param_addresses`` selects which latent sites are the *parameters*
    theta (perturbed + weighted); the remaining sites are treated as
    simulator noise and redrawn fresh each proposal. Default: all continuous
    latents — fine for prior-only parameter models, but name your parameters
    explicitly when the model also samples the synthetic dataset.
    """
    if staged is None:
        staged = stage(model_fn, *model_args)
    observed = jnp.asarray(observed)
    N = config.n_particles

    if param_addresses is None:
        param_sites = list(staged.continuous_sites)
        if staged.discrete_sites:
            raise ABCError(
                ErrorCode.NOT_STAGEABLE,
                "ABC-SMC perturbation requires continuous parameter sites; "
                "pass param_addresses to exclude discrete latents",
                {"discrete": [s.address for s in staged.discrete_sites]},
            )
    else:
        param_sites = [staged.site(a) for a in param_addresses]
        for s in param_sites:
            if not s.is_continuous:
                raise ABCError(
                    ErrorCode.NOT_STAGEABLE,
                    f"parameter site {s.address!r} is discrete",
                    {"support": s.support.kind},
                )

    # flat layout over parameter sites only
    offsets = {}
    off = 0
    for s in param_sites:
        offsets[s.address] = (off, off + s.size)
        off += s.size
    d_dim = off

    def flatten_params(latents):
        return jnp.concatenate(
            [jnp.ravel(jnp.asarray(latents[s.address], settings.real_dtype()))
             for s in param_sites]
        )

    def unflatten_params(vec):
        return {
            s.address: vec[offsets[s.address][0] : offsets[s.address][1]].reshape(s.shape)
            for s in param_sites
        }

    # stage 0: plain rejection
    r0 = abc_rejection(
        jax.random.fold_in(key, 0),
        observed=observed,
        distance=distance,
        epsilon=config.epsilons[0],
        n_samples=N,
        max_attempts=config.max_attempts_per_stage,
        batch_size=config.batch_size,
        staged=staged,
    )
    if N == 0:
        raise ABCError(
            ErrorCode.UNEXPECTED_MODEL_STRUCTURE, "empty initial population"
        )
    thetas = jax.vmap(flatten_params)(r0.particles)  # (N, d)
    log_w = jnp.zeros((N,), settings.real_dtype())
    attempts_total = r0.n_attempts

    def sim_and_logprior(kk, theta_vec):
        """Pin parameter sites, redraw noise sites, score the prior of the
        parameter sites only."""
        values = unflatten_params(theta_vec)
        data, trace = staged.replay_partial(kk, values)
        lp = jnp.zeros((), settings.real_dtype())
        for s in param_sites:
            lp = lp + trace.choices[s.address].log_prob
        return data, lp

    cap = min(N, config.batch_size)

    def propose_batch_fn(k, thetas, log_w, bw, obs, eps_t):
        """One batch of perturbed candidates: simulate, score, decide
        acceptance ON DEVICE and compact accepted rows to the front
        (top_k), so the host fetches ``cap`` rows + one count instead of
        the full batch (same single-transfer discipline as
        ``abc_rejection``)."""
        def one(kk):
            k1, k2, k3 = jax.random.split(kk, 3)
            base = jax.random.categorical(k1, log_w)
            theta = thetas[base] + bw * jax.random.normal(k2, (d_dim,), thetas.dtype)
            data, lp = sim_and_logprior(k3, theta)
            dist = distance(data, obs)
            # kernel denominator: log sum_j wbar_j K(theta | theta_j)
            log_wbar = log_w - log_sum_exp(log_w)
            z = (theta[None, :] - thetas) / bw
            log_k = -0.5 * jnp.sum(z * z, axis=-1) - jnp.sum(
                jnp.log(bw)
            ) - 0.5 * d_dim * jnp.log(2 * jnp.pi)
            log_denom = log_sum_exp(log_wbar + log_k)
            return theta, dist, lp - log_denom, jnp.isfinite(lp)

        th, d, lw, in_support = jax.vmap(one)(
            chain_keys(k, config.batch_size)
        )
        ok = in_support & (d <= eps_t)
        _, take = jax.lax.top_k(ok.astype(jnp.float32), cap)
        n_ok = jnp.minimum(jnp.sum(ok.astype(jnp.int32)), cap)
        return jnp.take(th, take, axis=0), jnp.take(lw, take), n_ok

    jit_propose = staged.cached_kernel(
        ("abc_smc_propose", config.batch_size, cap, N, d_dim,
         getattr(distance, "__qualname__", repr(distance)),
         # id() disambiguates distinct closures sharing a __qualname__
         # (e.g. two lambdas with different closed-over weights); the
         # cached jitted closure keeps `distance` alive, so the id is
         # never recycled while the cache entry exists (ADVICE r4)
         id(distance),
         observed.shape, str(observed.dtype),
         tuple(s.address for s in param_sites)),
        lambda: jax.jit(propose_batch_fn),
    )

    for t, eps in enumerate(config.epsilons[1:], start=1):
        # weighted kernel bandwidth (abc.rs:744-771)
        wbar = jnp.exp(log_w - log_sum_exp(log_w))
        mean = jnp.sum(wbar[:, None] * thetas, axis=0)
        var = jnp.sum(wbar[:, None] * (thetas - mean) ** 2, axis=0)
        bw = jnp.sqrt(2.0 * jnp.maximum(var, 1e-12))
        eps_t = jnp.asarray(eps, settings.real_dtype())

        new_thetas: List[np.ndarray] = []
        new_logw: List[np.ndarray] = []
        n_acc, attempts, i = 0, 0, 0
        while n_acc < N:
            if attempts >= config.max_attempts_per_stage:
                raise _stage_exhausted(t, n_acc, N, attempts)
            th_top, lw_top, n_ok = jit_propose(
                jax.random.fold_in(jax.random.fold_in(key, t), i),
                thetas, log_w, bw, observed, eps_t,
            )
            i += 1
            attempts += config.batch_size
            n_take = min(int(n_ok), cap, N - n_acc)
            if n_take:
                new_thetas.append(np.asarray(th_top)[:n_take])
                new_logw.append(np.asarray(lw_top)[:n_take])
                n_acc += n_take
        thetas = jnp.asarray(np.concatenate(new_thetas, axis=0)[:N])
        log_w = jnp.asarray(np.concatenate(new_logw)[:N])
        attempts_total += attempts

    particles = jax.vmap(unflatten_params)(thetas)
    final_d = jax.vmap(
        lambda i, th: distance(
            staged.replay_partial(jax.random.fold_in(key, 777), unflatten_params(th))[0],
            observed,
        ),
        in_axes=(0, 0),
    )(jnp.arange(N), thetas)
    return ABCResult(
        particles=particles,
        distances=final_d,
        log_weights=log_w - log_sum_exp(log_w),
        n_attempts=attempts_total,
    )


def abc_smc(
    key,
    model_fn: Optional[Callable] = None,
    observed=None,
    distance: Callable = euclidean_distance,
    config: ABCSMCConfig = ABCSMCConfig(),
    **kw,
) -> ABCResult:
    """Equal-weight variant: importance-weighted run + terminal resample
    (reference: abc_smc, abc.rs:696)."""
    res = abc_smc_weighted(key, model_fn, observed, distance, config, **kw)
    from ..ops.resampling import systematic_resample

    idx = systematic_resample(jax.random.fold_in(key, 999), res.log_weights)
    particles = jax.tree_util.tree_map(
        lambda x: jnp.take(x, idx, axis=0), res.particles
    )
    return ABCResult(
        particles=particles,
        distances=jnp.take(res.distances, idx),
        log_weights=jnp.zeros_like(res.log_weights),
        n_attempts=res.n_attempts,
    )


def abc_scalar_summary(
    key,
    model_fn: Optional[Callable] = None,
    observed_summary: float = 0.0,
    summary: Callable = jnp.mean,
    epsilon: float = 0.5,
    n_samples: int = 100,
    **kw,
) -> ABCResult:
    """Convenience: ABC on a scalar summary statistic (reference:
    abc.rs:882)."""
    dist = lambda a, b: jnp.abs(
        jnp.asarray(summary(a), settings.real_dtype()) - jnp.asarray(b)
    )
    return abc_rejection(
        key,
        model_fn,
        observed=jnp.asarray(observed_summary, settings.real_dtype()),
        distance=dist,
        epsilon=epsilon,
        n_samples=n_samples,
        **kw,
    )
