"""Mean-field variational inference with pathwise gradients.

Capability parity with the reference VI engine (reference:
src/inference/vi.rs — support-matched families (Real→Normal,
Positive→LogNormal, Unit→Beta — FG-17) :119-126,245-279; exact Beta sampling
(FG-60) :294-364; guide = map<Address, VariationalParam> :520-523;
``from_trace`` rejects discrete latents with a typed GuideError :577-600;
deterministic address-sorted guide sampling :609-630; MC ELBO
E_q[log p − log q] :639-669; optimization with decayed steps on location AND
scale with clamps (FG-04) :784-864; ELBO-plateau convergence windows (FG-44)
:812-821; prior-guide ``estimate_elbo`` (FG-46) :905-923).

Array-program re-design (SURVEY.md §3.5): the reference computes ELBO gradients
by central finite differences with common random numbers — 4·|params|·
n_samples model runs per iteration (vi.rs:687-725). Here the guide is
reparameterized, so ONE ``jax.grad`` of the vmapped MC-ELBO gives all
parameter gradients at once (CRN machinery unnecessary — the pathwise
estimator is deterministic in the base noise by construction). Families:
Normal via location-scale, LogNormal via exp, Beta via two Gammas
(G1/(G1+G2)) using JAX's implicitly-reparameterized gamma sampler — exact
Beta guides as in the reference, still fully differentiable.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import settings
from ..core.rng import chain_keys
from ..errors import ErrorCode, FugueError
from ..runtime.staging import StagedModel, stage


class GuideError(FugueError):
    """Unsupported guide construction (reference: vi.rs:577-600)."""


# ---------------------------------------------------------------------------
# Variational families (reference: vi.rs:119-126,245-364)
# ---------------------------------------------------------------------------


class Family:
    """One mean-field factor. Params are unconstrained arrays; ``sample`` is
    reparameterized (differentiable w.r.t. params); ``log_prob`` is the
    entropy side of the ELBO."""

    n_params = 2

    def init(self, shape):
        raise NotImplementedError

    def sample(self, key, params, shape):
        raise NotImplementedError

    def log_prob(self, params, x):
        raise NotImplementedError

    def clamp(self, params):
        return params


_LOG_2PI = float(np.log(2 * np.pi))


def _softplus(x):
    return jax.nn.softplus(x)


def _inv_softplus(y):
    y = jnp.asarray(y)
    return jnp.where(y > 20.0, y, jnp.log(jnp.expm1(jnp.minimum(y, 20.0))))


class NormalFamily(Family):
    """Real support: N(loc, softplus(raw_scale)) (vi.rs Real→Normal)."""

    def init(self, shape, loc=0.0, scale=1.0):
        dt = settings.real_dtype()
        return {
            "loc": jnp.full(shape, loc, dt),
            "raw_scale": jnp.full(shape, float(_inv_softplus(scale)), dt),
        }

    def sample(self, key, params, shape):
        eps = jax.random.normal(key, shape, settings.real_dtype())
        return params["loc"] + _softplus(params["raw_scale"]) * eps

    def log_prob(self, params, x):
        s = _softplus(params["raw_scale"])
        z = (x - params["loc"]) / s
        return -0.5 * z * z - jnp.log(s) - 0.5 * _LOG_2PI

    def entropy(self, params):
        s = _softplus(params["raw_scale"])
        return jnp.sum(0.5 * (1.0 + _LOG_2PI) + jnp.log(s))

    def clamp(self, params):
        # scale clamps (reference FG-04: vi.rs:101-109,457-483)
        return {
            "loc": jnp.clip(params["loc"], -1e6, 1e6),
            "raw_scale": jnp.clip(params["raw_scale"], _inv_softplus(1e-6), _inv_softplus(1e3)),
        }


class LogNormalFamily(Family):
    """Positive support: LogNormal(loc, softplus(raw_scale))."""

    def init(self, shape, loc=0.0, scale=1.0):
        dt = settings.real_dtype()
        return {
            "loc": jnp.full(shape, loc, dt),
            "raw_scale": jnp.full(shape, float(_inv_softplus(scale)), dt),
        }

    def sample(self, key, params, shape):
        eps = jax.random.normal(key, shape, settings.real_dtype())
        return jnp.exp(params["loc"] + _softplus(params["raw_scale"]) * eps)

    def log_prob(self, params, x):
        s = _softplus(params["raw_scale"])
        lx = jnp.log(x)
        z = (lx - params["loc"]) / s
        return -lx - jnp.log(s) - 0.5 * _LOG_2PI - 0.5 * z * z

    def entropy(self, params):
        s = _softplus(params["raw_scale"])
        return jnp.sum(params["loc"] + 0.5 * (1.0 + _LOG_2PI) + jnp.log(s))

    def clamp(self, params):
        return {
            "loc": jnp.clip(params["loc"], -30.0, 30.0),
            "raw_scale": jnp.clip(params["raw_scale"], _inv_softplus(1e-6), _inv_softplus(50.0)),
        }


class BetaFamily(Family):
    """Unit support: Beta(exp(raw_a), exp(raw_b)) — exact Beta guide
    (reference FG-17/FG-60), reparameterized through JAX's implicitly
    differentiable gamma sampler: X = G_a / (G_a + G_b). Log-space raw
    parameters keep the concentration direction well-conditioned (a 1→14
    move is a 2.6-unit raw step, not 13)."""

    def init(self, shape, a=1.0, b=1.0):
        dt = settings.real_dtype()
        return {
            "raw_a": jnp.full(shape, float(np.log(a)), dt),
            "raw_b": jnp.full(shape, float(np.log(b)), dt),
        }

    def sample(self, key, params, shape):
        ka, kb = jax.random.split(key)
        a = jnp.exp(params["raw_a"])
        b = jnp.exp(params["raw_b"])
        dt = settings.real_dtype()
        g1 = jax.random.gamma(ka, jnp.broadcast_to(a, shape), dtype=dt)
        g2 = jax.random.gamma(kb, jnp.broadcast_to(b, shape), dtype=dt)
        x = g1 / (g1 + g2)
        return jnp.clip(x, 1e-6, 1.0 - 1e-6)

    def log_prob(self, params, x):
        from jax.scipy.special import betaln

        a = jnp.exp(params["raw_a"])
        b = jnp.exp(params["raw_b"])
        return (a - 1) * jnp.log(x) + (b - 1) * jnp.log1p(-x) - betaln(a, b)

    def entropy(self, params):
        from jax.scipy.special import betaln, digamma

        a = jnp.exp(params["raw_a"])
        b = jnp.exp(params["raw_b"])
        h = (
            betaln(a, b)
            - (a - 1) * digamma(a)
            - (b - 1) * digamma(b)
            + (a + b - 2) * digamma(a + b)
        )
        return jnp.sum(h)

    def clamp(self, params):
        lo, hi = float(np.log(1e-3)), float(np.log(1e4))
        return {
            "raw_a": jnp.clip(params["raw_a"], lo, hi),
            "raw_b": jnp.clip(params["raw_b"], lo, hi),
        }


def family_for_support(support) -> Family:
    """Support-matched family choice (reference: vi.rs:119-126, FG-17)."""
    if support.kind == "real":
        return NormalFamily()
    if support.kind == "positive":
        return LogNormalFamily()
    if support.kind == "unit":
        return BetaFamily()
    if support.kind == "interval" and support.low is not None:
        # affine-warped Beta
        return _IntervalBetaFamily(support.low, support.high)
    raise GuideError(
        ErrorCode.NOT_STAGEABLE,
        f"no mean-field family for support {support.kind!r} "
        "(discrete latents are rejected — reference: vi.rs:577-600; "
        "marginalize them or use MH/SMC)",
        {"support": support.kind},
    )


class _IntervalBetaFamily(BetaFamily):
    def __init__(self, low, high):
        self.low = low
        self.high = high

    def sample(self, key, params, shape):
        u = super().sample(key, params, shape)
        return self.low + (self.high - self.low) * u

    def log_prob(self, params, x):
        u = (x - self.low) / (self.high - self.low)
        return super().log_prob(params, u) - jnp.log(self.high - self.low)

    def entropy(self, params):
        return super().entropy(params) + jnp.log(self.high - self.low) * jnp.size(
            params["raw_a"]
        )


# ---------------------------------------------------------------------------
# Guide (reference: MeanFieldGuide, vi.rs:520-630)
# ---------------------------------------------------------------------------


class MeanFieldGuide:
    """Address-keyed mean-field guide over the continuous latents of a
    staged model. Params live in one pytree (address → family params), so the
    whole guide optimizes with a single optax/grad step."""

    def __init__(self, staged: StagedModel):
        if staged.discrete_sites:
            raise GuideError(
                ErrorCode.NOT_STAGEABLE,
                "model has discrete latent sites; mean-field VI requires "
                "continuous latents (reference: vi.rs:577-600)",
                {"discrete": [s.address for s in staged.discrete_sites]},
            )
        self.staged = staged
        self.sites = staged.continuous_sites
        self.families: Dict[str, Family] = {
            s.address: family_for_support(s.support) for s in self.sites
        }
        # packed-draw groups: many scalar sites of the same family share ONE
        # base-noise draw (sliced per site) instead of one fold_in+threefry
        # each — the guide-sampling op count drops from O(#sites) RNG calls
        # to O(#family kinds), which dominates the ELBO body's cost for
        # scalar-site-heavy models (all ops are latency-bound tiny tensors)
        self._ls_groups: Dict[str, list] = {"normal": [], "lognormal": []}
        self._beta_sites: list = []
        for s in self.sites:
            fam = self.families[s.address]
            if type(fam) is NormalFamily:
                self._ls_groups["normal"].append(s)
            elif type(fam) is LogNormalFamily:
                self._ls_groups["lognormal"].append(s)
            elif type(fam) in (BetaFamily, _IntervalBetaFamily):
                self._beta_sites.append(s)
            else:  # pragma: no cover — future families sample per-site
                self._beta_sites.append(None)

    def init_params(self) -> Dict[str, Dict[str, Any]]:
        return {
            s.address: self.families[s.address].init(s.shape) for s in self.sites
        }

    def sample_latents(self, key, params) -> Dict[str, Any]:
        """One reparameterized draw of all sites, packed by family kind.

        Determinism: keys derive from (key, family-kind) only, and sites are
        address-sorted within each pack (reference's deterministic
        address-sorted guide sampling, vi.rs:609-630) — the same key always
        yields the same draw regardless of execution order."""
        dt = settings.real_dtype()
        out: Dict[str, Any] = {}
        for gi, (kind, group) in enumerate(sorted(self._ls_groups.items())):
            if not group:
                continue
            total = sum(s.size for s in group)
            eps = jax.random.normal(
                jax.random.fold_in(key, gi), (total,), dt
            )
            off = 0
            for s in group:
                e = eps[off:off + s.size].reshape(s.shape)
                off += s.size
                p = params[s.address]
                x = p["loc"] + _softplus(p["raw_scale"]) * e
                out[s.address] = jnp.exp(x) if kind == "lognormal" else x
        if self._beta_sites:
            bsites = [s for s in self._beta_sites if s is not None]
            a_all = jnp.concatenate([
                jnp.broadcast_to(
                    jnp.exp(params[s.address]["raw_a"]), s.shape or (1,)
                ).reshape(-1)
                for s in bsites
            ])
            b_all = jnp.concatenate([
                jnp.broadcast_to(
                    jnp.exp(params[s.address]["raw_b"]), s.shape or (1,)
                ).reshape(-1)
                for s in bsites
            ])
            ka, kb = jax.random.split(jax.random.fold_in(key, 17))
            g1 = jax.random.gamma(ka, a_all, dtype=dt)
            g2 = jax.random.gamma(kb, b_all, dtype=dt)
            u_all = jnp.clip(g1 / (g1 + g2), 1e-6, 1.0 - 1e-6)
            off = 0
            for s in bsites:
                u = u_all[off:off + s.size].reshape(s.shape)
                off += s.size
                fam = self.families[s.address]
                if isinstance(fam, _IntervalBetaFamily):
                    u = fam.low + (fam.high - fam.low) * u
                out[s.address] = u
        return out

    def log_q(self, params, latents):
        total = jnp.zeros((), settings.real_dtype())
        for s in self.sites:
            total = total + jnp.sum(
                self.families[s.address].log_prob(params[s.address], latents[s.address])
            )
        return total

    def entropy(self, params):
        """Analytic guide entropy — removes the entropy term's MC noise from
        the ELBO gradient (variance reduction over the reference's sampled
        log q term)."""
        total = jnp.zeros((), settings.real_dtype())
        for s in self.sites:
            total = total + self.families[s.address].entropy(params[s.address])
        return total

    def clamp(self, params):
        return {
            s.address: self.families[s.address].clamp(params[s.address])
            for s in self.sites
        }

    def sample_trace(self, key, params):
        """Guide draw replayed through the model → full Trace."""
        latents = self.sample_latents(key, params)
        return self.staged.replay_trace(latents)


# ---------------------------------------------------------------------------
# ELBO + optimization (reference: vi.rs:639-923)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class VIConfig:
    """Reference: VIConfig (vi.rs:728-759)."""

    n_iterations: int = 1000
    n_samples: int = 16  # MC samples per ELBO estimate
    learning_rate: float = 0.05
    decay: float = 0.0  # Robbins-Monro exponent; 0 → constant-rate Adam
    plateau_window: int = 100
    plateau_tol: float = 1e-4
    check_every: int = 50
    optimizer: str = "adam"  # "adam" | "sgd"


@dataclass
class VIResult:
    """Reference: vi.rs:763-772."""

    params: Dict[str, Any]
    elbo_history: np.ndarray
    converged: bool
    n_iterations_run: int
    guide: MeanFieldGuide

    def final_elbo(self) -> float:
        return float(self.elbo_history[-1])

    def posterior_sample(self, key, n: int = 1):
        draws = jax.vmap(lambda k: self.guide.sample_latents(k, self.params))(
            chain_keys(key, n)
        )
        return draws


def elbo(key, guide: MeanFieldGuide, params, n_samples: int):
    """MC ELBO = E_q[log p(x, z) − log q(z)] with reparameterized draws
    (reference estimator: vi.rs:639-669; gradients now exact pathwise)."""

    def one(k):
        latents = guide.sample_latents(k, params)
        lp = guide.staged.log_joint(latents)
        lq = guide.log_q(params, latents)
        return lp - lq

    return jnp.mean(jax.vmap(one)(chain_keys(key, n_samples)))


def elbo_analytic_entropy(key, guide: MeanFieldGuide, params, n_samples: int):
    """ELBO = E_q[log p] + H(q) with the entropy computed analytically —
    same expectation as ``elbo`` but with strictly lower gradient variance
    (the optimization objective)."""

    def one(k):
        latents = guide.sample_latents(k, params)
        return guide.staged.log_joint(latents)

    return jnp.mean(jax.vmap(one)(chain_keys(key, n_samples))) + guide.entropy(params)


def estimate_elbo(key, model_fn=None, n_samples: int = 128, *, staged=None,
                  model_args: tuple = ()):
    """ELBO of the prior-initialized guide — a model-fit sanity metric
    (reference: estimate_elbo, vi.rs:905-923, FG-46)."""
    if staged is None:
        staged = stage(model_fn, *model_args)
    guide = MeanFieldGuide(staged)
    return float(np.asarray(elbo(key, guide, guide.init_params(), n_samples)))


class UnconstrainedMeanFieldGuide:
    """q(z) = N(loc, diag(scale²)) on the staged model's unconstrained R^d;
    samples map back through the (runtime) support transforms.

    The mean-field fallback for sites whose CONSTRAINED space has no
    factorized family: interval supports with traced/dependent bounds
    (``Uniform(0, a)``) and simplex (Dirichlet) sites. Because ``constrain``
    rebuilds transforms from the runtime distributions, dependent bounds are
    exact here (VERDICT r1 item 6: the GuideError for this case is gone)."""

    def __init__(self, staged: StagedModel):
        if staged.discrete_sites:
            raise GuideError(
                ErrorCode.NOT_STAGEABLE,
                "model has discrete latent sites; VI requires continuous "
                "latents (reference: vi.rs:577-600)",
                {"discrete": [s.address for s in staged.discrete_sites]},
            )
        self.staged = staged
        self.d = staged.dim

    def init_params(self, scale: float = 0.5):
        dt = settings.real_dtype()
        return {
            "loc": jnp.zeros((self.d,), dt),
            "raw_scale": jnp.full((self.d,), float(_inv_softplus(scale)), dt),
        }

    def sample_z(self, key, params):
        eps = jax.random.normal(key, (self.d,), settings.real_dtype())
        return params["loc"] + _softplus(params["raw_scale"]) * eps

    def sample_latents(self, key, params):
        cont, _ = self.staged.constrain(self.sample_z(key, params))
        return cont

    def entropy(self, params):
        s = _softplus(params["raw_scale"])
        return jnp.sum(0.5 * (1.0 + _LOG_2PI) + jnp.log(s))

    def clamp(self, params):
        return {
            "loc": jnp.clip(params["loc"], -1e6, 1e6),
            "raw_scale": jnp.clip(
                params["raw_scale"], _inv_softplus(1e-6), _inv_softplus(1e3)
            ),
        }


def _meanfield_guide_for(staged: StagedModel):
    """Constrained support-matched families when every site has one
    (reference semantics); otherwise the unconstrained diagonal guide
    (traced-bound intervals, simplex sites). Discrete sites always raise."""
    if staged.discrete_sites:
        # raise the reference-parity typed error (vi.rs:577-600)
        return MeanFieldGuide(staged)
    try:
        return MeanFieldGuide(staged)
    except GuideError:
        return UnconstrainedMeanFieldGuide(staged)


# ---------------------------------------------------------------------------
# Full-rank guide (ADVI): multivariate Normal on the unconstrained flat space
# — captures posterior correlations mean-field factorization cannot.
# ---------------------------------------------------------------------------


class FullRankGuide:
    """q(z) = N(loc, L Lᵀ) over the staged model's unconstrained R^d;
    samples map back through the support transforms. Entropy is analytic
    (½d(1+log 2π) + Σ log diag L), so the ELBO objective is pathwise with no
    entropy-gradient noise."""

    def __init__(self, staged: StagedModel):
        if staged.discrete_sites:
            raise GuideError(
                ErrorCode.NOT_STAGEABLE,
                "model has discrete latent sites; full-rank VI requires "
                "continuous latents",
                {"discrete": [s.address for s in staged.discrete_sites]},
            )
        self.staged = staged
        self.d = staged.dim
        self._tril = jnp.tril_indices(self.d)

    def init_params(self, scale: float = 0.5):
        dt = settings.real_dtype()
        n_tril = self.d * (self.d + 1) // 2
        raw = jnp.zeros((n_tril,), dt)
        # diagonal entries sit at positions where row == col
        rows, cols = self._tril
        diag_mask = np.asarray(rows) == np.asarray(cols)
        raw = raw.at[jnp.asarray(np.nonzero(diag_mask)[0])].set(
            float(_inv_softplus(scale))
        )
        return {"loc": jnp.zeros((self.d,), dt), "raw_tril": raw}

    def _chol(self, params):
        dt = settings.real_dtype()
        L = jnp.zeros((self.d, self.d), dt).at[self._tril].set(
            params["raw_tril"]
        )
        diag = _softplus(jnp.diagonal(L))
        return L - jnp.diag(jnp.diagonal(L)) + jnp.diag(diag)

    def sample_z(self, key, params):
        eps = jax.random.normal(key, (self.d,), settings.real_dtype())
        return params["loc"] + self._chol(params) @ eps

    def sample_latents(self, key, params):
        cont, _ = self.staged.constrain(self.sample_z(key, params))
        return cont

    def entropy(self, params):
        L = self._chol(params)
        return 0.5 * self.d * (1.0 + _LOG_2PI) + jnp.sum(
            jnp.log(jnp.diagonal(L))
        )

    def covariance(self, params):
        L = self._chol(params)
        return L @ L.T

    def clamp(self, params):
        return {
            "loc": jnp.clip(params["loc"], -1e6, 1e6),
            "raw_tril": jnp.clip(params["raw_tril"], -1e3, 1e3),
        }


def _make_vi_program(guide, tx, loss_fn, config: "VIConfig", staged=None,
                     resume_mode: bool = False, mesh=None, chain_axes=None,
                     data_specs=None, data_min_bytes=None):
    """Compile the WHOLE optimization — Adam steps, ELBO history, and the
    plateau early-stop — into one XLA program (``lax.while_loop`` over
    ``check_every``-sized scan chunks).

    SPMD mode (``mesh`` given): the whole program runs under ``shard_map``
    over ``chain_axes``; ``loss_fn`` must return the PER-SHARD contribution
    whose ``psum`` over the axes equals the global negative ELBO (the
    sharded drivers construct such losses), and ``data_specs`` gives the
    PartitionSpecs for the staged data leaves (sharded data plates). Both
    the loss and its gradient are psum-reduced before the optimizer update,
    so every shard applies the identical update and the variational
    parameters stay bit-replicated across the mesh.

    Rationale: an earlier driver spent more per iteration on host overhead
    than on the loss — ``init_params()`` + ``tx.init()`` created ~120 tiny
    device arrays, each one a transfer, and the plateau check re-entered
    jit per chunk. Here
    parameter/optimizer initialization happens INSIDE the program (traced
    constants — zero input transfers), and the plateau check (reference
    FG-44, vi.rs:812-821) is a masked early-exit condition of the while
    loop. One ``run(key)`` call = one dispatch for the entire
    optimization."""
    import optax

    dt = settings.real_dtype()
    ce = config.check_every
    n_chunks = max(1, config.n_iterations // ce)
    hist_len = n_chunks * ce
    w = config.plateau_window
    plateau_on = 2 * w <= hist_len

    axis_names = None if mesh is None else (
        chain_axes[0] if len(chain_axes) == 1 else tuple(chain_axes)
    )

    def body(carry, k):
        params, opt_state = carry
        loss, grads = jax.value_and_grad(loss_fn)(params, k)
        if axis_names is not None:
            # explicit psum AFTER the backward pass: each shard computes its
            # local gradient contribution, the reduction makes the update
            # identical on every shard (params stay bit-replicated — the
            # scaling-book DP recipe, not grad-through-pmean)
            grads = jax.lax.psum(grads, axis_names)
            loss = jax.lax.psum(loss, axis_names)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        params = guide.clamp(params)
        return (params, opt_state), -loss

    # init values materialize ON HOST once at build time (cached with the
    # kernel) and enter the program as baked constants — zero transfers to
    # the device, at build or per call. The explicit CPU default_device
    # matters: without it every jnp op in init_params() is a round trip to
    # the accelerator.
    try:
        _host = jax.local_devices(backend="cpu")[0]
    except RuntimeError:  # pragma: no cover — no CPU backend registered
        _host = None
    if _host is not None:
        with jax.default_device(_host):
            params0 = jax.tree.map(np.asarray, guide.init_params())
    else:
        params0 = jax.tree.map(np.asarray, guide.init_params())

    def run_impl(key, dl, params_in=None):
        # resume path: the variational parameters flow in as TRACED
        # arguments (one executable serves every resumed state; the Adam
        # moments restart — documented, the schedule is fresh per segment)
        if params_in is not None:
            params = jax.tree.map(jnp.asarray, params_in)
        else:
            params = jax.tree.map(jnp.asarray, params0)
        opt_state = tx.init(params)
        hist0 = jnp.zeros((hist_len,), dt)

        def cond(carry):
            _, _, _, c, conv = carry
            return (c < n_chunks) & (~conv)

        def step(carry):
            params, opt_state, hist, c, _ = carry
            keys = jax.random.split(jax.random.fold_in(key, c), ce)
            (params, opt_state), elbos = jax.lax.scan(
                body, (params, opt_state), keys
            )
            hist = jax.lax.dynamic_update_slice(
                hist, elbos.astype(dt), (c * ce,)
            )
            total = (c + 1) * ce
            if plateau_on:
                # dynamic_slice clamps negative starts; the (total >= 2w)
                # gate makes those early garbage windows irrelevant
                recent = jnp.mean(
                    jax.lax.dynamic_slice(hist, (total - w,), (w,))
                )
                prev = jnp.mean(
                    jax.lax.dynamic_slice(hist, (total - 2 * w,), (w,))
                )
                conv = (total >= 2 * w) & (
                    jnp.abs(recent - prev)
                    / jnp.maximum(jnp.abs(prev), 1.0)
                    < config.plateau_tol
                )
            else:
                conv = jnp.asarray(False)
            return params, opt_state, hist, c + 1, conv

        params, opt_state, hist, c, conv = jax.lax.while_loop(
            cond,
            step,
            (params, opt_state, hist0, jnp.asarray(0, jnp.int32),
             jnp.asarray(False)),
        )
        # pack (history, n_done, converged) into ONE array: fetching each
        # output separately costs one device round trip apiece, which would
        # dominate short runs
        packed = jnp.concatenate([
            hist,
            jnp.asarray([c * ce], dt),
            jnp.asarray([conv], dt),
        ])
        return params, packed

    if staged is not None:
        # large stage() data arguments flow in as TRACED jit arguments
        # (StagedModel.data_leaves) instead of baked closure constants —
        # same discipline as the HMC/NUTS/ChEES/MAP drives: a big design
        # matrix as a constant travels inside the (possibly remote)
        # compile payload and re-uploads on every recompile
        if resume_mode:
            def run_raw(key, params_in, *dl):
                with staged.bind_data(dl, data_min_bytes):
                    return run_impl(key, dl, params_in)
        else:
            def run_raw(key, *dl):
                with staged.bind_data(dl, data_min_bytes):
                    return run_impl(key, dl)
    elif resume_mode:
        run_raw = lambda key, params_in: run_impl(key, (), params_in)
    else:
        run_raw = lambda key: run_impl(key, ())

    if mesh is None:
        return jax.jit(run_raw)

    # SPMD wrapping: data leaves may be sharded (data_specs), everything
    # else — key, resumed params, outputs — is replicated. A single P()
    # acts as a pytree prefix for the params dict.
    from jax.sharding import PartitionSpec as _P

    from ..parallel.sharded import _shard_map

    n_data = 0 if staged is None else len(staged.data_leaves(data_min_bytes))
    if data_specs is None:
        data_specs = tuple(_P() for _ in range(n_data))
    in_specs = (_P(),) + ((_P(),) if resume_mode else ()) + tuple(data_specs)
    mapped = _shard_map(
        run_raw, mesh, in_specs=in_specs, out_specs=(_P(), _P())
    )
    return jax.jit(mapped)


def _drive_vi(run, guide, tx, key, staged=None, resume=None,
              data_min_bytes=None) -> "VIResult":
    """Shared host-side tail: one dispatch + ONE result transfer, then
    truncate the history to the iterations that actually ran before the
    in-program early exit."""
    data = staged.data_leaves(data_min_bytes) if staged is not None else []
    if resume is not None:
        params, packed = run(key, resume.params, *data)
    else:
        params, packed = run(key, *data)
    packed = np.asarray(packed)
    n_done = int(packed[-2])
    return VIResult(
        params=params,
        elbo_history=packed[:-2][:n_done],
        converged=bool(packed[-1]),
        n_iterations_run=n_done,
        guide=guide,
    )


def optimize_fullrank_vi(
    key,
    model_fn: Optional[Callable] = None,
    config: VIConfig = VIConfig(),
    *,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    resume: Optional["VIResult"] = None,
    mesh=None,
    shard: str = "auto",
) -> VIResult:
    """Full-rank ADVI: pathwise gradients of
    E_q[log p(x(z)) + log|J|] + H(q) with annealed Adam + plateau stopping
    (same driver discipline as the mean-field path).

    ``resume``: a previous ``VIResult`` — optimization continues from its
    variational parameters (flowing in as runtime arguments, so repeated
    resumes share one executable; the Adam moments and learning-rate
    schedule restart per segment). Long runs on a dispatch-limited device
    split into several segments this way.

    ``mesh``: run the whole optimization device-parallel (delegates to
    ``parallel.sharded.sharded_vi`` with ``guide='fullrank'``; ``shard=``
    picks data-plate vs MC-sample sharding)."""
    import optax

    if staged is None:
        staged = stage(model_fn, *model_args)
    if mesh is not None:
        from ..parallel.sharded import sharded_vi

        return sharded_vi(key, config=config, mesh=mesh, guide="fullrank",
                          shard=shard, staged=staged, resume=resume)
    mode = "fresh" if resume is None else "resume"

    def build():
        guide = FullRankGuide(staged)
        t0 = max(config.n_iterations / 10.0, 1.0)
        schedule = lambda t: config.learning_rate * jnp.power(1.0 + t / t0, -0.6)
        tx = optax.adam(schedule)

        def neg_elbo(p, k):
            def one(kk):
                z = guide.sample_z(kk, p)
                return staged.log_joint_unconstrained(z)

            e = jnp.mean(
                jax.vmap(one)(chain_keys(k, config.n_samples))
            ) + guide.entropy(p)
            return -e

        return guide, tx, _make_vi_program(
            guide, tx, neg_elbo, config, staged=staged,
            resume_mode=(mode == "resume"))

    # one compiled executable per (engine, config) — never a fresh jit
    # closure per call (CLAUDE.md invariant; staged analog of FG-11/12)
    guide, tx, run = staged.cached_kernel(("vi_fullrank", config, mode),
                                          build)
    return _drive_vi(run, guide, tx, key, staged=staged, resume=resume)


def optimize_meanfield_vi(
    key,
    model_fn: Optional[Callable] = None,
    config: VIConfig = VIConfig(),
    *,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    resume: Optional["VIResult"] = None,
    mesh=None,
    shard: str = "auto",
) -> VIResult:
    """Mean-field VI driver (reference: optimize_meanfield_vi_with_config,
    vi.rs:784-864) with pathwise gradients, Adam or Robbins-Monro SGA,
    parameter clamps, and ELBO-plateau early stopping (FG-44).

    The whole optimization — including the plateau early-stop — is ONE
    compiled program (``lax.while_loop`` over ``check_every``-sized chunks),
    so a full run costs a single device dispatch.

    ``resume``: a previous ``VIResult`` — continue from its variational
    parameters (runtime arguments; Adam moments/schedule restart per
    segment). See ``optimize_fullrank_vi``.

    ``mesh``: run the whole optimization device-parallel (delegates to
    ``parallel.sharded.sharded_vi``; ``shard=`` picks data-plate vs
    MC-sample sharding).
    """
    import optax

    if staged is None:
        staged = stage(model_fn, *model_args)
    if mesh is not None:
        from ..parallel.sharded import sharded_vi

        return sharded_vi(key, config=config, mesh=mesh, guide="meanfield",
                          shard=shard, staged=staged, resume=resume)
    mode = "fresh" if resume is None else "resume"

    def build():
        guide = _meanfield_guide_for(staged)
        if config.optimizer == "adam":
            # anneal: Adam's scale-free steps otherwise jitter around the
            # optimum at the stationary phase (the Robbins-Monro condition the
            # reference satisfies via decayed steps, vi.rs:824-825).
            # Polynomial decay keeps late-phase motion alive for weakly-curved
            # directions.
            t0 = max(config.n_iterations / 10.0, 1.0)
            schedule = lambda t: config.learning_rate * jnp.power(
                1.0 + t / t0, -0.6
            )
            tx = optax.adam(schedule)
        elif config.decay > 0:
            schedule = lambda t: config.learning_rate * jnp.power(
                t + 1.0, -config.decay
            )
            tx = optax.sgd(schedule)
        else:
            tx = optax.sgd(config.learning_rate)

        if isinstance(guide, UnconstrainedMeanFieldGuide):
            # unconstrained-space ELBO: E_q[log p(x(z)) + log|J|] + H(q)
            def loss_fn(p, k):
                def one(kk):
                    z = guide.sample_z(kk, p)
                    return staged.log_joint_unconstrained(z)

                e = jnp.mean(
                    jax.vmap(one)(chain_keys(k, config.n_samples))
                ) + guide.entropy(p)
                return -e
        else:
            loss_fn = lambda p, k: -elbo_analytic_entropy(
                k, guide, p, config.n_samples
            )

        return guide, tx, _make_vi_program(
            guide, tx, loss_fn, config, staged=staged,
            resume_mode=(mode == "resume"))

    # one compiled executable per (engine, config) — never a fresh jit
    # closure per call (CLAUDE.md invariant; staged analog of FG-11/12)
    guide, tx, run = staged.cached_kernel(("vi_meanfield", config, mode),
                                          build)
    return _drive_vi(run, guide, tx, key, staged=staged, resume=resume)
