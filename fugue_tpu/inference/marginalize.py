"""Exact marginalization of enumerable discrete latents.

SURVEY.md §7 hard part 2: discrete sites inside gradient kernels. The
reference composes HMC with discrete sites by holding them fixed
(Metropolis-within-Gibbs, reference: src/inference/hmc.rs:69-71); the
Upgrade for *enumerable* discrete structure (mixture indicators,
Bernoulli switches, small integer ranges) is to sum them out exactly:

    log p(x, theta) = logsumexp_k  log p(x, theta, d = a_k)

over the cartesian product ``a_1..a_K`` of every discrete element's finite
domain. The resulting marginal joint is smooth in the continuous latents, so
HMC/NUTS gradients see the full mixture geometry (no stuck indicator modes),
and VI no longer rejects the model. The per-assignment replays are one
``vmap`` over a static (K, ...) assignment table — XLA batches the K model
evaluations exactly like K chains.

``MarginalizedModel`` presents the discrete-free ``StagedModel`` interface,
so every continuous engine (``hmc_chain``, ``nuts_chain``, ``adaptive_mcmc_
chain``, ``optimize_meanfield_vi``, ``map_estimate``) runs on it UNCHANGED
via their ``staged=`` argument. The discrete posterior is recovered exactly
afterwards from the enumeration weights (``discrete_posterior`` /
``infer_discrete``) — the same two-phase scheme as numpyro's
enumerate-then-``infer_discrete``, built here on fugue's staging runtime.

Non-enumerable discrete sites (unbounded counts: Poisson, Geometric) raise a
typed error — use ``gibbs_chain`` for those (inference/gibbs.py).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import settings
from ..core.numerics import log_sum_exp
from ..core.rng import chain_keys
from ..errors import ErrorCode, StagingError
from ..runtime.staging import Site, StagedModel, stage

_DEFAULT_MAX_STATES = 4096


def _site_domain(site: Site) -> Optional[np.ndarray]:
    """Finite per-element domain of a discrete site, or None if unbounded."""
    s = site.support
    if s.kind == "boolean":
        return np.array([False, True])
    if s.kind in ("categorical", "int_range"):
        if s.low is None or s.high is None:
            return None
        return np.arange(int(s.low), int(s.high) + 1)
    return None  # count etc.: unbounded


class MarginalizedModel:
    """A staged model with every discrete latent summed out exactly.

    Exposes the continuous-engine surface of ``StagedModel`` (``dim``,
    ``potential``, ``log_joint_unconstrained``, ``log_joint``, ``constrain``,
    ``unconstrain``, ``initial_position``, ``cached_kernel``, ...) where all
    densities are the exact discrete-marginal. ``sites``/``discrete_sites``
    report only continuous sites, so engines treat the model as fully
    continuous. Unknown attributes delegate to the wrapped ``StagedModel``.
    """

    def __init__(self, staged: StagedModel, *, max_states: int = _DEFAULT_MAX_STATES):
        self._inner = staged
        self._marg_sites: List[Site] = list(staged.discrete_sites)
        if not self._marg_sites:
            raise StagingError(
                ErrorCode.NOT_STAGEABLE,
                "model has no discrete latent sites to marginalize",
                {"sites": [s.address for s in staged.sites]},
            )
        # per-element domains; K = prod over elements of |domain|
        elems: List[Tuple[Site, np.ndarray]] = []
        for s in self._marg_sites:
            dom = _site_domain(s)
            if dom is None:
                raise StagingError(
                    ErrorCode.NOT_STAGEABLE,
                    f"discrete site {s.address!r} has unbounded support "
                    f"{s.support.kind!r} — not enumerable; use gibbs_chain "
                    "(inference/gibbs.py) for unbounded counts",
                    {"site": s.address, "support": s.support.kind},
                )
            for _ in range(s.size):
                elems.append((s, dom))
        n_states = 1
        for _, dom in elems:
            n_states *= len(dom)
            if n_states > max_states:
                raise StagingError(
                    ErrorCode.NOT_STAGEABLE,
                    f"enumeration needs {n_states}+ joint states "
                    f"(> max_states={max_states}); marginalize fewer sites "
                    "or raise max_states",
                    {"n_elements": len(elems)},
                )
        self.n_states = n_states

        # static assignment table: address -> (K, *shape) array of values.
        # Mixed-radix unrolling: element e cycles with period prod(|dom|) of
        # the elements after it (row-major cartesian product).
        idx = np.arange(n_states)
        period = n_states
        cols: List[np.ndarray] = []
        for _, dom in elems:
            period //= len(dom)
            cols.append(dom[(idx // period) % len(dom)])
        self._assignments: Dict[str, Any] = {}
        ci = 0
        for s in self._marg_sites:
            ref = np.asarray(staged._discovery_trace.choices[s.address].value)
            vals = np.stack(cols[ci:ci + s.size], axis=-1).astype(ref.dtype)
            ci += s.size
            self._assignments[s.address] = jnp.asarray(
                vals.reshape((n_states,) + s.shape)
            )
        self._kernel_cache: Dict[Any, Any] = {}
        # shadow the inner model's MH packed-proposal metadata: it is built
        # for the INNER site list (which includes the discrete sites being
        # marginalized here) and must never leak through __getattr__
        self._mh_packed_meta = None

    # -- discrete-free site table -------------------------------------------

    @property
    def sites(self):
        return self._inner.continuous_sites

    @property
    def continuous_sites(self):
        return self._inner.continuous_sites

    @property
    def discrete_sites(self):
        return []

    @property
    def marginalized_sites(self) -> List[Site]:
        return self._marg_sites

    def cached_kernel(self, cache_key, builder: Callable[[], Any]):
        # own cache: kernels built against the MARGINAL density must never
        # collide with kernels the inner staged model built for the raw one
        if cache_key not in self._kernel_cache:
            self._kernel_cache[cache_key] = builder()
        return self._kernel_cache[cache_key]

    def sample_prior(self, key) -> Dict[str, Any]:
        lat = self._inner.sample_prior(key)
        return {s.address: lat[s.address] for s in self._inner.continuous_sites}

    # -- marginal densities --------------------------------------------------

    def _per_state_log_joint_z(self, z):
        """(K,) log p(x, theta(z), d=a_k) + log|J| for every assignment."""
        return jax.vmap(
            lambda disc: self._inner.log_joint_unconstrained(z, disc)
        )(self._assignments)

    def _per_state_log_joint(self, latents: Dict[str, Any]):
        cont = {
            s.address: latents[s.address] for s in self._inner.continuous_sites
        }
        return jax.vmap(
            lambda disc: self._inner.log_joint({**cont, **disc})
        )(self._assignments)

    def log_joint_unconstrained(self, z, discrete: Optional[Dict[str, Any]] = None):
        if discrete:
            raise StagingError(
                ErrorCode.NOT_STAGEABLE,
                "marginalized model takes no discrete values — they are "
                "summed out",
                {"given": sorted(discrete)},
            )
        return log_sum_exp(self._per_state_log_joint_z(z))

    def potential(self, z, discrete: Optional[Dict[str, Any]] = None):
        return -self.log_joint_unconstrained(z, discrete)

    def log_joint(self, latents: Dict[str, Any]):
        return log_sum_exp(self._per_state_log_joint(latents))

    def log_density_parts(self, latents):
        raise StagingError(
            ErrorCode.NOT_STAGEABLE,
            "prior/likelihood/factor accumulators do not decompose under "
            "discrete marginalization (only the total joint is defined); "
            "for tempered SMC write the logsumexp as an explicit factor() "
            "in the model instead",
            {},
        )

    def log_density_parts_unconstrained(self, z, discrete=None):
        self.log_density_parts(None)

    # -- discrete-posterior recovery ----------------------------------------

    def _state_log_weights(self, latents: Dict[str, Any]):
        lj = self._per_state_log_joint(latents)
        return lj - log_sum_exp(lj)

    def discrete_posterior(self, latents: Dict[str, Any]) -> Dict[str, Any]:
        """Exact conditional p(d | theta, x) for ONE continuous draw.

        Returns, per marginalized site, an array of per-element category
        probabilities with shape ``(*site.shape, |domain|)`` (boolean sites:
        the last axis is [P(False), P(True)]).
        """
        w = jnp.exp(self._state_log_weights(latents))
        out: Dict[str, Any] = {}
        for s in self._marg_sites:
            dom = jnp.asarray(_site_domain(s))
            vals = self._assignments[s.address]  # (K, *shape)
            onehot = (vals[..., None] == dom).astype(settings.real_dtype())
            out[s.address] = jnp.tensordot(w, onehot, axes=([0], [0]))
        return out

    def infer_discrete(self, key, samples: Dict[str, Any]) -> Dict[str, Any]:
        """Draw discrete sites from their exact conditionals, one per
        continuous posterior draw — completing marginalized HMC/NUTS output
        to a full joint posterior sample.

        ``samples``: address → array with any leading batch dims (e.g. the
        engines' ``(n_chains, n_samples, *shape)``). Returns address →
        values with the same leading dims for every marginalized site.
        """
        cont_sites = self._inner.continuous_sites
        first = samples[cont_sites[0].address]
        batch = first.shape[: first.ndim - len(cont_sites[0].shape)]
        n = int(np.prod(batch)) if batch else 1
        flat = {
            s.address: jnp.reshape(
                samples[s.address], (n,) + s.shape
            )
            for s in cont_sites
        }

        def one(k, lat):
            logw = self._state_log_weights(lat)
            ki = jax.random.categorical(k, logw)
            return {
                a: v[ki] for a, v in self._assignments.items()
            }

        draw = self.cached_kernel(
            ("infer_discrete",),
            lambda: jax.jit(jax.vmap(one)),
        )
        out = draw(chain_keys(key, n), flat)
        return {
            a: jnp.reshape(v, batch + v.shape[1:]) for a, v in out.items()
        }

    def __getattr__(self, name):
        # delegate everything structural (dim, constrain, unconstrain,
        # initial_position, site/site_index, model_fn, ...) to the inner
        # staged model
        return getattr(self._inner, name)


def marginalize(
    model_fn: Optional[Callable] = None,
    *model_args,
    staged: Optional[StagedModel] = None,
    max_states: int = _DEFAULT_MAX_STATES,
    **model_kwargs,
) -> MarginalizedModel:
    """Stage ``model_fn`` and sum out its enumerable discrete latents.

    >>> marg = marginalize(gmm_model)
    >>> res = hmc_chain(key, staged=marg, n_chains=1024)       # smooth target
    >>> zs = marg.infer_discrete(key2, res.samples)            # exact p(d|theta,x)
    """
    if staged is None:
        staged = stage(model_fn, *model_args, **model_kwargs)
    return MarginalizedModel(staged, max_states=max_states)
