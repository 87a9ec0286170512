"""Staging: one discovery run → pure, vectorized array programs.

This is the architectural pivot of this build (SURVEY.md §7): the
reference re-interprets the model AST node-by-node for every transition
(``run`` trampoline, src/runtime/handler.rs:124-209 — O(#sites) dispatches
per model run). Here a model is executed ONCE with a tracing handler to
discover its ``SiteTable`` (ordered sites, dtype kinds, supports, shapes);
from then on everything is a pure function of flat arrays:

- ``sample_prior(key)``        → latent dict (jit, vmap over chains for free)
- ``log_density_parts(latents)`` → (log_prior, log_likelihood, log_factors)
  — preserving the reference Trace's three-accumulator split (trace.rs:198)
- ``log_joint(latents)``       → scalar
- ``potential(z)``             → -log p on *unconstrained* R^d via the
  per-site transforms, with log-Jacobian corrections; ``jax.grad`` of this is
  what replaces the reference's (L+1)·2d finite-difference model runs per HMC
  proposal (hmc.rs:301-329).

The model function must have *static structure*: the set of sample/observe
addresses may not depend on sampled values (XLA requirement; the reference's
open-universe RJMCMC traces are handled separately via bounded-branch masking
— SURVEY.md §7 hard part 1). Structure violations surface as typed staging
errors when the site table observed during a replay disagrees with discovery.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import settings
from ..core.distributions import Support
from ..core.transforms import Transform, transform_for_support
from ..errors import StagingError, ErrorCode
from .handler import run
from .interpreters import PriorHandler, ValuesHandler
from .trace import Trace


@dataclass(frozen=True)
class Site:
    """Static metadata for one latent site (the staged analog of an
    ``Address → Choice`` trace entry)."""

    address: str
    support: Support
    shape: Tuple[int, ...]
    kind: str  # real | bool | int
    size: int  # number of scalar elements

    @property
    def is_continuous(self) -> bool:
        return self.support.is_continuous

    @property
    def z_shape(self) -> Tuple[int, ...]:
        """Shape of the site's UNCONSTRAINED parameterization. Differs from
        ``shape`` only for dimension-changing transforms (simplex sites:
        stick-breaking maps k components to k-1 free coordinates)."""
        if self.support.kind == "simplex":
            return tuple(self.shape[:-1]) + (self.support.size - 1,)
        return tuple(self.shape)

    @property
    def z_size(self) -> int:
        return int(np.prod(self.z_shape)) if self.z_shape else 1


@dataclass
class LogDensityParts:
    """The three reference accumulators (trace.rs:31-43) as JAX scalars."""

    log_prior: Any
    log_likelihood: Any
    log_factors: Any

    def total(self):
        return self.log_prior + self.log_likelihood + self.log_factors


class StagedModel:
    """A model compiled to array programs over a fixed site table."""

    def __init__(self, model_fn: Callable, args: tuple = (), kwargs: dict = None,
                 discovery_key=None):
        self.model_fn = model_fn
        self.args = args
        self.kwargs = kwargs or {}
        if discovery_key is None:
            discovery_key = jax.random.PRNGKey(0)
        self._discover(discovery_key)

    # -- discovery ----------------------------------------------------------

    def _discover(self, key) -> None:
        _, trace = run(PriorHandler(key), self.model_fn, *self.args, **self.kwargs)
        sites: List[Site] = []
        for a in sorted(trace.choices.keys()):
            c = trace.choices[a]
            if c.is_observed:
                continue
            shape = tuple(jnp.shape(c.value))
            sites.append(
                Site(
                    address=a,
                    support=c.support,
                    shape=shape,
                    kind=c.kind,
                    size=int(np.prod(shape)) if shape else 1,
                )
            )
        self.sites: List[Site] = sites
        self.site_index: Dict[str, int] = {s.address: i for i, s in enumerate(sites)}
        self.continuous_sites = [s for s in sites if s.is_continuous]
        self.discrete_sites = [s for s in sites if not s.is_continuous]
        self.observed_addresses = sorted(
            a for a, c in trace.choices.items() if c.is_observed
        )
        # static transform table, used only where a support-keyed transform
        # suffices; the constrain/unconstrain paths rebuild transforms from
        # the runtime distribution at every replay (ConstrainHandler), which
        # is what makes dependent bounds (Uniform(0, a)) exact
        self._transforms: Dict[str, Transform] = {
            s.address: transform_for_support(s.support) for s in self.continuous_sites
        }
        # flat CONSTRAINED layout over continuous sites (address-sorted,
        # reference BTreeMap-order parity)
        self._offsets: Dict[str, Tuple[int, int]] = {}
        off = 0
        for s in self.continuous_sites:
            self._offsets[s.address] = (off, off + s.size)
            off += s.size
        self.constrained_dim = off
        # flat UNCONSTRAINED layout (z); sizes differ for simplex sites
        self._z_offsets: Dict[str, Tuple[int, int]] = {}
        zoff = 0
        for s in self.continuous_sites:
            self._z_offsets[s.address] = (zoff, zoff + s.z_size)
            zoff += s.z_size
        self.dim = zoff
        self._discovery_trace = trace
        self._kernel_cache: Dict[Any, Any] = {}

    # -- large data as runtime arguments ------------------------------------
    #
    # Array-valued stage() arguments above this size flow into compiled
    # drives as TRACED ARGUMENTS instead of baked closure constants. Baked
    # constants are embedded in the program at compile time, so a 200 MB
    # design matrix would be copied into every compiled drive and into the
    # persistent compile cache, and new data would force a recompile. Pass
    # big observed data through ``stage(model_fn, X, y)`` (NOT via closure
    # capture) to get this.

    DATA_ARG_BYTES = 1 << 20  # 1 MiB

    def _data_info(self, min_bytes: Optional[int] = None):
        if min_bytes is None:
            min_bytes = self.DATA_ARG_BYTES
        cache = getattr(self, "_data_cache", None)
        if cache is None:
            cache = self._data_cache = {}
        if min_bytes not in cache:
            leaves, treedef = jax.tree_util.tree_flatten(
                (self.args, self.kwargs)
            )
            idx = [
                i for i, x in enumerate(leaves)
                if hasattr(x, "nbytes") and hasattr(x, "dtype")
                and int(x.nbytes) >= min_bytes
            ]
            cache[min_bytes] = (leaves, treedef, idx)
        return cache[min_bytes]

    def data_leaves(self, min_bytes: Optional[int] = None) -> list:
        """The large array leaves of the staged model's arguments (possibly
        empty) — drives pass these as jit arguments and rebind them for the
        duration of tracing via ``bind_data``. ``min_bytes=0`` selects
        EVERY array leaf (used by harnesses that substitute whole datasets,
        e.g. simulation-based calibration)."""
        leaves, _treedef, idx = self._data_info(min_bytes)
        return [leaves[i] for i in idx]

    @contextlib.contextmanager
    def bind_data(self, new_leaves, min_bytes: Optional[int] = None):
        """Swap (traced) replacements for the selected data leaves into
        ``self.args``/``self.kwargs`` while a drive is being traced, so the
        model replays see tracers instead of concrete constants."""
        leaves, treedef, idx = self._data_info(min_bytes)
        if not idx:
            yield
            return
        new_leaves = list(new_leaves)
        if len(new_leaves) != len(idx):
            # the zip below pairs positionally — a silent length mismatch
            # (e.g. a caller flattening a template that carries non-array
            # leaves the nbytes/dtype filter skipped) would bind the wrong
            # arrays to the wrong slots (ADVICE r3)
            raise StagingError(
                ErrorCode.NOT_STAGEABLE,
                "bind_data got a different number of replacement leaves "
                "than the staged model's selected data leaves; pass "
                "replacements for exactly data_leaves(min_bytes)",
                {"expected": len(idx), "got": len(new_leaves)},
            )
        patched = list(leaves)
        for i, x in zip(idx, new_leaves):
            patched[i] = x
        old = (self.args, self.kwargs)
        self.args, self.kwargs = jax.tree_util.tree_unflatten(
            treedef, patched
        )
        try:
            yield
        finally:
            self.args, self.kwargs = old

    def cached_kernel(self, cache_key, builder: Callable[[], Any]):
        """Engine-kernel cache: compiled drive programs are keyed by their
        static configuration so repeated engine calls on the same staged
        model reuse the XLA executable instead of re-tracing (the staged
        analog of the reference's cached site list + cached score, FG-11/12)."""
        if cache_key not in self._kernel_cache:
            self._kernel_cache[cache_key] = builder()
        return self._kernel_cache[cache_key]

    # -- array programs -----------------------------------------------------

    def sample_prior(self, key) -> Dict[str, Any]:
        """Fresh prior draw of every latent, as an address→array dict.

        Pure function of the key: vmap it over split keys for a batch of
        chains (replaces one sequential PriorHandler run per chain).
        """
        _, trace = run(PriorHandler(key), self.model_fn, *self.args, **self.kwargs)
        return trace.latents()

    def prior_trace(self, key) -> Trace:
        _, trace = run(PriorHandler(key), self.model_fn, *self.args, **self.kwargs)
        return trace

    def log_density_parts(self, latents: Dict[str, Any]) -> LogDensityParts:
        """Replay with the given latent values; score everything.

        The staged collapse of Replay/ScoreGivenTrace
        (interpreters.rs:408-478): one jit-able function of arrays.
        """
        _, trace = run(
            ValuesHandler(latents), self.model_fn, *self.args, **self.kwargs
        )
        return LogDensityParts(
            trace.log_prior, trace.log_likelihood, trace.log_factors
        )

    def log_joint(self, latents: Dict[str, Any]):
        return self.log_density_parts(latents).total()

    def replay_trace(self, latents: Dict[str, Any]) -> Trace:
        _, trace = run(
            ValuesHandler(latents), self.model_fn, *self.args, **self.kwargs
        )
        return trace

    def replay(self, latents: Dict[str, Any]):
        """Replay with given latents → (model return value, trace). The
        return value is the staged analog of ``run(...).0`` — for ABC it is
        the simulated dataset."""
        return run(ValuesHandler(latents), self.model_fn, *self.args, **self.kwargs)

    def simulate(self, key):
        """Fresh prior execution → (model return value, latent dict). The
        likelihood-free simulator primitive (jit/vmap-able)."""
        result, trace = run(
            PriorHandler(key), self.model_fn, *self.args, **self.kwargs
        )
        return result, trace.latents()

    def replay_partial(self, key, values: Dict[str, Any]):
        """Replay with SOME latents pinned to ``values``; the rest (e.g.
        simulator noise sites) are drawn fresh from the prior — the staged
        ReplayHandler semantics (interpreters.rs:408-427) as an array
        program. Returns (result, trace)."""
        from .interpreters import PartialValuesHandler

        return run(
            PartialValuesHandler(key, values),
            self.model_fn, *self.args, **self.kwargs,
        )

    # -- constrained flat layout (no transforms; ABC perturbation space) ----

    def flatten_constrained(self, latents: Dict[str, Any]):
        parts = [
            jnp.ravel(jnp.asarray(latents[s.address], settings.real_dtype()))
            for s in self.continuous_sites
        ]
        if not parts:
            return jnp.zeros((0,), settings.real_dtype())
        return jnp.concatenate(parts)

    def unflatten_constrained(self, vec) -> Dict[str, Any]:
        out = {}
        for s in self.continuous_sites:
            lo, hi = self._offsets[s.address]
            out[s.address] = vec[lo:hi].reshape(s.shape)
        return out

    # -- flat unconstrained parameterization (continuous sites) -------------

    def _split_z(self, z) -> Dict[str, Any]:
        return {
            s.address: z[self._z_offsets[s.address][0]:
                         self._z_offsets[s.address][1]].reshape(s.z_shape)
            for s in self.continuous_sites
        }

    def _constrain_run(self, z, discrete: Optional[Dict[str, Any]] = None):
        """One model replay in unconstrained space → (trace, Σ log|J|).

        Transforms are rebuilt from each site's RUNTIME distribution
        (ConstrainHandler), so dependent bounds — ``Uniform(0, a)`` with
        ``a`` an earlier site — use the current bound values, never
        staging-discovery constants (VERDICT r1 item 6)."""
        from .interpreters import ConstrainHandler

        other = dict(discrete) if discrete else {}
        for s in self.discrete_sites:
            other.setdefault(
                s.address, self._discovery_trace.choices[s.address].value
            )
        h = ConstrainHandler(self._split_z(z), other)
        _, trace = run(h, self.model_fn, *self.args, **self.kwargs)
        return trace, h.logdet

    def constrain(self, z, discrete: Optional[Dict[str, Any]] = None
                  ) -> Tuple[Dict[str, Any], Any]:
        """Unconstrained flat vector z → (constrained latent dict, Σ log|J|).

        Implemented as a model replay so runtime (possibly dependent)
        supports transform exactly; under jit the density computations this
        also produces are dead-code-eliminated when unused."""
        trace, logdet = self._constrain_run(z, discrete)
        lat = trace.latents()
        return (
            {s.address: lat[s.address] for s in self.continuous_sites},
            logdet,
        )

    def unconstrain(self, latents: Dict[str, Any],
                    discrete: Optional[Dict[str, Any]] = None):
        """Constrained latent dict → flat unconstrained vector z (exact
        inverse of ``constrain``, including dependent bounds)."""
        from .interpreters import UnconstrainHandler

        values = self.merge_discrete(dict(latents), discrete)
        h = UnconstrainHandler(values)
        run(h, self.model_fn, *self.args, **self.kwargs)
        parts = [
            jnp.ravel(h.z_out[s.address]) for s in self.continuous_sites
        ]
        if not parts:
            return jnp.zeros((0,), settings.real_dtype())
        return jnp.concatenate(parts)

    def merge_discrete(self, cont: Dict[str, Any],
                       discrete: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        merged = dict(cont)
        if discrete:
            merged.update(discrete)
        for s in self.discrete_sites:
            merged.setdefault(
                s.address, self._discovery_trace.choices[s.address].value
            )
        return merged

    def log_density_parts_unconstrained(
        self, z, discrete: Optional[Dict[str, Any]] = None
    ) -> Tuple[LogDensityParts, Any]:
        """(density parts, Σ log|J|) in ONE model replay — the fused form of
        ``constrain`` + ``log_density_parts`` for tempered/β targets."""
        trace, logdet = self._constrain_run(z, discrete)
        return (
            LogDensityParts(
                trace.log_prior, trace.log_likelihood, trace.log_factors
            ),
            logdet,
        )

    def log_joint_unconstrained(self, z, discrete: Optional[Dict[str, Any]] = None):
        """log p(x(z), discrete) + log|J(z)| — the target for HMC/NUTS.
        One model replay (the previous implementation ran the transforms and
        the replay separately)."""
        parts, logdet = self.log_density_parts_unconstrained(z, discrete)
        return parts.total() + logdet

    def potential(self, z, discrete: Optional[Dict[str, Any]] = None):
        """U(z) = -(log p + log|J|). ``jax.grad(potential)`` replaces the
        reference's central-finite-difference force loop (hmc.rs:304-329)."""
        return -self.log_joint_unconstrained(z, discrete)

    def initial_position(self, key) -> Any:
        """Prior draw mapped to the unconstrained space."""
        return self.unconstrain(self.sample_prior(key))

    # -- structured <-> flat convenience ------------------------------------

    def flat_to_dict(self, z) -> Dict[str, Any]:
        cont, _ = self.constrain(z)
        return cont

    def site(self, address: str) -> Site:
        i = self.site_index.get(str(address))
        if i is None:
            raise StagingError(
                ErrorCode.NOT_STAGEABLE,
                f"unknown site {address!r}",
                {"known": [s.address for s in self.sites]},
            )
        return self.sites[i]


def stage(model_fn: Callable, *args, discovery_key=None, **kwargs) -> StagedModel:
    """Stage a model function into array programs (see module docstring)."""
    return StagedModel(model_fn, args, kwargs, discovery_key=discovery_key)
