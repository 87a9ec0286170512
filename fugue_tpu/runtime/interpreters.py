"""The concrete handler zoo.

Capability parity with the reference interpreters (reference:
src/runtime/interpreters.rs — PriorHandler:355-372, ReplayHandler:408-427,
ScoreGivenTrace:461-478 (fresh-logp semantics, FG-48),
SafeReplayHandler/SafeScoreGivenTrace:514-589, StrictScoreGivenTrace:606-679,
ReconcilingScoreGivenTrace:683-799, duplicate-address detection:23-45 FG-47).

All structural decisions (address present? dtype matches? duplicate?) happen
at Python trace time, so they work identically outside and inside ``jit``;
only *values* are traced arrays. "Safe" variants degrade mismatches to
``-inf`` log-weight plus a warning instead of raising — the compiled-code
analog of the reference's recoverable handlers.

Keys: handlers that draw randomness derive a per-site key via
``fold_in(run_key, crc32(address))`` (core/rng.py), giving order- and
layout-independent reproducibility.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Set

import jax
import jax.numpy as jnp

from ..core.rng import site_key
from ..errors import (
    address_conflict,
    trace_address_not_found,
    type_mismatch,
    unexpected_structure,
)
from .handler import Handler
from .trace import Choice, Trace


def _accum_sum(log_prob):
    """Per-site log-prob reduction under the plate accumulation policy:
    plain XLA reduce below settings.COMPENSATED_SUM_THRESHOLD, blocked-Kahan
    compensated summation for huge plates (SURVEY.md §7 hard part 5)."""
    from .. import settings
    from ..core.numerics import compensated_sum

    if jnp.ndim(log_prob) and jnp.size(log_prob) >= settings.compensated_sum_threshold():
        return compensated_sum(log_prob)
    return jnp.sum(log_prob)


# ---------------------------------------------------------------------------
# Site-fusion scoring (r4): models authored as scalar-site loops (the
# reference's plate! style, e.g. 20 theta#i sites) emit one tiny log-prob
# subgraph per site. With FUGUE_TPU_SITE_FUSION=1, scoring handlers DEFER
# whitelisted sites and batch-evaluate each group of same-family/same-shape
# sites as ONE stacked log_prob at finish(), exactly (elementwise formulas;
# stacking adds a leading site axis that broadcasts like the unstacked
# call). Per-site Choice.log_prob values are recovered by a per-site reduce
# of the stacked result, so the Trace API is unchanged; only floating-point
# accumulation ORDER differs. Huge plates (>= the compensated-sum
# threshold) stay eager to keep blocked-Kahan accumulation.
#
# DEFAULT OFF by measurement: on a 100-site model fusion cuts jaxpr ops
# 2217 -> 1483 and compile time 0.78 -> 0.52 s, but the 64-chain runtime
# REGRESSED 100 -> 165 us on CPU (the 100-operand stack outweighs the op
# savings; XLA already fuses the eager chain). Not measured on the GPU.
# Enable for compile-time-sensitive many-site models.
# ---------------------------------------------------------------------------

_FUSABLE = None


def _fusable_classes():
    global _FUSABLE
    if _FUSABLE is None:
        from ..core import distributions as d

        # elementwise-univariate families whose instance attrs are exactly
        # their stackable parameters (vars(dist) == params)
        _FUSABLE = {
            d.Normal, d.LogNormal, d.Exponential, d.Gamma, d.Beta,
            d.HalfNormal, d.HalfCauchy, d.Cauchy, d.Laplace, d.StudentT,
            d.ChiSquared, d.InverseGamma, d.Weibull, d.Uniform,
            d.BernoulliLogits, d.Bernoulli, d.Poisson,
        }
    return _FUSABLE


def _site_fusion_enabled() -> bool:
    import os

    return os.environ.get("FUGUE_TPU_SITE_FUSION", "0") == "1"


def _fusion_key(dist, value):
    """Group signature: same class + same logical value/param shapes stack
    exactly. Returns None when the site must score eagerly."""
    from .. import settings

    cls = type(dist)
    if cls not in _fusable_classes():
        return None
    vshape = jnp.shape(value)
    n = 1
    for sdim in vshape:
        n *= sdim
    if n >= settings.compensated_sum_threshold():
        return None  # huge plate: keep blocked-Kahan accumulation
    try:
        pshapes = tuple(jnp.shape(p) for p in dist._params())
    except Exception:
        return None
    for ps in pshapes:
        if len(ps) > len(vshape):
            return None  # param broadcasts ABOVE the value rank: bail out
    return (cls, vshape, pshapes)


def _batched_group_log_prob(cls, params_list, values):
    """One stacked log_prob for a group of n same-signature sites.

    ``params_list``: list over sites of the per-site _params() tuples;
    ``values``: list of per-site values. Returns the (n,) per-site summed
    log-probs."""
    vals = jnp.stack([jnp.asarray(v) for v in values])  # (n, *vshape)
    vndim = vals.ndim - 1
    proxy = object.__new__(cls)
    names = _param_attr_names(cls, params_list[0])
    for j, name in enumerate(names):
        p = jnp.stack([jnp.asarray(ps[j]) for ps in params_list])
        # right-align against the value by inserting axes after the new
        # leading site axis (the stacked analog of numpy broadcasting)
        pad = vndim - (p.ndim - 1)
        p = p.reshape(p.shape[:1] + (1,) * pad + p.shape[1:])
        setattr(proxy, name, p)
    lp = cls.log_prob(proxy, vals)  # (n, *broadcast shape)
    if lp.ndim > 1:
        lp = jnp.sum(lp, axis=tuple(range(1, lp.ndim)))
    return lp


_PARAM_NAMES_CACHE: Dict[type, tuple] = {}


def _param_attr_names(cls, params):
    """Attribute names backing _params() (cached per class by
    ``_register_param_names``, which every fused site passed through)."""
    return _PARAM_NAMES_CACHE[cls]


def _register_param_names(dist):
    cls = type(dist)
    if cls in _PARAM_NAMES_CACHE:
        return True
    params = dist._params()
    d = vars(dist)
    names = []
    for p in params:
        found = None
        for k, v in d.items():
            if v is p and k not in names:
                found = k
                break
        if found is None:
            return False
        names.append(found)
    if len(names) != len(params):
        return False
    _PARAM_NAMES_CACHE[cls] = tuple(names)
    return True


def _dist_kind(dist) -> str:
    if dist.support.kind == "boolean":
        return "bool"
    if dist.support.is_discrete:
        return "int"
    return "real"


class _RecordingHandler(Handler):
    """Shared bookkeeping: accumulator trace + duplicate detection (FG-47).

    Subclasses on the hot scoring paths set ``fuse_scoring = True`` to
    defer whitelisted sites into batched group log-probs (see the
    site-fusion block above); everything else scores eagerly and is
    bit-identical to r3 behavior."""

    fuse_scoring = False

    def __init__(self):
        self.trace = Trace()
        self._seen: Set[str] = set()
        self._pending: Dict[Any, list] = {}

    def _check_duplicate(self, addr: str) -> None:
        if addr in self._seen:
            raise address_conflict(addr)
        self._seen.add(addr)

    def _record(self, addr, value, log_prob, support, observed):
        lp_sum = _accum_sum(log_prob)
        self.trace.insert_choice(
            addr, Choice(value=value, log_prob=lp_sum, support=support, is_observed=observed)
        )
        return lp_sum

    def _score_site(self, addr, dist, value, observed):
        """Score one site into the right accumulator — fused (deferred)
        when this handler opts in and the site qualifies, eager otherwise."""
        if self.fuse_scoring and _site_fusion_enabled():
            fkey = _fusion_key(dist, value)
            if fkey is not None and _register_param_names(dist):
                choice = Choice(value=value, log_prob=None,
                                support=dist.support, is_observed=observed)
                self.trace.insert_choice(addr, choice)
                self._pending.setdefault((fkey, observed), []).append(
                    (choice, dist._params(), value)
                )
                return value
        lp = self._record(addr, value, dist.log_prob(value), dist.support,
                          observed)
        if observed:
            self.trace.log_likelihood = self.trace.log_likelihood + lp
        else:
            self.trace.log_prior = self.trace.log_prior + lp
        return value

    def _flush_fused(self):
        for ((cls, _vs, _ps), observed), items in self._pending.items():
            lp_vec = _batched_group_log_prob(
                cls, [it[1] for it in items], [it[2] for it in items]
            )
            for i, (choice, _, _) in enumerate(items):
                choice.log_prob = lp_vec[i]
            total = jnp.sum(lp_vec)
            if observed:
                self.trace.log_likelihood = self.trace.log_likelihood + total
            else:
                self.trace.log_prior = self.trace.log_prior + total
        self._pending = {}

    def on_observe(self, addr, dist, value):
        self._check_duplicate(addr)
        return self._score_site(addr, dist, value, True)

    def on_factor(self, log_weight):
        self.trace.log_factors = self.trace.log_factors + _accum_sum(log_weight)

    def finish(self) -> Trace:
        if self._pending:
            self._flush_fused()
        return self.trace


class PriorHandler(_RecordingHandler):
    """Sample fresh from the prior, score, record.

    Reference: interpreters.rs:355-372.
    """

    def __init__(self, key):
        super().__init__()
        self.key = key

    def on_sample(self, addr, dist, sample_shape):
        self._check_duplicate(addr)
        value = dist.sample(site_key(self.key, addr), sample_shape)
        lp = self._record(addr, value, dist.log_prob(value), dist.support, False)
        self.trace.log_prior = self.trace.log_prior + lp
        return value


class ReplayHandler(_RecordingHandler):
    """Reuse values from a base trace where present, else sample fresh;
    re-score everything under the current model's parameters.

    Reference: interpreters.rs:408-427.
    """

    def __init__(self, key, base: Trace):
        super().__init__()
        self.key = key
        self.base = base

    def _base_value(self, addr, dist):
        c = self.base.get_choice(addr)
        if c is None:
            return None
        if c.kind != _dist_kind(dist):
            raise type_mismatch(addr, _dist_kind(dist), c.kind)
        return c.value

    def on_sample(self, addr, dist, sample_shape):
        self._check_duplicate(addr)
        value = self._base_value(addr, dist)
        if value is None:
            value = dist.sample(site_key(self.key, addr), sample_shape)
        lp = self._record(addr, value, dist.log_prob(value), dist.support, False)
        self.trace.log_prior = self.trace.log_prior + lp
        return value


class ValuesHandler(_RecordingHandler):
    """Replay from a plain ``{address: value}`` dict (no Choice wrappers).

    This is the staging workhorse: ``log_density(positions)`` replays the
    model with latent values substituted from a flat dict — the array-program
    collapse of the reference's Replay/Score handlers (SURVEY.md §7).
    Missing addresses raise (strict) — staged models have a fixed site set.
    """

    fuse_scoring = True

    def __init__(self, values: Dict[str, Any]):
        super().__init__()
        self.values = values

    def on_sample(self, addr, dist, sample_shape):
        self._check_duplicate(addr)
        if addr not in self.values:
            raise trace_address_not_found(addr)
        return self._score_site(addr, dist, self.values[addr], False)


class ConstrainHandler(_RecordingHandler):
    """Replay with continuous latents given in UNCONSTRAINED space.

    Each continuous sample site's z-array maps through the transform built
    from the RUNTIME distribution instance (``unconstraining_transform``),
    so supports that depend on traced parameters — ``Uniform(0, a)`` with
    ``a`` an earlier site — use the CURRENT bounds and the exact Jacobian,
    never values baked at staging discovery (VERDICT r1 item 6). The summed
    log|J| accumulates on ``self.logdet``; the trace records constrained
    values as usual, so one run yields density parts AND constrained
    latents."""

    fuse_scoring = True

    def __init__(self, z_values: Dict[str, Any], other_values: Dict[str, Any]):
        super().__init__()
        self.z_values = z_values
        self.other_values = other_values
        self.logdet = 0.0

    def on_sample(self, addr, dist, sample_shape):
        self._check_duplicate(addr)
        if addr in self.z_values:
            t = dist.unconstraining_transform()
            z = self.z_values[addr]
            value = t.forward(z)
            self.logdet = self.logdet + jnp.sum(t.log_det_jacobian(z))
        elif addr in self.other_values:
            value = self.other_values[addr]
        else:
            raise trace_address_not_found(addr)
        return self._score_site(addr, dist, value, False)


class UnconstrainHandler(ValuesHandler):
    """Replay with CONSTRAINED latents, collecting each continuous site's
    inverse image under the runtime transform (the exact inverse of
    ``ConstrainHandler``, including dependent bounds)."""

    def __init__(self, values: Dict[str, Any]):
        super().__init__(values)
        self.z_out: Dict[str, Any] = {}

    def on_sample(self, addr, dist, sample_shape):
        value = super().on_sample(addr, dist, sample_shape)
        if dist.support.is_continuous:
            from .. import settings

            t = dist.unconstraining_transform()
            self.z_out[addr] = t.inverse(
                jnp.asarray(value, settings.real_dtype())
            )
        return value


class PartialValuesHandler(_RecordingHandler):
    """Replay from a plain value dict where present, sample fresh otherwise
    — the dict-based analog of ReplayHandler (used by ABC-SMC to pin
    parameter sites while redrawing simulator noise sites)."""

    def __init__(self, key, values: Dict[str, Any]):
        super().__init__()
        self.key = key
        self.values = values

    def on_sample(self, addr, dist, sample_shape):
        self._check_duplicate(addr)
        if addr in self.values:
            value = self.values[addr]
        else:
            value = dist.sample(site_key(self.key, addr), sample_shape)
        lp = self._record(addr, value, dist.log_prob(value), dist.support, False)
        self.trace.log_prior = self.trace.log_prior + lp
        return value


class PredictiveHandler(PartialValuesHandler):
    """Posterior/prior predictive execution: latent sites replay from a
    value dict (sampling fresh where absent, like PartialValuesHandler);
    ``observe`` sites DRAW a fresh value from the observation distribution
    instead of scoring the dataset — the recorded choice is the predictive
    draw.

    Reference capability: predictive simulation is done there by composing
    ReplayHandler over a posterior trace with a model whose observations are
    rewritten as samples (docs how-to); here it is a first-class handler so
    one model definition serves both inference and prediction.
    """

    def on_observe(self, addr, dist, value):
        self._check_duplicate(addr)
        batch = dist._batch_shape()
        vshape = jnp.shape(value)
        lead = vshape[: len(vshape) - len(batch)] if len(batch) else vshape
        draw = dist.sample(site_key(self.key, addr), lead)
        lp = self._record(addr, draw, dist.log_prob(draw), dist.support, True)
        self.trace.log_likelihood = self.trace.log_likelihood + lp
        return draw


class ScoreGivenTrace(_RecordingHandler):
    """Score a model against a fixed trace: no sampling; every latent must
    exist in the base trace; fresh log-probs are stored (FG-48).

    Reference: interpreters.rs:461-478 (panics on missing address — here a
    typed ``TraceAccessError`` raised at trace time).
    """

    def __init__(self, base: Trace):
        super().__init__()
        self.base = base

    def on_sample(self, addr, dist, sample_shape):
        self._check_duplicate(addr)
        c = self.base.get_choice(addr)
        if c is None:
            raise trace_address_not_found(addr)
        if c.kind != _dist_kind(dist):
            raise type_mismatch(addr, _dist_kind(dist), c.kind)
        value = c.value
        lp = self._record(addr, value, dist.log_prob(value), dist.support, False)
        self.trace.log_prior = self.trace.log_prior + lp
        return value


class SafeScoreGivenTrace(_RecordingHandler):
    """Like ScoreGivenTrace but degrades structure mismatches to a warning +
    ``-inf`` total weight instead of raising.

    Reference: interpreters.rs:514-589. A placeholder prior draw (from a fixed
    key) keeps the model executable past the mismatch; the -inf factor makes
    the trace's weight unusable, which is the point.
    """

    def __init__(self, base: Trace, warn: bool = True):
        super().__init__()
        self.base = base
        self.warn = warn
        self._poisoned = False

    def _poison(self, msg: str):
        if self.warn:
            warnings.warn(f"SafeScoreGivenTrace: {msg}; trace weight set to -inf")
        if not self._poisoned:
            self.trace.log_factors = self.trace.log_factors + (-jnp.inf)
            self._poisoned = True

    def on_sample(self, addr, dist, sample_shape):
        self._check_duplicate(addr)
        c = self.base.get_choice(addr)
        if c is None or c.kind != _dist_kind(dist):
            self._poison(
                f"missing address {addr!r}" if c is None
                else f"type mismatch at {addr!r}"
            )
            value = dist.sample(site_key(jax.random.PRNGKey(0), addr), sample_shape)
        else:
            value = c.value
        lp = self._record(addr, value, dist.log_prob(value), dist.support, False)
        self.trace.log_prior = self.trace.log_prior + lp
        return value


class SafeReplayHandler(ReplayHandler):
    """Replay that recovers from type mismatches by sampling fresh + warning.

    Reference: interpreters.rs:514-589.
    """

    def _base_value(self, addr, dist):
        c = self.base.get_choice(addr)
        if c is None:
            return None
        if c.kind != _dist_kind(dist):
            warnings.warn(
                f"SafeReplayHandler: type mismatch at {addr!r} "
                f"(trace has {c.kind}, model wants {_dist_kind(dist)}); resampling"
            )
            return None
        return c.value


class StrictScoreGivenTrace(ScoreGivenTrace):
    """ScoreGivenTrace that requires EXACT structure agreement: every model
    address must be in the trace (fresh address → typed
    ``UnexpectedModelStructure``) and every trace latent must be visited.

    Reference: interpreters.rs:606-679.
    """

    def on_sample(self, addr, dist, sample_shape):
        if self.base.get_choice(addr) is None:
            raise unexpected_structure(
                f"model sampled fresh address {addr!r} not present in trace",
                address=addr,
            )
        return super().on_sample(addr, dist, sample_shape)

    def finish(self) -> Trace:
        visited = set(self.trace.choices.keys())
        base_latents = {
            a for a, c in self.base.choices.items() if not c.is_observed
        }
        vanished = base_latents - visited
        if vanished:
            raise unexpected_structure(
                "model did not visit all trace addresses",
                vanished=sorted(vanished),
            )
        return self.trace


@dataclass
class ReconcileReport:
    """Structure-mismatch report (reference: interpreters.rs:683-799)."""

    birthed: List[str] = field(default_factory=list)
    vanished: List[str] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.birthed and not self.vanished


class ReconcilingScoreGivenTrace(_RecordingHandler):
    """RJMCMC-flavored scoring: fresh addresses are birthed from the prior,
    vanished addresses are reported — supporting structure-varying proposals.

    Reference: interpreters.rs:683-799 (``score_given_trace_reconciled``).
    """

    def __init__(self, key, base: Trace):
        super().__init__()
        self.key = key
        self.base = base
        self.report = ReconcileReport()

    def on_sample(self, addr, dist, sample_shape):
        self._check_duplicate(addr)
        c = self.base.get_choice(addr)
        if c is not None and c.kind == _dist_kind(dist):
            value = c.value
        else:
            value = dist.sample(site_key(self.key, addr), sample_shape)
            self.report.birthed.append(addr)
        lp = self._record(addr, value, dist.log_prob(value), dist.support, False)
        self.trace.log_prior = self.trace.log_prior + lp
        return value

    def finish(self) -> Trace:
        visited = set(self.trace.choices.keys())
        for a, c in self.base.choices.items():
            if not c.is_observed and a not in visited:
                self.report.vanished.append(a)
        return self.trace


# ---------------------------------------------------------------------------
# Convenience entry points matching the reference free functions
# ---------------------------------------------------------------------------


def score_given_trace(model, base: Trace, *args, **kwargs):
    from .handler import run

    return run(ScoreGivenTrace(base), model, *args, **kwargs)


def score_given_trace_safe(model, base: Trace, *args, **kwargs):
    from .handler import run

    return run(SafeScoreGivenTrace(base), model, *args, **kwargs)


def score_given_trace_strict(model, base: Trace, *args, **kwargs):
    """Reference: interpreters.rs:606-679."""
    from .handler import run

    return run(StrictScoreGivenTrace(base), model, *args, **kwargs)


def score_given_trace_reconciled(key, model, base: Trace, *args, **kwargs):
    """Reference: interpreters.rs:683-799. Returns (result, trace, report)."""
    from .handler import run

    handler = ReconcilingScoreGivenTrace(key, base)
    result, trace = run(handler, model, *args, **kwargs)
    return result, trace, handler.report
