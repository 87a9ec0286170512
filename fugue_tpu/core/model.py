"""The model language: effects + monadic combinators.

Capability parity with the reference model monad (reference:
src/core/model.rs — ``Model<A>`` CPS enum :20-131, smart constructors
``pure/sample/observe/factor/guard`` :144-716, combinators
``bind/map/and_then/zip/sequence_vec/traverse_vec`` :447-680) and the surface
macros (src/macros/mod.rs — ``prob!`` do-notation :29-69, ``plate!`` :82-86).

Array-program design: instead of a CPS-encoded enum walked by a trampoline, a
model is ordinary Python code that calls the effect functions ``sample`` /
``observe`` / ``factor``; an ambient *handler stack* interprets the effects
(algebraic-effects style). Python's native sequencing IS do-notation, so
``prob!`` needs no macro; ``Model`` is kept as a thin thunk wrapper so that
all the reference combinators exist with identical semantics. Under ``jit``
the whole model executes at trace time and disappears into one XLA program —
the compiled analog of "Rust, not an interpreted AST".

Effect values may be *arrays* (a site can carry ``sample_shape``), which is
the idiomatic staged form of ``plate!``: one vectorized site instead of n scalar
sites. The scalar-loop ``plate`` is also provided for reference parity.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from .distributions import Distribution
from ..errors import unexpected_structure

# ---------------------------------------------------------------------------
# Ambient handler stack
# ---------------------------------------------------------------------------

_HANDLER_STACK: List[Any] = []


def _current_handler():
    if not _HANDLER_STACK:
        raise unexpected_structure(
            "effect used outside of a handler; run models via "
            "fugue_tpu.run(handler, model_fn, ...) or an inference engine"
        )
    return _HANDLER_STACK[-1]


class _HandlerScope:
    def __init__(self, handler):
        self.handler = handler

    def __enter__(self):
        _HANDLER_STACK.append(self.handler)
        return self.handler

    def __exit__(self, *exc):
        _HANDLER_STACK.pop()
        return False


# ---------------------------------------------------------------------------
# Branch masks (bounded-branch conditionals; see ``masked`` / ``cond``)
# ---------------------------------------------------------------------------

_MASK_STACK: List[Any] = []


def _active_mask():
    """AND of all enclosing ``masked`` regions, or None outside any."""
    if not _MASK_STACK:
        return None
    m = _MASK_STACK[0]
    for x in _MASK_STACK[1:]:
        m = jnp.logical_and(m, x)
    return m


class _MaskedDistribution:
    """Duck-typed wrapper: same sampling, log_prob zeroed where inactive.

    Applied only to *observe* sites inside ``masked`` regions; latent sites
    keep their prior density unmasked (Carlin-Chib pseudo-prior convention),
    so the extended-space joint stays proper — inactive coordinates are
    prior-distributed instead of living on an improper flat direction that
    would break HMC/NUTS geometry.
    """

    __slots__ = ("dist", "mask")

    def __init__(self, dist, mask):
        self.dist = dist
        self.mask = mask

    @property
    def support(self):
        return self.dist.support

    def sample(self, key, sample_shape=()):
        return self.dist.sample(key, sample_shape)

    def log_prob(self, value):
        lp = self.dist.log_prob(value)
        return jnp.where(self.mask, lp, jnp.zeros_like(lp))

    def __repr__(self):
        return f"Masked({self.dist!r})"


class masked:
    """Context manager: observe/factor effects inside contribute their
    log-weight only where ``condition`` is True.

    The staged form of a data-dependent branch: the region's sites always
    execute (static site table, static shapes — XLA requirement), but the
    inactive branch's likelihood and factor terms are zeroed. Latent sites
    inside keep their prior term (pseudo-prior; see ``_MaskedDistribution``),
    which leaves posterior marginals of the *active* branch exactly correct.
    Nested regions AND together. Reference context: fugue supports
    structure-varying models via RJMCMC trace reconciliation
    (interpreters.rs:683-799); bounded-branch masking is the static-shape
    counterpart for enumerable structure.
    """

    def __init__(self, condition):
        self.condition = jnp.asarray(condition)

    def __enter__(self):
        _MASK_STACK.append(self.condition)
        return self.condition

    def __exit__(self, *exc):
        _MASK_STACK.pop()
        return False


def cond(pred, true_fn: Callable[[], Any], false_fn: Optional[Callable[[], Any]] = None):
    """Bounded-branch conditional over a traced predicate.

    Runs BOTH branches (so the site table and all shapes are static under
    jit), masks each branch's observe/factor contributions by the predicate,
    and where-selects the return value leaf-wise. Branches must use distinct
    addresses. ``false_fn`` may be omitted for a one-armed conditional.

    This is the supported encoding of enumerable structure-varying models
    (SURVEY hard-part #1): unbounded/open-universe structure is out of scope
    on static-shape hardware; use ``adaptive_mcmc_chain_dynamic`` (host-side
    RJMCMC) for that.
    """
    pred = jnp.asarray(pred)
    with masked(pred):
        tv = true_fn()
    if false_fn is None:
        return tv
    with masked(jnp.logical_not(pred)):
        fv = false_fn()
    if tv is None and fv is None:
        return None
    return jax.tree_util.tree_map(
        lambda a, b: jnp.where(pred, a, b), tv, fv
    )


# ---------------------------------------------------------------------------
# Effects (reference smart constructors: model.rs:144-716)
# ---------------------------------------------------------------------------


def sample(address, dist: Distribution, sample_shape: Tuple[int, ...] = ()):
    """Draw a latent value at ``address`` from ``dist``.

    Reference: ``Model::sample`` (model.rs:258). The handler decides what
    "draw" means (fresh prior draw, replay, score-only, ...). Inside a
    ``masked`` region the site's prior term is intentionally NOT masked
    (pseudo-prior convention — see ``masked``).
    """
    return _current_handler().on_sample(str(address), dist, tuple(sample_shape))


def observe(address, dist: Distribution, value):
    """Condition on ``value`` observed from ``dist``.

    Reference: ``Model::observe`` (model.rs:397). ``value`` may be an array;
    its summed log_prob accumulates into log_likelihood. Inside a ``masked``
    region the contribution is zeroed where the mask is False.
    """
    mask = _active_mask()
    if mask is not None:
        dist = _MaskedDistribution(dist, mask)
    return _current_handler().on_observe(str(address), dist, value)


def factor(log_weight):
    """Add an arbitrary log-weight term (reference: model.rs:426). Inside a
    ``masked`` region the term is zeroed where the mask is False (via
    ``where``, so a masked ``-inf`` contributes 0, not NaN)."""
    lw = jnp.asarray(log_weight)
    mask = _active_mask()
    if mask is not None:
        lw = jnp.where(mask, lw, jnp.zeros_like(lw))
    _current_handler().on_factor(lw)


def guard(condition):
    """Hard constraint: ``factor(-inf)`` when violated (reference:
    model.rs:710-716). ``condition`` may be a traced boolean array; violations
    are folded in as masked -inf so the same code runs under jit."""
    cond = jnp.asarray(condition)
    all_ok = jnp.all(cond)
    factor(jnp.where(all_ok, 0.0, -jnp.inf))


def plate(name: str, size: int, body: Callable[[int], Any]) -> List[Any]:
    """Scalar-loop plate: ``body(i)`` under address ``name#i`` for each i.

    Reference: ``plate!`` → ``traverse_vec`` (macros/mod.rs:82-86). The body
    receives the index and is responsible for using ``addr(name, i)``-style
    addresses; this helper simply runs the loop (Python's for-loop is the
    do-notation). For large plates prefer the vectorized form:
    ``sample(name, dist, sample_shape=(size,))`` — one site, one fused kernel.
    """
    return [body(i) for i in range(size)]


# ---------------------------------------------------------------------------
# Monadic Model wrapper (combinator parity with model.rs:447-680)
# ---------------------------------------------------------------------------


class Model:
    """A first-class probabilistic computation: a thunk run under handlers.

    The reference's ``Model<A>`` is a CPS tree; here it is a zero-argument
    callable whose body performs effects. All the reference combinators are
    provided with identical monad semantics. ``sequence_vec`` is iterative
    (a Python loop), giving the same O(1)-stack guarantee as the reference's
    stack-safe fold (model.rs:623-658, FG-19) without a trampoline.
    """

    __slots__ = ("_thunk",)

    def __init__(self, thunk: Callable[[], Any]):
        self._thunk = thunk

    def __call__(self):
        return self._thunk()

    # -- constructors -------------------------------------------------------

    @staticmethod
    def pure(value) -> "Model":
        """Reference: model.rs:144."""
        return Model(lambda: value)

    @staticmethod
    def sample(address, dist: Distribution, sample_shape=()) -> "Model":
        return Model(lambda: sample(address, dist, sample_shape))

    @staticmethod
    def observe(address, dist: Distribution, value) -> "Model":
        return Model(lambda: observe(address, dist, value))

    @staticmethod
    def factor(log_weight) -> "Model":
        return Model(lambda: factor(log_weight))

    @staticmethod
    def guard(condition) -> "Model":
        return Model(lambda: guard(condition))

    # -- combinators --------------------------------------------------------

    def bind(self, f: Callable[[Any], "Model"]) -> "Model":
        """Monadic bind (reference: model.rs:492-581)."""
        return Model(lambda: f(self._thunk())())

    and_then = bind

    def map(self, f: Callable[[Any], Any]) -> "Model":
        """Functor map (reference: model.rs:597)."""
        return Model(lambda: f(self._thunk()))

    def zip(self, other: "Model") -> "Model":
        """Pair two models sequentially (reference: model.rs:680)."""
        return Model(lambda: (self._thunk(), other._thunk()))

    @staticmethod
    def sequence_vec(models: Sequence["Model"]) -> "Model":
        """Run models in order, collect results (reference: model.rs:623-658,
        iterative / stack-safe)."""
        ms = list(models)

        def thunk():
            return [m() for m in ms]

        return Model(thunk)

    @staticmethod
    def traverse_vec(items: Sequence[Any], f: Callable[[Any], "Model"]) -> "Model":
        """map-then-sequence (reference: model.rs:680)."""
        xs = list(items)

        def thunk():
            return [f(x)() for x in xs]

        return Model(thunk)


# convenience aliases matching the flat reference re-exports (lib.rs:16-59)
pure = Model.pure
sequence_vec = Model.sequence_vec
traverse_vec = Model.traverse_vec
