"""The 17-distribution library as pure JAX ``(sample, log_prob)`` pairs.

Capability parity with the reference distribution layer
(reference: src/core/distribution.rs — trait :39-94; Normal:125, Uniform:242,
LogNormal:367, Exponential:472, Bernoulli:552, Categorical:655, Beta:830,
Gamma:990, Binomial:1103, Poisson:1206, StudentT:1297, Cauchy:1405,
Laplace:1484, Weibull:1570, ChiSquared:1668, InverseGamma:1737,
DiscreteUniform:1833), re-designed as array programs:

- ``sample(key, sample_shape)`` is a pure function of a counter-based PRNG
  key, so thousands of chains/particles draw in parallel with zero shared
  state (replaces the reference's single sequential ``&mut RngCore``).
- ``log_prob(x)`` is a vectorized log-space formula (no exp of densities),
  valid for batched ``x``; invalid support regions yield ``-inf`` instead of
  errors so the same code runs under jit (the compiled analog of the
  reference's typed runtime errors).
- "Natural return types" carry over as dtypes: Bernoulli → bool,
  Categorical/Binomial/Poisson/DiscreteUniform → int, everything else → the
  configured real dtype.
- Parameter validation happens eagerly when parameters are concrete (host
  values) and raises the same typed error codes as the reference
  (``InvalidMean``/``InvalidVariance``/… — src/error.rs:40-59); traced
  parameters are validated implicitly via -inf/nan propagation.

Every distribution declares a ``support`` used by staging to choose HMC
unconstraining transforms, MH proposal kinds, and VI families (the array-program analog
of the reference's support-detection logic, src/inference/mh.rs:146-161 and
src/inference/vi.rs:119-126).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln, betaln

from .. import settings
from ..errors import (
    ErrorCode,
    check_count,
    check_finite,
    check_positive,
    check_probability,
)

_LOG_2PI = math.log(2.0 * math.pi)


# ---------------------------------------------------------------------------
# Supports
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Support:
    """Declared support of a distribution.

    ``kind`` drives downstream algorithm choices (transform / proposal /
    variational family), mirroring the reference's support detection
    (mh.rs:146-161, vi.rs:119-126).
    """

    kind: str  # real | positive | unit | interval | boolean | count |
    #            int_range | categorical | simplex
    low: Optional[float] = None
    high: Optional[float] = None
    size: Optional[int] = None  # number of categories for categorical

    @property
    def is_continuous(self) -> bool:
        return self.kind in ("real", "positive", "unit", "interval", "simplex")

    @property
    def is_discrete(self) -> bool:
        return not self.is_continuous


REAL = Support("real")
POSITIVE = Support("positive")
UNIT = Support("unit")
BOOLEAN = Support("boolean")
COUNT = Support("count")


def interval(low: float, high: float) -> Support:
    return Support("interval", low=low, high=high)


def int_range(low: int, high: int) -> Support:
    return Support("int_range", low=low, high=high)


def categorical_support(k: int) -> Support:
    return Support("categorical", low=0, high=k - 1, size=k)


def simplex_support(k: int) -> Support:
    """Interior of the (k-1)-simplex: x_i > 0, Σx_i = 1 (k components)."""
    return Support("simplex", low=0.0, high=1.0, size=k)


# ---------------------------------------------------------------------------
# Base class
# ---------------------------------------------------------------------------


class Distribution:
    """Base distribution interface (reference trait: distribution.rs:39-94).

    Scalar event shape: every one of the 17 reference distributions is
    univariate; batching comes from ``sample_shape`` and broadcast parameters.
    """

    support: Support = REAL

    @property
    def dtype(self):
        if self.support.kind == "boolean":
            return jnp.bool_
        if self.support.is_discrete:
            return settings.int_dtype()
        return settings.real_dtype()

    def sample(self, key, sample_shape: Tuple[int, ...] = ()):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def _batch_shape(self) -> Tuple[int, ...]:
        """Broadcast shape of the parameters."""
        shapes = [jnp.shape(p) for p in self._params()]
        out: Tuple[int, ...] = ()
        for s in shapes:
            out = jnp.broadcast_shapes(out, s)
        return out

    def _params(self):
        return ()

    def _full_shape(self, sample_shape):
        return tuple(sample_shape) + self._batch_shape()

    def unconstraining_transform(self):
        """The bijector z ∈ R^k ↔ x ∈ support used by gradient-based kernels.

        Built from the RUNTIME distribution instance at every replay, so
        distributions whose support depends on traced parameters (e.g.
        ``Uniform(0, a)`` with ``a`` an earlier sample) transform with the
        CURRENT bounds — never with values baked at staging discovery.
        Default: the static support-keyed transform."""
        from .transforms import transform_for_support

        return transform_for_support(self.support)

    def __repr__(self):
        params = ", ".join(f"{v}" for v in self._params())
        return f"{type(self).__name__}({params})"


def _real(x):
    return jnp.asarray(x, settings.real_dtype())


# ---------------------------------------------------------------------------
# Continuous distributions
# ---------------------------------------------------------------------------


class Normal(Distribution):
    """Normal(mean, std). Reference: distribution.rs:125 (log-space density,
    no tail cutoff — FG-08)."""

    support = REAL

    def __init__(self, loc, scale):
        check_finite("mean", loc, ErrorCode.INVALID_MEAN)
        check_positive("std", scale, ErrorCode.INVALID_VARIANCE)
        self.loc = loc
        self.scale = scale

    @staticmethod
    def standard() -> "Normal":
        """Infallible N(0,1) (reference: distribution.rs:165)."""
        return Normal(0.0, 1.0)

    def _params(self):
        return (self.loc, self.scale)

    def sample(self, key, sample_shape=()):
        z = jax.random.normal(key, self._full_shape(sample_shape), settings.real_dtype())
        return _real(self.loc) + _real(self.scale) * z

    def log_prob(self, value):
        loc, scale = _real(self.loc), _real(self.scale)
        z = (_real(value) - loc) / scale
        return -0.5 * z * z - jnp.log(scale) - 0.5 * _LOG_2PI


class Uniform(Distribution):
    """Uniform(low, high) on [low, high). Reference: distribution.rs:242."""

    def __init__(self, low, high):
        check_finite("low", low, ErrorCode.INVALID_RANGE)
        check_finite("high", high, ErrorCode.INVALID_RANGE)
        from ..errors import ValidationError, _is_concrete, _is_python_static
        import numpy as np

        if _is_concrete(low) and _is_concrete(high):
            if not np.all(np.asarray(low) < np.asarray(high)):
                raise ValidationError(
                    ErrorCode.INVALID_RANGE,
                    "low must be < high",
                    {"low": low, "high": high},
                )
        # the support's STATIC bounds are recorded only for Python/numpy
        # values. A concrete jax.Array is NOT static: during eager staging
        # discovery, a bound computed from an earlier site's draw is a
        # concrete device array, and baking it would freeze the discovery
        # draw into the site table (the dependent-bound bug, VERDICT r1
        # item 6). Unknown-bound sites still transform exactly — the
        # runtime AffineSigmoid below uses the live bounds at every replay.
        if _is_python_static(low) and _is_python_static(high):
            self.support = interval(float(np.min(np.asarray(low))), float(np.max(np.asarray(high))))
        else:
            self.support = interval(None, None)  # bounds only known at trace time
        self.low = low
        self.high = high

    @staticmethod
    def unit() -> "Uniform":
        """Infallible U(0,1) (reference: distribution.rs:284)."""
        return Uniform(0.0, 1.0)

    def unconstraining_transform(self):
        """AffineSigmoid with the distribution's OWN (possibly traced,
        possibly per-element array) bounds — exact for dependent-bound
        models like ``Uniform(0, a)`` (VERDICT r1 item 6)."""
        from .transforms import AffineSigmoid

        return AffineSigmoid(self.low, self.high)

    def _params(self):
        return (self.low, self.high)

    def sample(self, key, sample_shape=()):
        u = jax.random.uniform(key, self._full_shape(sample_shape), settings.real_dtype())
        low, high = _real(self.low), _real(self.high)
        return low + (high - low) * u

    def log_prob(self, value):
        low, high = _real(self.low), _real(self.high)
        x = _real(value)
        inside = (x >= low) & (x < high)
        return jnp.where(inside, -jnp.log(high - low), -jnp.inf)


class LogNormal(Distribution):
    """LogNormal(mu, sigma) of the underlying normal. Reference: :367."""

    support = POSITIVE

    def __init__(self, loc, scale):
        check_finite("mu", loc, ErrorCode.INVALID_MEAN)
        check_positive("sigma", scale, ErrorCode.INVALID_VARIANCE)
        self.loc = loc
        self.scale = scale

    def _params(self):
        return (self.loc, self.scale)

    def sample(self, key, sample_shape=()):
        z = jax.random.normal(key, self._full_shape(sample_shape), settings.real_dtype())
        return jnp.exp(_real(self.loc) + _real(self.scale) * z)

    def log_prob(self, value):
        loc, scale = _real(self.loc), _real(self.scale)
        x = _real(value)
        safe_x = jnp.where(x > 0, x, 1.0)
        lx = jnp.log(safe_x)
        z = (lx - loc) / scale
        lp = -lx - jnp.log(scale) - 0.5 * _LOG_2PI - 0.5 * z * z
        return jnp.where(x > 0, lp, -jnp.inf)


class Exponential(Distribution):
    """Exponential(rate). Reference: :472."""

    support = POSITIVE

    def __init__(self, rate):
        check_positive("rate", rate, ErrorCode.INVALID_RATE)
        self.rate = rate

    def _params(self):
        return (self.rate,)

    def sample(self, key, sample_shape=()):
        e = jax.random.exponential(key, self._full_shape(sample_shape), settings.real_dtype())
        return e / _real(self.rate)

    def log_prob(self, value):
        rate = _real(self.rate)
        x = _real(value)
        return jnp.where(x >= 0, jnp.log(rate) - rate * x, -jnp.inf)


class Beta(Distribution):
    """Beta(alpha, beta). Reference: :830."""

    support = UNIT

    def __init__(self, concentration1, concentration0):
        check_positive("alpha", concentration1, ErrorCode.INVALID_SHAPE)
        check_positive("beta", concentration0, ErrorCode.INVALID_SHAPE)
        self.concentration1 = concentration1  # alpha
        self.concentration0 = concentration0  # beta

    @staticmethod
    def uniform_prior() -> "Beta":
        """Infallible Beta(1,1) (reference: distribution.rs:873)."""
        return Beta(1.0, 1.0)

    def _params(self):
        return (self.concentration1, self.concentration0)

    def sample(self, key, sample_shape=()):
        return jax.random.beta(
            key,
            _real(self.concentration1),
            _real(self.concentration0),
            self._full_shape(sample_shape),
            settings.real_dtype(),
        )

    def log_prob(self, value):
        a, b = _real(self.concentration1), _real(self.concentration0)
        x = _real(value)
        inside = (x > 0) & (x < 1)
        sx = jnp.where(inside, x, 0.5)
        lp = (a - 1) * jnp.log(sx) + (b - 1) * jnp.log1p(-sx) - betaln(a, b)
        return jnp.where(inside, lp, -jnp.inf)


class Gamma(Distribution):
    """Gamma(shape, rate). Reference: :990 (shape-rate parameterization)."""

    support = POSITIVE

    def __init__(self, concentration, rate):
        check_positive("shape", concentration, ErrorCode.INVALID_SHAPE)
        check_positive("rate", rate, ErrorCode.INVALID_RATE)
        self.concentration = concentration
        self.rate = rate

    def _params(self):
        return (self.concentration, self.rate)

    def sample(self, key, sample_shape=()):
        g = jax.random.gamma(
            key, _real(self.concentration), self._full_shape(sample_shape), settings.real_dtype()
        )
        return g / _real(self.rate)

    def log_prob(self, value):
        a, b = _real(self.concentration), _real(self.rate)
        x = _real(value)
        sx = jnp.where(x > 0, x, 1.0)
        lp = a * jnp.log(b) - gammaln(a) + (a - 1) * jnp.log(sx) - b * sx
        return jnp.where(x > 0, lp, -jnp.inf)


class StudentT(Distribution):
    """StudentT(df, loc, scale). Reference: :1297."""

    support = REAL

    def __init__(self, df, loc=0.0, scale=1.0):
        check_positive("df", df, ErrorCode.INVALID_SHAPE)
        check_finite("loc", loc, ErrorCode.INVALID_MEAN)
        check_positive("scale", scale, ErrorCode.INVALID_VARIANCE)
        self.df = df
        self.loc = loc
        self.scale = scale

    def _params(self):
        return (self.df, self.loc, self.scale)

    def sample(self, key, sample_shape=()):
        t = jax.random.t(key, _real(self.df), self._full_shape(sample_shape), settings.real_dtype())
        return _real(self.loc) + _real(self.scale) * t

    def log_prob(self, value):
        v, loc, scale = _real(self.df), _real(self.loc), _real(self.scale)
        z = (_real(value) - loc) / scale
        return (
            gammaln((v + 1) / 2)
            - gammaln(v / 2)
            - 0.5 * jnp.log(v * math.pi)
            - jnp.log(scale)
            - (v + 1) / 2 * jnp.log1p(z * z / v)
        )


class Cauchy(Distribution):
    """Cauchy(loc, scale). Reference: :1405."""

    support = REAL

    def __init__(self, loc, scale):
        check_finite("loc", loc, ErrorCode.INVALID_MEAN)
        check_positive("scale", scale, ErrorCode.INVALID_VARIANCE)
        self.loc = loc
        self.scale = scale

    def _params(self):
        return (self.loc, self.scale)

    def sample(self, key, sample_shape=()):
        c = jax.random.cauchy(key, self._full_shape(sample_shape), settings.real_dtype())
        return _real(self.loc) + _real(self.scale) * c

    def log_prob(self, value):
        loc, scale = _real(self.loc), _real(self.scale)
        z = (_real(value) - loc) / scale
        return -jnp.log(math.pi) - jnp.log(scale) - jnp.log1p(z * z)


class Laplace(Distribution):
    """Laplace(loc, scale). Reference: :1484."""

    support = REAL

    def __init__(self, loc, scale):
        check_finite("loc", loc, ErrorCode.INVALID_MEAN)
        check_positive("scale", scale, ErrorCode.INVALID_VARIANCE)
        self.loc = loc
        self.scale = scale

    def _params(self):
        return (self.loc, self.scale)

    def sample(self, key, sample_shape=()):
        l = jax.random.laplace(key, self._full_shape(sample_shape), settings.real_dtype())
        return _real(self.loc) + _real(self.scale) * l

    def log_prob(self, value):
        loc, scale = _real(self.loc), _real(self.scale)
        z = jnp.abs(_real(value) - loc) / scale
        return -jnp.log(2 * scale) - z


class Weibull(Distribution):
    """Weibull(shape k, scale lambda). Reference: :1570."""

    support = POSITIVE

    def __init__(self, concentration, scale):
        check_positive("shape", concentration, ErrorCode.INVALID_SHAPE)
        check_positive("scale", scale, ErrorCode.INVALID_VARIANCE)
        self.concentration = concentration  # k
        self.scale = scale  # lambda

    def _params(self):
        return (self.concentration, self.scale)

    def sample(self, key, sample_shape=()):
        return jax.random.weibull_min(
            key,
            _real(self.scale),
            _real(self.concentration),
            self._full_shape(sample_shape),
            settings.real_dtype(),
        )

    def log_prob(self, value):
        k, lam = _real(self.concentration), _real(self.scale)
        x = _real(value)
        sx = jnp.where(x > 0, x, 1.0)
        z = sx / lam
        lp = jnp.log(k) - jnp.log(lam) + (k - 1) * jnp.log(z) - z**k
        return jnp.where(x > 0, lp, -jnp.inf)


class ChiSquared(Distribution):
    """ChiSquared(df). Reference: :1668."""

    support = POSITIVE

    def __init__(self, df):
        check_positive("df", df, ErrorCode.INVALID_SHAPE)
        self.df = df

    def _params(self):
        return (self.df,)

    def sample(self, key, sample_shape=()):
        return jax.random.chisquare(
            key, _real(self.df), self._full_shape(sample_shape), settings.real_dtype()
        )

    def log_prob(self, value):
        k = _real(self.df)
        x = _real(value)
        sx = jnp.where(x > 0, x, 1.0)
        half_k = k / 2
        lp = (half_k - 1) * jnp.log(sx) - sx / 2 - half_k * math.log(2.0) - gammaln(half_k)
        return jnp.where(x > 0, lp, -jnp.inf)


class InverseGamma(Distribution):
    """InverseGamma(shape, scale). Reference: :1737."""

    support = POSITIVE

    def __init__(self, concentration, scale):
        check_positive("shape", concentration, ErrorCode.INVALID_SHAPE)
        check_positive("scale", scale, ErrorCode.INVALID_RATE)
        self.concentration = concentration
        self.scale = scale

    def _params(self):
        return (self.concentration, self.scale)

    def sample(self, key, sample_shape=()):
        g = jax.random.gamma(
            key, _real(self.concentration), self._full_shape(sample_shape), settings.real_dtype()
        )
        return _real(self.scale) / g

    def log_prob(self, value):
        a, b = _real(self.concentration), _real(self.scale)
        x = _real(value)
        sx = jnp.where(x > 0, x, 1.0)
        lp = a * jnp.log(b) - gammaln(a) - (a + 1) * jnp.log(sx) - b / sx
        return jnp.where(x > 0, lp, -jnp.inf)


class HalfNormal(Distribution):
    """HalfNormal(scale): |N(0, scale²)| on [0, ∞).

    Extension (no reference counterpart) — the standard
    weakly-informative prior for hierarchical scale parameters (Gelman
    2006); pairs with the Exp transform for HMC/NUTS/ChEES."""

    support = POSITIVE

    def __init__(self, scale):
        check_positive("scale", scale, ErrorCode.INVALID_VARIANCE)
        self.scale = scale

    def _params(self):
        return (self.scale,)

    def sample(self, key, sample_shape=()):
        z = jax.random.normal(key, self._full_shape(sample_shape), settings.real_dtype())
        return jnp.abs(_real(self.scale) * z)

    def log_prob(self, value):
        s = _real(self.scale)
        x = _real(value)
        z = x / s
        lp = (
            0.5 * jnp.log(jnp.asarray(2.0 / jnp.pi, x.dtype))
            - jnp.log(s)
            - 0.5 * z * z
        )
        return jnp.where(x >= 0, lp, -jnp.inf)


class HalfCauchy(Distribution):
    """HalfCauchy(scale): |Cauchy(0, scale)| on [0, ∞).

    Extension — the heavy-tailed hierarchical scale prior
    (eight-schools' canonical tau prior)."""

    support = POSITIVE

    def __init__(self, scale):
        check_positive("scale", scale, ErrorCode.INVALID_VARIANCE)
        self.scale = scale

    def _params(self):
        return (self.scale,)

    def sample(self, key, sample_shape=()):
        u = jax.random.uniform(
            key, self._full_shape(sample_shape), settings.real_dtype(),
            1e-7, 1.0 - 1e-7,
        )
        # inverse CDF of the half-Cauchy: x = scale * tan(pi * u / 2)
        return _real(self.scale) * jnp.tan(0.5 * jnp.pi * u)

    def log_prob(self, value):
        s = _real(self.scale)
        x = _real(value)
        lp = (
            jnp.log(jnp.asarray(2.0 / jnp.pi, x.dtype))
            - jnp.log(s)
            - jnp.log1p((x / s) ** 2)
        )
        return jnp.where(x >= 0, lp, -jnp.inf)


# ---------------------------------------------------------------------------
# Discrete distributions
# ---------------------------------------------------------------------------


class Bernoulli(Distribution):
    """Bernoulli(p) → bool. Reference: :552."""

    support = BOOLEAN

    def __init__(self, probs):
        check_probability("p", probs)
        self.probs = probs

    def _params(self):
        return (self.probs,)

    def sample(self, key, sample_shape=()):
        p = _real(self.probs)
        return jax.random.bernoulli(key, p, self._full_shape(sample_shape))

    def log_prob(self, value):
        p = _real(self.probs)
        v = jnp.asarray(value, jnp.bool_)
        # Stable at p == 0 / 1: the selected branch is exact, the other is
        # masked before log.
        lp_true = jnp.log(jnp.where(p > 0, p, 1.0))
        lp_false = jnp.log1p(-jnp.where(p < 1, p, 0.0))
        lp = jnp.where(v, jnp.where(p > 0, lp_true, -jnp.inf),
                       jnp.where(p < 1, lp_false, -jnp.inf))
        return lp


class BernoulliLogits(Distribution):
    """Bernoulli parameterized on the log-odds scale → bool.

    Extension (no reference counterpart): the numerically stable
    likelihood for logistic models — ``log p = -softplus(∓logits)`` never
    saturates where ``log(sigmoid(x))`` underflows, and the staged GLM
    potential keeps the X @ w matmul feeding it directly (no intermediate
    probability materialization)."""

    support = BOOLEAN

    def __init__(self, logits):
        check_finite("logits", logits, ErrorCode.INVALID_MEAN)
        self.logits = logits

    def _params(self):
        return (self.logits,)

    def sample(self, key, sample_shape=()):
        z = _real(self.logits)
        return jax.random.bernoulli(
            key, jax.nn.sigmoid(z), self._full_shape(sample_shape)
        )

    def log_prob(self, value):
        z = _real(self.logits)
        v = jnp.asarray(value, jnp.bool_)
        # log σ(z) = -softplus(-z); log(1-σ(z)) = -softplus(z)
        return jnp.where(v, -jax.nn.softplus(-z), -jax.nn.softplus(z))


class Categorical(Distribution):
    """Categorical(probs) → index in [0, k). Reference: :655-770 (cached-CDF
    binary-search sampling, FG-53 — here this is ``jax.random.categorical``
    on log-probabilities, a single fused Gumbel-argmax kernel)."""

    def __init__(self, probs=None, logits=None):
        if (probs is None) == (logits is None):
            from ..errors import ValidationError

            raise ValidationError(
                ErrorCode.INVALID_PROBABILITY,
                "exactly one of probs/logits must be given",
            )
        if probs is not None:
            check_probability("probs", probs)
            from ..errors import ValidationError, _is_concrete
            import numpy as np

            if _is_concrete(probs):
                arr = np.asarray(probs)
                if arr.ndim < 1 or arr.shape[-1] < 1:
                    raise ValidationError(
                        ErrorCode.INVALID_PROBABILITY, "probs must be non-empty"
                    )
                if not np.allclose(arr.sum(axis=-1), 1.0, atol=1e-5):
                    raise ValidationError(
                        ErrorCode.INVALID_PROBABILITY,
                        "probs must sum to 1",
                        {"sum": arr.sum(axis=-1)},
                    )
            self.probs = probs
            self._logits = None
        else:
            self.probs = None
            self._logits = logits
        k = jnp.shape(probs if probs is not None else logits)[-1]
        self.support = categorical_support(int(k))

    @staticmethod
    def uniform(k: int) -> "Categorical":
        """Infallible uniform over k categories (reference: :729)."""
        return Categorical(probs=jnp.full((k,), 1.0 / k, settings.real_dtype()))

    @property
    def logits(self):
        if self._logits is not None:
            return _real(self._logits)
        p = _real(self.probs)
        return jnp.log(jnp.where(p > 0, p, 1e-38))

    def _params(self):
        return (self.probs if self.probs is not None else self._logits,)

    def _batch_shape(self):
        return jnp.shape(self._params()[0])[:-1]

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self._batch_shape()
        return jax.random.categorical(key, self.logits, shape=shape).astype(
            settings.int_dtype()
        )

    def log_prob(self, value):
        logits = self.logits
        norm = jax.nn.log_softmax(logits, axis=-1)
        v = jnp.asarray(value, jnp.int32)
        k = logits.shape[-1]
        inside = (v >= 0) & (v < k)
        sv = jnp.clip(v, 0, k - 1)
        lp = jnp.take_along_axis(
            jnp.broadcast_to(norm, jnp.shape(sv) + (k,)), sv[..., None], axis=-1
        )[..., 0]
        return jnp.where(inside, lp, -jnp.inf)


class Binomial(Distribution):
    """Binomial(n, p) → count. Reference: :1103."""

    def __init__(self, total_count, probs):
        check_count("n", total_count)
        check_probability("p", probs)
        self.total_count = total_count
        self.probs = probs
        from ..errors import _is_concrete
        import numpy as np

        if _is_concrete(total_count):
            self.support = int_range(0, int(np.max(np.asarray(total_count))))
        else:
            self.support = COUNT

    def _params(self):
        return (self.total_count, self.probs)

    def sample(self, key, sample_shape=()):
        n = _real(self.total_count)
        p = _real(self.probs)
        draw = jax.random.binomial(key, n, p, self._full_shape(sample_shape))
        return draw.astype(settings.counting_dtype())

    def log_prob(self, value):
        n = _real(self.total_count)
        p = _real(self.probs)
        k = _real(value)
        inside = (k >= 0) & (k <= n)
        sk = jnp.clip(k, 0, n)
        log_p = jnp.log(jnp.where(p > 0, p, 1.0))
        log_q = jnp.log1p(-jnp.where(p < 1, p, 0.0))
        lp = (
            gammaln(n + 1)
            - gammaln(sk + 1)
            - gammaln(n - sk + 1)
            + jnp.where(sk > 0, sk * log_p, jnp.where(p > 0, 0.0, 0.0))
            + jnp.where(n - sk > 0, (n - sk) * log_q, 0.0)
        )
        # p==0 with k>0, or p==1 with k<n, must be -inf
        lp = jnp.where((p <= 0) & (sk > 0), -jnp.inf, lp)
        lp = jnp.where((p >= 1) & (sk < n), -jnp.inf, lp)
        return jnp.where(inside, lp, -jnp.inf)


class Poisson(Distribution):
    """Poisson(rate) → count. Reference: :1206."""

    support = COUNT

    def __init__(self, rate):
        check_positive("rate", rate, ErrorCode.INVALID_RATE)
        self.rate = rate

    def _params(self):
        return (self.rate,)

    def sample(self, key, sample_shape=()):
        lam = _real(self.rate)
        return jax.random.poisson(
            key, lam, self._full_shape(sample_shape), settings.counting_dtype()
        )

    def log_prob(self, value):
        lam = _real(self.rate)
        k = _real(value)
        inside = k >= 0
        sk = jnp.where(inside, k, 0.0)
        lp = sk * jnp.log(lam) - lam - gammaln(sk + 1)
        return jnp.where(inside, lp, -jnp.inf)


class Geometric(Distribution):
    """Geometric(p) → number of FAILURES before the first success, on
    {0, 1, 2, …} (the NegativeBinomial(1, p) convention; scipy's ``geom``
    counts trials and starts at 1).

    Extension (no reference counterpart). Sampling is one
    inverse-CDF transform: k = ⌊log U / log(1−p)⌋."""

    support = COUNT

    def __init__(self, probs):
        from ..errors import ValidationError, _is_concrete
        import numpy as np

        check_probability("probs", probs)
        if jnp.ndim(probs) == 0 and _is_concrete(probs):
            if float(np.asarray(probs)) <= 0.0:
                raise ValidationError(
                    ErrorCode.INVALID_PROBABILITY,
                    "probs must be > 0 (p=0 never terminates)",
                    {"probs": probs},
                )
        self.probs = probs

    def _params(self):
        return (self.probs,)

    def sample(self, key, sample_shape=()):
        p = _real(self.probs)
        u = jax.random.uniform(
            key, self._full_shape(sample_shape), settings.real_dtype(),
            1e-12, 1.0,
        )
        # Clamp p into (0, 1) for the inverse-CDF transform: p=0 can reach
        # here via a traced/array probs (the scalar-only constructor check
        # cannot see it) and would give log(u)/log1p(0) = -inf cast to int.
        p_safe = jnp.clip(p, 1e-12, 1.0 - 1e-12)
        k = jnp.floor(jnp.log(u) / jnp.log1p(-p_safe))
        return jnp.asarray(
            jnp.where(p >= 1.0, 0.0, k), settings.counting_dtype()
        )

    def log_prob(self, value):
        p = _real(self.probs)
        k = _real(value)
        inside = k >= 0
        sk = jnp.where(inside, k, 0.0)
        # Guard the sk*log1p(-p) term: at the valid edge p=1, k=0 it would
        # evaluate 0*(-inf) = NaN; the correct mass there is log(p) = 0.
        tail = jnp.where(sk == 0, 0.0, sk * jnp.log1p(-p))
        lp = tail + jnp.log(p)
        return jnp.where(inside, lp, -jnp.inf)


class NegativeBinomial(Distribution):
    """NegativeBinomial(total_count, probs) → number of FAILURES before the
    ``total_count``-th success (success probability ``probs``), on
    {0, 1, 2, …} — scipy's ``nbinom(n, p)`` convention; mean r(1−p)/p.

    Extension (no reference counterpart): the overdispersed
    count likelihood Poisson cannot express. Sampling is the exact
    Gamma-Poisson mixture — two fused vectorized kernels."""

    support = COUNT

    def __init__(self, total_count, probs):
        check_positive("total_count", total_count, ErrorCode.INVALID_COUNT)
        check_probability("probs", probs)
        self.total_count = total_count
        self.probs = probs

    def _params(self):
        return (self.total_count, self.probs)

    def sample(self, key, sample_shape=()):
        k1, k2 = jax.random.split(key)
        r = _real(self.total_count)
        p = _real(self.probs)
        shape = self._full_shape(sample_shape)
        lam = jax.random.gamma(
            k1, jnp.broadcast_to(r, shape), dtype=settings.real_dtype()
        ) * (1.0 - p) / p
        return jax.random.poisson(k2, lam, shape, settings.counting_dtype())

    def log_prob(self, value):
        r = _real(self.total_count)
        p = _real(self.probs)
        k = _real(value)
        inside = k >= 0
        sk = jnp.where(inside, k, 0.0)
        lp = (
            gammaln(sk + r)
            - gammaln(r)
            - gammaln(sk + 1.0)
            + r * jnp.log(p)
            + sk * jnp.log1p(-p)
        )
        return jnp.where(inside, lp, -jnp.inf)


class DiscreteUniform(Distribution):
    """DiscreteUniform(low, high) inclusive → int. Reference: :1833-1938
    (the reference's exact-u128-count machinery is unnecessary here: staged
    sites use int32/int64 arrays with the count computed in float log-space).
    """

    def __init__(self, low, high):
        from ..errors import ValidationError, _is_concrete
        import numpy as np

        if _is_concrete(low) and _is_concrete(high):
            if not np.all(np.asarray(low) <= np.asarray(high)):
                raise ValidationError(
                    ErrorCode.INVALID_RANGE,
                    "low must be <= high",
                    {"low": low, "high": high},
                )
            self.support = int_range(int(np.min(np.asarray(low))), int(np.max(np.asarray(high))))
        else:
            self.support = int_range(None, None)
        self.low = low
        self.high = high

    def _params(self):
        return (self.low, self.high)

    def sample(self, key, sample_shape=()):
        low = jnp.asarray(self.low, settings.counting_dtype())
        high = jnp.asarray(self.high, settings.counting_dtype())
        return jax.random.randint(
            key,
            self._full_shape(sample_shape),
            low,
            high + 1,
            settings.counting_dtype(),
        )

    def log_prob(self, value):
        low = _real(self.low)
        high = _real(self.high)
        v = _real(value)
        inside = (v >= low) & (v <= high)
        count = high - low + 1.0
        return jnp.where(inside, -jnp.log(count), -jnp.inf)


# ---------------------------------------------------------------------------
# Multivariate distributions (extension)
# ---------------------------------------------------------------------------
#
# The reference library is strictly univariate (distribution.rs:39-94 — every
# trait impl returns a scalar). On an accelerator, vector-valued sites are the natural
# unit of work (one site = one batched array op), so the framework adds
# first-class multivariate families on top of the 17-distribution parity set:
# sites with event shapes stage into the same flat layouts, HMC/NUTS run on
# the stick-breaking-unconstrained space, and VI gets a Dirichlet family.


class Dirichlet(Distribution):
    """Dirichlet(concentration) → point on the (k-1)-simplex, event shape
    ``(k,)`` over the last axis of ``concentration``.

    Extension (no reference counterpart; the reference is
    univariate-only). Sampling uses the Gamma-normalization construction so
    dtype policy and key-splitting match the rest of the library; HMC/NUTS
    handle simplex sites through the ``StickBreaking`` transform
    (core/transforms.py)."""

    def __init__(self, concentration):
        check_positive("concentration", concentration, ErrorCode.INVALID_SHAPE)
        shape = jnp.shape(concentration)
        if len(shape) < 1 or shape[-1] < 2:
            from ..errors import ValidationError

            raise ValidationError(
                ErrorCode.INVALID_SHAPE,
                "concentration must have a trailing event axis of size >= 2",
                {"shape": shape},
            )
        self.concentration = concentration
        self.support = simplex_support(int(shape[-1]))

    def _params(self):
        return (self.concentration,)

    def unconstraining_transform(self):
        from .transforms import StickBreaking

        return StickBreaking(self.support.size)

    def _batch_shape(self):
        return jnp.shape(self.concentration)[:-1]

    @property
    def event_size(self) -> int:
        return self.support.size

    def sample(self, key, sample_shape=()):
        dt = settings.real_dtype()
        conc = jnp.asarray(self.concentration, dt)
        full = tuple(sample_shape) + self._batch_shape() + (self.event_size,)
        g = jax.random.gamma(key, jnp.broadcast_to(conc, full), dtype=dt)
        return g / jnp.sum(g, axis=-1, keepdims=True)

    def log_prob(self, value):
        a = _real(self.concentration)
        x = _real(value)
        inside = jnp.all(x > 0.0, axis=-1) & (
            jnp.abs(jnp.sum(x, axis=-1) - 1.0) < 1e-4
        )
        xs = jnp.where(x > 0.0, x, 1.0)  # keep log finite off-support
        lp = (
            jnp.sum((a - 1.0) * jnp.log(xs), axis=-1)
            + gammaln(jnp.sum(a, axis=-1))
            - jnp.sum(gammaln(a), axis=-1)
        )
        return jnp.where(inside, lp, -jnp.inf)


class MultivariateNormal(Distribution):
    """MultivariateNormal(loc, covariance= | scale_tril=) → R^d vector,
    event shape ``(d,)``.

    Extension (no reference counterpart). Sampling is one batched
    ``eps @ L^T`` matmul; ``log_prob`` is a triangular solve —
    both batch over leading axes, so a 1024-chain HMC run scores all chains
    in one kernel."""

    def __init__(self, loc, covariance=None, scale_tril=None):
        from ..errors import ValidationError, _is_concrete
        import numpy as np

        if (covariance is None) == (scale_tril is None):
            raise ValidationError(
                ErrorCode.INVALID_VARIANCE,
                "exactly one of covariance/scale_tril must be given",
            )
        check_finite("loc", loc, ErrorCode.INVALID_MEAN)
        d = jnp.shape(loc)[-1] if jnp.ndim(loc) >= 1 else None
        if covariance is not None:
            if _is_concrete(covariance):
                arr = np.asarray(covariance)
                if arr.ndim < 2 or arr.shape[-1] != arr.shape[-2]:
                    raise ValidationError(
                        ErrorCode.INVALID_VARIANCE,
                        "covariance must be square",
                        {"shape": arr.shape},
                    )
                if not np.allclose(arr, np.swapaxes(arr, -1, -2), atol=1e-6):
                    raise ValidationError(
                        ErrorCode.INVALID_VARIANCE, "covariance must be symmetric"
                    )
                try:
                    np.linalg.cholesky(arr)
                except np.linalg.LinAlgError:
                    raise ValidationError(
                        ErrorCode.INVALID_VARIANCE,
                        "covariance must be positive definite",
                    )
            self._scale_tril = jnp.linalg.cholesky(
                jnp.asarray(covariance, settings.real_dtype())
            )
        else:
            if _is_concrete(scale_tril):
                arr = np.asarray(scale_tril)
                if arr.ndim < 2 or arr.shape[-1] != arr.shape[-2]:
                    raise ValidationError(
                        ErrorCode.INVALID_VARIANCE,
                        "scale_tril must be square",
                        {"shape": arr.shape},
                    )
                if np.any(np.diagonal(arr, axis1=-2, axis2=-1) <= 0):
                    raise ValidationError(
                        ErrorCode.INVALID_VARIANCE,
                        "scale_tril must have positive diagonal",
                    )
            self._scale_tril = jnp.asarray(scale_tril, settings.real_dtype())
        if d is None:
            d = self._scale_tril.shape[-1]
        self.loc = loc
        self.event_size = int(d)
        self.support = REAL

    @property
    def scale_tril(self):
        return self._scale_tril

    def _params(self):
        return (self.loc,)

    def _batch_shape(self):
        lb = jnp.shape(self.loc)[:-1] if jnp.ndim(self.loc) >= 1 else ()
        sb = jnp.shape(self._scale_tril)[:-2]
        return jnp.broadcast_shapes(lb, sb)

    def sample(self, key, sample_shape=()):
        dt = settings.real_dtype()
        d = self.event_size
        full = tuple(sample_shape) + self._batch_shape() + (d,)
        eps = jax.random.normal(key, full, dt)
        L = jnp.asarray(self._scale_tril, dt)
        return jnp.asarray(self.loc, dt) + jnp.einsum("...ij,...j->...i", L, eps)

    def log_prob(self, value):
        from jax.scipy.linalg import solve_triangular

        dt = settings.real_dtype()
        x = jnp.asarray(value, dt)
        L = jnp.asarray(self._scale_tril, dt)
        diff = x - jnp.asarray(self.loc, dt)
        y = solve_triangular(L, diff[..., None], lower=True)[..., 0]
        half_logdet = jnp.sum(
            jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1
        )
        d = self.event_size
        return -0.5 * jnp.sum(y * y, axis=-1) - half_logdet - 0.5 * d * _LOG_2PI


MULTIVARIATE_DISTRIBUTIONS = [Dirichlet, MultivariateNormal]

# beyond-parity univariate extensions (not counted in the 17-way reference
# registry below, which parity tests pin)
EXTRA_DISTRIBUTIONS = [
    HalfNormal, HalfCauchy, Geometric, NegativeBinomial, BernoulliLogits,
]


ALL_DISTRIBUTIONS = [
    Normal,
    Uniform,
    LogNormal,
    Exponential,
    Bernoulli,
    Categorical,
    Beta,
    Gamma,
    Binomial,
    Poisson,
    StudentT,
    Cauchy,
    Laplace,
    Weibull,
    ChiSquared,
    InverseGamma,
    DiscreteUniform,
]
