"""Unconstraining bijectors for gradient-based kernels.

The reference's HMC runs on *constrained* values and relies on -inf rejection
at support boundaries, explicitly leaving reparameterization to the user
(reference: src/inference/hmc.rs:62-66). This build adds the transforms the
reference punts on (SURVEY.md §7 step 4): each continuous support maps to a
bijector z ∈ R ↔ x ∈ support with a log-|Jacobian| term, so HMC/NUTS/VI
operate on unconstrained R^d with exact densities.

Each transform provides ``forward(z) -> x``, ``inverse(x) -> z`` and
``log_det_jacobian(z) -> log|dx/dz|`` (summed over the site's shape by the
caller). All are elementwise, jit/vmap/grad-safe.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .distributions import Support


class Transform:
    name = "identity"

    def forward(self, z):
        return z

    def inverse(self, x):
        return x

    def log_det_jacobian(self, z):
        return jnp.zeros_like(z)

    def unconstrained_shape(self, shape):
        """Shape of the unconstrained z for a constrained site of ``shape``.

        Elementwise transforms preserve shape; dimension-changing transforms
        (StickBreaking: k → k-1) override. Staging uses this to lay out the
        flat unconstrained position vector independently of the constrained
        layout."""
        return tuple(shape)


class Identity(Transform):
    pass


class Exp(Transform):
    """R → (0, ∞): x = exp(z); log|dx/dz| = z."""

    name = "exp"

    def forward(self, z):
        return jnp.exp(z)

    def inverse(self, x):
        return jnp.log(x)

    def log_det_jacobian(self, z):
        return z


class Sigmoid(Transform):
    """R → (0, 1): x = σ(z); log|dx/dz| = -softplus(z) - softplus(-z)."""

    name = "sigmoid"

    def forward(self, z):
        return jax.nn.sigmoid(z)

    def inverse(self, x):
        return jnp.log(x) - jnp.log1p(-x)

    def log_det_jacobian(self, z):
        return -jax.nn.softplus(z) - jax.nn.softplus(-z)


class AffineSigmoid(Transform):
    """R → (low, high): x = low + (high-low)·σ(z).

    ``low``/``high`` may be Python floats, per-element arrays, or traced
    values (dependent bounds, e.g. ``Uniform(0, a)``): every op below is
    elementwise-broadcasting, and the caller (ConstrainHandler) rebuilds the
    transform from the runtime distribution at each replay so the Jacobian
    always uses the current bounds."""

    name = "affine_sigmoid"

    def __init__(self, low, high):
        self.low = low
        self.high = high

    def forward(self, z):
        return self.low + (self.high - self.low) * jax.nn.sigmoid(z)

    def inverse(self, x):
        u = (x - self.low) / (self.high - self.low)
        return jnp.log(u) - jnp.log1p(-u)

    def log_det_jacobian(self, z):
        return (
            jnp.log(self.high - self.low)
            - jax.nn.softplus(z)
            - jax.nn.softplus(-z)
        )


class StickBreaking(Transform):
    """R^{k-1} → interior of the (k-1)-simplex (k components), along the
    last axis. The dimension-changing bijector for ``Dirichlet`` sites.

    Stan's stick-breaking parameterization: break fractions
    u_j = σ(z_j − log(k−1−j)) (the offset centers z=0 on the uniform
    simplex), x_j = u_j · rem_j with rem_j = Π_{i<j}(1−u_i), and the last
    component takes the remaining stick. log|J| = Σ_j log u_j + log(1−u_j)
    + log rem_j. All ops are vectorized cumprod/cumsum along the event axis
    — no sequential loop, jit/vmap/grad-safe."""

    name = "stick_breaking"

    def __init__(self, k: int):
        self.k = int(k)

    def unconstrained_shape(self, shape):
        if not shape or shape[-1] != self.k:
            raise ValueError(
                f"stick-breaking expects trailing event axis {self.k}, got {shape}"
            )
        return tuple(shape[:-1]) + (self.k - 1,)

    def _offsets(self, dtype):
        km1 = self.k - 1
        return jnp.log(jnp.arange(km1, 0, -1, dtype=dtype))

    def forward(self, z):
        u = jax.nn.sigmoid(z - self._offsets(z.dtype))
        one_minus = 1.0 - u
        rem = jnp.concatenate(
            [
                jnp.ones(z.shape[:-1] + (1,), z.dtype),
                jnp.cumprod(one_minus, axis=-1),
            ],
            axis=-1,
        )  # rem_j = stick remaining before break j; rem[..., -1] = last comp.
        head = u * rem[..., :-1]
        return jnp.concatenate([head, rem[..., -1:]], axis=-1)

    def inverse(self, x):
        km1 = self.k - 1
        head = x[..., :km1]
        csum = jnp.cumsum(head, axis=-1)
        rem = jnp.concatenate(
            [jnp.ones(x.shape[:-1] + (1,), x.dtype), 1.0 - csum[..., :-1]],
            axis=-1,
        )
        u = head / rem
        return jnp.log(u) - jnp.log1p(-u) + self._offsets(x.dtype)

    def log_det_jacobian(self, z):
        u = jax.nn.sigmoid(z - self._offsets(z.dtype))
        log_u = jax.nn.log_sigmoid(z - self._offsets(z.dtype))
        log_1mu = jax.nn.log_sigmoid(-(z - self._offsets(z.dtype)))
        log_rem = jnp.concatenate(
            [
                jnp.zeros(z.shape[:-1] + (1,), z.dtype),
                jnp.cumsum(log_1mu[..., :-1], axis=-1),
            ],
            axis=-1,
        )
        return jnp.sum(log_u + log_1mu + log_rem, axis=-1)


def transform_for_support(support: Support) -> Transform:
    """Pick the unconstraining transform for a continuous support.

    This is the STATIC fallback keyed on support kind; distributions with
    runtime parameters in their support override
    ``Distribution.unconstraining_transform`` so the transform is rebuilt
    from the live parameters at every replay (ConstrainHandler). Interval
    supports with bounds unknown statically fall back to Identity here — the
    reference-compatible -inf-rejection mode (hmc.rs:62-66) — but the only
    distribution producing them (Uniform) overrides with a runtime
    AffineSigmoid, so this branch is a safety net for custom distributions.
    """
    if support.kind == "real":
        return Identity()
    if support.kind == "positive":
        return Exp()
    if support.kind == "unit":
        return Sigmoid()
    if support.kind == "interval":
        if support.low is not None and support.high is not None:
            return AffineSigmoid(support.low, support.high)
        return Identity()
    if support.kind == "simplex":
        return StickBreaking(support.size)
    return Identity()
