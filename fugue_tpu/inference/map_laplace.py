"""MAP estimation + Laplace approximation.

The reference has no optimization-based engine — its closest capability is
the prior-guide ELBO probe (reference: src/inference/vi.rs:905-923) and the
analytic-posterior validation harness (src/inference/validation.rs:73-166).
MAP + Laplace is the standard missing rung of the PPL inference ladder
(Stan's ``optimize``, PyMC's ``find_MAP``), so fugue-tpu provides it as a
beyond-parity engine built on the same staged log-density every other
engine uses.

Array-program design: the objective is ``StagedModel.log_joint_unconstrained``
(log p + transform Jacobians — the density whose curvature the Laplace
approximation needs), optimized by Adam or L-BFGS under ONE ``lax.scan``
jitted program, with all random restarts vmapped into a single batch — the
restarts are free batch parallelism on the device, not a Python loop. Gradients
and Hessians come from autodiff of the staged density (the reference has no
autodiff at all; its HMC uses central finite differences, hmc.rs:14-49).

The Laplace evidence estimate ``log Z ≈ log p(z*) + d/2·log 2π −
½·log det(−H)`` is computed in the unconstrained space, where the Jacobian
terms make the integral equal the constrained-space marginal likelihood.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..core.rng import chain_keys
from ..errors import ErrorCode, ModelStructureError, ValidationError
from ..runtime.staging import StagedModel, stage
from ..runtime.trace import Trace


@dataclass(frozen=True)
class MAPConfig:
    """Static optimizer configuration (hashable → jit cache key)."""

    n_iterations: int = 500
    learning_rate: float = 0.1
    optimizer: str = "adam"  # "adam" | "lbfgs"
    n_restarts: int = 4  # vmapped random restarts (first = prior mean init)
    grad_tol: float = 1e-4  # converged iff ||∇|| < grad_tol at the end


@dataclass
class MAPResult:
    latents: Dict[str, Any]  # constrained MAP point (best restart)
    z: Any  # unconstrained flat MAP position
    log_joint: float  # log p + log|J| at z (the optimized objective)
    converged: bool  # ||grad|| < grad_tol for the best restart
    grad_norm: float
    history: np.ndarray  # (n_restarts, n_iterations) objective trace
    staged: StagedModel
    discrete: Optional[Dict[str, Any]]

    def trace(self) -> Trace:
        """Full replay trace at the MAP point (typed getters, accumulators)."""
        merged = self.staged.merge_discrete(self.latents, self.discrete)
        return self.staged.replay_trace(merged)


def _check_continuous(staged: StagedModel, discrete) -> None:
    if staged.discrete_sites and discrete is None:
        raise ModelStructureError(
            ErrorCode.UNEXPECTED_MODEL_STRUCTURE,
            "MAP/Laplace optimizes continuous latents only; this model has "
            "discrete sites. Pass discrete={addr: value} to pin them "
            "(or marginalize them out of the model).",
            context={"discrete_sites": [s.address for s in staged.discrete_sites]},
        )
    if not staged.continuous_sites:
        raise ModelStructureError(
            ErrorCode.UNEXPECTED_MODEL_STRUCTURE,
            "model has no continuous latent sites to optimize",
        )


def map_estimate(
    key,
    model_fn: Optional[Callable] = None,
    config: MAPConfig = MAPConfig(),
    *,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    discrete: Optional[Dict[str, Any]] = None,
) -> MAPResult:
    """Maximum-a-posteriori point estimate of all continuous latents.

    Runs ``config.n_restarts`` optimizations as one vmapped batch (restart 0
    starts at the staged discovery point, the rest at prior draws) and
    returns the best endpoint. The whole optimization is a single cached
    XLA program per (staged model, config) pair.
    """
    if staged is None:
        staged = stage(model_fn, *model_args)
    _check_continuous(staged, discrete)

    def neg_lj(z, disc):
        return -staged.log_joint_unconstrained(z, disc)

    def build():
        if config.optimizer == "lbfgs":
            opt = optax.lbfgs(learning_rate=None)
        elif config.optimizer == "adam":
            opt = optax.adam(config.learning_rate)
        else:
            raise ValidationError(
                ErrorCode.INVALID_RANGE,
                f"unknown optimizer {config.optimizer!r} (adam|lbfgs)",
            )

        def one_restart(z0, disc):
            fn = lambda z: neg_lj(z, disc)
            state = opt.init(z0)

            def step(carry, _):
                z, st = carry
                value, grad = jax.value_and_grad(fn)(z)
                updates, st = opt.update(
                    grad, st, z, value=value, grad=grad, value_fn=fn
                )
                z = optax.apply_updates(z, updates)
                return (z, st), -value  # history in log-joint units

            (z, _), hist = jax.lax.scan(
                step, (z0, state), None, length=config.n_iterations
            )
            lj, grad = jax.value_and_grad(fn)(z)
            return z, -lj, jnp.linalg.norm(grad), hist

        def drive(key, z_init, disc, *dl):
            # large stage() data arguments arrive as traced inputs, not
            # baked compile-payload constants (StagedModel.data_leaves)
            with staged.bind_data(dl):
                zs = jnp.concatenate(
                    [
                        z_init[None],
                        jax.vmap(staged.initial_position)(
                            chain_keys(key, max(config.n_restarts - 1, 1))
                        ),
                    ]
                )[: config.n_restarts]
                return jax.vmap(one_restart, in_axes=(0, None))(zs, disc)

        return jax.jit(drive)

    drive = staged.cached_kernel(("map", config), build)
    z_init = staged.unconstrain(staged._discovery_trace.latents())
    zs, ljs, gnorms, hists = drive(key, z_init, discrete,
                                   *staged.data_leaves())
    best = int(jnp.argmax(ljs))
    z = zs[best]
    latents, _ = staged.constrain(z)
    return MAPResult(
        latents=latents,
        z=z,
        log_joint=float(ljs[best]),
        converged=bool(gnorms[best] < config.grad_tol),
        grad_norm=float(gnorms[best]),
        history=np.asarray(hists),
        staged=staged,
        discrete=discrete,
    )


@dataclass
class LaplaceResult:
    map_result: MAPResult
    mean: Any  # unconstrained MAP position
    cov: Any  # (d, d) inverse negative Hessian
    chol: Any  # Cholesky factor of cov
    log_evidence: float  # Laplace marginal-likelihood estimate

    def sample_unconstrained(self, key, n: int = 1):
        eps = jax.random.normal(key, (n, self.mean.shape[0]), self.mean.dtype)
        return self.mean[None, :] + eps @ self.chol.T

    def sample(self, key, n: int = 1) -> Dict[str, Any]:
        """n Gaussian posterior draws, mapped back to the constrained space
        (address → (n, *site_shape) arrays)."""
        zs = self.sample_unconstrained(key, n)
        staged = self.map_result.staged
        return jax.vmap(lambda z: staged.constrain(z)[0])(zs)

    def sd(self, address: str):
        """Marginal posterior sd of a site in the UNCONSTRAINED space."""
        staged = self.map_result.staged
        lo, hi = staged._offsets[str(address)]
        return jnp.sqrt(jnp.diag(self.cov)[lo:hi]).reshape(
            staged.site(address).shape
        )


def laplace_approximation(map_result: MAPResult, jitter: float = 0.0) -> LaplaceResult:
    """Gaussian posterior approximation at the MAP point.

    Curvature comes from ``jax.hessian`` of the staged unconstrained
    log-density — one compiled program, exact second derivatives (the
    reference cannot express this: no autodiff). ``jitter`` adds a ridge to
    −H before inversion for barely-identified directions.
    """
    staged = map_result.staged

    def build():
        def drive(z, disc):
            lj = lambda zz: staged.log_joint_unconstrained(zz, disc)
            h = jax.hessian(lj)(z)
            neg_h = -h + jitter * jnp.eye(h.shape[0], dtype=h.dtype)
            sign, logdet = jnp.linalg.slogdet(neg_h)
            cov = jnp.linalg.inv(neg_h)
            chol = jnp.linalg.cholesky(cov)
            d = z.shape[0]
            log_z = lj(z) + 0.5 * d * jnp.log(2.0 * jnp.pi) - 0.5 * logdet
            return cov, chol, sign, log_z

        return jax.jit(drive)

    drive = staged.cached_kernel(("laplace", jitter), build)
    cov, chol, sign, log_z = drive(map_result.z, map_result.discrete)
    if not bool(sign > 0) or not bool(jnp.all(jnp.isfinite(chol))):
        raise ValidationError(
            ErrorCode.INVALID_SHAPE,
            "negative Hessian at the MAP point is not positive definite — "
            "not a local maximum (or a flat direction); increase "
            "n_iterations, try optimizer='lbfgs', or pass jitter>0.",
            context={"sign": float(sign)},
        )
    return LaplaceResult(
        map_result=map_result,
        mean=map_result.z,
        cov=cov,
        chol=chol,
        log_evidence=float(log_z),
    )
