"""ChEES-HMC: trajectory lengths learned from the chain batch.

hierarchical_models.py runs eight-schools with NUTS; this example runs the
Lock-step alternative: every chain shares ONE jittered trajectory length,
learned by gradient ascent on the ChEES criterion from cross-chain
statistics (Hoffman, Radul & Sountsov 2021). No per-chain control flow —
the batch stays lock-step, which is why this engine exists for
accelerators and has no counterpart in the reference (its HMC takes a
fixed user-chosen L, src/inference/hmc.rs:105-135).

Run: PYTHONPATH=. python examples/chees_hmc.py
"""

import jax
import jax.numpy as jnp
import numpy as np

import fugue_tpu as ft

jax.config.update("jax_enable_x64", True)

# Correlated Gaussian: the long principal axis (sd ~ sqrt(1.9)) needs a
# trajectory several step-sizes long; ChEES has to find that on its own.
RHO = 0.9
COV = jnp.array([[1.0, RHO], [RHO, 1.0]])


def model():
    ft.sample("x", ft.MultivariateNormal(jnp.zeros(2), COV))


res = ft.chees_chain(
    jax.random.PRNGKey(0),
    model,
    n_samples=1000,
    n_warmup=1000,
    n_chains=64,
)

x = np.asarray(res.samples["x"]).reshape(-1, 2)
cov_hat = np.cov(x.T)
print(f"learned max trajectory length T = {res.trajectory_length:.2f} "
      f"(step size {res.step_size:.3f}, mean {res.mean_leapfrog:.1f} leapfrogs)")
print(f"sample covariance:\n{cov_hat}")
print(f"acceptance {float(np.mean(res.accept_prob)):.2f}, "
      f"divergences {float(np.mean(res.divergences)):.4f}")

# closed form: mean 0, covariance COV
assert np.allclose(x.mean(0), [0.0, 0.0], atol=0.06)
assert np.allclose(cov_hat, np.asarray(COV), atol=0.12)
# the learned trajectory must be a multi-step one (not a random-walk L=1)
assert res.mean_leapfrog > 1.5
assert float(np.mean(res.divergences)) < 0.01

# Post-run criterion check: on large-d data-informed targets the default
# full-state criterion can silently flatten (use criterion="snaper" there);
# criterion_advice() measures the residual anisotropy that causes it from
# this run's own samples. Here the diagonal mass preconditions the target
# well, so no switch is advised.
advice = res.criterion_advice()
print(f"criterion advice: {advice['reason']}")
assert advice["recommendation"] is None
print("ok")
