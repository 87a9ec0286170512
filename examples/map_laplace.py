"""MAP + Laplace: point estimates, credible intervals, and evidence.

Beyond-parity engine (the reference has no optimizer — its nearest
capability is the analytic-validation harness,
reference: src/inference/validation.rs:73-166). Pattern mirrors the other
runnable examples: closed-form asserts at the end.

Run on CPU: python examples/map_laplace.py
"""

import math

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_enable_x64", True)

import fugue_tpu as ft  # noqa: E402


def main():
    # ------------------------------------------------------------------
    # 1. Ridge regression: the MAP of a Gaussian model IS the ridge fit.
    # ------------------------------------------------------------------
    rng = np.random.default_rng(42)
    x = rng.normal(size=50)
    y = 1.5 * x + 0.5 + rng.normal(size=50) * 0.4
    tau, sigma = 10.0, 0.4

    def regression():
        a = ft.sample("a", ft.Normal(0.0, tau))
        b = ft.sample("b", ft.Normal(0.0, tau))
        ft.observe("y", ft.Normal(a * jnp.asarray(x) + b, sigma), jnp.asarray(y))

    r = ft.map_estimate(
        jax.random.PRNGKey(0), regression, ft.MAPConfig(optimizer="lbfgs")
    )
    print(f"MAP slope     a = {float(r.latents['a']):+.4f}")
    print(f"MAP intercept b = {float(r.latents['b']):+.4f}")
    assert r.converged

    X = np.stack([x, np.ones_like(x)], axis=1)
    A = X.T @ X / sigma**2 + np.eye(2) / tau**2
    ridge = np.linalg.solve(A, X.T @ y / sigma**2)
    assert abs(float(r.latents["a"]) - ridge[0]) < 1e-6
    assert abs(float(r.latents["b"]) - ridge[1]) < 1e-6

    # Laplace credible intervals: exact for this Gaussian posterior.
    la = ft.laplace_approximation(r)
    sd_a = float(la.sd("a"))
    print(f"95% CI for a: [{float(r.latents['a']) - 1.96 * sd_a:+.4f}, "
          f"{float(r.latents['a']) + 1.96 * sd_a:+.4f}]")
    assert abs(sd_a - math.sqrt(np.linalg.inv(A)[0, 0])) < 1e-8

    # ------------------------------------------------------------------
    # 2. Model comparison by Laplace evidence: quadratic truth should beat
    #    the linear model on quadratic data.
    # ------------------------------------------------------------------
    y2 = 0.8 * x**2 - 0.2 * x + rng.normal(size=50) * 0.4

    def linear():
        a = ft.sample("a", ft.Normal(0.0, 2.0))
        b = ft.sample("b", ft.Normal(0.0, 2.0))
        ft.observe("y", ft.Normal(a * jnp.asarray(x) + b, sigma), jnp.asarray(y2))

    def quadratic():
        a = ft.sample("a", ft.Normal(0.0, 2.0))
        b = ft.sample("b", ft.Normal(0.0, 2.0))
        c = ft.sample("c", ft.Normal(0.0, 2.0))
        xx = jnp.asarray(x)
        ft.observe("y", ft.Normal(c * xx**2 + a * xx + b, sigma), jnp.asarray(y2))

    cfg = ft.MAPConfig(optimizer="lbfgs")
    lz_lin = ft.laplace_approximation(
        ft.map_estimate(jax.random.PRNGKey(1), linear, cfg)).log_evidence
    lz_quad = ft.laplace_approximation(
        ft.map_estimate(jax.random.PRNGKey(1), quadratic, cfg)).log_evidence
    print(f"log-evidence linear    = {lz_lin:10.2f}")
    print(f"log-evidence quadratic = {lz_quad:10.2f}")
    assert lz_quad > lz_lin + 10  # decisive Bayes factor for the truth

    # ------------------------------------------------------------------
    # 3. Warm-starting NUTS from the MAP point (common production pattern).
    # ------------------------------------------------------------------
    res = ft.nuts_chain(
        jax.random.PRNGKey(2), regression, n_samples=500, n_warmup=300,
        n_chains=4, init_position=r.z,
    )
    post_a = np.asarray(res.samples["a"]).mean()
    print(f"NUTS posterior mean a = {post_a:+.4f} (MAP {ridge[0]:+.4f})")
    assert abs(post_a - ridge[0]) < 4 * sd_a

    print("map_laplace example: OK")


if __name__ == "__main__":
    main()
