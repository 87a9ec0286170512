"""Beta-Bernoulli coin flip — the canonical first model.

Reference: examples/bayesian_coin_flip.rs:9-26. Prior Beta(2,2); 10 flips
with 7 heads → posterior Beta(9,5); closed-form checks at the end (the
reference pattern: examples double as regression tests).

Run: PYTHONPATH=. python examples/bayesian_coin_flip.py
"""

import jax
import jax.numpy as jnp
import numpy as np

import fugue_tpu as ft


def coin_model():
    p = ft.sample("p", ft.Beta(2.0, 2.0))
    flips = jnp.array([1, 0, 1, 1, 0, 1, 1, 1, 0, 1], dtype=bool)
    ft.observe("flips", ft.Bernoulli(p), flips)
    return p


def main():
    # 1024 vectorized chains of adaptive single-site MH
    res = ft.adaptive_mcmc_chain(
        jax.random.PRNGKey(0), coin_model,
        n_samples=500, n_warmup=500, n_chains=1024,
    )
    ft.print_diagnostics(res.samples)

    ps = np.asarray(res.samples["p"])
    post_mean = 9.0 / 14.0
    post_var = 9 * 5 / (14.0**2 * 15.0)
    assert abs(ps.mean() - post_mean) < 0.01, ps.mean()
    assert abs(ps.var() - post_var) / post_var < 0.1, ps.var()
    print(f"posterior mean {ps.mean():.4f} (exact {post_mean:.4f}) -- OK")


if __name__ == "__main__":
    main()
