"""Advanced distribution patterns: hierarchical priors, mixtures, truncation,
reparameterization, and compound distributions.

Reference: examples/advanced_distribution_patterns.rs (hierarchical priors,
mixture components, truncation-by-rejection, parameter transforms). Array-program
recast: truncation is a ``guard``/``factor`` mass correction instead of a
rejection loop; mixtures marginalize components with ``log_sum_exp`` so HMC
gets exact gradients; positive/unit-interval sites ride the automatic
unconstraining transforms.

Run: PYTHONPATH=. python examples/advanced_distribution_patterns.py
"""

import jax

# these asserts are tuned for f64 (the documented way to run the
# examples); self-configure so `python examples/...` works anywhere
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
from scipy import stats

import fugue_tpu as ft


def main():
    key = jax.random.PRNGKey(0)

    print("=== 1. Hierarchical priors ===")

    def hierarchy():
        mu = ft.sample("mu", ft.Normal(0.0, 10.0))          # global mean
        tau = ft.sample("tau", ft.Gamma(2.0, 0.5))          # group precision
        sigma = 1.0 / jnp.sqrt(tau)
        ft.sample("individual", ft.Normal(mu, sigma))
        return mu, sigma

    (mu, sigma), trace = ft.run(ft.PriorHandler(key), hierarchy)
    print(f"global mu {float(mu):.3f}, group sd {float(sigma):.3f}, "
          f"log-prior {float(trace.log_prior):.3f}")

    print("\n=== 2. Mixtures: explicit component vs marginalized ===")
    weights = jnp.array([0.6, 0.3, 0.1])
    locs = jnp.array([-2.0, 0.0, 3.0])
    scales = jnp.array([0.5, 1.0, 0.8])

    def explicit_mixture():
        z = ft.sample("z", ft.Categorical(probs=weights))
        x = ft.sample("x", ft.Normal(locs[z], scales[z]))
        return x

    x, _ = ft.run(ft.PriorHandler(key), explicit_mixture)
    print(f"explicit (discrete z in the trace): x = {float(x):.3f}")

    def marginal_logpdf(x):
        # sum_k w_k N(x | loc_k, scale_k) in log space — differentiable, no
        # discrete site, the form HMC/NUTS wants.
        comp = ft.Normal(locs, scales).log_prob(x) + jnp.log(weights)
        return ft.log_sum_exp(comp)

    def marginal_mixture():
        x = ft.sample("x", ft.Normal(0.0, 10.0))
        ft.factor(marginal_logpdf(x) - ft.Normal(0.0, 10.0).log_prob(x))
        return x

    res = ft.nuts_chain(jax.random.PRNGKey(1), marginal_mixture,
                        n_samples=2000, n_warmup=500, n_chains=8)
    xs = np.asarray(res.samples["x"]).ravel()
    true_mean = float((weights * locs).sum())
    print(f"marginalized mixture posterior mean {xs.mean():.3f} "
          f"(exact {true_mean:.3f})")
    assert abs(xs.mean() - true_mean) < 0.15

    print("\n=== 3. Truncation as an exact mass correction (no rejection loop) ===")
    # X ~ Normal(1, 1) truncated to x > 0: add -log P(X > 0) and guard.
    lo = 0.0
    log_mass = np.log(1 - stats.norm.cdf(lo, loc=1.0, scale=1.0))

    def truncated():
        x = ft.sample("x", ft.Normal(1.0, 1.0))
        ft.guard(x > lo)
        ft.factor(-log_mass)  # renormalize so the density integrates to 1
        return x

    staged = ft.stage(truncated)
    tn_mean = float(stats.truncnorm.mean(-1.0, np.inf, loc=1.0, scale=1.0))
    res = ft.hmc_chain(jax.random.PRNGKey(2), truncated, n_samples=2000,
                       n_warmup=500, config=ft.HMCConfig(n_leapfrog=16),
                       n_chains=8)
    xs = np.asarray(res.samples["x"]).ravel()
    xs = xs[xs > lo]  # guard rejects leaks; all retained draws are valid
    print(f"truncated-normal mean {xs.mean():.3f} (exact {tn_mean:.3f})")
    assert abs(xs.mean() - tn_mean) < 0.1

    print("\n=== 4. Automatic unconstraining transforms ===")

    def constrained():
        s = ft.sample("scale", ft.Gamma(2.0, 2.0))   # positive -> log transform
        p = ft.sample("prob", ft.Beta(2.0, 2.0))     # (0,1)    -> logit transform
        ft.observe("y", ft.Bernoulli(p), jnp.array([True, True, False]))
        return s, p

    st = ft.stage(constrained)
    z = st.unconstrain({"scale": jnp.array(1.5), "prob": jnp.array(0.25)})
    back, _ = st.constrain(z)
    assert abs(float(back["scale"]) - 1.5) < 1e-6
    assert abs(float(back["prob"]) - 0.25) < 1e-6
    print(f"unconstrained z = {np.round(np.asarray(z), 4)} "
          "(HMC runs here; Jacobians handled automatically)")

    print("\n=== 5. Compound pattern: Poisson rate with Gamma prior ===")
    # Gamma(a, rate b) prior + Poisson likelihood -> closed-form negative-
    # binomial marginal; posterior Gamma(a + sum y, b + n).
    a, b = 3.0, 1.0
    y = jnp.array([2, 4, 3, 5, 1, 2])

    def poisson_gamma():
        lam = ft.sample("lam", ft.Gamma(a, b))
        ft.observe("y", ft.Poisson(lam), y)
        return lam

    res = ft.nuts_chain(jax.random.PRNGKey(3), poisson_gamma,
                        n_samples=2000, n_warmup=500, n_chains=8)
    lam = np.asarray(res.samples["lam"]).ravel()
    post_mean = (a + float(y.sum())) / (b + len(y))
    print(f"posterior rate {lam.mean():.3f} (exact {post_mean:.3f})")
    assert abs(lam.mean() - post_mean) < 0.1
    print("OK")


if __name__ == "__main__":
    main()
