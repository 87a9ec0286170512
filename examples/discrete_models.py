"""Discrete latent variables: MH, Gibbs composition, and marginalization.

Reference: examples with discrete sites + the Metropolis-within-Gibbs
composition (hmc.rs:69-71). Three strategies, in order of preference:
1. marginalize enumerable discretes (exact, fastest on the device),
2. HMC-within-Gibbs for non-enumerable counts,
3. pure MH when everything is discrete.
"""

import jax
import jax.numpy as jnp
import numpy as np

import fugue_tpu as ft
from fugue_tpu.inference.gibbs import gibbs_chain


def main():
    # Strategy 1: marginalized mixture (exact)
    data = jnp.array([-2.1, -1.9, -2.2, 1.8, 2.1, 2.2, 1.9])

    def marginalized():
        mu0 = ft.sample("mu0", ft.Normal(-1.0, 3.0))
        mu1 = ft.sample("mu1", ft.Normal(1.0, 3.0))
        ft.guard(mu0 < mu1)  # ordering breaks label switching
        lp0 = jnp.log(0.5) + ft.Normal(mu0, 0.5).log_prob(data)
        lp1 = jnp.log(0.5) + ft.Normal(mu1, 0.5).log_prob(data)
        ft.factor(jnp.sum(jnp.logaddexp(lp0, lp1)))
        return mu0, mu1

    res = ft.hmc_chain(jax.random.PRNGKey(0), marginalized,
                       n_samples=800, n_warmup=500, n_chains=8)
    mu0 = float(np.asarray(res.samples["mu0"]).mean())
    mu1 = float(np.asarray(res.samples["mu1"]).mean())
    assert abs(mu0 + 2.0) < 0.3 and abs(mu1 - 2.0) < 0.3, (mu0, mu1)
    print(f"marginalized GMM: mu0={mu0:.2f}, mu1={mu1:.2f} -- OK")

    # Strategy 2: Gibbs for a mixed model
    def mixed():
        heads = ft.sample("heads", ft.Bernoulli(0.5))
        mu = ft.sample("mu", ft.Normal(jnp.where(heads, 1.0, -1.0), 1.0))
        ft.observe("y", ft.Normal(mu, 0.5), jnp.array([1.1, 0.9]))
        return mu

    gres = gibbs_chain(jax.random.PRNGKey(1), mixed,
                       n_samples=1000, n_warmup=400, n_chains=8)
    heads_rate = float(np.asarray(gres.samples["heads"], dtype=float).mean())
    assert heads_rate > 0.7, heads_rate
    print(f"gibbs mixed model: P(heads|data)={heads_rate:.2f} -- OK")

    # Strategy 3: pure MH on a fully discrete model
    def discrete_only():
        n = ft.sample("n", ft.Poisson(4.0))
        k = ft.sample("k", ft.Binomial(20, 0.3))
        ft.factor(-0.1 * jnp.abs(jnp.asarray(n - k, jnp.float64)))
        return n

    mres = ft.adaptive_mcmc_chain(jax.random.PRNGKey(2), discrete_only,
                                  n_samples=2000, n_warmup=500, n_chains=8)
    ns = np.asarray(mres.samples["n"], dtype=float)
    ks = np.asarray(mres.samples["k"], dtype=float)
    # the coupling factor pulls n and k together relative to their prior
    # means (E[n]=4, E[k]=6 → prior gap 2.0)
    assert abs(ns.mean() - ks.mean()) < 1.9
    print(f"discrete MH: E[n]={ns.mean():.2f}, E[k]={ks.mean():.2f} -- OK")


if __name__ == "__main__":
    main()
