"""Automatic enumeration of discrete latents: ``marginalize()``.

mixture_models.py writes the mixture logsumexp by hand; this example lets
the framework do it. ``marginalize(model_fn)`` sums every enumerable
discrete latent (Bernoulli switches, Categorical indicators, small integer
ranges) out of the joint — the cartesian product of assignments is one
static vmap axis — so HMC/NUTS/VI run on the smooth marginal, and
``infer_discrete`` afterwards draws the discrete sites from their EXACT
conditionals p(d | theta, data). (SURVEY.md §7 hard part 2; the reference's
only option is holding discrete sites fixed, src/inference/hmc.rs:69-71.)

Run: PYTHONPATH=. python examples/marginalized_discrete.py
"""

import jax
import jax.numpy as jnp
import numpy as np
from scipy import stats

import fugue_tpu as ft

jax.config.update("jax_enable_x64", True)

Y = 1.5


def switch_model():
    # A regime indicator shifts the mean of the observation process.
    z = ft.sample("z", ft.Bernoulli(0.3))
    theta = ft.sample("theta", ft.Normal(0.0, 1.0))
    mu = jnp.where(z, 2.0, -2.0)
    ft.observe("y", ft.Normal(theta + mu, 1.0), jnp.array(Y))


# Sum z out: the target over theta is a smooth 2-component mixture.
marg = ft.marginalize(switch_model)
print(f"enumerated joint states: {marg.n_states}")

res = ft.hmc_chain(
    jax.random.PRNGKey(0),
    staged=marg,
    n_samples=2000,
    n_warmup=1000,
    n_chains=8,
    config=ft.HMCConfig(n_leapfrog=16),
)
theta = np.asarray(res.samples["theta"]).reshape(-1)

# Complete the joint posterior: exact conditional draws of z per theta draw.
zs = marg.infer_discrete(jax.random.PRNGKey(1), res.samples)
z = np.asarray(zs["z"]).reshape(-1)

# Ground truth by quadrature over theta.
grid = np.linspace(-9.0, 9.0, 40001)
j0 = np.log(0.7) + stats.norm.logpdf(Y, loc=grid - 2.0) + stats.norm.logpdf(grid)
j1 = np.log(0.3) + stats.norm.logpdf(Y, loc=grid + 2.0) + stats.norm.logpdf(grid)
logp = np.logaddexp(j0, j1)
w = np.exp(logp - logp.max())
w /= w.sum()
mean_true = float(np.sum(w * grid))
var_true = float(np.sum(w * (grid - mean_true) ** 2))
p1_true = float(np.sum(np.exp(j1 - logp) * w))  # E_theta[P(z=1 | theta, y)]

print(f"E[theta | y]   sampled {theta.mean():+.3f}  quadrature {mean_true:+.3f}")
print(f"V[theta | y]   sampled {theta.var():.3f}   quadrature {var_true:.3f}")
print(f"P(z=1 | y)     sampled {z.mean():.3f}   quadrature {p1_true:.3f}")

assert abs(theta.mean() - mean_true) < 0.05
assert abs(theta.var() - var_true) < 0.15 * var_true + 0.02
assert abs(z.mean() - p1_true) < 0.04
print("ok")
