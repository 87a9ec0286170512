"""Parallel tempering: sampling a multimodal posterior HMC cannot mix.

Beyond-parity engine (no reference counterpart; the reference's
closest machinery is the SEQUENTIAL likelihood-tempering ladder inside SMC,
src/inference/smc.rs:455-580 — here all K rungs run simultaneously as one
vectorized batch axis with replica-exchange swaps).

Target: x ~ 0.3·N(−4, 0.4) + 0.7·N(+4, 0.4). The modes are ~20σ apart;
a single-temperature HMC chain freezes in whichever mode it starts in,
while 8 geometric rungs down to β = 0.02 ferry states across. Ends in
closed-form asserts (the reference pattern: examples double as regression
tests, e.g. examples/smc_inference.rs:96-110).

Run: PYTHONPATH=. JAX_PLATFORMS=cpu JAX_ENABLE_X64=true \
     python examples/parallel_tempering.py
"""

import jax
import jax.numpy as jnp
import numpy as np

import fugue_tpu as ft


def bimodal_model():
    x = ft.sample("x", ft.Normal(0.0, 10.0))
    mix = jnp.logaddexp(
        jnp.log(0.3) + ft.Normal(-4.0, 0.4).log_prob(x),
        jnp.log(0.7) + ft.Normal(4.0, 0.4).log_prob(x),
    )
    # score the mixture; cancel the broad instrumental prior
    ft.factor(mix - ft.Normal(0.0, 10.0).log_prob(x))
    return x


def main():
    key = jax.random.PRNGKey(0)

    res = ft.pt_chain(
        key,
        bimodal_model,
        n_samples=1500,
        n_warmup=500,
        config=ft.PTConfig(n_temps=8, beta_min=0.02, n_leapfrog=12),
        n_chains=16,
    )
    xs = np.asarray(res.samples["x"]).ravel()
    w_right = float(np.mean(xs > 0))
    mean = float(xs.mean())
    print(f"P(right mode) = {w_right:.3f}  (exact 0.700)")
    print(f"E[x]          = {mean:+.3f}  (exact {0.7 * 4 - 0.3 * 4:+.3f})")
    print("swap rate per rung pair:",
          np.round(np.asarray(res.swap_rate), 3))
    print("adapted step size per rung (hot → cold):",
          np.round(np.asarray(res.step_size), 3))

    # closed-form checks
    assert abs(w_right - 0.7) < 0.06, w_right
    assert abs(mean - 1.6) < 0.35, mean
    assert np.all(np.asarray(res.swap_rate) > 0.05)

    # contrast: plain HMC chains never cross the barrier
    hres = ft.hmc_chain(
        jax.random.fold_in(key, 1), bimodal_model,
        n_samples=1500, n_warmup=500, n_chains=16,
    )
    hx = np.asarray(hres.samples["x"])
    flip_frac = float(np.mean(np.any(hx > 0, axis=1) & np.any(hx < 0, axis=1)))
    print(f"HMC chains that ever visited both modes: {flip_frac:.2f}")
    assert flip_frac < 0.2  # the barrier really is impassable without rungs
    print("parallel tempering example OK")


if __name__ == "__main__":
    main()
