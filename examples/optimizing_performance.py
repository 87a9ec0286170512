"""Optimizing performance: stable numerics, kernel caching, vectorized scaling.

Reference: examples/optimizing_performance.rs (log-space numerics, trace reuse,
efficient handler patterns, timing harness). Array-program recast: the big wins
are architectural — stage once + cache compiled kernels (never rebuild a
``jax.jit`` closure per call), batch chains as an array axis instead of a
Python loop, and keep everything in log space on the VPU. ``time_jit``
separates compile time from steady-state run time.

Run: PYTHONPATH=. python examples/optimizing_performance.py
"""

import jax

# these asserts are tuned for f64 (the documented way to run the
# examples); self-configure so `python examples/...` works anywhere
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import fugue_tpu as ft
from fugue_tpu.utils.profiling import time_jit


def main():
    print("=== 1. Log-space numerics never overflow ===")
    extreme = jnp.array([700.0, 701.0, 699.0, 698.0])  # exp() would overflow
    lz = float(ft.log_sum_exp(extreme))
    probs = ft.normalize_log_probs(extreme)
    print(f"log-normalizer {lz:.2f}; probabilities sum to "
          f"{float(probs.sum()):.10f}")
    assert np.isfinite(lz) and abs(float(probs.sum()) - 1.0) < 1e-9
    w = float(ft.weighted_log_sum_exp(jnp.array([-1.0, -2.0, -3.0, -4.0]),
                                      jnp.array([0.4, 0.3, 0.2, 0.1])))
    print(f"weighted log-sum-exp {w:.4f}; safe_log(0) = {float(ft.safe_log(0.0))}")

    print("\n=== 2. Stage once, reuse the compiled kernel ===")
    obs = jnp.asarray(np.random.default_rng(0).normal(1.0, 0.5, 256))

    def model():
        mu = ft.sample("mu", ft.Normal(0.0, 5.0))
        sigma = ft.sample("sigma", ft.LogNormal(0.0, 1.0))
        ft.observe("y", ft.Normal(mu, sigma), obs)
        return mu

    staged = ft.stage(model)
    logp = jax.jit(staged.log_joint)
    lats = staged.sample_prior(jax.random.PRNGKey(0))
    t = time_jit(logp, lats)
    print(f"log-joint over 256 observations: {t}")
    # The kernel cache means engines never re-jit for the same static config.
    k1 = staged.cached_kernel("demo", lambda: logp)
    k2 = staged.cached_kernel("demo", lambda: jax.jit(staged.log_joint))
    assert k1 is k2
    print("cached_kernel returns the same compiled object for the same key")

    print("\n=== 3. Chains are an array axis, not a loop ===")
    for n_chains in (64, 1024):
        res = ft.adaptive_mcmc_chain(jax.random.PRNGKey(1), model,
                                     n_samples=100, n_warmup=100,
                                     n_chains=n_chains)
        n_draws = np.asarray(res.samples["mu"]).size
        print(f"  {n_chains:5d} chains -> {n_draws} draws in ONE compiled program")
    # 16x the chains costs far less than 16x the time on a vector machine:
    # the chain axis vectorizes into one batched program.

    print("\n=== 4. Gradients are free (autodiff), not 2d model runs ===")
    g = jax.jit(jax.grad(staged.potential))
    z = staged.initial_position(jax.random.PRNGKey(2))
    tg = time_jit(g, z)
    print(f"exact gradient of the log-joint: {tg}")
    # the reference needs 2*d model evaluations per gradient (hmc.rs:304-329);
    # reverse-mode autodiff computes it in O(1) model evaluations.

    print("\n=== 5. print-style cost introspection ===")
    from fugue_tpu.utils.profiling import cost_summary
    cs = cost_summary(staged.log_joint, lats)
    print(f"XLA cost analysis of the staged log-joint: {cs}")
    print("OK")


if __name__ == "__main__":
    main()
