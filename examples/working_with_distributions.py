"""Tour of the 17-distribution library: natural dtypes, log-densities, batching.

Reference: examples/working_with_distributions.rs (type-safety demo, continuous
and discrete tours, log_prob usage, parameter validation). Array-program recast:
every distribution is a pure ``(sample(key, shape), log_prob(x))`` pair —
sampling is functional over PRNG keys and broadcasts over leading batch axes,
so "draw 10,000 samples" is one vectorized call, not a loop.

Run: PYTHONPATH=. python examples/working_with_distributions.py
"""

import jax
import jax.numpy as jnp
import numpy as np

import fugue_tpu as ft


def main():
    key = jax.random.PRNGKey(0)

    print("=== 1. Natural return dtypes ===")
    flip = ft.Bernoulli(0.5).sample(key)
    assert flip.dtype == jnp.bool_
    count = ft.Poisson(3.0).sample(key)
    assert jnp.issubdtype(count.dtype, jnp.integer)
    idx = ft.Categorical(probs=jnp.array([0.6, 0.3, 0.1])).sample(key)
    assert jnp.issubdtype(idx.dtype, jnp.integer)
    x = ft.Normal(0.0, 1.0).sample(key)
    assert jnp.issubdtype(x.dtype, jnp.floating)
    print(f"Bernoulli→{flip.dtype}, Poisson→{count.dtype}, "
          f"Categorical→{idx.dtype}, Normal→{x.dtype}")

    print("\n=== 2. Log-densities are exact log-space formulas ===")
    # Peak of the standard normal: -0.5*log(2*pi)
    lp = float(ft.Normal.standard().log_prob(0.0))
    assert abs(lp - (-0.5 * np.log(2 * np.pi))) < 1e-6, lp
    print(f"Normal.standard().log_prob(0) = {lp:.6f}")
    # Bernoulli log-probs are stable at the boundary.
    assert float(ft.Bernoulli(1.0).log_prob(True)) == 0.0
    assert float(ft.Bernoulli(0.0).log_prob(False)) == 0.0

    print("\n=== 3. One vectorized call replaces a sampling loop ===")
    draws = ft.Gamma(2.0, 0.5).sample(key, (100_000,))
    mean, var = float(draws.mean()), float(draws.var())
    print(f"Gamma(2, rate=0.5): mean {mean:.3f} (exact 4), var {var:.3f} (exact 8)")
    assert abs(mean - 4.0) < 0.05 and abs(var - 8.0) < 0.5

    print("\n=== 4. Batched parameters broadcast ===")
    mus = jnp.linspace(-2.0, 2.0, 5)
    batch = ft.Normal(mus, 0.1).sample(key)  # one draw per mu
    assert batch.shape == (5,)
    lps = ft.Normal(mus, 0.1).log_prob(batch)
    assert lps.shape == (5,)
    print(f"5 means -> samples {np.round(np.asarray(batch), 2)}")

    print("\n=== 5. Infallible shortcut constructors ===")
    for d in (ft.Normal.standard(), ft.Uniform.unit(),
              ft.Beta.uniform_prior(), ft.Categorical.uniform(4)):
        print(f"  {type(d).__name__} ok, sample = {d.sample(key)}")

    print("\n=== 6. Parameter validation raises typed errors at trace time ===")
    for bad in (lambda: ft.Normal(0.0, -1.0),
                lambda: ft.Bernoulli(1.5),
                lambda: ft.Gamma(-2.0, 1.0)):
        try:
            bad()
            raise AssertionError("should have raised")
        except ft.FugueError as e:
            print(f"  {e.code.name}: {e}")

    print("\n=== 7. All 17 distributions ===")
    print(" ".join(sorted(d.__name__ for d in ft.ALL_DISTRIBUTIONS)))
    assert len(ft.ALL_DISTRIBUTIONS) == 17
    print("OK")


if __name__ == "__main__":
    main()
