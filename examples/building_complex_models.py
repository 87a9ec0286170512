"""Building complex models: effects, plates, scoped addresses, combinators.

Reference: examples/building_complex_models.rs (prob! do-notation, plate!
notation, scoped_addr!, sequencing combinators, hierarchical composition).
Array-program recast: models are plain Python functions issuing ``sample`` /
``observe`` / ``factor`` effects — Python's native do-notation — and plates
come in two flavors: the scalar ``ft.plate`` loop (per-index addresses, exact
reference semantics) and *vector sites* (one address, batched distribution),
which is the idiomatic staged form because it stages to a single fused op.

Run: PYTHONPATH=. python examples/building_complex_models.py
"""

import jax
import jax.numpy as jnp
import numpy as np

import fugue_tpu as ft


def main():
    key = jax.random.PRNGKey(0)

    print("=== 1. Do-notation is just Python ===")

    def simple():
        x = ft.sample("x", ft.Normal(0.0, 1.0))
        y = ft.sample("y", ft.Normal(x, 0.5))
        return x + y

    val, trace = ft.run(ft.PriorHandler(key), simple)
    print(f"x+y = {float(val):.3f}; log-prior {float(trace.log_prior):.3f}")

    print("\n=== 2. Monadic combinators (Model values) ===")
    m = ft.Model.sample("a", ft.Normal(0.0, 1.0)).bind(
        lambda a: ft.Model.sample("b", ft.Normal(a, 1.0)).map(lambda b: a + b))
    val, trace = ft.run(ft.PriorHandler(key), m)
    assert set(trace.addresses()) == {"a", "b"}
    seq = ft.sequence_vec([ft.Model.sample(ft.addr("s", i), ft.Normal(0.0, 1.0))
                           for i in range(3)])
    vals, _ = ft.run(ft.PriorHandler(key), seq)
    assert len(vals) == 3
    print(f"bind/map result {float(val):.3f}; sequence_vec -> {len(vals)} values")

    print("\n=== 3. Plates: scalar loop vs vector site ===")
    obs = jnp.array([1.2, -0.5, 2.1, 0.8, -1.0])

    def scalar_plate():
        mu = ft.sample("mu", ft.Normal(0.0, 2.0))
        ft.plate("obs", len(obs), lambda i: ft.observe(ft.addr("obs", i),
                                                       ft.Normal(mu, 1.0), obs[i]))
        return mu

    def vector_plate():
        mu = ft.sample("mu", ft.Normal(0.0, 2.0))
        ft.observe("obs", ft.Normal(mu, 1.0), obs)  # one batched site
        return mu

    s1 = ft.stage(scalar_plate)
    s2 = ft.stage(vector_plate)
    lats = {"mu": jnp.array(0.3)}
    ll1 = float(s1.log_density_parts(lats).log_likelihood)
    ll2 = float(s2.log_density_parts(lats).log_likelihood)
    assert abs(ll1 - ll2) < 1e-6, (ll1, ll2)
    n1 = len(ft.run(ft.PriorHandler(key), scalar_plate)[1])
    n2 = len(ft.run(ft.PriorHandler(key), vector_plate)[1])
    print(f"identical likelihood {ll1:.4f}; scalar form records {n1} trace "
          f"entries, vector form {n2} (one fused op on the VPU)")

    print("\n=== 4. Scoped addresses for reusable components ===")

    def random_effect(scope: str):
        mu = ft.sample(ft.scoped_addr(scope, "mu"), ft.Normal(0.0, 1.0))
        sd = ft.sample(ft.scoped_addr(scope, "sd"), ft.LogNormal(0.0, 0.5))
        return mu, sd

    def two_groups():
        a = random_effect("group_a")
        b = random_effect("group_b")
        return a, b

    _, trace = ft.run(ft.PriorHandler(key), two_groups)
    assert len(trace) == 4
    print(f"addresses: {sorted(trace.addresses())}")

    print("\n=== 5. Hierarchical composition (eight-schools shape) ===")
    y = jnp.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
    sigma = jnp.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])

    def eight_schools():
        mu = ft.sample("mu", ft.Normal(0.0, 5.0))
        tau = ft.sample("tau", ft.LogNormal(0.0, 1.0))
        theta = ft.sample("theta", ft.Normal(jnp.full(8, 0.0), 1.0))  # non-centered
        ft.observe("y", ft.Normal(mu + tau * theta, sigma), y)
        return mu

    res = ft.nuts_chain(jax.random.PRNGKey(1), eight_schools,
                        n_samples=400, n_warmup=400, n_chains=8)
    mu_hat = float(np.asarray(res.samples["mu"]).mean())
    print(f"posterior mean mu = {mu_hat:.2f} (expect ~ 4-5)")
    assert 1.0 < mu_hat < 9.0

    print("\n=== 6. guard() prunes regions via -inf factors ===")

    def positive_only():
        x = ft.sample("x", ft.Normal(1.0, 1.0))
        ft.guard(x > 0)
        return x

    staged = ft.stage(positive_only)
    assert np.isneginf(float(staged.log_joint({"x": jnp.array(-1.0)})))
    assert np.isfinite(float(staged.log_joint({"x": jnp.array(1.0)})))
    print("guard(x > 0): log-joint is -inf at x=-1, finite at x=+1")
    print("OK")


if __name__ == "__main__":
    main()
