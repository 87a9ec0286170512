"""End-to-end smoke: model DSL → handlers → staging → log densities."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fugue_tpu as ft


def coin_model():
    # Beta-Bernoulli coin flip (reference: examples/bayesian_coin_flip.rs:9-26)
    p = ft.sample("p", ft.Beta(2.0, 2.0))
    obs = jnp.array([1.0, 0.0, 1.0, 1.0, 0.0, 1.0, 1.0, 1.0, 0.0, 1.0])
    ft.observe("flips", ft.Bernoulli(p), obs.astype(bool))
    return p


def test_prior_handler_records_trace():
    result, trace = ft.run(ft.PriorHandler(jax.random.PRNGKey(0)), coin_model)
    assert "p" in trace and "flips" in trace
    assert 0.0 < float(result) < 1.0
    assert np.isfinite(float(trace.log_prior))
    assert np.isfinite(float(trace.log_likelihood))
    assert float(trace.total_log_weight()) == pytest.approx(
        float(trace.log_prior) + float(trace.log_likelihood), rel=1e-6
    )


def test_replay_and_score_agree():
    _, t1 = ft.run(ft.PriorHandler(jax.random.PRNGKey(1)), coin_model)
    _, t2 = ft.run(ft.ReplayHandler(jax.random.PRNGKey(2), t1), coin_model)
    assert float(t1.get_real("p")) == pytest.approx(float(t2.get_real("p")))
    _, t3 = ft.score_given_trace(coin_model, t1)
    assert float(t3.log_prior) == pytest.approx(float(t1.log_prior), rel=1e-6)


def test_staging_log_density_matches_handler():
    staged = ft.stage(coin_model)
    assert [s.address for s in staged.sites] == ["p"]
    latents = staged.sample_prior(jax.random.PRNGKey(3))
    parts = staged.log_density_parts(latents)
    _, t = ft.run(ft.PriorHandler(jax.random.PRNGKey(3)), coin_model)
    # same key -> same value -> same densities
    assert float(parts.log_prior) == pytest.approx(float(t.log_prior), rel=1e-6)
    assert float(parts.log_likelihood) == pytest.approx(
        float(t.log_likelihood), rel=1e-6
    )


def test_staged_potential_grad():
    staged = ft.stage(coin_model)
    z = staged.initial_position(jax.random.PRNGKey(4))
    assert z.shape == (1,)
    u = staged.potential(z)
    g = jax.grad(staged.potential)(z)
    assert np.isfinite(float(u))
    assert np.isfinite(float(g[0]))
    # vmap across chains
    zs = jnp.stack([z, z + 0.1, z - 0.1])
    us = jax.vmap(staged.potential)(zs)
    assert us.shape == (3,)


def test_jit_log_joint():
    staged = ft.stage(coin_model)
    f = jax.jit(staged.potential)
    z = staged.initial_position(jax.random.PRNGKey(5))
    assert np.isfinite(float(f(z)))


def test_duplicate_address_raises():
    def bad():
        ft.sample("x", ft.Normal(0.0, 1.0))
        ft.sample("x", ft.Normal(0.0, 1.0))

    with pytest.raises(ft.ModelStructureError):
        ft.run(ft.PriorHandler(jax.random.PRNGKey(0)), bad)


def test_address_escaping_injective():
    # reference regression: addr("a#1") != addr("a", 1)  (address.rs:174-223)
    assert ft.addr("a#1") != ft.addr("a", 1)
    assert ft.addr("a", 1) == "a#1"
    assert ft.addr("a\\x") != ft.addr("a", "x")


def test_model_combinators():
    m = ft.Model.sample("x", ft.Normal(0.0, 1.0)).bind(
        lambda x: ft.Model.pure(x * 2)
    )
    result, trace = ft.run(ft.PriorHandler(jax.random.PRNGKey(0)), m)
    assert float(result) == pytest.approx(2 * float(trace.get_real("x")))

    seq = ft.sequence_vec(
        [ft.Model.sample(ft.addr("y", i), ft.Normal(0.0, 1.0)) for i in range(5)]
    )
    results, trace = ft.run(ft.PriorHandler(jax.random.PRNGKey(1)), seq)
    assert len(results) == 5 and len(trace) == 5


def test_guard_and_factor():
    def m():
        x = ft.sample("x", ft.Normal(0.0, 1.0))
        ft.guard(x < 1e9)  # always true
        ft.factor(-1.5)
        return x

    _, t = ft.run(ft.PriorHandler(jax.random.PRNGKey(0)), m)
    assert float(t.log_factors) == pytest.approx(-1.5)

    def m_bad():
        x = ft.sample("x", ft.Normal(0.0, 1.0))
        ft.guard(x > 1e9)  # always false
        return x

    _, t = ft.run(ft.PriorHandler(jax.random.PRNGKey(0)), m_bad)
    assert float(t.total_log_weight()) == -np.inf


def test_stack_safety_many_sites():
    """Reference parity: huge-site-count models run without stack growth
    (handler.rs:256-316 tests 100k sites in a 512KiB-stack thread). Here
    sites are loop iterations, trivially O(1) stack; 10k sites keeps the
    eager-dispatch test fast. The full 100k-site run was measured once at
    76 s on this host (2-CPU, eager per-site jax dispatch ~0.76 ms/site,
    linear in #sites, constant memory) — the cost curve is documented in
    docs/performance.md; the scaling story on the device is vectorized sites, not
    100k scalar ones."""
    n = 10_000

    def big():
        total = 0.0
        for i in range(n):
            total = total + ft.sample(ft.addr("x", i), ft.Normal(0.0, 1.0))
        return total

    _, t = ft.run(ft.PriorHandler(jax.random.PRNGKey(0)), big)
    assert len(t) == n


def test_vectorized_plate_site():
    def m():
        mu = ft.sample("mu", ft.Normal(0.0, 1.0))
        ft.sample("eps", ft.Normal(0.0, 1.0), sample_shape=(64,))
        ft.observe("y", ft.Normal(mu, 1.0), jnp.zeros(64))
        return mu

    staged = ft.stage(m)
    eps_site = staged.site("eps")
    assert eps_site.shape == (64,)
    assert staged.dim == 65
    z = staged.initial_position(jax.random.PRNGKey(0))
    assert z.shape == (65,)
    assert np.isfinite(float(staged.potential(z)))
