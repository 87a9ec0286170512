"""Large data as runtime arguments (StagedModel.data_leaves / bind_data).

Array-valued ``stage()`` arguments above DATA_ARG_BYTES flow into the
HMC/NUTS/ChEES drives as traced jit arguments instead of baked closure
constants — baked constants would be copied into every compiled drive and
force a recompile for new data."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fugue_tpu as ft
from fugue_tpu.inference.chees import chees_chain
from fugue_tpu.inference.nuts import nuts_chain


def _linreg_model(X, y):
    w = ft.sample("w", ft.Normal(0.0, 1.0), sample_shape=(X.shape[1],))
    ft.observe("y", ft.Normal(X @ w, 1.0), y)


def _make(n=40_000, d=8, seed=0):
    rng = np.random.default_rng(seed)
    X = jnp.asarray(rng.normal(0, 1, (n, d)) / np.sqrt(d), jnp.float32)
    w_true = rng.normal(0, 1, d)
    y = jnp.asarray(X @ jnp.asarray(w_true, jnp.float32)
                    + jnp.asarray(rng.normal(0, 1, n), jnp.float32))
    return X, y, w_true


def test_large_args_detected_small_args_not():
    X, y, _ = _make()  # X: 40k x 8 f32 = 1.25 MiB > the 1 MiB threshold
    staged = ft.stage(_linreg_model, X, y)
    leaves = staged.data_leaves()
    assert len(leaves) == 1 and leaves[0] is X  # y is 156 KiB — baked

    small = ft.stage(_linreg_model, X[:100], y[:100])
    assert small.data_leaves() == []


@pytest.mark.parametrize("engine", ["hmc", "nuts", "chees"])
def test_engines_recover_posterior_with_data_args(engine):
    X, y, w_true = _make()
    staged = ft.stage(_linreg_model, X, y)
    assert staged.data_leaves()
    kw = dict(staged=staged, n_samples=150, n_warmup=150)
    if engine == "hmc":
        res = ft.hmc_chain(jax.random.PRNGKey(1), n_chains=8, **kw)
    elif engine == "nuts":
        res = nuts_chain(jax.random.PRNGKey(1), n_chains=8, **kw)
    else:
        res = chees_chain(jax.random.PRNGKey(1), n_chains=16, **kw)
    w_post = np.asarray(res.samples["w"]).mean((0, 1))
    # N=40k >> d=8: posterior concentrates tightly on the truth
    np.testing.assert_allclose(w_post, w_true, atol=0.05)


def test_data_args_match_closure_constants_exactly():
    """Same model, same key: data-as-arguments and closure-captured data
    yield bit-identical draws (binding only changes HOW data reaches the
    compiled program, not the program)."""
    X, y, _ = _make()
    staged_args = ft.stage(_linreg_model, X, y)

    def closure_model():
        _linreg_model(X, y)

    staged_clo = ft.stage(closure_model)
    assert staged_clo.data_leaves() == []  # closure capture: not detected

    r1 = ft.hmc_chain(jax.random.PRNGKey(3), staged=staged_args,
                      n_samples=50, n_warmup=50, n_chains=4)
    r2 = ft.hmc_chain(jax.random.PRNGKey(3), staged=staged_clo,
                      n_samples=50, n_warmup=50, n_chains=4)
    np.testing.assert_allclose(
        np.asarray(r1.positions), np.asarray(r2.positions), rtol=1e-6
    )


def test_bind_data_restores_on_exit():
    X, y, _ = _make()
    staged = ft.stage(_linreg_model, X, y)
    orig_args = staged.args
    with staged.bind_data([X + 1.0]):
        assert staged.args[0] is not X
    assert staged.args is orig_args or staged.args[0] is X


def test_sharded_hmc_threads_data_args():
    """Sharded drives also take large stage() data as traced arguments
    (replicated per shard) — the multi-device counterpart of the single-device
    data-as-arguments path."""
    from fugue_tpu.parallel.mesh import make_chain_mesh
    from fugue_tpu.parallel.sharded import sharded_hmc_chain

    X, y, w_true = _make(n=40_000, d=8, seed=1)
    staged = ft.stage(_linreg_model, X, y)
    assert staged.data_leaves()
    mesh = make_chain_mesh()
    res = sharded_hmc_chain(jax.random.PRNGKey(0), staged=staged,
                            n_samples=80, n_warmup=80, n_chains=8,
                            mesh=mesh)
    w_post = np.asarray(res.samples["w"]).mean((0, 1))
    # N=40k >> d: the posterior is tight; 8x80 draws suffice for 0.08
    np.testing.assert_allclose(w_post, w_true, atol=0.08)


def test_bind_data_rejects_misaligned_leaf_count():
    """ADVICE r3 (low): bind_data zips replacement leaves positionally
    against the nbytes/dtype-filtered index list; a silent length mismatch
    would bind the wrong arrays to the wrong slots."""
    import pytest

    from fugue_tpu.errors import StagingError

    data = {"y": jnp.zeros(4)}

    def model(d):
        mu = ft.sample("mu", ft.Normal(0.0, 1.0))
        ft.observe("y", ft.Normal(mu, 1.0), d["y"])

    staged = ft.stage(model, data)
    good = staged.data_leaves(min_bytes=0)
    with staged.bind_data(good, min_bytes=0):
        pass  # exact count is fine
    with pytest.raises(StagingError, match="replacement leaves"):
        with staged.bind_data(good + [jnp.zeros(4)], min_bytes=0):
            pass


def test_vi_threads_data_args():
    """VI drives (mean-field + full-rank) pass large stage() data in as
    traced jit arguments (r4: at-scale VI needs the same compile-payload
    discipline as the gradient drives) — bit-identical to closure capture."""
    from fugue_tpu.inference.vi import (
        VIConfig, optimize_fullrank_vi, optimize_meanfield_vi,
    )

    X, y, w_true = _make()
    staged_args = ft.stage(_linreg_model, X, y)
    assert staged_args.data_leaves()

    def closure_model():
        _linreg_model(X, y)

    staged_clo = ft.stage(closure_model)
    cfg = VIConfig(n_iterations=200, n_samples=8)
    r1 = optimize_meanfield_vi(jax.random.PRNGKey(5), staged=staged_args,
                               config=cfg)
    r2 = optimize_meanfield_vi(jax.random.PRNGKey(5), staged=staged_clo,
                               config=cfg)
    np.testing.assert_allclose(r1.elbo_history, r2.elbo_history, rtol=1e-6)
    w1 = np.asarray(r1.params["w"]["loc"])
    np.testing.assert_allclose(w1, w_true, atol=0.05)

    rf = optimize_fullrank_vi(jax.random.PRNGKey(6), staged=staged_args,
                              config=cfg)
    assert np.isfinite(rf.elbo_history).all()
