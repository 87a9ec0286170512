"""Production patterns: robust handlers, input validation, health checks,
checkpoint/resume.

Reference: examples/production_deployment.rs:12-753 (robust handlers, health
checks, input validators). Additions here: checkpointed long runs and the
convergence gate as a deployment health check.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

import fugue_tpu as ft
from fugue_tpu.runtime.checkpoint import load_checkpoint, save_checkpoint


def validate_inputs(data: np.ndarray) -> np.ndarray:
    """Input validator: reject NaN/inf before they poison a trace."""
    arr = np.asarray(data, dtype=np.float64)
    if not np.all(np.isfinite(arr)):
        raise ValueError(f"non-finite observations: {np.sum(~np.isfinite(arr))}")
    return arr


def main():
    raw = [1.2, 0.8, 1.5, 0.9, 1.1]
    data = jnp.asarray(validate_inputs(raw))

    def model():
        mu = ft.sample("mu", ft.Normal(0.0, 2.0))
        ft.observe("ys", ft.Normal(mu, 1.0), data)
        return mu

    # 1. Health check: the validation harness as a deployment gate
    report = ft.validate_conjugate_normal(jax.random.PRNGKey(11), "hmc")
    print(report.report())
    assert report.passed

    # 2. Robust scoring: bad external traces degrade, they don't crash
    _, good_trace = ft.run(ft.PriorHandler(jax.random.PRNGKey(0)), model)
    corrupted = good_trace.copy()
    del corrupted.choices["mu"]
    import warnings as w

    with w.catch_warnings():
        w.simplefilter("ignore")
        _, scored = ft.score_given_trace_safe(model, corrupted)
    assert float(scored.total_log_weight()) == -np.inf
    print("corrupted trace degraded to -inf -- OK")

    # 3. Checkpoint / resume a long sampling job
    staged = ft.stage(model)
    from fugue_tpu.inference.mh import init_mh_state, mh_step

    state = jax.vmap(lambda k: init_mh_state(staged, k))(
        jax.random.split(jax.random.PRNGKey(1), 64)
    )
    step = jax.jit(jax.vmap(lambda st, k: mh_step(staged, st, k, True)))
    for i in range(100):
        state, _ = step(state, jax.random.split(jax.random.fold_in(jax.random.PRNGKey(2), i), 64))

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "run.npz")
        save_checkpoint(path, state)
        resumed = load_checkpoint(path, state)
    np.testing.assert_array_equal(
        np.asarray(state.latents["mu"]), np.asarray(resumed.latents["mu"])
    )
    print("checkpoint round-trip after 100 transitions -- OK")

    # 4. Convergence gate before serving results
    res = ft.hmc_chain(jax.random.PRNGKey(3), model, n_samples=500,
                       n_warmup=500, n_chains=8)
    summaries = ft.summarize_samples(res.samples)
    worst = max(s.r_hat for s in summaries)
    assert worst < 1.05, f"refusing to serve: R-hat {worst}"
    print(f"serving gate passed (max R-hat {worst:.4f}) -- OK")


if __name__ == "__main__":
    main()
