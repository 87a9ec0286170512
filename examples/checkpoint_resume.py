"""Checkpoint/resume across engines: all inter-transition state lives in
the result (the reference's HmcSession discipline, hmc.rs:604-642), so a
long run splits into segments that continue exactly.

Demonstrates:
 1. NUTS: warm up once, then sample in two resumed segments;
 2. SMC: stop the tempering ladder mid-way (max_stages) and continue it
    BITWISE identically to an uninterrupted run;
 3. persistence round-trip through runtime.checkpoint (npz).

Run: PYTHONPATH=. python examples/checkpoint_resume.py
"""

import os
import tempfile

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import fugue_tpu as ft
from fugue_tpu.inference.smc import SMCConfig, adaptive_smc
from fugue_tpu.runtime.checkpoint import load_checkpoint, save_checkpoint

ys = jnp.array([1.2, 0.8, 1.5, 0.9, 1.1])
TAU = 0.25 + 5.0  # conjugate posterior: N(sum(y)/tau, 1/tau)
POST_MEAN, POST_SD = float(ys.sum()) / TAU, 1.0 / np.sqrt(TAU)


def model():
    mu = ft.sample("mu", ft.Normal(0.0, 2.0))
    ft.observe("ys", ft.Normal(mu, 1.0), ys)


def main():
    staged = ft.stage(model)

    # --- 1. NUTS in two resumed segments -------------------------------
    first = ft.nuts_chain(jax.random.PRNGKey(0), staged=staged,
                          n_samples=600, n_warmup=600, n_chains=8)
    second = ft.nuts_chain(jax.random.PRNGKey(1), staged=staged,
                           n_samples=600, n_warmup=0, n_chains=8,
                           resume=first)
    assert second.step_size == first.step_size  # warmed kernel carried over
    draws = np.concatenate([np.asarray(first.samples["mu"]),
                            np.asarray(second.samples["mu"])], axis=1)
    assert abs(draws.mean() - POST_MEAN) < 0.02
    assert abs(draws.std() - POST_SD) < 0.03
    print(f"NUTS split 2x600: mean={draws.mean():.4f} "
          f"(exact {POST_MEAN:.4f}), eps carried={second.step_size:.3f}")

    # --- 2. SMC ladder stopped and continued, bitwise ------------------
    def sharp():
        mu = ft.sample("mu", ft.Normal(0.0, 10.0))
        ft.observe("y", ft.Normal(mu, 0.05), jnp.array(3.0))

    st = ft.stage(sharp)
    cfg = SMCConfig(rejuvenation_steps=3)
    full = adaptive_smc(jax.random.PRNGKey(4), 2048, staged=st, config=cfg)
    part = adaptive_smc(jax.random.PRNGKey(4), 2048, staged=st,
                        config=SMCConfig(rejuvenation_steps=3, max_stages=2))
    assert not part.converged and part.beta < 1.0
    done = adaptive_smc(jax.random.PRNGKey(0), 2048, staged=st,
                        config=cfg, resume=part)
    np.testing.assert_array_equal(np.asarray(done.particles["mu"]),
                                  np.asarray(full.particles["mu"]))
    assert done.log_evidence == full.log_evidence
    print(f"SMC ladder: stopped at beta={part.beta:.3f} after "
          f"{part.n_stages} stages, resumed to beta=1 in "
          f"{done.n_stages} total — bitwise equal to the full run "
          f"(logZ={done.log_evidence:.3f})")

    # --- 3. persistence round-trip -------------------------------------
    path = os.path.join(tempfile.mkdtemp(), "smc_state.npz")
    save_checkpoint(path, part.state)
    restored = load_checkpoint(path, part.state)
    resumed = adaptive_smc(jax.random.PRNGKey(0), 2048, staged=st,
                           config=cfg,
                           resume=type(part)(  # state is all that matters
                               particles=part.particles,
                               log_weights=part.log_weights,
                               weights=part.weights,
                               log_evidence=part.log_evidence,
                               n_stages=part.n_stages, ess=part.ess,
                               beta=part.beta, converged=False,
                               state=restored))
    assert resumed.log_evidence == full.log_evidence
    print("checkpoint round-trip: resumed-from-disk logZ matches — OK")


if __name__ == "__main__":
    main()
