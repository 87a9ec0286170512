"""Multi-device inference: chains and particles across a mesh.

Runs on any device set — several GPUs or a virtual CPU mesh:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        PYTHONPATH=. python examples/sharded_inference.py
"""

import jax
import jax.numpy as jnp
import numpy as np

import fugue_tpu as ft
from fugue_tpu.parallel.mesh import make_chain_mesh
from fugue_tpu.inference.vi import VIConfig
from fugue_tpu.parallel.sharded import sharded_hmc_chain, sharded_smc, sharded_vi


def coin():
    p = ft.sample("p", ft.Beta(2.0, 3.0))
    ft.observe("obs", ft.Bernoulli(p), jnp.array([1] * 12 + [0] * 7, dtype=bool))
    return p


def main():
    mesh = make_chain_mesh()
    n_dev = mesh.devices.size
    print(f"mesh: {n_dev} devices along '{mesh.axis_names[0]}'")

    res = sharded_hmc_chain(
        jax.random.PRNGKey(0), coin, n_samples=500, n_warmup=400,
        n_chains=16 * n_dev, mesh=mesh,
    )
    ps = np.asarray(res.samples["p"])
    assert abs(ps.mean() - 14 / 24) < 0.01, ps.mean()
    print(f"sharded HMC: {ps.shape[0]} chains, mean={ps.mean():.4f} "
          f"(exact {14/24:.4f}), step={res.step_size:.3f} -- OK")

    smc = sharded_smc(jax.random.PRNGKey(1), 256 * n_dev, coin, mesh=mesh)
    assert abs(float(smc.posterior_mean("p")) - 14 / 24) < 0.02
    print(f"sharded SMC: {256*n_dev} particles, logZ={smc.log_evidence:.3f} -- OK")

    # whole-optimization SPMD VI: the data plate is sharded on axis 0 and
    # the pathwise ELBO gradient psum-reduced each Adam step, so parameters
    # stay bit-replicated while likelihood work scales with devices
    rng = np.random.default_rng(0)
    ys = jnp.asarray(rng.normal(1.8, 1.0, 8 * n_dev))
    staged_vi = ft.stage(lambda data: ft.observe(
        "ys", ft.Normal(ft.sample("mu", ft.Normal(0.0, 2.0)), 1.0), data), ys)
    vres = sharded_vi(jax.random.PRNGKey(2), staged=staged_vi,
                      config=VIConfig(n_iterations=400, n_samples=8),
                      mesh=mesh, shard="data")
    n_obs = 8 * n_dev
    post_mean = n_obs * float(ys.mean()) / (0.25 + n_obs)
    loc = float(vres.params["mu"]["loc"])
    assert abs(loc - post_mean) < 0.05, (loc, post_mean)
    print(f"sharded VI (data mode): E[mu]={loc:.4f} (exact {post_mean:.4f}) -- OK")


if __name__ == "__main__":
    main()
