"""The at-scale GLM workflow: data-as-arguments, split-precision matmuls,
MAP warm start, fixed pre-tuned kernel, and resume.

This is the shape of the scale-tier bench rows (bench.py: d=1024, N=1e5 on
the GPU) at a CPU-friendly size, showing the five APIs that make large-d
GLMs work on an accelerator:

1. pass the design matrix through ``stage(model, X, y)`` — array arguments
   >= 1 MiB become traced jit inputs of the compiled drives instead of
   baked compile-payload constants (``StagedModel.data_leaves``);
2. ``ops.matmul_bf16x2`` computes the linear predictor on the tensor cores in
   split bf16 precision with an exact custom VJP — bf16 data, ~f32
   parameter smoothness (plain bf16 parameter rounding makes the potential
   rough and collapses step-size adaptation); for pure MCMC drives,
   ``ops.matmul_bf16x2_fastgrad`` keeps the split forward and drops the
   backward's cotangent split (3 matmul passes per value+grad instead of
   4; the force error is MH-corrected);
3. ``BernoulliLogits`` is the saturation-free logistic likelihood;
4. MAP (LBFGS on the same staged potential) warm-starts the chains —
   far-tail inits cost more warmup than the optimization does;
5. the warmed kernel + final positions flow through ``resume=`` for
   continued sampling (the reference's all-state-in-a-value discipline,
   hmc.rs:604-642).

Run: PYTHONPATH=. python examples/glm_at_scale.py
"""

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import fugue_tpu as ft
from fugue_tpu.inference.map_laplace import MAPConfig, map_estimate
from fugue_tpu.ops import matmul_bf16x2

# --- synthetic logistic data, biggish N so the posterior is tight --------
D, N, C = 16, 20_000, 8
rng = np.random.default_rng(0)
X = jnp.asarray(rng.normal(0, 1, (N, D)) / np.sqrt(D), jnp.float32)
w_true = rng.normal(0, 1, D)
logits_true = np.asarray(X, np.float64) @ w_true
y = jnp.asarray(rng.uniform(size=N) < 1 / (1 + np.exp(-logits_true)))


def model(Xd, yd):
    w = ft.sample("w", ft.Normal(0.0, 1.0), sample_shape=(D,))
    ft.observe("y", ft.BernoulliLogits(matmul_bf16x2(Xd, w)), yd)


staged = ft.stage(model, X, y)
# X (20k x 16 f32 = 1.2 MiB) is above the data-argument threshold:
assert len(staged.data_leaves()) == 1

# --- MAP warm start (the optimization shares the staged potential) -------
m = map_estimate(
    jax.random.PRNGKey(0), staged=staged,
    config=MAPConfig(n_iterations=200, optimizer="lbfgs", n_restarts=1,
                     grad_tol=1.0),
)
# grad_tol is in joint-gradient units: with 20k observations a norm of
# O(1) is already deep inside the posterior's ~0.1-sd basin
assert m.converged

# --- HMC from the mode ---------------------------------------------------
first = ft.hmc_chain(
    jax.random.PRNGKey(1), staged=staged, n_samples=200, n_warmup=200,
    n_chains=C, init_position=m.z, init_jitter=0.05,
    config=ft.HMCConfig(n_leapfrog=8),
)
assert float(np.asarray(first.divergences).mean()) < 0.01

# --- continue sampling with the warmed kernel (no re-warmup) -------------
second = ft.hmc_chain(
    jax.random.PRNGKey(2), staged=staged, n_samples=200, n_warmup=0,
    n_chains=C, resume=first, config=ft.HMCConfig(n_leapfrog=8),
)

w_post = np.concatenate(
    [np.asarray(first.samples["w"]), np.asarray(second.samples["w"])], axis=1
).mean((0, 1))
corr = float(np.corrcoef(w_post, w_true)[0, 1])
max_err = float(np.abs(w_post - w_true).max())
print(f"posterior-mean vs generating coefficients: corr={corr:.4f}, "
      f"max|err|={max_err:.3f}")
assert corr > 0.98
assert max_err < 0.6  # N=20k: posterior sd ~ 0.15-0.2 per coordinate
print("glm_at_scale OK")
