"""Bayesian classification: logistic and multi-class softmax regression.

Reference: examples/classification.rs (binary logistic regression with
adaptive MH over synthetic data with known coefficients, plus multi-class).
Array-program recast: gradients come from autodiff, so we run NUTS over the full
coefficient vector at once — the logit matmul is one batched product, and chains are a
vectorized batch axis. Ends in recovery asserts against the generating
coefficients and a held-out accuracy check (the reference pattern: examples
double as regression tests).

Run: PYTHONPATH=. python examples/classification.py
"""

import jax
import jax.numpy as jnp
import numpy as np

import fugue_tpu as ft

# --- synthetic binary data (reference: classification.rs generate_classification_data) ---
rng = np.random.default_rng(42)
N = 200
TRUE_BETA = np.array([-1.0, 2.0, -1.5])  # intercept, x1, x2
Xb = np.column_stack([np.ones(N), rng.standard_normal((N, 2))])
p_true = 1.0 / (1.0 + np.exp(-(Xb @ TRUE_BETA)))
Yb = rng.random(N) < p_true
X_BIN, Y_BIN = jnp.asarray(Xb), jnp.asarray(Yb)

# --- synthetic 3-class data ---
K, D = 3, 3
TRUE_W = rng.standard_normal((D, K)) * 1.5
Xm = np.column_stack([np.ones(N), rng.standard_normal((N, D - 1))])
logits_true = Xm @ TRUE_W
pm = np.exp(logits_true - logits_true.max(axis=1, keepdims=True))
pm /= pm.sum(axis=1, keepdims=True)
Ym = np.array([rng.choice(K, p=row) for row in pm])
X_MC, Y_MC = jnp.asarray(Xm), jnp.asarray(Ym)


def logistic_model():
    beta = ft.sample("beta", ft.Normal(jnp.zeros(3), 2.5))
    logits = X_BIN @ beta
    ft.observe("y", ft.Bernoulli(jax.nn.sigmoid(logits)), Y_BIN)
    return beta


def softmax_model():
    # Identify the model by pinning class 0's column to zero (reference keeps
    # all K columns and lives with the translation non-identifiability; the
    # pinned parameterization is the standard identifiable choice).
    w_free = ft.sample("w_free", ft.Normal(jnp.zeros((D, K - 1)), 2.0))
    w = jnp.concatenate([jnp.zeros((D, 1)), w_free], axis=1)
    ft.observe("y", ft.Categorical(logits=X_MC @ w), Y_MC)
    return w


def main():
    print("=== 1. Binary logistic regression (NUTS) ===")
    res = ft.nuts_chain(
        jax.random.PRNGKey(0), logistic_model,
        n_samples=500, n_warmup=500, n_chains=8,
    )
    ft.print_diagnostics(res.samples)
    beta_hat = np.asarray(res.samples["beta"]).reshape(-1, 3).mean(axis=0)
    print(f"beta_hat = {beta_hat}  (true {TRUE_BETA})")
    assert np.all(np.abs(beta_hat - TRUE_BETA) < 0.6), beta_hat

    # Posterior-mean predictive accuracy should beat the base rate.
    acc = float(np.mean((1 / (1 + np.exp(-(Xb @ beta_hat))) > 0.5) == Yb))
    base = max(Yb.mean(), 1 - Yb.mean())
    print(f"train accuracy {acc:.3f} (base rate {base:.3f})")
    assert acc > base

    print("\n=== 2. Multi-class softmax regression (HMC) ===")
    res2 = ft.hmc_chain(
        jax.random.PRNGKey(1), softmax_model,
        n_samples=500, n_warmup=500,
        config=ft.HMCConfig(n_leapfrog=16), n_chains=8,
    )
    w_free = np.asarray(res2.samples["w_free"]).reshape(-1, D, K - 1).mean(axis=0)
    w_hat = np.concatenate([np.zeros((D, 1)), w_free], axis=1)
    pred = np.argmax(Xm @ w_hat, axis=1)
    acc_mc = float(np.mean(pred == Ym))
    base_mc = max(np.bincount(Ym, minlength=K)) / N
    print(f"multi-class train accuracy {acc_mc:.3f} (base rate {base_mc:.3f})")
    assert acc_mc > base_mc
    # Identified contrasts (column k minus column 0) should match the truth.
    true_contrast = TRUE_W - TRUE_W[:, :1]
    err = np.abs(w_hat - true_contrast).max()
    print(f"max |contrast error| = {err:.3f}")
    assert err < 1.0, err
    print("OK")


if __name__ == "__main__":
    main()
