"""Multi-engine benchmark suite — the committed artifact IS the claim.

Workloads mirror the reference's committed criterion benches
(/root/reference/benches/f_perf.rs:11-60: 20-site hierarchical MH, 64-particle
SMC with 3 rejuvenation steps, 128-sample ELBO) plus the BASELINE.md north-star
HMC/NUTS eight-schools configuration at 1024 chains. Every engine emits one
JSON line with {"submetric", value, unit, vs_baseline, device, ...extras};
the LAST line is the headline metric in the driver schema
{"metric", "value", "unit", "vs_baseline"}. A row that raises is printed
with its error and makes the run exit non-zero.

vs_baseline bases (BASELINE.md, Apple Silicon single core):
- MH: 65,274 transitions/s (1.532 ms / 100 transitions, f_perf.rs:27-29)
- SMC: 49.4 ms/run at 64 particles x 3 rejuvenation steps (f_perf.rs:33);
  normalized to particle-stages/s using OUR measured stage count
- VI: 2.27 ms per 128-sample ELBO evaluation (f_perf.rs:34); our iteration
  additionally computes the pathwise gradient and Adam update
- HMC: the reference computes gradients by central finite differences at
  (L+1)*2d model runs per transition (hmc.rs:301-329); with one model run
  costing 15.3 us / 20 sites (the MH bench), the derived single-core rate
  for the eight-schools d=10 workload is 1 / ((L+1)*2d*7.65us) transitions/s
- NUTS: no reference engine exists (fixed-L HMC only); vs_baseline compares
  against the same derived finite-difference HMC rate

Run on the GPU, one process for the card: python bench.py
"""

import json
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

# Published dense peaks per card, keyed by JAX's device_kind (NVIDIA H100
# SXM data sheet: rates without sparsity, at the full 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def device_peaks(kind=None):
    """Peak rates of the card ``kind`` (default: the first JAX device).
    A card missing from PEAKS is an error, not a default."""
    kind = kind or jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"add them to bench.PEAKS with their source")
    return PEAKS[kind]


def device_info():
    devs = jax.devices()
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs)}


REF_MH_TRANSITIONS_PER_SEC = 100.0 / 1.532e-3  # 65,274/s (f_perf.rs:27-29)
REF_MODEL_RUN_SEC = 1.532e-3 / 100 / 2  # one model run ~7.65us (half an MH
# transition: propose+score; f_perf.rs cost model mh.rs:60-69)
REF_SMC_RUN_SEC = 49.4e-3  # 64 particles, 3 rejuvenation steps (f_perf.rs:33)
REF_ELBO_EVAL_SEC = 2.27e-3  # 128 MC samples, 20-site model (f_perf.rs:34)

N_GROUPS = 17  # + mu + tau + sigma = 20 sites


def hierarchical_model():
    """20 scalar latent sites, mirroring the reference bench model shape
    (benches/f_perf.rs 20-site hierarchical)."""
    import fugue_tpu as ft

    rng = np.random.default_rng(0)
    data = jnp.asarray(rng.normal(0.5, 1.0, (N_GROUPS, 5)))

    mu = ft.sample("mu", ft.Normal(0.0, 2.0))
    tau = ft.sample("tau", ft.LogNormal(0.0, 0.5))
    sigma = ft.sample("sigma", ft.LogNormal(0.0, 0.5))
    thetas = []
    for i in range(N_GROUPS):
        theta_i = ft.sample(ft.addr("theta", i), ft.Normal(mu, tau))
        ft.observe(ft.addr("y", i), ft.Normal(theta_i, sigma), data[i])
        thetas.append(theta_i)
    return thetas


def eight_schools_model():
    """Non-centered eight schools (BASELINE north-star config 3)."""
    import fugue_tpu as ft

    y = jnp.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
    sigma = jnp.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])
    mu = ft.sample("mu", ft.Normal(0.0, 5.0))
    tau = ft.sample("tau", ft.LogNormal(0.5, 1.0))
    theta_raw = ft.sample("theta_raw", ft.Normal(0.0, 1.0), sample_shape=(8,))
    ft.observe("y", ft.Normal(mu + tau * theta_raw, sigma), y)
    return mu


def conjugate_evidence_model():
    """mu ~ N(0,1); y_i ~ N(mu,1) — log-evidence has a closed form
    (multivariate normal with covariance I + 11^T)."""
    import fugue_tpu as ft

    rng = np.random.default_rng(7)
    y = jnp.asarray(rng.normal(0.3, 1.0, 32))
    mu = ft.sample("mu", ft.Normal(0.0, 1.0))
    ft.observe("y", ft.Normal(mu, 1.0), y)
    return mu


def conjugate_log_evidence():
    rng = np.random.default_rng(7)
    y = np.asarray(rng.normal(0.3, 1.0, 32), np.float64)
    n = y.size
    # Sigma = I + J; |Sigma| = 1+n; Sigma^-1 = I - J/(1+n)
    quad = float(y @ y - (y.sum() ** 2) / (1.0 + n))
    return -0.5 * (n * np.log(2 * np.pi) + np.log(1.0 + n) + quad)


def _timed(fn, base=0, reps=3):
    """Mean seconds of fn(i) over ``reps`` distinct seeds i, after one
    untimed call that compiles."""
    jax.block_until_ready(fn(base))
    t0 = time.perf_counter()
    for i in range(reps):
        out = jax.block_until_ready(fn(base + 1 + i))
    return (time.perf_counter() - t0) / reps, out


def bench_mh():
    import fugue_tpu as ft
    from fugue_tpu.inference.mh import adaptive_mcmc_chain

    n_chains, n_warmup, n_samples = 262144, 50, 50
    staged = ft.stage(hierarchical_model)

    def run(i):
        return adaptive_mcmc_chain(
            jax.random.fold_in(jax.random.PRNGKey(0), i),
            n_samples=n_samples, n_warmup=n_warmup, n_chains=n_chains,
            staged=staged,
        ).samples["mu"]

    elapsed, _ = _timed(run, 1)
    rate = n_chains * (n_warmup + n_samples) / elapsed
    return {
        "submetric": "mh_transitions_per_sec_20site_hierarchical_262144chains",
        "value": round(rate, 1),
        "unit": "transitions/s",
        "vs_baseline": round(rate / REF_MH_TRANSITIONS_PER_SEC, 2),
        "wall_s": round(elapsed, 4),
    }


def bench_hmc():
    import fugue_tpu as ft
    from fugue_tpu.inference.hmc import HMCConfig, hmc_chain
    from fugue_tpu.inference.mcmc_utils import ess_multichain, split_r_hat

    n_chains, n_warmup, n_samples, L = 1024, 1000, 1000, 32
    staged = ft.stage(eight_schools_model)
    # target_accept 0.9: the funnel-ish eight-schools tail needs a smaller
    # step for a sub-1% divergence rate (VERDICT r2 item 5); the headline
    # metric is grad-evals/s, which a smaller eps does not distort
    cfg = HMCConfig(n_leapfrog=L, target_accept=0.9)

    def run(i):
        return hmc_chain(
            jax.random.fold_in(jax.random.PRNGKey(1), i),
            n_samples=n_samples, n_warmup=n_warmup, n_chains=n_chains,
            config=cfg, staged=staged,
        )

    elapsed, res = _timed(run, 1)
    grad_evals = n_chains * (n_warmup + n_samples) * (L + 1)
    mus = np.asarray(res.samples["mu"])
    ess = float(ess_multichain(mus))
    rhat = float(split_r_hat(mus))

    # achieved FLOP/s: XLA's own cost model for one batched
    # gradient evaluation x grad-eval rate (VERDICT r1 item 8)
    flops_per_grad = None
    try:
        vg = jax.jit(jax.vmap(jax.value_and_grad(
            lambda z: staged.potential(z, None))))
        q = jnp.zeros((n_chains, staged.dim), jnp.float32)
        ca = vg.lower(q).compile().cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        flops_per_grad = float(ca.get("flops", 0.0))
    except Exception:
        pass
    extras = {}
    if flops_per_grad:
        achieved = flops_per_grad / n_chains * grad_evals / elapsed
        extras = {
            "flops_per_sec": round(achieved, 1),
            "pct_fp32_peak": round(
                100 * achieved / device_peaks()["fp32_flops"], 4),
        }

    d = staged.dim
    ref_rate = 1.0 / ((L + 1) * 2 * d * REF_MODEL_RUN_SEC * (d / 20.0))
    rate = grad_evals / elapsed
    return {
        "submetric": "hmc_grad_evals_per_sec_eight_schools_1024chains_L32",
        "value": round(rate, 1),
        "unit": "grad-evals/s",
        "vs_baseline": round(
            (n_chains * (n_warmup + n_samples) / elapsed) / ref_rate, 2
        ),
        "wall_s": round(elapsed, 4),
        "ess_per_sec": round(ess / elapsed, 1),
        "r_hat": round(rhat, 5),
        "divergence_rate": round(float(np.asarray(res.divergences).mean()), 5),
        **extras,
    }


def bench_nuts():
    import fugue_tpu as ft
    from fugue_tpu.inference.mcmc_utils import ess_multichain, split_r_hat
    from fugue_tpu.inference.nuts import NUTSConfig, nuts_chain

    n_chains, n_warmup, n_samples = 1024, 1000, 1000
    staged = ft.stage(eight_schools_model)

    def run(i):
        return nuts_chain(
            jax.random.fold_in(jax.random.PRNGKey(2), i),
            n_samples=n_samples, n_warmup=n_warmup, n_chains=n_chains,
            config=NUTSConfig(), staged=staged,
        )

    elapsed, res = _timed(run, 1)
    mus = np.asarray(res.samples["mu"])
    ess = float(ess_multichain(mus))
    d = staged.dim
    ref_rate = 1.0 / (33 * 2 * d * REF_MODEL_RUN_SEC * (d / 20.0))
    trans_rate = n_chains * (n_warmup + n_samples) / elapsed

    # roofline accounting (VERDICT r1 item 8): EXACT leapfrog count from
    # the in-kernel counter (+1 trajectory-root value+grad per transition);
    # FLOPs per gradient from XLA's cost model of the batched value_and_grad
    n_trans = n_chains * (n_warmup + n_samples)
    grad_evals = res.n_leapfrogs + n_trans
    extras = {}
    try:
        vg = jax.jit(jax.vmap(jax.value_and_grad(
            lambda z: staged.potential(z, None))))
        q = jnp.zeros((n_chains, staged.dim), jnp.float32)
        ca = vg.lower(q).compile().cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        flops_per_grad = float(ca.get("flops", 0.0))
        if flops_per_grad:
            achieved = flops_per_grad / n_chains * grad_evals / elapsed
            extras = {
                "grad_evals_per_sec": round(grad_evals / elapsed, 1),
                "flops_per_sec": round(achieved, 1),
                "pct_fp32_peak": round(
                    100 * achieved / device_peaks()["fp32_flops"], 4
                ),
            }
    except Exception:
        pass

    return {
        "submetric": "nuts_ess_per_sec_eight_schools_1024chains",
        "value": round(ess / elapsed, 1),
        "unit": "ESS/s",
        "vs_baseline": round(trans_rate / ref_rate, 2),
        "wall_s": round(elapsed, 4),
        "transitions_per_sec": round(trans_rate, 1),
        "mean_tree_depth": round(
            float(np.asarray(res.tree_depths).mean()), 3),
        "r_hat": round(float(split_r_hat(mus)), 5),
        "divergence_rate": round(float(np.asarray(res.divergences).mean()), 5),
        **extras,
    }


def bench_chees():
    import fugue_tpu as ft
    from fugue_tpu.inference.chees import ChEESConfig, chees_chain
    from fugue_tpu.inference.mcmc_utils import ess_multichain, split_r_hat

    n_chains, n_warmup, n_samples = 1024, 1000, 1000
    staged = ft.stage(eight_schools_model)

    def run(i):
        return chees_chain(
            jax.random.fold_in(jax.random.PRNGKey(5), i),
            n_samples=n_samples, n_warmup=n_warmup, n_chains=n_chains,
            config=ChEESConfig(target_accept=0.8), staged=staged,
        )

    elapsed, res = _timed(run, 1)
    mus = np.asarray(res.samples["mu"])
    ess = float(ess_multichain(mus))
    d = staged.dim
    mean_L = res.mean_leapfrog
    trans_rate = n_chains * (n_warmup + n_samples) / elapsed
    # same derived finite-difference baseline as NUTS, at OUR mean step count
    ref_rate = 1.0 / ((mean_L + 1) * 2 * d * REF_MODEL_RUN_SEC * (d / 20.0))
    # EXACT in-kernel leapfrog count (+1 initial grad per transition)
    grad_evals = res.n_leapfrogs + n_chains * (n_warmup + n_samples)
    return {
        "submetric": "chees_ess_per_sec_eight_schools_1024chains",
        "value": round(ess / elapsed, 1),
        "unit": "ESS/s",
        "vs_baseline": round(trans_rate / ref_rate, 2),
        "wall_s": round(elapsed, 4),
        "transitions_per_sec": round(trans_rate, 1),
        "grad_evals_per_sec": round(grad_evals / elapsed, 1),
        "mean_leapfrog": round(mean_L, 2),
        "trajectory_length": round(res.trajectory_length, 3),
        "r_hat": round(float(split_r_hat(mus)), 5),
        "divergence_rate": round(float(np.asarray(res.divergences).mean()), 5),
    }


def bench_smc():
    import fugue_tpu as ft
    from fugue_tpu.inference.smc import SMCConfig, adaptive_smc

    n_particles = 131072
    staged = ft.stage(hierarchical_model)
    cfg = SMCConfig(rejuvenation_steps=3)

    def run(i):
        return adaptive_smc(
            jax.random.fold_in(jax.random.PRNGKey(3), i),
            n_particles, staged=staged, config=cfg,
        )

    elapsed, res = _timed(run, 1)
    stages = int(res.n_stages)
    rate = n_particles * stages / elapsed
    ref_rate = 64 * stages / REF_SMC_RUN_SEC  # same stage count, 64 particles

    # evidence accuracy on the conjugate model (closed-form logZ)
    staged_c = ft.stage(conjugate_evidence_model)
    res_c = adaptive_smc(
        jax.random.PRNGKey(33), 8192, staged=staged_c, config=cfg
    )
    logz_err = abs(float(res_c.log_evidence) - conjugate_log_evidence())

    return {
        "submetric": "smc_particle_stages_per_sec_20site_131072particles",
        "value": round(rate, 1),
        "unit": "particle-stages/s",
        "vs_baseline": round(rate / ref_rate, 2),
        "wall_s": round(elapsed, 4),
        "n_stages": stages,
        "log_evidence": round(float(res.log_evidence), 3),
        "conjugate_logZ_abs_err": round(logz_err, 4),
    }


def bench_vi():
    import fugue_tpu as ft
    from fugue_tpu.inference.vi import VIConfig, optimize_meanfield_vi

    n_iter, n_mc = 2000, 128
    staged = ft.stage(hierarchical_model)
    cfg = VIConfig(
        n_iterations=n_iter, n_samples=n_mc, plateau_window=10**9,
        check_every=n_iter,
    )

    def run(i):
        return optimize_meanfield_vi(
            jax.random.fold_in(jax.random.PRNGKey(4), i),
            staged=staged, config=cfg,
        ).elbo_history

    elapsed, hist = _timed(run, 1)
    rate = n_iter / elapsed
    return {
        "submetric": "vi_elbo_grad_iterations_per_sec_20site_128mc",
        "value": round(rate, 1),
        "unit": "iterations/s",
        "vs_baseline": round(rate / (1.0 / REF_ELBO_EVAL_SEC), 2),
        "wall_s": round(elapsed, 4),
        "final_elbo": round(float(np.asarray(hist)[-1]), 3),
    }


def bench_smc_hmc():
    """Second SMC row: gradient-based rejuvenation (SURVEY.md §7 step 6 —
    'HMC moves instead of single-site MH'; VERDICT r2 item 6)."""
    import fugue_tpu as ft
    from fugue_tpu.inference.smc import SMCConfig, adaptive_smc

    n_particles = 131072
    staged = ft.stage(hierarchical_model)
    # 1 move x 16 leapfrogs: same gradient work as 2x8 but one long
    # pi_beta-invariant trajectory
    cfg = SMCConfig(rejuvenation="hmc", rejuvenation_steps=1, hmc_leapfrog=16)

    def run(i):
        return adaptive_smc(
            jax.random.fold_in(jax.random.PRNGKey(13), i),
            n_particles, staged=staged, config=cfg,
        )

    elapsed, res = _timed(run, 1)
    stages = int(res.n_stages)
    rate = n_particles * stages / elapsed
    ref_rate = 64 * stages / REF_SMC_RUN_SEC

    staged_c = ft.stage(conjugate_evidence_model)
    res_c = adaptive_smc(
        jax.random.PRNGKey(34), 8192, staged=staged_c, config=cfg
    )
    logz_err = abs(float(res_c.log_evidence) - conjugate_log_evidence())

    return {
        "submetric": "smc_hmc_rejuvenation_particle_stages_per_sec",
        "value": round(rate, 1),
        "unit": "particle-stages/s",
        "vs_baseline": round(rate / ref_rate, 2),
        "wall_s": round(elapsed, 4),
        "n_stages": stages,
        "log_evidence": round(float(res.log_evidence), 3),
        "conjugate_logZ_abs_err": round(logz_err, 4),
    }


def bench_abc():
    """ABC engine artifacts (VERDICT r3 weak #3; reference engine
    abc.rs:283-325 rejection, :520-694 weighted ABC-SMC, example
    examples/abc_inference.rs): batched likelihood-free rejection on a
    Gaussian-mean target (64-obs simulator, mean-summary distance) at a
    device-bound batch size, plus a weighted ABC-SMC stage schedule.
    vs_baseline anchors to the reference's own measured per-site-visit
    cost (15.3 us / 20-site transition, benches/f_perf.rs:27-29): one sim
    = one model execution of n_obs+1 scalar sites."""
    import fugue_tpu as ft
    from fugue_tpu.inference.abc import (
        ABCSMCConfig, abc_rejection, abc_smc_weighted,
    )

    N_OBS, BATCH = 64, 1 << 17
    key = jax.random.PRNGKey(77)
    obs = 1.0 + jax.random.normal(jax.random.fold_in(key, 0), (N_OBS,))
    xbar = float(jnp.mean(obs))

    def sim():
        mu = ft.sample("mu_p", ft.Normal(0.0, 2.0))
        return ft.sample("xs", ft.Normal(mu, 1.0), sample_shape=(N_OBS,))

    staged = ft.stage(sim)
    dist = lambda a, b: jnp.abs(jnp.mean(a) - jnp.mean(b))

    def run(i):
        # 16 sub-batches per dispatch: one host round trip covers 2M sims
        return abc_rejection(
            jax.random.fold_in(jax.random.PRNGKey(30), i), staged=staged,
            observed=obs, distance=dist, epsilon=0.02, n_samples=4096,
            batch_size=BATCH, inner_batches=16, max_attempts=1 << 26,
        )

    run(0)  # compile
    # the rejection loop fetches its accepted rows on host every batch, so
    # it has finished when it returns
    t0 = time.perf_counter()
    res = run(1)
    elapsed = time.perf_counter() - t0
    sims_per_sec = res.n_attempts / elapsed
    ps = np.asarray(res.particles["mu_p"], np.float64)
    # ABC-on-mean posterior ~= N(16/(0.25/4 + 16) scaled): tau0=1/4, n=64
    post_m = (N_OBS * xbar) / (0.25 + N_OBS)
    post_sd = float(np.sqrt(1.0 / (0.25 + N_OBS)))

    def run_smc(i):
        # batch 16384: fewer, larger dispatches at the cost of cheap
        # wasted sims
        return abc_smc_weighted(
            jax.random.fold_in(jax.random.PRNGKey(31), i), staged=staged,
            observed=obs, distance=dist,
            config=ABCSMCConfig(n_particles=2048,
                                epsilons=(0.5, 0.2, 0.1, 0.05),
                                batch_size=16384,
                                max_attempts_per_stage=1 << 22),
            param_addresses=("mu_p",),
        )

    run_smc(0)  # compile (stage kernels are cached on the staged model)
    t0 = time.perf_counter()
    rs = run_smc(9)
    jax.block_until_ready(rs.log_weights)
    smc_wall = time.perf_counter() - t0
    w = np.exp(np.asarray(rs.log_weights, np.float64))
    w = w / w.sum()
    wm = float((w * np.asarray(rs.particles["mu_p"], np.float64)).sum())

    # reference cost model anchored to the reference's OWN measured rate:
    # its criterion bench runs a 20-site model at 15.3 us/transition
    # (benches/f_perf.rs:27-29) = 0.765 us per site visit; one ABC sim
    # executes the model once = N_OBS+1 scalar site visits (no vectorized
    # sites exist there), so ~(N_OBS+1)*0.765 us/sim
    ref_sims_per_sec = 1.0 / ((N_OBS + 1) * 0.765e-6)
    return {
        "submetric": "abc_rejection_sims_per_sec_64obs",
        "value": round(sims_per_sec, 1),
        "unit": "sims/s",
        "vs_baseline": round(sims_per_sec / ref_sims_per_sec, 2),
        "wall_s": round(elapsed, 3),
        "n_attempts": int(res.n_attempts),
        "posterior_mean_err_in_sd": round(abs(ps.mean() - post_m) / post_sd, 3),
        "posterior_sd_ratio": round(float(ps.std()) / post_sd, 3),
        "smc_weighted_mean_err_in_sd": round(abs(wm - post_m) / post_sd, 3),
        "smc_wall_s": round(smc_wall, 3),
        "smc_attempts": int(rs.n_attempts),
    }


def bench_vi_scale():
    """VI at scale (VERDICT r3 item 9): d=512 correlated-coefficient
    linear model with an EXACT closed-form posterior. Mean-field: marginal
    means must match (variances legitimately under-estimate on correlated
    posteriors); full-rank ADVI: means AND marginal sds. Data flows into
    the compiled optimization as traced arguments (r4 VI data-args)."""
    import fugue_tpu as ft
    from fugue_tpu.inference.vi import (
        VIConfig, optimize_fullrank_vi, optimize_meanfield_vi,
    )

    DD, DN = 512, 16384
    ii = np.arange(DD)
    Sigma = np.exp(-np.abs(ii[:, None] - ii[None, :]) / 16.0)
    Lj = jnp.asarray(np.linalg.cholesky(Sigma), jnp.float32)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(96), 3)

    @jax.jit
    def gen():
        X = jax.random.normal(k1, (DN, DD)) / np.float32(np.sqrt(DD))
        w_true = Lj @ jax.random.normal(k2, (DD,))
        yv = X @ w_true + jax.random.normal(k3, (DN,))
        Lam = (jnp.linalg.inv(Sigma.astype(np.float32)) + X.T @ X)
        Pcov = jnp.linalg.inv(Lam)
        pmean = Pcov @ (X.T @ yv)
        return X, yv, pmean, jnp.sqrt(jnp.diag(Pcov))

    Xj, yj, pmean, psd = gen()
    pmean_np, psd_np = np.asarray(pmean), np.asarray(psd)

    def model(Xd, yd):
        w = ft.sample(
            "w", ft.MultivariateNormal(jnp.zeros(DD), scale_tril=Lj))
        ft.observe("y", ft.Normal(Xd @ w, 1.0), yd)

    staged = ft.stage(model, Xj, yj)

    n_iter = 3000
    cfg = VIConfig(n_iterations=n_iter, n_samples=8,
                   plateau_window=10**9, check_every=n_iter,
                   learning_rate=0.02)

    def run_mf(i):
        return optimize_meanfield_vi(
            jax.random.fold_in(jax.random.PRNGKey(40), i),
            staged=staged, config=cfg)

    run_mf(0)  # compile
    t0 = time.perf_counter()
    r = run_mf(1)
    mf_wall = time.perf_counter() - t0
    mf_loc = np.asarray(r.params["w"]["loc"])
    mf_err = float(np.max(np.abs(mf_loc - pmean_np) / psd_np))

    # full-rank runs as resumed segments with a per-segment lr ladder: a
    # flat lr leaves marginal sds ~1.8x the exact posterior's, the ladder
    # converges them to within 20%
    seg_iter = 3000
    lr_ladder = (0.02, 0.01, 0.005, 0.0025, 0.00125, 0.00125)
    fr_iter = seg_iter * len(lr_ladder)

    def run_fr(i, prev, lr):
        cfg_s = VIConfig(n_iterations=seg_iter, n_samples=16,
                         plateau_window=10**9, check_every=seg_iter,
                         learning_rate=lr)
        return optimize_fullrank_vi(
            jax.random.fold_in(jax.random.PRNGKey(41), i),
            staged=staged, config=cfg_s, resume=prev)

    # compile both program modes for every ladder rung, then time clean
    rf = None
    for si, lr in enumerate(lr_ladder):
        rf = run_fr(si, rf, lr)
    t0 = time.perf_counter()
    rf = None
    for si, lr in enumerate(lr_ladder):
        rf = run_fr(10 + si, rf, lr)
    fr_wall = time.perf_counter() - t0
    fr_loc = np.asarray(rf.params["loc"])
    fr_err = float(np.max(np.abs(fr_loc - pmean_np) / psd_np))
    cov = np.asarray(rf.guide.covariance(rf.params))
    ratio = np.sqrt(np.diag(cov)) / psd_np

    # reference cost model: one ELBO eval = n_mc model runs, each costed at
    # the workload flops on a scalar core; the reference needs 4*|params|*
    # n_mc runs PER ITERATION for its CRN finite differences (vi.rs:687)
    flops_eval = 2 * DN * DD + DD * DD
    ref_iters_per_sec = SCALAR_CORE_FLOPS / (
        4 * (2 * DD) * 8 * flops_eval)
    mf_rate = n_iter / mf_wall
    return {
        "submetric": "vi_scale_d512_meanfield_iterations_per_sec",
        "value": round(mf_rate, 1),
        "unit": "iterations/s",
        "vs_baseline": round(mf_rate / ref_iters_per_sec, 1),
        "wall_s": round(mf_wall, 3),
        "max_mean_err_in_sd": round(mf_err, 3),
        "final_elbo": round(float(r.elbo_history[-1]), 2),
        "fullrank_iterations_per_sec": round(fr_iter / fr_wall, 1),
        "fullrank_wall_s": round(fr_wall, 3),
        "fullrank_max_mean_err_in_sd": round(fr_err, 3),
        "fullrank_sd_ratio_minmax": [round(float(ratio.min()), 3),
                                     round(float(ratio.max()), 3)],
        "fullrank_final_elbo": round(float(rf.elbo_history[-1]), 2),
    }


# ---------------------------------------------------------------------------
# Scale tier (VERDICT r2 item 1): large-d / large-N workloads with honest
# per-workload rooflines. vs_baseline derives from the reference's
# finite-difference cost model ((L+1)*2d model runs per HMC transition,
# hmc.rs:301-329) with one scalar model run costed at the workload's FLOPs
# on a 2 GFLOP/s single core — generous to the reference.
# ---------------------------------------------------------------------------

SCALAR_CORE_FLOPS = 2e9


def logistic_target(D=1024, N=100_000, seed=99):
    """Bayesian logistic regression target: bf16 design matrix (N, D) and
    labels generated on the device, data flowing into the drives as traced
    arguments. Returns (staged, w_true)."""
    import fugue_tpu as ft
    from fugue_tpu.ops import matmul_bf16x2_fastgrad

    kx, kw, ky = jax.random.split(jax.random.PRNGKey(seed), 3)

    @jax.jit
    def gen():
        X = (jax.random.normal(kx, (N, D), jnp.bfloat16)
             / np.float32(np.sqrt(D)))
        w_true = jax.random.normal(kw, (D,), jnp.float32)
        logits = jnp.matmul(X, w_true.astype(jnp.bfloat16),
                            preferred_element_type=jnp.float32)
        yv = jax.random.uniform(ky, (N,)) < jax.nn.sigmoid(logits)
        return X, w_true, yv

    X, w_true, y = gen()

    def model(Xd, yd):
        # fastgrad: split-precision forward (smooth potential), single-pass
        # bf16 backward (force error is corrected by the MH step)
        w = ft.sample("w", ft.Normal(0.0, 1.0), sample_shape=(D,))
        ft.observe("y", ft.BernoulliLogits(
            matmul_bf16x2_fastgrad(Xd, w)), yd)

    return ft.stage(model, X, y), w_true


def _logistic_setup(D=1024, N=100_000, C=256):
    """Shared d=1024 / N=1e5 / 256-chain logistic target for the scale rows,
    with a MAP warm start (the at-scale workflow: a far-tail init wastes the
    whole warmup budget re-finding the typical set)."""
    from fugue_tpu.inference.map_laplace import MAPConfig, map_estimate

    staged, w_true = logistic_target(D, N)
    m = map_estimate(
        jax.random.PRNGKey(20), staged=staged,
        config=MAPConfig(n_iterations=120, optimizer="lbfgs", n_restarts=1),
    )
    return staged, w_true, m, D, N, C


def _logistic_stats(w_true):
    """On-device stats for the logistic rows: max split-R-hat over sampled
    coordinates, coefficient error normalized by the POSTERIOR SD of each
    coordinate (the calibrated gate: the posterior mean sits within ~1 sd
    of the truth by construction), and the divergence rate."""
    from fugue_tpu.inference.mcmc_utils import ess_multichain, split_r_hat

    return jax.jit(lambda ws, divs: (
        jnp.max(jax.vmap(split_r_hat, in_axes=2)(ws[:, :, ::16])),
        jnp.mean(jnp.abs(jnp.mean(ws, axis=(0, 1)) - w_true)
                 / jnp.std(ws.reshape(-1, ws.shape[-1]), axis=0)),
        jnp.mean(divs.astype(jnp.float32)),
        # min multichain ESS over the strided coordinate sample — the
        # numerator of the cross-engine ESS/grad comparison (VERDICT r4
        # next #3 done-condition)
        jnp.min(jax.vmap(ess_multichain, in_axes=2)(ws[:, :, ::16])),
    ))


def _logistic_roofline(C, N, D):
    """ANALYTIC per-grad-eval roofline against the card's published peaks.
    With matmul_bf16x2_fastgrad the potential gradient is 3 bf16
    (C,D)x(D,N)-class matmuls (split-precision fwd: 2; single-pass bwd: 1),
    so per batched grad step: tensor-core time = 6*C*N*D / peak-bf16; memory
    time = 3 reads of the bf16 X (w/logits traffic amortizes over the C=256
    batch). The ceiling is their max; by construction achieved/roofline
    <= 1. scripts/profile_scale.py decomposes the gap."""
    peaks = device_peaks()
    hw_flops = 6 * C * N * D
    hbm_bytes = 3 * N * D * 2
    roof_s = max(hw_flops / peaks["bf16_flops"],
                 hbm_bytes / peaks["hbm_bytes_per_s"])
    return C / roof_s  # grad-evals/s ceiling


def bench_scale_logistic():
    """Bayesian logistic regression d=1024, N=1e5, 256 chains: the
    likelihood is one (C,d)@(d,N) matmul -> tensor-core workload.
    Adaptation ON (dual averaging + diagonal mass). Roofline is ANALYTIC
    (bf16 flops + memory bytes of the actual matmul set; <=100% by
    construction)."""
    from fugue_tpu.inference.hmc import HMCConfig, hmc_chain

    staged, w_true, m, D, N, C = _logistic_setup()
    L, NW, NS = 16, 300, 128
    cfg = HMCConfig(n_leapfrog=L, target_accept=0.8)
    stats = _logistic_stats(w_true)

    def run(i):
        r = hmc_chain(jax.random.fold_in(jax.random.PRNGKey(21), i),
                      n_samples=NS, n_warmup=NW, n_chains=C,
                      config=cfg, staged=staged,
                      init_position=m.z, init_jitter=0.05)
        return [float(x) for x in stats(r.samples["w"], r.divergences)] + [
            r.step_size]

    run(0)  # compile
    t0 = time.perf_counter()
    rhat, err_sd, div, ess_min, eps = run(1)
    elapsed = time.perf_counter() - t0
    n_grad = (NW + NS) * (L + 1)
    # useful (f32-equivalent) FLOPs: fwd (C,D)@(D,N) + bwd, 2*C*N*D each;
    # the fastgrad kernel executes 1.5x that in hardware bf16 flops
    # (split fwd = 2 passes, single-pass bwd)
    useful = 4 * C * N * D * n_grad / elapsed
    hardware = 1.5 * useful
    roof = _logistic_roofline(C, N, D)

    ref_grad_sec = 2 * D * (2 * N * D / SCALAR_CORE_FLOPS)
    rate = C * n_grad / elapsed
    return {
        "submetric": "scale_logistic_d1024_N1e5_grad_evals_per_sec",
        "value": round(rate, 1),
        "unit": "grad-evals/s",
        "vs_baseline": round(rate * ref_grad_sec, 1),
        "wall_s": round(elapsed, 3),
        "useful_flops_per_sec": round(useful, 1),
        "hardware_bf16_flops_per_sec": round(hardware, 1),
        "pct_bf16_peak_hardware": round(
            100 * hardware / device_peaks()["bf16_flops"], 2),
        "analytic_roofline_grad_evals_per_sec": round(roof, 1),
        "pct_of_analytic_roofline": round(100 * rate / roof, 1),
        "max_rhat_sampled": round(rhat, 4),
        "divergence_rate": round(div, 5),
        "mean_coef_err_in_posterior_sd": round(err_sd, 4),
        "min_ess_sampled": round(ess_min, 1),
        # min sampled ESS per WHOLE-RUN grad-eval per chain (warmup
        # included: the practical cost) — consistent across the scale rows
        "ess_per_grad": round(ess_min / n_grad, 6),
        "step_size": eps,
        "adaptive": True,
    }


def bench_scale_nuts():
    """NUTS on the SAME d=1024 logistic target — the engine a practitioner
    would actually reach for, full warmup adaptation, tree depth adapting
    per transition."""
    from fugue_tpu.inference.nuts import NUTSConfig, nuts_chain

    staged, w_true, m, D, N, C = _logistic_setup()
    NW, NS = 300, 128
    cfg = NUTSConfig(max_depth=6)
    stats = _logistic_stats(w_true)

    def run(i):
        r = nuts_chain(jax.random.fold_in(jax.random.PRNGKey(41), i),
                       n_samples=NS, n_warmup=NW, n_chains=C,
                       config=cfg, staged=staged,
                       init_position=m.z, init_jitter=0.05)
        vals = [float(x) for x in stats(
            jnp.asarray(r.samples["w"]), jnp.asarray(r.divergences))]
        return vals + [r.step_size,
                       float(np.asarray(r.tree_depths).mean()),
                       float(r.n_leapfrogs)]

    run(0)  # compile
    t0 = time.perf_counter()
    rhat, err_sd, div, ess_min, eps, depth, n_leaps = run(1)
    elapsed = time.perf_counter() - t0
    # EXACT leapfrog count from the in-kernel counter (+1 trajectory-root
    # value+grad per transition) — no 2^depth approximation (VERDICT r4)
    grad_evals = n_leaps + C * (NW + NS)
    rate = grad_evals / elapsed
    roof = _logistic_roofline(C, N, D)
    ref_grad_sec = 2 * D * (2 * N * D / SCALAR_CORE_FLOPS)
    return {
        "submetric": "scale_nuts_logistic_d1024_grad_evals_per_sec",
        "value": round(rate, 1),
        "unit": "grad-evals/s (exact in-kernel count)",
        "vs_baseline": round(rate * ref_grad_sec, 1),
        "wall_s": round(elapsed, 3),
        "transitions_per_sec": round(C * (NW + NS) / elapsed, 1),
        "mean_tree_depth": round(depth, 2),
        "pct_of_analytic_roofline": round(100 * rate / roof, 1),
        "max_rhat_sampled": round(rhat, 4),
        "divergence_rate": round(div, 5),
        "mean_coef_err_in_posterior_sd": round(err_sd, 4),
        "min_ess_sampled": round(ess_min, 1),
        "ess_per_grad": round(ess_min / (grad_evals / C), 6),
        "step_size": eps,
        "adaptive": True,
    }


def bench_scale_chees():
    """ChEES-HMC (SNAPER criterion) vs fixed-L HMC, head-to-head on a
    CORRELATED d=1024 logistic target (VERDICT r4 weak #1 / next #3
    done-condition: R-hat < 1.01 and ESS/grad >= fixed-L HMC at d=1024).

    The plain isotropic-design row is the wrong arena for adaptive
    trajectory lengths (a near-iso posterior lets any fixed L near a
    fraction of the period win); here the design carries a rotated
    log-spread spectrum [0.2, 3] that diagonal mass CANNOT equalize — the
    regime where the plain "chees" criterion dephases and collapses, where
    fixed L is target-dependent (CPU replica: L=32 drops to 0.13x the
    L=16 efficiency), and where SNAPER's principal-direction projection
    earns its keep (replica: 1.39x the best fixed-L ESS/grad). Both
    engines run the SAME staged target with MAP warm starts and exact
    in-kernel grad counts."""
    import fugue_tpu as ft
    from fugue_tpu.inference.chees import ChEESConfig, chees_chain
    from fugue_tpu.inference.hmc import HMCConfig, hmc_chain
    from fugue_tpu.inference.map_laplace import MAPConfig, map_estimate
    from fugue_tpu.ops import matmul_bf16x2_fastgrad

    D, N, C = 1024, 100_000, 256
    kz, kq, kw, ky = jax.random.split(jax.random.PRNGKey(107), 4)

    @jax.jit
    def gen():
        Z = jax.random.normal(kz, (N, D), jnp.bfloat16) / np.float32(
            np.sqrt(D))
        # rotated log-spread spectrum: A = Q diag(s) Q^T
        Q, _ = jnp.linalg.qr(jax.random.normal(kq, (D, D), jnp.float32))
        s = jnp.exp(jnp.linspace(np.log(0.2), np.log(3.0), D)
                    ).astype(jnp.float32)
        A = (Q * s[None, :]) @ Q.T
        X = jnp.matmul(Z, A.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32
                       ).astype(jnp.bfloat16)
        w_true = jax.random.normal(kw, (D,), jnp.float32)
        logits = jnp.matmul(X, w_true.astype(jnp.bfloat16),
                            preferred_element_type=jnp.float32)
        yv = jax.random.uniform(ky, (N,)) < jax.nn.sigmoid(logits)
        return X, w_true, yv

    X, w_true, y = gen()

    def model(Xd, yd):
        w = ft.sample("w", ft.Normal(0.0, 1.0), sample_shape=(D,))
        ft.observe("y", ft.BernoulliLogits(
            matmul_bf16x2_fastgrad(Xd, w)), yd)

    staged = ft.stage(model, X, y)
    m = map_estimate(
        jax.random.PRNGKey(20), staged=staged,
        config=MAPConfig(n_iterations=120, optimizer="lbfgs", n_restarts=1),
    )
    NW, NS = 300, 256
    stats = _logistic_stats(w_true)

    def run_chees(i):
        r = chees_chain(jax.random.fold_in(jax.random.PRNGKey(47), i),
                        n_samples=NS, n_warmup=NW, n_chains=C,
                        config=ChEESConfig(criterion="snaper"),
                        staged=staged, init_position=m.z, init_jitter=0.05)
        vals = [float(x) for x in stats(
            jnp.asarray(r.samples["w"]), jnp.asarray(r.divergences))]
        return vals + [r.step_size, r.trajectory_length,
                       r.mean_leapfrog, float(r.n_leapfrogs)]

    run_chees(0)  # compile
    t0 = time.perf_counter()
    rhat, err_sd, div, ess_min, eps, T, mean_L, n_leaps = run_chees(1)
    elapsed = time.perf_counter() - t0
    grad_evals = n_leaps + C * (NW + NS)
    rate = grad_evals / elapsed
    ess_per_grad = ess_min / (grad_evals / C)

    # fixed-L HMC head-to-head on the SAME target (L=16: the best fixed
    # length at the replica scale; longer L degrades)
    L = 16

    def run_hmc(i):
        r = hmc_chain(jax.random.fold_in(jax.random.PRNGKey(48), i),
                      n_samples=NS, n_warmup=NW, n_chains=C,
                      config=HMCConfig(n_leapfrog=L, target_accept=0.8),
                      staged=staged, init_position=m.z, init_jitter=0.05)
        return [float(x) for x in stats(
            jnp.asarray(r.samples["w"]), jnp.asarray(r.divergences))]

    run_hmc(0)
    h_rhat, _h_err, _h_div, h_ess = run_hmc(1)
    h_ess_per_grad = h_ess / ((NW + NS) * (L + 1))

    roof = _logistic_roofline(C, N, D)
    ref_grad_sec = 2 * D * (2 * N * D / SCALAR_CORE_FLOPS)
    return {
        "submetric": "scale_chees_snaper_correlated_d1024_grad_evals_per_sec",
        "value": round(rate, 1),
        "unit": "grad-evals/s (exact in-kernel count)",
        "vs_baseline": round(rate * ref_grad_sec, 1),
        "wall_s": round(elapsed, 3),
        "pct_of_analytic_roofline": round(100 * rate / roof, 1),
        "max_rhat_sampled": round(rhat, 4),
        "divergence_rate": round(div, 5),
        "mean_coef_err_in_posterior_sd": round(err_sd, 4),
        "min_ess_sampled": round(ess_min, 1),
        "ess_per_grad": round(ess_per_grad, 6),
        "hmc_fixed_L16_ess_per_grad": round(h_ess_per_grad, 6),
        "hmc_fixed_L16_max_rhat": round(h_rhat, 4),
        "ess_per_grad_vs_fixed_L16": round(
            ess_per_grad / max(h_ess_per_grad, 1e-12), 3),
        "trajectory_length": round(T, 4),
        "mean_leapfrog": round(mean_L, 2),
        "criterion": "snaper",
        "step_size": eps,
        "adaptive": True,
    }


def bench_scale_densemass():
    """Correlated-coefficient linear model, d=256, N=8192, DENSE mass HMC,
    128 chains — the batched-Cholesky machinery row, gated on the exact
    closed-form posterior. Schedule L=32, target 0.85, 600+1024: longer
    trajectories cost more grads/transition but amortize the fixed
    per-transition overhead."""
    import fugue_tpu as ft
    from fugue_tpu.inference.hmc import HMCConfig, hmc_chain
    from fugue_tpu.inference.mcmc_utils import split_r_hat

    DD, DN, DC, L = 256, 8192, 128, 32
    NW, NS = 600, 1024
    ii = np.arange(DD)
    Sigma = np.exp(-np.abs(ii[:, None] - ii[None, :]) / 32.0)
    Ls = np.linalg.cholesky(Sigma)
    Lj = jnp.asarray(Ls, jnp.float32)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(98), 3)

    @jax.jit
    def gen():
        # data + exact closed-form posterior, all on device (f32 solves)
        X = jax.random.normal(k1, (DN, DD)) / np.float32(np.sqrt(DD))
        w_true = Lj @ jax.random.normal(k2, (DD,))
        yv = X @ w_true + jax.random.normal(k3, (DN,))
        Lam = (jnp.linalg.inv(Sigma.astype(np.float32))
               + X.T @ X)
        Pcov = jnp.linalg.inv(Lam)
        pmean = Pcov @ (X.T @ yv)
        return X, yv, pmean, jnp.sqrt(jnp.diag(Pcov))

    Xj, yj, pmean, psd = gen()

    def model(Xd, yd):
        w = ft.sample(
            "w", ft.MultivariateNormal(jnp.zeros(DD), scale_tril=Lj)
        )
        ft.observe("y", ft.Normal(Xd @ w, 1.0), yd)

    staged = ft.stage(model, Xj, yj)
    cfg = HMCConfig(n_leapfrog=L, mass="dense", target_accept=0.85)

    stats = jax.jit(lambda ws, divs: (
        jnp.max(jnp.abs(jnp.mean(ws, axis=(0, 1)) - pmean) / psd),
        jnp.min(jnp.std(ws.reshape(-1, DD), axis=0) / psd),
        jnp.max(jnp.std(ws.reshape(-1, DD), axis=0) / psd),
        jnp.max(jax.vmap(split_r_hat, in_axes=2)(ws[:, :, ::8])),
        jnp.mean(divs.astype(jnp.float32)),
    ))

    def run(i):
        r = hmc_chain(jax.random.fold_in(jax.random.PRNGKey(22), i),
                      n_samples=NS, n_warmup=NW, n_chains=DC,
                      config=cfg, staged=staged)
        return [float(x) for x in stats(r.samples["w"], r.divergences)]

    run(0)  # compile
    t0 = time.perf_counter()
    err, sd_lo, sd_hi, rhat, div = run(1)
    elapsed = time.perf_counter() - t0
    n_grad = (NW + NS) * (L + 1)
    rate = DC * n_grad / elapsed
    flops_eval = 2 * DN * DD + DD * DD
    ref_grad_sec = 2 * DD * (flops_eval / SCALAR_CORE_FLOPS)
    return {
        "submetric": "scale_densemass_mvn_d256_grad_evals_per_sec",
        "value": round(rate, 1),
        "unit": "grad-evals/s",
        "vs_baseline": round(rate * ref_grad_sec, 1),
        "wall_s": round(elapsed, 3),
        "max_norm_mean_err_in_posterior_sd": round(err, 3),
        "marginal_sd_ratio_minmax": [round(sd_lo, 3), round(sd_hi, 3)],
        "max_rhat_sampled": round(rhat, 4),
        "divergence_rate": round(div, 5),
    }


def bench_scale_plate():
    """10^6-row observation plate (128 groups x 8192), 64 chains — the
    memory/elementwise-bound row."""
    import fugue_tpu as ft
    from fugue_tpu.inference.hmc import HMCConfig, hmc_chain
    from fugue_tpu.inference.mcmc_utils import split_r_hat

    PG, PNB, PC, L = 128, 8192, 64, 16
    # 400+256: the r5 widened gate (max R-hat over ALL groups) showed
    # 100+64 left slow coordinates at R-hat ~1.5 — the per-group posterior
    # sd is ~0.011, so a diffuse init needs the longer adaptation, and the
    # 128-group max-R-hat statistic needs the longer chains (1.031 at 128
    # samples was estimator spread, not bias)
    NW, NS = 400, 256
    ka, kb = jax.random.split(jax.random.PRNGKey(97))

    @jax.jit
    def gen():
        theta_true = jax.random.normal(ka, (PG,))
        Y = theta_true[:, None] + jax.random.normal(kb, (PG, PNB))
        return Y

    Y = gen()

    def model(Yd):
        mu = ft.sample("mu", ft.Normal(0.0, 1.0))
        theta = ft.sample("theta", ft.Normal(mu, 1.0), sample_shape=(PG,))
        ft.observe("Y", ft.Normal(theta[:, None], 1.0), Yd)

    staged = ft.stage(model, Y)
    # jitter 0.5: at fixed L=16 on this near-Gaussian plate posterior the
    # default 0.2 step jitter leaves a trajectory-length resonance
    cfg = HMCConfig(n_leapfrog=L, jitter=0.5)

    stats = jax.jit(lambda th, divs: (
        # per-group posterior ~= N(ybar_g * n/(n+1), 1/(n+1)) (weak mu prior)
        jnp.max(jnp.abs(jnp.mean(th, axis=(0, 1))
                        - jnp.mean(Y, axis=1) * (PNB / (PNB + 1.0)))
                * np.float32(np.sqrt(PNB + 1.0))),
        # gate the MAX split-R-hat over ALL sampled group means, not just
        # theta[0] (VERDICT r4 weak #4)
        jnp.max(split_r_hat(jnp.moveaxis(th, 2, 0))),
        jnp.mean(divs.astype(jnp.float32)),
    ))

    # analytic warm start: z = [mu, theta_g] with theta_g ~= ybar_g
    # (conjugate posterior mode) — the at-scale workflow, matching the
    # logistic rows' MAP warm start
    z0 = jnp.concatenate([
        jnp.zeros((1,), jnp.float32),
        (jnp.mean(Y, axis=1) * (PNB / (PNB + 1.0))).astype(jnp.float32),
    ])

    def run(i):
        r = hmc_chain(jax.random.fold_in(jax.random.PRNGKey(23), i),
                      n_samples=NS, n_warmup=NW, n_chains=PC,
                      config=cfg, staged=staged,
                      init_position=z0, init_jitter=0.01)
        return [float(x) for x in stats(r.samples["theta"], r.divergences)]

    run(0)  # compile
    t0 = time.perf_counter()
    err, rhat, div = run(1)
    elapsed = time.perf_counter() - t0
    n_grad = (NW + NS) * (L + 1)
    rows_per_sec = PC * n_grad * PG * PNB / elapsed

    # the fused per-row normal-logpdf grad is ~10 elementwise flops/row;
    # the row reports achieved useful FLOP/s (no roofline yet)
    flops_eval = PG * PNB * 10
    useful_flops = PC * n_grad * flops_eval / elapsed
    ref_grad_sec = 2 * (PG + 2) * (flops_eval / SCALAR_CORE_FLOPS)
    return {
        "submetric": "scale_plate_1e6_rows_obs_grad_rows_per_sec",
        "value": round(rows_per_sec, 1),
        "unit": "obs-grad-rows/s",
        "vs_baseline": round(
            (PC * n_grad / elapsed) * ref_grad_sec, 1
        ),
        "wall_s": round(elapsed, 3),
        "useful_flops_per_sec": round(useful_flops, 1),
        "max_group_mean_err_in_sd": round(err, 3),
        "max_rhat_groups": round(rhat, 4),
        "divergence_rate": round(div, 5),
    }


ROWS = [
    ("mh", bench_mh),
    ("hmc", bench_hmc),
    ("nuts", bench_nuts),
    ("chees", bench_chees),
    ("smc", bench_smc),
    ("smc_hmc", bench_smc_hmc),
    ("vi", bench_vi),
    ("abc", bench_abc),
    ("scale_logistic", bench_scale_logistic),
    ("scale_nuts", bench_scale_nuts),
    ("scale_chees", bench_scale_chees),
    ("scale_densemass", bench_scale_densemass),
    ("scale_plate", bench_scale_plate),
    ("vi_scale", bench_vi_scale),
]


def main():
    from fugue_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = device_info()
    if device["platform"] != "gpu":
        print(f"bench: no GPU found (JAX platform {device['platform']!r})",
              file=sys.stderr)
        return 1
    device_peaks()  # an unknown card fails here, before any row
    results, failed = {}, []
    for name, fn in ROWS:
        t0 = time.perf_counter()
        try:
            row = fn()
        except Exception as e:
            traceback.print_exc()
            row = {"submetric": name, "error": repr(e)}
            failed.append(name)
        row["total_s_incl_compile"] = round(time.perf_counter() - t0, 1)
        row.update(device)
        results[name] = row
        print(json.dumps(row), flush=True)
    if failed:
        print(f"bench: rows failed: {failed}", file=sys.stderr)
        return 1

    # headline (driver schema) — LAST line
    mh = results["mh"]
    print(
        json.dumps(
            {
                "metric": mh["submetric"],
                "value": mh["value"],
                "unit": mh["unit"],
                "vs_baseline": mh["vs_baseline"],
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
