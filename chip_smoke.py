"""Smoke test of fugue-tpu on an NVIDIA GPU: the main path at bench sizes.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py             # phases P0-P5 on one card
    python chip_smoke.py --chips 4   # only the sharded drives, on four cards

Phases (one process; each compares with a plain reference):

- P0 device: JAX must see a GPU; prints the card, its power limit, the JAX
  version, ``XLA_FLAGS`` and the compile-cache directory.
- P1 f32 conjugate gates: the conjugate harnesses and a posterior-moment
  gate for every engine on the f32 path, against closed forms.
- P2 eight schools through NUTS, HMC and ChEES at 1024 chains: finite
  draws, max split-R-hat, and the three engines' posterior means of ``mu``
  and ``tau`` agreeing within Monte-Carlo error.
- P3 Bayesian logistic regression at full width (d=1024, N=1e5, 256
  chains): HMC quality gates, and the staged potential and gradient against
  a plain ``jax.numpy`` density at HIGHEST precision.
- P4 SMC log-evidence at 131072 particles against the closed form; XLA
  systematic resampling at 2^20 particles against an f64 inversion; times
  of the plain XLA log-sum-exp, resampling and Normal-plate gradient.
- P5 the JSON-RPC service in process: sessions and one-shot engines.

Every phase prints its readings and its compile and run seconds. A failed
gate makes the script exit non-zero without the result line. The last line
of a passing run is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


# ---------------------------------------------------------------------------
# gates, readings and per-phase compile/run seconds
# ---------------------------------------------------------------------------

# XLA's compile of each program (traces of nested jits overlap each other,
# so tracing is left in the run seconds)
_COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"


class Report:
    """Collects gate outcomes and attributes XLA compile time to phases."""

    def __init__(self):
        self.failed = []
        self._compile_s = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event == _COMPILE_EVENT:
            self._compile_s += duration

    def gate(self, name, ok, **readings):
        from fugue_tpu.serve import _jsonable

        ok = bool(ok)
        if not ok:
            self.failed.append(name)
        print(json.dumps({"gate": name, "passed": ok, **_jsonable(readings)}),
              flush=True)
        return ok

    def phase(self, name, fn, *args, **kwargs):
        print(f"== {name}", flush=True)
        c0, t0 = self._compile_s, time.perf_counter()
        try:
            fn(self, *args, **kwargs)
        except Exception as e:  # a crashed phase is a failed gate
            traceback.print_exc()
            self.gate(f"{name}: raised", False, error=repr(e)[:2000])
        wall = time.perf_counter() - t0
        compile_s = self._compile_s - c0
        print(json.dumps({"phase": name, "wall_s": wall,
                          "compile_s": compile_s,
                          "run_s": wall - compile_s}), flush=True)


def _split_rhat_max(samples):
    """Max split-R-hat over every coordinate of every site."""
    from fugue_tpu.inference.mcmc_utils import split_r_hat

    worst = 0.0
    for v in samples.values():
        v = np.asarray(v, np.float64)
        flat = v.reshape(v.shape[0], v.shape[1], -1)
        rh = np.asarray(split_r_hat(np.moveaxis(flat, 2, 0)))
        worst = max(worst, float(rh.max()))
    return worst


def _mean_and_mcse(draws):
    from fugue_tpu.inference.mcmc_utils import ess_multichain

    x = np.asarray(draws, np.float64)
    ess = float(ess_multichain(x))
    return float(x.mean()), float(x.std() / math.sqrt(max(ess, 1.0)))


# ---------------------------------------------------------------------------
# P0 device
# ---------------------------------------------------------------------------


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def phase_device(rep, expect_count=1):
    from fugue_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    devs = jax.devices()
    print(json.dumps({
        "platform": devs[0].platform, "device_kind": devs[0].device_kind,
        "device_count": len(devs), "jax": jax.__version__,
        "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""),
        "compile_cache_dir": cache_dir,
    }), flush=True)
    print(f"nvidia-smi: {nvidia_smi_line()}", flush=True)
    rep.gate("P0 device count", len(devs) >= expect_count,
             need=expect_count, have=len(devs))
    rep.gate("P0 f32 default", jnp.asarray(1.0).dtype == jnp.float32)


# ---------------------------------------------------------------------------
# P1 f32 conjugate gates (the engine-by-engine closed-form checks)
# ---------------------------------------------------------------------------


def phase_conjugate(rep):
    import fugue_tpu as ft
    from scipy import stats as st
    from fugue_tpu.inference.validation import (
        validate_beta_bernoulli, validate_conjugate_normal,
    )

    # 1) reference-parity conjugate harnesses (2-SE gates, ESS-based)
    for sampler in ("hmc", "mh"):
        for name, fn, seed in (("conjugate_normal", validate_conjugate_normal, 11),
                               ("beta_bernoulli", validate_beta_bernoulli, 12)):
            r = fn(jax.random.PRNGKey(seed), sampler)
            rep.gate(f"P1 {name}_{sampler}", r.passed,
                     checks={k: bool(v) for k, v in r.checks.items()},
                     observed_mean=float(r.observed_mean),
                     expected_mean=float(r.expected_mean))

    # 2) per-engine posterior-moment gates on one conjugate Normal target:
    #    posterior N(sum(y)/(tau0+n), 1/(tau0+n)) with tau0=0.25, n=5
    ys = jnp.array([1.2, 0.8, 1.5, 0.9, 1.1])
    tau = 0.25 + 5.0
    post_mean, post_var = float(ys.sum()) / tau, 1.0 / tau

    def model():
        mu = ft.sample("mu", ft.Normal(0.0, 2.0))
        ft.observe("ys", ft.Normal(mu, 1.0), ys)

    staged = ft.stage(model)

    def moment_gate(name, draws, mean_tol_sd=0.15, var_tol=0.25, **extra):
        x = np.asarray(draws).reshape(-1).astype(np.float64)
        mean_err = abs(x.mean() - post_mean) / np.sqrt(post_var)
        var_err = abs(x.var() - post_var) / post_var
        rep.gate(name, np.isfinite(x).all() and mean_err < mean_tol_sd
                 and var_err < var_tol,
                 mean_err_in_posterior_sd=mean_err, var_rel_err=var_err,
                 **extra)

    r = ft.nuts_chain(jax.random.PRNGKey(1), staged=staged, n_samples=1000,
                      n_warmup=500, n_chains=64)
    moment_gate("P1 nuts_f32", r.samples["mu"],
                divergence_rate=float(np.asarray(r.divergences).mean()))

    r = ft.chees_chain(jax.random.PRNGKey(2), staged=staged, n_samples=1000,
                       n_warmup=500, n_chains=64)
    moment_gate("P1 chees_f32", r.samples["mu"],
                divergence_rate=float(np.asarray(r.divergences).mean()),
                trajectory_length=r.trajectory_length)

    from fugue_tpu.inference.ess import ess_chain
    r = ess_chain(jax.random.PRNGKey(3), staged=staged, n_samples=1000,
                  n_warmup=200, n_chains=64)
    moment_gate("P1 elliptical_slice_f32", r.samples["mu"])

    from fugue_tpu.inference.tempering import PTConfig, pt_chain
    r = pt_chain(jax.random.PRNGKey(4), staged=staged, n_samples=800,
                 n_warmup=400, config=PTConfig(n_temps=4, beta_min=0.1),
                 n_chains=16)
    moment_gate("P1 parallel_tempering_f32", r.samples["mu"])

    r = ft.adaptive_smc(jax.random.PRNGKey(5), 8192, staged=staged)
    w = np.exp(np.asarray(r.log_weights, np.float64))
    w = w / w.sum()
    x = np.asarray(r.particles["mu"], np.float64)
    sm = float((w * x).sum())
    logz = float(st.multivariate_normal(
        mean=np.zeros(5), cov=np.eye(5) + 4.0).logpdf(np.asarray(ys, np.float64)))
    mean_err = abs(sm - post_mean) / np.sqrt(post_var)
    logz_err = abs(float(r.log_evidence) - logz)
    rep.gate("P1 smc_f32", mean_err < 0.2 and logz_err < 0.1,
             weighted_mean_err_in_sd=mean_err, logZ_abs_err=logz_err)

    r = ft.optimize_meanfield_vi(
        jax.random.PRNGKey(6), staged=staged,
        config=ft.VIConfig(n_iterations=1500, n_samples=64))
    loc = float(np.asarray(r.params["mu"]["loc"]))
    rep.gate("P1 vi_f32",
             abs(loc - post_mean) < 3 * np.sqrt(post_var / 64) + 0.02
             and np.isfinite(r.elbo_history).all(),
             loc_err=abs(loc - post_mean), final_elbo=float(r.elbo_history[-1]))

    # 3) exact discrete marginalization (f32 logsumexp path)
    def mix_model():
        k = ft.sample("k", ft.Bernoulli(0.3))
        mu = ft.sample("mu", ft.Normal(jnp.where(k, 2.0, -2.0), 1.0))
        ft.observe("y", ft.Normal(mu, 0.5), jnp.array(1.5))

    from fugue_tpu.inference.marginalize import marginalize
    marg = marginalize(staged=ft.stage(mix_model))
    r = ft.nuts_chain(jax.random.PRNGKey(7), staged=marg, n_samples=800,
                      n_warmup=400, n_chains=32)
    mu_draws = np.asarray(r.samples["mu"]).reshape(-1)
    # quadrature ground truth over the 2-component posterior
    grid = np.linspace(-8, 8, 4001)
    dens = (0.3 * st.norm(2, 1).pdf(grid) + 0.7 * st.norm(-2, 1).pdf(grid)) \
        * st.norm(grid, 0.5).pdf(1.5)
    dens /= np.trapezoid(dens, grid)
    qm = float(np.trapezoid(grid * dens, grid))
    rep.gate("P1 marginalize_f32", abs(mu_draws.mean() - qm) < 0.05,
             mean_err=abs(float(mu_draws.mean()) - qm))

    # 4) ABC: exact-match rejection on the sufficient statistic is the exact
    #    conjugate posterior Beta(2+s, 2+f); weighted ABC-SMC on a mean
    from fugue_tpu.inference.abc import (
        ABCSMCConfig, abc_rejection, abc_smc_weighted,
    )

    flips = jnp.array([1, 1, 1, 0, 1, 0, 1, 1, 0, 1], dtype=bool)

    def coin():
        p = ft.sample("p", ft.Beta(2.0, 2.0))
        return ft.sample("flips", ft.Bernoulli(p), sample_shape=(10,))

    r = abc_rejection(
        jax.random.PRNGKey(9), coin, observed=flips,
        distance=lambda a, b: jnp.abs(
            jnp.sum(a.astype(jnp.float32)) - jnp.sum(b.astype(jnp.float32))),
        epsilon=0.5, n_samples=512, batch_size=8192, max_attempts=1 << 22,
    )
    ps = np.asarray(r.particles["p"], np.float64)
    # Beta(9, 5): mean 9/14, sd ~0.123; MC err ~ sd/sqrt(512)
    rep.gate("P1 abc_rejection_f32",
             abs(ps.mean() - 9.0 / 14.0) < 0.03 and abs(ps.std() - 0.12323) < 0.03,
             mean_err=abs(float(ps.mean()) - 9.0 / 14.0),
             n_attempts=int(r.n_attempts))

    def gauss_sim():
        mu = ft.sample("mu_p", ft.Normal(0.0, 2.0))
        return ft.sample("xs", ft.Normal(mu, 1.0), sample_shape=(16,))

    obs = np.asarray(st.norm(1.0, 1.0).rvs(16, random_state=7), np.float32)
    rs = abc_smc_weighted(
        jax.random.PRNGKey(10), gauss_sim, observed=jnp.asarray(obs),
        distance=lambda a, b: jnp.abs(jnp.mean(a) - jnp.mean(b)),
        config=ABCSMCConfig(n_particles=512, epsilons=(1.0, 0.5, 0.25, 0.1)),
        param_addresses=("mu_p",),
    )
    w = np.exp(np.asarray(rs.log_weights, np.float64))
    w = w / w.sum()
    wm = float((w * np.asarray(rs.particles["mu_p"], np.float64)).sum())
    # conjugate-on-mean posterior; eps=0.1 inflates the variance, so the
    # gate is loose
    post_m = (16.0 * float(obs.mean())) / (0.25 + 16.0)
    rep.gate("P1 abc_smc_f32", abs(wm - post_m) < 0.15,
             weighted_mean_err=abs(wm - post_m), n_attempts=int(rs.n_attempts))

    # 5) Gibbs (mixed discrete/continuous), dynamic MH (two-model
    #    posterior odds), MAP/Laplace (curvature + evidence)
    from fugue_tpu.inference.gibbs import gibbs_chain

    def gibbs_model():
        heads = ft.sample("heads", ft.Bernoulli(0.5))
        mu = ft.sample("mu", ft.Normal(jnp.where(heads, 1.0, -1.0), 1.0))
        ft.observe("yg", ft.Normal(mu, 0.5), jnp.array([1.1, 0.9, 1.2]))

    rg = gibbs_chain(jax.random.PRNGKey(13), gibbs_model, n_samples=1500,
                     n_warmup=500, n_chains=32)
    y_g = np.array([1.1, 0.9, 1.2], np.float64)
    cov_g = 0.25 * np.eye(3) + np.ones((3, 3))
    zp = st.multivariate_normal(mean=np.ones(3), cov=cov_g).pdf(y_g)
    zm = st.multivariate_normal(mean=-np.ones(3), cov=cov_g).pdf(y_g)
    heads_post = zp / (zp + zm)
    # conditional mu posteriors: precision 1 + 3/0.25 = 13
    mu_plus = (1.0 + y_g.sum() / 0.25) / 13.0
    mu_minus = (-1.0 + y_g.sum() / 0.25) / 13.0
    mu_post = heads_post * mu_plus + (1 - heads_post) * mu_minus
    heads_hat = float(np.asarray(rg.samples["heads"], np.float64).mean())
    mu_hat = float(np.asarray(rg.samples["mu"], np.float64).mean())
    rep.gate("P1 gibbs_f32",
             abs(heads_hat - heads_post) < 0.03 and abs(mu_hat - mu_post) < 0.05
             and np.isfinite(mu_hat),
             heads_err=abs(heads_hat - heads_post), mu_err=abs(mu_hat - mu_post))

    from fugue_tpu.inference.mh_dynamic import adaptive_mcmc_chain_dynamic

    y_obs = 2.4

    def trans_model():
        use_b = ft.sample("use_b", ft.Bernoulli(0.3))
        a = ft.sample("a", ft.Normal(0.0, 1.0))
        if bool(np.asarray(use_b)):
            b = ft.sample("b", ft.Normal(0.0, 1.0))
            mean = a + b
        else:
            mean = a
        ft.observe("yt", ft.Normal(mean, 0.5), jnp.asarray(y_obs))

    z0 = st.norm(0, np.sqrt(1.25)).pdf(y_obs)
    z1 = st.norm(0, np.sqrt(2.25)).pdf(y_obs)
    post_use_b = 0.3 * z1 / (0.3 * z1 + 0.7 * z0)
    # a host loop over traces: structure mixing is slow at 2,000
    # transitions, so this gate (0.12) catches f32 catastrophes (NaN
    # weights, wrong odds); the sharp 0.05 gate at 12k transitions is
    # tests/test_mh_dynamic.py::test_transdimensional_model_selection
    rd = adaptive_mcmc_chain_dynamic(
        jax.random.PRNGKey(1), trans_model, n_samples=1600, n_warmup=400)
    freq = float(rd.presence("b").mean())
    rep.gate("P1 dynamic_mh_f32",
             abs(freq - post_use_b) < 0.12
             and rd.birth_count > 0 and rd.death_count > 0,
             presence_err=abs(freq - post_use_b),
             births=int(rd.birth_count), deaths=int(rd.death_count))

    from scipy.special import betaln as sp_betaln
    from fugue_tpu.inference.map_laplace import (
        MAPConfig, laplace_approximation, map_estimate,
    )

    # curvature: conjugate Normal target (Gaussian, so Laplace is exact)
    rm = map_estimate(jax.random.PRNGKey(15), staged=staged,
                      config=MAPConfig(n_iterations=300, optimizer="lbfgs"))
    la = laplace_approximation(rm)
    map_err = abs(float(np.asarray(rm.z)[0]) - post_mean)
    cov_err = abs(float(np.asarray(la.cov)[0, 0]) - post_var) / post_var
    # evidence: Beta-Bernoulli Laplace vs exact B(9,5)/B(2,2)
    flips_ml = [1.0] * 7 + [0.0] * 3

    def coin_ml():
        p = ft.sample("p", ft.Beta(2.0, 2.0))
        for i, yv in enumerate(flips_ml):
            ft.observe(ft.addr("flip", i), ft.Bernoulli(p), yv)

    rm2 = map_estimate(jax.random.PRNGKey(16), coin_ml,
                       MAPConfig(n_iterations=300, optimizer="lbfgs"))
    la2 = laplace_approximation(rm2)
    ev_err = abs(float(la2.log_evidence) - float(sp_betaln(9, 5) - sp_betaln(2, 2)))
    rep.gate("P1 map_laplace_f32",
             map_err < 0.02 and cov_err < 0.05 and ev_err < 0.08,
             map_err=map_err, cov_rel_err=cov_err, log_evidence_abs_err=ev_err)

    # 6) simulation-based calibration: uniform ranks certify the whole HMC
    #    pipeline without a closed form
    from fugue_tpu.inference.sbc import sbc

    def sbc_model(data):
        mu = ft.sample("mu", ft.Normal(0.0, 1.0))
        sig = ft.sample("sig", ft.LogNormal(0.0, 0.5))
        ft.observe("y", ft.Normal(mu, sig), data["y"])

    r = sbc(jax.random.PRNGKey(8), sbc_model, {"y": jnp.zeros(8)},
            n_datasets=128, n_posterior=63, n_warmup=200, thin=4)
    rep.gate("P1 sbc_f32", r.passed, min_p_value=float(r.p_values.min()),
             n_datasets=int(r.ranks.shape[0]))


# ---------------------------------------------------------------------------
# P2 eight schools through the three gradient engines
# ---------------------------------------------------------------------------


def phase_eight_schools(rep, n_chains=1024, n_warmup=500, n_samples=500,
                        rhat_max=1.01):
    import fugue_tpu as ft
    from bench import eight_schools_model

    staged = ft.stage(eight_schools_model)
    kw = dict(n_samples=n_samples, n_warmup=n_warmup, n_chains=n_chains,
              staged=staged)
    runs = {
        "nuts": ft.nuts_chain(jax.random.PRNGKey(2), **kw),
        "hmc": ft.hmc_chain(jax.random.PRNGKey(1), config=ft.HMCConfig(
            n_leapfrog=32, target_accept=0.9), **kw),
        "chees": ft.chees_chain(jax.random.PRNGKey(5), config=ft.ChEESConfig(
            target_accept=0.8), **kw),
    }
    moments = {}
    for name, r in runs.items():
        finite = all(np.isfinite(np.asarray(v)).all() for v in r.samples.values())
        rhat = _split_rhat_max(r.samples)
        moments[name] = {s: _mean_and_mcse(r.samples[s]) for s in ("mu", "tau")}
        rep.gate(f"P2 {name} finite and max split-R-hat < {rhat_max}",
                 finite and rhat < rhat_max, max_split_rhat=rhat,
                 divergence_rate=float(np.asarray(r.divergences).mean()),
                 posterior={s: {"mean": m, "mcse": se}
                            for s, (m, se) in moments[name].items()})
    names = list(runs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            for s in ("mu", "tau"):
                (ma, sa), (mb, sb) = moments[a][s], moments[b][s]
                z = abs(ma - mb) / math.sqrt(sa * sa + sb * sb)
                rep.gate(f"P2 {a} vs {b} posterior mean of {s} within 4 MCSE",
                         z <= 4.0, z=z)


# ---------------------------------------------------------------------------
# P3 full-width Bayesian logistic regression
# ---------------------------------------------------------------------------


def reference_logistic_potential(X, y, w):
    """U(w) = -(log N(w; 0, I) + sum_i log Bernoulli(y_i; sigmoid(x_i.w))),
    written in plain ``jax.numpy`` at HIGHEST precision, independently of
    ``fugue_tpu.ops``. ``X`` is read as the staged model reads it: rounded
    to bf16, then cast to f32."""
    Xf = X.astype(jnp.bfloat16).astype(jnp.float32)
    logits = jnp.matmul(Xf, w, precision=jax.lax.Precision.HIGHEST)
    yf = y.astype(jnp.float32)
    log_lik = jnp.sum(yf * logits - jnp.logaddexp(0.0, logits))
    log_prior = jnp.sum(-0.5 * w * w) - 0.5 * w.shape[-1] * math.log(2 * math.pi)
    return -(log_prior + log_lik)


def logistic_kernel_check(staged, X, y, positions):
    """Staged potential and gradient vs the plain reference at ``positions``
    (k, d). Returns (readings, compiled staged value_and_grad)."""
    data = staged.data_leaves()

    def staged_vg(Z, *dl):
        with staged.bind_data(dl):
            return jax.vmap(jax.value_and_grad(
                lambda z: staged.potential(z, None)))(Z)

    compiled = jax.jit(staged_vg).lower(positions, *data).compile()
    u, g = compiled(positions, *data)
    ref_vg = jax.jit(jax.vmap(jax.value_and_grad(
        lambda w, Xd, yd: reference_logistic_potential(Xd, yd, w)),
        in_axes=(0, None, None)))
    u_ref, g_ref = ref_vg(positions, X, y)
    u, g, u_ref, g_ref = (np.asarray(a, np.float64) for a in (u, g, u_ref, g_ref))
    cos = np.sum(g * g_ref, -1) / (
        np.linalg.norm(g, axis=-1) * np.linalg.norm(g_ref, axis=-1))
    readings = {
        "value_rel_err_max": float(np.max(np.abs(u - u_ref) / np.abs(u_ref))),
        "grad_cosine_min": float(cos.min()),
        "grad_rel_l2_max": float(np.max(
            np.linalg.norm(g - g_ref, axis=-1) / np.linalg.norm(g_ref, axis=-1))),
    }
    return readings, compiled


# value: split-bf16 forward, f32 accumulation; gradient: single-pass bf16
# backward by design (fugue_tpu.ops.matmul_bf16x2_fastgrad)
VALUE_REL_TOL = 1e-4
GRAD_COS_MIN = 0.999
GRAD_REL_L2_MAX = 2e-2


def phase_logistic(rep, D=1024, N=100_000, C=256, n_warmup=300,
                   n_samples=128):
    import fugue_tpu as ft
    from bench import _logistic_setup, _logistic_stats

    staged, w_true, m, D, N, C = _logistic_setup(D, N, C)
    X, y = staged.args
    print(json.dumps({"logistic": {"D": D, "N": N, "chains": C,
                                   "n_warmup": n_warmup,
                                   "n_samples": n_samples}}), flush=True)

    # kernel check at 4 positions around the MAP point
    pos = m.z[None, :] + 0.1 * jax.random.normal(
        jax.random.PRNGKey(3), (4, D), jnp.float32)
    readings, compiled = logistic_kernel_check(staged, X, y, pos)
    rep.gate("P3 staged potential and gradient vs plain reference",
             readings["value_rel_err_max"] <= VALUE_REL_TOL
             and readings["grad_cosine_min"] >= GRAD_COS_MIN
             and readings["grad_rel_l2_max"] <= GRAD_REL_L2_MAX,
             **readings)
    print(f"memory_analysis (staged value_and_grad, 4 positions): "
          f"{compiled.memory_analysis()}", flush=True)

    # TF32: does a plain f32 matmul run at reduced precision by default?
    Xf = X.astype(jnp.float32)
    wv = w_true.astype(jnp.float32)
    mm = jax.jit(lambda a, b: a @ b)
    mm_hi = jax.jit(lambda a, b: jnp.matmul(
        a, b, precision=jax.lax.Precision.HIGHEST))
    d_default, d_highest = mm(Xf, wv), mm_hi(Xf, wv)
    rel = float(jnp.max(jnp.abs(d_default - d_highest))
                / jnp.max(jnp.abs(d_highest)))
    print(json.dumps({"tf32_check": {
        "max_rel_diff_default_vs_highest": rel,
        "default_f32_matmul_is_reduced_precision": rel > 1e-5}}), flush=True)
    del Xf, d_default, d_highest

    stats = _logistic_stats(w_true)
    r = ft.hmc_chain(jax.random.PRNGKey(21), n_samples=n_samples,
                     n_warmup=n_warmup, n_chains=C,
                     config=ft.HMCConfig(n_leapfrog=16, target_accept=0.8),
                     staged=staged, init_position=m.z, init_jitter=0.05)
    rhat, err_sd, div, ess_min = (
        float(v) for v in stats(r.samples["w"], r.divergences))
    rep.gate("P3 hmc max sampled R-hat < 1.05", rhat < 1.05, max_rhat=rhat)
    # the posterior mean sits about one posterior sd from the truth, so a
    # calibrated run reads ~0.8 (E|Z| for a standard normal)
    rep.gate("P3 hmc mean coef error < 1.2 posterior sd", err_sd < 1.2,
             mean_coef_err_in_posterior_sd=err_sd)
    rep.gate("P3 hmc divergence rate < 0.01", div < 0.01, divergence_rate=div,
             min_ess_sampled=ess_min, step_size=r.step_size)
    stats_mem = jax.devices()[0].memory_stats() or {}
    print(json.dumps({"peak_bytes_in_use": stats_mem.get("peak_bytes_in_use")}),
          flush=True)


# ---------------------------------------------------------------------------
# P4 SMC evidence and resampling
# ---------------------------------------------------------------------------


def systematic_reference_check(key, log_weights):
    """XLA ``systematic_resample`` vs an f64 numpy comb inversion with the
    same ``u0``. Every selected index must bracket its comb point within
    ``tol`` of the f64 CDF. ``tol`` is the f32 noise floor of a cumulative
    sum of n normalized weights in any order: 4 * eps32 * sqrt(n), a
    random-walk bound on n roundings of partial sums no larger than 1. An
    index that differs from the f64 one by a slot or a few is within it."""
    from fugue_tpu.ops.resampling import systematic_resample

    n = log_weights.shape[-1]
    idx = np.asarray(systematic_resample(key, log_weights))
    u0 = float(jax.random.uniform(key, ()))
    lw = np.asarray(log_weights, np.float64)
    w = np.exp(lw - lw.max())
    cdf = np.cumsum(w) / w.sum()
    us = (np.arange(n) + u0) / n
    ref = np.clip(np.searchsorted(cdf, us, side="left"), 0, n - 1)
    lo = np.where(idx > 0, cdf[np.maximum(idx - 1, 0)], 0.0)
    hi = cdf[idx]
    # how far outside [cdf[i-1], cdf[i]] each comb point falls
    violation = np.maximum(np.maximum(lo - us, us - hi), 0.0)
    tol = 4 * np.finfo(np.float32).eps * math.sqrt(n)
    return {
        "n": n,
        "mismatch_fraction": float(np.mean(idx != ref)),
        "max_index_shift": int(np.max(np.abs(idx - ref))),
        "max_cdf_violation": float(violation.max()),
        "tol": float(tol),
        "ok": bool(violation.max() <= tol),
    }


def _time_call(fn, *args, reps=20):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def xla_op_times(sizes=(1 << 16, 1 << 20, 1 << 24)):
    """Device seconds per call of the plain XLA log-sum-exp, systematic
    resampling and Normal-plate value-and-gradient at each size."""
    import fugue_tpu as ft
    from fugue_tpu.core.numerics import log_sum_exp
    from fugue_tpu.ops.resampling import systematic_resample
    from fugue_tpu.runtime.interpreters import _accum_sum

    lse = jax.jit(log_sum_exp)
    resample = jax.jit(systematic_resample)
    plate = jax.jit(jax.value_and_grad(
        lambda p, yv: _accum_sum(ft.Normal(p[0], p[1]).log_prob(yv))))
    out = {}
    key = jax.random.PRNGKey(0)
    for n in sizes:
        x = jax.random.normal(jax.random.fold_in(key, n), (n,), jnp.float32)
        out[n] = {
            "log_sum_exp_s": _time_call(lse, x),
            "systematic_resample_s": _time_call(resample, key, x),
            "normal_plate_value_and_grad_s": _time_call(
                plate, jnp.array([0.1, 1.3], jnp.float32), x),
        }
    return out


def phase_smc(rep, n_particles=131072, resample_n=1 << 20,
              time_sizes=(1 << 16, 1 << 20, 1 << 24)):
    import fugue_tpu as ft
    from bench import conjugate_evidence_model, conjugate_log_evidence

    staged = ft.stage(conjugate_evidence_model)
    r = ft.adaptive_smc(jax.random.PRNGKey(33), n_particles, staged=staged,
                        config=ft.SMCConfig(rejuvenation_steps=3))
    err = abs(float(r.log_evidence) - conjugate_log_evidence())
    rep.gate("P4 smc |logZ - closed form| <= 0.05", err <= 0.05,
             n_particles=n_particles, logZ_abs_err=err, n_stages=int(r.n_stages))

    lw = 3.0 * jax.random.normal(jax.random.PRNGKey(4), (resample_n,), jnp.float32)
    res = systematic_reference_check(jax.random.PRNGKey(5), lw)
    rep.gate("P4 systematic_resample f32 vs f64 inversion", res.pop("ok"), **res)

    if time_sizes:
        print(json.dumps({"xla_op_seconds_per_call": xla_op_times(time_sizes)}),
              flush=True)


# ---------------------------------------------------------------------------
# P5 the JSON-RPC service, in process
# ---------------------------------------------------------------------------

SERVICE_SOURCE = (
    'let mu <- sample("mu", normal(0.0, 2.0));'
    'for i in 0..3 { observe(("y", i), normal(mu, 1.0), ys[i]); }'
    'return mu;'
)
SERVICE_DATA = {"ys": [1.0, 1.2, 0.8]}
# posterior N(3.0 / 3.25, 1 / 3.25)
SERVICE_MEAN, SERVICE_SD = 3.0 / 3.25, math.sqrt(1.0 / 3.25)


def _all_finite(x):
    if isinstance(x, dict):
        return all(_all_finite(v) for v in x.values())
    if isinstance(x, list):
        return all(_all_finite(v) for v in x)
    if isinstance(x, float):
        return math.isfinite(x)
    return True


def phase_service(rep, expect_devices=1, sessions=True):
    """Every engine method of the service on one compiled model; with
    ``sessions=False`` only ``compile`` and ``hmc.sharded``."""
    from fugue_tpu.serve import FugueService

    svc = FugueService(seed=0)

    def call(method, **params):
        out = svc.handle({"method": method, "params": params, "id": 1})
        ok = "error" not in out and out.get("id") == 1 and _all_finite(
            out.get("result"))
        rep.gate(f"P5 {method} well-formed and finite", ok,
                 **({"error": out["error"]} if "error" in out else {}))
        return out.get("result") or {}

    mid = call("compile", source=SERVICE_SOURCE, data=SERVICE_DATA)["model_id"]
    if sessions:
        _service_sessions(rep, call, mid)
    hs = call("hmc.sharded", model_id=mid, n_samples=500, n_warmup=500)
    summ = hs.get("summaries", {}).get("mu", {"mean": [math.inf], "r_hat": [math.inf]})
    rep.gate("P5 hmc.sharded posterior mean within 0.05 of the closed form",
             hs.get("n_devices") == expect_devices
             and abs(summ["mean"][0] - SERVICE_MEAN) < 0.05
             and summ["r_hat"][0] < 1.05,
             n_devices=hs.get("n_devices"), summary=summ)


def _service_sessions(rep, call, mid):
    sid = call("mh.new", model_id=mid, n_chains=64)["session_id"]
    call("mh.step", session_id=sid, n=100)
    sid = call("hmc.new", model_id=mid, n_leapfrog=8)["session_id"]
    call("hmc.step", session_id=sid)
    call("hmc.step", session_id=sid, recorded=True)
    sid = call("nuts.new", model_id=mid, warmup=100)["session_id"]
    call("nuts.step", session_id=sid)
    call("nuts.step", session_id=sid, recorded=True)
    sid = call("chees.new", model_id=mid, n_chains=64, n_warmup=150)["session_id"]
    call("chees.step", session_id=sid, n=20)
    smc = call("smc.run", model_id=mid, n_particles=4096)
    rep.gate("P5 smc.run posterior mean",
             abs(smc.get("posterior_means", {}).get("mu", math.inf)
                 - SERVICE_MEAN) < 0.05,
             posterior_means=smc.get("posterior_means"))
    vi = call("vi.run", model_id=mid, n_iterations=1000, posterior_draws=4096)
    post = vi.get("posterior", {}).get("mu", {"mean": [math.inf], "sd": [math.inf]})
    rep.gate("P5 vi.run posterior within 0.05 of the closed form",
             abs(post["mean"][0] - SERVICE_MEAN) < 0.05
             and abs(post["sd"][0] - SERVICE_SD) < 0.05, posterior=post)


# ---------------------------------------------------------------------------
# --chips N: the sharded drives against the same engines on one card
# ---------------------------------------------------------------------------


def _spans(rep, name, arr, n):
    devices = {s.device for s in arr.addressable_shards}
    rep.gate(f"{name} output spans {n} devices", len(devices) == n,
             devices=len(devices), sharding=str(arr.sharding))


def phase_multichip(rep, n=4, n_chains=256, n_warmup=300, n_samples=500,
                    n_particles=131072, plate_n=1 << 22):
    import fugue_tpu as ft
    from bench import conjugate_evidence_model
    from jax.sharding import PartitionSpec as P
    from fugue_tpu.parallel.mesh import (
        DATA_AXIS, make_chain_data_mesh, make_chain_mesh,
    )
    from fugue_tpu.parallel.sharded import (
        _shard_map, sharded_chees_chain, sharded_hmc_chain,
        sharded_nuts_chain, sharded_smc, sharded_vi,
    )

    mesh = make_chain_mesh(n)
    staged = ft.stage(conjugate_evidence_model)
    kw = dict(n_samples=n_samples, n_warmup=n_warmup, n_chains=n_chains,
              staged=staged)
    for name, sharded, single in (
            ("hmc", sharded_hmc_chain, ft.hmc_chain),
            ("chees", sharded_chees_chain, ft.chees_chain),
            ("nuts", sharded_nuts_chain, ft.nuts_chain)):
        rs = sharded(jax.random.PRNGKey(1), mesh=mesh, **kw)
        r1 = single(jax.random.PRNGKey(1), **kw)
        _spans(rep, f"sharded_{name}_chain", rs.positions, n)
        (ms, ss), (m1, s1) = (_mean_and_mcse(r.samples["mu"]) for r in (rs, r1))
        z = abs(ms - m1) / math.sqrt(ss * ss + s1 * s1)
        rep.gate(f"sharded_{name}_chain mean of mu matches one card within "
                 f"4 MCSE", z <= 4.0 and np.isfinite(ms), z=z,
                 sharded=ms, one_card=m1)

    rs = sharded_smc(jax.random.PRNGKey(3), n_particles, staged=staged, mesh=mesh)
    r1 = ft.adaptive_smc(jax.random.PRNGKey(3), n_particles, staged=staged)
    _spans(rep, "sharded_smc", rs.log_weights, n)
    d = abs(float(rs.log_evidence) - float(r1.log_evidence))
    rep.gate("sharded_smc logZ matches one card within 0.1", d <= 0.1,
             sharded=float(rs.log_evidence), one_card=float(r1.log_evidence))

    ys = jnp.linspace(-1.0, 3.0, 64 * n)
    staged_vi = ft.stage(lambda yv: ft.observe(
        "ys", ft.Normal(ft.sample("mu", ft.Normal(0.0, 2.0)), 1.0), yv), ys)
    cfg = ft.VIConfig(n_iterations=1500, n_samples=16)
    rs = sharded_vi(jax.random.PRNGKey(5), staged=staged_vi, config=cfg,
                    mesh=mesh, shard="data")
    r1 = ft.optimize_meanfield_vi(jax.random.PRNGKey(5), staged=staged_vi,
                                  config=cfg)
    loc_s = float(np.asarray(rs.params["mu"]["loc"]))
    loc_1 = float(np.asarray(r1.params["mu"]["loc"]))
    # data mode draws the same guide samples as one card: only the order
    # of the f32 likelihood sum differs
    prec = 0.25 + ys.size
    exact = float(jnp.sum(ys)) / prec
    rep.gate("sharded_vi (data) loc matches one card and the closed form",
             abs(loc_s - loc_1) < 0.02 * math.sqrt(1 / prec) + 1e-4
             and abs(loc_s - exact) < 0.1 * math.sqrt(1 / prec) + 1e-3,
             sharded=loc_s, one_card=loc_1, exact=exact)

    mesh2 = make_chain_data_mesh(n // 2, 2)
    yp = jax.random.normal(jax.random.PRNGKey(7), (plate_n,), jnp.float32)

    def shard_fn(mu, y_local):
        local = jnp.sum(ft.Normal(mu[0], 1.0).log_prob(y_local))
        return jax.lax.psum(local, DATA_AXIS)[None]

    total = jax.jit(_shard_map(shard_fn, mesh2, in_specs=(P(), P(DATA_AXIS)),
                               out_specs=P()))(jnp.asarray([0.3]), yp)
    one = jax.jit(lambda y_: jnp.sum(ft.Normal(0.3, 1.0).log_prob(y_)))(yp)
    rel = abs(float(total[0]) - float(one)) / abs(float(one))
    rep.gate("data-plate psum matches one device (rtol 1e-5)", rel <= 1e-5,
             rel_err=rel)

    phase_service(rep, expect_devices=n, sessions=False)


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1,
                    help="1: phases P0-P5 on one card; N > 1: only the "
                         "sharded drives across N cards")
    args = ap.parse_args(argv)

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)

    rep = Report()
    rep.phase("P0 device", phase_device, expect_count=args.chips)
    if rep.failed:
        return 1
    if args.chips > 1:
        rep.phase(f"multi-card x{args.chips}", phase_multichip, n=args.chips)
    else:
        rep.phase("P1 f32 conjugate gates", phase_conjugate)
        rep.phase("P2 eight schools", phase_eight_schools)
        rep.phase("P3 full-width logistic", phase_logistic)
        rep.phase("P4 SMC", phase_smc)
        rep.phase("P5 service", phase_service)
    if rep.failed:
        print(f"chip_smoke: {len(rep.failed)} gate(s) failed: {rep.failed}",
              file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
