"""The device boundary: what replaced the removed streaming kernels, the
compile cache, the benchmark's peak table, and the GPU smoke script.

The numerical checks run the f32 path that a GPU runs (``enable_x64(False)``)
against float64 references."""

import importlib.util
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import logsumexp as sp_logsumexp

import fugue_tpu as ft
from fugue_tpu import settings
from fugue_tpu.core.numerics import log_sum_exp
from fugue_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # chip_smoke imports bench by name
    sys.path.insert(0, REPO)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def chip_smoke():
    return _load("chip_smoke")


@pytest.fixture(scope="module")
def bench():
    return _load("bench")


# -- systematic resampling: XLA f32 against an f64 comb inversion ------------


@pytest.mark.parametrize("n", [1 << 13, 1 << 15, 1 << 17])
def test_systematic_resample_f32_vs_f64_inversion(chip_smoke, n):
    with jax.enable_x64(False):
        lw = 3.0 * jax.random.normal(jax.random.PRNGKey(n), (n,), jnp.float32)
        res = chip_smoke.systematic_reference_check(jax.random.PRNGKey(1), lw)
    assert res["ok"], res
    # a wrong inversion moves many slots far; f32 noise moves a few by a
    # few slots
    assert res["mismatch_fraction"] < 0.05, res
    assert res["max_index_shift"] <= 64, res


# -- log-sum-exp against scipy ------------------------------------------------


def _lse_case(case):
    rng = np.random.default_rng(0)
    if case == "long":
        return rng.normal(0.0, 30.0, 1 << 20)
    if case == "neg_inf_blocks":
        x = rng.normal(0.0, 5.0, 1 << 16)
        x[: 1 << 14] = -np.inf
        x[1 << 15: (1 << 15) + 4096] = -np.inf
        return x
    return np.full(4096, -np.inf)  # every term -inf


@pytest.mark.parametrize("case", ["long", "neg_inf_blocks", "all_neg_inf"])
def test_log_sum_exp_f32_vs_scipy(case):
    x = _lse_case(case).astype(np.float32)
    expected = sp_logsumexp(x.astype(np.float64))
    with jax.enable_x64(False):
        got = float(jax.jit(log_sum_exp)(jnp.asarray(x)))
    if np.isneginf(expected):
        assert np.isneginf(got)
    else:
        assert got == pytest.approx(expected, rel=1e-6, abs=1e-5)


# -- a Normal plate and its gradient, below and above the compensated-sum ----
#    threshold


@pytest.mark.parametrize("n", [1 << 15, 1 << 17])
def test_normal_plate_value_and_grad_vs_closed_form(n):
    assert (n >= settings.COMPENSATED_SUM_THRESHOLD) == (n == 1 << 17)
    rng = np.random.default_rng(n)
    y = rng.normal(0.5, 1.3, n).astype(np.float32)
    sigma = 1.3

    def model(yv):
        mu = ft.sample("mu", ft.Normal(0.0, 10.0))
        ft.observe("y", ft.Normal(mu, sigma), yv)

    mu = -0.2
    with jax.enable_x64(False):
        staged = ft.stage(model, jnp.asarray(y))
        u, g = jax.jit(jax.value_and_grad(staged.potential))(
            jnp.array([mu], jnp.float32))
    y64 = y.astype(np.float64)
    z = (y64 - mu) / sigma
    log_lik = np.sum(-0.5 * z * z) - n * (math.log(sigma)
                                          + 0.5 * math.log(2 * math.pi))
    log_prior = -0.5 * (mu / 10.0) ** 2 - math.log(10.0) - 0.5 * math.log(2 * math.pi)
    grad = -(np.sum(y64 - mu) / sigma ** 2 - mu / 100.0)
    assert float(u) == pytest.approx(-(log_lik + log_prior), rel=1e-5)
    assert float(g[0]) == pytest.approx(grad, rel=1e-4)


# -- the compile-cache helper -------------------------------------------------


@pytest.fixture()
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield before
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets nothing
    assert jax.config.jax_compilation_cache_dir == restore_cache_dir


def test_compile_cache_fixed_path_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    first = compile_cache.enable_compile_cache()
    second = compile_cache.enable_compile_cache()
    assert first == second == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == first
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# -- the benchmark's peak table -----------------------------------------------


def test_peaks_known_kind(bench):
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == {"bf16_flops": 989e12, "tf32_flops": 495e12,
                     "fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}


def test_peaks_unknown_kind_raises(bench):
    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks("cpu")


# -- chip_smoke.py ------------------------------------------------------------


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU found" in out.stderr


def test_logistic_reference_density_matches_staged_potential(chip_smoke, bench):
    """The P3 plain reference against the staged bf16x2 potential, N=512."""
    with jax.enable_x64(False):
        staged, _ = bench.logistic_target(D=64, N=512)
        X, y = staged.args
        pos = jax.random.normal(jax.random.PRNGKey(3), (4, 64), jnp.float32)
        readings, _ = chip_smoke.logistic_kernel_check(staged, X, y, pos)
    assert readings["value_rel_err_max"] <= chip_smoke.VALUE_REL_TOL, readings
    assert readings["grad_cosine_min"] >= chip_smoke.GRAD_COS_MIN, readings
    assert readings["grad_rel_l2_max"] <= chip_smoke.GRAD_REL_L2_MAX, readings


@pytest.fixture()
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m "
                    "pytest -m gpu tests/")


@pytest.mark.gpu
def test_full_width_logistic_kernel_on_gpu(gpu, chip_smoke, bench):
    """P3's kernel check at d=1024, N=1e5 on the card."""
    with jax.enable_x64(False):
        staged, w_true = bench.logistic_target()
        X, y = staged.args
        pos = w_true[None, :] + 0.1 * jax.random.normal(
            jax.random.PRNGKey(3), (4, w_true.shape[0]), jnp.float32)
        readings, _ = chip_smoke.logistic_kernel_check(staged, X, y, pos)
    assert readings["value_rel_err_max"] <= chip_smoke.VALUE_REL_TOL, readings
    assert readings["grad_cosine_min"] >= chip_smoke.GRAD_COS_MIN, readings
    assert readings["grad_rel_l2_max"] <= chip_smoke.GRAD_REL_L2_MAX, readings
