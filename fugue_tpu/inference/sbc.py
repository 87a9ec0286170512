"""Simulation-based calibration (Talts et al. 2018).

Beyond-parity validation harness (the reference stops at conjugate
known-answer checks, validation.rs:73-166): SBC tests the WHOLE inference
pipeline on any model, no closed form needed. For each synthetic dataset
``m``: draw θ_m from the prior, y_m from p(y|θ_m), run the sampler on y_m,
and record the rank of θ_m among L (approximately independent) posterior
draws. If the sampler targets the right posterior, every rank is uniform
on {0..L}; a χ² uniformity test per coordinate catches bias, over- and
under-dispersion.

Array-program form: the ENTIRE harness — prior-predictive generation, one HMC
chain per dataset, rank computation — is one jitted program with the
dataset axis vmapped, so hundreds of calibration replicates cost one
sampler wall-clock. Datasets reach the model through the data-as-arguments
machinery (``StagedModel.bind_data`` with ``min_bytes=0``), which requires
the model to take its observed data as ONE dict argument keyed by observed
address:

    def model(data):
        mu = ft.sample("mu", ft.Normal(0.0, 1.0))
        ft.observe("y", ft.Normal(mu, 1.0), data["y"])

    res = sbc(key, model, {"y": jnp.zeros(5)})
    assert res.passed
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import settings
from ..core.rng import chain_keys
from ..errors import ErrorCode, StagingError
from ..runtime.handler import run
from ..runtime.interpreters import PredictiveHandler
from ..runtime.staging import stage
from .hmc import HMCConfig, initial_positions, make_hmc_drive


@dataclass
class SBCResult:
    """Rank statistics + per-coordinate χ² uniformity report."""

    ranks: np.ndarray  # (n_datasets, d) ints in [0, L]
    n_posterior: int  # L
    coords: List[str]  # flat-coordinate labels (address[index])
    chi2: np.ndarray  # (d,) χ² statistics over n_bins equal bins
    p_values: np.ndarray  # (d,)
    n_bins: int
    passed: bool  # Bonferroni-corrected min p-value above alpha

    def report(self) -> str:
        lines = [
            f"SBC: {self.ranks.shape[0]} datasets x {self.n_posterior} "
            f"posterior draws, {self.n_bins} bins "
            f"({'PASS' if self.passed else 'FAIL'})"
        ]
        for j, name in enumerate(self.coords):
            lines.append(
                f"  {name:<24} chi2={self.chi2[j]:8.2f}  "
                f"p={self.p_values[j]:.4f}"
            )
        return "\n".join(lines)


def sbc(
    key,
    model_fn: Callable,
    data_template: Dict[str, Any],
    *,
    n_datasets: int = 128,
    n_posterior: int = 127,
    n_warmup: int = 300,
    thin: int = 4,
    config: Optional[HMCConfig] = None,
    n_bins: Optional[int] = None,
    alpha: float = 0.01,
    inference_model_fn: Optional[Callable] = None,
) -> SBCResult:
    """Run simulation-based calibration of the HMC pipeline on ``model_fn``.

    ``data_template``: dict ``{observed_address: template_array}`` — the
    model's single data argument; shapes/dtypes fix the dataset layout, the
    values are replaced by prior-predictive draws per replicate.

    ``inference_model_fn``: run the SAMPLER under a different model than
    the GENERATOR (default: the same). The SBC ranks then quantify how a
    misspecified pipeline miscalibrates — and a deliberately wrong prior is
    the harness's own negative control (the test suite asserts χ² rejects
    it).

    Ranks are computed on the UNCONSTRAINED flat coordinates: the per-site
    transforms are coordinate-wise monotone, so ranks are invariant (models
    with simplex sites, whose stick-breaking transform is not
    coordinate-wise, are rejected).
    """
    if config is None:
        config = HMCConfig(n_leapfrog=16)
    # coerce template values to arrays so EVERY observed leaf passes
    # bind_data's nbytes/dtype filter — a python-float leaf would otherwise
    # be silently skipped and the sampler would condition on the template
    # value instead of the generated draw (ADVICE r3)
    data_template = {k: np.asarray(v) for k, v in data_template.items()}
    staged = stage(model_fn, data_template)
    staged_inf = (staged if inference_model_fn is None
                  else stage(inference_model_fn, data_template))
    if [s_.address for s_ in staged_inf.continuous_sites] != [
            s_.address for s_ in staged.continuous_sites]:
        raise StagingError(
            ErrorCode.NOT_STAGEABLE,
            "generator and inference models must share the latent site set",
        )
    d = staged.dim
    if d == 0:
        raise StagingError(
            ErrorCode.NOT_STAGEABLE, "model has no continuous latent sites"
        )
    if staged.discrete_sites:
        raise StagingError(
            ErrorCode.NOT_STAGEABLE,
            "SBC ranks discrete sites are not supported; marginalize first",
            {"discrete": [s.address for s in staged.discrete_sites]},
        )
    for s in staged.continuous_sites:
        if s.support.kind == "simplex":
            raise StagingError(
                ErrorCode.NOT_STAGEABLE,
                "simplex sites break coordinate-wise rank invariance",
                {"site": s.address},
            )
    missing = set(staged.observed_addresses) - set(data_template)
    if missing:
        raise StagingError(
            ErrorCode.NOT_STAGEABLE,
            "data_template must carry every observed address",
            {"missing": sorted(missing)},
        )
    dt = settings.real_dtype()
    n_total = n_posterior * thin
    drive = make_hmc_drive(staged_inf, config, 1, n_total, n_warmup)
    template_keys = sorted(data_template)

    def one_dataset(k):
        k_gen, k_init, k_eps, k_run = jax.random.split(k, 4)
        # (θ_m, y_m) ~ prior predictive — one eager-style replay under trace
        _, tr = run(
            PredictiveHandler(k_gen, {}), staged.model_fn,
            *staged.args, **staged.kwargs,
        )
        latents = {
            s.address: tr.choices[s.address].value
            for s in staged.continuous_sites
        }
        z_true = staged_inf.unconstrain(latents).astype(dt)
        data_m = {a: tr.choices[a].value for a in template_keys}
        # template values are coerced to arrays above, so this full
        # flatten aligns 1:1 with bind_data's selected leaves (and
        # bind_data now asserts the lengths match — ADVICE r3)
        new_leaves = jax.tree_util.tree_flatten(((data_m,), {}))[0]
        with staged_inf.bind_data(new_leaves, min_bytes=0):
            q0 = initial_positions(staged_inf, k_init, 1, config.init)
            _, qs, _, _, _, _, _ = drive(q0, k_eps, k_run)
        z_post = qs[thin - 1 :: thin, 0, :]  # (n_posterior, d), thinned
        rank = jnp.sum((z_post < z_true[None, :]).astype(jnp.int32), axis=0)
        return rank

    prog = staged.cached_kernel(
        ("sbc", config, n_datasets, n_posterior, n_warmup, thin,
         None if inference_model_fn is None else id(inference_model_fn)),
        lambda: jax.jit(jax.vmap(one_dataset)),
    )
    ranks = np.asarray(prog(chain_keys(jax.random.fold_in(key, 41),
                                       n_datasets)))

    # χ² uniformity over equal-width bins of {0..L}
    L = n_posterior
    if n_bins is None:
        n_bins = max(4, min(20, (L + 1) // 8))
    edges = np.linspace(0, L + 1, n_bins + 1)
    expected = n_datasets / n_bins
    chi2 = np.zeros(d)
    for j in range(d):
        counts, _ = np.histogram(ranks[:, j], bins=edges)
        chi2[j] = float(((counts - expected) ** 2 / expected).sum())
    from scipy import stats as st

    p_values = st.chi2.sf(chi2, df=n_bins - 1)
    passed = bool(p_values.min() > alpha / d)  # Bonferroni

    coords = []
    for s in staged.continuous_sites:
        if s.z_size == 1:
            coords.append(s.address)
        else:
            coords.extend(f"{s.address}[{i}]" for i in range(s.z_size))
    return SBCResult(
        ranks=ranks,
        n_posterior=L,
        coords=coords,
        chi2=chi2,
        p_values=np.asarray(p_values),
        n_bins=n_bins,
        passed=passed,
    )
