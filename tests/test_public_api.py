"""Public API surface coverage.

Reference parity: tests/public_api_coverage.rs (866 LoC) +
public_api_validation.rs — every public item is importable from the crate
root and behaves at the contract level. The reference re-exports its full API
flat at the crate root (src/lib.rs:16-59); fugue_tpu mirrors that.
"""


import jax
import jax.numpy as jnp
import pytest

import fugue_tpu as ft


FLAT_EXPORTS = [
    # errors
    "FugueError", "ErrorCode", "ErrorCategory", "ErrorContext",
    "ValidationError", "ModelStructureError", "TraceAccessError",
    "TypeMismatchError", "StagingError",
    # addresses + numerics
    "Address", "addr", "scoped_addr",
    "log_sum_exp", "weighted_log_sum_exp", "normalize_log_probs",
    "log1p_exp", "safe_log", "log_gamma",
    # distributions (all 17 + base + support)
    "Distribution", "Support",
    "Normal", "Uniform", "LogNormal", "Exponential", "Bernoulli",
    "Categorical", "Beta", "Gamma", "Binomial", "Poisson", "StudentT",
    "Cauchy", "Laplace", "Weibull", "ChiSquared", "InverseGamma",
    "DiscreteUniform",
    # model language
    "Model", "sample", "observe", "factor", "guard", "plate", "pure",
    "sequence_vec", "traverse_vec",
    # runtime
    "Handler", "run", "Trace", "Choice",
    "PriorHandler", "ReplayHandler", "ValuesHandler", "ScoreGivenTrace",
    "SafeReplayHandler", "SafeScoreGivenTrace", "StrictScoreGivenTrace",
    "ReconcilingScoreGivenTrace", "ReconcileReport",
    "score_given_trace", "score_given_trace_safe",
    "score_given_trace_strict", "score_given_trace_reconciled",
    "stage", "StagedModel", "Site", "LogDensityParts",
    # engines
    "adaptive_mcmc_chain", "MHState", "MHResult", "mh_step",
    "hmc_chain", "HmcSession", "HMCConfig", "HMCResult", "hmc_transition",
    "nuts_chain", "NUTSConfig", "NUTSResult", "nuts_transition",
    "adaptive_smc", "SMCConfig", "SMCResult", "importance_reweight",
    "optimize_meanfield_vi", "VIConfig", "VIResult", "MeanFieldGuide",
    "GuideError", "elbo", "estimate_elbo",
    "abc_rejection", "abc_smc", "abc_smc_weighted", "abc_scalar_summary",
    "ABCError", "ABCResult", "ABCSMCConfig", "SummaryStatsDistance",
    "euclidean_distance", "manhattan_distance",
    "gibbs_chain", "GibbsResult",
    # diagnostics + validation
    "ess", "ess_multichain", "r_hat", "split_r_hat", "geweke",
    "summarize_samples", "print_diagnostics", "ParameterSummary",
    "validate_conjugate_normal", "validate_beta_bernoulli",
    "ConjugateNormalConfig", "ConjugateBetaBernoulliConfig",
    "ValidationResult", "ks_two_sample",
]


@pytest.mark.parametrize("name", FLAT_EXPORTS)
def test_flat_export_exists(name):
    assert hasattr(ft, name), f"fugue_tpu.{name} missing from flat API"


def test_all_17_distributions_in_registry():
    assert len(ft.ALL_DISTRIBUTIONS) == 17
    for cls in ft.ALL_DISTRIBUTIONS:
        assert issubclass(cls, ft.Distribution)


def test_distribution_contract():
    """Every distribution exposes sample(key, shape) + log_prob + support."""
    key = jax.random.PRNGKey(0)
    instances = [
        ft.Normal(0.0, 1.0), ft.Uniform(0.0, 1.0), ft.LogNormal(0.0, 1.0),
        ft.Exponential(1.0), ft.Bernoulli(0.5), ft.Categorical.uniform(3),
        ft.Beta(2.0, 2.0), ft.Gamma(2.0, 1.0), ft.Binomial(10, 0.5),
        ft.Poisson(2.0), ft.StudentT(5.0), ft.Cauchy(0.0, 1.0),
        ft.Laplace(0.0, 1.0), ft.Weibull(1.5, 1.0), ft.ChiSquared(3.0),
        ft.InverseGamma(3.0, 1.0), ft.DiscreteUniform(0, 5),
    ]
    assert len({type(d) for d in instances}) == 17
    for d in instances:
        x = d.sample(key, (4,))
        assert x.shape == (4,)
        lp = d.log_prob(x)
        assert lp.shape == (4,)
        assert bool(jnp.all(jnp.isfinite(lp))), type(d).__name__
        assert isinstance(d.support, ft.Support)


def test_config_dataclasses_are_hashable():
    """Configs must be usable as jit static args / cache keys (the staged
    analog of the reference's plain config structs)."""
    for cfg in (ft.HMCConfig(), ft.NUTSConfig(), ft.SMCConfig(),
                ft.VIConfig(), ft.ABCSMCConfig()):
        hash(cfg)


def test_module_layout():
    """The documented package structure exists."""
    import fugue_tpu.core.distributions
    import fugue_tpu.core.model
    import fugue_tpu.core.transforms
    import fugue_tpu.runtime.staging
    import fugue_tpu.runtime.checkpoint
    import fugue_tpu.inference.mh
    import fugue_tpu.inference.hmc
    import fugue_tpu.inference.nuts
    import fugue_tpu.inference.smc
    import fugue_tpu.inference.vi
    import fugue_tpu.inference.abc
    import fugue_tpu.inference.gibbs
    import fugue_tpu.inference.diagnostics
    import fugue_tpu.inference.mcmc_utils
    import fugue_tpu.inference.validation
    import fugue_tpu.parallel.mesh
    import fugue_tpu.parallel.sharded
    import fugue_tpu.ops.resampling
    import fugue_tpu.dsl.compiler
    import fugue_tpu.dsl.sessions


def test_error_taxonomy_codes_stable():
    """Error codes carry the reference's stable numbering."""
    assert int(ft.ErrorCode.INVALID_MEAN) == 100
    assert int(ft.ErrorCode.ADDRESS_CONFLICT) == 301
    assert int(ft.ErrorCode.UNEXPECTED_MODEL_STRUCTURE) == 302
    assert int(ft.ErrorCode.TRACE_ADDRESS_NOT_FOUND) == 500
    assert int(ft.ErrorCode.TYPE_MISMATCH) == 600
    assert ft.ErrorCategory.of(ft.ErrorCode.INVALID_RATE) is ft.ErrorCategory.VALIDATION
    assert ft.ErrorCategory.of(ft.ErrorCode.TYPE_MISMATCH) is ft.ErrorCategory.TYPE


def test_version():
    assert isinstance(ft.__version__, str)
