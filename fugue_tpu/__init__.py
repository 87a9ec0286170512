"""fugue-tpu: a probabilistic-programming inference engine on JAX/XLA.

A brand-new JAX/XLA implementation of the capabilities of the
``fugue`` PPL (monadic model DSL over 17 typed distributions, trace-based
replay/scoring runtime, adaptive MH / HMC / NUTS / tempered SMC / mean-field
VI / ABC, convergence diagnostics, conjugate validation harnesses) —
re-architected around staged array programs: models compile once into pure
log-density + sampler functions, inference kernels run jit-compiled with
chains/particles vectorized on-chip and sharded across device meshes.

The public API is re-exported flat here, mirroring the reference crate root
(reference: src/lib.rs:16-59).
"""

__version__ = "0.1.0"

# L0: errors
from .errors import (
    ErrorCategory,
    ErrorCode,
    ErrorContext,
    FugueError,
    ModelStructureError,
    StagingError,
    TraceAccessError,
    TypeMismatchError,
    ValidationError,
)

# L1: core — addresses, numerics, distributions, model language
from .core.address import Address, addr, scoped_addr
from .core.numerics import (
    log1p_exp,
    log_gamma,
    log_sum_exp,
    normalize_log_probs,
    safe_log,
    weighted_log_sum_exp,
)
from .core.distributions import (
    ALL_DISTRIBUTIONS,
    Bernoulli,
    BernoulliLogits,
    Beta,
    Binomial,
    Categorical,
    Cauchy,
    ChiSquared,
    Dirichlet,
    MultivariateNormal,
    DiscreteUniform,
    Distribution,
    EXTRA_DISTRIBUTIONS,
    Exponential,
    Gamma,
    Geometric,
    HalfCauchy,
    HalfNormal,
    InverseGamma,
    NegativeBinomial,
    Laplace,
    LogNormal,
    Normal,
    Poisson,
    StudentT,
    Support,
    Uniform,
    Weibull,
)
from .core.model import (
    Model,
    cond,
    factor,
    guard,
    masked,
    observe,
    plate,
    pure,
    sample,
    sequence_vec,
    traverse_vec,
)
from .core.rng import address_seed, chain_keys, site_key
from .core import transforms

# L4: inference engines + diagnostics (lazy-loaded heavy modules are fine to
# import eagerly here: they only define functions)
from .inference.mh import MHResult, MHState, adaptive_mcmc_chain, mh_step
from .inference.mh_dynamic import DynamicMHResult, adaptive_mcmc_chain_dynamic
from .inference.hmc import (
    HMCConfig,
    HMCResult,
    HmcSession,
    hmc_chain,
    hmc_transition,
)
from .inference.nuts import (
    NUTSConfig,
    NUTSResult,
    NutsSession,
    nuts_chain,
    nuts_transition,
)
from .inference.smc import (
    SMCConfig,
    SMCResult,
    adaptive_smc,
    importance_reweight,
)
from .inference.vi import (
    FullRankGuide,
    GuideError,
    MeanFieldGuide,
    VIConfig,
    VIResult,
    elbo,
    estimate_elbo,
    optimize_fullrank_vi,
    optimize_meanfield_vi,
)
from .inference.abc import (
    ABCError,
    ABCResult,
    ABCSMCConfig,
    SummaryStatsDistance,
    abc_rejection,
    abc_scalar_summary,
    abc_smc,
    abc_smc_weighted,
    euclidean_distance,
    manhattan_distance,
)
from .inference.gibbs import GibbsResult, gibbs_chain
from .inference.chees import ChEESConfig, ChEESResult, CheesSession, chees_chain
from .inference.ess import ESSConfig, ESSResult, ess_chain
from .inference.marginalize import MarginalizedModel, marginalize
from .inference.tempering import PTConfig, PTResult, geometric_ladder, pt_chain
from .inference.predictive import posterior_predictive, predictive
from .inference.model_comparison import (
    ELPDResult,
    compare,
    pointwise_log_likelihood,
    psis_loo,
    waic,
)
from .inference.map_laplace import (
    LaplaceResult,
    MAPConfig,
    MAPResult,
    laplace_approximation,
    map_estimate,
)
from .inference.diagnostics import (
    ParameterSummary,
    print_diagnostics,
    summarize_samples,
)
from .inference.mcmc_utils import (
    ess,
    ess_multichain,
    geweke,
    r_hat,
    rank_normalized_split_r_hat,
    split_r_hat,
)
from .inference.validation import (
    ConjugateBetaBernoulliConfig,
    ConjugateNormalConfig,
    ValidationResult,
    ks_two_sample,
    validate_beta_bernoulli,
    validate_conjugate_normal,
)
from .inference.sbc import SBCResult, sbc

# L3: runtime — handlers, interpreters, traces, staging
from .runtime.handler import Handler, run
from .runtime.interpreters import (
    PredictiveHandler,
    PriorHandler,
    ReconcileReport,
    ReconcilingScoreGivenTrace,
    ReplayHandler,
    SafeReplayHandler,
    SafeScoreGivenTrace,
    ScoreGivenTrace,
    StrictScoreGivenTrace,
    ValuesHandler,
    score_given_trace,
    score_given_trace_reconciled,
    score_given_trace_safe,
    score_given_trace_strict,
)
from .runtime.trace import Choice, Trace
from .runtime.staging import LogDensityParts, Site, StagedModel, stage
