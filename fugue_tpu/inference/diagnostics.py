"""Convergence diagnostics over batched sample arrays.

Capability parity with the reference diagnostics module (reference:
src/inference/diagnostics.rs — typed value extractors :76-98, Diagnostics
trait :104-207, split-R-hat :218-259, parameter summaries :322-391,
``print_diagnostics`` with convergence verdicts at 1.01/1.1 thresholds
:394-456).

Array-program form: samples live as (n_chains, n_samples[, ...site shape])
arrays per site — diagnostics are batched jit-compiled ops over those arrays
(the north-star requirement), not loops over Vec<Trace>.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence

import numpy as np

from .mcmc_utils import ess, ess_multichain, r_hat, split_r_hat

# verdict thresholds (reference: diagnostics.rs:444-448)
RHAT_EXCELLENT = 1.01
RHAT_GOOD = 1.1

DEFAULT_QUANTILES = (0.025, 0.25, 0.5, 0.75, 0.975)


@dataclass
class ParameterSummary:
    """Per-parameter summary (reference: diagnostics.rs:322-328)."""

    name: str
    mean: float
    sd: float
    quantiles: Dict[float, float]
    r_hat: float
    ess: float
    n_chains: int
    n_samples: int

    @property
    def converged(self) -> bool:
        return self.r_hat < RHAT_GOOD

    @property
    def verdict(self) -> str:
        if self.r_hat < RHAT_EXCELLENT:
            return "excellent"
        if self.r_hat < RHAT_GOOD:
            return "good"
        return "poor"


def _flatten_site(x) -> np.ndarray:
    """(m, n, *shape) → (m*prod(shape) pseudo-params handled upstream); here
    scalar sites only: (m, n)."""
    return np.asarray(x)


def summarize_samples(
    samples: Dict[str, Any],
    quantiles: Sequence[float] = DEFAULT_QUANTILES,
) -> List[ParameterSummary]:
    """Summaries for each scalar component of each site.

    ``samples``: address → (n_chains, n_samples, *site_shape) array. Array
    sites are expanded into indexed pseudo-parameters ``addr[i]`` the way the
    reference's extractors flatten per-address scalars.
    """
    out: List[ParameterSummary] = []
    for name in sorted(samples.keys()):
        arr = np.asarray(samples[name], dtype=np.float64)
        if arr.ndim < 2:
            raise ValueError(
                f"site {name!r}: expected (n_chains, n_samples, ...) array"
            )
        m, n = arr.shape[0], arr.shape[1]
        flat = arr.reshape(m, n, -1)
        k = flat.shape[-1]
        # batched diagnostics over all components at once
        comp = np.moveaxis(flat, -1, 0)  # (k, m, n)
        rh = np.asarray(split_r_hat(comp))
        es = np.asarray(ess_multichain(comp))
        for j in range(k):
            xs = comp[j]
            qs = {q: float(np.quantile(xs, q)) for q in quantiles}
            pname = name if k == 1 else f"{name}[{j}]"
            out.append(
                ParameterSummary(
                    name=pname,
                    mean=float(xs.mean()),
                    sd=float(xs.std(ddof=1)),
                    quantiles=qs,
                    r_hat=float(rh[j]),
                    ess=float(es[j]),
                    n_chains=m,
                    n_samples=n,
                )
            )
    return out


def print_diagnostics(
    samples: Dict[str, Any],
    quantiles: Sequence[float] = DEFAULT_QUANTILES,
    file=None,
) -> List[ParameterSummary]:
    """Formatted diagnostics table + convergence verdict.

    Reference: diagnostics.rs:394-456.
    """
    summaries = summarize_samples(samples, quantiles)
    header = (
        f"{'parameter':<20} {'mean':>10} {'sd':>10} "
        + " ".join(f"q{int(q*100):>02}" .rjust(9) for q in quantiles)
        + f" {'R-hat':>8} {'ESS':>9}"
    )
    lines = [header, "-" * len(header)]
    worst = 0.0
    for s in summaries:
        worst = max(worst, s.r_hat)
        lines.append(
            f"{s.name:<20} {s.mean:>10.4f} {s.sd:>10.4f} "
            + " ".join(f"{s.quantiles[q]:>9.4f}" for q in quantiles)
            + f" {s.r_hat:>8.4f} {s.ess:>9.1f}"
        )
    if worst < RHAT_EXCELLENT:
        verdict = f"convergence: EXCELLENT (max R-hat {worst:.4f} < {RHAT_EXCELLENT})"
    elif worst < RHAT_GOOD:
        verdict = f"convergence: GOOD (max R-hat {worst:.4f} < {RHAT_GOOD})"
    else:
        verdict = f"convergence: POOR (max R-hat {worst:.4f} >= {RHAT_GOOD})"
    lines.append(verdict)
    print("\n".join(lines), file=file)
    return summaries


# ---------------------------------------------------------------------------
# Trace-list extractors (reference: diagnostics.rs:76-98) — compatibility
# layer for code that works with handler-produced traces rather than staged
# sample arrays.
# ---------------------------------------------------------------------------


def extract_real(traces: Sequence, address: str) -> np.ndarray:
    """Pull the f64 values at ``address`` out of a sequence of traces."""
    vals = []
    for t in traces:
        v = t.get_real(address)
        if v is not None:
            vals.append(float(np.asarray(v)))
    return np.asarray(vals)


def extract_bool(traces: Sequence, address: str) -> np.ndarray:
    vals = []
    for t in traces:
        v = t.get_bool(address)
        if v is not None:
            vals.append(bool(np.asarray(v)))
    return np.asarray(vals)


def extract_int(traces: Sequence, address: str) -> np.ndarray:
    vals = []
    for t in traces:
        v = t.get_int(address)
        if v is not None:
            vals.append(int(np.asarray(v)))
    return np.asarray(vals)
