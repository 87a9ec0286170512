"""Tensor-core linear-algebra helpers for model code.

Large-d GLM likelihoods are matmuls; the GPU's tensor cores run them fastest
with bfloat16 inputs and f32 accumulation (989 TFLOP/s dense bf16 on an H100
SXM against 67 TFLOP/s of plain f32, NVIDIA data sheet). These
helpers are the supported way to write the design-matrix product inside a
model so the staged potential keeps one clean matmul island:

    logits = matmul_bf16(X, w)          # (N,) — inside a model function
    ft.observe("y", ft.BernoulliLogits(logits), y)

No reference counterpart (the reference is scalar Rust, SURVEY.md §2.3
"Tensor parallel: no tensors"); this is the accelerator realization of its
"hot loops in the fast language" discipline.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def matmul_bf16(a, b):
    """``a @ b`` with bf16 inputs and f32 accumulation — one bf16 pass.

    Relative error per output element is ~bf16 eps (7.8e-3) on the INPUTS
    only; the contraction itself accumulates in f32, so the result does not
    degrade with the contraction length. Appropriate for GLM
    linear predictors (the likelihood is smooth in the logits); use plain
    f32 ``@`` when the workload gates on closed-form moment recovery
    tighter than ~1e-2 relative.
    """
    return jnp.matmul(
        a.astype(jnp.bfloat16),
        b.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )


def matvec_bf16(a, x):
    """``a @ x`` for a matrix and vector (vmap-friendly alias)."""
    return matmul_bf16(a, x)


def _split_bf16(w):
    """w (f32) → (hi, lo) bf16 pair with hi + lo ≈ w to ~16 mantissa bits."""
    hi = w.astype(jnp.bfloat16)
    lo = (w - hi.astype(jnp.float32)).astype(jnp.bfloat16)
    return hi, lo


@jax.custom_vjp
def matmul_bf16x2(a, w):
    """``a @ w`` with bf16 DATA and split-bf16 (pseudo-f32) PARAMETERS.

    Why: a plain bf16 cast of the parameter vector makes the staged
    potential a deterministically ROUGH function of position — O(1)
    log-density wiggles at the bf16 ULP scale of ``w`` — which collapses
    HMC dual averaging toward useless step sizes (measured on the
    d=1024/N=1e5 logistic row: eps 0.008 → 0.0004, R-hat 54). Splitting
    w = hi + lo into two bf16 passes keeps both matmuls on the tensor cores
    while
    restoring ~16 mantissa bits of parameter precision, so the wiggle
    amplitude drops ~2^-8 below the thermal scale. Costs 2x the matmul
    work of ``matmul_bf16``; the honest roofline halves accordingly.

    The VJP is defined explicitly with the SAME split trick on the
    cotangent (autodiff through the hi/lo decomposition would bf16-round
    the tangents — exactly the noise this op exists to remove).
    """
    hi, lo = _split_bf16(w.astype(jnp.float32))
    ab = a.astype(jnp.bfloat16)
    return (jnp.matmul(ab, hi, preferred_element_type=jnp.float32)
            + jnp.matmul(ab, lo, preferred_element_type=jnp.float32))


def _mm_fwd(a, w):
    return matmul_bf16x2(a, w), (a, w)


def _mm_bwd(res, g):
    a, w = res
    ab = a.astype(jnp.bfloat16)
    g_hi, g_lo = _split_bf16(g.astype(jnp.float32))

    def t(x, y):  # aᵀ-contraction over the shared N axis, f32 accumulate
        return jnp.tensordot(x, y, axes=((0,), (0,)),
                             preferred_element_type=jnp.float32)

    # grad wrt w: aᵀ @ g with split-precision cotangent (shape-generic for
    # vector or matrix w)
    gw = t(ab, g_hi) + t(ab, g_lo)
    # grad wrt a: g ⊗ w / g @ wᵀ — data is usually a constant/argument, so
    # this path is rarely materialized
    if w.ndim == 1:
        ga = g[..., :, None] * w[None, :]
    else:
        ga = jnp.matmul(g, w.T)
    return ga.astype(a.dtype), gw.astype(w.dtype)


matmul_bf16x2.defvjp(_mm_fwd, _mm_bwd)


@jax.custom_vjp
def matmul_bf16x2_fastgrad(a, w):
    """Same split-precision FORWARD as ``matmul_bf16x2`` (smooth potential
    — the property HMC dual averaging needs), but a single-pass bf16
    BACKWARD: the cotangent is bf16-rounded once instead of hi/lo split.

    Why this is sound for MCMC: the backward feeds the leapfrog FORCE only
    — an approximate-force trajectory is still a valid MH proposal because
    acceptance uses the exact (split-precision) potential at the endpoints;
    force error only costs a little acceptance, never bias. For a GLM
    residual cotangent (elements O(1)), bf16 rounding is ~4e-3 relative
    per element and the f32-accumulated contraction over N rows averages
    it to ~4e-3/sqrt(N) on the gradient (~1e-5 at N=1e4) — far below the
    thermal force scale. Cost: 3 bf16 matmul passes per value+grad instead
    of 4 (on the GPU the gain is not measured yet; scripts/profile_scale.py
    is the ladder that measures it).

    Use ``matmul_bf16x2`` when the gradient itself is the deliverable
    (MAP/Laplace curvature, VI pathwise gradients at convergence)."""
    return matmul_bf16x2(a, w)


def _mmf_fwd(a, w):
    return matmul_bf16x2(a, w), (a, w)


def _mmf_bwd(res, g):
    a, w = res
    ab = a.astype(jnp.bfloat16)
    gw = jnp.tensordot(ab, g.astype(jnp.bfloat16), axes=((0,), (0,)),
                       preferred_element_type=jnp.float32)
    if w.ndim == 1:
        ga = g[..., :, None] * w[None, :]
    else:
        ga = jnp.matmul(g, w.T)
    return ga.astype(a.dtype), gw.astype(w.dtype)


matmul_bf16x2_fastgrad.defvjp(_mmf_fwd, _mmf_bwd)
