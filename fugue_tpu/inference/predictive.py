"""Vectorized posterior/prior predictive sampling.

The reference produces predictive draws by replaying a posterior trace
through a hand-rewritten model (docs how-to around ReplayHandler,
interpreters.rs:408-427). Array-program version: one model definition, a
``PredictiveHandler`` that redraws ``observe`` sites, and ``jax.vmap`` over
the stacked posterior draws — every (chain, draw) replays in one compiled
program, no Python loop over samples.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import jax
import jax.numpy as jnp

from ..runtime.handler import run
from ..runtime.interpreters import PredictiveHandler


def predictive(
    key,
    model_fn: Callable,
    posterior: Optional[Dict[str, Any]] = None,
    *,
    model_args: tuple = (),
    batch_ndim: int = 2,
    return_sites: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """Draw predictive samples by replaying posterior draws through the model.

    Args:
      key: PRNG key.
      model_fn: the model function (same one used for inference).
      posterior: dict ``{address: array}`` of latent draws with ``batch_ndim``
        leading batch axes — e.g. ``result.samples`` from ``hmc_chain`` /
        ``nuts_chain`` (chains, draws, *event). ``None`` / ``{}`` gives the
        prior predictive.
      model_args: extra positional args for ``model_fn``.
      batch_ndim: number of leading batch axes on each posterior array
        (2 for (chains, draws), 1 for a flat draw axis, 0 for a single draw).
      return_sites: restrict the output to these addresses (default: all
        observed sites plus any latent sites not pinned by ``posterior``).

    Returns:
      dict ``{address: array}`` with the same leading batch axes as the
      posterior: fresh draws at every ``observe`` site, plus fresh draws at
      any latent site absent from ``posterior``.
    """
    posterior = dict(posterior or {})

    def one(values, k):
        _, tr = run(PredictiveHandler(k, values), model_fn, *model_args)
        out = {}
        for a, c in tr.choices.items():
            if return_sites is not None:
                if a in return_sites:
                    out[a] = c.value
            elif c.is_observed or a not in values:
                out[a] = c.value
        return out

    if batch_ndim == 0:
        return one(posterior, key)

    # flatten the batch axes, vmap once, restore the batch shape
    batch_shape = None
    flat = {}
    for a, v in posterior.items():
        v = jnp.asarray(v)
        bs = v.shape[:batch_ndim]
        if batch_shape is None:
            batch_shape = bs
        elif bs != batch_shape:
            raise ValueError(
                f"posterior batch shapes disagree: {a} has {bs}, "
                f"expected {batch_shape}"
            )
        flat[a] = v.reshape((-1,) + v.shape[batch_ndim:])
    if batch_shape is None:
        raise ValueError(
            "posterior is empty with batch_ndim > 0; pass batch_ndim=0 "
            "for a single prior-predictive draw or provide posterior draws"
        )
    n = 1
    for s in batch_shape:
        n *= s
    keys = jax.random.split(key, n)
    outs = jax.vmap(one)(flat, keys)
    return {
        a: v.reshape(batch_shape + v.shape[1:]) for a, v in outs.items()
    }


def posterior_predictive(key, model_fn, posterior, **kwargs):
    """Alias of :func:`predictive` with a required posterior."""
    return predictive(key, model_fn, posterior, **kwargs)
