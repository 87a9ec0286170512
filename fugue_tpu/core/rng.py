"""Deterministic counter-based key derivation.

The reference threads one sequential RNG through every engine ("seed = a
replayable recording", crates/fugue-wasm/src/lib.rs:12-14). The array-program
equivalent (SURVEY.md §2.3): counter-based ``jax.random`` keys split per
(chain, site, iteration), so results are reproducible AND independent of
sharding layout / execution order.
"""

from __future__ import annotations

import zlib

import jax


def address_seed(address: str) -> int:
    """Stable 31-bit hash of an address (process-independent, unlike
    Python's randomized ``hash``)."""
    return zlib.crc32(str(address).encode("utf-8")) & 0x7FFFFFFF


def site_key(key, address: str):
    """Per-site key: fold the address hash into the run key. Order- and
    layout-independent: the same (seed, address) always yields the same
    draw regardless of which chain/shard/iteration evaluates it."""
    return jax.random.fold_in(key, address_seed(address))


def iteration_key(key, iteration):
    return jax.random.fold_in(key, iteration)


def chain_keys(key, n_chains: int):
    """One independent key per chain."""
    return jax.random.split(key, n_chains)
