"""Device-mesh construction + sharding helpers.

The single backend module the engines use for multi-chip scale-out
(SURVEY.md §5 "Distributed communication backend"): mesh construction over
the devices of one or several hosts, named-axis shardings for chain/particle batches, and the small
collective vocabulary (pmean for cross-chain adaptation consensus, psum for
ESS/log-evidence/likelihood reductions, all_gather/permutation for SMC
resampling). The reference has no distributed layer at all (Cargo.toml:48-52
— no MPI/NCCL); this module is the invented device-mesh structure.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CHAIN_AXIS = "chains"
DATA_AXIS = "data"


def make_chain_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh with every device along the chain axis — the default layout
    for MCMC/SMC batches (DP over chains)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (CHAIN_AXIS,))


def make_chain_data_mesh(
    chain_devices: int, data_devices: int, devices=None
) -> Mesh:
    """2-D mesh: chains × data. Chains shard the DP batch axis; the data
    axis shards large observation plates whose log-likelihood partial sums
    reduce with psum — the PPL analog of sequence/context parallelism
    (SURVEY.md §2.3)."""
    if devices is None:
        devices = jax.devices()
    need = chain_devices * data_devices
    if len(devices) < need:
        raise ValueError(
            f"need {need} devices for a {chain_devices}x{data_devices} mesh, "
            f"have {len(devices)}"
        )
    grid = np.asarray(devices[:need]).reshape(chain_devices, data_devices)
    return Mesh(grid, (CHAIN_AXIS, DATA_AXIS))


def chain_sharding(mesh: Mesh, ndim: int = 1) -> NamedSharding:
    """Shard the leading (chain/particle) axis; replicate the rest."""
    spec = P(CHAIN_AXIS, *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
