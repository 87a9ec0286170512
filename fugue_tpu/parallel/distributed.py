"""Multi-host backend: process bootstrap + two-level (hosts x devices) meshes.

The reference has no distributed layer at all (single-threaded Rust,
Cargo.toml:48-52 — no MPI/NCCL); this module is the invented structure
SURVEY.md §5 "Distributed communication backend" calls for:

- ``initialize_distributed`` wraps ``jax.distributed.initialize`` with an
  env-var bootstrap (idempotent, no-op for single-process runs), so the same
  script runs unchanged on a laptop, one host, or several hosts.
- ``make_hybrid_mesh`` builds a two-level device mesh: ``dcn_axes``
  (across hosts, over the data-center network) OUTERMOST, ``ici_axes``
  (within a host, over NVLink between its GPUs) innermost, so collectives
  along the inner axes stay inside a host and only coarse reductions cross
  the network — the scaling-book layout rule.
- ``flat_axis_index`` linearizes a multi-axis shard index for deterministic
  per-shard RNG folding that is independent of how the chain batch is split
  across hosts and devices.

Multi-host runbook (docs/scaling.md, 'Multi-host runs'): every host runs the
SAME program;
set ``FUGUE_COORDINATOR_ADDRESS``, ``FUGUE_NUM_PROCESSES``,
``FUGUE_PROCESS_ID`` (or rely on the cluster auto-detection built into
``jax.distributed.initialize``), call ``initialize_distributed()`` first,
then build a hybrid mesh and pass it to the sharded drivers.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

_ENV_PREFIXES = ("FUGUE_", "JAX_")

# module-level idempotence guard (jax.distributed.initialize raises if
# called twice; a no-op second call is friendlier for notebook reruns)
_initialized = False


@dataclass(frozen=True)
class DistributedConfig:
    """Bootstrap parameters for ``jax.distributed.initialize``.

    ``None`` fields are omitted from the call so JAX's own cluster
    auto-detection (GKE/SLURM/Borg env conventions) still applies.
    """

    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    local_device_ids: Optional[Tuple[int, ...]] = None

    @property
    def is_multiprocess(self) -> bool:
        if self.num_processes is not None:
            return self.num_processes > 1
        return self.coordinator_address is not None


def _env_get(env: Mapping[str, str], name: str) -> Optional[str]:
    for prefix in _ENV_PREFIXES:
        v = env.get(prefix + name)
        if v is not None and v != "":
            return v
    return None


def config_from_env(env: Optional[Mapping[str, str]] = None) -> DistributedConfig:
    """Parse the bootstrap config from environment variables.

    Recognized (``FUGUE_`` wins over ``JAX_``): ``*_COORDINATOR_ADDRESS``,
    ``*_NUM_PROCESSES``, ``*_PROCESS_ID``, ``*_LOCAL_DEVICE_IDS`` (comma
    separated). Absent vars stay ``None`` (auto-detect).
    """
    if env is None:
        env = os.environ
    coord = _env_get(env, "COORDINATOR_ADDRESS")
    nproc = _env_get(env, "NUM_PROCESSES")
    pid = _env_get(env, "PROCESS_ID")
    local = _env_get(env, "LOCAL_DEVICE_IDS")
    return DistributedConfig(
        coordinator_address=coord,
        num_processes=int(nproc) if nproc is not None else None,
        process_id=int(pid) if pid is not None else None,
        local_device_ids=(
            tuple(int(x) for x in local.split(",")) if local else None
        ),
    )


def initialize_distributed(
    config: Optional[DistributedConfig] = None,
    *,
    env: Optional[Mapping[str, str]] = None,
    _initialize_fn=None,
) -> bool:
    """Bootstrap the JAX distributed runtime from ``config`` (or env vars).

    Returns ``True`` if ``jax.distributed.initialize`` was called, ``False``
    for the single-process no-op. Idempotent: a second call is a no-op.
    ``_initialize_fn`` is a test seam (defaults to
    ``jax.distributed.initialize``).
    """
    global _initialized
    if _initialized:
        return False
    if config is None:
        config = config_from_env(env)
    if not config.is_multiprocess:
        return False  # single process: nothing to coordinate
    kwargs = {}
    if config.coordinator_address is not None:
        kwargs["coordinator_address"] = config.coordinator_address
    if config.num_processes is not None:
        kwargs["num_processes"] = config.num_processes
    if config.process_id is not None:
        kwargs["process_id"] = config.process_id
    if config.local_device_ids is not None:
        kwargs["local_device_ids"] = list(config.local_device_ids)
    fn = _initialize_fn if _initialize_fn is not None else (
        jax.distributed.initialize
    )
    fn(**kwargs)
    _initialized = True
    return True


# ---------------------------------------------------------------------------
# two-level (hosts x local devices) meshes
# ---------------------------------------------------------------------------


def make_hybrid_mesh(
    ici_axes: Dict[str, int],
    dcn_axes: Optional[Dict[str, int]] = None,
    *,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Two-level mesh: ``dcn_axes`` (outermost, host-spanning) × ``ici_axes``
    (innermost, within a host). Axis order in the mesh is
    ``(*dcn_axes, *ici_axes)`` so that sharding a batch over
    ``tuple(mesh.axis_names)`` keeps neighboring shards on one host and
    collectives over the inner axes never leave it.

    An axis size of ``-1`` (at most one per level) infers the size from the
    device count. With one process per host this uses
    ``mesh_utils.create_hybrid_device_mesh`` (process-aware placement); in a
    single process (including virtual CPU device farms) it falls back to a
    row-major reshape, which preserves the same logical layout for testing.
    """
    if dcn_axes is None:
        dcn_axes = {}
    if devices is None:
        devices = jax.devices()
    n = len(devices)

    names = tuple(dcn_axes) + tuple(ici_axes)
    sizes = list(dcn_axes.values()) + list(ici_axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1 (inferred)")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1])) if len(sizes) > 1 else 1
        if n % known:
            raise ValueError(
                f"cannot infer axis: {n} devices not divisible by {known}"
            )
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} needs {int(np.prod(sizes))} "
            f"devices, have {n}"
        )

    n_dcn = len(dcn_axes)
    dcn_shape = sizes[:n_dcn]
    ici_shape = sizes[n_dcn:]

    if jax.process_count() > 1 and n_dcn > 0:
        from jax.experimental import mesh_utils

        # one process per host-spanning granule (exercised for real by the
        # 2-process integration test, tests/test_distributed_multiprocess.py)
        n_dcn_total = int(np.prod(dcn_shape))
        if jax.process_count() == n_dcn_total:
            grid = mesh_utils.create_hybrid_device_mesh(
                mesh_shape=ici_shape or (1,),
                dcn_mesh_shape=dcn_shape,
                devices=devices,
                process_is_granule=True,
            )
            grid = grid.reshape(sizes)
        else:
            # irregular layout (dcn axes spanning several processes per
            # granule): sort by (process, id) so the host axis follows
            # process boundaries, then row-major reshape
            ordered = sorted(devices, key=lambda d: (d.process_index, d.id))
            grid = np.asarray(ordered).reshape(sizes)
    else:
        # single process (or no host level): row-major reshape keeps the
        # logical layout identical for virtual-device testing
        grid = np.asarray(devices).reshape(sizes)
    return Mesh(grid, names)


def make_pod_chain_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """The default multi-host layout for MCMC/SMC: one axis over hosts, one
    axis over each host's local devices; shard chain/particle batches over
    BOTH axes (``chain_axes=("hosts", "chains")``)."""
    if devices is None:
        devices = jax.devices()
    n_hosts = jax.process_count()
    if len(devices) % n_hosts:
        raise ValueError(
            f"{len(devices)} devices not divisible by {n_hosts} hosts"
        )
    return make_hybrid_mesh(
        ici_axes={"chains": len(devices) // n_hosts},
        dcn_axes={"hosts": n_hosts},
        devices=devices,
    )


def flat_axis_index(mesh: Mesh, axes: Sequence[str]):
    """Row-major linear shard index over ``axes`` (inside ``shard_map``).

    Used to fold per-shard RNG streams deterministically; the flat index —
    and hence the sampled chains — depends only on the logical mesh layout,
    not on which physical host runs the shard.
    """
    import jax.numpy as jnp

    idx = jnp.zeros((), jnp.int32)
    for ax in axes:
        idx = idx * mesh.shape[ax] + jax.lax.axis_index(ax)
    return idx
