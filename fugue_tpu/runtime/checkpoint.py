"""Checkpoint / resume for long-running inference.

The reference has no serialization; its *mechanism* is the replayable trace +
incremental sessions holding all inter-transition state in a value
(SURVEY.md §5 "Checkpoint/resume": trace+replay architecture,
interpreters.rs:374-427; HmcSession hmc.rs:604-642; seeds documented as "a
replayable recording"). On multi-host meshes runs are long, so checkpointing is
first-class here: any sampler state — (PRNG key, position arrays, adaptation
state, samples so far) — is a pytree of arrays and round-trips through a
single ``.npz`` file keyed by tree paths. ``load_checkpoint`` takes a
template pytree (e.g. the freshly-initialized state) so structure never
depends on unpickling arbitrary objects.

``save_checkpoint_sharded`` / ``load_checkpoint_sharded`` cover the
multi-host case via orbax: each host writes only the shards of
mesh-sharded arrays it owns, and restore re-places shards onto the template's
``Sharding`` — the state never has to fit on (or move through) one host.
"""

from __future__ import annotations

import os
from typing import Any

import jax
import numpy as np


def _path_str(path) -> str:
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        elif hasattr(p, "name"):
            parts.append(str(p.name))
        else:
            parts.append(str(p))
    return "/".join(parts)


def save_checkpoint(path: str, state: Any) -> None:
    """Serialize a pytree of arrays to ``path`` (.npz)."""
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    arrays = {}
    for keypath, leaf in leaves:
        arrays[_path_str(keypath)] = np.asarray(leaf)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic: a crash never leaves a torn checkpoint


def load_checkpoint(path: str, template: Any) -> Any:
    """Restore a pytree saved by ``save_checkpoint``; ``template`` supplies
    the structure (and dtypes for 0-d python scalars)."""
    with np.load(path) as data:
        leaves_t = jax.tree_util.tree_flatten_with_path(template)
        paths = [_path_str(kp) for kp, _ in leaves_t[0]]
        missing = [p for p in paths if p not in data]
        if missing:
            raise KeyError(
                f"checkpoint {path!r} missing leaves {missing[:5]!r}"
                + ("..." if len(missing) > 5 else "")
            )
        new_leaves = [jax.numpy.asarray(data[p]) for p in paths]
    return jax.tree_util.tree_unflatten(leaves_t[1], new_leaves)


# ---------------------------------------------------------------------------
# Sharded (multi-host) checkpoints via orbax
# ---------------------------------------------------------------------------


def _abstract_like(template: Any) -> Any:
    """Template pytree → abstract arrays carrying shape/dtype/sharding, the
    form orbax needs to restore each shard onto the right devices without
    materializing the full array per host."""
    import jax.numpy as jnp

    def leaf(x):
        if isinstance(x, jax.Array):
            return jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=x.sharding)
        arr = jnp.asarray(x)
        return jax.ShapeDtypeStruct(arr.shape, arr.dtype)

    return jax.tree_util.tree_map(leaf, template)


def save_checkpoint_sharded(path: str, state: Any) -> None:
    """Checkpoint a pytree that may contain mesh-sharded ``jax.Array``s.

    Uses orbax's OCDBT/zarr format: on a multi-host mesh every process writes
    only its local shards (no gather), and the write is atomic (finalized
    directory rename). ``path`` is a directory, created if needed.
    """
    import orbax.checkpoint as ocp

    path = os.path.abspath(_path_abs(path))
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(path, state, force=True)


def load_checkpoint_sharded(path: str, template: Any) -> Any:
    """Restore a pytree saved by ``save_checkpoint_sharded``. ``template``
    supplies structure, dtypes and — for ``jax.Array`` leaves — the target
    ``Sharding``, so each host reads only the shards it will own."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(_path_abs(path))
    with ocp.StandardCheckpointer() as ckptr:
        return ckptr.restore(path, _abstract_like(template))


def _path_abs(path) -> str:
    return os.fspath(path)
