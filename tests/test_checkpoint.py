"""Checkpoint/resume round trips (SURVEY.md §5 aux subsystem)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fugue_tpu as ft
from fugue_tpu.runtime.checkpoint import load_checkpoint, save_checkpoint
from fugue_tpu.inference.mh import init_mh_state


def test_pytree_roundtrip(tmp_path):
    state = {
        "positions": jnp.arange(12.0).reshape(3, 4),
        "key": jax.random.PRNGKey(7),
        "nested": {"scale": jnp.array(0.5), "t": jnp.array(3)},
    }
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, state)
    restored = load_checkpoint(path, state)
    for (ka, a), (kb, b) in zip(
        jax.tree_util.tree_flatten_with_path(state)[0],
        jax.tree_util.tree_flatten_with_path(restored)[0],
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_sampler_state_roundtrip(tmp_path):
    """Persist and restore full MH sampler state mid-run; resumed chain
    continues deterministically."""
    def model():
        mu = ft.sample("mu", ft.Normal(0.0, 2.0))
        ft.observe("y", ft.Normal(mu, 1.0), jnp.array([1.0, 1.2]))
        return mu

    staged = ft.stage(model)
    state = jax.vmap(lambda k: init_mh_state(staged, k))(
        jax.random.split(jax.random.PRNGKey(0), 4)
    )
    path = str(tmp_path / "mh.npz")
    save_checkpoint(path, state)
    restored = load_checkpoint(path, state)
    np.testing.assert_array_equal(
        np.asarray(state.log_joint), np.asarray(restored.log_joint)
    )
    # continue both one step with same key → identical
    from fugue_tpu.inference.mh import mh_step

    step = jax.vmap(lambda st, k: mh_step(staged, st, k, True))
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    s1, _ = step(state, keys)
    s2, _ = step(restored, keys)
    np.testing.assert_array_equal(
        np.asarray(s1.latents["mu"]), np.asarray(s2.latents["mu"])
    )


def test_missing_leaf_raises(tmp_path):
    path = str(tmp_path / "x.npz")
    save_checkpoint(path, {"a": jnp.ones(3)})
    with pytest.raises(KeyError):
        load_checkpoint(path, {"a": jnp.ones(3), "b": jnp.zeros(2)})


def test_atomic_overwrite(tmp_path):
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, {"v": jnp.array(1.0)})
    save_checkpoint(path, {"v": jnp.array(2.0)})
    out = load_checkpoint(path, {"v": jnp.array(0.0)})
    assert float(out["v"]) == 2.0
    assert not os.path.exists(path + ".tmp")


# ---------------------------------------------------------------------------
# Sharded (orbax) checkpoints — multi-host path, tested on the 8-device
# CPU mesh (SURVEY.md §5 "Checkpoint/resume")
# ---------------------------------------------------------------------------


def _sharded_state():
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()).reshape(8), ("chains",))
    sharding = NamedSharding(mesh, P("chains"))
    positions = jax.device_put(jnp.arange(64.0).reshape(8, 8), sharding)
    return {
        "positions": positions,
        "key": jax.random.PRNGKey(3),
        "step": jnp.array(17),
    }, sharding


def test_sharded_roundtrip_preserves_values_and_sharding(tmp_path):
    from fugue_tpu.runtime.checkpoint import (
        load_checkpoint_sharded,
        save_checkpoint_sharded,
    )

    state, sharding = _sharded_state()
    path = os.path.join(str(tmp_path), "ckpt")
    save_checkpoint_sharded(path, state)
    restored = load_checkpoint_sharded(path, state)
    np.testing.assert_array_equal(
        np.asarray(restored["positions"]), np.asarray(state["positions"])
    )
    np.testing.assert_array_equal(np.asarray(restored["key"]), np.asarray(state["key"]))
    assert int(restored["step"]) == 17
    # the restored array is placed with the template's sharding
    assert restored["positions"].sharding.is_equivalent_to(sharding, 2)


def test_sharded_restore_onto_different_layout(tmp_path):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from fugue_tpu.runtime.checkpoint import (
        load_checkpoint_sharded,
        save_checkpoint_sharded,
    )

    state, _ = _sharded_state()
    path = os.path.join(str(tmp_path), "ckpt")
    save_checkpoint_sharded(path, state)

    # resume onto a DIFFERENT mesh layout (e.g. a new device count)
    mesh2 = Mesh(np.array(jax.devices()).reshape(4, 2), ("chains", "model"))
    s2 = NamedSharding(mesh2, P("model", "chains"))
    template = dict(state)
    template["positions"] = jax.device_put(jnp.zeros((8, 8)), s2)
    restored = load_checkpoint_sharded(path, template)
    np.testing.assert_array_equal(
        np.asarray(restored["positions"]), np.asarray(state["positions"])
    )
    assert restored["positions"].sharding.is_equivalent_to(s2, 2)
