"""Multi-host backend: env bootstrap + hosts x devices hybrid meshes.

The bootstrap path is unit-tested with faked env vars and a recorded
initialize function (no real coordinator needed); the hybrid-mesh sharded
drivers run on the virtual 8-device CPU mesh (SURVEY.md §4 item 8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fugue_tpu as ft
from fugue_tpu.parallel import distributed as dist
from fugue_tpu.parallel.distributed import (
    DistributedConfig,
    config_from_env,
    initialize_distributed,
    make_hybrid_mesh,
    make_pod_chain_mesh,
)
from fugue_tpu.parallel.sharded import sharded_hmc_chain


# ---------------------------------------------------------------------------
# env-var bootstrap
# ---------------------------------------------------------------------------


def test_config_from_env_fugue_vars():
    cfg = config_from_env(
        {
            "FUGUE_COORDINATOR_ADDRESS": "10.0.0.1:8476",
            "FUGUE_NUM_PROCESSES": "4",
            "FUGUE_PROCESS_ID": "2",
            "FUGUE_LOCAL_DEVICE_IDS": "0,1,2,3",
        }
    )
    assert cfg == DistributedConfig("10.0.0.1:8476", 4, 2, (0, 1, 2, 3))
    assert cfg.is_multiprocess


def test_config_from_env_jax_fallback_and_precedence():
    cfg = config_from_env(
        {
            "JAX_COORDINATOR_ADDRESS": "host:1234",
            "FUGUE_NUM_PROCESSES": "2",
            "JAX_NUM_PROCESSES": "8",  # FUGUE_ wins
            "JAX_PROCESS_ID": "1",
        }
    )
    assert cfg.coordinator_address == "host:1234"
    assert cfg.num_processes == 2
    assert cfg.process_id == 1
    assert cfg.local_device_ids is None


def test_config_from_env_empty_is_single_process():
    cfg = config_from_env({})
    assert cfg == DistributedConfig()
    assert not cfg.is_multiprocess


def test_initialize_noop_single_process(monkeypatch):
    monkeypatch.setattr(dist, "_initialized", False)
    calls = []
    assert (
        initialize_distributed(env={}, _initialize_fn=lambda **kw: calls.append(kw))
        is False
    )
    assert calls == []


def test_initialize_calls_jax_with_env_config(monkeypatch):
    monkeypatch.setattr(dist, "_initialized", False)
    calls = []
    ok = initialize_distributed(
        env={
            "FUGUE_COORDINATOR_ADDRESS": "c:1",
            "FUGUE_NUM_PROCESSES": "2",
            "FUGUE_PROCESS_ID": "0",
        },
        _initialize_fn=lambda **kw: calls.append(kw),
    )
    assert ok
    assert calls == [
        {"coordinator_address": "c:1", "num_processes": 2, "process_id": 0}
    ]
    # idempotent: second call is a no-op even with multiprocess env
    assert (
        initialize_distributed(
            env={"FUGUE_NUM_PROCESSES": "2"},
            _initialize_fn=lambda **kw: calls.append(kw),
        )
        is False
    )
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# hybrid mesh construction (single-process emulation path)
# ---------------------------------------------------------------------------


def test_make_hybrid_mesh_shapes():
    mesh = make_hybrid_mesh(ici_axes={"chains": 4}, dcn_axes={"hosts": 2})
    assert mesh.axis_names == ("hosts", "chains")  # hosts outermost
    assert mesh.devices.shape == (2, 4)


def test_make_hybrid_mesh_inferred_axis():
    mesh = make_hybrid_mesh(ici_axes={"chains": -1}, dcn_axes={"hosts": 2})
    assert mesh.devices.shape == (2, 4)
    with pytest.raises(ValueError):
        make_hybrid_mesh(ici_axes={"a": -1}, dcn_axes={"b": -1})
    with pytest.raises(ValueError):
        make_hybrid_mesh(ici_axes={"a": 3}, dcn_axes={"b": 2})  # 6 != 8


def test_make_pod_chain_mesh_single_process():
    mesh = make_pod_chain_mesh()
    assert mesh.axis_names == ("hosts", "chains")
    assert mesh.devices.shape == (1, 8)


# ---------------------------------------------------------------------------
# sharded drivers over the two-level mesh
# ---------------------------------------------------------------------------


def coin_model():
    obs = jnp.array([1] * 12 + [0] * 7, dtype=bool)
    p = ft.sample("p", ft.Beta(2.0, 3.0))
    ft.observe("obs", ft.Bernoulli(p), obs)
    return p


def test_sharded_hmc_over_hybrid_mesh():
    """Chains split over hosts×chains; adaptation collectives reduce over the
    axis tuple; the posterior still matches the conjugate closed form."""
    mesh = make_hybrid_mesh(ici_axes={"chains": 4}, dcn_axes={"hosts": 2})
    res = sharded_hmc_chain(
        jax.random.PRNGKey(0), coin_model, n_samples=500, n_warmup=400,
        n_chains=32, mesh=mesh, chain_axes=("hosts", "chains"),
    )
    ps = np.asarray(res.samples["p"])
    assert ps.shape == (32, 500)
    assert ps.mean() == pytest.approx(14 / 24, abs=0.015)
    assert np.isfinite(res.step_size) and res.step_size > 0


def test_flat_axis_index_is_row_major():
    from jax.sharding import PartitionSpec as P
    from fugue_tpu.parallel.sharded import _shard_map

    mesh = make_hybrid_mesh(ici_axes={"chains": 4}, dcn_axes={"hosts": 2})

    def f():
        return dist.flat_axis_index(mesh, ("hosts", "chains"))[None]

    idx = jax.jit(
        _shard_map(f, mesh, in_specs=(), out_specs=P(("hosts", "chains")))
    )()
    assert np.asarray(idx).tolist() == list(range(8))
