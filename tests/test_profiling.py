"""utils/profiling.py: the runtime introspection helpers (SURVEY.md §5
"Tracing/profiling" — the reference's story is structural; these add the
device-side timing/cost tools every bench in the repo uses)."""

import jax
import jax.numpy as jnp

from fugue_tpu.utils.profiling import Timing, cost_summary, time_jit


def test_time_jit_separates_compile_from_steady_state():
    f = jax.jit(lambda x: jnp.sum(x * x))
    t = time_jit(f, jnp.arange(64.0), reps=5)
    assert isinstance(t, Timing)
    assert t.reps == 5
    assert t.compile_s > 0 and t.mean_s >= 0 and t.std_s >= 0
    # compile (trace+lower+build) dominates a trivial kernel's execution
    assert t.compile_s > t.mean_s
    assert "Timing(" in repr(t)


def test_cost_summary_reports_flops():
    def mm(a, b):
        return a @ b

    a = jnp.ones((32, 64))
    b = jnp.ones((64, 16))
    c = cost_summary(mm, a, b)
    assert isinstance(c, dict)
    # XLA's cost model counts the 2*M*N*K matmul flops on CPU & GPU alike
    if "flops" in c:
        assert c["flops"] >= 2 * 32 * 64 * 16


def test_device_trace_writes_profile(tmp_path):
    from fugue_tpu.utils.profiling import device_trace

    f = jax.jit(lambda x: x + 1.0)
    with device_trace(str(tmp_path)):
        jax.block_until_ready(f(jnp.ones(8)))
    # a trace directory with at least one event file appears
    produced = list(tmp_path.rglob("*"))
    assert produced, "profiler produced no output"
