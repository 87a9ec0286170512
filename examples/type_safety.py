"""Type safety: natural dtypes end-to-end, typed trace getters, error taxonomy.

Reference: examples/type_safety.rs (natural return types vs f64-everything
PPLs; typed trace access; compile-time safety). The array-program recast keeps the same
guarantees at the dtype level: Bernoulli sites are bool arrays, count sites
are integer arrays, and the Trace exposes typed getters that raise
``TypeMismatchError``/``TraceAccessError`` with stable error codes instead of
silently casting.

Run: PYTHONPATH=. python examples/type_safety.py
"""

import jax
import jax.numpy as jnp

import fugue_tpu as ft


def decision_model():
    is_heads = ft.sample("coin", ft.Bernoulli(0.5))
    n_events = ft.sample("events", ft.Poisson(4.0))
    component = ft.sample("component", ft.Categorical(probs=jnp.array([0.5, 0.3, 0.2])))
    amount = ft.sample("amount", ft.Normal(0.0, 1.0))
    # Natural conditional logic on a boolean — no `== 1.0` comparisons.
    bonus = jnp.where(is_heads, 10.0, 0.0)
    return bonus + amount + n_events.astype(amount.dtype), component


def main():
    print("=== 1. Natural dtypes flow through a model ===")
    (result, trace) = ft.run(ft.PriorHandler(jax.random.PRNGKey(0)), decision_model)
    assert trace.get_choice("coin").value.dtype == jnp.bool_
    assert jnp.issubdtype(trace.get_choice("events").value.dtype, jnp.integer)
    print(f"result = {result}, sites = {list(trace.addresses())}")

    print("\n=== 2. Typed getters: Option-flavor returns None on mismatch ===")
    assert trace.get_bool("coin") is not None
    assert trace.get_real("coin") is None          # bool site, not real
    assert trace.get_int("events") is not None
    assert trace.get_real("missing") is None

    print("=== 3. Result-flavor raises typed errors with stable codes ===")
    try:
        trace.get_real_result("coin")
        raise AssertionError("should have raised")
    except ft.TypeMismatchError as e:
        assert e.code == ft.ErrorCode.TYPE_MISMATCH
        print(f"  TypeMismatch({e.code.value}): {e}")
    try:
        trace.get_real_result("missing")
        raise AssertionError("should have raised")
    except ft.TraceAccessError as e:
        assert e.code == ft.ErrorCode.TRACE_ADDRESS_NOT_FOUND
        print(f"  TraceAddressNotFound({e.code.value}): {e}")

    print("\n=== 4. Address collisions are structural errors, not silent ===")

    def colliding():
        ft.sample("x", ft.Normal(0.0, 1.0))
        ft.sample("x", ft.Normal(0.0, 1.0))  # duplicate address

    try:
        ft.run(ft.PriorHandler(jax.random.PRNGKey(0)), colliding)
        raise AssertionError("should have raised")
    except ft.ModelStructureError as e:
        assert e.code == ft.ErrorCode.ADDRESS_CONFLICT
        print(f"  AddressConflict({e.code.value}): {e}")

    print("\n=== 5. addr!-style escaping keeps indexed addresses injective ===")
    assert ft.addr("a#1") != ft.addr("a", 1)
    assert ft.addr("a", 1) == ft.addr("a", 1)
    print(f'  addr("a#1") = {ft.addr("a#1")!r} != addr("a",1) = {ft.addr("a", 1)!r}')

    print("\n=== 6. Error taxonomy mirrors the reference codes ===")
    for code in (ft.ErrorCode.INVALID_MEAN, ft.ErrorCode.INVALID_PROBABILITY,
                 ft.ErrorCode.ADDRESS_CONFLICT, ft.ErrorCode.TYPE_MISMATCH):
        print(f"  {code.name} = {code.value} ({ft.ErrorCategory.of(code).name})")
    print("OK")


if __name__ == "__main__":
    main()
