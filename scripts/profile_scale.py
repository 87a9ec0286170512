"""Decompose the scale-tier roofline gap of the d=1024 logistic HMC row.

The ladder measures whatever kernel + roofline bench.py currently defines
(peaks from bench.PEAKS for the card it runs on). Each level adds one real
component of the production drive; every level is timed on the host clock
around work that ends in ``jax.block_until_ready``:

  L0  pure bf16 matmul pair (C,D)@(D,N) + (C,N)@(N,D)   — the roofline's
      numerator executed alone: how close ANY program can get
  L1  fused value_and_grad of the staged logistic potential (one batched
      grad eval of whatever kernel bench._logistic_setup currently uses —
      matmul_bf16x2_fastgrad since r5: split fwd + single-pass bf16 bwd)
      — adds the VJP structure, the extra forward pass, elementwise link
      terms
  L2  L1 inside a 16-step leapfrog lax.scan (the HMC inner loop) — adds
      integrator elementwise ops + loop structure
  L3  the full hmc_chain drive (warmup + sampling, adaptation ON) — adds
      momentum draws, MH accept, dual averaging, Welford, divergence flags

Per-level grad-eval rate / analytic roofline = cumulative efficiency; the
RATIO between consecutive levels attributes each loss term. The result is
printed as one JSON object.

Run on the GPU, one process for the card:  python scripts/profile_scale.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def main():
    import bench
    from fugue_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    t_all = time.perf_counter()
    staged, w_true, m, D, N, C = bench._logistic_setup()
    X, y = staged.data_leaves(0)  # X (>=1MiB) AND the small y vector
    dt = jnp.float32
    roof_rate = bench._logistic_roofline(C, N, D)  # grad-evals/s ceiling

    def timed(fn, args, reps=3):
        jax.block_until_ready(fn(*args))
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / reps

    results = {"analytic_roofline_grad_evals_per_sec": round(roof_rate, 1)}

    # L0: the bare matmul pair of one gradient (fwd logits + bwd X^T r),
    # chained K times so dispatch amortizes like the real drive
    K0 = 128
    Xb = X.astype(jnp.bfloat16)

    @jax.jit
    def l0(W):
        def body(Wc, _):
            logits = jnp.matmul(Wc.astype(jnp.bfloat16), Xb.T,
                                preferred_element_type=jnp.float32)
            r = jax.nn.sigmoid(logits) - y.astype(dt)[None, :]
            g = jnp.matmul(r.astype(jnp.bfloat16), Xb,
                           preferred_element_type=jnp.float32)
            return Wc - 1e-6 * g, ()
        Wf, _ = jax.lax.scan(body, W, None, length=K0)
        return jnp.sum(Wf)

    W0 = jnp.zeros((C, D), dt)
    t = timed(l0, (W0,))
    results["L0_bare_matmul_pair"] = {
        "grad_evals_per_sec": round(C * K0 / t, 1),
        "pct_of_roofline": round(100 * (C * K0 / t) / roof_rate, 1),
        "what_it_adds": "fwd+bwd bf16 matmuls + sigmoid residual only",
    }

    # L1: the production fused value_and_grad of the staged potential, with
    # the data as TRACED arguments via bind_data, as the drives pass it
    @jax.jit
    def l1(W, *dl):
        with staged.bind_data(dl, 0):
            vg = jax.vmap(jax.value_and_grad(
                lambda z: staged.potential(z, None)))

            def body(Wc, _):
                u, g = vg(Wc)
                return Wc - 1e-6 * g, ()

            Wf, _ = jax.lax.scan(body, W, None, length=K0)
            return jnp.sum(Wf)

    t = timed(l1, (W0, X, y))
    results["L1_staged_value_and_grad"] = {
        "grad_evals_per_sec": round(C * K0 / t, 1),
        "pct_of_roofline": round(100 * (C * K0 / t) / roof_rate, 1),
        "what_it_adds": "the production kernel's extra matmul pass "
                        "(split-precision fwd), prior terms, log1p_exp "
                        "link, VJP transpose structure",
    }

    # L2: 16-step leapfrog scan (the HMC inner loop, no MH/adaptation),
    # vmapped over chains exactly as the drive builds it (hmc.py:338)
    from fugue_tpu.inference.hmc import leapfrog

    L = 16
    im = jnp.ones((D,), dt)

    K2 = 8  # trajectories chained per call

    @jax.jit
    def l2(W, P, *dl):
        with staged.bind_data(dl, 0):
            grad_in = jax.grad(lambda z: staged.potential(z, None))

            def body(carry, _):
                Wc, Pc = carry
                Q_new, P_new = jax.vmap(
                    lambda q, p: leapfrog(grad_in, q, p,
                                          jnp.asarray(0.2, dt), L, im)
                )(Wc, Pc)
                return (Q_new, P_new), ()

            (Wf, Pf), _ = jax.lax.scan(body, (W, P), None, length=K2)
            return jnp.sum(Wf) + jnp.sum(Pf)

    P0 = jnp.zeros((C, D), dt)
    t = timed(l2, (W0, P0, X, y))
    results["L2_leapfrog_scan"] = {
        "grad_evals_per_sec": round(C * K2 * (L + 1) / t, 1),
        "pct_of_roofline": round(
            100 * (C * K2 * (L + 1) / t) / roof_rate, 1),
        "what_it_adds": "integrator elementwise updates + scan structure",
    }

    # L3: the full production drive (hmc_chain row configuration)
    from fugue_tpu.inference.hmc import HMCConfig, hmc_chain

    NW, NS = 300, 128
    cfg = HMCConfig(n_leapfrog=L, target_accept=0.8)

    def l3(i):
        r = hmc_chain(jax.random.fold_in(jax.random.PRNGKey(21), i),
                      n_samples=NS, n_warmup=NW, n_chains=C,
                      config=cfg, staged=staged,
                      init_position=m.z, init_jitter=0.05)
        return r.samples["w"]

    jax.block_until_ready(l3(0))
    t0 = time.perf_counter()
    jax.block_until_ready(l3(1))
    t = time.perf_counter() - t0
    n_grad = (NW + NS) * (L + 1)
    results["L3_full_hmc_drive"] = {
        "grad_evals_per_sec": round(C * n_grad / t, 1),
        "pct_of_roofline": round(100 * (C * n_grad / t) / roof_rate, 1),
        "what_it_adds": "momentum draws, MH accept, dual averaging, "
                        "Welford mass, divergence flags, sample recording",
    }

    # attribution: each consecutive ratio is one loss term
    keys = ["L0_bare_matmul_pair", "L1_staged_value_and_grad",
            "L2_leapfrog_scan", "L3_full_hmc_drive"]
    rates = [results[k]["grad_evals_per_sec"] for k in keys]
    results["attribution"] = {
        "matmul_shape_efficiency_vs_roofline": round(
            100 * rates[0] / roof_rate, 1),
        "vjp_and_split_precision_cost_pct": round(
            100 * (1 - rates[1] / rates[0]), 1),
        "integrator_cost_pct": round(100 * (1 - rates[2] / rates[1]), 1),
        "drive_overhead_cost_pct": round(100 * (1 - rates[3] / rates[2]), 1),
        "note": "each pct is the throughput lost ADDING that layer; the "
                "chain multiplies to L3/roofline",
    }

    print(json.dumps({
        **bench.device_info(),
        "config": {"D": D, "N": N, "C": C, "L": L},
        "wall_s": round(time.perf_counter() - t_all, 1),
        "results": results,
    }))


if __name__ == "__main__":
    main()
