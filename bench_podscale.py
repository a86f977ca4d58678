"""Large-bank measurements on one GPU (BASELINE.json config 5: "10k+
HMMs, long sequences").

Two tables, printed as JSON lines:

1. Single-chip VBHEM full-EM throughput over Kb in {8192, 16384, 32768}
   — the per-device shard sizes a large bank decomposes into under
   the 'base'-axis sharding of `parallel/spmd.py`.
2. Long-T forward-backward: XLA sequential scan vs log-depth
   associative scan (`ops/fb.py:forward_backward_assoc`) vs the Pallas
   kernel across T in {128, 512, 1024, 4096, 16384}.

Usage:  python bench_podscale.py
"""
import json
import time

import jax
import jax.numpy as jnp
import numpy as np


def timeit(fn, *args, reps=5):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def em_table():
    from bench import make_problem
    from vbhem_tpu.models import vbhem

    kr, tau = 8, 10
    rows = []
    for kb in (8192, 16384, 32768):
        n_iters = 200
        base, post, hyps, cfg = make_problem(jax.random.key(0), kb=kb,
                                             kr=kr)
        tilde_n = (cfg.nv * kb) * base.omega

        def em_iter(post, _):
            exps = vbhem.reduced_expectations(post)
            pair = vbhem.e_step(base, post, exps, tau)
            hat_z, z_ni, nj = vbhem.soft_assignments(
                tilde_n, exps.log_omega, pair.ll_elbo)
            ll = vbhem.elbo(post, exps, pair, hat_z, z_ni, nj, hyps)
            stats = vbhem.aggregate_stats(base, pair, z_ni, nj)
            return vbhem.m_step(stats, hyps), ll

        @jax.jit
        def run(post):
            return jax.lax.scan(em_iter, post, None, length=n_iters)

        dt = timeit(run, post, reps=3) / n_iters
        rows.append({"kb": kb, "dt_per_iter_ms": round(dt * 1e3, 3),
                     "pairs_per_sec": round(kb * kr / dt, 1)})
        print(json.dumps({"table": "em_scaling", **rows[-1]}), flush=True)
    return rows


def fb_table():
    from vbhem_tpu.ops.fb import forward_backward, forward_backward_assoc
    from vbhem_tpu.ops.fb_pallas import forward_backward_pallas

    k, n = 3, 128
    rng = np.random.default_rng(0)
    rows = []
    log_pz1 = jnp.asarray(np.log(rng.dirichlet(np.ones(k))), jnp.float32)
    log_trans = jnp.asarray(np.log(rng.dirichlet(np.ones(k), size=k)),
                            jnp.float32)
    for t_max in (128, 512, 1024, 4096, 16384):
        log_rho = jnp.asarray(rng.normal(size=(n, t_max, k)) * 0.5,
                              jnp.float32)
        mask = jnp.ones((n, t_max), bool)
        args = (log_pz1, log_trans, log_rho, mask)
        row = {"t": t_max}
        row["scan_ms"] = round(
            timeit(jax.jit(forward_backward), *args) * 1e3, 3)
        row["assoc_ms"] = round(
            timeit(jax.jit(forward_backward_assoc), *args) * 1e3, 3)
        row["pallas_ms"] = round(
            timeit(jax.jit(forward_backward_pallas), *args) * 1e3, 3)
        rows.append(row)
        print(json.dumps({"table": "fb_long_t", **row}), flush=True)
    return rows


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench_podscale: needs a GPU; JAX found "
                         f"{dev.platform}")
    print(f"# device={dev.platform} kind={dev.device_kind}", flush=True)
    em_table()
    fb_table()


if __name__ == "__main__":
    main()
