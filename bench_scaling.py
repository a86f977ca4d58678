"""Scaling measurement for the sharded VBHEM EM loop (BASELINE.json's
">=80% samples/s scaling efficiency from 1 host to N>=2 hosts" target).

What this measures is the cost the sharded program adds over the
unsharded one at the same total problem size — partition overhead +
the psum collectives — on a virtual N-device CPU mesh.  It says nothing
of device times: the virtual-mesh number bounds the overhead of the
SPMD program structure, not scaling on GPUs.

Reported: wall-clock of `n_iters` EM iterations (while_loop with
min_diff=0 so it never early-stops) at fixed TOTAL Kb, run (a) on one
device unsharded, (b) sharded over the 'base' axis of an n-device mesh.
Efficiency = t_unsharded / t_sharded (1.0 = sharding is free).

Usage:  JAX_PLATFORMS=cpu python bench_scaling.py [n_devices] [kb]
"""
import json
import sys
import time

n_dev = int(sys.argv[1]) if len(sys.argv) > 1 else 8
kb = int(sys.argv[2]) if len(sys.argv) > 2 else 2048

import os
os.environ.setdefault("VBHEM_TPU_NO_COMPILE_CACHE", "1")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={n_dev}").strip()

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")


def main():
    from bench import make_problem
    from vbhem_tpu.models import vbhem
    from vbhem_tpu.parallel import spmd

    kr, tau, n_iters = 8, 10, 30
    base, post, hyps, cfg = make_problem(jax.random.key(0), kb=kb, kr=kr)
    posts = jax.tree.map(lambda a: a[None], post)  # 1 trial lane

    def timed(fn, *args):
        out = fn(*args)             # compile + warmup
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            jax.block_until_ready(fn(*args))
        return (time.perf_counter() - t0) / reps

    # (a) unsharded single device: same while_loop, min_diff=0
    def unsharded(p):
        return vbhem.vbhem_em(base, p, hyps, nv=cfg.nv, tau=tau,
                              max_iter=n_iters, min_diff=0.0)

    t1 = timed(jax.jit(jax.vmap(unsharded)), posts)

    # (b) base axis sharded over n_dev devices; build the jitted
    # program ONCE so the timing measures execution, not re-tracing
    mesh = spmd.make_mesh(n_trial=1, n_base=n_dev)
    sharded = spmd.make_sharded_vbhem_em(mesh, kb, posts, cfg.nv, tau,
                                         max_iter=n_iters, min_diff=0.0)
    t_n = timed(lambda p: sharded(base, p, hyps), posts)

    eff = t1 / t_n
    print(json.dumps({
        "metric": "vbhem_sharded_em_overhead_efficiency",
        "kb": kb, "n_devices": n_dev, "iters": n_iters,
        "t_unsharded_s": round(t1, 4), "t_sharded_s": round(t_n, 4),
        "efficiency": round(eff, 4),
        "note": "virtual CPU mesh; same TOTAL work, so 1.0 = sharding "
                "adds no overhead",
    }))


if __name__ == "__main__":
    main()
