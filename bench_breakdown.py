"""Per-stage timing breakdown of one VBHEM EM iteration (diagnostic;
not the driver bench).  Stages are jitted and timed one at a time with
immediate flushed output, so partial results survive an interrupted
run.  Each stage is one dispatch, so sub-millisecond stages include the
launch cost; bench_roofline.py times them inside one scan instead."""
import time

import jax
import jax.numpy as jnp

from bench import make_problem
from vbhem_tpu.models import vbhem
from vbhem_tpu.ops.pair_estep import expected_pair_ll_variational


def timed(name, fn, reps=30):
    t0 = time.time()
    out = fn()
    jax.block_until_ready(out)
    compile_s = time.time() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    print(f"{name:28s} {dt * 1e3:8.3f} ms   (compile {compile_s:.1f}s)",
          flush=True)
    return out


def main(kb=512, kr=8, tau=10):
    print(f"Kb={kb} Kr={kr} tau={tau}", flush=True)
    base, post, hyps, cfg = make_problem(jax.random.key(0), kb=kb, kr=kr)
    tilde_n = (cfg.nv * kb) * base.omega

    exps = timed("reduced_expectations",
                 jax.jit(lambda: vbhem.reduced_expectations(post)))
    ell = timed("expected_pair_ll",
                jax.jit(lambda: expected_pair_ll_variational(
                    base.hmm.mean, base.hmm.cov, post.niw.m, post.niw.w,
                    post.niw.v, post.niw.beta, exps.log_lam)))
    pair = timed("pair_bwd_fwd (e_step)",
                 jax.jit(lambda: vbhem.e_step(base, post, exps, tau)))
    hz = timed("soft_assignments",
               jax.jit(lambda: vbhem.soft_assignments(
                   tilde_n, exps.log_omega, pair.ll_elbo)))
    hat_z, z_ni, nj = hz
    timed("elbo", jax.jit(lambda: vbhem.elbo(post, exps, pair, hat_z,
                                             z_ni, nj, hyps)))
    stats = timed("aggregate_stats",
                  jax.jit(lambda: vbhem.aggregate_stats(base, pair, z_ni,
                                                        nj)))
    timed("m_step", jax.jit(lambda: vbhem.m_step(stats, hyps)))


if __name__ == "__main__":
    main()
