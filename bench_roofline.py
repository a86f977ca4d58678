"""Roofline / per-stage steady-state timing for the bench-shape VBHEM
EM iteration.

Unlike bench_breakdown.py (one dispatch per stage, so launch overhead
is part of every sub-ms stage), every timing here runs the stage
inside a `lax.scan` of ``n_iters`` steps in ONE dispatch, with a dummy
carry consuming the output so XLA cannot dead-code it.  That yields the
steady-state per-iteration cost of each stage including its HBM
traffic (but without cross-stage fusion, so the stage sum slightly
OVERestimates the fused full-EM iteration — the full iteration is also
timed for reference).

Also prints the pair E-step's analytic minimum traffic and operation
counts at the bench shape (no peak rates: those belong with the
benchmark, keyed by device kind).

Run alone on the card: another process on it skews the times.
"""
import time

import jax
import jax.numpy as jnp

from bench import make_problem
from vbhem_tpu.models import vbhem
from vbhem_tpu.ops.pair_estep import (expected_pair_ll_variational,
                                      pair_bwd_fwd)


def scan_timed(name, fn, out_probe, n_iters=500, reps=3):
    """Steady-state per-iteration time of `fn` under lax.scan.

    fn: () -> pytree; out_probe: pytree -> scalar (cheap reduction that
    keeps the computation alive in the scan carry)."""

    def step(carry, _):
        out = fn()
        return carry + out_probe(out) * 1e-30, None

    @jax.jit
    def run():
        c, _ = jax.lax.scan(step, jnp.float32(0.0), None, length=n_iters)
        return c

    out = jax.block_until_ready(run())     # compile + warmup
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(run())
    dt = (time.perf_counter() - t0) / reps / n_iters
    print(f"{name:34s} {dt * 1e6:9.1f} us/iter", flush=True)
    return dt


def main(kb=8192, kr=8, tau=10):
    print(f"Kb={kb} Kr={kr} tau={tau} device={jax.devices()[0].platform}",
          flush=True)
    base, post, hyps, cfg = make_problem(jax.random.key(0), kb=kb, kr=kr)
    tilde_n = (cfg.nv * kb) * base.omega
    sb = base.hmm.mean.shape[1]
    sr = post.eta.shape[-1]
    d = base.hmm.mean.shape[-1]

    # ---- full EM iteration (the bench metric itself) ----
    def em_iter(p):
        exps = vbhem.reduced_expectations(p)
        pair = vbhem.e_step(base, p, exps, tau)
        hat_z, z_ni, nj = vbhem.soft_assignments(tilde_n, exps.log_omega,
                                                 pair.ll_elbo)
        ll = vbhem.elbo(p, exps, pair, hat_z, z_ni, nj, hyps)
        stats = vbhem.aggregate_stats(base, pair, z_ni, nj)
        return vbhem.m_step(stats, hyps), ll

    def step_full(carry, _):
        p, acc = carry
        p2, ll = em_iter(p)
        return (p2, acc + ll * 1e-30), None

    @jax.jit
    def run_full():
        (p, acc), _ = jax.lax.scan(step_full, (post, jnp.float32(0.0)),
                                   None, length=500)
        return acc

    jax.block_until_ready(run_full())
    t0 = time.perf_counter()
    for _ in range(3):
        jax.block_until_ready(run_full())
    dt_full = (time.perf_counter() - t0) / 3 / 500
    print(f"{'FULL em_iter (chained)':34s} {dt_full * 1e6:9.1f} us/iter  "
          f"-> {kb * kr / dt_full / 1e6:.1f}M pairs/s", flush=True)

    # ---- stages (fixed inputs, steady state) ----
    exps = jax.jit(vbhem.reduced_expectations)(post)
    pair = jax.jit(lambda: vbhem.e_step(base, post, exps, tau))()
    hat_z, z_ni, nj = jax.jit(lambda: vbhem.soft_assignments(
        tilde_n, exps.log_omega, pair.ll_elbo))()
    stats = jax.jit(lambda: vbhem.aggregate_stats(base, pair, z_ni, nj))()
    jax.block_until_ready((exps, pair, hat_z, stats))

    psum = lambda t: sum(jnp.sum(x) for x in jax.tree.leaves(t))  # noqa: E731

    dts = {}
    dts["reduced_expectations"] = scan_timed(
        "reduced_expectations",
        lambda: vbhem.reduced_expectations(post), psum)
    dts["expected_pair_ll"] = scan_timed(
        "expected_pair_ll (ell)",
        lambda: expected_pair_ll_variational(
            base.hmm.mean, base.hmm.cov, post.niw.m, post.niw.w,
            post.niw.v, post.niw.beta, exps.log_lam), jnp.sum)
    dts["pair_e_step"] = scan_timed(
        "e_step total",
        lambda: vbhem.e_step(base, post, exps, tau), psum)
    dts["soft_assignments"] = scan_timed(
        "soft_assignments",
        lambda: vbhem.soft_assignments(tilde_n, exps.log_omega,
                                       pair.ll_elbo), psum)
    dts["elbo"] = scan_timed(
        "elbo",
        lambda: vbhem.elbo(post, exps, pair, hat_z, z_ni, nj, hyps),
        lambda x: x)
    dts["aggregate_stats"] = scan_timed(
        "aggregate_stats",
        lambda: vbhem.aggregate_stats(base, pair, z_ni, nj), psum)
    dts["m_step"] = scan_timed(
        "m_step", lambda: vbhem.m_step(stats, hyps), psum)
    stage_sum = sum(dts.values())
    print(f"{'stage sum (unfused bound)':34s} {stage_sum * 1e6:9.1f} "
          f"us/iter", flush=True)

    # ---- XLA-scan pair path for comparison ----
    ell = jax.jit(lambda: expected_pair_ll_variational(
        base.hmm.mean, base.hmm.cov, post.niw.m, post.niw.w,
        post.niw.v, post.niw.beta, exps.log_lam))()
    jax.block_until_ready(ell)
    scan_timed("pair_bwd_fwd (XLA scan path)",
               lambda: pair_bwd_fwd(base.hmm.prior, base.hmm.trans,
                                    exps.log_pi, exps.log_a, ell, tau),
               psum, n_iters=50)

    # ---- analytic roofline at this shape ----
    f32 = 4
    pair_n = kb * kr
    ell_bytes = pair_n * sb * sr * f32
    base_bytes = kb * (sb + sb * sb + sb * d + sb * d * d) * f32
    out_bytes = pair_n * (1 + sr + sr * sr + sr * sb) * f32
    min_traffic = ell_bytes + base_bytes + out_bytes
    # per pair per tau-step: Sb*Sr*Sr logtheta adds + exp, Sr*Sb lse
    # (max+log), Sb*Sb*Sr mul-add for the trans contraction; x2 for
    # backward+forward
    flops_step = sb * sr * sr * 3 + sr * sb * 4 + sb * sb * sr * 2
    exps_step = sb * sr * sr + sr * sb     # transcendentals
    total_flops = pair_n * tau * flops_step * 2
    total_exp = pair_n * tau * exps_step * 2
    print(f"\npair-kernel analytic minimums at this shape:")
    print(f"  min device-memory traffic {min_traffic / 1e6:.1f} MB")
    print(f"  ~{total_flops / 1e6:.0f} MFLOP + ~{total_exp / 1e6:.0f} M "
          f"transcendentals per iteration")
    print(f"  measured e_step: {dts['pair_e_step'] * 1e6:.1f} us -> "
          f"{total_flops / dts['pair_e_step'] / 1e12:.2f} TFLOP/s eff + "
          f"{total_exp / dts['pair_e_step'] / 1e9:.1f} Gtranscendental/s",
          flush=True)


if __name__ == "__main__":
    main()
