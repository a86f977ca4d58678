"""Benchmark: VBHEM E-step/EM throughput on one GPU.

Prints ONE JSON line:
  {"metric": "vbhem_pair_updates_per_sec", "value": N, "unit": "pairs/s",
   "vs_baseline": R}

The metric is the driver-defined north star (BASELINE.md): (base i,
reduced j) pair updates per second through the full VBHEM EM iteration
(pair E-step backward+forward recursions over tau virtual steps, soft
assignments, conjugate M-step, ELBO).

``vs_baseline``: the reference publishes no numbers (BASELINE.md), so
the baseline is the target from BASELINE.json — 50x a single-core C-MEX
implementation.  The single-core number is MEASURED, not estimated:
`native/baseline_pair_estep.c` is a scalar C port of this repo's pair
E-step (E3logN + backward/forward recursions, the same math as
`ops/pair_estep.py`), compiled `gcc -O2` at the bench shape
(Kb=8192, Kr=8, Sb=Sr=3, D=2, tau=10).  The baseline is RE-MEASURED on
the current host at bench time (compile + run below); if that fails, or
if the host is loaded and the fresh number comes out LOWER than the
best idle-host measurement on record, the recorded idle number is used
instead — i.e. we always divide by the LARGER (more conservative)
baseline:

  {"pairs_per_sec": 176877, ...}   # idle host, 2026-08-20 (ADVICE r2)

vs_baseline = value / (50 x baseline_pairs_per_sec), so vs_baseline >= 1
means the >=50x single-core target is met; multiply by 50 for the raw
single-core speedup.

Scope note (ADVICE r2): the C baseline times the pair E-STEP only,
while the GPU metric includes the full EM iteration (E-step + soft
assignments + ELBO + conjugate M-step).  The direction is conservative
— the C number overestimates what a full single-core C EM loop would
do, so vs_baseline understates the true full-EM speedup.

The kernels' parity with the XLA paths on the card is checked by
``chip_smoke.py`` (phase b), not here.  Without a GPU this script
fails.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp

# Best idle-host single-core measurement on record (pairs/s); used as a
# floor for the fresh measurement so a loaded host can't inflate
# vs_baseline.
IDLE_HOST_PAIRS_PER_SEC = 176877.0


def measure_c_baseline(kb=8192, kr=8):
    """Compile and run native/baseline_pair_estep.c on this host; return
    pairs/s, or None if the toolchain/run fails."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "native", "baseline_pair_estep.c")
    try:
        with tempfile.TemporaryDirectory() as td:
            exe = os.path.join(td, "baseline_pair_estep")
            subprocess.run(["gcc", "-O2", "-o", exe, src, "-lm"],
                           check=True, capture_output=True, timeout=120)
            out = subprocess.run([exe, str(kb), str(kr)], check=True,
                                 capture_output=True, timeout=600)
            return float(json.loads(out.stdout)["pairs_per_sec"])
    except Exception as e:  # missing gcc, timeout, parse failure ...
        print(f"# C baseline remeasure failed ({e!r}); using recorded "
              f"idle-host number", file=sys.stderr)
        return None


def make_problem(key, kb=512, sb=3, kr=8, sr=3, d=2, dtype=jnp.float32):
    from vbhem_tpu.containers import H3M, HMM
    from vbhem_tpu.models import vbhem
    from vbhem_tpu.config import VBHEMConfig

    ks = jax.random.split(key, 6)
    mean = jax.random.normal(ks[0], (kb, sb, d), dtype) * 3.0
    a = jax.random.normal(ks[1], (kb, sb, d, d), dtype) * 0.3
    cov = jnp.einsum("ksde,ksfe->ksdf", a, a) + jnp.eye(d, dtype=dtype)
    prior = jax.random.dirichlet(ks[2], jnp.ones((sb,)), (kb,)).astype(dtype)
    trans = jax.random.dirichlet(ks[3], jnp.ones((sb,)), (kb, sb)).astype(dtype)
    base = H3M(omega=jnp.full((kb,), 1.0 / kb, dtype),
               hmm=HMM(prior=prior, trans=trans, mean=mean, cov=cov),
               state_mask=jnp.ones((kb, sb), bool))
    cfg = VBHEMConfig(m0=(0.0,) * d, w0=1.0, nv=100, tau=10)
    hyps = vbhem.VBHEMHyps.from_config(cfg, d, dtype)
    post = vbhem.init_baseem(ks[4], base, kr, sr, hyps, cfg.nv)
    return base, post, hyps, cfg


def main():
    # Kb=8192: a per-device shard of the north-star config (BASELINE.json:
    # "10k+ input HMMs"); 500 EM iterations in one dispatch.
    kb, kr, tau, n_iters = 8192, 8, 10, 500
    from vbhem_tpu.models import vbhem

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: needs a GPU; JAX found {dev.platform}")

    base, post, hyps, cfg = make_problem(jax.random.key(0), kb=kb, kr=kr)
    tilde_n = (cfg.nv * kb) * base.omega

    def em_iter(post, _):
        exps = vbhem.reduced_expectations(post)
        pair = vbhem.e_step(base, post, exps, tau)
        hat_z, z_ni, nj = vbhem.soft_assignments(tilde_n, exps.log_omega,
                                                 pair.ll_elbo)
        ll = vbhem.elbo(post, exps, pair, hat_z, z_ni, nj, hyps)
        stats = vbhem.aggregate_stats(base, pair, z_ni, nj)
        return vbhem.m_step(stats, hyps), ll

    @jax.jit
    def run(post):
        post, lls = jax.lax.scan(em_iter, post, None, length=n_iters)
        return post, lls

    # compile + warmup
    out = run(post)
    jax.block_until_ready(out)
    # timed
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        out = run(post)
        jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps

    pairs_per_sec = kb * kr * n_iters / dt

    fresh = measure_c_baseline(kb=kb, kr=kr)
    single_core = max(fresh or 0.0, IDLE_HOST_PAIRS_PER_SEC)
    baseline = 50.0 * single_core

    print(json.dumps({
        "metric": "vbhem_pair_updates_per_sec",
        "value": round(pairs_per_sec, 1),
        "unit": "pairs/s",
        "vs_baseline": round(pairs_per_sec / baseline, 3),
    }))
    # diagnostics to stderr (driver reads only stdout JSON)
    print(f"# device={dev.platform} kind={dev.device_kind} Kb={kb} Kr={kr} "
          f"tau={tau} "
          f"iters={n_iters} dt/iter={dt / n_iters * 1e3:.2f}ms "
          f"final_elbo={float(out[1][-1]):.4g} "
          f"c_baseline={single_core:.1f} pairs/s"
          f" ({'fresh' if fresh and fresh >= IDLE_HOST_PAIRS_PER_SEC else 'recorded idle-host'})",
          file=sys.stderr)


if __name__ == "__main__":
    main()
