"""Smoke test of the VBEM -> VBHEM pipeline on NVIDIA GPUs.

Run from the repository root:

    python chip_smoke.py               # one GPU: phases (a), (b), (c)
    python chip_smoke.py --devices 4   # four GPUs: phases (a), (d)

Phases:

  (a) device   JAX must find a GPU; the script never falls back to the
               CPU.  Prints the card (nvidia-smi name and power limit),
               the JAX version and ``device_kind``.
  (b) kernels  compiles the Pallas forward-backward kernel for the card at
               the width bank learning runs it, compares it once with the
               plain XLA path (``jax_default_matmul_precision="highest"``),
               and times both.
  (c) main     one repeat of the reference synthetic protocol through
               ``runner.run_experiment`` (2 clusters x 20 subjects, 25
               sequences x T=50, K=1:6 x S=1:5, tau=50, Nv=100, hyper-
               parameter learning on), which must select K=2, S=2 with
               Rand index 1.0; then a few EM iterations at Kb=8192.
  (d) sharded  ``spmd.sharded_vbhem_em`` on a ('trial', 'base') = (1, 4)
               mesh at Kb=32,768 against single-device ``vbhem_em``.

Any failure raises and ends the run with a non-zero exit code.  The last
line of standard output is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np

# Parity gate of a kernel: max relative error |got - ref| / (|ref| + 1)
# against the plain XLA path evaluated in float64 on the same inputs.
# The XLA float32 path's own error is printed beside it.
KERNEL_TOL = 5e-5
# VBHEM restarts per (K, S) cell in phase (c); the reference runs 100.
MAIN_TRIALS = 25
OUTDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "chip_smoke_out")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def phase_device(n_devices: int):
    """(a) The first device must be a GPU, and there must be enough."""
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX found "
                         f"{dev.platform} ({dev.device_kind})")
    if len(devices) < n_devices:
        raise SystemExit(f"chip_smoke: needs {n_devices} GPUs; JAX found "
                         f"{len(devices)}")
    card = card_name()
    log(f"card: {card}")
    log(f"jax {jax.__version__}; device_kind {dev.device_kind}; "
        f"{len(devices)} device(s)")
    return dev, card


# ---------------------------------------------------------------------------
# problems
# ---------------------------------------------------------------------------

def random_bank(key, kb: int, sb: int, d: int = 2, dtype=jnp.float32):
    """A random base bank of Kb HMMs with Sb states and D-dim emissions."""
    from vbhem_tpu.containers import H3M, HMM
    ks = jax.random.split(key, 4)
    mean = jax.random.normal(ks[0], (kb, sb, d), dtype) * 3.0
    a = jax.random.normal(ks[1], (kb, sb, d, d), dtype) * 0.3
    cov = jnp.einsum("ksde,ksfe->ksdf", a, a) + jnp.eye(d, dtype=dtype)
    prior = jax.random.dirichlet(ks[2], jnp.ones((sb,)), (kb,)).astype(dtype)
    trans = jax.random.dirichlet(ks[3], jnp.ones((sb,)),
                                 (kb, sb)).astype(dtype)
    return H3M(omega=jnp.full((kb,), 1.0 / kb, dtype),
               hmm=HMM(prior=prior, trans=trans, mean=mean, cov=cov),
               state_mask=jnp.ones((kb, sb), bool))


def clustered_bank(key, kb: int, n_groups: int, sb: int, d: int = 2,
                   dtype=jnp.float32):
    """A bank of Kb HMMs that are noisy copies of ``n_groups`` well
    separated prototypes: the cluster structure that VBHEM is for, so an
    EM run's assignments do not hinge on float32 rounding."""
    from vbhem_tpu.containers import H3M, HMM
    kp, kg, kn = jax.random.split(key, 3)
    proto = random_bank(kp, n_groups, sb, d, dtype)
    group = jax.random.randint(kg, (kb,), 0, n_groups)
    hmm = jax.tree.map(lambda a: a[group], proto.hmm)
    noise = 0.1 * jax.random.normal(kn, hmm.mean.shape, dtype)
    hmm = hmm._replace(mean=3.0 * hmm.mean + noise)
    return H3M(omega=jnp.full((kb,), 1.0 / kb, dtype), hmm=hmm,
               state_mask=jnp.ones((kb, sb), bool))


def em_problem(key, base, kr: int, sr: int, n_trials: int = 0):
    """Hyperparameters and base-EM initial posteriors of Kr reduced HMMs
    with Sr states (with a leading trials axis when ``n_trials`` > 0)."""
    from vbhem_tpu.config import VBHEMConfig
    from vbhem_tpu.models import vbhem
    d = base.hmm.mean.shape[-1]
    cfg = VBHEMConfig(m0=(0.0,) * d, w0=1.0, nv=100, tau=10)
    hyps = vbhem.VBHEMHyps.from_config(cfg, d, jnp.float32)

    def init(k):
        return vbhem.init_baseem(k, base, kr, sr, hyps, cfg.nv)

    post = (jax.vmap(init)(jax.random.split(key, n_trials)) if n_trials
            else init(key))
    return post, hyps, cfg


# ---------------------------------------------------------------------------
# (b) kernels
# ---------------------------------------------------------------------------

def max_rel_err(got, want) -> float:
    return max(
        float(np.max(np.abs(np.asarray(g, np.float64)
                            - np.asarray(w, np.float64))
                     / (np.abs(np.asarray(w, np.float64)) + 1.0)))
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)))


def first_call(fn, args):
    """(result, seconds) of the first call: compile plus one run."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def time_ms(fn, args, reps: int) -> float:
    """Median milliseconds of ``reps`` runs of a compiled call."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _to_f64(a):
    return a.astype(jnp.float64) if a.dtype == jnp.float32 else a


def compare_kernel(name: str, kernel_fn, xla_fn, args, card: str,
                   reps: int = 10) -> float:
    """Compile ``kernel_fn`` and the XLA path, check the kernel against
    the XLA path in float64 (KERNEL_TOL), and time both in float32."""
    kernel_fn, xla_fn = jax.jit(kernel_fn), jax.jit(xla_fn)
    got, c_k = first_call(kernel_fn, args)
    want, c_x = first_call(xla_fn, args)
    with jax.enable_x64(True):
        exact = jax.jit(xla_fn)(*jax.tree.map(_to_f64, args))
    err, err_xla = max_rel_err(got, exact), max_rel_err(want, exact)
    t_k, t_x = time_ms(kernel_fn, args, reps), time_ms(xla_fn, args, reps)
    log(f"kernel {name}: max_rel_err vs float64 {err:.3e} (tol "
        f"{KERNEL_TOL:.0e}; "
        f"xla float32 {err_xla:.3e}; kernel vs xla "
        f"{max_rel_err(got, want):.3e}); kernel {t_k:.4f} ms, xla "
        f"{t_x:.4f} ms (median of {reps}); first call {c_k:.2f} s / "
        f"{c_x:.2f} s; card {card}")
    if not err <= KERNEL_TOL:
        raise AssertionError(f"{name}: max_rel_err {err:.3e} > "
                             f"{KERNEL_TOL:.0e}")
    return err


def fb_problem(key, n_subj: int, n_trials: int, n_seqs: int, t: int, k: int):
    """Bank-learning shaped forward-backward inputs: per (subject,
    restart) scores and emissions, per-subject ragged masks."""
    ks = jax.random.split(key, 4)
    log_rho = 2.0 * jax.random.normal(ks[0], (n_subj, n_trials, n_seqs, t, k))
    log_pz1 = jnp.log(jax.random.dirichlet(
        ks[1], jnp.ones((k,)), (n_subj, n_trials))) - 0.1
    log_trans = jnp.log(jax.random.dirichlet(
        ks[2], jnp.ones((k,)), (n_subj, n_trials, k))) - 0.1
    lengths = jax.random.randint(ks[3], (n_subj, n_seqs), max(t // 5, 1),
                                 t + 1).at[:, 0].set(t)
    mask = jnp.arange(t)[None, None, :] < lengths[..., None]
    return (log_pz1.astype(jnp.float32), log_trans.astype(jnp.float32),
            log_rho.astype(jnp.float32), mask)


def phase_kernels(card: str, n_subj: int = 40, n_trials: int = 20,
                  n_seqs: int = 25, t: int = 50, k: int = 3,
                  interpret: bool = False, reps: int = 10) -> None:
    """(b) The forward-backward kernel against the XLA scan at the width
    bank learning runs it in the reference protocol (2 x 20 subjects, 20
    restarts, 25 sequences of T=50, K<=3), folded over the subject and
    restart lanes as bank learning calls it.  ``interpret`` (tests only)
    runs the kernel on the CPU."""
    from vbhem_tpu.ops import fb_pallas
    from vbhem_tpu.ops.fb import forward_backward

    def lanes(fn):
        inner = jax.vmap(fn, in_axes=(0, 0, 0, None))    # restarts
        return jax.vmap(inner, in_axes=(0, 0, 0, 0))     # subjects

    def kernel(*a):
        out = lanes(lambda *b: fb_pallas.forward_backward_pallas(
            *b, interpret=interpret))(*a)
        return out.gamma, out.xi_sum, out.phi_norm

    def xla(*a):
        out = lanes(forward_backward)(*a)
        return out.gamma, out.xi_sum, out.phi_norm

    args = fb_problem(jax.random.key(11), n_subj, n_trials, n_seqs, t, k)
    if not interpret:
        # the pipeline's own dispatch must take the kernel here
        auto = jax.make_jaxpr(lanes(fb_pallas.forward_backward_auto))(*args)
        assert "pallas_call" in str(auto), "kernel not dispatched"
    compare_kernel("forward_backward bank", kernel, xla, args, card, reps)


# ---------------------------------------------------------------------------
# (c) main path
# ---------------------------------------------------------------------------

def em_rising(base, post, hyps, nv: int, tau: int, n_iter: int) -> np.ndarray:
    """``n_iter`` EM iterations; the ELBO must be finite and not fall
    (beyond float32 rounding of its magnitude)."""
    from vbhem_tpu.models import vbhem
    run = jax.jit(lambda p: vbhem.em_trace(base, p, hyps, nv, tau, n_iter))
    _, lls = jax.block_until_ready(run(post))
    lls = np.asarray(lls, np.float64)
    assert np.all(np.isfinite(lls)), f"non-finite ELBO: {lls}"
    drop = np.min(np.diff(lls)) if n_iter > 1 else 0.0
    assert drop >= -1e-5 * np.max(np.abs(lls)), f"ELBO fell: {lls}"
    return lls


def phase_main_path(card: str, outdir: str = OUTDIR,
                    trials: int = MAIN_TRIALS, protocol=None,
                    em_kb: int = 8192, em_kr: int = 8,
                    em_iters: int = 10) -> None:
    """(c) One repeat of the synthetic protocol through the runner, then
    a few EM iterations at the pod-shard width.  ``protocol`` overrides
    runner keyword arguments (tests shrink the shapes with it)."""
    from vbhem_tpu.experiments import runner, synthetic

    # the runner resumes from checkpoints, so start from an empty dir
    shutil.rmtree(outdir, ignore_errors=True)
    log(f"reduced: VBHEM restarts per (K,S) cell {trials} "
        f"(the reference runs 100)")
    kwargs = dict(vbhem_config=synthetic.default_vbhem_config(trials=trials))
    kwargs.update(protocol or {})
    t0 = time.perf_counter()
    summary = runner.run_experiment(outdir, n_repeats=1, methods=("vbhem",),
                                    dtype="f32", **kwargs)
    wall = time.perf_counter() - t0
    grid = runner.load_checkpoint(outdir, 0, "vbhem")
    score = grid["score"]
    log(f"main path: repeat 0 selected K={score.best_k} S={score.best_s} "
        f"RI={score.rand_index:.4f}; wall {wall:.1f} s, of which VBHEM grid "
        f"{grid['elapsed']:.1f} s, grid+DIC {grid['elapsed_with_dic']:.1f} "
        f"s, data+bank learning+distances "
        f"{wall - grid['elapsed_with_dic']:.1f} s (compiles included); "
        f"card {card}")
    vb = summary["vbhem"]
    assert (score.best_k, score.best_s, score.rand_index) == (2, 2, 1.0) \
        and vb["p_k_correct"] == vb["p_s_correct"] == 1.0, summary

    base = random_bank(jax.random.key(12), em_kb, 3)
    post, hyps, cfg = em_problem(jax.random.key(13), base, em_kr, 3)
    t0 = time.perf_counter()
    lls = em_rising(base, post, hyps, cfg.nv, cfg.tau, em_iters)
    # the CPU backend (tests) keeps no memory statistics
    peak = (jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use", "not measured")
    log(f"em Kb={em_kb} Kr={em_kr}: {em_iters} iterations in "
        f"{time.perf_counter() - t0:.2f} s (compile included), ELBO "
        f"{lls[0]:.6g} -> {lls[-1]:.6g}; peak_bytes_in_use {peak}; "
        f"card {card}")


# ---------------------------------------------------------------------------
# (d) sharded
# ---------------------------------------------------------------------------

# Final-state agreement of the sharded and single-device EM in float32:
# the base-axis psum adds the per-device partial statistics in another
# order than one device's reduction does.
SHARD_TOL = 1e-4


def phase_sharded(card: str, n_devices: int = 4, kb: int = 32768,
                  kr: int = 8, s: int = 3, iters: int = 20) -> None:
    """(d) The Kb-sharded EM loop on a (1, n_devices) mesh against the
    same EM on one device, both for exactly ``iters`` iterations."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from vbhem_tpu.models import vbhem
    from vbhem_tpu.parallel import spmd

    base = clustered_bank(jax.random.key(14), kb, kr, s)
    posts, hyps, cfg = em_problem(jax.random.key(15), base, kr, s,
                                  n_trials=1)
    mesh = spmd.make_mesh(n_trial=1, n_base=n_devices)
    base_sh = jax.device_put(base, NamedSharding(mesh, P("base")))
    t0 = time.perf_counter()
    st = spmd.sharded_vbhem_em(mesh, base_sh, posts, hyps, cfg.nv, cfg.tau,
                               max_iter=iters, min_diff=0.0)
    jax.block_until_ready(st)
    t_sh = time.perf_counter() - t0
    used = st.hat_z.sharding.device_set
    assert len(used) == n_devices, f"sharded state lives on {used}"

    dev0 = jax.devices()[0]
    base_1, posts_1 = jax.device_put((base, posts), dev0)
    t0 = time.perf_counter()
    ref = jax.jit(jax.vmap(lambda p: vbhem.vbhem_em(
        base_1, p, hyps, nv=cfg.nv, tau=cfg.tau, max_iter=iters,
        min_diff=0.0)))(posts_1)
    jax.block_until_ready(ref)
    t_1 = time.perf_counter() - t0
    assert np.array_equal(np.asarray(st.it), np.asarray(ref.it)), \
        (st.it, ref.it)
    ll_err = max_rel_err(st.ll, ref.ll)
    post_err = max_rel_err(st.post, ref.post)
    log(f"sharded Kb={kb} Kr={kr} on {n_devices} devices: {int(st.it[0])} "
        f"iterations, ELBO {float(st.ll[0]):.8g} vs {float(ref.ll[0]):.8g}; "
        f"max_rel_err ELBO {ll_err:.3e}, posterior {post_err:.3e} "
        f"(tol {SHARD_TOL:.0e}); wall {t_sh:.2f} s sharded, {t_1:.2f} s one "
        f"device (compiles included); card {card}")
    assert ll_err <= SHARD_TOL and post_err <= SHARD_TOL


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded path (phase d)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    dev, card = phase_device(args.devices)
    if args.devices == 4:
        t = time.perf_counter()
        phase_sharded(card, n_devices=4)
        log(f"phase sharded: {time.perf_counter() - t:.1f} s")
    else:
        for name, phase in (("kernels", phase_kernels),
                            ("main", phase_main_path)):
            t = time.perf_counter()
            phase(card)
            log(f"phase {name}: {time.perf_counter() - t:.1f} s")
    log(f"total: {time.perf_counter() - t0:.1f} s; card {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
