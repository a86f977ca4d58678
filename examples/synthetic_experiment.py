"""CLI for the synthetic ground-truth benchmark — this framework's
version of `Synthetic_experiment/exprmt1_demo.m` + `syn_evluate.m`.

Runs VBEM -> VBHEM(K,S grid) -> VHEM(AIC/BIC) -> CCFD -> PPK(AIC/BIC)
over seeded repeats with per-stage checkpoint/resume, then prints the
recovery summary (Rand index, purity, P(K=2), P(S=2) per method).

Example (small smoke run):
  python examples/synthetic_experiment.py --repeats 2 --subjects 6 \
      --seqs 10 --kmax 3 --smax 3 --out /tmp/syn --cpu
"""
import argparse
import dataclasses
import json
import os
import sys


def _raise_map_count():
    """XLA:CPU parallel codegen mmaps thousands of small JIT code
    sections per big module; the kernel default vm.max_map_count=65530
    is exhausted by this compile-heavy pipeline (LLVM 'Cannot allocate
    memory' then segfault, observed at ~59k maps).  Raise it if we can."""
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            if int(f.read()) < 1048576:
                with open("/proc/sys/vm/max_map_count", "w") as g:
                    g.write("1048576")
    except OSError:
        pass


_raise_map_count()

import jax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="syn_out")
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--subjects", type=int, default=20,
                    help="HMMs per ground-truth cluster")
    ap.add_argument("--seqs", type=int, default=25)
    ap.add_argument("--t", type=int, default=50)
    ap.add_argument("--kmax", type=int, default=6)
    ap.add_argument("--smax", type=int, default=5)
    ap.add_argument("--trials", type=int, default=50)
    ap.add_argument("--hem-trials", type=int, default=20,
                    help="VHEM restarts per initmode (x3 under 'auto')")
    ap.add_argument("--repeat-ids", default=None,
                    help="comma list of repeat indices (subset of a "
                         "shared outdir for multi-process runs; give each "
                         "process its own GPU: a JAX process reserves most "
                         "of a card's memory, so a second process on the "
                         "same card fails for want of memory)")
    ap.add_argument("--methods", default="vbhem,vhem,ccfd,ppk")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (default: JAX's default "
                         "platform, the GPU where there is one)")
    ap.add_argument("--dtype", default="f64", choices=["f32", "f64"],
                    help="f64 (CPU, MATLAB-grade parity) or f32 (GPU)")
    ap.add_argument("--hyp-steps", type=int, default=25,
                    help="L-BFGS step cap for the batched hyp optimizers")
    ap.add_argument("--max-hyp-solutions", default="5",
                    help="cap on uniqueLL survivors that get hyp-"
                         "optimized per grid cell ('none' = optimize "
                         "every survivor, the reference behavior — "
                         "`vbhem_h3m_c.m:96-160`)")
    args = ap.parse_args()
    max_hyp = (None if str(args.max_hyp_solutions).lower() == "none"
               else int(args.max_hyp_solutions))
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.dtype == "f64":
        jax.config.update("jax_enable_x64", True)

    from vbhem_tpu.config import HEMConfig
    from vbhem_tpu.experiments import runner, synthetic

    repeat_ids = ([int(v) for v in args.repeat_ids.split(",")]
                  if args.repeat_ids else None)
    summary = runner.run_experiment(
        args.out, n_repeats=args.repeats, repeat_ids=repeat_ids,
        n_per_cluster=args.subjects, n_seqs=args.seqs, t=args.t,
        k_grid=range(1, args.kmax + 1), s_grid=range(1, args.smax + 1),
        vb_config=dataclasses.replace(
            synthetic.default_vb_config(), hyp_max_steps=args.hyp_steps,
            max_hyp_solutions=max_hyp, verbose=2),
        vbhem_config=dataclasses.replace(
            synthetic.default_vbhem_config(trials=args.trials),
            hyp_max_steps=args.hyp_steps, max_hyp_solutions=max_hyp,
            verbose=2),
        # exprmt1_demo.m:115-118: hemopt.tau = T, Nv = 100, initmode auto
        hem_config=HEMConfig(trials=args.hem_trials, nv=100, tau=args.t),
        methods=tuple(args.methods.split(",")),
        dtype=args.dtype)
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
