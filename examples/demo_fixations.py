"""End-to-end demo: per-subject VBEM -> VBHEM clustering -> plots.

The JAX equivalent of `demo/vbdemo_face.m`: learn an HMM per
subject from fixation sequences with model selection over S=1..3 and
hyperparameter learning, cluster the subjects' HMMs with VBHEM over
K=1..5, prune empty clusters, and plot the group models.

The reference ships a private Excel dataset (`demo/demodata.xls`); this
demo generates equivalent synthetic face-viewing data instead: two
viewer groups ("holistic" vs "analytic") with different ROI dynamics on
a 512x384 image.  Point `--xls` at a SubjectID/TrialID/FixX/FixY table
to run on real data (`read_xls_fixations.m` format).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from vbhem_tpu.config import VBConfig, VBHEMConfig
from vbhem_tpu.containers import HMM, SeqBatch
from vbhem_tpu.models import hmm_tools, vbhem, vbhmm
from vbhem_tpu.models.hyp_heuristics import set_hyperparam
from vbhem_tpu.utils import plots



def synth_subjects(key, n_per_group=5, n_trials=12, t=12):
    """Two groups of synthetic viewers on a 512x384 'face'."""
    eyes_l, eyes_r, mouth = [180.0, 140.0], [330.0, 140.0], [255.0, 280.0]
    cov = (28.0 ** 2) * jnp.eye(2)
    holistic = HMM(prior=jnp.asarray([0.6, 0.2, 0.2]),
                   trans=jnp.asarray([[0.6, 0.2, 0.2],
                                      [0.5, 0.4, 0.1],
                                      [0.5, 0.1, 0.4]]),
                   mean=jnp.asarray([[255.0, 170.0], eyes_l, eyes_r]),
                   cov=jnp.broadcast_to(cov, (3, 2, 2)))
    analytic = HMM(prior=jnp.asarray([0.45, 0.45, 0.1]),
                   trans=jnp.asarray([[0.5, 0.4, 0.1],
                                      [0.4, 0.5, 0.1],
                                      [0.3, 0.3, 0.4]]),
                   mean=jnp.asarray([eyes_l, eyes_r, mouth]),
                   cov=jnp.broadcast_to(cov, (3, 2, 2)))
    batches, labels = [], []
    for gi, gt in enumerate([holistic, analytic]):
        for si in range(n_per_group):
            k = jax.random.fold_in(jax.random.fold_in(key, gi), si)
            _, x = hmm_tools.sample(k, gt, t=t, n=n_trials)
            batches.append(SeqBatch(x=x, lengths=jnp.full((n_trials,), t,
                                                          jnp.int32)))
            labels.append(gi)
    return batches, np.asarray(labels)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--xls", default=None, help="fixation table (xls/csv)")
    ap.add_argument("--image", default=None,
                    help="background image for ROI plots (the reference "
                         "demo uses demo/ave_face120.png)")
    ap.add_argument("--out", default="demo_out", help="output dir")
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--cpu", action="store_true", help="force CPU")
    ap.add_argument("--quick", action="store_true",
                    help="tiny settings for smoke/integration tests")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    os.makedirs(args.out, exist_ok=True)
    bg = None
    if args.image:
        import matplotlib.image as mpimg
        bg = mpimg.imread(args.image)

    if args.xls:
        # native one-pass C++ CSV loader when available, pandas
        # otherwise (read_xls_fixations.m parity either way; legacy
        # BIFF8 .xls falls back to the vendored utils/xls.py reader)
        from vbhem_tpu.utils.native_io import read_fixations_auto
        subjects = read_fixations_auto(args.xls)
        names = list(subjects)
        batches = [subjects[n] for n in names]
        labels = None
    else:
        batches, labels = synth_subjects(jax.random.key(args.seed))
        names = [f"subj{i:02d}" for i in range(len(batches))]

    # per-subject VBEM, model selection over S (vbdemo_face.m:21-40).
    # With --xls we use the reference demo's exact hyperparameters:
    # alpha0=1, mu0=image center ([320,420] face image -> (160,210)),
    # W0=0.001, beta0=1, v0=10, epsilon0=1, learn_hyps=1, 50 restarts.
    if args.xls and not args.quick:
        cfg = VBConfig(alpha0=1.0, epsilon0=1.0, beta0=1.0, v0=10.0,
                       w0=0.001, mu0=(160.0, 210.0), learn_hyps=True)
    else:
        cfg = VBConfig(numtrials=3, learn_hyps=False, max_iter=30) \
            if args.quick else VBConfig(numtrials=10, learn_hyps=True)
        cfg = set_hyperparam(cfg, batches, mode="d")
    results = []
    for i, b in enumerate(batches):
        s_grid = [1, 2] if args.quick else [1, 2, 3]
        res, info = vbhmm.learn(jax.random.key(args.seed + i), b,
                                s_grid, cfg)
        print(f"{names[i]}: best S={info['model_best_k']} "
              f"LL={float(res.ll):.1f}")
        results.append(res)
        fig = plots.plot_vbhmm(res, batch=b, image=bg, title=names[i])
        fig.savefig(os.path.join(args.out, f"{names[i]}.png"), dpi=80)

    # VBHEM clustering over the (K, S) grid (vbdemo_face.m:46-67).
    # With --xls: the reference demo's exact settings — K=1:5 x S=1:3,
    # wtkmeans init, Nv=10, tau=5, trials=50, alpha0=eta0=epsilon0=
    # lambda0=1, v0=10, W0=0.001, m0=image center, learn_hyps on
    # (the vbhemopt default, vbhem_h3m_cluster.m:188).
    if args.xls and not args.quick:
        vb_cfg = VBHEMConfig(alpha0=1.0, eta0=1.0, epsilon0=1.0,
                             lambda0=1.0, v0=10.0, w0=0.001,
                             m0=(160.0, 210.0), trials=50, nv=10, tau=5,
                             initmode="wtkmeans")
        k_grid, s_grid = [1, 2, 3, 4, 5], [1, 2, 3]
    else:
        # alpha0=1e6 keeps weakly-evidenced clusters alive, as in the
        # paper's synthetic experiment (exprmt1_demo.m:72)
        vb_cfg = VBHEMConfig(alpha0=1e6, m0=cfg.mu0, w0=cfg.w0,
                             trials=3 if args.quick else 10,
                             nv=50, tau=10,
                             initmode="baseem" if args.quick else "auto",
                             learn_hyps=False)
        k_grid = [1, 2] if args.quick else [1, 2, 3, 4, 5]
        s_grid = 2 if args.quick else 3
    base = vbhem.h3m_from_results(results)
    # single-program padded sweep: ONE compile for the whole grid
    # instead of a per-(K,S,initmode) recompile
    res, info = vbhem.cluster_batched(jax.random.key(args.seed + 1001),
                                      base, k_grid, s_grid, vb_cfg)
    # full vbh3m_remove_empty semantics: cluster pruning + per-cluster
    # state pruning + standardize (vbdemo_face.m:67)
    res, group_hmms = vbhem.vbh3m_remove_empty(res)
    print("selected K =", info["model_best_k"],
          "selected S =", info.get("model_best_s"),
          "| groups:", res.groups,
          "| states/cluster after prune:",
          [int(h.model.prior.shape[0]) for h in group_hmms])
    if labels is not None:
        from vbhem_tpu.utils.metrics import rand_index
        ri = rand_index(np.asarray(res.label), labels)[0]
        print("adjusted Rand index vs ground truth:", round(ri, 3))

    fig = plots.plot_vbhem_clusters(res, image=bg)
    fig.savefig(os.path.join(args.out, "clusters.png"), dpi=80)
    import matplotlib.pyplot as plt
    fig2, ax = plt.subplots(figsize=(5, 3.5))
    # per-K best over the S axis (vbdemo_face.m:78 plots model_LL vs K)
    plots.plot_model_selection(ax, np.max(info["model_ll"], axis=1),
                               info["model_k"])
    fig2.savefig(os.path.join(args.out, "model_selection.png"), dpi=80)
    print("plots written to", args.out)


if __name__ == "__main__":
    main()
