"""Batch VBEM over subjects, with optional batch hyperparameter
learning (one shared hyp vector optimized over the summed objective).

Parity map: `src/hmm/vbhmm_learn_batch.m` — per-subject learning
(`:56-78`, a `parfor` there, a loop of jitted fits here), and batch hyp
learning (`:107-457`): per-subject init solutions are kept, a shared
transformed hyp vector is optimized with BFGS where each function eval
re-runs EM for every (subject, kept-init) pair, scores each subject by
its best solution, and sums over subjects.

Design delta: the (subject x kept-init) EM runs are one vmapped
batch (the reference flattens them into one `parfor`, `:347-457`);
requires homogeneous sequence counts per subject (pad sequences to a
common T; heterogeneous N falls back to the slower per-subject path).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import VBConfig
from ..containers import SeqBatch
from . import vbhmm


def learn_bank(key: jax.Array, batches: Sequence[SeqBatch], k: int,
               config: VBConfig = VBConfig()):
    """Learn one HMM per subject with the WHOLE bank batched: the
    subject x trial restarts are one vmapped program, and (with
    ``config.learn_hyps``) every subject's uniqueLL survivors are hyp-
    optimized together in one vmapped L-BFGS — the vectorised form of
    `vbhmm_learn_batch.m:56-78` (a parfor of per-subject learns, each
    with its own hyp optimization, `vbhmm_learn.m:498-552`).

    Requires homogeneous per-subject data shapes; callers should fall
    back to per-subject :func:`vbhmm.learn` otherwise.  Returns
    (list of VBHMMResult, info dict).
    """
    from .. import hyp as hypmod

    n_subj = len(batches)
    dim = batches[0].x.shape[-1]
    dtype = batches[0].x.dtype
    assert len({(int(b.x.shape[0]), int(b.x.shape[1]))
                for b in batches}) == 1, "learn_bank needs uniform shapes"
    xs = jnp.stack([b.x for b in batches])             # [S, N, T, D]
    lens = jnp.stack([b.lengths for b in batches])     # [S, N]
    hyps0 = vbhmm.VBHyps.from_config(config, dim, dtype)
    numtrials = 1 if k == 1 else config.numtrials

    def fit_subject(skey, x, lengths):
        b = SeqBatch(x=x, lengths=lengths)

        def one_trial(tk):
            post0 = vbhmm.random_init(tk, b, k, hyps0, config.covar_type)
            return vbhmm.vbem_em(b, post0, hyps0, max_iter=config.max_iter,
                                 min_diff=config.min_diff,
                                 covar_type=config.covar_type)

        return jax.vmap(one_trial)(jax.random.split(skey, numtrials))

    skeys = jax.random.split(key, n_subj)
    states = jax.jit(jax.vmap(fit_subject))(skeys, xs, lens)  # [S, trials]

    info = {}
    if config.learn_hyps:
        # one lane per (subject, unique solution), padded to a fixed
        # lane count per subject for a static program shape
        lls = np.asarray(states.ll)                     # [S, trials]
        cap = config.max_hyp_solutions or numtrials
        n_lane = min(cap, numtrials)
        lane_subj, lane_trial = [], []
        for si in range(n_subj):
            uniq = hypmod.unique_ll(lls[si], config.min_diff)[:n_lane]
            if len(uniq) == 0:
                uniq = np.asarray([int(np.argmax(lls[si]))])
            uniq = np.concatenate(
                [uniq, np.full((n_lane - len(uniq),), uniq[0])])
            lane_subj.extend([si] * n_lane)
            lane_trial.extend(int(t) for t in uniq)
        lane_subj = np.asarray(lane_subj)
        si_idx = jnp.asarray(lane_subj)
        ti_idx = jnp.asarray(lane_trial)
        init_posts = jax.tree.map(lambda a: a[si_idx, ti_idx], states.post)
        lane_x = xs[si_idx]
        lane_len = lens[si_idx]

        specs = hypmod.vb_specs(dim, config.bounds, config.learn_hyps_keys)

        def neg_elbo(hyps, x, lengths, init_post):
            b = SeqBatch(x=x, lengths=lengths)
            st = vbhmm.vbem_em(b, init_post, jax.lax.stop_gradient(hyps),
                               max_iter=config.max_iter,
                               min_diff=config.min_diff,
                               covar_type=config.covar_type)
            post = jax.lax.stop_gradient(st.post)
            fb = vbhmm.e_step(b, post)
            stats = vbhmm.suff_stats(b, fb)
            return -vbhmm.elbo(b, post, fb, stats, hyps)

        hyps_b, _, _ = hypmod.optimize_hyps_batched(
            neg_elbo, hyps0, specs, (lane_x, lane_len, init_posts),
            max_steps=config.hyp_max_steps)

        def rerun(h, x, lengths, p):
            return vbhmm.vbem_em(SeqBatch(x=x, lengths=lengths), p, h,
                                 max_iter=config.max_iter,
                                 min_diff=config.min_diff,
                                 covar_type=config.covar_type)

        sts = jax.jit(jax.vmap(rerun))(hyps_b, lane_x, lane_len,
                                       init_posts)
        # degenerate hyp-optimized lanes fall back to pre-opt solutions
        pre = jax.tree.map(lambda a: a[si_idx, ti_idx], states)
        sts, n_bad, bad = hypmod.fallback_degenerate_lanes(
            sts, pre, pre.ll, sts.ll)
        # reverted lanes keep hyps0 so learned_hyps matches the kept state
        hyps_b = hypmod.substitute_lanes(hyps_b, hyps0, bad)
        if n_bad and config.verbose >= 2:
            print(f"  [hyp] {n_bad} degenerate lane(s) reverted",
                  flush=True)
        if dtype == jnp.float32:
            # per-subject lane selection on host-f64 rescored bounds
            # (f32 device ELBOs can carry selection-flipping artifacts)
            from . import rescore
            lane_ll = rescore.vbem_rescore_lanes(
                np.asarray(lane_x), np.asarray(lane_len), sts.post,
                hyps_b)
            info["lane_ll_f64"] = lane_ll
        else:
            lane_ll = np.asarray(sts.ll)
        picks, learned = [], []
        for si in range(n_subj):
            lanes = np.where(lane_subj == si)[0]
            best = lanes[int(np.argmax(lane_ll[lanes]))]
            picks.append(int(best))
        picks = jnp.asarray(np.asarray(picks))
        final = jax.tree.map(lambda a: a[picks], sts)
        info["learned_hyps"] = jax.tree.map(lambda a: a[picks], hyps_b)
    else:
        if dtype == jnp.float32:
            from . import rescore
            ll64 = np.stack([
                rescore.vbem_rescore_lanes(
                    np.asarray(xs[si]), np.asarray(lens[si]),
                    jax.tree.map(lambda a, si=si: a[si], states.post),
                    hyps0)
                for si in range(n_subj)])               # [S, trials]
            best = jnp.asarray(np.argmax(ll64, axis=1))
        else:
            best = jnp.argmax(states.ll, axis=1)        # [S]
        final = jax.tree.map(
            lambda a: a[jnp.arange(n_subj), best], states)

    results = []
    for si in range(n_subj):
        st = jax.tree.map(lambda a: a[si], final)
        res = vbhmm.finalize(batches[si], st)
        if config.sortclusters:
            res = vbhmm.standardize(res, config.sortclusters)
        results.append(res)
    return results, info


def learn_batch(key: jax.Array, batches: Sequence[SeqBatch], k: int,
                config: VBConfig = VBConfig(),
                learn_hyps_batch: bool = False,
                keep_inits: int = 3):
    """Learn one HMM per subject.

    With ``learn_hyps_batch`` (reference `vbopt.learn_hyps_batch`), a
    single hyp vector shared by all subjects is optimized over the
    summed best-solution ELBOs; returns (results, info) where info
    carries the learned hyps.
    """
    if not learn_hyps_batch:
        results = []
        for i, b in enumerate(batches):
            res, _ = vbhmm.learn(jax.random.fold_in(key, i), b, k, config)
            results.append(res)
        return results, {}

    dim = batches[0].x.shape[-1]
    dtype = batches[0].x.dtype
    hyps0 = vbhmm.VBHyps.from_config(config, dim, dtype)

    # 1) per-subject trials with base hyps; keep top unique solutions
    #    (`vbhmm_learn_batch.m:107-117`, keep_suboptimal_hmms=1)
    from .. import hyp as hypmod
    kept_posts = []   # list over subjects of posteriors stacked [M, ...]
    for i, b in enumerate(batches):
        states = vbhmm.fit_single_k(jax.random.fold_in(key, i), b, k,
                                    config, hyps0)
        uniq = hypmod.unique_ll(np.asarray(states.ll),
                                config.min_diff)[:keep_inits]
        idx = list(uniq) + [int(uniq[0])] * (keep_inits - len(uniq))
        kept_posts.append(jax.tree.map(
            lambda a: a[jnp.asarray(idx)], states.post))

    same_shapes = len({(int(b.x.shape[0]), int(b.x.shape[1]))
                       for b in batches}) == 1
    if not same_shapes:
        # heterogeneous subjects: per-subject independent hyp-opt
        # fallback (still empirical Bayes, just not tied)
        results = []
        for i, b in enumerate(batches):
            cfgi = config
            res, _ = vbhmm.learn(jax.random.fold_in(key, i), b, k, cfgi)
            results.append(res)
        return results, {"note": "heterogeneous shapes: untied hyps"}

    xs = jnp.stack([b.x for b in batches])            # [S, N, T, D]
    lens = jnp.stack([b.lengths for b in batches])    # [S, N]
    posts = jax.tree.map(lambda *a: jnp.stack(a), *kept_posts)  # [S, M,...]

    specs = hypmod.vb_specs(dim, config.bounds, config.learn_hyps_keys)

    def subject_best_ll(hyps, x, lengths, posts_s):
        b = SeqBatch(x=x, lengths=lengths)

        def one(init_post):
            st = vbhmm.vbem_em(b, init_post, jax.lax.stop_gradient(hyps),
                               max_iter=config.max_iter,
                               min_diff=config.min_diff,
                               covar_type=config.covar_type)
            post = jax.lax.stop_gradient(st.post)
            fb = vbhmm.e_step(b, post)
            stats = vbhmm.suff_stats(b, fb)
            return vbhmm.elbo(b, post, fb, stats, hyps)

        lls = jax.vmap(one)(posts_s)                   # [M]
        return jnp.max(lls)

    def neg_total(hyps):
        lls = jax.vmap(subject_best_ll, in_axes=(None, 0, 0, 0))(
            hyps, xs, lens, posts)
        # normalized by batch size (`vbhmm_learn_batch.m:455-457`)
        return -jnp.sum(lls) / len(batches)

    hyps_opt, info = hypmod.optimize_hyps(neg_total, hyps0, specs)

    # 3) final per-subject refits with the shared optimal hyps
    results = []
    for i, b in enumerate(batches):
        posts_s = jax.tree.map(lambda a: a[i], posts)
        sts = jax.vmap(lambda p: vbhmm.vbem_em(
            b, p, hyps_opt, max_iter=config.max_iter,
            min_diff=config.min_diff, covar_type=config.covar_type))(posts_s)
        best = int(jnp.argmax(sts.ll))
        st = jax.tree.map(lambda a: a[best], sts)
        res = vbhmm.finalize(b, st)
        if config.sortclusters:
            res = vbhmm.standardize(res, config.sortclusters)
        results.append(res)
    return results, {"learned_hyps": hyps_opt, **info}
