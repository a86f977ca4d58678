"""The full synthetic benchmark driver: multiple seeded repeats of the
multi-method pipeline with per-stage checkpoints and aggregate recovery
statistics.

Parity map: `Synthetic_experiment/exprmt1_demo.m` (the staged pipeline,
with `.mat` checkpoints after every stage and repeat,
`exprmt1_demo.m:58-60,96-102,136-142,176-178,256-258`) and the
aggregation of `syn_evluate.m` / `evaluate_vbhem_jounarl.m:450-655`
(Rand index, purity, P(K correct/over/under), P(S correct/over/under)
per method/criterion).

Checkpoints are one pickle per (repeat, stage) in ``outdir``; a rerun
with the same outdir resumes after the last completed stage — the
equivalent of the reference's save/load `.mat` discipline.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import time
from typing import Dict, List, Optional

import jax
import numpy as np

from ..config import HEMConfig, VBConfig, VBHEMConfig
from . import synthetic as syn

GT_K, GT_S = 2, 2

STAGES = ("data", "vbem", "vbhem", "vhem", "ccfd", "ppk", "dist")


def _ckpt_path(outdir: str, repeat: int, stage: str) -> str:
    return os.path.join(outdir, f"r{repeat:03d}_{stage}.pkl")


def _load(outdir: str, repeat: int, stage: str):
    p = _ckpt_path(outdir, repeat, stage)
    if os.path.exists(p):
        with open(p, "rb") as f:
            return pickle.load(f)
    return None


def load_checkpoint(outdir: str, repeat: int, stage: str):
    """Public checkpoint loader (one pickle per (repeat, stage));
    returns None when that stage has not completed."""
    return _load(outdir, repeat, stage)


def _meta_path(outdir: str, repeat: int) -> str:
    return os.path.join(outdir, f"r{repeat:03d}_meta.json")


def _scale_meta(n_per_cluster, n_seqs, t, k_grid, s_grid, dtype) -> Dict:
    """Run-scale descriptor written alongside each repeat's checkpoints
    so aggregates can't silently pool repeats run at different scales.
    ``dtype`` is informational (cross-precision pooling of the SAME
    scale is an intentional consistency check); the scale keys are the
    grouping config."""
    return {"n_per_cluster": int(n_per_cluster), "n_seqs": int(n_seqs),
            "t": int(t), "k_grid": [int(k) for k in k_grid],
            "s_grid": [int(s) for s in s_grid], "dtype": dtype}


def _write_meta(outdir: str, repeat: int, meta: Dict) -> None:
    p = _meta_path(outdir, repeat)
    _NON_SCALE_KEYS = ("dtype", "provenance")
    old = _load_meta(outdir, repeat)
    if old is not None:
        old_scale = {k: v for k, v in old.items() if k not in _NON_SCALE_KEYS}
        new_scale = {k: v for k, v in meta.items() if k not in _NON_SCALE_KEYS}
        if old_scale != new_scale:
            raise ValueError(
                f"repeat {repeat} in {outdir} was checkpointed at a "
                f"different scale ({old_scale} != {new_scale}); refusing "
                f"to mix — use a fresh outdir")
        if old.get("provenance") == meta.get("provenance"):
            return
        # upgrade in place: same scale, new/changed provenance stamp
        meta = dict(old, provenance=meta.get("provenance"))
    # tmp+rename: a worker killed mid-write must not truncate the meta
    tmp = p + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, p)


def _load_meta(outdir: str, repeat: int) -> Optional[Dict]:
    p = _meta_path(outdir, repeat)
    if os.path.exists(p):
        try:
            with open(p) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError):
            return None
    return None


def _bank_provenance(outdir: str, repeat: int, banks_obj) -> Dict:
    """Identity + creating-code-version of a repeat's VBEM bank.

    ``bank_version`` is read from inside the stage pickle (written since
    round 5); banks checkpointed by earlier code report "pre-r5" — the
    aggregate segregates those so a stale bank can never silently feed a
    headline parity number (the reference's per-iteration .mat
    provenance discipline, `exprmt1_demo.m:96-102`)."""
    import hashlib
    p = _ckpt_path(outdir, repeat, "vbem")
    h = None
    if os.path.exists(p):
        sha = hashlib.sha256()
        with open(p, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                sha.update(chunk)
        h = sha.hexdigest()[:16]
    version = banks_obj.get("bank_version") if isinstance(banks_obj, dict) \
        and "banks" in banks_obj else "pre-r5"
    return {"bank_sha256": h, "bank_version": version}


def _save(outdir: str, repeat: int, stage: str, obj) -> None:
    p = _ckpt_path(outdir, repeat, stage)
    tmp = p + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, p)


def run_repeat(repeat: int, outdir: str,
               n_per_cluster: int = 20, n_seqs: int = 25, t: int = 50,
               k_grid=range(1, 7), s_grid=range(1, 6),
               vb_config: Optional[VBConfig] = None,
               vbhem_config: Optional[VBHEMConfig] = None,
               hem_config: Optional[HEMConfig] = None,
               methods=("vbhem", "vhem", "ccfd", "ppk"),
               verbose: bool = True, dtype: str = "f64") -> Dict:
    """One repeat of the benchmark (`exprmt1_demo.m` outer iteration,
    seeded `rng(it)`-style by folding the repeat index)."""
    key = jax.random.key(repeat)
    scores: Dict[str, syn.RecoveryScore] = {}
    timings: Dict[str, float] = {}
    _write_meta(outdir, repeat,
                _scale_meta(n_per_cluster, n_seqs, t, k_grid, s_grid,
                            dtype))

    def log(msg):
        if verbose:
            print(f"[repeat {repeat}] {msg}", flush=True)

    # ---- data (exprmt1_sampledata.m) ----
    ds = _load(outdir, repeat, "data")
    if ds is None:
        ds = syn.sample_dataset(jax.random.fold_in(key, 0),
                                n_per_cluster=n_per_cluster,
                                n_seqs=n_seqs, t=t)
        _save(outdir, repeat, "data", ds)
    import jax.numpy as jnp
    want = jnp.float32 if dtype == "f32" else jnp.float64
    if ds.batches[0].x.dtype != want:
        # cast checkpointed data to the requested compute precision
        # (f32 on the GPU; datasets are generated/stored in f64)
        ds = syn.SyntheticDataset(
            batches=[type(b)(x=jnp.asarray(np.asarray(b.x), want),
                             lengths=b.lengths) for b in ds.batches],
            labels=ds.labels)
    labels = ds.labels

    # ---- per-subject VBEM, one bank per S for PPK (exprmt1_demo.m:47) ----
    banks_obj = _load(outdir, repeat, "vbem")
    banks = banks_obj.get("banks") if isinstance(banks_obj, dict) \
        and "banks" in banks_obj else banks_obj
    if banks is None:
        t0 = time.time()
        vb_cfg = vb_config or syn.default_vb_config()
        banks = {}
        s_list = sorted(set([GT_S]) | set(s_grid)) if "ppk" in methods \
            else [GT_S]
        for s in s_list:
            # per-S sub-checkpoints so a killed worker resumes mid-stage
            bank = _load(outdir, repeat, f"vbem_s{s}")
            if bank is None:
                log(f"VBEM bank S={s}")
                bank = syn.learn_subject_hmms(
                    jax.random.fold_in(key, 100 + s), ds, s=s,
                    config=vb_cfg)
                _save(outdir, repeat, f"vbem_s{s}", bank)
            banks[s] = bank
        timings["vbem"] = time.time() - t0
        # bank provenance travels INSIDE the stage pickle (version of
        # the code that produced it), so aggregates can segregate
        # banks that predate correctness fixes
        from .. import __version__
        banks_obj = {"banks": banks, "bank_version": __version__}
        _save(outdir, repeat, "vbem", banks_obj)
        for s in s_list:   # sub-checkpoints subsumed by the stage pickle
            try:
                os.remove(_ckpt_path(outdir, repeat, f"vbem_s{s}"))
            except OSError:
                pass
    _write_meta(outdir, repeat,
                dict(_scale_meta(n_per_cluster, n_seqs, t, k_grid, s_grid,
                                 dtype),
                     provenance=_bank_provenance(outdir, repeat, banks_obj)))
    results = banks[GT_S]

    # ---- VBHEM over the (K,S) grid (exprmt1_demo.m:64-108) ----
    if "vbhem" in methods:
        try:
            st = _load(outdir, repeat, "vbhem")
            if st is None:
                t0 = time.time()
                log("VBHEM grid")
                res, info, score = syn.run_vbhem(
                    jax.random.fold_in(key, 1), results, labels,
                    k_grid=k_grid, s_grid=s_grid, config=vbhem_config)
                grid_elapsed = time.time() - t0  # ELBO-converged grid
                base = syn.vbhem.h3m_from_results(
                    results, use_post=(vbhem_config or
                                       syn.default_vbhem_config()).use_post)
                cfg = vbhem_config or syn.default_vbhem_config()
                dic_out = syn.run_vbhem_dic(info, base, cfg.tau, labels)
                st = {"score": score, "dic_score": dic_out["score"],
                      "dic": dic_out["dic"], "model_ll": info["model_ll"],
                      # restart budget this grid ran with (the reference
                      # default is 100, `vbhem_h3m_cluster.m:159`)
                      "trials": cfg.trials,
                      # pruned selected model (small) so checkpoints can
                      # be RE-scored if scoring semantics evolve
                      "result": res,
                      # grid sweep only (the BASELINE.md wall-clock-to-
                      # ELBO-convergence metric); the extra DIC pass is
                      # timed separately
                      "elapsed": grid_elapsed,
                      "elapsed_with_dic": time.time() - t0}
                _save(outdir, repeat, "vbhem", st)
            scores["vbhem"] = st["score"]
            scores["vbhem_dic"] = st["dic_score"]
            timings["vbhem"] = st["elapsed"]
        except Exception as e:  # noqa: BLE001 — stage isolation
            log(f"vbhem FAILED: {e!r}")
            timings["vbhem_error"] = repr(e)
    # ---- VHEM grid + AIC/BIC (exprmt1_demo.m:114-148) ----
    if "vhem" in methods:
        try:
            st = _load(outdir, repeat, "vhem")
            if st is None:
                t0 = time.time()
                log("VHEM grid")
                out = syn.run_vhem_grid(jax.random.fold_in(key, 2), results,
                                        labels, k_grid=k_grid, s_grid=s_grid,
                                        config=hem_config)
                st = {"aic_score": out["aic_score"],
                      "bic_score": out["bic_score"], "aic": out["aic"],
                      "bic": out["bic"], "elapsed": time.time() - t0}
                _save(outdir, repeat, "vhem", st)
            scores["vhem_aic"] = st["aic_score"]
            scores["vhem_bic"] = st["bic_score"]
            timings["vhem"] = st["elapsed"]
        except Exception as e:  # noqa: BLE001 — stage isolation
            log(f"vhem FAILED: {e!r}")
            timings["vhem_error"] = repr(e)
    # ---- CCFD (exprmt1_demo.m:155-178) ----
    if "ccfd" in methods:
        try:
            st = _load(outdir, repeat, "ccfd")
            if st is None:
                t0 = time.time()
                log("CCFD")
                out = syn.run_ccfd(jax.random.fold_in(key, 3), results,
                                   labels, ds=ds)
                st = {"score": out["score"], "elapsed": time.time() - t0}
                _save(outdir, repeat, "ccfd", st)
            scores["ccfd"] = st["score"]
            timings["ccfd"] = st["elapsed"]
        except Exception as e:  # noqa: BLE001 — stage isolation
            log(f"ccfd FAILED: {e!r}")
            timings["ccfd_error"] = repr(e)
    # ---- PPK grid + AIC/BIC (exprmt1_demo.m:180-258) ----
    if "ppk" in methods:
        try:
            st = _load(outdir, repeat, "ppk")
            if st is None:
                t0 = time.time()
                log("PPK grid")
                out = syn.run_ppk_grid(jax.random.fold_in(key, 4), banks, ds,
                                       labels, k_grid=k_grid)
                st = {"aic_score": out["aic_score"],
                      "bic_score": out["bic_score"], "ll": out["ll"],
                      "elapsed": time.time() - t0}
                _save(outdir, repeat, "ppk", st)
            scores["ppk_aic"] = st["aic_score"]
            scores["ppk_bic"] = st["bic_score"]
            timings["ppk"] = st["elapsed"]
        except Exception as e:  # noqa: BLE001 — stage isolation
            log(f"ppk FAILED: {e!r}")
            timings["ppk_error"] = repr(e)

    # ---- Dunn index per method from SKLD distances between the subject
    # HMMs (`evaluate_vbhem_jounarl.m:107-113`) ----
    dunn = {}
    try:
        from ..models import ccfd as ccfd_mod
        from ..utils.metrics import dunn_index
        dmat = _load(outdir, repeat, "dist")
        if dmat is None:
            hmms = [r.model for r in results]
            dmat = ccfd_mod.skl_distance_matrix(
                jax.random.fold_in(key, 5), hmms, data=ds.batches)
            _save(outdir, repeat, "dist", dmat)
        for m, sc in scores.items():
            lab = getattr(sc, "labels", None)
            if lab is None:
                continue
            lab = np.asarray(lab)
            # undefined for one cluster or all-singletons (max intra
            # diameter 0 -> inf, which is not valid strict JSON)
            if 1 < len(np.unique(lab)) < len(lab):
                d = float(dunn_index(dmat, lab))
                if np.isfinite(d):
                    dunn[m] = d
    except Exception as e:  # noqa: BLE001 — stage isolation
        log(f"dunn FAILED: {e!r}")
        timings["dunn_error"] = repr(e)
    return {"scores": scores, "timings": timings, "dunn": dunn}


def aggregate(per_repeat: List[Dict]) -> Dict:
    """Recovery statistics per method across repeats
    (`evaluate_vbhem_jounarl.m:450-655`)."""
    methods = sorted({m for r in per_repeat for m in r["scores"]})
    summary = {}
    for m in methods:
        ss = [r["scores"][m] for r in per_repeat if m in r["scores"]]
        ks = np.array([s.best_k for s in ss])

        def s_stat(op):
            # the reference's is_S_* are per-repeat FRACTIONS of
            # surviving clusters (`evaluate_vbhem_jounarl.m:104-106`)
            # when per-cluster pruned state counts are available
            vals = []
            for s in ss:
                sl = getattr(s, "s_list", None)
                if sl:
                    vals.append(float(np.mean(op(np.asarray(sl)))))
                else:
                    vals.append(float(op(np.asarray(s.best_s))))
            return float(np.mean(vals))

        summary[m] = {
            "rand_index_mean": float(np.mean([s.rand_index for s in ss])),
            "purity_mean": float(np.mean([s.purity for s in ss])),
            "p_k_correct": float(np.mean(ks == GT_K)),
            "p_k_over": float(np.mean(ks > GT_K)),
            "p_k_under": float(np.mean(ks < GT_K)),
            "p_s_correct": s_stat(lambda v: v == GT_S),
            "p_s_over": s_stat(lambda v: v > GT_S),
            "p_s_under": s_stat(lambda v: v < GT_S),
            "n_repeats": len(ss),
        }
        dunns = [r["dunn"][m] for r in per_repeat
                 if m in r.get("dunn", {})
                 and np.isfinite(r["dunn"][m])]
        if dunns:
            summary[m]["dunn_mean"] = float(np.mean(dunns))
    return summary


def aggregate_from_checkpoints(outdir: str, n_repeats: int = 10,
                               exclude_repeats=()) -> Dict:
    """Aggregate whatever (repeat, stage) checkpoints exist in ``outdir``
    WITHOUT running anything — for summarizing a partially completed
    multi-worker run.  Repeats with no completed method stages are
    skipped.

    Repeats checkpointed at DIFFERENT scales (per their ``r*_meta.json``
    sidecars) are SEGREGATED: the result then maps each scale config to
    its own summary instead of silently pooling them into one recovery
    statistic.  Repeats with no meta sidecar (pre-meta snapshots) group
    under "unknown".  Mixed dtypes within one scale are pooled (an
    intentional cross-precision consistency check) but reported.

    ``exclude_repeats`` removes known-bad repeats (e.g. a bank produced
    by code that predates a correctness fix) from every summary; they
    are still reported under ``"excluded"`` with their own statistics so
    nothing is silently dropped.  Each group also reports per-repeat
    bank provenance from the meta sidecars."""
    exclude = set(int(r) for r in exclude_repeats)
    groups: Dict[str, Dict] = {}
    excluded: Dict[str, Dict] = {}
    for r in range(n_repeats):
        scores_r = _collect_repeat_scores(outdir, r)
        if not scores_r:
            continue
        meta = _load_meta(outdir, r)
        if r in exclude:
            excluded[str(r)] = {
                "provenance": (meta or {}).get("provenance"),
                "summary": aggregate([scores_r])}
            continue
        key = ("unknown" if meta is None else json.dumps(
            {k: v for k, v in meta.items()
             if k not in ("dtype", "provenance")},
            sort_keys=True))
        g = groups.setdefault(key, {"per_repeat": [], "repeats": [],
                                    "dtypes": {}, "provenance": {}})
        g["per_repeat"].append(scores_r)
        g["repeats"].append(r)
        if meta is not None:
            g["dtypes"][str(r)] = meta.get("dtype")
            if meta.get("provenance") is not None:
                g["provenance"][str(r)] = meta["provenance"]
    if not groups:
        return {"excluded": excluded} if excluded else {}
    if len(groups) == 1:
        out = aggregate(next(iter(groups.values()))["per_repeat"])
        g = next(iter(groups.values()))
        if g["provenance"]:
            out["provenance"] = g["provenance"]
        if excluded:
            out["excluded"] = excluded
        return out
    out = {"mixed_configs": True,
           "groups": {k: {"repeats": g["repeats"],
                          "dtypes": g["dtypes"],
                          "provenance": g["provenance"],
                          "summary": aggregate(g["per_repeat"])}
                      for k, g in groups.items()}}
    if excluded:
        out["excluded"] = excluded
    return out


def _collect_repeat_scores(outdir: str, r: int) -> Optional[Dict]:
    """Scores + Dunn for one repeat from its stage checkpoints, or None
    when no method stage has completed."""
    scores, dunn = {}, {}
    st = _load(outdir, r, "vbhem")
    if st is not None:
        scores["vbhem"] = st["score"]
        scores["vbhem_dic"] = st["dic_score"]
    st = _load(outdir, r, "vhem")
    if st is not None:
        scores["vhem_aic"] = st["aic_score"]
        scores["vhem_bic"] = st["bic_score"]
    st = _load(outdir, r, "ccfd")
    if st is not None:
        scores["ccfd"] = st["score"]
    st = _load(outdir, r, "ppk")
    if st is not None:
        scores["ppk_aic"] = st["aic_score"]
        scores["ppk_bic"] = st["bic_score"]
    dmat = _load(outdir, r, "dist")
    if dmat is not None:
        from ..utils.metrics import dunn_index
        for m, sc in scores.items():
            lab = getattr(sc, "labels", None)
            if lab is None:
                continue
            lab = np.asarray(lab)
            if 1 < len(np.unique(lab)) < len(lab):
                d = float(dunn_index(dmat, lab))
                if np.isfinite(d):
                    dunn[m] = d
    if not scores:
        return None
    return {"scores": scores, "timings": {}, "dunn": dunn}


def run_experiment(outdir: str, n_repeats: int = 10,
                   repeat_ids: Optional[List[int]] = None, **kwargs) -> Dict:
    """All repeats + aggregation; resumable via the per-stage pickles.
    ``repeat_ids`` restricts to a subset (so several processes can split
    the repeats over one shared ``outdir``; a final full-range rerun
    aggregates everything from the checkpoints)."""
    os.makedirs(outdir, exist_ok=True)
    ids = list(repeat_ids) if repeat_ids is not None else list(
        range(n_repeats))
    per_repeat = []
    for r in ids:
        per_repeat.append(run_repeat(r, outdir, **kwargs))
    summary = aggregate(per_repeat)
    with open(os.path.join(outdir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary
