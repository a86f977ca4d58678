"""The synthetic ground-truth benchmark — data generation, the full
multi-method pipeline, and evaluation.

Parity map: `Synthetic_experiment/exprmt1_sampledata.m` (ground truth:
2 HMMs x 2 states, shared Gaussians at (0,0)/(3,3) with identity
covariance, transition matrices [.6 .4;.4 .6] vs [.4 .6;.6 .4];
datasets of 2 clusters x 20 HMMs x 25 seqs x T=50 plus N(0, 0.1)
noise), `exprmt1_demo.m` (VBEM -> VBHEM grid -> VHEM -> CCFD -> PPK),
and the recovery scoring of `syn_evluate.m` / `evaluate_vbhem_jounarl.m`
(Rand index, purity, P(K correct), P(S correct)).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import HEMConfig, VBConfig, VBHEMConfig
from ..containers import HMM, SeqBatch
from ..models import hmm_tools, vbhem, vbhmm, vhem
from ..utils.metrics import purity, rand_index


def gt_hmms(dtype=jnp.float64):
    """The two ground-truth HMMs (`exprmt1_sampledata.m:21-43`)."""
    mean = jnp.asarray([[0.0, 0.0], [3.0, 3.0]], dtype)
    cov = jnp.broadcast_to(jnp.eye(2, dtype=dtype), (2, 2, 2))
    prior = jnp.asarray([0.5, 0.5], dtype)
    h1 = HMM(prior=prior, trans=jnp.asarray([[0.6, 0.4], [0.4, 0.6]], dtype),
             mean=mean, cov=cov)
    h2 = HMM(prior=prior, trans=jnp.asarray([[0.4, 0.6], [0.6, 0.4]], dtype),
             mean=mean, cov=cov)
    return h1, h2


class SyntheticDataset(NamedTuple):
    batches: List[SeqBatch]     # one per subject (HMM)
    labels: np.ndarray          # [Kb] ground-truth cluster of each subject


def sample_dataset(key, n_per_cluster: int = 20, n_seqs: int = 25,
                   t: int = 50, noise: float = 0.1,
                   dtype=jnp.float64) -> SyntheticDataset:
    """Sample one dataset (`exprmt1_sampledata.m:51-87`)."""
    h1, h2 = gt_hmms(dtype)
    batches, labels = [], []
    for gi, h in enumerate([h1, h2]):
        for si in range(n_per_cluster):
            k = jax.random.fold_in(jax.random.fold_in(key, gi), si)
            _, x = hmm_tools.sample(k, h, t=t, n=n_seqs)
            x = x + noise * jax.random.normal(jax.random.fold_in(k, 99),
                                              x.shape, dtype)
            batches.append(SeqBatch(x=x, lengths=jnp.full((n_seqs,), t,
                                                          jnp.int32)))
            labels.append(gi)
    return SyntheticDataset(batches=batches, labels=np.asarray(labels))


def default_vb_config() -> VBConfig:
    """VBEM settings of `exprmt1_demo.m:28-47` (S=2, default hyps with
    the synthetic-data m0/W0).  ``learn_hyps`` is ON, matching
    `exprmt1_demo.m:38` (`vbopt.learn_hyps = 1`); the uniqueLL survivors
    that get hyp-optimized are capped at 5 per subject to bound the
    batched L-BFGS lane count (the reference optimizes every survivor)."""
    return VBConfig(mu0=(1.5, 1.5), w0=1.0, numtrials=20,
                    learn_hyps=True, max_hyp_solutions=5,
                    hyp_max_steps=50)


def default_vbhem_config(trials: int = 50) -> VBHEMConfig:
    """VBHEM settings of `exprmt1_demo.m:66-79`; ``learn_hyps`` is ON —
    the reference default (`vbhem_h3m_cluster.m:188`) — with the same
    5-survivor cap per grid cell as the VBEM stage."""
    return VBHEMConfig(alpha0=1e6, m0=(1.5, 1.5), w0=1.0, nv=100,
                       tau=50, trials=trials, initmode="baseem",
                       learn_hyps=True, max_hyp_solutions=5,
                       hyp_max_steps=50)


def learn_subject_hmms(key, ds: SyntheticDataset, s: int = 2,
                       config: Optional[VBConfig] = None):
    """Per-subject VBEM (`exprmt1_demo.m:47`, vbhmm_learn_batch).  Uses
    the fully batched bank learner (one program for all subjects' trials
    + one vmapped L-BFGS for every subject's hyp optimization) when the
    per-subject shapes are uniform, as they are for this benchmark."""
    from ..models import batch as batch_mod
    config = config or default_vb_config()
    shapes = {(int(b.x.shape[0]), int(b.x.shape[1])) for b in ds.batches}
    if len(shapes) == 1:
        results, _ = batch_mod.learn_bank(key, ds.batches, s, config)
        return results
    results = []
    for i, batch in enumerate(ds.batches):
        res, _ = vbhmm.learn(jax.random.fold_in(key, i), batch, s, config)
        results.append(res)
    return results


class RecoveryScore(NamedTuple):
    rand_index: float
    purity: float
    best_k: int
    best_s: int
    # hard labels of the selected model (for the Dunn index,
    # `evaluate_vbhem_jounarl.m:107-113`); None in old checkpoints
    labels: Optional[object] = None
    # per-surviving-cluster PRUNED state counts (the reference scores
    # S_select per cluster after vbh3m_remove_empty,
    # `evaluate_vbhem_jounarl.m:92-105`); None in old checkpoints and
    # for methods without per-cluster state selection
    s_list: Optional[object] = None


def run_vbhem(key, results, labels, k_grid=range(1, 7), s_grid=range(1, 6),
              config: Optional[VBHEMConfig] = None):
    """VBHEM over the (K,S) grid + recovery scoring
    (`exprmt1_demo.m:64-108` + `evaluate_vbhem_jounarl.m:86-118`).

    Uses the single-program padded sweep (`vbhem.cluster_batched`, one
    compile for the whole grid) when hyp learning is off and a single
    initmode is set; falls back to the per-cell path otherwise."""
    config = config or default_vbhem_config()
    base = vbhem.h3m_from_results(results, use_post=config.use_post,
                                  covar_type=config.covar_type)
    # single-program padded sweep; with learn_hyps the grid-level
    # vmapped L-BFGS runs on top (one lane per cell x solution); 'auto'
    # concatenates the three initmodes' trials
    res, info = vbhem.cluster_batched(key, base, list(k_grid),
                                      list(s_grid), config)
    # the reference scores K/S/labels AFTER vbh3m_remove_empty: K =
    # surviving clusters, S = each surviving HMM's PRUNED state count
    # (`evaluate_vbhem_jounarl.m:92-105`), not the selected grid cell
    res, hmm_list = vbhem.vbh3m_remove_empty(res)
    lab = np.asarray(res.label)
    ri, _, _, _ = rand_index(lab, labels)
    s_list = [int(h.model.prior.shape[0]) for h in hmm_list]
    return res, info, RecoveryScore(rand_index=ri,
                                    purity=purity(lab, labels),
                                    best_k=len(hmm_list),
                                    best_s=int(np.median(s_list)),
                                    labels=lab, s_list=s_list)


def run_vhem(key, results, labels, k: int = 2, s: int = 2,
             config: Optional[HEMConfig] = None):
    """VHEM baseline on the same bank (`exprmt1_demo.m:114-148`)."""
    config = config or HEMConfig(trials=20, nv=100, tau=10)
    base = vbhem.h3m_from_results(results, use_post=False)
    res = vhem.cluster(key, base, k, s, config)
    lab = np.asarray(res.label)
    ri, _, _, _ = rand_index(lab, labels)
    return res, RecoveryScore(rand_index=ri, purity=purity(lab, labels),
                              best_k=k, best_s=s, labels=lab)


# ---------------------------------------------------------------------------
# Baseline model selection (evaluate_vbhem_jounarl.m) and the full
# multi-method pipeline with per-stage checkpoints (exprmt1_demo.m)
# ---------------------------------------------------------------------------

def _vhem_expected_ll(res, nv: float) -> float:
    """log_ests of the VHEM AIC/BIC criteria
    (`evaluate_vbhem_jounarl.m:180-182`): the expected data
    log-likelihood reconstructed from the soft assignments Z and the
    per-pair lower bounds,
      sum_ij Z_ij (log omega_j - log Z_ij + Nv * L_elbo_ij)
    with omega_j = (1/Kb) sum_i Z_ij."""
    # host-side in f64: the 1e-50 / 1e-300 floors underflow to 0 in f32
    # (log -> -inf, 0 * -inf -> NaN) when the models were fit in float32
    z = np.asarray(res.z, np.float64)
    ll_elbo = np.asarray(res.ll_elbo, np.float64)
    omega = z.sum(axis=0) / z.shape[0]
    return float(np.sum(z * (np.log(omega + 1e-300)[None, :]
                             - np.log(z + 1e-50) + nv * ll_elbo)))


def _num_params(k: int, s: int, d: int) -> int:
    """Free parameters of a K-cluster, S-state, D-dim H3M
    (`evaluate_vbhem_jounarl.m:180,215`)."""
    return (k - 1) + k * ((s - 1) + s * (s - 1) + s * 2 * d)


def run_vhem_grid(key, results, labels, k_grid=range(1, 7),
                  s_grid=range(1, 6),
                  config: Optional[HEMConfig] = None) -> Dict:
    """VHEM over the (K,S) grid with AIC/BIC model selection
    (`exprmt1_demo.m:114-148` + `evaluate_vbhem_jounarl.m:160-239`)."""
    config = config or HEMConfig(trials=20, nv=100, tau=10)
    base = vbhem.h3m_from_results(results, use_post=False)
    kb = len(results)
    d = np.asarray(results[0].model.mean).shape[-1]
    n_bic = config.nv * kb * config.tau

    ks, ss = list(k_grid), list(s_grid)
    cells, aic, bic = {}, np.full((len(ks), len(ss)), np.inf), \
        np.full((len(ks), len(ss)), np.inf)
    for ki, k in enumerate(ks):
        for si, s in enumerate(ss):
            ck = jax.random.fold_in(jax.random.fold_in(key, ki), si)
            # identity shortcut disabled: its placeholder LogL/Z are not
            # comparable with trained cells' expected LL (AIC/BIC would
            # otherwise always select K == Kb when Kb is in the grid)
            res = vhem.cluster(ck, base, k, s, config,
                               allow_identity_shortcut=False)
            cells[(k, s)] = res
            log_ests = _vhem_expected_ll(res, config.nv)
            aic[ki, si] = 2 * (k * s * (s + 2 * d) - 1) - 2 * log_ests
            bic[ki, si] = (np.log(n_bic) * _num_params(k, s, d)
                           - 2 * log_ests)

    out = {"cells": cells, "aic": aic, "bic": bic,
           "k_grid": ks, "s_grid": ss}
    for crit, grid in (("aic", aic), ("bic", bic)):
        ki, si = np.unravel_index(np.argmin(grid), grid.shape)
        res = cells[(ks[ki], ss[si])]
        lab = np.asarray(res.label)
        # reference scoring (`evaluate_vbhem_jounarl.m:470-477`):
        # K_select = clusters with members, S_select = per nonempty
        # cluster the count of states with emit_vcounts > 1e-3
        sizes = np.bincount(lab, minlength=ks[ki])
        nonempty = np.where(sizes > 0)[0]
        ec = np.asarray(res.emit_counts)
        s_list = [int((ec[j] > 1e-3).sum()) for j in nonempty]
        out[crit + "_score"] = RecoveryScore(
            rand_index=rand_index(lab, labels)[0],
            purity=purity(lab, labels), best_k=len(nonempty),
            best_s=int(np.median(s_list)), labels=lab, s_list=s_list)
    return out


def run_vbhem_dic(info: Dict, base, tau: int, labels) -> Dict:
    """DIC model selection over the learned VBHEM grid cells
    (`myDIC.m`; min-DIC selection of `evaluate_vbhem_jounarl.m:124-152`).
    Uses the vb path (synthetic=False): the reference's own synthetic
    evaluation calls `myDIC(hmms, vbh3mj, T, div_T)` with `issyn`
    defaulting to 0 (`evaluate_vbhem_jounarl.m:148`)."""
    from ..models.dic import dic
    ks = sorted({k for k, _ in info["model_all"]})
    ss = sorted({s for _, s in info["model_all"]})
    dics = np.full((len(ks), len(ss)), np.inf)
    for ki, k in enumerate(ks):
        for si, s in enumerate(ss):
            if (k, s) in info["model_all"]:
                _, dval = dic(base, info["model_all"][(k, s)], tau)
                dics[ki, si] = dval
    ki, si = np.unravel_index(np.argmin(dics), dics.shape)
    # reference prunes the DIC-selected cell before scoring
    # (`evaluate_vbhem_jounarl.m:516-533`: vbh3m_remove_empty, then
    # K_select = surviving clusters, S_select = pruned state counts)
    res, hmm_list = vbhem.vbh3m_remove_empty(
        info["model_all"][(ks[ki], ss[si])])
    lab = np.asarray(res.label)
    s_list = [int(h.model.prior.shape[0]) for h in hmm_list]
    return {"dic": dics, "score": RecoveryScore(
        rand_index=rand_index(lab, labels)[0], purity=purity(lab, labels),
        best_k=len(hmm_list), best_s=int(np.median(s_list)),
        labels=lab, s_list=s_list)}


def run_ccfd(key, results, labels, ds: Optional[SyntheticDataset] = None,
             n_samples: int = 100) -> Dict:
    """CCFD density-peak clustering on symmetric-KL distances
    (`exprmt1_demo.m:155-178`).  K is selected automatically by the
    outlier detection, S is the subject-HMM state count."""
    from ..models import ccfd as ccfd_mod
    hmms = [r.model for r in results]
    data = ds.batches if ds is not None else None
    res = ccfd_mod.ccfd(key, hmms, data=data, n_samples=n_samples)
    lab = res.label
    s = np.asarray(results[0].model.mean).shape[0]
    return {"result": res, "score": RecoveryScore(
        rand_index=rand_index(lab, labels)[0], purity=purity(lab, labels),
        best_k=int(lab.max()) + 1, best_s=s, labels=lab)}


def run_ppk_grid(key, banks_by_s: Dict[int, list], ds: SyntheticDataset,
                 labels, k_grid=range(1, 7)) -> Dict:
    """PPK spectral clustering over the (K,S) grid with AIC/BIC selection
    from the held-in data log-likelihood
    (`exprmt1_demo.m:180-258` + `evaluate_vbhem_jounarl.m:239-296`)."""
    from ..models import ppk as ppk_mod
    ks = list(k_grid)
    ss = sorted(banks_by_s)
    d = np.asarray(banks_by_s[ss[0]][0].model.mean).shape[-1]
    t_mean = float(np.mean([np.asarray(b.lengths).mean()
                            for b in ds.batches]))
    n_obs = int(sum(np.asarray(b.lengths).sum() for b in ds.batches))

    # all sequences as one batch; per-bank loglik table under EVERY
    # bank HMM in one dispatch (the reference loops center HMMs x
    # subjects, exprmt1_demo.m:236-251)
    all_x = jnp.concatenate([b.x for b in ds.batches], axis=0)
    all_len = jnp.concatenate([b.lengths for b in ds.batches], axis=0)
    all_batch = SeqBatch(x=all_x, lengths=all_len)

    def bank_ll_table(hmms):
        from ..models.vbhem import h3m_from_hmms
        hb = h3m_from_hmms(list(hmms)).hmm

        def one(p, a, m, c):
            return hmm_tools.loglik(all_batch,
                                    HMM(prior=p, trans=a, mean=m, cov=c))
        return np.asarray(jax.jit(jax.vmap(one))(
            hb.prior, hb.trans, hb.mean, hb.cov))     # [n_hmms, n_seqs]

    cells, ll_grid = {}, np.full((len(ks), len(ss)), -np.inf)
    for si, s in enumerate(ss):
        hmms = [r.model for r in banks_by_s[s]]
        gram = ppk_mod.gram_matrix(hmms)
        ll_table = bank_ll_table(hmms)
        for ki, k in enumerate(ks):
            ck = jax.random.fold_in(jax.random.fold_in(key, ki), si)
            assign, centers, u = ppk_mod.spectral_cluster(ck, gram, k)
            # cluster centers: the input HMM nearest each spectral centroid
            center_idx = np.zeros((k,), np.int64)
            for j in range(k):
                members = np.where(assign == j)[0]
                pool = members if len(members) else np.arange(len(hmms))
                d2 = ((u[pool] - centers[j]) ** 2).sum(axis=1)
                center_idx[j] = pool[int(np.argmin(d2))]
            weight = np.array([(assign == j).mean() for j in range(k)])
            # data log-likelihood under the mixture of center HMMs
            # (exprmt1_demo.m:236-251)
            lls = ll_table[center_idx].T             # [n_seqs, K]
            mix = np.log(weight + 1e-300)[None, :] + lls
            mx = mix.max(axis=1)
            ll = float(np.sum(mx + np.log(
                np.exp(mix - mx[:, None]).sum(axis=1))))
            cells[(k, s)] = {"label": assign, "center_idx": center_idx,
                             "ll": ll}
            ll_grid[ki, si] = ll

    out = {"cells": cells, "ll": ll_grid, "k_grid": ks, "s_grid": ss}
    for crit in ("aic", "bic"):
        grid = np.full_like(ll_grid, np.inf)
        for ki, k in enumerate(ks):
            for si, s in enumerate(ss):
                pars = _num_params(k, s, d)
                pen = 2 * pars if crit == "aic" else np.log(n_obs) * pars
                grid[ki, si] = -2 * ll_grid[ki, si] + pen
        ki, si = np.unravel_index(np.argmin(grid), grid.shape)
        lab = cells[(ks[ki], ss[si])]["label"]
        out[crit] = grid
        out[crit + "_score"] = RecoveryScore(
            rand_index=rand_index(lab, labels)[0],
            purity=purity(lab, labels), best_k=ks[ki], best_s=ss[si],
            labels=lab)
    return out
