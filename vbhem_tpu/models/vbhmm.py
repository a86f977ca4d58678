"""VBEM learning of a single Gaussian-emission HMM (the reference's L2
engine, `src/hmm/`).

Pipeline parity map (reference file -> function here):
  * `vbhmm_learn.m`    -> :func:`learn` (restarts, model selection over K)
  * `vbhmm_em.m`       -> :func:`vbem_em` (the EM loop)
  * `vbhmm_fb.m` + MEX -> :mod:`..ops.fb`
  * `vbhmm_em_lb.m`    -> :func:`elbo` (8 Bishop-ch.10 terms)
  * `vbhmm_init.m`     -> :func:`init_from_gmm` / :func:`random_init`

Design deltas: restarts are a vmapped leading axis instead of
a `parfor` loop; sequences are a dense masked batch; the EM loop is a
`lax.while_loop` so the whole fit is one compiled program.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from ..config import VBConfig
from ..containers import HMM, HMMPosterior, NIW, SeqBatch, VBHMMResult
from ..ops.fb import FBStats, expected_log_gauss
from ..ops.fb_pallas import forward_backward_auto
from ..ops.gmm import fit_gmm
from ..utils.numeric import (e_log_det_lambda, e_log_dirichlet, inv_psd,
                             log_dirichlet_const, log_wishart_b, logdet_psd,
                             sym, tiny)


class VBHyps(NamedTuple):
    """Prior hyperparameters as a differentiable pytree (the learnable set
    of `get_hypinfo.m`)."""
    alpha0: jnp.ndarray    # scalar
    epsilon0: jnp.ndarray  # scalar
    beta0: jnp.ndarray     # scalar
    v0: jnp.ndarray        # scalar
    m0: jnp.ndarray        # [D]
    w0: jnp.ndarray        # [D] diagonal of W0 (iid = constant diagonal)

    @property
    def w0inv_diag(self) -> jnp.ndarray:
        return 1.0 / self.w0

    @classmethod
    def from_config(cls, config: VBConfig, dim: int, dtype=jnp.float64):
        w0 = config.w0
        w0 = tuple(w0) if isinstance(w0, (tuple, list)) else (w0,) * dim
        return cls(
            alpha0=jnp.asarray(config.alpha0, dtype),
            epsilon0=jnp.asarray(config.epsilon0, dtype),
            beta0=jnp.asarray(config.beta0, dtype),
            v0=jnp.asarray(config.v0, dtype),
            m0=jnp.asarray(config.default_mu0(dim), dtype),
            w0=jnp.asarray(w0, dtype),
        )


class SuffStats(NamedTuple):
    """Masked sufficient statistics of the E-step (`vbhmm_em.m:158-246`)."""
    nk1: jnp.ndarray    # [K] initial-state counts (no floor)
    nk: jnp.ndarray     # [K] state counts (floored)
    m_trans: jnp.ndarray  # [K, K] transition counts
    xbar: jnp.ndarray   # [K, D] weighted means
    s: jnp.ndarray      # [K, D, D] weighted scatter (normalized by nk)


def e_step(batch: SeqBatch, post: HMMPosterior) -> FBStats:
    log_rho = expected_log_gauss(batch.x, post.niw)
    log_pz1 = e_log_dirichlet(post.alpha)
    log_trans = e_log_dirichlet(post.epsilon)
    return forward_backward_auto(log_pz1, log_trans, log_rho, batch.mask)


def suff_stats(batch: SeqBatch, fb: FBStats) -> SuffStats:
    """Accumulate masked statistics with batched matmuls
    (`vbhmm_em.m:158-246`; the data-block matmul trick at :210-246)."""
    dtype = batch.x.dtype
    gamma = fb.gamma                           # [N, T, K], already masked
    nk1 = jnp.sum(gamma[:, 0, :], axis=0)
    nk = jnp.sum(gamma, axis=(0, 1)) + tiny(dtype)
    m_trans = jnp.sum(fb.xi_sum, axis=0)
    xbar = jnp.einsum("ntk,ntd->kd", gamma, batch.x) / nk[:, None]
    m2 = jnp.einsum("ntk,ntd,nte->kde", gamma, batch.x, batch.x) / nk[:, None, None]
    s = sym(m2 - xbar[:, :, None] * xbar[:, None, :])
    return SuffStats(nk1=nk1, nk=nk, m_trans=m_trans, xbar=xbar, s=s)


def m_step(stats: SuffStats, hyps: VBHyps,
           covar_type: str = "full") -> HMMPosterior:
    """Conjugate Dirichlet/NIW updates (`vbhmm_em.m:352-408`).

    ``covar_type='diag'`` constrains the Wishart scale to diagonal
    matrices, following the VBHEM layer's diag convention
    (`vbhem_mstep_component.m:55-63`: scatter enters as diag(S), and the
    stored W is diag of the inverse); downstream E-step/ELBO formulas
    are unchanged because the reference itself embeds the diag vector
    back into a diagonal matrix (`vbhemh3m_lb.m:127`)."""
    dtype = stats.xbar.dtype
    d = stats.xbar.shape[-1]
    alpha = hyps.alpha0 + stats.nk1 + tiny(dtype)
    epsilon = hyps.epsilon0 + stats.m_trans
    beta = hyps.beta0 + stats.nk
    v = hyps.v0 + stats.nk + 1.0
    m = (hyps.beta0 * hyps.m0[None, :] + stats.nk[:, None] * stats.xbar) / beta[:, None]
    mult1 = hyps.beta0 * stats.nk / (hyps.beta0 + stats.nk)          # [K]
    diff3 = stats.xbar - hyps.m0[None, :]                            # [K, D]
    w0inv = jnp.diag(hyps.w0inv_diag.astype(dtype))
    s = stats.s
    if covar_type == "diag":
        s = s * jnp.eye(d, dtype=dtype)
    winv = (w0inv[None] + stats.nk[:, None, None] * s
            + mult1[:, None, None] * diff3[:, :, None] * diff3[:, None, :])
    w = inv_psd(winv)
    if covar_type == "diag":
        w = w * jnp.eye(d, dtype=dtype)
    return HMMPosterior(alpha=alpha, epsilon=epsilon,
                        niw=NIW(beta=beta, v=v, m=m, w=w))


def elbo(batch: SeqBatch, post: HMMPosterior, fb: FBStats,
         stats: SuffStats, hyps: VBHyps) -> jnp.ndarray:
    """Variational lower bound: the 8 terms of `vbhmm_em_lb.m:120-257`."""
    dtype = batch.x.dtype
    k = post.num_states
    d = batch.x.shape[-1]
    niw = post.niw

    log_lam = e_log_det_lambda(niw.v, niw.w)               # [K]
    log_pi = e_log_dirichlet(post.alpha)                   # [K]
    log_a = e_log_dirichlet(post.epsilon)                  # [K, K]

    logdet_w0inv = jnp.sum(jnp.log(hyps.w0inv_diag))
    log_c_alpha0 = gammaln(k * hyps.alpha0) - k * gammaln(hyps.alpha0)
    log_c_eps0 = gammaln(k * hyps.epsilon0) - k * gammaln(hyps.epsilon0)
    log_b0 = log_wishart_b(logdet_w0inv, hyps.v0, d)

    # per-state quadratic/trace statistics (vbhmm_em_lb.m:106-118)
    tr_sw = jnp.einsum("kde,ked->k", stats.s, niw.w)
    dxb = stats.xbar - niw.m
    xbar_w_xbar = jnp.einsum("kd,kde,ke->k", dxb, niw.w, dxb)
    dm = niw.m - hyps.m0[None, :]
    m_w_m = jnp.einsum("kd,kde,ke->k", dm, niw.w, dm)
    w0inv_diag = hyps.w0inv_diag.astype(dtype)
    tr_w0inv_w = jnp.einsum("d,kdd->k", w0inv_diag, niw.w)

    two_pi = jnp.asarray(2.0 * jnp.pi, dtype)

    # Lt1: E[log p(X|Z, mu, Lambda)], Bishop 10.71
    lt1 = 0.5 * jnp.sum(stats.nk * (log_lam - d / niw.beta - niw.v * tr_sw
                                    - niw.v * xbar_w_xbar - d * jnp.log(two_pi)))
    # Lt2: E[log p(Z|pi, A)], Bishop 10.72
    lt2a = jnp.sum(stats.nk1 * log_pi)
    lt2b = jnp.sum(stats.m_trans * log_a)
    lt2 = lt2a + lt2b
    # Lt3 / Lt4: E[log p(pi)], E[log p(A)], Bishop 10.73
    lt3 = log_c_alpha0 + (hyps.alpha0 - 1.0) * jnp.sum(log_pi)
    lt4 = k * log_c_eps0 + (hyps.epsilon0 - 1.0) * jnp.sum(log_a)
    # Lt5: E[log p(mu, Lambda)], Bishop 10.74
    lt51 = 0.5 * jnp.sum(d * jnp.log(hyps.beta0 / two_pi) + log_lam
                         - d * hyps.beta0 / niw.beta
                         - hyps.beta0 * niw.v * m_w_m)
    lt52 = (k * log_b0 + 0.5 * (hyps.v0 - d - 1.0) * jnp.sum(log_lam)
            - 0.5 * jnp.sum(niw.v * tr_w0inv_w))
    lt5 = lt51 + lt52
    # Lt6: E[log q(Z)] using the FB normalizer (vbhmm_em_lb.m:203-221)
    lt63 = jnp.sum(fb.gamma * fb.log_rho)
    lt64 = jnp.sum(fb.phi_norm)
    lt6 = lt2a + lt2b + lt63 - lt64
    # Lt7: E[log q(pi, A)], Bishop 10.76
    lt71 = jnp.sum((post.alpha - 1.0) * log_pi) + log_dirichlet_const(post.alpha)
    lt72 = jnp.sum(jnp.sum((post.epsilon - 1.0) * log_a, -1)
                   + log_dirichlet_const(post.epsilon))
    lt7 = lt71 + lt72
    # Lt8: E[log q(mu, Lambda)], Bishop 10.77
    log_bk = log_wishart_b(-logdet_psd(niw.w), niw.v, d)
    h_ent = jnp.sum(-log_bk - 0.5 * (niw.v - d - 1.0) * log_lam + 0.5 * niw.v * d)
    lt8 = 0.5 * jnp.sum(log_lam + d * jnp.log(niw.beta / two_pi)) \
        - 0.5 * d * k - h_ent

    return lt1 + lt2 + lt3 + lt4 + lt5 - lt6 - lt7 - lt8


class EMState(NamedTuple):
    post: HMMPosterior
    ll: jnp.ndarray
    last_ll: jnp.ndarray
    it: jnp.ndarray
    gamma: jnp.ndarray
    stats: SuffStats
    done: jnp.ndarray


def vbem_em(batch: SeqBatch, init_post: HMMPosterior, hyps: VBHyps,
            max_iter: int = 100, min_diff: float = 1e-5,
            covar_type: str = "full") -> EMState:
    """Run the VBEM loop to convergence (`vbhmm_em.m:112-414`).

    Matches the reference's control flow: each iteration is
    {E-step, ELBO, convergence check, M-step}; the M-step IS applied on
    the converging iteration (the reference's `break` sits after the
    M-step, `vbhmm_em.m:411-413`), so the returned posterior is post-M
    while ``ll``/``gamma``/``stats`` are pre-M.  NaN ELBO maps to -inf
    (unstable model, `vbhmm_em.m:312-330`).
    """
    dtype = batch.x.dtype
    big_neg = jnp.asarray(-jnp.finfo(dtype).max, dtype)

    def body(st: EMState) -> EMState:
        fb = e_step(batch, st.post)
        stats = suff_stats(batch, fb)
        ll = elbo(batch, st.post, fb, stats, hyps)
        unstable = jnp.isnan(ll)
        ll = jnp.where(unstable, -jnp.inf, ll)
        lik_incr = jnp.abs((ll - st.ll) / st.ll)
        converged = jnp.logical_and(st.it > 0, lik_incr <= min_diff)
        done = converged | unstable | (st.it + 1 >= max_iter)
        new_post = m_step(stats, hyps, covar_type)
        # On an unstable iteration keep the previous posterior.
        new_post = jax.tree.map(
            lambda new, old: jnp.where(unstable, old, new), new_post, st.post)
        return EMState(post=new_post, ll=ll, last_ll=st.ll,
                       it=st.it + 1, gamma=fb.gamma, stats=stats, done=done)

    fb0 = e_step(batch, init_post)
    st0 = EMState(post=init_post, ll=big_neg, last_ll=big_neg,
                  it=jnp.asarray(0), gamma=fb0.gamma,
                  stats=suff_stats(batch, fb0), done=jnp.asarray(False))
    out = jax.lax.while_loop(lambda st: ~st.done, body, st0)
    return out


def em_trace(batch: SeqBatch, init_post: HMMPosterior, hyps: VBHyps,
             n_iter: int = 50):
    """Run exactly ``n_iter`` VBEM iterations recording the ELBO after
    each (the reference's iteration history; see also
    `vbhmm_em.m:287-301` monotonicity warnings).  Returns
    (final posterior, ll_history [n_iter])."""
    def step(post, _):
        fb = e_step(batch, post)
        stats = suff_stats(batch, fb)
        ll = elbo(batch, post, fb, stats, hyps)
        return m_step(stats, hyps), ll

    return jax.lax.scan(step, init_post, None, length=n_iter)


def init_from_gmm(weight: jnp.ndarray, mean: jnp.ndarray, cov: jnp.ndarray,
                  n_total: jnp.ndarray, hyps: VBHyps,
                  covar_type: str = "full") -> HMMPosterior:
    """GMM -> initial variational parameters (`vbhmm_init.m:163-199`)."""
    k, d = mean.shape
    dtype = mean.dtype
    nk = n_total * weight                       # state occupancy guess
    nk2 = jnp.full((k,), n_total / k, dtype)    # uniform prior/trans guess
    alpha = hyps.alpha0 + nk2
    epsilon = hyps.epsilon0 + jnp.broadcast_to(nk2[None, :], (k, k))
    beta = hyps.beta0 + nk
    v = hyps.v0 + nk + 1.0
    m = (hyps.beta0 * hyps.m0[None, :] + nk[:, None] * mean) / beta[:, None]
    mult1 = hyps.beta0 * nk / (hyps.beta0 + nk)
    diff3 = mean - hyps.m0[None, :]
    w0inv = jnp.diag(hyps.w0inv_diag.astype(dtype))
    if covar_type == "diag":
        cov = cov * jnp.eye(d, dtype=dtype)
    winv = (w0inv[None] + nk[:, None, None] * cov
            + mult1[:, None, None] * diff3[:, :, None] * diff3[:, None, :])
    w = inv_psd(winv)
    if covar_type == "diag":
        w = w * jnp.eye(d, dtype=dtype)
    return HMMPosterior(alpha=alpha, epsilon=epsilon,
                        niw=NIW(beta=beta, v=v, m=m, w=w))


def random_init(key: jax.Array, batch: SeqBatch, k: int,
                hyps: VBHyps, covar_type: str = "full") -> HMMPosterior:
    """'random' initmode: GMM fit on pooled data with a random-sample
    start (`vbhmm_init.m:25-91`).  Padded rows are excluded by giving
    them zero weight in the GMM fit."""
    n, t_max, d = batch.x.shape
    x = batch.x.reshape(n * t_max, d)
    w = batch.mask.reshape(n * t_max).astype(x.dtype)
    g = fit_gmm(key, x, k, weights=w)
    return init_from_gmm(g.weight, g.mean, g.cov,
                         batch.total.astype(x.dtype), hyps, covar_type)


def split_init(batch: SeqBatch, k: int, hyps: VBHyps,
               covar_type: str = "full") -> HMMPosterior:
    """'split' initmode: deterministic component-splitting GMM on the
    pooled data (`vbhmm_init.m:104-111`), then the same GMM->posterior
    conversion as 'random'."""
    from ..ops.gmm import fit_gmm_split
    n, t_max, d = batch.x.shape
    x = batch.x.reshape(n * t_max, d)
    w = batch.mask.reshape(n * t_max).astype(x.dtype)
    g = fit_gmm_split(x, k, weights=w)
    return init_from_gmm(g.weight, g.mean, g.cov,
                         batch.total.astype(x.dtype), hyps, covar_type)


def fit_single_k(key: jax.Array, batch: SeqBatch, k: int, config: VBConfig,
                 hyps: Optional[VBHyps] = None,
                 init_post: Optional[HMMPosterior] = None) -> EMState:
    """Random restarts for one K, vmapped (`vbhmm_learn.m:454-480`).
    Returns the batched EMState over trials."""
    dtype = batch.x.dtype
    if hyps is None:
        hyps = VBHyps.from_config(config, batch.x.shape[-1], dtype)
    numtrials = 1 if k == 1 else config.numtrials
    if init_post is not None:
        numtrials = 1   # deterministic init (initgmm/inithmm): one trial

    if init_post is None and config.initmode == "split":
        # 'split' is deterministic -> one shared init for every trial
        init_post = split_init(batch, k, hyps, config.covar_type)
        numtrials = 1

    def one_trial(trial_key):
        post0 = init_post if init_post is not None else random_init(
            trial_key, batch, k, hyps, config.covar_type)
        return vbem_em(batch, post0, hyps,
                       max_iter=config.max_iter, min_diff=config.min_diff,
                       covar_type=config.covar_type)

    keys = jax.random.split(key, numtrials)
    return jax.vmap(one_trial)(keys)


def select_best_trial(states: EMState) -> EMState:
    best = jnp.argmax(states.ll)
    return jax.tree.map(lambda a: a[best], states)


def finalize(batch: SeqBatch, st: EMState) -> VBHMMResult:
    """Package one EM solution as a result struct (`vbhmm_em.m:424-492`)."""
    post = st.post
    return VBHMMResult(
        post=post, model=post.to_point(), ll=st.ll, gamma=st.gamma,
        counts_n1=st.stats.nk1, counts=st.stats.nk,
        trans_counts=st.stats.m_trans,
        state_mask=jnp.ones_like(post.alpha, dtype=bool))


def optimize_solution_hyps(batch: SeqBatch, init_post: HMMPosterior,
                           hyps0: VBHyps, config: VBConfig):
    """Empirical-Bayes hyp optimization for one solution
    (`vbhmm_em_hyp.m`): L-BFGS-B over transformed hyps; each objective
    eval re-runs EM from the SAME initial posterior (the given solution)
    with the candidate hyps, exactly as `vbhmm_em_hyp.m:166-200`.
    Returns (opt hyps, final EMState, info)."""
    from .. import hyp as hypmod

    dim = batch.x.shape[-1]
    specs = hypmod.vb_specs(dim, config.bounds, config.learn_hyps_keys)

    def neg_elbo(hyps: VBHyps):
        st = vbem_em(batch, init_post, jax.lax.stop_gradient(hyps),
                     max_iter=config.max_iter, min_diff=config.min_diff,
                     covar_type=config.covar_type)
        post = jax.lax.stop_gradient(st.post)
        fb = e_step(batch, post)
        stats = suff_stats(batch, fb)
        # gradient = dL/dhyps at the EM fixed point (posterior stopped)
        return -elbo(batch, post, fb, stats, hyps)

    hyps_opt, info = hypmod.optimize_hyps(neg_elbo, hyps0, specs)
    st = vbem_em(batch, init_post, hyps_opt,
                 max_iter=config.max_iter, min_diff=config.min_diff,
                 covar_type=config.covar_type)
    return hyps_opt, st, info


def optimize_solution_hyps_batched(batch: SeqBatch, init_posts: HMMPosterior,
                                   hyps0: VBHyps, config: VBConfig):
    """Hyp-optimize a BANK of solutions in one compiled program: the
    per-unique-solution L-BFGS runs of `vbhmm_learn.m:498-552` become a
    vmapped lane axis (the reference parfors this loop).  ``init_posts``
    carries a leading lane axis.  Returns (hyps with lane axis, final
    EMStates with lane axis)."""
    from .. import hyp as hypmod

    dim = batch.x.shape[-1]
    specs = hypmod.vb_specs(dim, config.bounds, config.learn_hyps_keys)

    def neg_elbo(hyps: VBHyps, init_post: HMMPosterior):
        st = vbem_em(batch, init_post, jax.lax.stop_gradient(hyps),
                     max_iter=config.max_iter, min_diff=config.min_diff,
                     covar_type=config.covar_type)
        post = jax.lax.stop_gradient(st.post)
        fb = e_step(batch, post)
        stats = suff_stats(batch, fb)
        # gradient = dL/dhyps at the EM fixed point (posterior stopped)
        return -elbo(batch, post, fb, stats, hyps)

    hyps_b, _, _ = hypmod.optimize_hyps_batched(
        neg_elbo, hyps0, specs, (init_posts,),
        max_steps=config.hyp_max_steps)

    def rerun(h, p):
        return vbem_em(batch, p, h, max_iter=config.max_iter,
                       min_diff=config.min_diff,
                       covar_type=config.covar_type)

    sts = jax.jit(jax.vmap(rerun))(hyps_b, init_posts)
    return hyps_b, sts


def learn(key: jax.Array, batch: SeqBatch, k, config: VBConfig = VBConfig(),
          hyps: Optional[VBHyps] = None, initgmm=None,
          inithmm: Optional[HMMPosterior] = None):
    """Learn an HMM with restarts and optional model selection over K
    (`vbhmm_learn.m:232-654`).

    ``k`` may be an int or a sequence of ints.  With a sequence, each K
    runs the FULL single-K path (restarts + hyp learning when enabled,
    exactly as the reference recurses per K, `vbhmm_learn.m:364-388`)
    and the winner maximizes ``LL + gammaln(K+1)`` — the
    multiple-parameterization correction of `vbhmm_learn.m:391`.

    ``initgmm`` (a `(prior, mean, cov)` triple or an
    :class:`..ops.gmm.GMM`) and ``inithmm`` (an existing posterior)
    drive the 'initgmm' / 'inithmm' initmodes (`vbhmm_init.m:93-120`,
    `:154-161`); config.initmode='split' uses the deterministic
    component-splitting GMM.  Returns (VBHMMResult, dict).
    """
    if isinstance(k, (list, tuple, range)):
        import numpy as np
        ks = list(k)
        results, sub_infos, lls = [], [], []
        for ki, kk in enumerate(ks):
            sub_key = jax.random.fold_in(key, ki)
            res, sub_info = learn(sub_key, batch, int(kk), config, hyps,
                                  initgmm=initgmm, inithmm=inithmm)
            results.append(res)
            sub_infos.append(sub_info)
            # cross-K comparison uses the f64-rescored bound when the
            # compute dtype is f32 (set by the single-K path below)
            lls.append(sub_info.get("ll_f64", float(res.ll)))
        corrected = np.asarray(lls) + np.array(
            [float(gammaln(kk + 1)) for kk in ks])
        best = int(np.argmax(corrected))
        info = {"model_ll": corrected, "model_k": ks,
                "model_best_k": ks[best], "model_all": results,
                "model_infos": sub_infos,
                "vbopt": config, "version": _version()}
        if "learned_hyps" in sub_infos[best]:
            info["learned_hyps"] = sub_infos[best]["learned_hyps"]
        return results[best], info

    init_post = None
    if config.initmode == "initgmm" or initgmm is not None:
        if initgmm is None:
            raise ValueError("initmode='initgmm' needs the initgmm arg")
        gw, gm, gc = (initgmm.weight, initgmm.mean, initgmm.cov) \
            if hasattr(initgmm, "weight") else initgmm
        hyps_i = hyps if hyps is not None else VBHyps.from_config(
            config, batch.x.shape[-1], batch.x.dtype)
        init_post = init_from_gmm(jnp.asarray(gw), jnp.asarray(gm),
                                  jnp.asarray(gc),
                                  batch.total.astype(batch.x.dtype),
                                  hyps_i, config.covar_type)
    elif config.initmode == "inithmm" or inithmm is not None:
        if inithmm is None:
            raise ValueError("initmode='inithmm' needs the inithmm arg")
        # use the given variational posterior directly
        # (`vbhmm_init.m:154-161`)
        init_post = inithmm

    states = fit_single_k(key, batch, int(k), config, hyps,
                          init_post=init_post)
    info = {"model_best_k": int(k), "vbopt": config, "version": _version()}
    if config.keep_suboptimal:
        # keep every uniqueLL restart solution in the output, like the
        # reference's keep_suboptimal_hmms (`vbhmm_learn.m:417,600`)
        from .. import hyp as hypmod
        import numpy as np
        uniq_all = hypmod.unique_ll(np.asarray(states.ll), config.min_diff)
        info["suboptimal"] = [
            finalize(batch, jax.tree.map(lambda a, i=int(i): a[i], states))
            for i in uniq_all]
    if config.learn_hyps:
        # dedup restart solutions by LL and hyp-optimize each unique one
        # (`vbhmm_learn.m:484-552`) in ONE vmapped L-BFGS program, then
        # take the best final ELBO.
        from .. import hyp as hypmod
        import numpy as np
        dim = batch.x.shape[-1]
        hyps0 = hyps if hyps is not None else VBHyps.from_config(
            config, dim, batch.x.dtype)
        uniq = hypmod.unique_ll(np.asarray(states.ll), config.min_diff)
        if config.max_hyp_solutions is not None:
            uniq = uniq[:config.max_hyp_solutions]
        if len(uniq) == 0:
            uniq = np.asarray([int(np.argmax(np.asarray(states.ll)))])
        # pad the lane count to a static bucket (duplicate lanes are
        # harmless under the final max-LL selection) so the batched
        # L-BFGS program compiles once per bucket, not once per subject
        uniq = hypmod.pad_lanes(uniq, bucket=4)
        idx = jnp.asarray(uniq)
        init_posts = jax.tree.map(lambda a: a[idx], states.post)
        hyps_b, sts = optimize_solution_hyps_batched(
            batch, init_posts, hyps0, config)
        # degenerate hyp-optimized lanes fall back to pre-opt solutions
        # (`vbhmm_learn.m:567-571` warning test, made a rejection)
        pre = jax.tree.map(lambda a: a[idx], states)
        sts, n_bad, bad = hypmod.fallback_degenerate_lanes(
            sts, pre, pre.ll, sts.ll)
        # reverted lanes keep hyps0 so info['learned_hyps'] matches the
        # state actually kept
        hyps_b = hypmod.substitute_lanes(hyps_b, hyps0, bad)
        if n_bad and config.verbose >= 2:
            print(f"  [hyp] {n_bad} degenerate lane(s) reverted",
                  flush=True)
        if batch.x.dtype == jnp.float32:
            # f32 device bounds can carry selection-flipping artifacts;
            # pick the winning lane on host-f64 rescored values (the
            # VBEM analogue of cluster_batched's grid-cell rescoring)
            from . import rescore
            lane_ll64 = rescore.vbem_rescore_lanes(
                np.asarray(batch.x), np.asarray(batch.lengths),
                sts.post, hyps_b)
            best = int(np.argmax(lane_ll64))
            info["ll_f64"] = float(lane_ll64[best])
        else:
            best = int(jnp.argmax(sts.ll))
        st = jax.tree.map(lambda a: a[best], sts)
        info["learned_hyps"] = jax.tree.map(lambda a: a[best], hyps_b)
    else:
        if batch.x.dtype == jnp.float32:
            from . import rescore
            import numpy as np
            hyps0_ns = hyps if hyps is not None else VBHyps.from_config(
                config, batch.x.shape[-1], batch.x.dtype)
            trial_ll64 = rescore.vbem_rescore_lanes(
                np.asarray(batch.x), np.asarray(batch.lengths),
                states.post, hyps0_ns)
            best = int(np.argmax(trial_ll64))
            st = jax.tree.map(lambda a: a[best], states)
            info["ll_f64"] = float(trial_ll64[best])
        else:
            st = select_best_trial(states)
    res = finalize(batch, st)
    if config.sortclusters:
        res = standardize(res, config.sortclusters)
    return res, info


# ---------------------------------------------------------------------------
# state standardization / permutation / pruning (vbhmm_standardize.m,
# vbhmm_permute.m, vbhmm_remove_empty.m)
# ---------------------------------------------------------------------------

def _version() -> str:
    """Version stamp carried in every output (`emhmm_version.m`,
    `vbhmm_learn.m:651-654`)."""
    from .. import __version__
    return __version__


def permute(res: VBHMMResult, perm: jnp.ndarray) -> VBHMMResult:
    """Apply a state permutation to every field (`vbhmm_permute.m`)."""
    post = res.post
    new_post = HMMPosterior(
        alpha=post.alpha[..., perm],
        epsilon=post.epsilon[..., perm, :][..., :, perm],
        niw=NIW(beta=post.niw.beta[..., perm], v=post.niw.v[..., perm],
                m=post.niw.m[..., perm, :], w=post.niw.w[..., perm, :, :]))
    return VBHMMResult(
        post=new_post, model=new_post.to_point(), ll=res.ll,
        gamma=res.gamma[..., perm], counts_n1=res.counts_n1[..., perm],
        counts=res.counts[..., perm],
        trans_counts=res.trans_counts[..., perm, :][..., :, perm],
        state_mask=None if res.state_mask is None else res.state_mask[..., perm])


def _most_likely_path_order(prior: jnp.ndarray, trans: jnp.ndarray) -> jnp.ndarray:
    """Greedy argmax walk ordering 'f' (`vbhmm_standardize.m:73-93`):
    start at the most probable initial state, then repeatedly follow the
    most probable transition to an unvisited state."""
    import numpy as np
    p = np.asarray(prior)
    a = np.asarray(trans)
    k = p.shape[0]
    order = [int(np.argmax(p))]
    for _ in range(k - 1):
        row = a[order[-1]].copy()
        row[order] = -np.inf
        order.append(int(np.argmax(row)))
    return jnp.asarray(order)


def standardize(res: VBHMMResult, mode: str = "f") -> VBHMMResult:
    """Canonical state ordering (`vbhmm_standardize.m`): 'e' by emission
    count, 'p' by prior, 'f' by most-likely greedy path, 's' by
    steady-state probability, 'l'/'r' left-to-right / right-to-left by
    emission mean x."""
    import numpy as np
    if mode in ("e",):
        perm = jnp.asarray(np.argsort(-np.asarray(res.counts), kind="stable"))
    elif mode == "p":
        perm = jnp.asarray(np.argsort(-np.asarray(res.model.prior), kind="stable"))
    elif mode == "f":
        perm = _most_likely_path_order(res.model.prior, res.model.trans)
    elif mode == "s":
        ss = steady_state(res.model.trans)
        perm = jnp.asarray(np.argsort(-np.asarray(ss), kind="stable"))
    elif mode in ("l", "r"):
        # left-to-right / right-to-left by emission mean x
        # (`vbhmm_standardize.m:96-104`)
        mx = np.asarray(res.model.mean)[:, 0]
        perm = jnp.asarray(np.argsort(mx if mode == "l" else -mx,
                                      kind="stable"))
    else:
        raise ValueError(f"unknown standardize mode {mode!r}")
    return permute(res, perm)


def remove_empty(res: VBHMMResult, thresh: float = 1.0):
    """Prune states with soft count below ``thresh``
    (`vbhmm_remove_empty.m`).  Returns (result, kept_idx, removed_idx);
    shapes shrink, so this is a host-side (non-jit) op used between
    pipeline stages, exactly where the reference uses it."""
    import numpy as np
    counts = np.asarray(res.counts)
    keep = np.where(counts >= thresh)[0]
    removed = np.where(counts < thresh)[0]
    if len(removed) == 0:
        return res, keep, removed
    perm = jnp.asarray(keep)
    post = res.post
    new_post = HMMPosterior(
        alpha=post.alpha[perm],
        epsilon=post.epsilon[perm][:, perm],
        niw=NIW(beta=post.niw.beta[perm], v=post.niw.v[perm],
                m=post.niw.m[perm], w=post.niw.w[perm]))
    gamma = res.gamma[..., perm]
    gsum = jnp.sum(gamma, axis=-1, keepdims=True)
    gamma = gamma / jnp.where(gsum == 0, 1.0, gsum)
    out = VBHMMResult(
        post=new_post, model=new_post.to_point(), ll=res.ll, gamma=gamma,
        counts_n1=res.counts_n1[perm], counts=res.counts[perm],
        trans_counts=res.trans_counts[perm][:, perm],
        state_mask=jnp.ones_like(new_post.alpha, dtype=bool))
    return out, keep, removed


def steady_state(trans: jnp.ndarray) -> jnp.ndarray:
    """Stationary distribution p = A^T p (`vbhmm_prob_steadystate.m`)."""
    k = trans.shape[-1]
    a = jnp.concatenate([trans.T - jnp.eye(k, dtype=trans.dtype),
                         jnp.ones((1, k), trans.dtype)], axis=0)
    b = jnp.concatenate([jnp.zeros((k,), trans.dtype),
                         jnp.ones((1,), trans.dtype)])
    sol, *_ = jnp.linalg.lstsq(a, b)
    return sol
