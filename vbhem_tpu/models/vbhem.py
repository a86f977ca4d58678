"""VBHEM: clustering a bank of HMMs into K reduced cluster-center HMMs
with S states each, without touching raw data (the reference's L3
engine, `src/vbhem/`).

Parity map (reference file -> here):
  * `vbhem_h3m_cluster.m`    -> :func:`cluster` ((K,S) grid + selection)
  * `vbhem_h3m_c.m`          -> :func:`fit_single_ks` (vmapped trials)
  * `vbhem_h3m_c_step_fc.m`  -> :func:`vbhem_em` (the EM loop)
  * `vbhem_hmm_bwd_fwd_*`    -> :mod:`..ops.pair_estep`
  * `vbhemh3m_lb.m`          -> :func:`elbo` (10 terms)
  * `vbhem_mstep_component.m` + `vbhem_compute_Statistics.m`
                             -> :func:`m_step`
  * `hmms_to_h3m_hem.m`      -> :func:`h3m_from_results`
  * `vbhemhmm_init.m`        -> :func:`init_baseem` / :func:`init_wtkmeans`
                                / :func:`init_random`
  * `form_outputH3M.m`       -> :class:`VBHEMResult` / :func:`finalize`
  * `vbh3m_remove_empty.m`   -> :func:`remove_empty_clusters`

Design: the (i, j) pair grid, the trial restarts, and the
(K, S) sweep are all batch axes (vmap / one compiled program per grid
cell) rather than `parfor` loops; the base-HMM bank is a dense padded
pytree so the hot E-step is pure batched einsum + scan.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from ..config import VBHEMConfig
from ..containers import H3M, HMM, H3MPosterior, NIW, VBHMMResult
from ..ops.kmeans import kmeans
from ..ops.pair_estep import (PairStats, expected_pair_ll_variational,
                              pair_bwd_fwd)
from ..utils.numeric import (e_log_det_lambda, e_log_dirichlet, inv_psd,
                             log_dirichlet_const, log_wishart_b, logdet_psd,
                             sym, tiny)


class VBHEMHyps(NamedTuple):
    """Prior hyperparameters of the reduced model as a differentiable
    pytree (the learnable set of `vbhem_get_hypinfo.m`)."""
    alpha0: jnp.ndarray
    eta0: jnp.ndarray
    epsilon0: jnp.ndarray
    lambda0: jnp.ndarray
    v0: jnp.ndarray
    m0: jnp.ndarray   # [D]
    w0: jnp.ndarray   # [D] diagonal of W0

    @property
    def w0inv_diag(self) -> jnp.ndarray:
        return 1.0 / self.w0

    @classmethod
    def from_config(cls, config: VBHEMConfig, dim: int, dtype=jnp.float64):
        w0 = config.w0
        w0 = tuple(w0) if isinstance(w0, (tuple, list)) else (w0,) * dim
        return cls(
            alpha0=jnp.asarray(config.alpha0, dtype),
            eta0=jnp.asarray(config.eta0, dtype),
            epsilon0=jnp.asarray(config.epsilon0, dtype),
            lambda0=jnp.asarray(config.lambda0, dtype),
            v0=jnp.asarray(config.v0, dtype),
            m0=jnp.asarray(config.default_m0(dim), dtype),
            w0=jnp.asarray(w0, dtype),
        )


# ---------------------------------------------------------------------------
# base bank construction (hmms_to_h3m_hem.m)
# ---------------------------------------------------------------------------

def h3m_from_results(results: Sequence[VBHMMResult], use_post: bool = True,
                     s_max: Optional[int] = None,
                     dtype=None, covar_type: str = "full") -> H3M:
    """Convert learned VBHMMs into a dense padded base H3M.

    With ``use_post`` (the reference default, `vbhem_h3m_cluster.m:210`),
    point estimates are replaced by posterior expectations
    (`hmms_to_h3m_hem.m:43-92`):
      prior = exp(E[log pi]),  A = exp(E[log A])   (sub-normalized!)
      cov   = ((beta + 1) / beta) * E[Sigma]
    Padded states get zero prior/transition mass and identity covariance
    (inert through the pair recursions).
    """
    import numpy as np
    k_b = len(results)
    dims = [np.asarray(r.post.niw.m).shape[-1] for r in results]
    d = dims[0]
    ss = [np.asarray(r.post.alpha).shape[-1] for r in results]
    sm = s_max if s_max is not None else max(ss)
    dt = dtype or np.asarray(results[0].post.niw.m).dtype

    prior = np.zeros((k_b, sm), dt)
    trans = np.zeros((k_b, sm, sm), dt)
    mean = np.zeros((k_b, sm, d), dt)
    cov = np.tile(np.eye(d, dtype=dt), (k_b, sm, 1, 1))
    mask = np.zeros((k_b, sm), bool)

    for i, r in enumerate(results):
        s = ss[i]
        mask[i, :s] = True
        if use_post:
            lp = np.asarray(e_log_dirichlet(r.post.alpha))
            la = np.asarray(e_log_dirichlet(r.post.epsilon))
            prior[i, :s] = np.exp(lp)
            trans[i, :s, :s] = np.exp(la)
            beta = np.asarray(r.post.niw.beta)
            scale = (beta + 1.0) / beta
            cov[i, :s] = np.asarray(r.post.niw.expected_cov()) * \
                scale[:, None, None]
        else:
            prior[i, :s] = np.asarray(r.model.prior)
            trans[i, :s, :s] = np.asarray(r.model.trans)
            cov[i, :s] = np.asarray(r.model.cov)
        mean[i, :s] = np.asarray(r.post.niw.m if use_post else r.model.mean)

    if covar_type == "diag":
        # `hmms_to_h3m_hem.m:78-91` covmode 'diag': keep diag(cov) only
        cov = cov * np.eye(d, dtype=dt)
    omega = np.full((k_b,), 1.0 / k_b, dt)
    hmm = HMM(prior=jnp.asarray(prior), trans=jnp.asarray(trans),
              mean=jnp.asarray(mean), cov=jnp.asarray(cov))
    return H3M(omega=jnp.asarray(omega), hmm=hmm, state_mask=jnp.asarray(mask))


def h3m_from_hmms(hmms: Sequence[HMM], s_max: Optional[int] = None) -> H3M:
    """Build a base H3M from plain point-estimate HMMs (testing / VHEM)."""
    import numpy as np
    k_b = len(hmms)
    d = hmms[0].dim
    ss = [h.num_states for h in hmms]
    sm = s_max if s_max is not None else max(ss)
    dt = np.asarray(hmms[0].mean).dtype
    prior = np.zeros((k_b, sm), dt)
    trans = np.zeros((k_b, sm, sm), dt)
    mean = np.zeros((k_b, sm, d), dt)
    cov = np.tile(np.eye(d, dtype=dt), (k_b, sm, 1, 1))
    mask = np.zeros((k_b, sm), bool)
    for i, h in enumerate(hmms):
        s = ss[i]
        mask[i, :s] = True
        prior[i, :s] = np.asarray(h.prior)
        trans[i, :s, :s] = np.asarray(h.trans)
        mean[i, :s] = np.asarray(h.mean)
        cov[i, :s] = np.asarray(h.cov)
    omega = np.full((k_b,), 1.0 / k_b, dt)
    return H3M(omega=jnp.asarray(omega),
               hmm=HMM(prior=jnp.asarray(prior), trans=jnp.asarray(trans),
                       mean=jnp.asarray(mean), cov=jnp.asarray(cov)),
               state_mask=jnp.asarray(mask))


# ---------------------------------------------------------------------------
# E-step
# ---------------------------------------------------------------------------

class ReducedExpectations(NamedTuple):
    log_omega: jnp.ndarray  # [Kr]      E[log omega]
    log_pi: jnp.ndarray     # [Kr, Sr]  E[log pi]
    log_a: jnp.ndarray      # [Kr, Sr, Sr]
    log_lam: jnp.ndarray    # [Kr, Sr]  E[log |Lambda|]


def reduced_expectations(post: H3MPosterior) -> ReducedExpectations:
    """Digamma expectations of the reduced model
    (`vbhem_h3m_c_step_fc.m:118-165, 270-273`)."""
    return ReducedExpectations(
        log_omega=e_log_dirichlet(post.alpha),
        log_pi=e_log_dirichlet(post.eta),
        log_a=e_log_dirichlet(post.epsilon),
        log_lam=e_log_det_lambda(post.niw.v, post.niw.w))


def e_step(base: H3M, post: H3MPosterior, exps: ReducedExpectations,
           tau: int) -> PairStats:
    """Pair E-step over the full [Kb, Kr] grid
    (`vbhem_h3m_c_step_fc.m:168-268`): E3logN, then the backward and
    forward recursions as XLA scans."""
    ell = expected_pair_ll_variational(
        base.hmm.mean, base.hmm.cov, post.niw.m, post.niw.w, post.niw.v,
        post.niw.beta, exps.log_lam)
    return pair_bwd_fwd(base.hmm.prior, base.hmm.trans, exps.log_pi,
                        exps.log_a, ell, tau)


def soft_assignments(tilde_n: jnp.ndarray, log_omega: jnp.ndarray,
                     ll_elbo: jnp.ndarray, axis_name: Optional[str] = None):
    """hat_Z softmax weighted by virtual counts
    (`vbhem_h3m_c_step_fc.m:275-283`).

    The softmax over clusters is row-local; only the cluster masses Nj
    reduce over the base axis — a `psum` when Kb is sharded
    (``axis_name`` set, pod configuration)."""
    from ..utils.numeric import logsumexp
    dtype = ll_elbo.dtype
    log_z = tilde_n[:, None] * (log_omega[None, :] + ll_elbo)
    hat_z = jnp.exp(log_z - logsumexp(log_z, axis=-1, keepdims=True))
    hat_z = hat_z + tiny(dtype)
    z_ni = hat_z * tilde_n[:, None]
    nj = jnp.sum(z_ni, axis=0)
    if axis_name is not None:
        nj = jax.lax.psum(nj, axis_name)
    nj = nj + tiny(dtype)
    return hat_z, z_ni, nj


# ---------------------------------------------------------------------------
# M-step (vbhem_compute_Statistics.m + vbhem_mstep_component.m)
# ---------------------------------------------------------------------------

class ClusterStats(NamedTuple):
    nj: jnp.ndarray          # [Kr]
    nj_rho1: jnp.ndarray     # [Kr, Sr]
    nj_rho2rho: jnp.ndarray  # [Kr, Sr, Sr]
    nj_rho: jnp.ndarray      # [Kr, Sr]
    y_bar: jnp.ndarray       # [Kr, Sr, D]
    s_plus_c: jnp.ndarray    # [Kr, Sr, D, D]


def aggregate_stats(base: H3M, pair: PairStats, z_ni: jnp.ndarray,
                    nj: jnp.ndarray,
                    axis_name: Optional[str] = None) -> ClusterStats:
    """Z-weighted reduction of pair statistics over the base axis.

    The emission statistics are linear images of ``sum_t_nu`` against
    cached base moments (`vbhem_hmm_bwd_fwd_fast.m:350-384` merged with
    `vbhem_compute_Statistics.m:33-78`).  This reduction is a `psum`
    when the Kb axis is sharded (pod configuration).
    """
    dtype = z_ni.dtype
    mean_b, cov_b = base.hmm.mean, base.hmm.cov
    nj_rho1 = jnp.einsum("ij,ijr->jr", z_ni, pair.nu_1)
    nj_rho2rho = jnp.einsum("ij,ijrs->jrs", z_ni, pair.sum_xi)
    # second moment cache: mu mu^T + Sigma per base state
    m2_b = mean_b[..., :, None] * mean_b[..., None, :] + cov_b  # [Kb,Sb,D,D]
    emit_pr = jnp.sum(pair.sum_t_nu, axis=-1)                   # [Kb,Kr,Sr]
    nj_rho = jnp.einsum("ij,ijr->jr", z_ni, emit_pr)
    y_sum = jnp.einsum("ij,ijrb,ibd->jrd", z_ni, pair.sum_t_nu, mean_b)
    m2_sum = jnp.einsum("ij,ijrb,ibde->jrde", z_ni, pair.sum_t_nu, m2_b)
    if axis_name is not None:
        nj_rho1, nj_rho2rho, nj_rho, y_sum, m2_sum = jax.lax.psum(
            (nj_rho1, nj_rho2rho, nj_rho, y_sum, m2_sum), axis_name)
    nj_rho = nj_rho + tiny(dtype)
    y_bar = y_sum / nj_rho[..., None]
    s_plus_c = sym(m2_sum / nj_rho[..., None, None]
                   - y_bar[..., :, None] * y_bar[..., None, :])
    sr = nj_rho1.shape[-1]
    if sr == 1:
        # degenerate transition counts (`vbhem_compute_Statistics.m:80-82`)
        nj_rho2rho = jnp.full_like(nj_rho2rho, 1e-12)
    return ClusterStats(nj=nj, nj_rho1=nj_rho1, nj_rho2rho=nj_rho2rho,
                        nj_rho=nj_rho, y_bar=y_bar, s_plus_c=s_plus_c)


def m_step(stats: ClusterStats, hyps: VBHEMHyps,
           covar_type: str = "full") -> H3MPosterior:
    """Conjugate natural-parameter updates (`vbhem_mstep_component.m:42-72`
    + the alpha update of `vbhem_h3m_c_step_fc.m:394-397`).

    ``covar_type='diag'``: the scatter enters as diag(S_plus_C) and the
    stored Wishart scale is the diagonal of the inverse
    (`vbhem_mstep_component.m:55-63`) — kept embedded as a diagonal
    matrix so every downstream formula is unchanged (the reference
    re-embeds it too, `vbhemh3m_lb.m:127`)."""
    dtype = stats.y_bar.dtype
    alpha = hyps.alpha0 + stats.nj
    eta = hyps.eta0 + stats.nj_rho1
    epsilon = hyps.epsilon0 + stats.nj_rho2rho
    lam = hyps.lambda0 + stats.nj_rho
    v = hyps.v0 + stats.nj_rho + 1.0
    m = (hyps.lambda0 * hyps.m0 + stats.nj_rho[..., None] * stats.y_bar) \
        / lam[..., None]
    mult1 = hyps.lambda0 * stats.nj_rho / lam
    diff3 = stats.y_bar - hyps.m0                              # [Kr,Sr,D]
    w0inv = jnp.diag(hyps.w0inv_diag.astype(dtype))
    d = stats.y_bar.shape[-1]
    s_pc = stats.s_plus_c
    if covar_type == "diag":
        s_pc = s_pc * jnp.eye(d, dtype=dtype)
    winv = (w0inv + stats.nj_rho[..., None, None] * s_pc
            + mult1[..., None, None] * diff3[..., :, None] * diff3[..., None, :])
    w = inv_psd(winv)
    if covar_type == "diag":
        w = w * jnp.eye(d, dtype=dtype)
    return H3MPosterior(alpha=alpha, eta=eta, epsilon=epsilon,
                        niw=NIW(beta=lam, v=v, m=m, w=w))


# ---------------------------------------------------------------------------
# ELBO (vbhemh3m_lb.m)
# ---------------------------------------------------------------------------

def elbo(post: H3MPosterior, exps: ReducedExpectations, pair: PairStats,
         hat_z: jnp.ndarray, z_ni: jnp.ndarray, nj: jnp.ndarray,
         hyps: VBHEMHyps, axis_name: Optional[str] = None) -> jnp.ndarray:
    """The 10-term VBHEM lower bound (`vbhemh3m_lb.m:88-186`)."""
    dtype = hat_z.dtype
    kr = post.num_clusters
    sr = post.num_states
    d = post.niw.dim
    niw = post.niw
    two_pi = jnp.asarray(2.0 * jnp.pi, dtype)

    logdet_w0inv = jnp.sum(jnp.log(hyps.w0inv_diag))
    log_c_alpha0 = gammaln(kr * hyps.alpha0) - kr * gammaln(hyps.alpha0)
    log_c_eta0 = gammaln(sr * hyps.eta0) - sr * gammaln(hyps.eta0)
    log_c_eps0 = gammaln(sr * hyps.epsilon0) - sr * gammaln(hyps.epsilon0)
    log_b0 = log_wishart_b(logdet_w0inv, hyps.v0, d)

    lt1 = jnp.sum(z_ni * pair.ll_elbo)
    lt7_local = jnp.sum(hat_z * jnp.log(hat_z))
    if axis_name is not None:
        lt1, lt7_local = jax.lax.psum((lt1, lt7_local), axis_name)
    lt2 = jnp.sum(nj * exps.log_omega)
    lt3 = kr * log_c_eta0 + (hyps.eta0 - 1.0) * jnp.sum(exps.log_pi)
    lt4 = kr * sr * log_c_eps0 + (hyps.epsilon0 - 1.0) * jnp.sum(exps.log_a)

    # Lt5: E[log p(mu, Lambda)] over all (j, k)
    dm = niw.m - hyps.m0                                       # [Kr,Sr,D]
    m_w_m = jnp.einsum("jrd,jrde,jre->jr", dm, niw.w, dm)
    w0inv_diag = hyps.w0inv_diag.astype(dtype)
    tr_w0inv_w = jnp.einsum("d,jrdd->jr", w0inv_diag, niw.w)
    const2 = d * jnp.log(hyps.lambda0 / two_pi)
    lt51 = 0.5 * jnp.sum(const2 + exps.log_lam - d * hyps.lambda0 / niw.beta
                         - hyps.lambda0 * niw.v * m_w_m)
    lt52 = (kr * sr * log_b0
            + 0.5 * (hyps.v0 - d - 1.0) * jnp.sum(exps.log_lam)
            - 0.5 * jnp.sum(niw.v * tr_w0inv_w))
    lt5 = lt51 + lt52

    lt6 = log_c_alpha0 + (hyps.alpha0 - 1.0) * jnp.sum(exps.log_omega)
    lt7 = lt7_local
    lt8 = log_dirichlet_const(post.alpha) \
        + jnp.sum((post.alpha - 1.0) * exps.log_omega)
    lt9 = (jnp.sum(log_dirichlet_const(post.eta))
           + jnp.sum((post.eta - 1.0) * exps.log_pi)
           + jnp.sum(log_dirichlet_const(post.epsilon))
           + jnp.sum((post.epsilon - 1.0) * exps.log_a))

    log_bk = log_wishart_b(-logdet_psd(niw.w), niw.v, d)       # [Kr,Sr]
    h_ent = jnp.sum(-log_bk - 0.5 * (niw.v - d - 1.0) * exps.log_lam
                    + 0.5 * niw.v * d)
    lt10 = 0.5 * jnp.sum(exps.log_lam + d * jnp.log(niw.beta / two_pi)) \
        - 0.5 * d * kr * sr - h_ent

    return lt1 + lt2 + lt3 + lt4 + lt5 + lt6 - lt7 - lt8 - lt9 - lt10


# ---------------------------------------------------------------------------
# EM loop (vbhem_h3m_c_step_fc.m)
# ---------------------------------------------------------------------------

def _project_diag(post: H3MPosterior) -> H3MPosterior:
    """Constrain a posterior's Wishart scales to diagonal matrices (the
    diag-covariance model keeps W as a vector, embedded diagonally)."""
    eye = jnp.eye(post.niw.dim, dtype=post.niw.w.dtype)
    return post._replace(niw=post.niw._replace(w=post.niw.w * eye))


class VBHEMState(NamedTuple):
    post: H3MPosterior
    ll: jnp.ndarray
    last_ll: jnp.ndarray
    it: jnp.ndarray
    hat_z: jnp.ndarray       # [Kb, Kr]
    ll_elbo: jnp.ndarray     # [Kb, Kr]
    stats: ClusterStats
    done: jnp.ndarray


def vbhem_em(base: H3M, init_post: H3MPosterior, hyps: VBHEMHyps,
             nv: int, tau: int, max_iter: int = 200,
             min_diff: float = 1e-5, kb_total: Optional[int] = None,
             axis_name: Optional[str] = None,
             covar_type: str = "full") -> VBHEMState:
    """The VBHEM EM loop, mirroring `vbhem_h3m_c_step_fc.m:115-433`.

    Virtual counts: tilde_N_i = Nv * Kb * omega_i (`:26-30`).  Control
    flow matches the reference: {expectations, pair E-step, hat_Z, ELBO,
    convergence check, M-step}, with the M-step applied on the
    converging iteration and NaN -> -inf instability handling.

    When the base axis Kb is sharded across devices (shard_map), pass
    ``axis_name`` and ``kb_total`` (the global Kb): statistic reductions
    become psums across devices and the posterior/ELBO stay replicated.
    """
    dtype = base.hmm.mean.dtype
    kb = kb_total if kb_total is not None else base.num_hmms
    tilde_n = (nv * kb) * base.omega
    big_neg = jnp.asarray(-jnp.finfo(dtype).max, dtype)
    if covar_type == "diag":
        init_post = _project_diag(init_post)

    def body(st: VBHEMState) -> VBHEMState:
        exps = reduced_expectations(st.post)
        pair = e_step(base, st.post, exps, tau)
        hat_z, z_ni, nj = soft_assignments(tilde_n, exps.log_omega,
                                           pair.ll_elbo, axis_name)
        ll = elbo(st.post, exps, pair, hat_z, z_ni, nj, hyps, axis_name)
        unstable = jnp.isnan(ll)
        ll = jnp.where(unstable, -jnp.inf, ll)
        lik_incr = jnp.abs((ll - st.ll) / st.ll)
        converged = jnp.logical_and(st.it > 0, lik_incr <= min_diff)
        done = converged | unstable | (st.it + 1 >= max_iter)
        stats = aggregate_stats(base, pair, z_ni, nj, axis_name)
        new_post = m_step(stats, hyps, covar_type)
        new_post = jax.tree.map(
            lambda new, old: jnp.where(unstable, old, new), new_post, st.post)
        return VBHEMState(post=new_post, ll=ll, last_ll=st.ll, it=st.it + 1,
                          hat_z=hat_z, ll_elbo=pair.ll_elbo, stats=stats,
                          done=done)

    kr, sr = init_post.num_clusters, init_post.num_states
    d = init_post.niw.dim
    # state shapes follow the LOCAL base shard (kb_total only scales
    # tilde_N); under shard_map the loop body produces [kb_local, Kr]
    kb_local = base.num_hmms
    # big_neg is made (vacuously) data-dependent so the carry's ll /
    # last_ll inherit the varying-manual-axes of the inputs under
    # shard_map (a bare constant is 'unvarying' and rejected).
    ll0 = big_neg + jnp.zeros((), dtype) * jnp.sum(init_post.alpha)
    st0 = VBHEMState(
        post=init_post, ll=ll0, last_ll=ll0, it=jnp.asarray(0),
        hat_z=jnp.zeros((kb_local, kr), dtype),
        ll_elbo=jnp.zeros((kb_local, kr), dtype),
        stats=ClusterStats(
            nj=jnp.zeros((kr,), dtype), nj_rho1=jnp.zeros((kr, sr), dtype),
            nj_rho2rho=jnp.zeros((kr, sr, sr), dtype),
            nj_rho=jnp.zeros((kr, sr), dtype),
            y_bar=jnp.zeros((kr, sr, d), dtype),
            s_plus_c=jnp.zeros((kr, sr, d, d), dtype)),
        done=jnp.asarray(False))
    # First iteration outside the loop (the loop body always ran at
    # least once): the carry then inherits its varying-manual-axes from
    # the actual inputs, which shard_map's while_loop vma check requires
    # (constant-initialized carries are unvarying and get rejected).
    st1 = body(st0)
    return jax.lax.while_loop(lambda st: ~st.done, body, st1)


def em_trace(base: H3M, init_post: H3MPosterior, hyps: VBHEMHyps,
             nv: int, tau: int, n_iter: int = 50):
    """Run exactly ``n_iter`` EM iterations recording the ELBO after
    each — the reference's `LogLs` iteration history / `story` trace
    (`vbhem_h3m_c_step_fc.m:425`, `hem_h3m_c_step.m:76-96`).  Returns
    (final posterior, ll_history [n_iter])."""
    kb = base.num_hmms
    tilde_n = (nv * kb) * base.omega

    def step(post, _):
        exps = reduced_expectations(post)
        pair = e_step(base, post, exps, tau)
        hat_z, z_ni, nj = soft_assignments(tilde_n, exps.log_omega,
                                           pair.ll_elbo)
        ll = elbo(post, exps, pair, hat_z, z_ni, nj, hyps)
        stats = aggregate_stats(base, pair, z_ni, nj)
        return m_step(stats, hyps), ll

    return jax.lax.scan(step, init_post, None, length=n_iter)


# ---------------------------------------------------------------------------
# initializers (vbhemhmm_init.m)
# ---------------------------------------------------------------------------

def _emission_w_from_cov(cov: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """W = inv((v - D - 1) * Sigma) (`vbhemhmm_init.m:86`)."""
    d = cov.shape[-1]
    return inv_psd((v[..., None, None] - d - 1.0) * cov)


def init_baseem(key: jax.Array, base: H3M, kr: int, sr: int,
                hyps: VBHEMHyps, nv: int) -> H3MPosterior:
    """'baseem' initializer (`vbhemhmm_init.m:58-100`): each reduced
    emission copies a random base emission; priors/transitions uniform
    (initopt mode 'u'); cluster weights random."""
    dtype = base.hmm.mean.dtype
    kb, sb_max = base.state_mask.shape
    nv_total = nv * kb
    nlr = nv_total / kr

    k_b, k_g, k_w = jax.random.split(key, 3)
    rand_b = jax.random.randint(k_b, (kr, sr), 0, kb)
    # random valid state of the chosen base HMM
    n_states = jnp.sum(base.state_mask, axis=-1)               # [Kb]
    u = jax.random.uniform(k_g, (kr, sr))
    rand_g = jnp.floor(u * n_states[rand_b]).astype(jnp.int32)
    rand_g = jnp.minimum(rand_g, sb_max - 1)

    v = jnp.full((kr, sr), hyps.v0 + nlr / sr + 1.0, dtype)
    lam = jnp.full((kr, sr), hyps.lambda0 + nlr / sr, dtype)
    m = base.hmm.mean[rand_b, rand_g]                          # [Kr,Sr,D]
    w = _emission_w_from_cov(base.hmm.cov[rand_b, rand_g], v)

    eta = jnp.full((kr, sr), 1.0 / sr, dtype) * nlr + hyps.eta0
    epsilon = jnp.full((kr, sr, sr), 1.0 / sr, dtype) * nlr / sr \
        + hyps.epsilon0
    omega = jax.random.uniform(k_w, (kr,), dtype)
    omega = omega / jnp.sum(omega)
    alpha = hyps.alpha0 + omega * nv_total
    return H3MPosterior(alpha=alpha, eta=eta, epsilon=epsilon,
                        niw=NIW(beta=lam, v=v, m=m, w=w))


def init_wtkmeans(key: jax.Array, base: H3M, kr: int, sr: int,
                  hyps: VBHEMHyps, nv: int) -> H3MPosterior:
    """'wtkmeans' initializer (`vbhemhmm_init.m:294-425`): weighted
    k-means of base emission means into Kr clusters (weights = long-run
    state probabilities, makeGMMweights mode '0'), then k-means into Sr
    states per cluster; random priors/transitions (initopt mode 'r')."""
    dtype = base.hmm.mean.dtype
    kb, sb_max = base.state_mask.shape
    d = base.hmm.mean.shape[-1]
    nj_virt = nv * kb / kr

    # long-run state weights: p A^50 per base HMM (makeGMMweights '0')
    def powiter(p_a):
        p, a = p_a
        return jax.lax.fori_loop(0, 50, lambda _, q: q @ a, p)
    p_inf = jax.vmap(powiter)((base.hmm.prior, base.hmm.trans))  # [Kb,Sb]
    weights = (p_inf * base.state_mask).reshape(-1)
    weights = weights / jnp.sum(weights)
    means_flat = base.hmm.mean.reshape(kb * sb_max, d)

    k1, k2, k3, k4 = jax.random.split(key, 4)
    valid = base.state_mask.reshape(-1).astype(dtype)
    # plain seeded k-means provides the start (`:330-333` rng(wtseed)
    # kmeans), then the energy-adjusted weighted k-means of
    # `my_weighted_kmeans.m` refines the assignment
    from ..ops.kmeans import weighted_kmeans_energy
    _, init_c = kmeans(k1, means_flat, kr, weights=valid)
    assign, _ = weighted_kmeans_energy(means_flat, weights, init_c)

    # per-cluster k-means into Sr centers (the reference runs PLAIN
    # kmeans on the member means, `:358-366`); empty clusters fall back
    # to the global centers (reference copies the first nonempty one).
    _, global_centers = kmeans(k3, means_flat, sr, weights=valid)

    def per_cluster(j, key_j):
        in_c = ((assign == j) & (valid > 0)).astype(dtype)
        has = jnp.sum(in_c) > 0
        _, centers = kmeans(key_j, means_flat, sr,
                            weights=jnp.where(has, in_c, valid))
        return jnp.where(has, centers, global_centers)

    keys = jax.random.split(k2, kr)
    centers = jax.vmap(per_cluster)(jnp.arange(kr), keys)      # [Kr,Sr,D]

    v = jnp.full((kr, sr), hyps.v0 + nj_virt / sr + 1.0, dtype)
    lam = jnp.full((kr, sr), hyps.lambda0 + nj_virt / sr, dtype)
    # NOTE: the FIRST base HMM's FIRST state covariance for every
    # (cluster, state) is the reference's exact recipe here —
    # `vbhemhmm_init.m:411-419` uses h3m_b.hmm{1,1}.emit{1,1}.covars
    # for all W, full and diag alike.  (Unlike 'random', which pools
    # member covariances — see init_random.)
    cov_ref = base.hmm.cov[0, 0]                               # first base cov
    w = _emission_w_from_cov(jnp.broadcast_to(cov_ref, (kr, sr, d, d)), v)

    kp, ka = jax.random.split(k4)
    prior = jax.random.uniform(kp, (kr, sr), dtype)
    prior = prior / jnp.sum(prior, -1, keepdims=True)
    a = jax.random.uniform(ka, (kr, sr, sr), dtype)
    a = a / jnp.sum(a, -1, keepdims=True)
    eta = prior * nj_virt + hyps.eta0
    epsilon = a * nj_virt + hyps.epsilon0
    alpha = hyps.alpha0 + jnp.full((kr,), nj_virt, dtype)
    return H3MPosterior(alpha=alpha, eta=eta, epsilon=epsilon,
                        niw=NIW(beta=lam, v=v, m=centers, w=w))


def init_random(key: jax.Array, base: H3M, kr: int, sr: int,
                hyps: VBHEMHyps, nv: int) -> H3MPosterior:
    """'random' initializer (`vbhemhmm_init.m:874-1038`): random
    partition of base HMMs into clusters (every cluster guaranteed
    non-empty, as the reference's resample-until loop ensures), a
    per-cluster Sr-component GMM fit on the member emission means,
    then the exact NIW/Dirichlet hyper-space conversion of
    `vbhemhmm_init.m:983-1030`: member masses `N_i = Nv*omega_b`,
    `Nj_rho = N_j * mix.weight`, posterior mean
    `m = (lambda0*m0 + Nj_rho*ybar)/lambda`, and
    `W = inv(W0inv + Nj_rho*Sigma + lam0*Nj_rho/(lam0+Nj_rho)
    (ybar-m0)(ybar-m0)')`.

    Design deltas (documented): the reference's small-pool edge cases
    (Sr==1 single Gaussian, Nd<=Sr iid-variance padding,
    `vbhemhmm_init.m:911-928`) are absorbed by the always-ridge
    weighted EM fit, which degenerates to the same means-as-points /
    pooled-variance behavior under jit."""
    from ..ops.gmm import fit_gmm
    dtype = base.hmm.mean.dtype
    kb, sb_max = base.state_mask.shape
    d = base.hmm.mean.shape[-1]

    k1, k2 = jax.random.split(key)
    # random partition with every cluster non-empty: the first Kr HMMs
    # of a random permutation get distinct labels, the rest are uniform
    perm = jax.random.permutation(k1, kb)
    rand_lab = jax.random.randint(jax.random.fold_in(k1, 1), (kb,), 0, kr,
                                  dtype=jnp.int32)
    labels = jnp.zeros((kb,), jnp.int32)
    # clamp to kb: when kr > kb the extra clusters simply stay empty
    npin = min(kr, kb)
    labels = labels.at[perm[:npin]].set(jnp.arange(npin, dtype=jnp.int32))
    labels = labels.at[perm[npin:]].set(rand_lab[perm[npin:]])

    means_flat = base.hmm.mean.reshape(kb * sb_max, d)
    base_of = jnp.repeat(jnp.arange(kb), sb_max)
    valid = base.state_mask.reshape(-1)

    def per_cluster(j, key_j):
        w_c = ((labels[base_of] == j) & valid).astype(dtype)
        return fit_gmm(key_j, means_flat, sr, weights=w_c,
                       start_weighted=True)

    mix = jax.vmap(per_cluster)(jnp.arange(kr), jax.random.split(k2, kr))
    # mix.weight [Kr,Sr], mix.mean [Kr,Sr,D], mix.cov [Kr,Sr,D,D]

    # member masses (`vbhemhmm_init.m:983-987`)
    n_i = nv * base.omega                                      # [Kb]
    one_hot = (labels[:, None] == jnp.arange(kr)[None]).astype(dtype)
    n_j = jnp.sum(one_hot * n_i[:, None], axis=0)              # [Kr]

    nj_rho = n_j[:, None] * mix.weight                         # [Kr,Sr]
    lam = hyps.lambda0 + nj_rho
    v = hyps.v0 + nj_rho + 1.0
    ybar = mix.mean
    m = (hyps.lambda0 * hyps.m0 + nj_rho[..., None] * ybar) \
        / lam[..., None]
    mult1 = (hyps.lambda0 * nj_rho / (hyps.lambda0 + nj_rho))
    diff = ybar - hyps.m0                                      # [Kr,Sr,D]
    w0inv = jnp.diag(hyps.w0inv_diag).astype(dtype)
    w_inv = (w0inv + nj_rho[..., None, None] * mix.cov
             + mult1[..., None, None] * diff[..., :, None]
             * diff[..., None, :])
    w = inv_psd(w_inv)

    eta = hyps.eta0 + jnp.broadcast_to((n_j / sr)[:, None], (kr, sr))
    epsilon = hyps.epsilon0 + jnp.broadcast_to(
        (n_j / sr)[:, None, None], (kr, sr, sr))
    alpha = hyps.alpha0 + n_j
    return H3MPosterior(alpha=alpha, eta=eta, epsilon=epsilon,
                        niw=NIW(beta=lam, v=v, m=m, w=w))


def init_gmmNew(key: jax.Array, base: H3M, kr: int, sr: int,
                hyps: VBHEMHyps, nv: int) -> H3MPosterior:
    """'gmmNew' initializer (`vbhemhmm_init.m:103-291`): pool all base
    emission Gaussians, reduce them to Sr shared components with
    mixture-hierarchies EM (`GMM_MixHierEM.m`), use the reduced
    Gaussians as every cluster's emissions; priors/transitions random,
    cluster weights random, converted to hyperparameter space via the
    virtual counts Nsj = omega_j * Nv_total (`vbhemhmm_init.m:258-291`)."""
    from ..ops.gmm import mix_hier_em
    dtype = base.hmm.mean.dtype
    kb, sb_max = base.state_mask.shape
    d = base.hmm.mean.shape[-1]
    nv_total = nv * kb

    k1, k2, k3 = jax.random.split(key, 3)
    means_flat = base.hmm.mean.reshape(kb * sb_max, d)
    covs_flat = base.hmm.cov.reshape(kb * sb_max, d, d)
    pool_w = base.state_mask.reshape(-1).astype(dtype)
    red, _ = mix_hier_em(k1, means_flat, covs_flat, pool_w, sr, nv=nv)

    omega = jax.random.uniform(k2, (kr,), dtype)
    omega = omega / jnp.sum(omega)
    nsj = omega * nv_total                                     # [Kr]
    nsj_rho = jnp.broadcast_to(nsj[:, None] / sr, (kr, sr))    # [Kr, Sr]

    v = hyps.v0 + nsj_rho + 1.0
    lam = hyps.lambda0 + nsj_rho
    m = jnp.broadcast_to(red.mean[None], (kr, sr, d))
    w = _emission_w_from_cov(jnp.broadcast_to(red.cov[None], (kr, sr, d, d)),
                             v)

    kp, ka = jax.random.split(k3)
    prior = jax.random.uniform(kp, (kr, sr), dtype)
    prior = prior / jnp.sum(prior, -1, keepdims=True)
    a = jax.random.uniform(ka, (kr, sr, sr), dtype)
    a = a / jnp.sum(a, -1, keepdims=True)
    eta = prior * nsj[:, None] + hyps.eta0
    epsilon = a * nsj[:, None, None] + hyps.epsilon0
    alpha = hyps.alpha0 + nsj
    return H3MPosterior(alpha=alpha, eta=eta, epsilon=epsilon,
                        niw=NIW(beta=lam, v=v, m=m, w=w))


def init_gmmNew2(key: jax.Array, base: H3M, kr: int, sr: int,
                 hyps: VBHEMHyps, nv: int) -> H3MPosterior:
    """'gmmNew2' (`vbhemhmm_init.m:103-291`, tmpK = Sr*Kr branch):
    like gmmNew but reduces the pooled bank to Kr*Sr components and
    gives each cluster its own random block of Sr Gaussians."""
    from ..ops.gmm import mix_hier_em
    dtype = base.hmm.mean.dtype
    kb, sb_max = base.state_mask.shape
    d = base.hmm.mean.shape[-1]
    nv_total = nv * kb

    k1, k2, k3, k4 = jax.random.split(key, 4)
    red, _ = mix_hier_em(k1, base.hmm.mean.reshape(kb * sb_max, d),
                         base.hmm.cov.reshape(kb * sb_max, d, d),
                         base.state_mask.reshape(-1).astype(dtype),
                         kr * sr, nv=nv)
    # random permutation -> [Kr, Sr] assignment of reduced Gaussians
    use = jax.random.permutation(k2, kr * sr).reshape(kr, sr)
    m = red.mean[use]                                          # [Kr,Sr,D]
    covs = red.cov[use]

    omega = jax.random.uniform(k3, (kr,), dtype)
    omega = omega / jnp.sum(omega)
    nsj = omega * nv_total
    nsj_rho = jnp.broadcast_to(nsj[:, None] / sr, (kr, sr))
    v = hyps.v0 + nsj_rho + 1.0
    lam = hyps.lambda0 + nsj_rho
    w = _emission_w_from_cov(covs, v)

    kp, ka = jax.random.split(k4)
    prior = jax.random.uniform(kp, (kr, sr), dtype)
    prior = prior / jnp.sum(prior, -1, keepdims=True)
    a = jax.random.uniform(ka, (kr, sr, sr), dtype)
    a = a / jnp.sum(a, -1, keepdims=True)
    return H3MPosterior(alpha=hyps.alpha0 + nsj,
                        eta=prior * nsj[:, None] + hyps.eta0,
                        epsilon=a * nsj[:, None, None] + hyps.epsilon0,
                        niw=NIW(beta=lam, v=v, m=m, w=w))


_INITIALIZERS = {
    "baseem": init_baseem,
    "gmmNew": init_gmmNew,
    "gmmNew2": init_gmmNew2,
    "wtkmeans": init_wtkmeans,
    "random": init_random,
}


def resolve_initmode(mode: str) -> str:
    """Validate an initmode for a single-mode fitting entry point.

    'auto' (try-all over baseem/gmmNew/wtkmeans,
    `vbhem_h3m_cluster.m:363-399`) is implemented by the
    :func:`cluster` / :func:`cluster_batched` front-ends, which run the
    single-mode workers once per mode; the workers themselves must not
    silently reinterpret it."""
    if mode == "auto":
        raise ValueError(
            "initmode='auto' is a front-end (cluster/cluster_batched) "
            "feature; this single-mode entry point needs an explicit "
            "initmode from " + str(sorted(_INITIALIZERS)))
    if mode not in _INITIALIZERS:
        raise ValueError(f"unknown initmode {mode!r}; expected one of "
                         f"{sorted(_INITIALIZERS)} (or 'auto' via the "
                         f"cluster front-ends)")
    return mode


# ---------------------------------------------------------------------------
# trials + (K,S) sweep (vbhem_h3m_c.m / vbhem_h3m_cluster.m)
# ---------------------------------------------------------------------------

class VBHEMResult(NamedTuple):
    """Final packaged model (`form_outputH3M.m`)."""
    post: H3MPosterior
    h3m: H3M                # point-estimate form
    ll: jnp.ndarray
    hat_z: jnp.ndarray      # [Kb, Kr]
    ll_elbo: jnp.ndarray    # [Kb, Kr]
    nj: jnp.ndarray         # [Kr]
    label: jnp.ndarray      # [Kb] hard assignments
    counts_n1: jnp.ndarray  # [Kr, Sr]
    counts: jnp.ndarray     # [Kr, Sr]
    trans_counts: jnp.ndarray  # [Kr, Sr, Sr]

    @property
    def groups(self):
        import numpy as np
        lab = np.asarray(self.label)
        return [list(np.where(lab == j)[0]) for j in range(self.nj.shape[-1])]


def finalize(st: VBHEMState) -> VBHEMResult:
    return VBHEMResult(
        post=st.post, h3m=st.post.to_h3m(), ll=st.ll, hat_z=st.hat_z,
        ll_elbo=st.ll_elbo, nj=st.stats.nj,
        label=jnp.argmax(st.hat_z, axis=-1),
        counts_n1=st.stats.nj_rho1, counts=st.stats.nj_rho,
        trans_counts=st.stats.nj_rho2rho)


def fit_single_ks(key: jax.Array, base: H3M, kr: int, sr: int,
                  config: VBHEMConfig,
                  hyps: Optional[VBHEMHyps] = None,
                  initmode: Optional[str] = None) -> VBHEMState:
    """Vmapped random restarts for one (K, S) cell (`vbhem_h3m_c.m:28-76`).
    Returns the batched VBHEMState over trials (best selected by caller)."""
    dtype = base.hmm.mean.dtype
    if hyps is None:
        hyps = VBHEMHyps.from_config(config, base.hmm.mean.shape[-1], dtype)
    mode = resolve_initmode(initmode or config.initmode)
    init_fn = _INITIALIZERS[mode]

    def one_trial(trial_key):
        post0 = init_fn(trial_key, base, kr, sr, hyps, config.nv)
        return vbhem_em(base, post0, hyps, nv=config.nv, tau=config.tau,
                        max_iter=config.max_iter, min_diff=config.min_diff,
                        covar_type=config.covar_type)

    keys = jax.random.split(key, config.trials)
    return jax.vmap(one_trial)(keys)


def select_best_trial(states: VBHEMState) -> VBHEMState:
    best = jnp.argmax(states.ll)
    return jax.tree.map(lambda a: a[best], states)


def optimize_solution_hyps(base: H3M, init_post: H3MPosterior,
                           hyps0: VBHEMHyps, config: VBHEMConfig):
    """Empirical-Bayes hyp optimization for one VBHEM solution
    (`vbhem_h3m_c_hyp.m`): each objective eval re-runs the VBHEM EM from
    the same initial posterior (the reference's 'inith3m' restart,
    `vbhem_h3m_c_hyp.m:105-137`) with candidate hyps; gradient =
    dELBO/dhyps at the fixed point via autodiff."""
    from .. import hyp as hypmod

    dim = base.hmm.mean.shape[-1]
    specs = hypmod.vbhem_specs(dim, config.bounds, config.learn_hyps_keys)
    kb = base.num_hmms
    tilde_n = (config.nv * kb) * base.omega

    def neg_elbo(hyps: VBHEMHyps):
        st = vbhem_em(base, init_post, jax.lax.stop_gradient(hyps),
                      nv=config.nv, tau=config.tau,
                      max_iter=config.max_iter, min_diff=config.min_diff,
                      covar_type=config.covar_type)
        post = jax.lax.stop_gradient(st.post)
        exps = reduced_expectations(post)
        pair = e_step(base, post, exps, config.tau)
        hat_z, z_ni, nj = soft_assignments(tilde_n, exps.log_omega,
                                           pair.ll_elbo)
        return -elbo(post, exps, pair, hat_z, z_ni, nj, hyps)

    hyps_opt, info = hypmod.optimize_hyps(neg_elbo, hyps0, specs)
    st = vbhem_em(base, init_post, hyps_opt, nv=config.nv, tau=config.tau,
                  max_iter=config.max_iter, min_diff=config.min_diff,
                  covar_type=config.covar_type)
    return hyps_opt, st, info


def optimize_solution_hyps_batched(base: H3M, init_posts: H3MPosterior,
                                   hyps0: VBHEMHyps, config: VBHEMConfig):
    """Hyp-optimize a BANK of solutions (leading lane axis on
    ``init_posts``) in one vmapped L-BFGS program — the reference
    parfors exactly this loop (`vbhem_h3m_c.m:96-160`).  Returns
    (hyps with lane axis, final VBHEMStates with lane axis)."""
    from .. import hyp as hypmod

    dim = base.hmm.mean.shape[-1]
    specs = hypmod.vbhem_specs(dim, config.bounds, config.learn_hyps_keys)
    kb = base.num_hmms
    tilde_n = (config.nv * kb) * base.omega

    def neg_elbo(hyps: VBHEMHyps, init_post: H3MPosterior):
        st = vbhem_em(base, init_post, jax.lax.stop_gradient(hyps),
                      nv=config.nv, tau=config.tau,
                      max_iter=config.max_iter, min_diff=config.min_diff,
                      covar_type=config.covar_type)
        post = jax.lax.stop_gradient(st.post)
        exps = reduced_expectations(post)
        pair = e_step(base, post, exps, config.tau)
        hat_z, z_ni, nj = soft_assignments(tilde_n, exps.log_omega,
                                           pair.ll_elbo)
        return -elbo(post, exps, pair, hat_z, z_ni, nj, hyps)

    hyps_b, _, _ = hypmod.optimize_hyps_batched(
        neg_elbo, hyps0, specs, (init_posts,),
        max_steps=config.hyp_max_steps)

    def rerun(h, p):
        return vbhem_em(base, p, h, nv=config.nv, tau=config.tau,
                        max_iter=config.max_iter, min_diff=config.min_diff,
                        covar_type=config.covar_type)

    sts = jax.jit(jax.vmap(rerun))(hyps_b, init_posts)
    return hyps_b, sts


def cluster(key: jax.Array, base: H3M, k, s,
            config: VBHEMConfig = VBHEMConfig(),
            hyps: Optional[VBHEMHyps] = None):
    """(K, S) model-selection sweep (`vbhem_h3m_cluster.m:253-354`).

    ``k``/``s`` may be ints or sequences.  Grid cells are scored by
    ``LL + gammaln(K+1) + gammaln(S+1)`` — the multiple-parameterization
    corrections applied at `:280` and `:334`.  'auto' initmode tries
    {baseem, gmmNew, wtkmeans} per cell and keeps the best
    (`vbhem_h3m_cluster.m:363-399`).
    Returns (VBHEMResult, info dict).
    """
    import numpy as np
    ks = list(k) if isinstance(k, (list, tuple, range)) else [int(k)]
    ss = list(s) if isinstance(s, (list, tuple, range)) else [int(s)]
    modes = (["baseem", "gmmNew", "wtkmeans"] if config.initmode == "auto"
             else [config.initmode])

    dim = base.hmm.mean.shape[-1]
    hyps0 = hyps if hyps is not None else VBHEMHyps.from_config(
        config, dim, base.hmm.mean.dtype)

    results = {}
    scores = np.full((len(ks), len(ss)), -np.inf)
    for ki, kk in enumerate(ks):
        for si, sv in enumerate(ss):
            cell_key = jax.random.fold_in(jax.random.fold_in(key, ki), si)
            best_st, best_ll = None, -np.inf
            for mi, mode in enumerate(modes):
                states = fit_single_ks(
                    jax.random.fold_in(cell_key, mi), base, kk, sv,
                    config, hyps0, initmode=mode)
                if config.learn_hyps:
                    # hyp-optimize each unique restart solution in ONE
                    # vmapped L-BFGS program (`vbhem_h3m_c.m:96-160`)
                    from .. import hyp as hypmod
                    uniq = hypmod.unique_ll(np.asarray(states.ll),
                                            config.min_diff)
                    if config.max_hyp_solutions is not None:
                        uniq = uniq[:config.max_hyp_solutions]
                    if len(uniq) == 0:
                        uniq = np.asarray(
                            [int(np.argmax(np.asarray(states.ll)))])
                    uniq = hypmod.pad_lanes(uniq, bucket=4)
                    idx = jnp.asarray(np.asarray(uniq))
                    init_posts = jax.tree.map(lambda a: a[idx], states.post)
                    _, sts = optimize_solution_hyps_batched(
                        base, init_posts, hyps0, config)
                    pre = jax.tree.map(lambda a: a[idx], states)
                    sts, n_bad, _ = hypmod.fallback_degenerate_lanes(
                        sts, pre, pre.ll, sts.ll)
                    if n_bad and config.verbose >= 1:
                        print(f"  [hyp] {n_bad} degenerate lane(s) "
                              f"reverted (K={kk},S={sv})", flush=True)
                    bi_l = int(jnp.argmax(sts.ll))
                    st_opt = jax.tree.map(lambda a: a[bi_l], sts)
                    cand = float(st_opt.ll)
                    cand = cand if np.isfinite(cand) else -np.inf
                    if best_st is None or cand > best_ll:
                        best_st, best_ll = st_opt, cand
                else:
                    st = select_best_trial(states)
                    cand = float(st.ll)
                    # NaN ll (every trial unstable) must not leave
                    # best_st = None: coalesce to -inf and keep SOME
                    # state so finalize() has a model to package
                    cand = cand if np.isfinite(cand) else -np.inf
                    if best_st is None or cand > best_ll:
                        best_st, best_ll = st, cand
            results[(kk, sv)] = finalize(best_st)
            scores[ki, si] = best_ll + float(gammaln(kk + 1)) \
                + float(gammaln(sv + 1))

    best_k, best_s, model_ll_k, s_star = _two_stage_select(scores, ks, ss)
    from .vbhmm import _version
    info = {"model_ll": scores, "model_ll_k": model_ll_k,
            "model_best_s_per_k": s_star, "model_k": ks, "model_s": ss,
            "model_best_k": best_k, "model_best_s": best_s,
            "model_all": results, "vbhemopt": config,
            "version": _version()}
    return results[(best_k, best_s)], info


def _two_stage_select(scores, ks, ss):
    """The reference's exact (K,S) selection rule
    (`vbhem_h3m_cluster.m:261-345`): per K pick S* maximizing
    LL + gammaln(S+1); then pick K maximizing the per-K winner's RAW
    LL + gammaln(K+1) — the S-stage correction does NOT propagate to
    the K stage (`out_all{ki}.LL` is the raw cell LL, `:276-283`).
    A joint argmax of LL + gammaln(K+1) + gammaln(S+1) is a different
    objective (differs by gammaln(S*+1) varying across K) and can flip
    near-ties.

    ``scores`` is the [nK, nS] grid of LL + gammaln(K+1) + gammaln(S+1)
    (both corrections), from which both stages are derived exactly.
    Returns (best_k, best_s, model_ll_k, s_star_per_k)."""
    import numpy as np
    from jax.scipy.special import gammaln as _gl
    scores = np.asarray(scores)
    # per-K S*: gammaln(K+1) is constant along a row, so the row argmax
    # of `scores` equals the argmax of LL + gammaln(S+1)
    s_star = np.argmax(scores, axis=1)                       # [nK]
    s_corr = np.asarray([float(_gl(s + 1)) for s in ss])
    # K stage: raw LL + gammaln(K+1) = scores - gammaln(S*+1)
    model_ll_k = scores[np.arange(len(ks)), s_star] - s_corr[s_star]
    # all-(-inf) rows (every cell failed) must not crash the argmax
    if not np.isfinite(model_ll_k).any():
        return ks[0], ss[0], model_ll_k, [ss[i] for i in s_star]
    bi = int(np.argmax(model_ll_k))
    return ks[bi], ss[s_star[bi]], model_ll_k, [ss[i] for i in s_star]


def to_hmm_list(res: VBHEMResult, state_thresh: float = 1e-3):
    """Reduced H3M -> list of per-cluster point-estimate HMMs with
    low-count states pruned (`convert_h3m2hmms.m` + the per-HMM pruning
    of `vbh3m_remove_empty.m:63-76`).  Host-side (ragged shapes)."""
    import numpy as np
    out = []
    counts = np.asarray(res.counts)
    for j in range(res.h3m.omega.shape[-1]):
        keep = np.where(counts[j] >= state_thresh)[0]
        if len(keep) == 0:
            keep = np.asarray([int(np.argmax(counts[j]))])
        p = np.asarray(res.h3m.hmm.prior[j])[keep]
        a = np.asarray(res.h3m.hmm.trans[j])[np.ix_(keep, keep)]
        p = p / p.sum()
        a = a / np.maximum(a.sum(-1, keepdims=True), 1e-300)
        out.append(HMM(prior=jnp.asarray(p), trans=jnp.asarray(a),
                       mean=res.h3m.hmm.mean[j][jnp.asarray(keep)],
                       cov=res.h3m.hmm.cov[j][jnp.asarray(keep)]))
    return out


def remove_empty_clusters(res: VBHEMResult, cluster_thresh: float = 1.0,
                          state_thresh: float = 1e-3) -> VBHEMResult:
    """Post-hoc pruning (`vbh3m_remove_empty.m`): drop clusters with
    Nj < cluster_thresh, renormalize, relabel.  (Per-cluster state
    pruning produces ragged shapes; states with count < state_thresh are
    reported via ``counts`` and dropped when converting to HMM lists.)"""
    import numpy as np
    nj = np.asarray(res.nj)
    keep = np.where(nj >= cluster_thresh)[0]
    if len(keep) == len(nj):
        return res
    perm = jnp.asarray(keep)
    post = H3MPosterior(
        alpha=res.post.alpha[perm], eta=res.post.eta[perm],
        epsilon=res.post.epsilon[perm],
        niw=NIW(beta=res.post.niw.beta[perm], v=res.post.niw.v[perm],
                m=res.post.niw.m[perm], w=res.post.niw.w[perm]))
    hat_z = res.hat_z[:, perm]
    hat_z = hat_z / jnp.sum(hat_z, axis=-1, keepdims=True)
    return VBHEMResult(
        post=post, h3m=post.to_h3m(), ll=res.ll, hat_z=hat_z,
        ll_elbo=res.ll_elbo[:, perm], nj=res.nj[perm],
        label=jnp.argmax(hat_z, axis=-1),
        counts_n1=res.counts_n1[perm], counts=res.counts[perm],
        trans_counts=res.trans_counts[perm])


def vbh3m_remove_empty(res: VBHEMResult, cluster_thresh: float = 1.0,
                       state_thresh: float = 1e-3,
                       sortclusters: str = "f"):
    """Full `vbh3m_remove_empty.m` semantics: (1) drop clusters with
    Nj < cluster_thresh and renormalize/relabel (`:15-59`,
    :func:`remove_empty_clusters`); (2) prune each surviving cluster
    HMM's states with soft count < state_thresh (`:63-76`, the
    reference's ``vbhmm_remove_empty(hmm, 0, 1e-3)``); (3) standardize
    each pruned HMM's state order (`:80-83`).

    Returns ``(cluster_pruned_result, hmm_list)`` where ``hmm_list`` is
    the reference's ``h3mo.hmm`` — per-cluster state-pruned,
    standardized :class:`VBHMMResult`s (ragged state counts live on the
    host; the dense pytree keeps the cluster-pruned grid)."""
    from ..containers import HMMPosterior, VBHMMResult as VBR
    from . import vbhmm as vbhmm_mod
    res = remove_empty_clusters(res, cluster_thresh=cluster_thresh,
                                state_thresh=state_thresh)
    hmms = []
    for j in range(res.post.alpha.shape[-1]):
        post_j = HMMPosterior(
            alpha=res.post.eta[j], epsilon=res.post.epsilon[j],
            niw=NIW(beta=res.post.niw.beta[j], v=res.post.niw.v[j],
                    m=res.post.niw.m[j], w=res.post.niw.w[j]))
        sr = post_j.alpha.shape[-1]
        r_j = VBR(post=post_j, model=post_j.to_point(), ll=res.ll,
                  gamma=jnp.zeros((1, 1, sr), res.post.eta.dtype),
                  counts_n1=res.counts_n1[j], counts=res.counts[j],
                  trans_counts=res.trans_counts[j],
                  state_mask=jnp.ones((sr,), bool))
        r_j, _, _ = vbhmm_mod.remove_empty(r_j, thresh=state_thresh)
        hmms.append(vbhmm_mod.standardize(r_j, sortclusters))
    return res, hmms


# ---------------------------------------------------------------------------
# Single-program padded (K,S) sweep (SURVEY.md section 7.1: the grid as a
# flat batch of masked cells — ONE compile for the whole model-selection
# sweep, cells x trials vmapped/shardable, instead of one XLA program per
# (K,S) cell)
# ---------------------------------------------------------------------------

def reduced_expectations_masked(post: H3MPosterior, cmask: jnp.ndarray,
                                smask: jnp.ndarray) -> ReducedExpectations:
    """Digamma expectations of a PADDED reduced model: normalizers run
    over active entries only; masked entries carry a large-negative
    finite score so every downstream exp() is exactly zero."""
    from ..utils.numeric import masked_e_log_dirichlet
    sm = smask[None, :]
    return ReducedExpectations(
        log_omega=masked_e_log_dirichlet(post.alpha, cmask),
        log_pi=masked_e_log_dirichlet(post.eta, sm),
        log_a=masked_e_log_dirichlet(post.epsilon, smask[None, None, :]),
        log_lam=e_log_det_lambda(post.niw.v, post.niw.w))


def elbo_masked(post: H3MPosterior, exps: ReducedExpectations,
                pair: PairStats, hat_z: jnp.ndarray, z_ni: jnp.ndarray,
                nj: jnp.ndarray, hyps: VBHEMHyps, cmask: jnp.ndarray,
                smask: jnp.ndarray) -> jnp.ndarray:
    """The 10-term bound over the ACTIVE sub-grid of a padded cell —
    numerically equal to :func:`elbo` on the unpadded (K, S) model."""
    from ..utils.numeric import masked_log_dirichlet_const
    dtype = hat_z.dtype
    d = post.niw.dim
    niw = post.niw
    two_pi = jnp.asarray(2.0 * jnp.pi, dtype)
    cm = cmask.astype(dtype)                                  # [K]
    sm = smask.astype(dtype)                                  # [S]
    cs = cm[:, None] * sm[None, :]                            # [K,S]
    css = cs[:, :, None] * sm[None, None, :]                  # [K,S,S]
    kr_a = jnp.sum(cm)
    sr_a = jnp.sum(sm)

    logdet_w0inv = jnp.sum(jnp.log(hyps.w0inv_diag))
    log_c_alpha0 = gammaln(kr_a * hyps.alpha0) - kr_a * gammaln(hyps.alpha0)
    log_c_eta0 = gammaln(sr_a * hyps.eta0) - sr_a * gammaln(hyps.eta0)
    log_c_eps0 = gammaln(sr_a * hyps.epsilon0) \
        - sr_a * gammaln(hyps.epsilon0)
    log_b0 = log_wishart_b(logdet_w0inv, hyps.v0, d)

    lt1 = jnp.sum(cm[None, :] * z_ni * pair.ll_elbo)
    lt7 = jnp.sum(cm[None, :] * hat_z * jnp.log(hat_z))
    lt2 = jnp.sum(cm * nj * exps.log_omega)
    lt3 = kr_a * log_c_eta0 + (hyps.eta0 - 1.0) * jnp.sum(cs * exps.log_pi)
    lt4 = kr_a * sr_a * log_c_eps0 \
        + (hyps.epsilon0 - 1.0) * jnp.sum(css * exps.log_a)

    dm = niw.m - hyps.m0
    m_w_m = jnp.einsum("jrd,jrde,jre->jr", dm, niw.w, dm)
    w0inv_diag = hyps.w0inv_diag.astype(dtype)
    tr_w0inv_w = jnp.einsum("d,jrdd->jr", w0inv_diag, niw.w)
    const2 = d * jnp.log(hyps.lambda0 / two_pi)
    lt51 = 0.5 * jnp.sum(cs * (const2 + exps.log_lam
                               - d * hyps.lambda0 / niw.beta
                               - hyps.lambda0 * niw.v * m_w_m))
    lt52 = (kr_a * sr_a * log_b0
            + 0.5 * (hyps.v0 - d - 1.0) * jnp.sum(cs * exps.log_lam)
            - 0.5 * jnp.sum(cs * niw.v * tr_w0inv_w))
    lt5 = lt51 + lt52

    lt6 = log_c_alpha0 + (hyps.alpha0 - 1.0) * jnp.sum(cm * exps.log_omega)
    lt8 = masked_log_dirichlet_const(post.alpha, cmask) \
        + jnp.sum(cm * (post.alpha - 1.0) * exps.log_omega)
    lt9 = (jnp.sum(cm * masked_log_dirichlet_const(post.eta,
                                                   smask[None, :]))
           + jnp.sum(cs * (post.eta - 1.0) * exps.log_pi)
           + jnp.sum(cs * masked_log_dirichlet_const(
               post.epsilon, smask[None, None, :]))
           + jnp.sum(css * (post.epsilon - 1.0) * exps.log_a))

    log_bk = log_wishart_b(-logdet_psd(niw.w), niw.v, d)
    h_ent = jnp.sum(cs * (-log_bk - 0.5 * (niw.v - d - 1.0) * exps.log_lam
                          + 0.5 * niw.v * d))
    lt10 = 0.5 * jnp.sum(cs * (exps.log_lam
                               + d * jnp.log(niw.beta / two_pi))) \
        - 0.5 * d * kr_a * sr_a - h_ent

    return lt1 + lt2 + lt3 + lt4 + lt5 + lt6 - lt7 - lt8 - lt9 - lt10


def vbhem_em_masked(base: H3M, init_post: H3MPosterior, hyps: VBHEMHyps,
                    nv: int, tau: int, cmask: jnp.ndarray,
                    smask: jnp.ndarray, max_iter: int = 200,
                    min_diff: float = 1e-5,
                    covar_type: str = "full") -> VBHEMState:
    """:func:`vbhem_em` over a PADDED (Kmax, Smax) cell: cluster/state
    masks confine all probability mass to the active sub-grid, so every
    (K, S) grid cell runs as the same compiled program."""
    dtype = base.hmm.mean.dtype
    kb = base.num_hmms
    tilde_n = (nv * kb) * base.omega
    big_neg = jnp.asarray(-jnp.finfo(dtype).max, dtype)
    if covar_type == "diag":
        init_post = _project_diag(init_post)

    def body(st: VBHEMState) -> VBHEMState:
        exps = reduced_expectations_masked(st.post, cmask, smask)
        pair = e_step(base, st.post, exps, tau)
        hat_z, z_ni, nj = soft_assignments(tilde_n, exps.log_omega,
                                           pair.ll_elbo)
        ll = elbo_masked(st.post, exps, pair, hat_z, z_ni, nj, hyps,
                         cmask, smask)
        unstable = jnp.isnan(ll)
        ll = jnp.where(unstable, -jnp.inf, ll)
        lik_incr = jnp.abs((ll - st.ll) / st.ll)
        converged = jnp.logical_and(st.it > 0, lik_incr <= min_diff)
        done = converged | unstable | (st.it + 1 >= max_iter)
        stats = aggregate_stats(base, pair, z_ni, nj)
        new_post = m_step(stats, hyps, covar_type)
        new_post = jax.tree.map(
            lambda new, old: jnp.where(unstable, old, new), new_post,
            st.post)
        return VBHEMState(post=new_post, ll=ll, last_ll=st.ll,
                          it=st.it + 1, hat_z=hat_z,
                          ll_elbo=pair.ll_elbo, stats=stats, done=done)

    kr, sr = init_post.num_clusters, init_post.num_states
    d = init_post.niw.dim
    # big_neg is made (vacuously) data-dependent so the carry's ll /
    # last_ll inherit the varying-manual-axes of the inputs under
    # shard_map (a bare constant is 'unvarying' and rejected).
    ll0 = big_neg + jnp.zeros((), dtype) * jnp.sum(init_post.alpha)
    st0 = VBHEMState(
        post=init_post, ll=ll0, last_ll=ll0, it=jnp.asarray(0),
        hat_z=jnp.zeros((kb, kr), dtype),
        ll_elbo=jnp.zeros((kb, kr), dtype),
        stats=ClusterStats(
            nj=jnp.zeros((kr,), dtype), nj_rho1=jnp.zeros((kr, sr), dtype),
            nj_rho2rho=jnp.zeros((kr, sr, sr), dtype),
            nj_rho=jnp.zeros((kr, sr), dtype),
            y_bar=jnp.zeros((kr, sr, d), dtype),
            s_plus_c=jnp.zeros((kr, sr, d, d), dtype)),
        done=jnp.asarray(False))
    # First iteration outside the loop (the loop body always ran at
    # least once): the carry then inherits its varying-manual-axes from
    # the actual inputs, which shard_map's while_loop vma check requires
    # (constant-initialized carries are unvarying and get rejected).
    st1 = body(st0)
    return jax.lax.while_loop(lambda st: ~st.done, body, st1)


def fit_grid_batched(key: jax.Array, base: H3M, ks, ss,
                     config: VBHEMConfig, hyps: VBHEMHyps,
                     initmode: Optional[str] = None,
                     trial_chunk: Optional[int] = None):
    """The whole (K,S) x trials sweep as ONE compiled program.

    Every cell is padded to (max K, max S) with cluster/state masks and
    all cells x trials are vmapped together.  Returns
    (per-cell-and-trial VBHEMState with leading [n_cells, trials] axes,
    cells list, cmasks, smasks).  Compile count: 1 (vs len(ks)*len(ss)
    for the per-cell path) — the sweep is also shardable across devices
    by the leading axis.
    """
    import numpy as np
    ks, ss = list(ks), list(ss)
    kmax, smax = max(ks), max(ss)
    cells = [(k, s) for k in ks for s in ss]
    cmasks = jnp.asarray(np.stack(
        [np.arange(kmax) < k for k, _ in cells]))
    smasks = jnp.asarray(np.stack(
        [np.arange(smax) < s for _, s in cells]))

    mode = resolve_initmode(initmode or config.initmode)
    init_fn = _INITIALIZERS[mode]

    def one(cell_key, cmask, smask):
        post0 = init_fn(cell_key, base, kmax, smax, hyps, config.nv)
        return vbhem_em_masked(base, post0, hyps, nv=config.nv,
                               tau=config.tau, cmask=cmask, smask=smask,
                               max_iter=config.max_iter,
                               min_diff=config.min_diff,
                               covar_type=config.covar_type)

    n_cells = len(cells)
    keys = jax.random.split(key, (n_cells, config.trials))
    if trial_chunk is None:
        trial_chunk = default_trial_chunk(base, max(ks), max(ss),
                                          config.tau, config.trials,
                                          n_cells)
    if trial_chunk and trial_chunk < config.trials * n_cells:
        # bound BOTH program size and live memory: the XLA pair E-step
        # stacks a [tau-1, Kb, K, S, Sb, S] theta tensor PER LANE, so
        # one program folding every (cell x trial) lane at benchmark
        # scale is large to compile and to hold.  Instead the (cell,
        # trial) lanes are FLATTENED and a single small vmapped program
        # (compiled once) is dispatched per lane-chunk from the host —
        # bounded memory, identical results.
        n_lanes = n_cells * config.trials
        flat_keys = keys.reshape(n_lanes)
        ci = jnp.repeat(jnp.arange(n_cells), config.trials)
        pad = (-n_lanes) % trial_chunk
        if pad:
            flat_keys = jnp.concatenate([flat_keys, flat_keys[:pad]])
            ci = jnp.concatenate([ci, ci[:pad]])
        chunk_fn = jax.jit(jax.vmap(one, in_axes=(0, 0, 0)))
        chunks = []
        n_chunks = (n_lanes + pad) // trial_chunk
        for c in range(n_chunks):
            if config.verbose >= 2:
                print(f"  sweep lane-chunk {c + 1}/{n_chunks} "
                      f"({trial_chunk} lanes)", flush=True)
            sl = slice(c * trial_chunk, (c + 1) * trial_chunk)
            chunks.append(jax.block_until_ready(
                chunk_fn(flat_keys[sl], cmasks[ci[sl]], smasks[ci[sl]])))
        states = jax.tree.map(lambda *a: jnp.concatenate(a, axis=0),
                              *chunks)
        states = jax.tree.map(
            lambda a: a[:n_lanes].reshape(
                (n_cells, config.trials) + a.shape[1:]), states)
    else:
        run = jax.jit(jax.vmap(jax.vmap(one, in_axes=(0, None, None)),
                               in_axes=(0, 0, 0)))
        states = run(keys, cmasks, smasks)
    return states, cells, cmasks, smasks


def default_trial_chunk(base: H3M, kmax: int, smax: int, tau: int,
                        trials: int, n_cells: int) -> Optional[int]:
    """Pick a trials-axis chunk so the grid sweep's live lane memory
    stays ~<2 GB on the GPU (the XLA pair E-step materializes a
    [tau-1, Kb, K, S_b, S, S] theta stack per lane).  Returns None (no
    chunking) on CPU or when everything fits.  The 1 GB budget and the
    128-lane cap were inherited, not measured on the card."""
    if jax.default_backend() != "gpu":
        return None
    sb = base.hmm.prior.shape[-1]
    itemsize = jnp.dtype(base.hmm.mean.dtype).itemsize
    per_lane = max(tau - 1, 1) * base.num_hmms * kmax * smax * sb * smax \
        * itemsize
    budget = 1 * 1024 ** 3
    lanes = max(1, int(budget // max(per_lane, 1)))
    # also cap the per-dispatch program size
    lanes = min(lanes, 128)
    if lanes >= trials * n_cells:
        return None
    return lanes


def optimize_hyps_grid_batched(base: H3M, states: VBHEMState, cells,
                               cmasks: jnp.ndarray, smasks: jnp.ndarray,
                               config: VBHEMConfig, hyps0: VBHEMHyps):
    """Hyp-optimize every cell's uniqueLL survivors across the ENTIRE
    padded (K,S) grid in one vmapped L-BFGS program.

    The reference nests {grid recursion} x {parfor over unique
    solutions} (`vbhem_h3m_cluster.m:261-354` + `vbhem_h3m_c.m:96-160`);
    here every (cell, unique-solution) pair is one lane of a single
    compiled program over the padded masked representation.

    Returns (final VBHEMStates with leading lane axis, lane->cell index
    array, learned hyps with leading lane axis).
    """
    import numpy as np
    from .. import hyp as hypmod

    lls = np.asarray(states.ll)                        # [n_cells, trials]
    lanes = []
    for ci in range(len(cells)):
        uniq = hypmod.unique_ll(lls[ci], config.min_diff)
        if config.max_hyp_solutions is not None:
            uniq = uniq[:config.max_hyp_solutions]
        if len(uniq) == 0:
            uniq = [int(np.argmax(lls[ci]))]
        lanes.extend((ci, int(t)) for t in uniq)
    # pad the total lane count to a static bucket so the grid-level
    # L-BFGS program compiles once per bucket, not once per repeat
    while len(lanes) % 16:
        lanes.append(lanes[0])
    ci_idx = jnp.asarray([c for c, _ in lanes])
    tr_idx = jnp.asarray([t for _, t in lanes])
    init_posts = jax.tree.map(lambda a: a[ci_idx, tr_idx], states.post)
    cm = cmasks[ci_idx]
    sm = smasks[ci_idx]

    dim = base.hmm.mean.shape[-1]
    specs = hypmod.vbhem_specs(dim, config.bounds, config.learn_hyps_keys)
    kb = base.num_hmms
    tilde_n = (config.nv * kb) * base.omega

    def neg_elbo(hyps, init_post, cmask, smask):
        st = vbhem_em_masked(base, init_post, jax.lax.stop_gradient(hyps),
                             nv=config.nv, tau=config.tau, cmask=cmask,
                             smask=smask, max_iter=config.max_iter,
                             min_diff=config.min_diff,
                             covar_type=config.covar_type)
        post = jax.lax.stop_gradient(st.post)
        exps = reduced_expectations_masked(post, cmask, smask)
        pair = e_step(base, post, exps, config.tau)
        hat_z, z_ni, nj = soft_assignments(tilde_n, exps.log_omega,
                                           pair.ll_elbo)
        return -elbo_masked(post, exps, pair, hat_z, z_ni, nj, hyps,
                            cmask, smask)

    if jax.default_backend() == "gpu":
        # the host-outer-loop joint optimizer compiles only the vmapped
        # EM objective, not optimizer while_loops around the masked-EM
        # while_loop; which driver is faster on the card is not measured
        hyps_b, _, _ = hypmod.optimize_hyps_joint(
            neg_elbo, hyps0, specs, (init_posts, cm, sm),
            max_evals=2 * config.hyp_max_steps)
    else:
        hyps_b, _, _ = hypmod.optimize_hyps_batched(
            neg_elbo, hyps0, specs, (init_posts, cm, sm),
            max_steps=config.hyp_max_steps)

    def rerun(h, p, cmask, smask):
        return vbhem_em_masked(base, p, h, nv=config.nv, tau=config.tau,
                               cmask=cmask, smask=smask,
                               max_iter=config.max_iter,
                               min_diff=config.min_diff,
                               covar_type=config.covar_type)

    n_lanes = len(lanes)
    import os as _os
    chunk = (int(_os.environ.get("VBHEM_TPU_HYP_LANE_CHUNK", 64))
             if jax.default_backend() == "gpu" else n_lanes)
    if chunk < n_lanes:
        fn = jax.jit(jax.vmap(rerun))
        outs = []
        for a in range(0, n_lanes, chunk):
            sl = slice(a, min(a + chunk, n_lanes))
            size = sl.stop - sl.start
            args_c = jax.tree.map(lambda x: x[sl],
                                  (hyps_b, init_posts, cm, sm))
            # cyclic pad handles tails SMALLER than the pad amount
            if size < chunk:
                wrap = jnp.arange(chunk) % size
                args_c = jax.tree.map(lambda x: x[wrap], args_c)
            out = jax.block_until_ready(fn(*args_c))
            if size < chunk:
                out = jax.tree.map(lambda x: x[:size], out)
            outs.append(out)
        sts = jax.tree.map(lambda *x: jnp.concatenate(x, axis=0), *outs)
    else:
        sts = jax.jit(jax.vmap(rerun))(hyps_b, init_posts, cm, sm)
    # degenerate hyp-optimized lanes fall back to their pre-opt solution
    # (see hyp.degenerate_mask; `vbhem_h3m_c.m:175-180`)
    pre = jax.tree.map(lambda a: a[ci_idx, tr_idx], states)
    sts, n_bad, bad = hypmod.fallback_degenerate_lanes(
        sts, pre, pre.ll, sts.ll)
    # reverted lanes keep hyps0 (the hyps their kept state converged
    # under) so cell_hyps / f64 rescoring never pair a pre-opt posterior
    # with degenerate optimized hyps
    hyps_b = hypmod.substitute_lanes(hyps_b, hyps0, bad)
    if n_bad and config.verbose >= 1:
        print(f"  [hyp] {n_bad} degenerate hyp-optimized lane(s) "
              f"reverted to pre-optimization solutions", flush=True)
    return sts, np.asarray([c for c, _ in lanes]), hyps_b


def cluster_batched(key: jax.Array, base: H3M, k, s,
                    config: VBHEMConfig = VBHEMConfig(),
                    hyps: Optional[VBHEMHyps] = None):
    """(K,S) model selection via the single-program padded sweep.
    Same selection rule and return contract as :func:`cluster`, one
    compile for the whole grid; with ``config.learn_hyps`` the
    per-unique-solution hyp optimization also runs as one vmapped
    program over every (cell, solution) lane.

    'auto' initmode runs the sweep once per {baseem, gmmNew, wtkmeans}
    and concatenates the restarts along the trials axis (the reference
    keeps the best mode per cell, `vbhem_h3m_cluster.m:363-399`; taking
    the max over the union of all modes' trials selects the same
    winner — the only difference is that uniqueLL dedup then sees all
    modes' solutions together rather than per mode)."""
    import numpy as np
    ks = list(k) if isinstance(k, (list, tuple, range)) else [int(k)]
    ss = list(s) if isinstance(s, (list, tuple, range)) else [int(s)]
    dim = base.hmm.mean.shape[-1]
    hyps0 = hyps if hyps is not None else VBHEMHyps.from_config(
        config, dim, base.hmm.mean.dtype)

    modes = (["baseem", "gmmNew", "wtkmeans"]
             if config.initmode == "auto" else [config.initmode])
    per_mode = []
    for mi, mode in enumerate(modes):
        st_m, cells, cmasks, smasks = fit_grid_batched(
            jax.random.fold_in(key, mi) if len(modes) > 1 else key,
            base, ks, ss, config, hyps0, initmode=mode)
        per_mode.append(st_m)
    states = per_mode[0] if len(per_mode) == 1 else jax.tree.map(
        lambda *a: jnp.concatenate(a, axis=1), *per_mode)
    if config.learn_hyps:
        if config.verbose >= 2:
            print("  grid hyp optimization (vmapped L-BFGS over "
                  "cell x solution lanes)", flush=True)
        sts, lane_cell, hyps_lanes = optimize_hyps_grid_batched(
            base, states, cells, cmasks, smasks, config, hyps0)
        lane_ll = np.asarray(sts.ll)

        def cell_state(ci):
            lanes = np.where(lane_cell == ci)[0]
            best_lane = lanes[int(np.argmax(lane_ll[lanes]))]
            return (jax.tree.map(lambda a: a[best_lane], sts),
                    jax.tree.map(lambda a: a[best_lane], hyps_lanes))
    else:
        lls = np.asarray(states.ll)                   # [n_cells, trials]
        best_trial = lls.argmax(axis=1)

        def cell_state(ci):
            return (jax.tree.map(
                lambda a: a[ci, best_trial[ci]], states), hyps0)

    # Model selection compares cell ELBOs; on f32 backends the device
    # bound can carry precision/optimization artifacts large enough to
    # flip the (K,S) choice (a +21k-nat phantom was observed after hyp
    # optimization, RESULTS.md round-4), so every cell winner is
    # RE-EVALUATED in float64 on the host (NumPy oracle, exact same
    # bound) and selection uses the f64 values.
    rescore_f64 = base.hmm.mean.dtype == jnp.float32
    scores = np.full((len(ks), len(ss)), -np.inf)
    scores_device = np.full((len(ks), len(ss)), -np.inf)
    results = {}
    cell_hyps_all = {}
    for ci, (kk, sv) in enumerate(cells):
        st, cell_hyps = cell_state(ci)
        cell_hyps_all[(kk, sv)] = cell_hyps
        # slice the padded state down to the active (K, S) sub-grid
        ksl, ssl = jnp.arange(kk), jnp.arange(sv)
        post = H3MPosterior(
            alpha=st.post.alpha[ksl],
            eta=st.post.eta[ksl][:, ssl],
            epsilon=st.post.epsilon[ksl][:, ssl][:, :, ssl],
            niw=NIW(beta=st.post.niw.beta[ksl][:, ssl],
                    v=st.post.niw.v[ksl][:, ssl],
                    m=st.post.niw.m[ksl][:, ssl],
                    w=st.post.niw.w[ksl][:, ssl]))
        stats = st.stats
        res = VBHEMResult(
            post=post, h3m=post.to_h3m(), ll=st.ll,
            hat_z=st.hat_z[:, ksl], ll_elbo=st.ll_elbo[:, ksl],
            nj=stats.nj[ksl],
            label=jnp.argmax(st.hat_z[:, ksl], axis=-1),
            counts_n1=stats.nj_rho1[ksl][:, ssl],
            counts=stats.nj_rho[ksl][:, ssl],
            trans_counts=stats.nj_rho2rho[ksl][:, ssl][:, :, ssl])
        results[(kk, sv)] = res
        ki, si = ks.index(kk), ss.index(sv)
        corr = float(gammaln(kk + 1)) + float(gammaln(sv + 1))
        scores_device[ki, si] = float(st.ll) + corr
        if rescore_f64 and np.isfinite(float(st.ll)):
            from . import rescore as rescore_mod
            ll64 = rescore_mod.elbo_f64(base, post, cell_hyps,
                                        config.nv, config.tau)
            if (config.verbose >= 2
                    and abs(ll64 - float(st.ll)) > 0.01 * abs(ll64)):
                print(f"  [rescore] cell ({kk},{sv}): device f32 ll "
                      f"{float(st.ll):.1f} -> f64 {ll64:.1f}",
                      flush=True)
            scores[ki, si] = ll64 + corr
        else:
            scores[ki, si] = scores_device[ki, si]

    best_k, best_s, model_ll_k, s_star = _two_stage_select(scores, ks, ss)
    from .vbhmm import _version
    info = {"model_ll": scores, "model_ll_device": scores_device,
            "model_ll_k": model_ll_k, "model_best_s_per_k": s_star,
            "model_k": ks, "model_s": ss,
            "model_best_k": best_k, "model_best_s": best_s,
            "model_all": results, "model_hyps": cell_hyps_all,
            "vbhemopt": config, "version": _version()}
    return results[(best_k, best_s)], info
