"""Deviance Information Criterion for a learned VBH3M.

Parity map: `src/compare_mtds/dic/myDIC.m` — effective parameter count
P_d from the gap between plug-in estimates and posterior expectations
of omega/pi/A/mu/Sigma (`:36-96`), plus a deviance term from the
expected log-likelihood of the base bank under the point-estimate
reduced model via the VHEM pair kernel (`:160-177`).  Models with
minimum DIC are selected in the evaluation harness.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax.scipy.special import digamma

from ..containers import H3M
from ..ops.pair_estep import expected_pair_ll_point, pair_bwd_fwd
from ..utils.numeric import e_log_det_lambda, e_log_dirichlet, logsumexp
from .vbhem import VBHEMResult


def dic(base: H3M, res: VBHEMResult, tau: int, lambda0: float = 1.0,
        per_time: bool = False, synthetic: bool = False) -> tuple:
    """Returns (P_d, DIC).  ``lambda0`` is the NIW mean-precision prior
    used during learning (`myDIC.m:25`).

    ``synthetic`` selects the reference's `issyn=1` variant
    (`myDIC.m:98-154`): the Sigma plug-in precision is the inverse of
    the converted point-estimate covariance, i.e. (v-D-1)W (with the
    small-v fallback of `convert_h3mrtoh3mb.m:44-70`), instead of the vb
    path's vW (`myDIC.m:86-90`).  The count weights (N_Eta, N_Eps,
    Nl_j) are the aggregated E-step statistics in both variants here —
    the reference stores the same numbers on different structs."""
    post = res.post
    reduced = res.h3m
    kb = base.num_hmms
    nj = np.asarray(res.nj)
    ni = nj.sum() / kb                                       # myDIC.m:21
    d = base.hmm.mean.shape[-1]

    # omega term (myDIC.m:29-40)
    log_omega_tilde = np.asarray(e_log_dirichlet(post.alpha))
    log_omega_hat = np.log(np.asarray(reduced.omega))
    term_omega = float(nj @ (log_omega_hat - log_omega_tilde))

    # pi term (myDIC.m:44-54): counts N1 = posterior initial-state counts
    log_pi_tilde = np.asarray(e_log_dirichlet(post.eta))     # [Kr,Sr]
    log_pi_hat = np.log(np.asarray(reduced.hmm.prior))
    n1 = np.asarray(res.counts_n1)
    term_pi = float(np.sum(n1 * (log_pi_hat - log_pi_tilde)))

    # A term (myDIC.m:58-70)
    log_a_tilde = np.asarray(e_log_dirichlet(post.epsilon))  # [Kr,Sr,Sr]
    log_a_hat = np.log(np.maximum(np.asarray(reduced.hmm.trans), 1e-300))
    m = np.asarray(res.trans_counts)
    term_eps = float(np.sum(m * (log_a_hat - log_a_tilde)))

    # mu term (myDIC.m:73-78)
    lam = np.asarray(post.niw.beta)
    term_mu = float(-0.5 * np.sum(lambda0 / lam))

    # Sigma term: plug-in precision = v*W (vb path, myDIC.m:82-96) or
    # inv(expected covariance) (synthetic path, myDIC.m:139-147)
    log_lam_tilde = np.asarray(e_log_det_lambda(post.niw.v, post.niw.w))
    v = np.asarray(post.niw.v)
    w = np.asarray(post.niw.w)
    if synthetic:
        _, logdet_cov = np.linalg.slogdet(np.asarray(reduced.hmm.cov))
        logdet_plug = -logdet_cov
    else:
        _, logdet_plug = np.linalg.slogdet(v[..., None, None] * w)
    n_rho = np.asarray(res.counts)
    term_w = float(0.5 * np.sum(n_rho * (logdet_plug - log_lam_tilde)))

    p_d = 2.0 * (term_omega + term_pi + term_eps + term_mu + term_w)

    # deviance (myDIC.m:160-177): base vs point-estimate reduced
    ell = expected_pair_ll_point(base.hmm.mean, base.hmm.cov,
                                 reduced.hmm.mean, reduced.hmm.cov)
    log_pi_r = jnp.log(jnp.maximum(reduced.hmm.prior, 1e-300))
    log_a_r = jnp.log(jnp.maximum(reduced.hmm.trans, 1e-300))
    pair = pair_bwd_fwd(base.hmm.prior, base.hmm.trans, log_pi_r, log_a_r,
                        ell, tau)
    log_z = jnp.log(jnp.maximum(reduced.omega, 1e-300))[None, :] \
        + ni * pair.ll_elbo
    ll = float(jnp.sum(logsumexp(log_z, axis=-1)))
    if per_time:
        ll = ll / tau
    return p_d, 2.0 * p_d - 2.0 * ll


def aic_bic_vhem(ll: float, k: int, s: int, d: int, n_obs: int) -> tuple:
    """AIC/BIC for a VHEM solution with the reference's explicit
    parameter count (K-1) + K((S-1) + S(S-1) + 2SD)
    (`evaluate_vbhem_jounarl.m:160-239`)."""
    n_params = (k - 1) + k * ((s - 1) + s * (s - 1) + 2 * s * d)
    aic = -2.0 * ll + 2.0 * n_params
    bic = -2.0 * ll + n_params * np.log(max(n_obs, 1))
    return aic, bic
