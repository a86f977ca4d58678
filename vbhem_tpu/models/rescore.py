"""Float64 NumPy re-evaluation of the VBHEM lower bound.

Device compute runs in float32; model selection compares per-(K,S)-cell
ELBOs whose legitimate differences can be a few hundred nats out of
~1e6 — and an f32-evaluated bound after aggressive hyperparameter
optimization was observed to carry a +21k-nat phantom for specific
cells (RESULTS.md round-4), silently corrupting the (K,S) choice.
This module recomputes the EXACT 10-term bound (`vbhemh3m_lb.m:88-186`)
plus the hierarchical backward recursion for the data term
(`vbhem_hmm_bwd_fwd_fast.m:166-257`, LL only) in pure NumPy float64 —
independent of JAX's x64 flag, so it works on the host even in a
process that computes in float32 on the GPU.  It doubles as an independent oracle for the JAX
implementation (tests/test_rescore.py asserts 1e-9-level agreement
with `models.vbhem.elbo` in f64).
"""
from __future__ import annotations

import numpy as np
from scipy.special import digamma, gammaln

TINY = 1e-50  # the reference's +1e-50 mass floor


def _logsumexp(a: np.ndarray, axis: int = -1) -> np.ndarray:
    mx = np.max(a, axis=axis, keepdims=True)
    mx = np.where(np.isfinite(mx), mx, 0.0)
    return np.squeeze(mx, axis) + np.log(
        np.sum(np.exp(a - mx), axis=axis))


def _logdet_psd(a: np.ndarray) -> np.ndarray:
    sign, logdet = np.linalg.slogdet(a)
    return logdet


def _e_log_dirichlet(conc: np.ndarray, axis: int = -1) -> np.ndarray:
    return digamma(conc) - digamma(np.sum(conc, axis=axis, keepdims=True))


def _e_log_det_lambda(v: np.ndarray, w: np.ndarray) -> np.ndarray:
    d = w.shape[-1]
    i = np.arange(1, d + 1, dtype=np.float64)
    t = np.sum(digamma(0.5 * (v[..., None] + 1.0 - i)), axis=-1)
    return t + d * np.log(2.0) + _logdet_psd(w)


def _log_dirichlet_const(conc: np.ndarray, axis: int = -1) -> np.ndarray:
    return gammaln(np.sum(conc, axis=axis)) - np.sum(gammaln(conc),
                                                     axis=axis)


def _log_wishart_b(logdet_winv, v, d: int):
    v = np.asarray(v, np.float64)
    i = np.arange(1, d + 1, dtype=np.float64)
    return (0.5 * v * logdet_winv - 0.5 * v * d * np.log(2.0)
            - 0.25 * d * (d - 1) * np.log(np.pi)
            - np.sum(gammaln(0.5 * (v[..., None] + 1.0 - i)), axis=-1))


def pair_ll_elbo_f64(prior_b, trans_b, log_pi, log_a, ell,
                     tau: int) -> np.ndarray:
    """LL_elbo [Kb, Kr] of the hierarchical backward recursion
    (`vbhem_hmm_bwd_fwd_fast.m:166-257`), data term only."""
    ll_old = np.zeros_like(ell)                        # [i,j,b,r]
    for _ in range(tau - 1):
        logtheta = (log_a[None, :, :, None, :]
                    + (ell + ll_old)[:, :, None, :, :])
        lse = _logsumexp(logtheta, axis=-1)            # [i,j,rp,b]
        ll_old = np.einsum("ibc,ijrc->ijbr", trans_b, lse)
    logtheta1 = log_pi[None, :, None, :] + ell + ll_old
    lse1 = _logsumexp(logtheta1, axis=-1)              # [i,j,b]
    return np.einsum("ib,ijb->ij", prior_b, lse1)


def elbo_f64(base, post, hyps, nv: int, tau: int,
             return_terms: bool = False):
    """The full 10-term VBHEM bound in float64 for an UNPADDED
    (K, S) model.  ``base``/``post``/``hyps`` are the JAX pytrees
    (H3M / H3MPosterior / VBHEMHyps); everything is pulled to NumPy.

    ``return_terms=True`` additionally returns the dict of the ten
    terms (lt1..lt10, `vbhemh3m_lb.m:88-186` order, pre-sign) for
    per-term decomposition of cell-ELBO differences."""
    f = lambda a: np.asarray(a, np.float64)  # noqa: E731
    omega_b, prior_b, trans_b = f(base.omega), f(base.hmm.prior), \
        f(base.hmm.trans)
    mean_b, cov_b = f(base.hmm.mean), f(base.hmm.cov)
    alpha, eta, eps = f(post.alpha), f(post.eta), f(post.epsilon)
    lam, v, m, w = f(post.niw.beta), f(post.niw.v), f(post.niw.m), \
        f(post.niw.w)
    alpha0, eta0, eps0 = float(hyps.alpha0), float(hyps.eta0), \
        float(hyps.epsilon0)
    lam0, v0 = float(hyps.lambda0), float(hyps.v0)
    m0, w0 = f(hyps.m0), f(hyps.w0)

    kb = omega_b.shape[0]
    kr, sr = eta.shape
    d = m.shape[-1]

    # ---- digamma expectations ----
    log_omega = _e_log_dirichlet(alpha)
    log_pi = _e_log_dirichlet(eta)
    log_a = _e_log_dirichlet(eps)
    log_lam = _e_log_det_lambda(v, w)

    # ---- expected emission LL (E3logN, full covariance) ----
    tr = np.einsum("jrde,ibed->ijbr", w, cov_b)
    diff = mean_b[:, None, :, None, :] - m[None, :, None, :, :]
    quad = np.einsum("ijbrd,jrde,ijbre->ijbr", diff, w, diff)
    ell = -0.5 * (d * np.log(2 * np.pi) - log_lam[None, :, None, :]
                  + d / lam[None, :, None, :]
                  + v[None, :, None, :] * (tr + quad))

    ll_elbo = pair_ll_elbo_f64(prior_b, trans_b, log_pi, log_a, ell, tau)

    # ---- soft assignments (`vbhem_h3m_c_step_fc.m:275-283`) ----
    tilde_n = (nv * kb) * omega_b
    log_z = tilde_n[:, None] * (log_omega[None, :] + ll_elbo)
    hat_z = np.exp(log_z - _logsumexp(log_z, axis=-1)[:, None]) + TINY
    z_ni = hat_z * tilde_n[:, None]
    nj = np.sum(z_ni, axis=0) + TINY

    # ---- the 10 terms (`vbhemh3m_lb.m:88-186`) ----
    logdet_w0inv = float(np.sum(np.log(1.0 / w0)))
    w0inv_diag = 1.0 / w0
    log_c_alpha0 = gammaln(kr * alpha0) - kr * gammaln(alpha0)
    log_c_eta0 = gammaln(sr * eta0) - sr * gammaln(eta0)
    log_c_eps0 = gammaln(sr * eps0) - sr * gammaln(eps0)
    log_b0 = _log_wishart_b(logdet_w0inv, v0, d)

    lt1 = np.sum(z_ni * ll_elbo)
    lt2 = np.sum(nj * log_omega)
    lt3 = kr * log_c_eta0 + (eta0 - 1.0) * np.sum(log_pi)
    lt4 = kr * sr * log_c_eps0 + (eps0 - 1.0) * np.sum(log_a)

    dm = m - m0
    m_w_m = np.einsum("jrd,jrde,jre->jr", dm, w, dm)
    tr_w0inv_w = np.einsum("d,jrdd->jr", w0inv_diag, w)
    const2 = d * np.log(lam0 / (2 * np.pi))
    lt51 = 0.5 * np.sum(const2 + log_lam - d * lam0 / lam
                        - lam0 * v * m_w_m)
    lt52 = (kr * sr * log_b0 + 0.5 * (v0 - d - 1.0) * np.sum(log_lam)
            - 0.5 * np.sum(v * tr_w0inv_w))
    lt5 = lt51 + lt52

    lt6 = log_c_alpha0 + (alpha0 - 1.0) * np.sum(log_omega)
    lt7 = np.sum(hat_z * np.log(hat_z))
    lt8 = _log_dirichlet_const(alpha) + np.sum((alpha - 1.0) * log_omega)
    lt9 = (np.sum(_log_dirichlet_const(eta))
           + np.sum((eta - 1.0) * log_pi)
           + np.sum(_log_dirichlet_const(eps))
           + np.sum((eps - 1.0) * log_a))

    log_bk = _log_wishart_b(-_logdet_psd(w), v, d)
    h_ent = np.sum(-log_bk - 0.5 * (v - d - 1.0) * log_lam + 0.5 * v * d)
    lt10 = 0.5 * np.sum(log_lam + d * np.log(lam / (2 * np.pi))) \
        - 0.5 * d * kr * sr - h_ent

    total = float(lt1 + lt2 + lt3 + lt4 + lt5 + lt6 - lt7 - lt8 - lt9
                  - lt10)
    if return_terms:
        terms = {f"lt{i}": float(v) for i, v in enumerate(
            [lt1, lt2, lt3, lt4, lt5, lt6, lt7, lt8, lt9, lt10], 1)}
        return total, terms
    return total


# ---------------------------------------------------------------------------
# VBEM (subject-level) 8-term bound in float64 (`vbhmm_em_lb.m:120-257`)
# ---------------------------------------------------------------------------

def _fb_f64(log_pz1, log_trans, log_rho, mask):
    """Scaled forward-backward in NumPy f64, mirroring
    `ops/fb.py:forward_backward` exactly (same per-step max-rescale and
    normalizer conventions, `vbhmm_fb.m:289-377`).
    Returns (gamma [N,T,K], xi_sum [N,K,K], phi_norm [N])."""
    n, t_max, k = log_rho.shape
    pz1 = np.exp(log_pz1)
    trans = np.exp(log_trans)
    if pz1.ndim == 1:
        pz1 = np.broadcast_to(pz1[None, :], (n, k))
    maskf = mask.astype(np.float64)

    max_rho = np.max(log_rho, axis=-1)                       # [N, T]
    px = np.exp(log_rho - max_rho[..., None])                # [N, T, K]

    alpha = np.zeros((t_max, n, k))
    c = np.ones((t_max, n))
    delta0 = pz1 * px[:, 0, :]
    c[0] = np.sum(delta0, axis=-1)
    alpha[0] = delta0 / c[0][:, None]
    for t in range(1, t_max):
        delta = (alpha[t - 1] @ trans) * px[:, t, :]
        ct = np.sum(delta, axis=-1)
        ct = np.where(ct > 0, ct, 1.0)
        a_new = delta / ct[:, None]
        valid = mask[:, t]
        alpha[t] = np.where(valid[:, None], a_new, alpha[t - 1])
        c[t] = np.where(valid, ct, 1.0)

    beta = np.ones((t_max, n, k))
    xi_sum = np.zeros((n, k, k))
    for t in range(t_max - 2, -1, -1):
        bp = beta[t + 1] * px[:, t + 1, :]
        beta_t = (bp @ trans.T) / c[t + 1][:, None]
        valid = mask[:, t + 1]
        beta[t] = np.where(valid[:, None], beta_t, 1.0)
        xi_t = (trans[None] * (alpha[t][:, :, None] * bp[:, None, :])
                / c[t + 1][:, None, None])
        xi_sum += np.where(valid[:, None, None], xi_t, 0.0)

    gamma = np.moveaxis(alpha * beta, 0, 1) * maskf[..., None]
    log_c = np.where(mask, np.log(np.moveaxis(c, 0, 1)), 0.0)
    phi_norm = np.sum(log_c, axis=-1) + np.sum(max_rho * maskf, axis=-1)
    return gamma, xi_sum, phi_norm


def vbem_elbo_f64(x, lengths, post, hyps) -> float:
    """The full 8-term VBEM bound (`vbhmm_em_lb.m:120-257`) in NumPy
    float64 for one subject solution: E-step (expected-log-Gaussian +
    scaled FB) -> masked sufficient statistics -> bound.  ``post`` is an
    HMMPosterior, ``hyps`` a VBHyps; mirrors `models/vbhmm.py:elbo` so
    it doubles as an independent oracle (tests/test_rescore.py).

    Used to make restart / multi-K / bank-lane selection f64-grade when
    device compute is float32 (the VBEM analogue of the grid-cell
    rescoring above)."""
    f = lambda a: np.asarray(a, np.float64)  # noqa: E731
    x = f(x)
    lengths = np.asarray(lengths)
    n, t_max, d = x.shape
    mask = np.arange(t_max)[None, :] < lengths[:, None]
    maskf = mask.astype(np.float64)

    alpha_p, eps_p = f(post.alpha), f(post.epsilon)
    lam, v, m, w = f(post.niw.beta), f(post.niw.v), f(post.niw.m), \
        f(post.niw.w)
    alpha0, eps0 = float(hyps.alpha0), float(hyps.epsilon0)
    beta0, v0 = float(hyps.beta0), float(hyps.v0)
    m0, w0 = f(hyps.m0), f(hyps.w0)
    k = alpha_p.shape[-1]

    # ---- E-step in f64 ----
    log_pi = _e_log_dirichlet(alpha_p)
    log_a = _e_log_dirichlet(eps_p)
    log_lam = _e_log_det_lambda(v, w)
    diff = x[:, :, None, :] - m[None, None, :, :]            # [N,T,K,D]
    quad = np.einsum("ntkd,kde,ntke->ntk", diff, w, diff)
    delta = d / lam[None, None, :] + v[None, None, :] * quad
    log_rho = (0.5 * log_lam[None, None, :] - 0.5 * delta
               - 0.5 * d * np.log(2 * np.pi))
    gamma, xi_sum_n, phi_norm = _fb_f64(log_pi, log_a, log_rho, mask)
    log_rho = log_rho * maskf[..., None]

    # ---- sufficient statistics (`vbhmm_em.m:158-246`) ----
    nk1 = np.sum(gamma[:, 0, :], axis=0)
    nk = np.sum(gamma, axis=(0, 1)) + TINY
    m_trans = np.sum(xi_sum_n, axis=0)
    xbar = np.einsum("ntk,ntd->kd", gamma, x) / nk[:, None]
    m2 = np.einsum("ntk,ntd,nte->kde", gamma, x, x) / nk[:, None, None]
    s = m2 - xbar[:, :, None] * xbar[:, None, :]
    s = 0.5 * (s + np.swapaxes(s, -1, -2))

    # ---- the 8 terms ----
    logdet_w0inv = float(np.sum(np.log(1.0 / w0)))
    w0inv_diag = 1.0 / w0
    log_c_alpha0 = gammaln(k * alpha0) - k * gammaln(alpha0)
    log_c_eps0 = gammaln(k * eps0) - k * gammaln(eps0)
    log_b0 = _log_wishart_b(logdet_w0inv, np.asarray(v0), d)

    tr_sw = np.einsum("kde,ked->k", s, w)
    dxb = xbar - m
    xbar_w_xbar = np.einsum("kd,kde,ke->k", dxb, w, dxb)
    dm = m - m0[None, :]
    m_w_m = np.einsum("kd,kde,ke->k", dm, w, dm)
    tr_w0inv_w = np.einsum("d,kdd->k", w0inv_diag, w)

    lt1 = 0.5 * np.sum(nk * (log_lam - d / lam - v * tr_sw
                             - v * xbar_w_xbar - d * np.log(2 * np.pi)))
    lt2a = np.sum(nk1 * log_pi)
    lt2b = np.sum(m_trans * log_a)
    lt2 = lt2a + lt2b
    lt3 = log_c_alpha0 + (alpha0 - 1.0) * np.sum(log_pi)
    lt4 = k * log_c_eps0 + (eps0 - 1.0) * np.sum(log_a)
    lt51 = 0.5 * np.sum(d * np.log(beta0 / (2 * np.pi)) + log_lam
                        - d * beta0 / lam - beta0 * v * m_w_m)
    lt52 = (k * log_b0 + 0.5 * (v0 - d - 1.0) * np.sum(log_lam)
            - 0.5 * np.sum(v * tr_w0inv_w))
    lt5 = lt51 + lt52
    lt63 = np.sum(gamma * log_rho)
    lt64 = np.sum(phi_norm)
    lt6 = lt2a + lt2b + lt63 - lt64
    lt71 = np.sum((alpha_p - 1.0) * log_pi) + _log_dirichlet_const(alpha_p)
    lt72 = np.sum(np.sum((eps_p - 1.0) * log_a, -1)
                  + _log_dirichlet_const(eps_p))
    lt7 = lt71 + lt72
    log_bk = _log_wishart_b(-_logdet_psd(w), v, d)
    h_ent = np.sum(-log_bk - 0.5 * (v - d - 1.0) * log_lam + 0.5 * v * d)
    lt8 = 0.5 * np.sum(log_lam + d * np.log(lam / (2 * np.pi))) \
        - 0.5 * d * k - h_ent

    return float(lt1 + lt2 + lt3 + lt4 + lt5 - lt6 - lt7 - lt8)


def vbem_rescore_lanes(x, lengths, posts, hyps_lanes) -> np.ndarray:
    """f64-rescore a batch of lane solutions.  ``posts`` has a leading
    lane axis; ``hyps_lanes`` either shares that leading axis or is a
    single unbatched VBHyps applied to every lane.  ``x`` may be
    [N,T,D] (shared data) or [L,N,T,D] (per-lane data, e.g. bank lanes
    over subjects; ``lengths`` then [L,N]).  Returns [L] float64."""
    import jax
    n_lanes = int(np.asarray(posts.alpha).shape[0])
    per_lane_hyps = np.asarray(hyps_lanes.alpha0).ndim >= 1
    per_lane_x = np.asarray(x).ndim == 4
    out = np.empty((n_lanes,), np.float64)
    for li in range(n_lanes):
        p = jax.tree.map(lambda a: a[li], posts)
        h = jax.tree.map(lambda a: a[li], hyps_lanes) if per_lane_hyps \
            else hyps_lanes
        xi = x[li] if per_lane_x else x
        ln = lengths[li] if per_lane_x else lengths
        try:
            out[li] = vbem_elbo_f64(xi, ln, p, h)
        except (np.linalg.LinAlgError, FloatingPointError, ValueError):
            out[li] = -np.inf
    return out
