"""Key-driven GMM fitting, used to initialize VBEM (and by the VHEM /
VBHEM `gmmNew` initializers).

Replaces MATLAB's `gmdistribution.fit(..., 'Start', 'randSample')` used
by `src/hmm/vbhmm_init.m:59-60` and the Netlab-style fallback
`src/compare_mtds/hem/gmm/gmm.m`.  Same initialization convention:
means are K distinct random data points, all components start from the
pooled data covariance with uniform weights, then EM runs to a relative
log-likelihood tolerance of 1e-5.

Fully jittable: fixed-shape EM with a `lax.while_loop`, deterministic
under a PRNG key (the reference makes seeds mandatory for exactly this
reproducibility, `vbhmm_learn.m:343-345`).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.numeric import logsumexp, sym


class GMM(NamedTuple):
    weight: jnp.ndarray  # [K]
    mean: jnp.ndarray    # [K, D]
    cov: jnp.ndarray     # [K, D, D]


def _log_gauss(x: jnp.ndarray, mean: jnp.ndarray, cov: jnp.ndarray) -> jnp.ndarray:
    """log N(x | mean, cov): x [M, D], mean [K, D], cov [K, D, D] -> [M, K]."""
    from ..utils.numeric import inv_psd, logdet_psd
    d = x.shape[-1]
    prec = inv_psd(cov)                                             # [K, D, D]
    diff = x[:, None, :] - mean[None, :, :]                         # [M, K, D]
    quad = jnp.einsum("mkd,kde,mke->mk", diff, prec, diff)
    logdet = logdet_psd(cov)
    return -0.5 * (quad + logdet + d * jnp.log(jnp.asarray(2 * jnp.pi, x.dtype)))


def fit_gmm(key: jax.Array, x: jnp.ndarray, k: int,
            weights: jnp.ndarray | None = None,
            max_iter: int = 100, tol: float = 1e-5,
            reg: float = 1e-6, start_weighted: bool = False) -> GMM:
    """EM fit of a K-component full-covariance GMM on x [M, D].

    ``weights`` optionally weights each point (used by the weighted
    initializers); defaults to 1.  ``reg`` is a relative ridge added to
    covariances (the reference regularizes with 1e-10 on its fallback
    path, `vbhmm_init.m:68`; we always regularize slightly since there
    is no try/catch under jit).  ``start_weighted`` draws the randSample
    start means proportionally to ``weights`` (without replacement) —
    used when x carries masked-out points that must not seed a
    component (e.g. the per-cluster pools of `vbhemhmm_init.m:874-1038`).
    """
    m, d = x.shape
    dtype = x.dtype
    w_pt = jnp.ones((m,), dtype) if weights is None else weights.astype(dtype)
    w_sum = jnp.sum(w_pt)

    # randSample start: K distinct random points as means.
    if start_weighted:
        idx = jax.random.choice(key, m, (k,), replace=False,
                                p=w_pt / w_sum)
        mean0 = x[idx]
    else:
        perm = jax.random.permutation(key, m)
        mean0 = x[perm[:k]]
    xm = jnp.sum(w_pt[:, None] * x, 0) / w_sum
    xc = x - xm
    data_cov = (xc.T * w_pt) @ xc / w_sum
    scale = jnp.trace(data_cov) / d
    ridge = (reg * scale + 1e-30) * jnp.eye(d, dtype=dtype)
    cov0 = jnp.broadcast_to(data_cov + ridge, (k, d, d))
    weight0 = jnp.full((k,), 1.0 / k, dtype)

    def e_step(g: GMM):
        lp = _log_gauss(x, g.mean, g.cov) + jnp.log(g.weight)[None]  # [M, K]
        norm = logsumexp(lp, axis=-1)
        resp = jnp.exp(lp - norm[:, None]) * w_pt[:, None]
        ll = jnp.sum(norm * w_pt)
        return resp, ll

    def m_step(resp) -> GMM:
        nk = jnp.sum(resp, 0) + 1e-30
        mean = (resp.T @ x) / nk[:, None]
        m2 = jnp.einsum("mk,md,me->kde", resp, x, x) / nk[:, None, None]
        cov = sym(m2 - mean[:, :, None] * mean[:, None, :]) + ridge
        return GMM(weight=nk / jnp.sum(nk), mean=mean, cov=cov)

    def cond(carry):
        g, ll, last_ll, it = carry
        not_conv = jnp.abs((ll - last_ll) / jnp.where(last_ll == 0, 1.0, last_ll)) > tol
        return jnp.logical_and(it < max_iter,
                               jnp.logical_or(it < 2, not_conv))

    def body(carry):
        g, ll, last_ll, it = carry
        resp, new_ll = e_step(g)
        return m_step(resp), new_ll, ll, it + 1

    big = jnp.asarray(-jnp.finfo(dtype).max, dtype)
    init = (GMM(weight0, mean0, cov0), big, big, jnp.asarray(0))
    g, ll, _, _ = jax.lax.while_loop(cond, body, init)
    return g


def fit_gmm_split(x: jnp.ndarray, k: int,
                  weights: jnp.ndarray | None = None,
                  max_iter: int = 100, tol: float = 1e-5,
                  reg: float = 1e-6, em_iters_per_split: int = 15) -> GMM:
    """GMM fit by LBG-style component splitting — the 'split' initmode of
    `vbhmm_init.m:104-111` (the reference delegates to the emhmm
    `gmm_learn(..., initmode='split')`, an external dependency; this is
    the standard algorithm it names).

    Start from the single weighted-ML Gaussian; repeat K-1 times:
    split the component with the largest mass x spread
    (weight * trace(cov)) along its principal eigenvector by
    +-0.5*sqrt(lambda_max), halve its weight, run a few masked EM
    iterations; finish with EM to tolerance.  Deterministic (no PRNG),
    which is the point of 'split' vs 'random' initialization.
    """
    m, d = x.shape
    dtype = x.dtype
    w_pt = jnp.ones((m,), dtype) if weights is None else weights.astype(dtype)
    w_sum = jnp.sum(w_pt)

    xm = jnp.sum(w_pt[:, None] * x, 0) / w_sum
    xc = x - xm
    data_cov = (xc.T * w_pt) @ xc / w_sum
    scale = jnp.trace(data_cov) / d
    ridge = (reg * scale + 1e-30) * jnp.eye(d, dtype=dtype)

    # padded-to-K component bank; ``active`` masks live components
    mean_b = jnp.zeros((k, d), dtype).at[0].set(xm)
    cov_b = jnp.broadcast_to(data_cov + ridge, (k, d, d))
    weight_b = jnp.zeros((k,), dtype).at[0].set(1.0)

    def masked_em(g: GMM, active, n_iters):
        def one(_, g):
            lw = jnp.where(active, jnp.log(g.weight + 1e-300), -jnp.inf)
            lp = _log_gauss(x, g.mean, g.cov) + lw[None]
            norm = logsumexp(lp, axis=-1)
            resp = jnp.where(active[None],
                             jnp.exp(lp - norm[:, None]), 0.0) \
                * w_pt[:, None]
            nk = jnp.sum(resp, 0) + 1e-30
            mean = (resp.T @ x) / nk[:, None]
            m2 = jnp.einsum("mk,md,me->kde", resp, x, x) / nk[:, None, None]
            cov = sym(m2 - mean[:, :, None] * mean[:, None, :]) + ridge
            weight = jnp.where(active, nk / jnp.sum(nk), 0.0)
            # keep inactive slots inert (identity-scale cov, zero weight)
            mean = jnp.where(active[:, None], mean, g.mean)
            cov = jnp.where(active[:, None, None], cov, g.cov)
            return GMM(weight=weight, mean=mean, cov=cov)

        return jax.lax.fori_loop(0, n_iters, one, g)

    def em_to_tol(g: GMM):
        # plain EM from the split init, run to the relative-LL tolerance
        def e_step(g: GMM):
            lp = _log_gauss(x, g.mean, g.cov) + jnp.log(g.weight + 1e-300)[None]
            norm = logsumexp(lp, axis=-1)
            resp = jnp.exp(lp - norm[:, None]) * w_pt[:, None]
            return resp, jnp.sum(norm * w_pt)

        def m_step(resp) -> GMM:
            nk = jnp.sum(resp, 0) + 1e-30
            mean = (resp.T @ x) / nk[:, None]
            m2 = jnp.einsum("mk,md,me->kde", resp, x, x) / nk[:, None, None]
            cov = sym(m2 - mean[:, :, None] * mean[:, None, :]) + ridge
            return GMM(weight=nk / jnp.sum(nk), mean=mean, cov=cov)

        def cond(carry):
            _, ll, last_ll, it = carry
            not_conv = jnp.abs((ll - last_ll) / jnp.where(
                last_ll == 0, 1.0, last_ll)) > tol
            return jnp.logical_and(it < max_iter,
                                   jnp.logical_or(it < 2, not_conv))

        def body(carry):
            g, ll, _, it = carry
            resp, new_ll = e_step(g)
            return m_step(resp), new_ll, ll, it + 1

        big = jnp.asarray(-jnp.finfo(dtype).max, dtype)
        out, _, _, _ = jax.lax.while_loop(cond, body,
                                          (g, big, big, jnp.asarray(0)))
        return out

    g = GMM(weight=weight_b, mean=mean_b, cov=cov_b)
    for n_active in range(1, k):
        active = jnp.arange(k) < n_active
        # split the live component with the largest weight * trace(cov)
        spread = jnp.where(active,
                           g.weight * jnp.trace(g.cov, axis1=-2, axis2=-1),
                           -jnp.inf)
        j = jnp.argmax(spread)
        evals, evecs = jnp.linalg.eigh(g.cov[j])
        delta = 0.5 * jnp.sqrt(jnp.maximum(evals[-1], 1e-30)) * evecs[:, -1]
        g = GMM(
            weight=g.weight.at[j].set(g.weight[j] / 2)
                           .at[n_active].set(g.weight[j] / 2),
            mean=g.mean.at[j].set(g.mean[j] - delta)
                       .at[n_active].set(g.mean[j] + delta),
            cov=g.cov.at[n_active].set(g.cov[j]))
        g = masked_em(g, jnp.arange(k) < (n_active + 1),
                      em_iters_per_split)
    return em_to_tol(g)


def mix_hier_em(key: jax.Array, mean: jnp.ndarray, cov: jnp.ndarray,
                prior: jnp.ndarray, t: int, nv: float = 100.0,
                max_iter: int = 30, tol: float = 1e-6):
    """Vasconcelos mixture-hierarchies EM: reduce a pooled bank of P
    Gaussians to a T-component GMM using virtual samples.

    Vectorised JAX replacement for
    `src/compare_mtds/hem/gmm/GMM_MixHierEM.m` (E-step log-posterior
    `:113-165`, M-step `:179-199`), used by the 'gmmNew' initializers of
    both VHEM (`initialize_hem_h3m_c.m:276-494`) and VBHEM
    (`vbhemhmm_init.m:103-291`).

    mean [P, D], cov [P, D, D], prior [P] (masked-out components carry
    prior 0 and are inert).  Returns (GMM over T components,
    log-posterior lp [T, P]) — lp is the reference's `lp_out`.
    """
    from ..utils.numeric import inv_psd, logdet_psd
    p, d = mean.shape
    dtype = mean.dtype
    prior = prior / jnp.sum(prior)
    coef = -0.5 * d * jnp.log(jnp.asarray(2.0 * jnp.pi, dtype))
    dpp = nv * prior                                        # [P]

    # init: weighted kmeans++ centers on base means, covariance = mean
    # base covariance, uniform weights (GMM_MixHierEM.m:92-100)
    from .kmeans import kmeans
    _, cent0 = kmeans(key, mean, t, weights=prior, max_iter=10)
    vrnc0 = jnp.broadcast_to(
        jnp.einsum("p,pde->de", prior, cov)[None], (t, d, d))
    mxwt0 = jnp.full((t,), 1.0 / t, dtype)

    def e_step(mxwt, cent, vrnc):
        ivr = inv_psd(vrnc)                                 # [T, D, D]
        ld = logdet_psd(vrnc)                               # [T]
        tr = jnp.einsum("tde,ped->tp", ivr, cov)            # [T, P]
        diff = mean[None] - cent[:, None]                   # [T, P, D]
        quad = jnp.einsum("tpd,tde,tpe->tp", diff, ivr, diff)
        xpt = (jnp.log(mxwt)[:, None]
               + dpp[None, :] * (coef - 0.5 * (tr + quad + ld[:, None])))
        lse = logsumexp(xpt, axis=0)                        # [P]
        logpost = xpt - lse[None]
        return logpost, jnp.mean(lse)

    def m_step(logpost):
        post = jnp.exp(logpost)                             # [T, P]
        mxwt = jnp.mean(post, axis=1) + 1e-30
        wts = post * prior[None]
        wts = wts / (jnp.sum(wts, axis=1, keepdims=True) + 1e-30)
        cent = wts @ mean                                   # [T, D]
        diff = mean[None] - cent[:, None]                   # [T, P, D]
        vrnc = (jnp.einsum("tp,tpd,tpe->tde", wts, diff, diff)
                + jnp.einsum("tp,pde->tde", wts, cov))
        return mxwt / jnp.sum(mxwt), cent, sym(vrnc)

    big = jnp.asarray(-jnp.finfo(dtype).max, dtype)

    def cond(carry):
        _, _, _, ll, last, it = carry
        return jnp.logical_and(it < max_iter,
                               jnp.logical_or(it < 2, ll - last > tol))

    def body(carry):
        mxwt, cent, vrnc, ll, _, it = carry
        logpost, new_ll = e_step(mxwt, cent, vrnc)
        mxwt, cent, vrnc = m_step(logpost)
        return mxwt, cent, vrnc, new_ll, ll, it + 1

    mxwt, cent, vrnc, _, _, _ = jax.lax.while_loop(
        cond, body, (mxwt0, cent0, vrnc0, big, big, jnp.asarray(0)))
    logpost, _ = e_step(mxwt, cent, vrnc)
    return GMM(weight=mxwt, mean=cent, cov=vrnc), logpost
