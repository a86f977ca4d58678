"""Hierarchical backward/forward recursions over virtual samples — the
VBHEM/VHEM E-step over all (base i, reduced j) pairs.

XLA replacement for the reference C kernels
`src/vbhem/vbhem_hmm_bwd_fwd_mex.c` (variational flavor; MATLAB mirror
`vbhem_hmm_bwd_fwd_fast.m`) and
`src/compare_mtds/hem/vhem_h3m/hem_hmm_bwd_fwd_mex.c` (point-estimate
flavor).  Both flavors share the recursion; they differ only in the
expected Gaussian log-likelihood matrix, so there is ONE kernel here
taking a precomputed ``ell`` matrix (cf. SURVEY.md section 7.1).

Layout: instead of a C double loop over (i, j) pairs, the whole
[Kb, Kr] pair grid advances together through one `lax.scan` over the
virtual length T; per step the work is batched einsums over
[Kb, Kr, S...] tensors that XLA fuses and tiles.  Ragged base state
counts are handled by zero-padding prior/A rows (padded states carry
exactly zero probability mass through every recursion).

Returned statistics per pair (i, j):
  * ``ll_elbo``  [Kb, Kr]            lower bound E_i[log p(virtual | j)]
  * ``nu_1``     [Kb, Kr, Sr]        expected initial-state counts
  * ``sum_xi``   [Kb, Kr, Sr, Sr]    expected transition counts
  * ``sum_t_nu`` [Kb, Kr, Sr, Sb]    time-summed state pair counts

The reference's emission statistics (`update_emit_pr/mu/Mu`,
`vbhem_hmm_bwd_fwd_fast.m:350-384`) are all linear images of
``sum_t_nu`` against cached base moments, so they are formed by the
caller with three einsums rather than inside the kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.numeric import logsumexp


class PairStats(NamedTuple):
    ll_elbo: jnp.ndarray    # [Kb, Kr]
    nu_1: jnp.ndarray       # [Kb, Kr, Sr]
    sum_xi: jnp.ndarray     # [Kb, Kr, Sr, Sr]
    sum_t_nu: jnp.ndarray   # [Kb, Kr, Sr, Sb]


def expected_pair_ll_variational(mean_b: jnp.ndarray, cov_b: jnp.ndarray,
                                 m_r: jnp.ndarray, w_r: jnp.ndarray,
                                 v_r: jnp.ndarray, lam_r: jnp.ndarray,
                                 log_lam_tilde: jnp.ndarray) -> jnp.ndarray:
    """E3logN of the VBHEM E-step (`vbhem_hmm_bwd_fwd_fast.m:102-135`,
    full-covariance case; MEX `vbhem_hmm_bwd_fwd_mex.c:601-626`):

      -0.5 [ D log 2pi - E[log|Lambda|] + D/lambda
             + v (tr(W Sigma_b) + (mu_b - m)^T W (mu_b - m)) ]

    mean_b [Kb,Sb,D], cov_b [Kb,Sb,D,D]; m_r [Kr,Sr,D], w_r [Kr,Sr,D,D],
    v_r/lam_r/log_lam_tilde [Kr,Sr]  ->  [Kb, Kr, Sb, Sr].
    """
    d = mean_b.shape[-1]
    tr = jnp.einsum("jrde,ibed->ijbr", w_r, cov_b)
    diff = mean_b[:, None, :, None, :] - m_r[None, :, None, :, :]  # [i,j,b,r,D]
    quad = jnp.einsum("ijbrd,jrde,ijbre->ijbr", diff, w_r, diff)
    two_pi = jnp.asarray(2.0 * jnp.pi, mean_b.dtype)
    return -0.5 * (d * jnp.log(two_pi)
                   - log_lam_tilde[None, :, None, :]
                   + d / lam_r[None, :, None, :]
                   + v_r[None, :, None, :] * (tr + quad))


def expected_pair_ll_point(mean_b: jnp.ndarray, cov_b: jnp.ndarray,
                           mean_r: jnp.ndarray, cov_r: jnp.ndarray) -> jnp.ndarray:
    """Expected log Gaussian between point-estimate banks — the VHEM
    flavor (`g3m_stats.m`; `hem_hmm_bwd_fwd_mex.c` ELL blocks):

      E_{N(mu_b, S_b)}[log N(y | mu_r, S_r)]
        = -0.5 [ D log 2pi + log|S_r| + tr(S_r^-1 S_b)
                 + (mu_b - mu_r)^T S_r^-1 (mu_b - mu_r) ]
    """
    from ..utils.numeric import inv_psd, logdet_psd
    d = mean_b.shape[-1]
    prec_r = inv_psd(cov_r)                          # [Kr,Sr,D,D]
    logdet = logdet_psd(cov_r)                       # [Kr,Sr]
    tr = jnp.einsum("jrde,ibed->ijbr", prec_r, cov_b)
    diff = mean_b[:, None, :, None, :] - mean_r[None, :, None, :, :]
    quad = jnp.einsum("ijbrd,jrde,ijbre->ijbr", diff, prec_r, diff)
    two_pi = jnp.asarray(2.0 * jnp.pi, mean_b.dtype)
    return -0.5 * (d * jnp.log(two_pi) + logdet[None, :, None, :] + tr + quad)


def pair_bwd_fwd(prior_b: jnp.ndarray, trans_b: jnp.ndarray,
                 log_pi_r: jnp.ndarray, log_a_r: jnp.ndarray,
                 ell: jnp.ndarray, tau: int) -> PairStats:
    """Backward + forward recursions over T=tau virtual steps for ALL
    (i, j) pairs at once.

    prior_b [Kb,Sb], trans_b [Kb,Sb,Sb]  (zero-padded rows for ragged Sb)
    log_pi_r [Kr,Sr], log_a_r [Kr,Sr,Sr] (digamma expectations, or plain
        logs for the VHEM flavor)
    ell [Kb,Kr,Sb,Sr]  expected emission log-likelihood matrix.

    Backward mirror: `vbhem_hmm_bwd_fwd_fast.m:166-257`;
    forward mirror: `:266-341`.
    """
    kb, kr, sb, sr = ell.shape
    dtype = ell.dtype

    # ---- backward: Theta[t], LL ----
    # ll carries [Kb,Kr,Sb,Sr] = LL_old (reference LL_old', transposed).
    # zeros_like(ell) (not jnp.zeros) so the carry inherits ell's
    # varying-manual-axes under shard_map.
    ll0 = jnp.zeros_like(ell)

    def bwd_step(ll_old, _):
        # logtheta[i,j, rho_prev, b_cur, rho_cur]
        logtheta = (log_a_r[None, :, :, None, :]
                    + (ell + ll_old)[:, :, None, :, :])
        lse = logsumexp(logtheta, axis=-1)                 # [i,j,rho_prev,b_cur]
        theta = jnp.exp(logtheta - lse[..., None])
        # LL_new[i,j,b_prev,rho_prev] = sum_{b_cur} Ab[i,b_prev,b_cur] lse
        ll_new = jnp.einsum("ibc,ijrc->ijbr", trans_b, lse)
        return ll_new, theta

    ll_last, thetas = jax.lax.scan(bwd_step, ll0, None, length=tau - 1)
    # thetas: [tau-1, i, j, rho_prev, b, rho_cur], ordered t = tau .. 2 in
    # reference terms (first scan element corresponds to t = tau).

    # terminate (t = 1): logtheta1[i,j,b,rho]
    logtheta1 = log_pi_r[None, :, None, :] + ell + ll_last
    lse1 = logsumexp(logtheta1, axis=-1)                   # [i,j,b]
    theta1 = jnp.exp(logtheta1 - lse1[..., None])
    ll_elbo = jnp.einsum("ib,ijb->ij", prior_b, lse1)

    # ---- forward ----
    nu0 = prior_b[:, None, None, :] * jnp.swapaxes(theta1, -1, -2)  # [i,j,rho,b]
    nu_1 = jnp.sum(nu0, axis=-1)

    def fwd_step(carry, theta_t):
        # theta_t: [i,j,rho_prev,b_cur,rho_cur]; iterate t = 2..tau, which
        # is the REVERSE of the scan-stacking order of `thetas`.
        nu, sum_xi, sum_t_nu = carry
        foo = jnp.einsum("ijrb,ibc->ijrc", nu, trans_b)    # [i,j,rho_prev,b_cur]
        xi = foo[..., None] * theta_t                      # [i,j,rho_prev,b_cur,rho_cur]
        sum_xi = sum_xi + jnp.sum(xi, axis=-2)
        nu_new = jnp.swapaxes(jnp.sum(xi, axis=-3), -1, -2)  # [i,j,rho_cur,b_cur]
        return (nu_new, sum_xi, sum_t_nu + nu_new), None

    # [Kb,Kr,Sr,Sr] zeros that inherit nu0's varying axes (shard_map)
    sum_xi0 = jnp.einsum("ijrb,ijsb->ijrs", nu0, nu0) * 0.0
    init = (nu0, sum_xi0, nu0)
    (nu_f, sum_xi, sum_t_nu), _ = jax.lax.scan(fwd_step, init, thetas,
                                               reverse=True)
    return PairStats(ll_elbo=ll_elbo, nu_1=nu_1, sum_xi=sum_xi,
                     sum_t_nu=sum_t_nu)
