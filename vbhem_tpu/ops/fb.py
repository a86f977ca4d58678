"""Masked, batched scaled forward-backward for the VBEM E-step.

XLA replacement for the reference's C MEX kernel
`src/hmm/vbhmm_fb_mex.c` (I/O contract at :6-25) and its MATLAB mirror
`src/hmm/vbhmm_fb.m:201-379`.  Instead of looping sequences in C, the
whole batch advances together: the scan carries ``alpha_hat`` of shape
[N, K], so each time step is one batched [N,K]x[K,K] product, and the
T-loop is a single `lax.scan`.  On the GPU in float32 the fused kernel
of :mod:`.fb_pallas` serves the E-step instead; this path is its
reference.

Numerical conventions copied from the reference (required for ELBO
parity):
  * emissions are rescaled per time step by ``max_k logrho``
    (`vbhmm_fb.m:289-291`), and that shift is added back into the
    per-sequence log-normalizer ``phi_norm`` (`vbhmm_fb.m:377`);
  * the forward recursion is renormalized by ``c_t = sum_k Delta_t``
    (`vbhmm_fb.m:299-323`);
  * the initial/transition scores are ``exp`` of digamma expectations
    (sub-normalized), per Bishop's VBHMM (`vbhmm_fb.m:121-122`).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..containers import NIW


class FBStats(NamedTuple):
    """E-step outputs, mirroring `vbhmm_fb.m:383-389`."""
    log_rho: jnp.ndarray    # [N, T, K] expected log emission (masked entries = 0)
    gamma: jnp.ndarray      # [N, T, K] responsibilities (masked entries = 0)
    xi_sum: jnp.ndarray     # [N, K, K] summed transition responsibilities
    phi_norm: jnp.ndarray   # [N] per-sequence log normalizer of q(Z)


def expected_log_gauss(x: jnp.ndarray, niw: NIW) -> jnp.ndarray:
    """Expected log Gaussian density under the NIW posterior.

    Bishop (10.46)/(10.64), as in `vbhmm_fb.m:234-257`:
        delta[k] = D/beta_k + v_k (x - m_k)^T W_k (x - m_k)
        logrho[k] = 0.5 E[log|Lambda_k|] - 0.5 delta[k] - (D/2) log(2 pi)

    x: [N, T, D] -> [N, T, K].
    """
    from ..utils.numeric import e_log_det_lambda
    d = x.shape[-1]
    diff = x[:, :, None, :] - niw.m[None, None, :, :]           # [N,T,K,D]
    quad = jnp.einsum("ntkd,kde,ntke->ntk", diff, niw.w, diff)
    delta = d / niw.beta[None, None, :] + niw.v[None, None, :] * quad
    log_lam = e_log_det_lambda(niw.v, niw.w)                    # [K]
    cd = 0.5 * d * jnp.log(jnp.asarray(2.0 * jnp.pi, x.dtype))
    return 0.5 * log_lam[None, None, :] - 0.5 * delta - cd


def forward_backward(log_pz1: jnp.ndarray, log_trans: jnp.ndarray,
                     log_rho: jnp.ndarray, mask: jnp.ndarray) -> FBStats:
    """Scaled FB over a padded batch.

    log_pz1:   [K] or [N, K]   digamma expectation E[log pi] (NOT
               normalized); a leading N axis gives per-sequence priors
               (the reference's `usegroups` mode, `vbhmm_fb.m:81-93`).
    log_trans: [K, K] or [N, K, K] E[log A], row format
    log_rho:   [N, T, K] expected log emissions
    mask:      [N, T] bool, True for real observations.  Every sequence
               must have mask[:, 0] == True (T >= 1).
    """
    n, t_max, k = log_rho.shape
    dtype = log_rho.dtype

    pz1 = jnp.exp(log_pz1)          # sub-normalized prior scores
    trans = jnp.exp(log_trans)      # sub-normalized transition scores
    if pz1.ndim == 1:
        pz1 = jnp.broadcast_to(pz1[None, :], (n, k))
    per_seq_trans = trans.ndim == 3

    def fwd_mm(alpha_prev):
        if per_seq_trans:
            return jnp.einsum("nk,nkl->nl", alpha_prev, trans)
        return alpha_prev @ trans

    def bwd_mm(bp):
        if per_seq_trans:
            return jnp.einsum("nl,nkl->nk", bp, trans)
        return bp @ trans.T

    # Per-step emission rescale by the max over states (vbhmm_fb.m:289-291).
    max_rho = jnp.max(log_rho, axis=-1)                        # [N, T]
    px = jnp.exp(log_rho - max_rho[..., None])                 # [N, T, K]
    maskf = mask.astype(dtype)

    # ---- forward: alpha_hat_t = normalize((alpha_{t-1} @ A) * px_t) ----
    delta0 = pz1 * px[:, 0, :]
    c0 = jnp.sum(delta0, axis=-1)                              # [N]
    alpha0 = delta0 / c0[:, None]

    def fwd_step(alpha_prev, inp):
        px_t, valid = inp                                      # [N,K], [N]
        delta = fwd_mm(alpha_prev) * px_t
        c = jnp.sum(delta, axis=-1)
        c_safe = jnp.where(c > 0, c, 1.0)
        alpha_new = delta / c_safe[:, None]
        # Padded steps: carry alpha through unchanged, c contributes log 1.
        alpha_out = jnp.where(valid[:, None], alpha_new, alpha_prev)
        c_out = jnp.where(valid, c_safe, 1.0)
        return alpha_out, (alpha_out, c_out)

    xs = (jnp.moveaxis(px[:, 1:], 1, 0), jnp.moveaxis(mask[:, 1:], 1, 0))
    _, (alpha_rest, c_rest) = jax.lax.scan(fwd_step, alpha0, xs)
    alpha = jnp.concatenate([alpha0[None], alpha_rest], axis=0)  # [T, N, K]
    c = jnp.concatenate([c0[None], c_rest], axis=0)              # [T, N]

    # ---- backward: beta, gamma, xi (vbhmm_fb.m:325-362) ----
    beta_last = jnp.ones((n, k), dtype=dtype)

    def bwd_step(beta_next, inp):
        # processes position t given (beta_{t+1}, px_{t+1}, c_{t+1}, valid_{t+1})
        px_next, c_next, valid_next, alpha_t = inp
        bp = beta_next * px_next                               # [N, K]
        eta = bwd_mm(bp)
        beta_t = eta / c_next[:, None]
        beta_t = jnp.where(valid_next[:, None], beta_t, jnp.ones_like(beta_t))
        trans_b = trans if per_seq_trans else trans[None]
        xi_t = (trans_b * (alpha_t[:, :, None] * bp[:, None, :])
                / c_next[:, None, None])
        xi_t = jnp.where(valid_next[:, None, None], xi_t, 0.0)
        return beta_t, (beta_t, xi_t)

    xs_b = (jnp.moveaxis(px[:, 1:], 1, 0), c[1:],
            jnp.moveaxis(mask[:, 1:], 1, 0), alpha[:-1])
    _, (beta_rest, xi_all) = jax.lax.scan(bwd_step, beta_last, xs_b,
                                          reverse=True)
    beta = jnp.concatenate([beta_rest, beta_last[None]], axis=0)  # [T, N, K]
    # beta at position T_n-1 (last valid) must be ones: positions whose
    # successor is invalid got ones from the where above.  Position T_max-1
    # is ones by construction.

    gamma = alpha * beta                                       # [T, N, K]
    gamma = jnp.moveaxis(gamma, 0, 1) * maskf[..., None]       # [N, T, K]
    xi_sum = jnp.sum(jnp.moveaxis(xi_all, 0, 1), axis=1)       # [N, K, K]

    log_c = jnp.where(mask, jnp.log(jnp.moveaxis(c, 0, 1)), 0.0)
    phi_norm = jnp.sum(log_c, axis=-1) + jnp.sum(max_rho * maskf, axis=-1)

    return FBStats(log_rho=log_rho * maskf[..., None], gamma=gamma,
                   xi_sum=xi_sum, phi_norm=phi_norm)


def forward_backward_assoc(log_pz1: jnp.ndarray, log_trans: jnp.ndarray,
                           log_rho: jnp.ndarray, mask: jnp.ndarray) -> FBStats:
    """Parallel-in-time FB via `lax.associative_scan` — log-depth over T
    instead of the sequential scan, for long-sequence configurations
    (SURVEY.md section 5: the alpha recursion is a normalized linear
    recurrence over matrix products, so prefix/suffix products give
    every alpha_t / beta_t in O(log T) depth).

    Semantics identical to :func:`forward_backward` (same gamma, xi_sum,
    phi_norm); masked steps contribute identity transition operators.
    Work is O(T K^3) vs the sequential O(T K^2) — the right trade when
    T is large and K small, which is exactly this model family.
    """
    n, t_max, k = log_rho.shape
    dtype = log_rho.dtype
    eye = jnp.eye(k, dtype=dtype)

    pz1 = jnp.exp(log_pz1)
    trans = jnp.exp(log_trans)
    if pz1.ndim == 1:
        pz1 = jnp.broadcast_to(pz1[None, :], (n, k))
    if trans.ndim == 2:
        trans = jnp.broadcast_to(trans[None], (n, k, k))

    max_rho = jnp.max(log_rho, axis=-1)                      # [N, T]
    px = jnp.exp(log_rho - max_rho[..., None])               # [N, T, K]
    maskf = mask.astype(dtype)

    # step operators M_t[i,j] = A[i,j] * b_t[j], identity on masked steps
    # (t >= 1; t = 0 is the initial distribution row)
    m_ops = trans[:, None, :, :] * px[:, 1:, None, :]        # [N,T-1,K,K]
    m_ops = jnp.where(mask[:, 1:, None, None], m_ops,
                      eye[None, None])

    def combine(a, b):
        m1, s1 = a
        m2, s2 = b
        prod = jnp.einsum("...ij,...jk->...ik", m1, m2)
        scale = jnp.max(prod, axis=(-2, -1), keepdims=True)
        scale = jnp.where(scale > 0, scale, 1.0)
        return prod / scale, s1 + s2 + jnp.log(scale[..., 0, 0])

    def combine_rev(a, b):
        # reverse=True scans the flipped sequence, so compose right-to-
        # left to recover products in original time order
        m1, s1 = a
        m2, s2 = b
        prod = jnp.einsum("...ij,...jk->...ik", m2, m1)
        scale = jnp.max(prod, axis=(-2, -1), keepdims=True)
        scale = jnp.where(scale > 0, scale, 1.0)
        return prod / scale, s1 + s2 + jnp.log(scale[..., 0, 0])

    zeros = jnp.zeros(m_ops.shape[:2], dtype)
    # prefix products P_t = M_2 ... M_{t+1}  (alpha_t = alpha_1 P_{t-1})
    pre_m, pre_s = jax.lax.associative_scan(combine, (m_ops, zeros), axis=1)
    # suffix products S_t = M_{t+1} ... M_T  (beta_t = S_t 1)
    suf_m, suf_s = jax.lax.associative_scan(combine_rev, (m_ops, zeros),
                                            axis=1, reverse=True)

    # alpha (normalized rows)
    alpha1 = pz1 * px[:, 0, :]                               # [N, K]
    alpha_rest = jnp.einsum("nk,ntkj->ntj", alpha1, pre_m)   # [N,T-1,K]
    alpha = jnp.concatenate([alpha1[:, None], alpha_rest], axis=1)
    alpha_norm = jnp.sum(alpha, axis=-1, keepdims=True)
    alpha_hat = alpha / jnp.where(alpha_norm > 0, alpha_norm, 1.0)

    # log normalizer: log(alpha_1 . P_{T-1} . 1) + scales + max_rho shifts
    phi_norm = (jnp.log(alpha_norm[:, -1, 0]) + pre_s[:, -1]
                + jnp.sum(max_rho * maskf, axis=-1))

    # beta (normalized) — beta_t = S_t @ 1 for t < T, ones at t = T-1
    beta_rest = jnp.sum(suf_m, axis=-1)                      # [N,T-1,K]
    beta = jnp.concatenate([beta_rest, jnp.ones((n, 1, k), dtype)], axis=1)
    beta_norm = jnp.sum(beta, axis=-1, keepdims=True)
    beta_hat = beta / jnp.where(beta_norm > 0, beta_norm, 1.0)

    gamma = alpha_hat * beta_hat
    gsum = jnp.sum(gamma, axis=-1, keepdims=True)
    gamma = gamma / jnp.where(gsum > 0, gsum, 1.0)
    gamma = gamma * maskf[..., None]

    # xi_t (t -> t+1): alpha_t[i] A[i,j] b_{t+1}[j] beta_{t+1}[j], renorm
    bb = px[:, 1:] * beta_hat[:, 1:]                         # [N,T-1,K]
    xi = (alpha_hat[:, :-1, :, None] * trans[:, None]
          * bb[:, :, None, :])                               # [N,T-1,K,K]
    xi_norm = jnp.sum(xi, axis=(-2, -1), keepdims=True)
    xi = xi / jnp.where(xi_norm > 0, xi_norm, 1.0)
    xi = xi * maskf[:, 1:, None, None]
    xi_sum = jnp.sum(xi, axis=1)

    return FBStats(log_rho=log_rho * maskf[..., None], gamma=gamma,
                   xi_sum=xi_sum, phi_norm=phi_norm)
