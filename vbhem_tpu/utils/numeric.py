"""Numeric primitives shared by the VBEM / VBHEM / VHEM engines.

These replace the reference toolbox's scattered numeric helpers
(`src/vbhem/logtrick.m`, `src/vbhem/logtrick2.m`, the digamma-expectation
blocks in `src/hmm/vbhmm_fb.m:63-93`, and the Wishart/Dirichlet
normalizer constants in `src/hmm/vbhmm_em_lb.m:74-118`) with batched,
jit-friendly JAX equivalents.  Everything is dtype-polymorphic: float64
for CPU parity tests, float32 on the GPU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import digamma, gammaln

__all__ = [
    "tiny",
    "logsumexp",
    "masked_logsumexp",
    "e_log_det_lambda",
    "e_log_dirichlet",
    "log_dirichlet_const",
    "log_wishart_b",
    "sym",
    "solve_psd",
    "logdet_psd",
]


def tiny(dtype) -> jnp.ndarray:
    """Dtype-aware replacement for the reference's `+1e-50` mass floors
    (`vbhmm_em.m:163,172`, `vbhem_h3m_c_step_fc.m:277`).  1e-50 underflows
    in float32, so we use the smallest positive normal for the dtype."""
    return jnp.asarray(jnp.finfo(jnp.dtype(dtype)).tiny, dtype=dtype)


def logsumexp(a: jnp.ndarray, axis=-1, keepdims: bool = False) -> jnp.ndarray:
    """log-sum-exp (the reference's `logtrick`/`logtrick2`)."""
    amax = jnp.max(a, axis=axis, keepdims=True)
    amax = jnp.where(jnp.isfinite(amax), amax, 0.0)
    out = jnp.log(jnp.sum(jnp.exp(a - amax), axis=axis, keepdims=True)) + amax
    return out if keepdims else jnp.squeeze(out, axis=axis)


def masked_logsumexp(a: jnp.ndarray, mask: jnp.ndarray, axis=-1,
                     keepdims: bool = False) -> jnp.ndarray:
    """log-sum-exp over entries where ``mask`` is True; -inf rows give -inf.

    Masked entries are excluded by setting them to -inf *before* the max
    shift; NaN·0 issues are avoided by the finite-max guard.
    """
    neg_inf = jnp.asarray(-jnp.inf, dtype=a.dtype)
    am = jnp.where(mask, a, neg_inf)
    amax = jnp.max(am, axis=axis, keepdims=True)
    safe_amax = jnp.where(jnp.isfinite(amax), amax, 0.0)
    s = jnp.sum(jnp.where(mask, jnp.exp(am - safe_amax), 0.0),
                axis=axis, keepdims=True)
    out = jnp.where(jnp.isfinite(amax), jnp.log(s) + safe_amax, neg_inf)
    return out if keepdims else jnp.squeeze(out, axis=axis)


def e_log_det_lambda(v: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """E[log |Lambda|] for Lambda ~ Wishart(W, v); Bishop (10.65).

    ``logLambdaTilde`` in the reference (`vbhmm_fb.m:64-68`):
        sum_i psi((v + 1 - i)/2) + D log 2 + log det W.

    v: [...], w: [..., D, D] -> [...].
    """
    d = w.shape[-1]
    i = jnp.arange(1, d + 1, dtype=v.dtype)
    t = jnp.sum(digamma(0.5 * (v[..., None] + 1.0 - i)), axis=-1)
    return t + d * jnp.log(jnp.asarray(2.0, v.dtype)) + logdet_psd(w)


def e_log_dirichlet(conc: jnp.ndarray, axis=-1) -> jnp.ndarray:
    """E[log pi_k] for pi ~ Dir(conc); Bishop (10.66):
    psi(conc_k) - psi(sum conc).  Used for logPiTilde / logATilde
    (`vbhmm_fb.m:70-93`)."""
    return digamma(conc) - digamma(jnp.sum(conc, axis=axis, keepdims=True))


def log_dirichlet_const(conc: jnp.ndarray, axis=-1) -> jnp.ndarray:
    """log C(conc) of a Dirichlet: gammaln(sum conc) - sum gammaln(conc)
    (`vbhmm_em_lb.m:92-94`)."""
    return gammaln(jnp.sum(conc, axis=axis)) - jnp.sum(gammaln(conc), axis=axis)


def log_wishart_b(logdet_winv: jnp.ndarray, v: jnp.ndarray, d: int) -> jnp.ndarray:
    """log B(W, v) of a Wishart given log det(W^{-1}) (`vbhmm_em_lb.m:88-89`):

        (v/2) logdet(W^-1) - (v d / 2) log 2 - (d(d-1)/4) log pi
        - sum_i gammaln((v + 1 - i)/2)
    """
    v = jnp.asarray(v)
    i = jnp.arange(1, d + 1, dtype=v.dtype)
    return (0.5 * v * logdet_winv
            - 0.5 * v * d * jnp.log(jnp.asarray(2.0, v.dtype))
            - 0.25 * d * (d - 1) * jnp.log(jnp.asarray(jnp.pi, v.dtype))
            - jnp.sum(gammaln(0.5 * (v[..., None] + 1.0 - i)), axis=-1))


def sym(a: jnp.ndarray) -> jnp.ndarray:
    """Symmetrize [..., D, D] (reference symmetrizes W and C for stability,
    `vbhmm_em.m:382-407`)."""
    return 0.5 * (a + jnp.swapaxes(a, -1, -2))


def solve_psd(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve a @ x = b for symmetric positive-definite ``a`` via Cholesky."""
    chol = jnp.linalg.cholesky(a)
    return jax.scipy.linalg.cho_solve((chol, True), b)


def inv_psd(a: jnp.ndarray) -> jnp.ndarray:
    """Inverse of a symmetric positive-definite matrix.

    D <= 3 uses the closed-form cofactor inverse: the model family's
    emission dims are tiny (D=2 fixations), and a batched Cholesky of
    [..., 2, 2] lowers to separate loop kernels whose launch overhead
    can dominate the EM iteration's Kb-independent cost; the cofactor
    form is pure elementwise arithmetic that XLA fuses into the
    surrounding chain.  Larger D falls back to Cholesky."""
    d = a.shape[-1]
    if d == 1:
        return 1.0 / a
    if d == 2:
        a00 = a[..., 0, 0]
        a01 = 0.5 * (a[..., 0, 1] + a[..., 1, 0])
        a11 = a[..., 1, 1]
        det = a00 * a11 - a01 * a01
        inv = jnp.stack([
            jnp.stack([a11, -a01], axis=-1),
            jnp.stack([-a01, a00], axis=-1)], axis=-2)
        return inv / det[..., None, None]
    if d == 3:
        s = sym(a)
        a00, a01, a02 = s[..., 0, 0], s[..., 0, 1], s[..., 0, 2]
        a11, a12, a22 = s[..., 1, 1], s[..., 1, 2], s[..., 2, 2]
        c00 = a11 * a22 - a12 * a12
        c01 = a02 * a12 - a01 * a22
        c02 = a01 * a12 - a02 * a11
        c11 = a00 * a22 - a02 * a02
        c12 = a01 * a02 - a00 * a12
        c22 = a00 * a11 - a01 * a01
        det = a00 * c00 + a01 * c01 + a02 * c02
        inv = jnp.stack([
            jnp.stack([c00, c01, c02], axis=-1),
            jnp.stack([c01, c11, c12], axis=-1),
            jnp.stack([c02, c12, c22], axis=-1)], axis=-2)
        return inv / det[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(d, dtype=a.dtype), a.shape)
    return sym(solve_psd(a, eye))


def logdet_psd(a: jnp.ndarray) -> jnp.ndarray:
    """log det of a symmetric positive-definite matrix.

    Closed-form determinant for D <= 3 (see :func:`inv_psd` for why);
    Cholesky otherwise.  PSD inputs keep the closed-form determinant
    positive, so the log is as safe as the Cholesky diagonal."""
    d = a.shape[-1]
    if d == 1:
        return jnp.log(a[..., 0, 0])
    if d == 2:
        a01 = 0.5 * (a[..., 0, 1] + a[..., 1, 0])
        det = a[..., 0, 0] * a[..., 1, 1] - a01 * a01
        return jnp.log(det)
    if d == 3:
        s = sym(a)
        a00, a01, a02 = s[..., 0, 0], s[..., 0, 1], s[..., 0, 2]
        a11, a12, a22 = s[..., 1, 1], s[..., 1, 2], s[..., 2, 2]
        det = (a00 * (a11 * a22 - a12 * a12)
               + a01 * (a02 * a12 - a01 * a22)
               + a02 * (a01 * a12 - a02 * a11))
        return jnp.log(det)
    chol = jnp.linalg.cholesky(a)
    diag = jnp.diagonal(chol, axis1=-2, axis2=-1)
    return 2.0 * jnp.sum(jnp.log(diag), axis=-1)


def masked_e_log_dirichlet(conc: jnp.ndarray, mask: jnp.ndarray,
                           axis=-1, big: float = 1e30) -> jnp.ndarray:
    """E[log pi_k] over the ACTIVE entries of a padded Dirichlet: the
    normalizer sums active concentrations only; masked entries get -big
    (finite, so downstream exp() is exactly 0 without inf arithmetic).
    Used by the single-program padded (K,S) sweep."""
    conc_safe = jnp.where(mask, conc, 1.0)
    total = jnp.sum(jnp.where(mask, conc, 0.0), axis=axis, keepdims=True)
    val = digamma(conc_safe) - digamma(total)
    return jnp.where(mask, val, jnp.asarray(-big, conc.dtype))


def masked_log_dirichlet_const(conc: jnp.ndarray, mask: jnp.ndarray,
                               axis=-1) -> jnp.ndarray:
    """log C(conc) over the active entries of a padded Dirichlet."""
    conc_safe = jnp.where(mask, conc, 1.0)
    total = jnp.sum(jnp.where(mask, conc, 0.0), axis=axis)
    return gammaln(total) - jnp.sum(
        jnp.where(mask, gammaln(conc_safe), 0.0), axis=axis)
