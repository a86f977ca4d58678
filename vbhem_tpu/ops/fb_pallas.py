"""Fused Pallas kernel (Triton route) for the VBEM forward-backward
E-step on the GPU.

GPU counterpart of the reference C kernel `src/hmm/vbhmm_fb_mex.c` (I/O
contract at :6-25; scaled recursions mirrored from
`src/hmm/vbhmm_fb.m:201-379`).  The XLA path (:func:`.fb.forward_backward`)
runs the recursion as 2(T-1) `lax.scan` steps of a few small kernels
over [N, K] tensors with K <= 5; here the whole forward and backward
recursion over T runs inside one kernel.

Layout: one sequence per thread.  Every operand is transposed so the
sequence axis N is minor ([T, K, N], [T, N], [K + K*K, N]), so each
per-sequence quantity moves as one coalesced [BLOCK] vector, and the
grid is 1-D over blocks of sequences.  The state loops (K <= K_MAX) are
unrolled in Python; T is a `fori_loop`.  The prior and transition
scores are per-sequence rows, which makes per-sequence parameters (the
reference's `usegroups` mode, `vbhmm_fb.m:81-93`) cost the same as
shared ones.

The Triton route has no scratch memory: the forward pass writes alpha
into the gamma output and the scale factors c into one more output, and
the backward pass reads alpha_t back before it overwrites that slot
with gamma_t.

Restart trials and subjects arrive through `vmap`.  The `custom_vmap`
rule folds the batch axes into N, so a whole bank (subjects x restarts x
sequences, about 20,000 sequences in the reference protocol) runs as
one launch; one lane alone is 25 sequences, less than one block.

Semantics are those of :func:`.fb.forward_backward` (parity in
tests/test_fb.py).
"""
from __future__ import annotations

import functools
import operator

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .fb import FBStats, forward_backward

# Largest state count the unrolled kernel takes.
K_MAX = 8
# Sequences per program: one per thread of NUM_WARPS warps.
BLOCK = 128
NUM_WARPS = 4


def use_kernel(backend: str, dtype, k: int) -> bool:
    """Whether the fused kernel serves a forward-backward E-step: the
    Triton route exists only on the GPU, the kernel is written for
    float32, and its unrolled state loops are bounded."""
    return (backend == "gpu" and jnp.dtype(dtype) == jnp.float32
            and 1 <= k <= K_MAX)


def _sum(xs):
    return functools.reduce(operator.add, xs)


def _kernel(rho_ref, mask_ref, par_ref, gamma_ref, xi_ref, phi_ref, c_ref,
            *, t_max: int, k: int):
    """One block of sequences.  rho [T, K], mask [T] (float 0/1), par
    rows pz1 [K] then trans [K, K]; outputs gamma [T, K], xi [K*K],
    phi [1], and c [T] (the scale factors, read back by the backward
    pass)."""
    pz1 = [par_ref[a] for a in range(k)]
    trans = [par_ref[k + f] for f in range(k * k)]      # [a*k + l]

    def px_at(t):
        # emissions rescaled by their max over states (vbhmm_fb.m:289-291)
        rho = [rho_ref[t, a] for a in range(k)]
        m = functools.reduce(jnp.maximum, rho)
        return [jnp.exp(r - m) for r in rho], m

    # ---- forward (vbhmm_fb.m:299-323): alpha_hat, c, phi ----
    px0, m0 = px_at(0)
    delta = [pz1[a] * px0[a] for a in range(k)]
    c0 = _sum(delta)
    alpha = [x / c0 for x in delta]
    for a in range(k):
        gamma_ref[0, a] = alpha[a]
    c_ref[0] = c0
    phi = jnp.log(c0) + m0                  # t = 0 is always observed

    def fwd(t, carry):
        alpha, phi = carry
        px, m = px_at(t)
        valid = mask_ref[t] > 0.5
        delta = [_sum([alpha[a] * trans[a * k + l] for a in range(k)])
                 * px[l] for l in range(k)]
        c = _sum(delta)
        c_safe = jnp.where(c > 0, c, 1.0)
        # padded steps carry alpha unchanged and contribute log 1
        alpha = tuple(jnp.where(valid, x / c_safe, a)
                      for x, a in zip(delta, alpha))
        c_out = jnp.where(valid, c_safe, 1.0)
        for a in range(k):
            gamma_ref[t, a] = alpha[a]
        c_ref[t] = c_out
        return alpha, phi + jnp.log(c_out) + jnp.where(valid, m, 0.0)

    _, phi = jax.lax.fori_loop(1, t_max, fwd, (tuple(alpha), phi))
    phi_ref[0] = phi

    # ---- backward (vbhmm_fb.m:325-362): beta, gamma, xi_sum ----
    def bwd(s, carry):
        # beta = beta_{t+1}; emit gamma_{t+1}, xi_{t -> t+1}, beta_t
        beta, alpha_next, xi = carry
        t = t_max - 2 - s
        valid = mask_ref[t + 1] > 0.5
        for a in range(k):
            gamma_ref[t + 1, a] = jnp.where(valid, alpha_next[a] * beta[a],
                                            0.0)
        alpha_t = tuple(gamma_ref[t, a] for a in range(k))
        px, _ = px_at(t + 1)
        bp = [beta[l] * px[l] for l in range(k)]
        c_next = c_ref[t + 1]
        xi = tuple(
            xi[a * k + l] + jnp.where(
                valid, trans[a * k + l] * (alpha_t[a] * bp[l]) / c_next, 0.0)
            for a in range(k) for l in range(k))
        beta = tuple(
            jnp.where(valid,
                      _sum([trans[a * k + l] * bp[l] for l in range(k)])
                      / c_next, 1.0)
            for a in range(k))
        return beta, alpha_t, xi

    ones = jnp.ones_like(pz1[0])
    alpha_last = tuple(gamma_ref[t_max - 1, a] for a in range(k))
    beta, alpha0, xi = jax.lax.fori_loop(
        0, t_max - 1, bwd, ((ones,) * k, alpha_last, (0.0 * ones,) * (k * k)))
    for a in range(k):
        gamma_ref[0, a] = alpha0[a] * beta[a]
    for f in range(k * k):
        xi_ref[f] = xi[f]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _fb_call(rho, maskf, par, *, interpret: bool):
    """The kernel over rho [T, K, N], maskf [T, N], par [K + K*K, N]
    (sequences minor) -> gamma [T, K, N], xi [K*K, N], phi [1, N]."""
    t_max, k, n = rho.shape
    n_pad = _round_up(n, BLOCK)

    def pad(a):
        # padded sequences get finite inputs so they stay inert
        return jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, n_pad - n)],
                       constant_values=1.0)

    dtype = rho.dtype
    vma = (jax.typeof(rho).vma | jax.typeof(maskf).vma
           | jax.typeof(par).vma)
    gamma, xi, phi, _ = pl.pallas_call(
        functools.partial(_kernel, t_max=t_max, k=k),
        grid=(n_pad // BLOCK,),
        in_specs=[pl.BlockSpec((t_max, k, BLOCK), lambda i: (0, 0, i)),
                  pl.BlockSpec((t_max, BLOCK), lambda i: (0, i)),
                  pl.BlockSpec((k + k * k, BLOCK), lambda i: (0, i))],
        out_specs=[pl.BlockSpec((t_max, k, BLOCK), lambda i: (0, 0, i)),
                   pl.BlockSpec((k * k, BLOCK), lambda i: (0, i)),
                   pl.BlockSpec((1, BLOCK), lambda i: (0, i)),
                   pl.BlockSpec((t_max, BLOCK), lambda i: (0, i))],
        out_shape=[
            jax.ShapeDtypeStruct((t_max, k, n_pad), dtype, vma=vma),
            jax.ShapeDtypeStruct((k * k, n_pad), dtype, vma=vma),
            jax.ShapeDtypeStruct((1, n_pad), dtype, vma=vma),
            jax.ShapeDtypeStruct((t_max, n_pad), dtype, vma=vma)],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="vbhmm_forward_backward",
    )(pad(rho), pad(maskf), pad(par))
    return gamma[..., :n], xi[:, :n], phi[:, :n]


@functools.lru_cache(maxsize=None)
def _folding_fb_call(interpret: bool):
    """:func:`_fb_call` whose `vmap` folds the batch axis into the
    sequence axis N (one launch for the whole bank; see the module
    docstring)."""

    @jax.custom_batching.custom_vmap
    def call(rho, maskf, par):
        return _fb_call(rho, maskf, par, interpret=interpret)

    @call.def_vmap
    def _fold(axis_size, in_batched, rho, maskf, par):
        n = rho.shape[-1]

        def fold(a, batched):       # [B, ..., N] -> [..., B*N]
            if not batched:
                a = jnp.broadcast_to(a, (axis_size,) + a.shape)
            a = jnp.moveaxis(a, 0, -2)
            return a.reshape(a.shape[:-2] + (axis_size * n,))

        def unfold(a):              # [..., B*N] -> [B, ..., N]
            return jnp.moveaxis(a.reshape(a.shape[:-1] + (axis_size, n)),
                                -2, 0)

        # recurse through `call` so a further vmap level folds again
        outs = call(*map(fold, (rho, maskf, par), in_batched))
        return tuple(map(unfold, outs)), (True,) * len(outs)

    return call


def forward_backward_pallas(log_pz1: jnp.ndarray, log_trans: jnp.ndarray,
                            log_rho: jnp.ndarray, mask: jnp.ndarray,
                            interpret: bool = False) -> FBStats:
    """Drop-in replacement for :func:`.fb.forward_backward`; accepts
    shared ([K] / [K, K]) or per-sequence ([N, K] / [N, K, K]) scores.
    ``interpret`` runs the kernel on the CPU, for tests only."""
    n, t_max, k = log_rho.shape
    dtype = log_rho.dtype
    pz1 = jnp.broadcast_to(jnp.exp(log_pz1), (n, k))
    trans = jnp.broadcast_to(jnp.exp(log_trans), (n, k, k))
    par = jnp.concatenate([pz1, trans.reshape(n, k * k)], axis=1).T
    maskf = mask.astype(dtype)
    gamma, xi, phi = _folding_fb_call(interpret)(
        jnp.transpose(log_rho, (1, 2, 0)), maskf.T, par.astype(dtype))
    return FBStats(log_rho=log_rho * maskf[..., None],
                   gamma=jnp.transpose(gamma, (2, 0, 1)),
                   xi_sum=jnp.transpose(xi.reshape(k, k, n), (2, 0, 1)),
                   phi_norm=phi[0])


def forward_backward_auto(log_pz1: jnp.ndarray, log_trans: jnp.ndarray,
                          log_rho: jnp.ndarray, mask: jnp.ndarray) -> FBStats:
    """The VBEM E-step: the fused kernel where :func:`use_kernel` allows
    it, otherwise the XLA `lax.scan` (the reference's `useMEX` dual
    path, `vbhmm_fb.m:96-199`)."""
    if use_kernel(jax.default_backend(), log_rho.dtype, log_rho.shape[-1]):
        return forward_backward_pallas(log_pz1, log_trans, log_rho, mask)
    return forward_backward(log_pz1, log_trans, log_rho, mask)
