"""PPK-SC: probability-product-kernel spectral clustering of HMMs.

Parity map: `src/compare_mtds/ppk/ppk_sc.m` (driver), `elkernel.m`
(iterated PPK between two HMMs, T=10, rho=0.5, covariance pad 0.45),
`bhatt.m` (Bhattacharyya affinity between Gaussians, ridge 1e-5*trace),
`SpectralClustering.m` (Jordan-Weiss type 3: symmetric-normalized
affinity, top-K eigenvectors, row-normalized, k-means).

The Gram matrix is one `vmap` over HMM pairs; eigendecomposition via
`jnp.linalg.eigh`; k-means via :mod:`..ops.kmeans`.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..containers import HMM
from ..ops.kmeans import kmeans

PAD = 0.45          # elkernel.m:17 ("i don't know what is this!")
RHO = 0.5           # Bhattacharyya exponent
DEFAULT_T = 10


def bhatt_affinity(mean1, cov1, mean2, cov2) -> jnp.ndarray:
    """Bhattacharyya affinity between all Gaussian pairs (`bhatt.m`).

    mean1 [S1,D], cov1 [S1,D,D], mean2 [S2,D], cov2 [S2,D,D] -> [S1,S2].
    """
    from ..utils.numeric import inv_psd, logdet_psd
    d = mean1.shape[-1]
    ridge = 1e-5
    c1 = cov1 + ridge * jnp.trace(cov1, axis1=-2, axis2=-1)[..., None, None] \
        * jnp.eye(d, dtype=cov1.dtype)
    c2 = cov2 + ridge * jnp.trace(cov2, axis1=-2, axis2=-1)[..., None, None] \
        * jnp.eye(d, dtype=cov2.dtype)
    ic1 = inv_psd(c1)                                    # [S1,D,D]
    ic2 = inv_psd(c2)                                    # [S2,D,D]
    cd = inv_psd(ic1[:, None] + ic2[None, :])            # [S1,S2,D,D]
    md = jnp.einsum("ide,ie->id", ic1, mean1)[:, None, :] \
        + jnp.einsum("jde,je->jd", ic2, mean2)[None, :, :]
    q1 = jnp.einsum("id,ide,ie->i", mean1, ic1, mean1)[:, None]
    q2 = jnp.einsum("jd,jde,je->j", mean2, ic2, mean2)[None, :]
    qd = jnp.einsum("ijd,ijde,ije->ij", md, cd, md)
    log_norm = ((1 - 2 * RHO) * (d / 2) * jnp.log(2 * jnp.pi)
                - (d / 2) * jnp.log(RHO)
                - (RHO / 2) * logdet_psd(c1)[:, None]
                - (RHO / 2) * logdet_psd(c2)[None, :]
                + 0.5 * logdet_psd(cd))
    return jnp.exp(log_norm - (RHO / 2) * (q1 + q2 - qd))


def ppk(hmm1: HMM, hmm2: HMM, t: int = DEFAULT_T,
        rho: float = RHO) -> jnp.ndarray:
    """Iterated probability-product kernel (`elkernel.m:28-53`)."""
    d = hmm1.dim
    pad = PAD * jnp.eye(d, dtype=hmm1.cov.dtype)
    pot = bhatt_affinity(hmm1.mean, hmm1.cov + pad,
                         hmm2.mean, hmm2.cov + pad)     # [S1,S2]
    p1, p2 = hmm1.prior, hmm2.prior
    a1, a2 = hmm1.trans, hmm2.trans
    if t == 1:
        return jnp.einsum("i,j,ij->", p1, p2, pot)
    # sep1 = sum_ij (p1_i p2_j)^rho pot_ij (A1_i:)^rho' (A2_j:)^rho
    w0 = (p1[:, None] * p2[None, :]) ** rho * pot        # [S1,S2]
    sep = jnp.einsum("ij,ik,jl->kl", w0, a1 ** rho, a2 ** rho)

    def step(sep, _):
        w = sep * pot
        new = jnp.einsum("ij,ik,jl->kl", w, a1 ** rho, a2 ** rho)
        return new, None

    # reference: t=2..T updates sep (T-1 total updates incl. the first)
    sep, _ = jax.lax.scan(step, sep, None, length=t - 2) if t > 2 \
        else (sep, None)
    return jnp.sum(sep * pot)


def _gram_matrix_loop(hmms: Sequence[HMM], t: int = DEFAULT_T) -> np.ndarray:
    """Host-side pair loop (kept as the oracle for the batched path)."""
    n = len(hmms)
    a = np.zeros((n, n))
    for i in range(n):
        for j in range(i, n):
            v = float(ppk(hmms[i], hmms[j], t))
            a[i, j] = a[j, i] = v
    return a


def gram_matrix(hmms: Sequence[HMM], t: int = DEFAULT_T) -> np.ndarray:
    """Pairwise PPK Gram matrix (`ppk_sc.m:16-22`) as ONE dispatch.

    Heterogeneous state counts are zero-padded (prior/transition mass 0,
    identity covariance): a padded state contributes exactly 0 to every
    `sep` update because its prior weight and incoming transition mass
    are both zero, so the padded kernel equals the ragged one.  The full
    N x N pair grid is then a double vmap — the vectorised form of the
    reference's `for n2=n1:N` loop (`ppk_sc.m:16-22`).
    """
    from .vbhem import h3m_from_hmms
    bank = h3m_from_hmms(list(hmms))
    hb = bank.hmm
    n = bank.num_hmms

    def pair(i, j):
        h1 = HMM(prior=hb.prior[i], trans=hb.trans[i], mean=hb.mean[i],
                 cov=hb.cov[i])
        h2 = HMM(prior=hb.prior[j], trans=hb.trans[j], mean=hb.mean[j],
                 cov=hb.cov[j])
        return ppk(h1, h2, t)

    ii, jj = jnp.meshgrid(jnp.arange(n), jnp.arange(n), indexing="ij")
    g = jax.jit(jax.vmap(jax.vmap(pair)))(ii, jj)
    g = np.asarray(g)
    return 0.5 * (g + g.T)


class PPKSCResult(NamedTuple):
    label: np.ndarray          # [N] cluster assignments (0-based)
    center_idx: np.ndarray     # [K] index of center HMM per cluster
    gram: np.ndarray           # [N, N]
    embedding: np.ndarray      # [N, K] spectral embedding


def spectral_cluster(key, affinity: np.ndarray, k: int) -> tuple:
    """Jordan-Weiss normalized spectral clustering
    (`SpectralClustering.m:29-98`, Type 3)."""
    degs = affinity.sum(axis=1)
    degs = np.where(degs == 0, np.finfo(float).eps, degs)
    dm12 = 1.0 / np.sqrt(degs)
    lap = dm12[:, None] * affinity * dm12[None, :]
    lap = 0.5 * (lap + lap.T)
    vals, vecs = np.linalg.eigh(lap)
    u = vecs[:, np.argsort(-vals)[:k]]                  # top-K eigenvectors
    norms = np.sqrt((u ** 2).sum(axis=1, keepdims=True))
    u = np.where(norms > 0, u / norms, 0.0)
    assign, centers = kmeans(key, jnp.asarray(u), k)
    return np.asarray(assign), np.asarray(centers), u


def ppk_sc(key, hmms: Sequence[HMM], k: int,
           t: int = DEFAULT_T) -> PPKSCResult:
    """Full PPK-SC pipeline (`ppk_sc.m`).  Cluster 'centers' are the
    input HMMs mapped closest to the spectral centroids (`:36-45`)."""
    a = gram_matrix(hmms, t)
    assign, centers, u = spectral_cluster(key, a, k)
    center_idx = np.zeros((k,), dtype=np.int64)
    for j in range(k):
        members = np.where(assign == j)[0]
        if len(members) == 0:
            center_idx[j] = int(np.argmin(
                ((u - centers[j]) ** 2).sum(axis=1)))
            continue
        d2 = ((u[members] - centers[j]) ** 2).sum(axis=1)
        center_idx[j] = members[int(np.argmin(d2))]
    return PPKSCResult(label=assign, center_idx=center_idx, gram=a,
                       embedding=u)
