"""VHEM: non-Bayesian hierarchical EM clustering of HMM banks — the
original H3M-toolbox baseline (reference L4, `src/compare_mtds/hem/`).

Parity map:
  * `vhem_cluster.m`      -> :func:`cluster`
  * `hem_h3m_c.m`         -> :func:`fit_single_ks` (vmapped trials)
  * `hem_h3m_c_step.m`    -> :func:`vhem_em`
  * `hem_hmm_bwd_fwd_mex.c` -> shared :mod:`..ops.pair_estep` kernel with
    the point-estimate expected-log-Gaussian flavor (the reference keeps
    two near-identical C kernels; SURVEY.md section 7.1 merges them)
  * `hem_mstep_component.m` -> :func:`m_step` (weighted ML updates)
  * `initialize_hem_h3m_c.m` ('baseem'/'base') -> initializers

Degenerate handling (`hem_h3m_c_step.m:461-493`): after each M-step,
zero-mass clusters are replaced by a perturbed copy of the heaviest
cluster with its weight split (`hem_fix_degenerate_component.m`), and
zero-count states within a cluster by a perturbed copy of that
cluster's heaviest state (`hem_fix_degenerate_hmm.m`); see
:func:`fix_degenerate_components` / :func:`fix_degenerate_states`.
The GMM-emission fix (`hem_fix_degenerate_emission.m`) never fires in
this toolbox — emissions are single Gaussians (ncentres == 1 guard at
`hem_h3m_c_step.m:481`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp

from ..config import HEMConfig
from ..containers import H3M, HMM
from ..ops.pair_estep import (PairStats, expected_pair_ll_point,
                              pair_bwd_fwd)
from ..utils.numeric import logsumexp, sym, tiny


class VHEMState(NamedTuple):
    h3m: H3M                 # reduced model (point estimates)
    ll: jnp.ndarray
    last_ll: jnp.ndarray
    it: jnp.ndarray
    z: jnp.ndarray           # [Kb, Kr]
    ll_elbo: jnp.ndarray     # [Kb, Kr]
    emit_counts: jnp.ndarray  # [Kr, Sr] state virtual counts
    done: jnp.ndarray
    key: jax.Array           # PRNG for degenerate-fix perturbations


def _inf_norm(mode: str, nv: int, tau: int, kb: int) -> float:
    """Normalization of L_elbo (`hem_h3m_c_step.m:110-119`)."""
    if mode == "":
        return 1.0
    if mode == "n":
        return nv / kb
    if mode in ("tn", "nt"):
        return tau * nv / kb
    if mode == "t":
        return float(tau)
    raise ValueError(f"unknown inf_norm {mode!r}")


def e_step(base: H3M, reduced: H3M, tau: int,
           smooth: float = 1.0) -> PairStats:
    """Pair E-step with point-estimate scores (`hem_h3m_c_step.m:185-287`).
    ``smooth`` tempers the expected emission log-likelihood."""
    ell = expected_pair_ll_point(base.hmm.mean, base.hmm.cov,
                                 reduced.hmm.mean, reduced.hmm.cov)
    if smooth != 1.0:
        ell = ell / smooth
    log_pi = jnp.log(jnp.maximum(reduced.hmm.prior, 1e-300))
    log_a = jnp.log(jnp.maximum(reduced.hmm.trans, 1e-300))
    return pair_bwd_fwd(base.hmm.prior, base.hmm.trans, log_pi, log_a, ell,
                        tau)


def m_step(base: H3M, pair: PairStats, z: jnp.ndarray,
           config: HEMConfig) -> tuple:
    """Weighted ML updates (`hem_h3m_c_step.m:428-459` +
    `hem_mstep_component.m:83-166`).  Returns (reduced H3M, emit counts)."""
    dtype = z.dtype
    kb, kr = z.shape
    sr = pair.nu_1.shape[-1]
    d = base.hmm.mean.shape[-1]
    eps = tiny(dtype)

    omega_new = jnp.sum(z, axis=0) / kb                       # [Kr]
    zw = z * base.omega[:, None]                              # Zomega [Kb,Kr]

    prior_u = jnp.einsum("ij,ijr->jr", zw, pair.nu_1)
    a_u = jnp.einsum("ij,ijrs->jrs", zw, pair.sum_xi)
    if sr == 1:
        a_u = jnp.full_like(a_u, 1e-12)   # hem_mstep_component.m:124-126
    if config.tau == 1:
        a_u = 1e-12 * jnp.broadcast_to(jnp.eye(sr, dtype=dtype), a_u.shape)
    prior_new = prior_u / jnp.maximum(jnp.sum(prior_u, -1, keepdims=True), eps)
    trans_new = a_u / jnp.maximum(jnp.sum(a_u, -1, keepdims=True), eps)

    # emission stats are linear in sum_t_nu against cached base moments
    mean_b = base.hmm.mean
    m2_b = mean_b[..., :, None] * mean_b[..., None, :] + base.hmm.cov
    w_sum = jnp.einsum("ij,ijrb->jr", zw, pair.sum_t_nu)      # Gweight
    mu_sum = jnp.einsum("ij,ijrb,ibd->jrd", zw, pair.sum_t_nu, mean_b)
    m2_sum = jnp.einsum("ij,ijrb,ibde->jrde", zw, pair.sum_t_nu, m2_b)
    w_safe = jnp.maximum(w_sum, eps)
    mean_new = mu_sum / w_safe[..., None]
    cov_new = sym(m2_sum / w_safe[..., None, None]
                  - mean_new[..., :, None] * mean_new[..., None, :])
    cov_new = cov_new + config.reg_cov * jnp.eye(d, dtype=dtype)
    if config.covar_type == "diag":
        # `hem_mstep_component.m` diag case: ML covariance is the
        # diagonal of the weighted second moment minus mean^2
        cov_new = cov_new * jnp.eye(d, dtype=dtype)

    # state virtual counts (`hem_mstep_component.m:138`)
    emit_counts = jnp.sum(a_u, axis=-2) + prior_u
    h3m = H3M(omega=omega_new,
              hmm=HMM(prior=prior_new, trans=trans_new,
                      mean=mean_new, cov=cov_new),
              state_mask=jnp.ones((kr, sr), bool))
    return h3m, emit_counts


def fix_degenerate_components(h3m: H3M, key: jax.Array) -> H3M:
    """Replace zero-weight clusters by a perturbed copy of the heaviest
    one with its weight split (`hem_fix_degenerate_component.m`).

    The reference fixes degenerates one at a time in a Python loop; here
    all simultaneous zeros (rare — usually one) draw from the same donor
    and share half its weight, which is jit-compatible and identical in
    the single-degenerate case.  Like the reference, the copied cluster
    gets the donor's emissions, a noised copy of the donor's prior, and
    a fresh random transition matrix preserving the donor's zero
    pattern."""
    omega = h3m.omega
    kr, sr = h3m.hmm.prior.shape
    dtype = omega.dtype
    deg = omega <= 0.0
    n_deg = jnp.sum(deg)
    any_deg = n_deg > 0
    donor = jnp.argmax(omega)
    is_donor = jnp.arange(kr) == donor

    w_max = omega[donor]
    omega_new = jnp.where(deg, 0.5 * w_max / jnp.maximum(n_deg, 1), omega)
    omega_new = jnp.where(any_deg & is_donor, 0.5 * w_max, omega_new)
    omega_new = omega_new / jnp.sum(omega_new)

    k1, k2 = jax.random.split(key)
    # prior: donor prior + (.1/Sr) * U[0,1), renormalized
    prior_d = h3m.hmm.prior[donor]
    prior_fix = prior_d[None] + (0.1 / sr) * jax.random.uniform(
        k1, (kr, sr), dtype)
    prior_fix = prior_fix / jnp.sum(prior_fix, -1, keepdims=True)
    prior_new = jnp.where(deg[:, None], prior_fix, h3m.hmm.prior)
    # A: fresh (.1/Sr)*rand with the donor's zeros kept, renormalized
    trans_d = h3m.hmm.trans[donor]
    a_fix = (0.1 / sr) * jax.random.uniform(k2, (kr, sr, sr), dtype)
    a_fix = jnp.where(trans_d[None] == 0, 0.0, a_fix)
    a_fix = a_fix / jnp.maximum(jnp.sum(a_fix, -1, keepdims=True), 1e-300)
    trans_new = jnp.where(deg[:, None, None], a_fix, h3m.hmm.trans)

    mean_new = jnp.where(deg[:, None, None], h3m.hmm.mean[donor][None],
                         h3m.hmm.mean)
    cov_new = jnp.where(deg[:, None, None, None], h3m.hmm.cov[donor][None],
                        h3m.hmm.cov)
    return h3m._replace(omega=omega_new,
                        hmm=HMM(prior=prior_new, trans=trans_new,
                                mean=mean_new, cov=cov_new))


def fix_degenerate_states(h3m: H3M, emit_counts: jnp.ndarray,
                          key: jax.Array) -> H3M:
    """Replace zero-count states of each cluster by a split of that
    cluster's heaviest state (`hem_fix_degenerate_hmm.m`): prior mass
    halved between donor and copy, donor's outgoing row copied, incoming
    column split, emission mean perturbed by 1% multiplicative noise."""
    kr, sr = h3m.hmm.prior.shape
    dtype = h3m.hmm.prior.dtype
    deg = emit_counts <= 0.0                                  # [Kr, Sr]
    n_deg = jnp.sum(deg, axis=-1)                             # [Kr]
    any_deg = n_deg > 0
    donor = jnp.argmax(emit_counts, axis=-1)                  # [Kr]
    is_donor = jnp.arange(sr)[None, :] == donor[:, None]      # [Kr, Sr]

    take_donor = lambda a: jnp.take_along_axis(
        a, donor.reshape((kr,) + (1,) * (a.ndim - 1)), axis=1)

    p_max = take_donor(h3m.hmm.prior)                         # [Kr, 1]
    prior_new = jnp.where(deg, 0.5 * p_max / jnp.maximum(n_deg, 1)[:, None],
                          h3m.hmm.prior)
    prior_new = jnp.where(any_deg[:, None] & is_donor, 0.5 * p_max,
                          prior_new)
    prior_new = prior_new / jnp.maximum(
        jnp.sum(prior_new, -1, keepdims=True), 1e-300)

    # rows: degenerate state gets the donor's outgoing row
    row_d = take_donor(h3m.hmm.trans)                         # [Kr, 1, Sr]
    trans_new = jnp.where(deg[:, :, None], row_d, h3m.hmm.trans)
    # columns: incoming donor mass split between donor and degenerates
    col_d = jnp.take_along_axis(trans_new, donor[:, None, None],
                                axis=2)                       # [Kr, Sr, 1]
    share = 0.5 * col_d / jnp.maximum(n_deg, 1)[:, None, None]
    trans_new = jnp.where(deg[:, None, :], share, trans_new)
    trans_new = jnp.where((any_deg[:, None] & is_donor)[:, None, :],
                          0.5 * col_d, trans_new)
    trans_new = trans_new / jnp.maximum(
        jnp.sum(trans_new, -1, keepdims=True), 1e-300)

    mean_d = take_donor(h3m.hmm.mean)                         # [Kr, 1, D]
    noise = 1.0 + 0.01 * jax.random.uniform(key, h3m.hmm.mean.shape, dtype)
    mean_new = jnp.where(deg[:, :, None], mean_d * noise, h3m.hmm.mean)
    cov_d = take_donor(h3m.hmm.cov)                           # [Kr, 1, D, D]
    cov_new = jnp.where(deg[:, :, None, None], cov_d, h3m.hmm.cov)
    return h3m._replace(hmm=HMM(prior=prior_new, trans=trans_new,
                                mean=mean_new, cov=cov_new))


def vhem_em(base: H3M, init: H3M, config: HEMConfig,
            key: Optional[jax.Array] = None) -> VHEMState:
    """The VHEM EM loop (`hem_h3m_c_step.m:179-505`)."""
    dtype = base.hmm.mean.dtype
    kb = base.num_hmms
    kr, sr = init.hmm.prior.shape
    n_i = (config.nv * kb) * base.omega                       # [Kb]
    inf_norm = _inf_norm(config.inf_norm, config.nv, config.tau, kb)
    big_neg = jnp.asarray(-jnp.finfo(dtype).max, dtype)

    # apply the covariance regularization once up front
    # (`hem_h3m_c_step.m:98-108`)
    d = base.hmm.mean.shape[-1]
    init = init._replace(hmm=init.hmm._replace(
        cov=init.hmm.cov + config.reg_cov * jnp.eye(d, dtype=dtype)))

    def body(st: VHEMState) -> VHEMState:
        pair = e_step(base, st.h3m, config.tau, config.smooth)
        ll_n = pair.ll_elbo / inf_norm
        log_z = jnp.log(jnp.maximum(st.h3m.omega, 1e-300))[None, :] \
            + n_i[:, None] * ll_n
        z = jnp.exp(log_z - logsumexp(log_z, -1, keepdims=True))
        ll = jnp.sum(logsumexp(log_z, -1))
        unstable = jnp.isnan(ll)
        ll = jnp.where(unstable, -jnp.inf, ll)
        change = (ll - st.ll) / jnp.abs(st.ll)
        converged = jnp.logical_and(st.it > 0, change < config.min_diff)
        done = converged | unstable | (st.it + 1 >= config.max_iter)
        new_h3m, emit_counts = m_step(base, pair, z, config)
        # degenerate repair (hem_h3m_c_step.m:461-478)
        k_c, k_s = jax.random.split(jax.random.fold_in(st.key, st.it))
        new_h3m = fix_degenerate_components(new_h3m, k_c)
        new_h3m = fix_degenerate_states(new_h3m, emit_counts, k_s)
        new_h3m = jax.tree.map(
            lambda new, old: jnp.where(unstable, old, new), new_h3m, st.h3m)
        return VHEMState(h3m=new_h3m, ll=ll, last_ll=st.ll, it=st.it + 1,
                         z=z, ll_elbo=pair.ll_elbo,
                         emit_counts=emit_counts, done=done, key=st.key)

    st0 = VHEMState(h3m=init, ll=big_neg, last_ll=big_neg,
                    it=jnp.asarray(0), z=jnp.zeros((kb, kr), dtype),
                    ll_elbo=jnp.zeros((kb, kr), dtype),
                    emit_counts=jnp.zeros((kr, sr), dtype),
                    done=jnp.asarray(False),
                    key=key if key is not None else jax.random.key(0))
    return jax.lax.while_loop(lambda st: ~st.done, body, st0)


# ---------------------------------------------------------------------------
# initializers (initialize_hem_h3m_c.m)
# ---------------------------------------------------------------------------

def init_baseem(key: jax.Array, base: H3M, kr: int, sr: int,
                config: HEMConfig) -> H3M:
    """'baseem': random base emissions as reduced emissions, uniform
    prior/transitions (`initialize_hem_h3m_c.m:111-141`)."""
    dtype = base.hmm.mean.dtype
    kb, sb_max = base.state_mask.shape
    k_b, k_g, k_w = jax.random.split(key, 3)
    rand_b = jax.random.randint(k_b, (kr, sr), 0, kb)
    n_states = jnp.sum(base.state_mask, axis=-1)
    u = jax.random.uniform(k_g, (kr, sr))
    rand_g = jnp.minimum(jnp.floor(u * n_states[rand_b]).astype(jnp.int32),
                         sb_max - 1)
    mean = base.hmm.mean[rand_b, rand_g]
    cov = base.hmm.cov[rand_b, rand_g]
    prior = jnp.full((kr, sr), 1.0 / sr, dtype)
    trans = jnp.full((kr, sr, sr), 1.0 / sr, dtype)
    omega = jax.random.uniform(k_w, (kr,), dtype) + 0.1
    omega = omega / jnp.sum(omega)
    return H3M(omega=omega,
               hmm=HMM(prior=prior, trans=trans, mean=mean, cov=cov),
               state_mask=jnp.ones((kr, sr), bool))


def init_base_subset(key: jax.Array, base: H3M, kr: int, sr: int,
                     config: HEMConfig) -> H3M:
    """'base': a random subset of input HMMs as initial centers
    (`initialize_hem_h3m_c.m:40-61,142-155`).  Requires the base HMMs to
    have >= sr states (extra states are truncated, fewer padded from
    state 0)."""
    dtype = base.hmm.mean.dtype
    kb = base.num_hmms
    idx = jax.random.permutation(key, kb)[:kr]
    take = lambda a: a[idx][:, :sr]
    prior = take(base.hmm.prior)
    prior = prior / jnp.maximum(jnp.sum(prior, -1, keepdims=True), 1e-12)
    trans = base.hmm.trans[idx][:, :sr, :sr]
    trans = trans / jnp.maximum(jnp.sum(trans, -1, keepdims=True), 1e-12)
    return H3M(omega=jnp.full((kr,), 1.0 / kr, dtype),
               hmm=HMM(prior=prior, trans=trans,
                       mean=take(base.hmm.mean),
                       cov=base.hmm.cov[idx][:, :sr]),
               state_mask=jnp.ones((kr, sr), bool))


def init_gmmNew(key: jax.Array, base: H3M, kr: int, sr: int,
                config: HEMConfig) -> H3M:
    """'gmmNew': pool base emission Gaussians, reduce to Sr shared
    components with mixture-hierarchies EM, random prior/transitions
    (`initialize_hem_h3m_c.m:276-494` with makeAprior random mode)."""
    from ..ops.gmm import mix_hier_em
    dtype = base.hmm.mean.dtype
    kb, sb_max = base.state_mask.shape
    d = base.hmm.mean.shape[-1]
    k1, k2, k3, k4 = jax.random.split(key, 4)
    red, _ = mix_hier_em(k1, base.hmm.mean.reshape(kb * sb_max, d),
                         base.hmm.cov.reshape(kb * sb_max, d, d),
                         base.state_mask.reshape(-1).astype(dtype), sr,
                         nv=config.nv)
    prior = jax.random.uniform(k2, (kr, sr), dtype)
    prior = prior / jnp.sum(prior, -1, keepdims=True)
    trans = jax.random.uniform(k3, (kr, sr, sr), dtype)
    trans = trans / jnp.sum(trans, -1, keepdims=True)
    omega = jax.random.uniform(k4, (kr,), dtype) + 0.1
    omega = omega / jnp.sum(omega)
    return H3M(omega=omega,
               hmm=HMM(prior=prior, trans=trans,
                       mean=jnp.broadcast_to(red.mean[None], (kr, sr, d)),
                       cov=jnp.broadcast_to(red.cov[None], (kr, sr, d, d))),
               state_mask=jnp.ones((kr, sr), bool))


def init_gmmNew2(key: jax.Array, base: H3M, kr: int, sr: int,
                 config: HEMConfig) -> H3M:
    """'gmmNew2': reduce the pooled base Gaussians to Kr*Sr components
    and give each cluster its own random block of Sr
    (`initialize_hem_h3m_c.m:276-494`, tmpK = Sr*Kr branch)."""
    from ..ops.gmm import mix_hier_em
    dtype = base.hmm.mean.dtype
    kb, sb_max = base.state_mask.shape
    d = base.hmm.mean.shape[-1]
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    red, _ = mix_hier_em(k1, base.hmm.mean.reshape(kb * sb_max, d),
                         base.hmm.cov.reshape(kb * sb_max, d, d),
                         base.state_mask.reshape(-1).astype(dtype), kr * sr,
                         nv=config.nv)
    use = jax.random.permutation(k2, kr * sr).reshape(kr, sr)
    prior = jax.random.uniform(k3, (kr, sr), dtype)
    prior = prior / jnp.sum(prior, -1, keepdims=True)
    trans = jax.random.uniform(k4, (kr, sr, sr), dtype)
    trans = trans / jnp.sum(trans, -1, keepdims=True)
    omega = jax.random.uniform(k5, (kr,), dtype) + 0.1
    omega = omega / jnp.sum(omega)
    return H3M(omega=omega,
               hmm=HMM(prior=prior, trans=trans,
                       mean=red.mean[use], cov=red.cov[use]),
               state_mask=jnp.ones((kr, sr), bool))


def _init_from_indices(base: H3M, idx: jnp.ndarray, sr: int,
                       omega: jnp.ndarray) -> H3M:
    take = lambda a: a[idx][:, :sr]
    prior = take(base.hmm.prior)
    prior = prior / jnp.maximum(jnp.sum(prior, -1, keepdims=True), 1e-12)
    trans = base.hmm.trans[idx][:, :sr, :sr]
    trans = trans / jnp.maximum(jnp.sum(trans, -1, keepdims=True), 1e-12)
    kr = int(idx.shape[0])
    return H3M(omega=omega,
               hmm=HMM(prior=prior, trans=trans,
                       mean=take(base.hmm.mean),
                       cov=base.hmm.cov[idx][:, :sr]),
               state_mask=jnp.ones((kr, sr), bool))


def init_gmm(key: jax.Array, base: H3M, kr: int, sr: int,
             config: HEMConfig) -> H3M:
    """'gmm' (`initialize_hem_h3m_c.m:495-593`): pool ALL base emission
    Gaussians weighted by their long-run state probabilities (p A^50,
    `:533-545`), reduce them with mixture-hierarchies EM to the
    per-state emission mixture size M, and give EVERY (cluster, state)
    that same reduced emission; prior/transitions/omega random.  This is
    the initializer the reference's NaN-retry ladder switches to
    (`hem_h3m_c.m:304-320`).

    In this toolbox emissions are single Gaussians (M=1,
    `vhem_cluster.m:160`), so the reduced emission is the ONE pooled
    Gaussian.  Design delta: the reference MATLAB errors on full
    covariances (`:496-498`, a limitation of its GMM struct codepath);
    the math is covariance-type agnostic, so this implementation
    supports both."""
    from ..ops.gmm import mix_hier_em
    dtype = base.hmm.mean.dtype
    kb, sb_max = base.state_mask.shape
    d = base.hmm.mean.shape[-1]
    k1, k2, k3, k4 = jax.random.split(key, 4)

    # long-run state weights p A^50 per base HMM (`:538-541`)
    def powiter(p_a):
        p, a = p_a
        return jax.lax.fori_loop(0, 50, lambda _, q: q @ a, p)
    p_inf = jax.vmap(powiter)((base.hmm.prior, base.hmm.trans))  # [Kb,Sb]
    weights = (p_inf * base.state_mask).reshape(-1)
    weights = weights / jnp.sum(weights)

    red, _ = mix_hier_em(k1, base.hmm.mean.reshape(kb * sb_max, d),
                         base.hmm.cov.reshape(kb * sb_max, d, d),
                         weights, 1, nv=config.nv)
    prior = jax.random.uniform(k2, (kr, sr), dtype)
    prior = prior / jnp.sum(prior, -1, keepdims=True)
    trans = jax.random.uniform(k3, (kr, sr, sr), dtype)
    trans = trans / jnp.sum(trans, -1, keepdims=True)
    omega = jax.random.uniform(k4, (kr,), dtype)
    omega = omega / jnp.sum(omega)
    return H3M(omega=omega,
               hmm=HMM(prior=prior, trans=trans,
                       mean=jnp.broadcast_to(red.mean[0], (kr, sr, d)),
                       cov=jnp.broadcast_to(red.cov[0], (kr, sr, d, d))),
               state_mask=jnp.ones((kr, sr), bool))


def init_highp(key: jax.Array, base: H3M, kr: int, sr: int,
               config: HEMConfig) -> H3M:
    """'highp': the Kr highest-weight base HMMs as centers, uniform
    omega (`initialize_hem_h3m_c.m:259-269`)."""
    del key
    dtype = base.hmm.mean.dtype
    idx = jnp.argsort(-base.omega)[:kr]
    return _init_from_indices(base, idx, sr,
                              jnp.full((kr,), 1.0 / kr, dtype))


def init_trick(key: jax.Array, base: H3M, kr: int, sr: int,
               config: HEMConfig) -> H3M:
    """'trick': evenly-spaced base HMMs as centers, random omega
    (`initialize_hem_h3m_c.m:247-257`)."""
    dtype = base.hmm.mean.dtype
    kb = base.num_hmms
    idx = jnp.arange(kr) * max(kb // kr, 1)
    omega = jax.random.uniform(key, (kr,), dtype)
    return _init_from_indices(base, idx, sr, omega / jnp.sum(omega))


_INITIALIZERS = {"baseem": init_baseem, "base": init_base_subset,
                 "gmmNew": init_gmmNew, "gmmNew2": init_gmmNew2,
                 "gmm": init_gmm, "highp": init_highp,
                 "trick": init_trick}

# 'auto' tries these and keeps the best solution (`vhem_cluster.m:210-233`)
_AUTO_MODES = ("baseem", "gmmNew", "gmmNew2")


class VHEMResult(NamedTuple):
    """`h3m_to_hmms.m` output form: reduced models + memberships."""
    h3m: H3M
    ll: jnp.ndarray
    z: jnp.ndarray
    label: jnp.ndarray
    emit_counts: jnp.ndarray
    ll_elbo: jnp.ndarray     # [Kb, Kr] per-pair expected LL (L_elbo1)

    @property
    def groups(self):
        import numpy as np
        lab = np.asarray(self.label)
        return [list(np.where(lab == j)[0])
                for j in range(self.h3m.omega.shape[-1])]


def finalize(st: VHEMState) -> VHEMResult:
    return VHEMResult(h3m=st.h3m, ll=st.ll, z=st.z,
                      label=jnp.argmax(st.z, axis=-1),
                      emit_counts=st.emit_counts, ll_elbo=st.ll_elbo)


def fit_single_ks(key: jax.Array, base: H3M, kr: int, sr: int,
                  config: HEMConfig,
                  initmode: Optional[str] = None) -> VHEMState:
    """Vmapped random restarts (`hem_h3m_c.m:229-322`)."""
    mode = initmode or config.initmode
    if mode == "auto":
        mode = "baseem"
    init_fn = _INITIALIZERS[mode]

    def one_trial(trial_key):
        k_init, k_fix = jax.random.split(trial_key)
        return vhem_em(base, init_fn(k_init, base, kr, sr, config),
                       config, key=k_fix)

    keys = jax.random.split(key, config.trials)
    return jax.vmap(one_trial)(keys)


def select_best_trial(states: VHEMState) -> VHEMState:
    best = jnp.argmax(states.ll)
    return jax.tree.map(lambda a: a[best], states)


def cluster(key: jax.Array, base: H3M, kr: int, sr: int,
            config: HEMConfig = HEMConfig(),
            initmode: Optional[str] = None,
            allow_identity_shortcut: bool = True) -> VHEMResult:
    """VHEM clustering for one (K, S) (`vhem_cluster.m`).  When
    Kr == Kb the inputs are returned unchanged with an identity
    assignment and LogL = 0, exactly as `hem_h3m_c.m:19-25`.

    'auto' initmode tries {baseem, gmmNew, gmmNew2} and keeps the best
    solution by LL (`vhem_cluster.m:210-233`).

    NaN-retry ladder (`hem_h3m_c.m:304-320`): if every restart of a
    mode is unstable (ll = -inf), redo with fresh keys up to 5 times,
    then switch the initializer to 'gmm' for up to 5 more; a model
    that still failed is returned with ``given_up`` semantics
    (ll = -inf)."""
    import numpy as np
    if kr == base.num_hmms and allow_identity_shortcut:
        # identity shortcut (`hem_h3m_c.m:19-25`); callers that compare
        # LLs across a K grid must disable it — the placeholder
        # LogL=0 / ll_elbo=0 is not commensurable with trained cells
        eye = jnp.eye(kr, dtype=base.omega.dtype)
        return VHEMResult(h3m=base, ll=jnp.zeros((), base.omega.dtype),
                          z=eye, label=jnp.arange(kr),
                          emit_counts=jnp.zeros_like(base.hmm.prior),
                          ll_elbo=jnp.zeros((kr, kr), base.omega.dtype))
    mode = initmode or config.initmode
    modes = _AUTO_MODES if mode == "auto" else (mode,)

    def one_mode(mode, mode_key):
        st = select_best_trial(
            fit_single_ks(mode_key, base, kr, sr, config, mode))
        redo = 0
        while not np.isfinite(float(st.ll)) and redo < 10:
            redo += 1
            # the reference ladder switches to 'gmm' after 5 redos
            # (`hem_h3m_c.m:304-320`)
            use_mode = mode if redo <= 5 else "gmm"
            st = select_best_trial(fit_single_ks(
                jax.random.fold_in(mode_key, 1000 + redo), base, kr, sr,
                config, use_mode))
        return st

    best = None
    for mi, m in enumerate(modes):
        st = one_mode(m, jax.random.fold_in(key, mi) if len(modes) > 1
                      else key)
        if best is None or float(st.ll) > float(best.ll):
            best = st
    return finalize(best)


# ---------------------------------------------------------------------------
# 'split' mode: incremental K/S growing (hem_h3m_c.m:91-226)
# ---------------------------------------------------------------------------

def _split_gauss(mean, cov, f: float = 1.0):
    """Split one Gaussian along its principal axis
    (`hem_h3m_c.m:340-365`, generalized from the diag case to full
    covariances via the top eigenpair)."""
    import numpy as np
    vals, vecs = np.linalg.eigh(cov)
    vmax, u = vals[-1], vecs[:, -1]
    delta = np.sqrt(max(vmax, 0.0)) * u
    new_cov = cov - (1.0 - 1.0 / (2.0 * f) ** 2) * vmax * np.outer(u, u)
    return mean + f * delta, mean - f * delta, new_cov


def cluster_split(key: jax.Array, base: H3M, kr: int, sr: int,
                  config: HEMConfig = HEMConfig()) -> VHEMResult:
    """'split' initialization: learn (K=1,S=1) from the global emission
    average, then repeatedly split the heaviest cluster until K=kr, then
    the most-used state of every cluster until S=sr, re-running the EM
    after each split (`hem_h3m_c.m:91-226`)."""
    import numpy as np
    dtype = np.asarray(base.hmm.mean).dtype
    d = base.hmm.mean.shape[-1]
    maskf = np.asarray(base.state_mask, float)
    n_emit = maskf.sum()

    # global average emission (hem_h3m_c.m:113-121)
    mean0 = (np.asarray(base.hmm.mean) * maskf[..., None]).sum((0, 1)) / n_emit
    cov0 = (np.asarray(base.hmm.cov) * maskf[..., None, None]).sum((0, 1)) \
        / n_emit

    omega = np.ones((1,), dtype)
    prior = np.ones((1, 1), dtype)
    trans = np.ones((1, 1, 1), dtype)
    means = mean0[None, None, :].astype(dtype)
    covs = cov0[None, None, :, :].astype(dtype)

    def em(omega, prior, trans, means, covs):
        k, s = prior.shape
        init = H3M(omega=jnp.asarray(omega),
                   hmm=HMM(prior=jnp.asarray(prior),
                           trans=jnp.asarray(trans),
                           mean=jnp.asarray(means), cov=jnp.asarray(covs)),
                   state_mask=jnp.ones((k, s), bool))
        return vhem_em(base, init, config)

    st = em(omega, prior, trans, means, covs)

    # --- grow K by splitting the heaviest cluster (hem_h3m_c.m:145-171) ---
    for kk in range(2, kr + 1):
        omega = np.array(st.h3m.omega)
        prior = np.array(st.h3m.hmm.prior)
        trans = np.array(st.h3m.hmm.trans)
        means = np.array(st.h3m.hmm.mean)
        covs = np.array(st.h3m.hmm.cov)
        j = int(np.argmax(omega))
        m1, m2, c_new = _split_gauss(means[j, 0], covs[j, 0])
        omega = np.concatenate([omega, [omega[j] / 2]]); omega[j] /= 2
        prior = np.concatenate([prior, prior[j:j + 1]], axis=0)
        trans = np.concatenate([trans, trans[j:j + 1]], axis=0)
        means_new, covs_new = means[j:j + 1].copy(), covs[j:j + 1].copy()
        means[j, 0], covs[j, 0] = m1, c_new
        means_new[0, 0], covs_new[0, 0] = m2, c_new
        means = np.concatenate([means, means_new], axis=0)
        covs = np.concatenate([covs, covs_new], axis=0)
        st = em(omega, prior, trans, means, covs)

    # --- grow S by splitting the most-used state (hem_h3m_c.m:174-218) ---
    for ss in range(2, sr + 1):
        omega = np.array(st.h3m.omega)
        means = np.array(st.h3m.hmm.mean)
        covs = np.array(st.h3m.hmm.cov)
        counts = np.array(st.emit_counts)
        k = means.shape[0]
        means2 = np.zeros((k, ss, d), dtype)
        covs2 = np.tile(np.eye(d, dtype=dtype), (k, ss, 1, 1))
        for j in range(k):
            mi = int(np.argmax(counts[j]))
            m1, m2, c_new = _split_gauss(means[j, mi], covs[j, mi])
            means2[j, :ss - 1] = means[j]
            covs2[j, :ss - 1] = covs[j]
            means2[j, mi], covs2[j, mi] = m1, c_new
            means2[j, ss - 1], covs2[j, ss - 1] = m2, c_new
        # uniform prior/A after a state split (hem_h3m_c.m:210-213)
        prior = np.full((k, ss), 1.0 / ss, dtype)
        trans = np.full((k, ss, ss), 1.0 / ss, dtype)
        st = em(omega, prior, trans, means2, covs2)

    return finalize(st)


def compute_stats(res: VHEMResult, base: H3M, tau: int = 10,
                  smooth: float = 1.0):
    """Per-state MANOVA statistics (`vhem_cluster.m:239-266` +
    `hem_hmm_bwd_fwd.m:52-57` / `g3m_stats.m:307-315` second moments):
    normalized emission weights, effective ROI counts, AND the
    Z-weighted emission moments — per reduced state, the assignment-
    weighted mean (= the learned centre, `hem_mstep_component.m:173`)
    and the weighted second moment of the base MEANS
    (`new_Gmu2 / new_Gweight`, `hem_mstep_component.m:115-116,169-172`;
    note mu2 uses mu mu^T of the base centres, NOT mu mu^T + cov)."""
    import numpy as np
    counts = np.asarray(res.emit_counts)                    # [Kr, Sr]
    tot_base_rois = int(np.asarray(base.state_mask).sum())
    weights = counts / max(counts.sum(), np.finfo(np.float64).tiny)

    # Z-weighted moments: rerun the pair E-step at the final model to
    # recover sum_t_nu (the reference collects these during the final
    # M-step, hem_h3m_c_step.m:349-380)
    pair = e_step(base, res.h3m, tau, smooth)
    zw = res.z * base.omega[:, None]                        # [Kb, Kr]
    mean_b = base.hmm.mean
    mu2_b = mean_b[..., :, None] * mean_b[..., None, :]     # [Kb,Sb,D,D]
    w_sum = jnp.einsum("ij,ijrb->jr", zw, pair.sum_t_nu)
    mu2_sum = jnp.einsum("ij,ijrb,ibde->jrde", zw, pair.sum_t_nu, mu2_b)
    eps = tiny(w_sum.dtype)
    emit_mu2 = np.asarray(mu2_sum / jnp.maximum(w_sum, eps)[..., None, None])

    return {
        "tot_ind_rois": tot_base_rois,
        "emit_vcounts": counts,
        "weights": weights,
        "n_rois": tot_base_rois * weights,
        "emit_mu": np.asarray(res.h3m.hmm.mean),            # [Kr, Sr, D]
        "emit_mu2": emit_mu2,                               # [Kr,Sr,D,D]
    }
