"""Multi-chip SPMD execution of the VBHEM engine.

The reference parallelizes with single-machine `parfor` over restarts
(`vbhem_h3m_c.m:28`) and leaves the base-HMM axis serial inside the MEX
kernel.  Here the device mesh carries both axes (SURVEY.md section 5
"Distributed communication backend"):

  * ``trial`` axis — random restarts (and (K,S) grid cells) are
    embarrassingly parallel: sharded vmap, no communication until the
    final argmax.
  * ``base``  axis — the Kb base-HMM bank is sharded for pod-scale
    problems; per-iteration sufficient statistics (Nj, Nj_rho*, y_bar,
    S_plus_C) and the ELBO terms reduce with `psum` across devices (see
    the ``axis_name`` plumbing in :mod:`..models.vbhem`).  Every device
    reaches every other at the same rate (NVLink, all to all), so the
    mesh follows the algorithm alone.

Everything below builds a single jitted program with `shard_map`, so
XLA schedules the collectives (NCCL on the GPU); nothing here calls a
collective library directly.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..containers import H3M, H3MPosterior
from ..models import vbhem
from jax import shard_map


def make_mesh(n_trial: int, n_base: int, devices=None) -> Mesh:
    """Create a ('trial', 'base') mesh over the available devices."""
    import numpy as np
    devices = devices if devices is not None else jax.devices()
    if n_trial * n_base > len(devices):
        raise ValueError(f"mesh {n_trial}x{n_base} needs more than "
                         f"{len(devices)} devices")
    dev = np.asarray(devices[: n_trial * n_base]).reshape(n_trial, n_base)
    return Mesh(dev, axis_names=("trial", "base"))


def sharded_em_step(mesh: Mesh, base: H3M, posts: H3MPosterior,
                    hyps: vbhem.VBHEMHyps, nv: int, tau: int):
    """One VBHEM EM iteration, trials sharded over 'trial' and the base
    bank sharded over 'base'.  ``posts`` carries a leading trials axis.
    Returns (new posts, per-trial ELBO).  This is the jitted multi-chip
    training step."""
    kb_total = base.num_hmms

    def local_step(base_shard: H3M, post: H3MPosterior):
        tilde_n = (nv * kb_total) * base_shard.omega
        exps = vbhem.reduced_expectations(post)
        pair = vbhem.e_step(base_shard, post, exps, tau)
        hat_z, z_ni, nj = vbhem.soft_assignments(
            tilde_n, exps.log_omega, pair.ll_elbo, axis_name="base")
        ll = vbhem.elbo(post, exps, pair, hat_z, z_ni, nj, hyps, "base")
        stats = vbhem.aggregate_stats(base_shard, pair, z_ni, nj, "base")
        return vbhem.m_step(stats, hyps), ll

    def stepper(base_shard: H3M, posts_shard: H3MPosterior):
        return jax.vmap(local_step, in_axes=(None, 0))(base_shard, posts_shard)

    base_spec = jax.tree.map(lambda _: P("base"), base)
    posts_spec = jax.tree.map(lambda _: P("trial"), posts)
    fn = shard_map(stepper, mesh=mesh,
                   in_specs=(base_spec, posts_spec),
                   out_specs=(posts_spec, P("trial")))
    return jax.jit(fn)(base, posts)


def make_sharded_vbhem_em(mesh: Mesh, kb_total: int, posts_tmpl,
                          nv: int, tau: int, max_iter: int = 200,
                          min_diff: float = 1e-5,
                          covar_type: str = "full"):
    """Build the jitted sharded full-EM program ONCE; the returned
    callable (base, posts, hyps) -> VBHEMState can be invoked repeatedly
    without re-tracing (``posts_tmpl`` is any pytree with the posts
    structure, used only to construct the partition specs)."""

    def local_em(base_shard: H3M, post0: H3MPosterior,
                 hyps: vbhem.VBHEMHyps):
        return vbhem.vbhem_em(base_shard, post0, hyps, nv=nv, tau=tau,
                              max_iter=max_iter, min_diff=min_diff,
                              kb_total=kb_total, axis_name="base",
                              covar_type=covar_type)

    def run(base_shard: H3M, posts_shard: H3MPosterior,
            hyps: vbhem.VBHEMHyps):
        return jax.vmap(local_em, in_axes=(None, 0, None))(
            base_shard, posts_shard, hyps)

    def specs_like(tree, spec):
        return jax.tree.map(lambda _: spec, tree)

    posts_spec = specs_like(posts_tmpl, P("trial"))
    out_spec = vbhem.VBHEMState(
        post=specs_like(posts_tmpl, P("trial")),
        ll=P("trial"), last_ll=P("trial"), it=P("trial"),
        hat_z=P("trial", "base"), ll_elbo=P("trial", "base"),
        stats=vbhem.ClusterStats(
            nj=P("trial"), nj_rho1=P("trial"), nj_rho2rho=P("trial"),
            nj_rho=P("trial"), y_bar=P("trial"), s_plus_c=P("trial")),
        done=P("trial"))

    def call(base: H3M, posts: H3MPosterior, hyps: vbhem.VBHEMHyps):
        base_spec = jax.tree.map(lambda _: P("base"), base)
        hyps_spec = jax.tree.map(lambda _: P(), hyps)
        fn = shard_map(run, mesh=mesh,
                       in_specs=(base_spec, posts_spec, hyps_spec),
                       out_specs=out_spec)
        return fn(base, posts, hyps)

    return jax.jit(call)


def sharded_vbhem_em(mesh: Mesh, base: H3M, posts: H3MPosterior,
                     hyps: vbhem.VBHEMHyps, nv: int, tau: int,
                     max_iter: int = 200, min_diff: float = 1e-5,
                     covar_type: str = "full"):
    """The FULL VBHEM EM loop (``lax.while_loop`` to convergence) under
    shard_map: trials sharded over the 'trial' axis, the Kb base bank
    sharded over 'base'.  Per-iteration sufficient statistics and the
    ELBO reduce with psum over 'base'; the posterior stays replicated
    so the convergence predicate is uniform across devices.  ``posts``
    carries a leading trials axis (divisible by the 'trial' mesh axis).

    This is the large-bank training loop of BASELINE.json's north star
    ("10k+ input HMMs" with all-reduced sufficient statistics) — the
    reference has no analog; its base axis is serial inside one MEX
    call (`vbhem_h3m_c_step_fc.m:175`).

    Returns the vmapped :class:`..models.vbhem.VBHEMState` with a
    leading trials axis (hat_Z and ll_elbo laid out [trial, base-shard]).
    """
    return make_sharded_vbhem_em(mesh, base.num_hmms, posts, nv, tau,
                                 max_iter, min_diff, covar_type)(
        base, posts, hyps)


def replicate_to_mesh(mesh: Mesh, tree):
    """Place a pytree fully replicated on the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda a: jax.device_put(a, sharding), tree)


def sharded_fit_trials(mesh: Mesh, base: H3M, kr: int, sr: int,
                       config, hyps: vbhem.VBHEMHyps, key,
                       initmode: Optional[str] = None):
    """Full restart-trial fit with the trials axis sharded over the
    'trial' mesh axis and the base bank replicated — the vectorised form
    of the reference's `parfor it=1:trials` (`vbhem_h3m_c.m:28`):
    embarrassingly parallel, no communication until the final argmax.

    Requires config.trials to be divisible by the mesh's trial axis.
    Returns the vmapped VBHEMState with a leading trials axis, laid out
    across devices.
    """
    n_trial = mesh.shape["trial"]
    if config.trials % n_trial:
        raise ValueError(f"trials={config.trials} not divisible by the "
                         f"'trial' mesh axis ({n_trial})")
    mode = vbhem.resolve_initmode(initmode or config.initmode)
    init_fn = vbhem._INITIALIZERS[mode]

    def one_trial(trial_key):
        post0 = init_fn(trial_key, base, kr, sr, hyps, config.nv)
        return vbhem.vbhem_em(base, post0, hyps, nv=config.nv,
                              tau=config.tau, max_iter=config.max_iter,
                              min_diff=config.min_diff,
                              covar_type=config.covar_type)

    keys = jax.random.split(key, config.trials)
    key_sharding = NamedSharding(mesh, P("trial"))
    keys = jax.device_put(keys, key_sharding)
    fit = jax.jit(jax.vmap(one_trial),
                  in_shardings=(key_sharding,))
    return fit(keys)


def sharded_grid_sweep(mesh: Mesh, base: H3M, ks, ss, config,
                       hyps: vbhem.VBHEMHyps, key,
                       initmode: Optional[str] = None):
    """The single-program padded (K,S) sweep with the TRIALS axis laid
    out over the 'trial' mesh axis (cells replicated in the program's
    leading axis, trials device-parallel).  One compile for the entire
    model-selection grid across the whole mesh — the vectorised form of
    the reference's nested grid recursion + parfor
    (`vbhem_h3m_cluster.m:261-354`, `vbhem_h3m_c.m:28`).

    Requires config.trials divisible by the trial axis size.  Returns
    the same (states, cells, cmasks, smasks) as
    :func:`..models.vbhem.fit_grid_batched`.
    """
    import numpy as np
    n_trial = mesh.shape["trial"]
    if config.trials % n_trial:
        raise ValueError(f"trials={config.trials} not divisible by "
                         f"'trial' axis ({n_trial})")
    ks, ss = list(ks), list(ss)
    kmax, smax = max(ks), max(ss)
    cells = [(k, s) for k in ks for s in ss]
    cmasks = jnp.asarray(np.stack([np.arange(kmax) < k for k, _ in cells]))
    smasks = jnp.asarray(np.stack([np.arange(smax) < s for _, s in cells]))

    mode = vbhem.resolve_initmode(initmode or config.initmode)
    init_fn = vbhem._INITIALIZERS[mode]

    def one(cell_key, cmask, smask):
        post0 = init_fn(cell_key, base, kmax, smax, hyps, config.nv)
        return vbhem.vbhem_em_masked(base, post0, hyps, nv=config.nv,
                                     tau=config.tau, cmask=cmask,
                                     smask=smask,
                                     max_iter=config.max_iter,
                                     min_diff=config.min_diff,
                                     covar_type=config.covar_type)

    keys = jax.random.split(key, (len(cells), config.trials))
    key_sharding = NamedSharding(mesh, P(None, "trial"))
    keys = jax.device_put(keys, key_sharding)
    run = jax.jit(jax.vmap(jax.vmap(one, in_axes=(0, None, None)),
                           in_axes=(0, 0, 0)),
                  in_shardings=(key_sharding, NamedSharding(mesh, P()),
                                NamedSharding(mesh, P())))
    states = run(keys, cmasks, smasks)
    return states, cells, cmasks, smasks
