"""Empirical-Bayes hyperparameter optimization for both engines.

Parity map: `src/hmm/vbhmm_em_hyp.m` + `src/hmm/get_hypinfo.m` (VBEM),
`src/vbhem/vbhem_h3m_c_hyp.m` + `src/vbhem/vbhem_get_hypinfo.m` (VBHEM),
and the Rasmussen BFGS driver `src/util/minimize_new.m`.

Design deltas from the reference (SURVEY.md section 7.1):
  * gradients come from **autodiff of the ELBO at the EM fixed point**
    instead of the hand-derived formulas of `vbhmm_em_lb.m:261-396` /
    `vbhemh3m_lb.m:202-341`.  At convergence the ELBO is stationary in
    the variational factors, so the partial derivative w.r.t. the hyps
    with the posterior held fixed IS the total derivative — which is
    exactly what the reference's formulas compute.  (The analytic
    formulas are kept as a test oracle in tests/test_hyp.py.)
  * the box-constrained quasi-Newton outer loop is SciPy L-BFGS-B over
    the transformed parameters, with bounds mapped into transform space
    — replacing minimize_new + the clip-and-zero-gradient mechanism of
    `vbhmm_clip_hyps.m` (L-BFGS-B's projected gradient does the same
    zeroing at the box).
  * each objective eval is a full jitted EM run from the same initial
    posterior, like `vbhmm_em_hyp.m:166-200`.

Transforms (`get_hypinfo.m:18-80`): alpha0/epsilon0/eta0/beta0/lambda0
-> log;  v0 -> log(v0 - D + 1);  W0 -> log W0 (diag);  mu0/m0 ->
identity.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import HypBounds


class HypSpec(NamedTuple):
    name: str
    transform: Callable      # hyp -> opt space
    inverse: Callable        # opt space -> hyp
    size: int                # number of scalars
    lo: float                # bound in hyp space (lower)
    hi: float                # bound in hyp space (upper)


def _log_spec(name, lo, hi, size=1):
    return HypSpec(name, jnp.log, jnp.exp, size, lo, hi)


def _identity_spec(name, size):
    return HypSpec(name, lambda x: x, lambda x: x, size,
                   -np.inf, np.inf)


def vb_specs(dim: int, bounds: HypBounds, keys: Sequence[str]):
    """Learnable-hyp registry for the VBEM engine (get_hypinfo.m)."""
    d = dim
    table = {
        "alpha0": _log_spec("alpha0", bounds.alpha0_min, bounds.alpha0_max),
        "epsilon0": _log_spec("epsilon0", bounds.epsilon0_min,
                              bounds.epsilon0_max),
        "beta0": _log_spec("beta0", bounds.beta0_min, bounds.beta0_max),
        "v0": HypSpec("v0", lambda v: jnp.log(v - (d - 1.0)),
                      lambda t: jnp.exp(t) + (d - 1.0), 1,
                      bounds.v0_min + (d - 1.0), bounds.v0_max),
        "w0": _log_spec("w0", bounds.w0_min, bounds.w0_max, size=d),
        "mu0": _identity_spec("m0", d),  # config key mu0 -> VBHyps.m0
    }
    return [table[k] for k in keys]


def vbhem_specs(dim: int, bounds: HypBounds, keys: Sequence[str]):
    """Learnable-hyp registry for VBHEM (vbhem_get_hypinfo.m)."""
    d = dim
    table = {
        "alpha0": _log_spec("alpha0", bounds.alpha0_min, bounds.alpha0_max),
        "eta0": _log_spec("eta0", bounds.eta0_min, bounds.eta0_max),
        "epsilon0": _log_spec("epsilon0", bounds.epsilon0_min,
                              bounds.epsilon0_max),
        "lambda0": _log_spec("lambda0", bounds.beta0_min, bounds.beta0_max),
        "v0": HypSpec("v0", lambda v: jnp.log(v - (d - 1.0)),
                      lambda t: jnp.exp(t) + (d - 1.0), 1,
                      bounds.v0_min + (d - 1.0), bounds.v0_max),
        "w0": _log_spec("w0", bounds.w0_min, bounds.w0_max, size=d),
        "m0": _identity_spec("m0", d),
    }
    return [table[k] for k in keys]


def pack(hyps, specs) -> np.ndarray:
    """Hyps pytree -> flat optimization vector (transform space)."""
    parts = []
    for s in specs:
        val = jnp.atleast_1d(getattr(hyps, s.name))
        parts.append(np.asarray(s.transform(val), dtype=np.float64).ravel())
    return np.concatenate(parts)


def unpack(theta: jnp.ndarray, hyps_template, specs):
    """Flat vector -> hyps pytree (differentiable)."""
    out = hyps_template
    i = 0
    for s in specs:
        seg = theta[i: i + s.size]
        i += s.size
        val = s.inverse(seg)
        ref = getattr(hyps_template, s.name)
        if jnp.ndim(ref) == 0:
            val = val[0]
        out = out._replace(**{s.name: val.astype(ref.dtype)
                              if hasattr(val, "astype") else val})
    return out


def transform_bounds(specs) -> list:
    """Box bounds in transform space for L-BFGS-B."""
    bounds = []
    for s in specs:
        if np.isinf(s.lo) and np.isinf(s.hi):
            bounds.extend([(None, None)] * s.size)
        else:
            lo = float(s.transform(jnp.asarray(s.lo)))
            hi = float(s.transform(jnp.asarray(s.hi)))
            bounds.extend([(lo, hi)] * s.size)
    return bounds


def optimize_hyps(objective_and_grad, hyps0, specs,
                  max_evals: int = 100) -> Tuple[object, dict]:
    """Box-constrained quasi-Newton outer loop.

    ``objective_and_grad(hyps) -> (-elbo, grad_pytree)`` where the grad
    is w.r.t. the hyps pytree.  Returns (optimized hyps, info).
    """
    from scipy.optimize import minimize

    theta0 = pack(hyps0, specs)
    bounds = transform_bounds(specs)

    # differentiate the full composition theta -> -elbo (the transform
    # chain rule of `vbhmm_em_lb.m:387-396` falls out of autodiff)
    @jax.jit
    def val_and_grad(theta):
        def comp(th):
            hyps = unpack(th, hyps0, specs)
            return objective_and_grad(hyps)
        return jax.value_and_grad(comp)(theta)

    def scipy_fun(theta_np):
        v, g = val_and_grad(jnp.asarray(theta_np))
        v = float(v)
        g = np.asarray(g, dtype=np.float64)
        if not np.isfinite(v):
            # unstable model: L=-inf in the reference; tell the line
            # search to back off
            return 1e300, np.zeros_like(g)
        return v, g

    res = minimize(scipy_fun, theta0, jac=True, method="L-BFGS-B",
                   bounds=bounds, options={"maxfun": max_evals,
                                           "ftol": 1e-12, "gtol": 1e-8})
    hyps_opt = unpack(jnp.asarray(res.x), hyps0, specs)
    return hyps_opt, {"fun": float(res.fun), "nfev": int(res.nfev),
                      "converged": bool(res.success), "message": str(res.message)}


def bound_vectors(specs) -> Tuple[np.ndarray, np.ndarray]:
    """Box bounds in transform space as (lo, hi) vectors (identity-
    transformed hyps get +-inf)."""
    los, his = [], []
    for s in specs:
        if np.isinf(s.lo) and np.isinf(s.hi):
            los.extend([-np.inf] * s.size)
            his.extend([np.inf] * s.size)
        else:
            lo = float(s.transform(jnp.asarray(s.lo)))
            hi = float(s.transform(jnp.asarray(s.hi)))
            los.extend([lo] * s.size)
            his.extend([hi] * s.size)
    return np.asarray(los), np.asarray(his)


def lbfgs_box(fun, theta0: jnp.ndarray, lo: jnp.ndarray, hi: jnp.ndarray,
              max_steps: int = 50, gtol: float = 1e-8,
              ftol: float = 1e-12):
    """Box-constrained L-BFGS as one pure-JAX program (vmappable).

    This is the batched, in-graph counterpart of the reference's
    `minimize_new.m` + clip mechanism — a PROJECTED L-BFGS: the iterate
    is projected into the box after every update (so it is always
    feasible, like `vbhmm_clip_hyps.m` re-clipping each evaluation),
    line-search probes outside the box are evaluated at their projection
    (clip inside the objective), and gradient components pushing against
    an active bound are zeroed exactly like `vbhmm_em_lb.m:330-343`
    zeroes clipped gradients.  Non-finite objective values map to a
    large constant so the backtracking line search rejects those steps
    (the reference maps unstable EM runs to L = -inf and backs off).

    Returns (theta_opt clipped into the box, final value, iterations).
    """
    import optax
    import optax.tree_utils as otu

    dtype = theta0.dtype
    big = jnp.asarray(1e30, dtype)
    theta0 = jnp.clip(theta0, lo, hi)

    def safe_fun(theta):
        v = fun(jnp.clip(theta, lo, hi))
        return jnp.where(jnp.isfinite(v), v, big)

    # 10 backtracking probes: under vmap every lane executes the MAX
    # probe count of any lane per L-BFGS step, and each probe is a full
    # EM re-run — 20 probes doubled the worst-case cost of every step
    # for negligible final-ELBO difference.
    opt = optax.lbfgs(
        linesearch=optax.scale_by_backtracking_linesearch(
            max_backtracking_steps=10, store_grad=True))
    vag = optax.value_and_grad_from_state(safe_fun)

    def step(carry):
        theta, state, _, best_theta, best_v = carry
        v, g = vag(theta, state=state)
        ok = jnp.isfinite(v) & jnp.all(jnp.isfinite(g))
        v = jnp.where(ok, v, big)
        g = jnp.where(ok, g, jnp.zeros_like(g))
        # best-so-far: L-BFGS steps on this noisy objective (a full EM
        # re-run per eval, kinked at EM basin boundaries) are NOT
        # monotone; returning the final iterate was observed to end
        # thousands of nats WORSE than the start, silently corrupting
        # the (K,S) grid.  The reference's minimize_new is a monotone
        # line-search minimizer, so post >= pre always holds there —
        # tracking the best iterate restores that contract.
        better = v < best_v
        best_theta = jnp.where(better, theta, best_theta)
        best_v = jnp.where(better, v, best_v)
        # projected gradient: a component at an active bound that pushes
        # outward contributes nothing (minimizing, so descent moves along
        # -g: at lo, g>0 pushes below lo; at hi, g<0 pushes above hi)
        outward = ((theta <= lo) & (g > 0)) | ((theta >= hi) & (g < 0))
        g = jnp.where(outward, jnp.zeros_like(g), g)
        updates, state = opt.update(g, state, theta, value=v, grad=g,
                                    value_fn=safe_fun)
        theta_new = optax.apply_updates(theta, updates)
        theta_new = jnp.where(jnp.all(jnp.isfinite(theta_new)),
                              theta_new, theta)
        # keep the iterate feasible: at the bound (where clip still
        # passes half the gradient through) rather than outside it
        # (where the clip gradient is identically zero and the
        # coordinate could never re-enter the box)
        theta_new = jnp.clip(theta_new, lo, hi)
        return theta_new, state, v, best_theta, best_v

    def cont(carry):
        _, state, prev_v, _, _ = carry
        it = otu.tree_get(state, "count")
        g = otu.tree_get(state, "grad")
        v = otu.tree_get(state, "value")
        small_grad = otu.tree_norm(g) < gtol
        small_step = jnp.abs(v - prev_v) <= ftol * jnp.maximum(
            jnp.abs(v), 1.0)
        return (it == 0) | ((it < max_steps) & ~small_grad & ~small_step)

    state0 = opt.init(theta0)
    theta, state, _, best_theta, best_v = jax.lax.while_loop(
        cont, step, (theta0, state0, jnp.asarray(jnp.inf, dtype),
                     theta0, big))
    it = otu.tree_get(state, "count")
    # the final iterate's value is only known if evaluated; compare it
    # too so a last accepted improvement is not lost
    v_last = safe_fun(theta)
    better = v_last < best_v
    best_theta = jnp.where(better, jnp.clip(theta, lo, hi), best_theta)
    best_v = jnp.where(better, v_last, best_v)
    return jnp.clip(best_theta, lo, hi), best_v, it


def optimize_hyps_batched(neg_elbo_fn, hyps0, specs, batched_args,
                          max_steps: int = 50,
                          lane_chunk: int | None = None):
    """Vmapped empirical-Bayes hyp optimization: one L-BFGS per lane,
    ALL lanes in one compiled program — the vectorised form of the
    reference's parfor over unique restart solutions
    (`vbhem_h3m_c.m:96-160`, `vbhmm_learn.m:498-552`).

    ``neg_elbo_fn(hyps, *lane_args) -> scalar`` (already clipped hyps).
    ``batched_args`` is a tuple of pytrees sharing a leading lane axis.
    ``lane_chunk`` bounds the per-dispatch lane count (the small chunk
    program compiles once and is dispatched per chunk, which bounds
    program size and live memory as the grid sweep's chunking does;
    default 64 on the GPU, everything at once on CPU).
    Returns (hyps pytree with leading lane axis, final values, iters).
    """
    theta0 = jnp.asarray(pack(hyps0, specs))
    lo_np, hi_np = bound_vectors(specs)
    lo = jnp.asarray(lo_np, theta0.dtype)
    hi = jnp.asarray(hi_np, theta0.dtype)

    def one(*args):
        def f(theta):
            hyps = unpack(theta, hyps0, specs)
            return neg_elbo_fn(hyps, *args)
        return lbfgs_box(f, theta0, lo, hi, max_steps=max_steps)

    n_lanes = jax.tree.leaves(batched_args)[0].shape[0]
    # 64 lanes per dispatch on the GPU was inherited, not measured on the
    # card; choosing it by measurement is still open
    if lane_chunk is None and jax.default_backend() == "gpu":
        import os
        lane_chunk = int(os.environ.get("VBHEM_TPU_HYP_LANE_CHUNK", 64))
    if lane_chunk and lane_chunk < n_lanes:
        fn = jax.jit(jax.vmap(one))
        outs = []
        for a in range(0, n_lanes, lane_chunk):
            sl = slice(a, min(a + lane_chunk, n_lanes))
            size = sl.stop - sl.start
            # pad the tail chunk to the full chunk shape (one compile);
            # cyclic indexing handles tails SMALLER than the pad amount
            args_c = jax.tree.map(lambda x: x[sl], batched_args)
            if size < lane_chunk:
                wrap = jnp.arange(lane_chunk) % size
                args_c = jax.tree.map(lambda x: x[wrap], args_c)
            out = jax.block_until_ready(fn(*args_c))
            if size < lane_chunk:
                out = jax.tree.map(lambda x: x[:size], out)
            outs.append(out)
        theta_b, vals, iters = jax.tree.map(
            lambda *x: jnp.concatenate(x, axis=0), *outs)
    else:
        theta_b, vals, iters = jax.jit(jax.vmap(one))(*batched_args)
    hyps_b = jax.vmap(lambda th: unpack(th, hyps0, specs))(theta_b)
    return hyps_b, vals, iters


def degenerate_mask(ll_pre, ll_post) -> np.ndarray:
    """Lanes whose hyp-optimized solution is degenerate.

    The reference only WARNS when hyp optimization produces a
    degenerate model (test `abs(LL_old./LL)>10`, `vbhmm_learn.m:567-571`
    / `vbhem_h3m_c.m:175-180`) and keeps it anyway; with this
    framework's stronger optimizer such solutions (bound-saturated W0
    collapsing emission covariances, ELBO exploding to huge POSITIVE
    values) can hijack (K,S) model selection — observed at reference
    scale: a (K=5,S=2) cell returning ELBO +7.6e6 vs legitimate -743k.
    Lanes matching the degenerate signature therefore FALL BACK to
    their pre-optimization solution:
      |post| < |pre|/10  (the reference's own warning test),
      pre < 0 and post > |pre|  (sign-flipped blow-up), or
      post non-finite while pre is finite.
    The sign-flip test only applies to negative pre bounds: a genuinely
    positive ELBO (continuous densities with small variances) improving
    under hyp optimization is NOT degenerate.
    """
    pre = np.asarray(ll_pre, np.float64)
    post = np.asarray(ll_post, np.float64)
    finite_pre = np.isfinite(pre)
    bad = (~np.isfinite(post)) & finite_pre
    with np.errstate(invalid="ignore"):
        bad |= finite_pre & (np.abs(post) < np.abs(pre) / 10.0)
        bad |= finite_pre & (pre < 0) & (post > np.abs(pre))
    return bad


def fallback_degenerate_lanes(post_states, pre_states, ll_pre, ll_post):
    """Replace degenerate OR degraded hyp-optimized lanes (leading
    axis) with their pre-optimization states; returns
    (states, n_reverted, bad_mask).

    Beyond the degenerate signature (see :func:`degenerate_mask`), a
    lane whose post-optimization bound is WORSE than its
    pre-optimization bound is reverted: the reference's `minimize_new`
    is a monotone line-search minimizer started at hyps0, so post >= pre
    holds there by construction — a degraded lane here can only be an
    optimizer/EM-path artifact, and keeping it was observed to swing a
    (K,S) cell by thousands of nats (round-5 root-cause of the S=3
    over-selection).

    Callers that keep per-lane learned hyps MUST also revert those lanes
    to the pre-optimization hyps (see :func:`substitute_lanes`), so the
    stored/rescored hyps always match the state actually kept."""
    bad = degenerate_mask(ll_pre, ll_post)
    pre = np.asarray(ll_pre, np.float64)
    post = np.asarray(ll_post, np.float64)
    with np.errstate(invalid="ignore"):
        tol = np.maximum(1e-6 * np.abs(pre), 1e-3)
        bad |= np.isfinite(pre) & ~(post >= pre - tol)
    if not bad.any():
        return post_states, 0, bad
    badj = jnp.asarray(bad)

    def pick(new, old):
        b = badj.reshape(badj.shape + (1,) * (new.ndim - 1))
        return jnp.where(b, old, new)

    return jax.tree.map(pick, post_states, pre_states), int(bad.sum()), bad


def substitute_lanes(hyps_b, hyps0, bad: np.ndarray):
    """Substitute the unbatched pre-optimization hyps ``hyps0`` into the
    lane-batched ``hyps_b`` wherever ``bad`` is True, so reverted lanes
    carry the hyps their kept state was actually converged under."""
    if not np.asarray(bad).any():
        return hyps_b
    badj = jnp.asarray(np.asarray(bad))

    def pick(hb, h0):
        b = badj.reshape(badj.shape + (1,) * (hb.ndim - 1))
        return jnp.where(b, jnp.broadcast_to(h0, hb.shape), hb)

    return jax.tree.map(pick, hyps_b, hyps0)


def pad_lanes(idx: np.ndarray, bucket: int = 4) -> np.ndarray:
    """Pad a lane-index vector to the next multiple of ``bucket`` by
    repeating the first lane.  Duplicate lanes cost compute but keep the
    batched L-BFGS program's shape static across callers, so it compiles
    once per bucket size instead of once per unique-solution count."""
    idx = np.asarray(idx)
    rem = (-len(idx)) % bucket
    if rem:
        idx = np.concatenate([idx, np.full((rem,), idx[0], idx.dtype)])
    return idx


def unique_ll(lls: np.ndarray, min_diff: float = 1e-5) -> np.ndarray:
    """Indices of unique restart solutions by LL, gating which get
    expensive hyp optimization (`src/util/uniqueLL.m:41-80`): two LLs
    are duplicates when their relative difference is below
    2 * min_diff * 10."""
    lls = np.asarray(lls, dtype=np.float64)
    order = np.argsort(-lls)
    thresh = 2.0 * min_diff * 10.0
    kept: list = []
    for i in order:
        if not np.isfinite(lls[i]):
            continue
        dup = any(abs(lls[i] - lls[j])
                  / max(abs(lls[j]), 1e-300) < thresh for j in kept)
        if not dup:
            kept.append(int(i))
    return np.asarray(kept, dtype=np.int64)


def optimize_hyps_joint(neg_elbo_fn, hyps0, specs, batched_args,
                        max_evals: int = 60,
                        lane_chunk: Optional[int] = None):
    """Host-outer-loop batched hyp optimization: ONE scipy L-BFGS-B over
    the concatenation of every lane's transformed hyp vector, with the
    objective = sum of per-lane -ELBOs evaluated by ONE vmapped jitted
    program per iteration.

    The objective is separable, so its stationary points are exactly the
    per-lane optima of :func:`optimize_hyps_batched`; only the
    optimization TRAJECTORY differs (shared line-search step, joint
    curvature estimate).  It compiles only the vmapped EM objective, not
    optimizer while_loops wrapped around the masked-EM while_loop; on
    the GPU it is the path :func:`..models.vbhem.optimize_hyps_grid_batched`
    takes (which of the two drivers is faster on the card has not been
    measured).  Returns (hyps pytree with leading lane axis, values,
    nit).
    """
    from scipy.optimize import minimize

    theta0 = np.asarray(pack(hyps0, specs))
    p = theta0.size
    n_lanes = jax.tree.leaves(batched_args)[0].shape[0]
    lo, hi = bound_vectors(specs)
    bounds = [(None if not np.isfinite(l) else l,
               None if not np.isfinite(h) else h)
              for l, h in zip(lo, hi)] * n_lanes

    def per_lane(theta, *args):
        hyps = unpack(theta, hyps0, specs)
        v = neg_elbo_fn(hyps, *args)
        return jnp.where(jnp.isfinite(v), v, jnp.asarray(1e10, v.dtype))

    dtype = jax.tree.leaves(hyps0)[0].dtype

    # Bound the per-dispatch lane count, which bounds the size of the
    # folded while_loop-EM program and its live memory (the grid sweep
    # chunks its lanes for the same reason; 64 on the GPU is not
    # measured on the card).  The objective is a sum over lanes, so
    # chunked evaluation with zero weights on cyclic tail padding is
    # exact.
    import os as _os
    if lane_chunk is None:
        lane_chunk = n_lanes
        if jax.default_backend() == "gpu":
            lane_chunk = int(_os.environ.get("VBHEM_TPU_HYP_LANE_CHUNK",
                                             64))
    lane_chunk = min(lane_chunk, n_lanes)

    @jax.jit
    def val_and_grad_chunk(thetas_c, w_c, *args_c):
        def total(th):
            vals = jax.vmap(per_lane)(th, *args_c)
            return jnp.sum(w_c * vals)
        return jax.value_and_grad(total)(thetas_c)

    def eval_chunks(thetas):
        v_tot = 0.0
        g_out = np.zeros((n_lanes, p), np.float64)
        for a in range(0, n_lanes, lane_chunk):
            sl = slice(a, min(a + lane_chunk, n_lanes))
            size = sl.stop - sl.start
            idx = jnp.arange(lane_chunk) % size + a  # cyclic tail pad
            w = jnp.asarray(np.arange(lane_chunk) < size, dtype)
            args_c = jax.tree.map(lambda x: x[idx], batched_args)
            v, g = val_and_grad_chunk(thetas[idx], w, *args_c)
            v_tot += float(v)
            g_out[sl] = np.asarray(g, np.float64)[:size]
        return v_tot, g_out

    def fun(x):
        v, g = eval_chunks(jnp.asarray(x.reshape(n_lanes, p), dtype))
        if not np.isfinite(v):
            return 1e300, np.zeros_like(g.ravel())
        return v, g.ravel()

    x0 = np.tile(theta0, n_lanes)
    it_count = [0]

    def _progress(_):
        it_count[0] += 1
        if _os.environ.get("VBHEM_TPU_HYP_VERBOSE", "1") != "0":
            print(f"    joint hyp L-BFGS-B iter {it_count[0]} "
                  f"({n_lanes} lanes, chunk {lane_chunk})", flush=True)

    res = minimize(fun, x0, jac=True, method="L-BFGS-B", bounds=bounds,
                   callback=_progress,
                   options={"maxfun": max_evals, "ftol": 1e-12,
                            "gtol": 1e-8})
    thetas = jnp.asarray(res.x.reshape(n_lanes, p), dtype)
    hyps_b = jax.vmap(lambda th: unpack(th, hyps0, specs))(thetas)
    vals_np = np.empty((n_lanes,), np.float64)
    fn_vals = jax.jit(jax.vmap(per_lane))
    for a in range(0, n_lanes, lane_chunk):
        sl = slice(a, min(a + lane_chunk, n_lanes))
        size = sl.stop - sl.start
        idx = jnp.arange(lane_chunk) % size + a
        args_c = jax.tree.map(lambda x: x[idx], batched_args)
        vals_np[sl] = np.asarray(fn_vals(thetas[idx], *args_c))[:size]
    return hyps_b, jnp.asarray(vals_np, dtype), int(res.nit)
