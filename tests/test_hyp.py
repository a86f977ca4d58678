"""Hyperparameter-learning tests.

Oracle: the reference's hand-derived analytic gradients
(`vbhmm_em_lb.m:261-324`) — autodiff of the ELBO at the EM fixed point
must reproduce them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import digamma

from vbhem_tpu import hyp as hypmod
from vbhem_tpu.config import VBConfig
from vbhem_tpu.containers import SeqBatch
from vbhem_tpu.models import hmm_tools, vbhmm
from tests.test_vbhmm import make_gt_hmm


@pytest.fixture(scope="module")
def setup():
    hmm = make_gt_hmm([[0.6, 0.4], [0.4, 0.6]])
    _, x = hmm_tools.sample(jax.random.key(11), hmm, t=40, n=20)
    batch = SeqBatch(x=x, lengths=jnp.full((20,), 40, jnp.int32))
    cfg = VBConfig(mu0=(1.5, 1.5), w0=1.0, numtrials=3)
    hyps = vbhmm.VBHyps.from_config(cfg, 2, jnp.float64)
    post0 = vbhmm.random_init(jax.random.key(0), batch, 2, hyps)
    st = vbhmm.vbem_em(batch, post0, hyps, max_iter=100, min_diff=1e-7)
    return batch, cfg, hyps, st


def reference_gradients(batch, st, hyps):
    """Hand-derived formulas from vbhmm_em_lb.m:261-324 (as oracle)."""
    post = st.post
    fb = vbhmm.e_step(batch, post)
    stats = vbhmm.suff_stats(batch, fb)
    k = post.num_states
    d = batch.x.shape[-1]
    log_pi = np.asarray(digamma(np.asarray(post.alpha))
                        - digamma(np.asarray(post.alpha).sum()))
    eps = np.asarray(post.epsilon)
    log_a = digamma(eps) - digamma(eps.sum(-1, keepdims=True))
    v = np.asarray(post.niw.v)
    w = np.asarray(post.niw.w)
    m = np.asarray(post.niw.m)
    beta = np.asarray(post.niw.beta)
    a0 = float(hyps.alpha0)
    e0 = float(hyps.epsilon0)
    b0 = float(hyps.beta0)
    v0 = float(hyps.v0)
    w0 = np.asarray(hyps.w0)
    m0 = np.asarray(hyps.m0)

    g = {}
    g["alpha0"] = k * digamma(k * a0) - k * digamma(a0) + log_pi.sum()
    g["epsilon0"] = k * (k * digamma(k * e0) - k * digamma(e0)) + log_a.sum()
    loglam = np.array([
        digamma(0.5 * (v[i] + 1 - np.arange(1, d + 1))).sum()
        + d * np.log(2) + np.log(np.linalg.det(w[i])) for i in range(k)])
    logdet_w0inv = np.sum(np.log(1.0 / w0))
    g["v0"] = k * (0.5 * logdet_w0inv - 0.5 * d * np.log(2)
                   - 0.5 * digamma(0.5 * (v0 + 1 - np.arange(1, d + 1))).sum()) \
        + 0.5 * loglam.sum()
    mwm = np.array([ (m[i] - m0) @ w[i] @ (m[i] - m0) for i in range(k)])
    g["beta0"] = 0.5 * np.sum(d / b0 - d / beta - v * mwm)
    # W0 (diag): d/dW0 = K*(-0.5 v0 W0inv) - 0.5 sum_k v_k * (-(W0inv^2) W_kdd)
    w0inv = 1.0 / w0
    dtr = np.stack([-(w0inv ** 2) * np.diagonal(w[i]) for i in range(k)])
    g["w0"] = -0.5 * v0 * w0inv * k - 0.5 * (v[:, None] * dtr).sum(0)
    g["m0"] = np.sum([b0 * v[i] * (w[i] @ (m[i] - m0)) for i in range(k)],
                     axis=0)
    return g


def test_autodiff_matches_reference_gradients(setup):
    batch, cfg, hyps, st = setup

    def neg_elbo(h):
        post = jax.lax.stop_gradient(st.post)
        fb = vbhmm.e_step(batch, post)
        stats = vbhmm.suff_stats(batch, fb)
        return -vbhmm.elbo(batch, post, fb, stats, h)

    grads = jax.grad(neg_elbo)(hyps)
    ref = reference_gradients(batch, st, hyps)
    np.testing.assert_allclose(-float(grads.alpha0), ref["alpha0"], rtol=1e-6)
    np.testing.assert_allclose(-float(grads.epsilon0), ref["epsilon0"], rtol=1e-6)
    np.testing.assert_allclose(-float(grads.v0), ref["v0"], rtol=1e-6)
    np.testing.assert_allclose(-float(grads.beta0), ref["beta0"], rtol=1e-6)
    np.testing.assert_allclose(-np.asarray(grads.w0), ref["w0"], rtol=1e-6)
    np.testing.assert_allclose(-np.asarray(grads.m0), ref["m0"], rtol=1e-6)


def test_hyp_optimization_improves_elbo(setup):
    batch, cfg, hyps, st = setup
    ll_before = float(st.ll)
    hyps_opt, st_opt, info = vbhmm.optimize_solution_hyps(
        batch, st.post, hyps, cfg)
    assert float(st_opt.ll) >= ll_before - 1e-6, (ll_before, float(st_opt.ll))
    assert float(st_opt.ll) > ll_before + 1.0, "hyp-opt should help clearly"
    # optimized hyps stay inside bounds
    assert cfg.bounds.alpha0_min <= float(hyps_opt.alpha0) <= cfg.bounds.alpha0_max
    assert float(hyps_opt.v0) > batch.x.shape[-1] - 1


def test_unique_ll():
    lls = np.array([-100.0, -100.000001, -90.0, -np.inf, -90.00001])
    idx = hypmod.unique_ll(lls, min_diff=1e-5)
    assert list(idx)[:2] == [2] or -90.0 in lls[idx]
    assert len(idx) == 2  # -90 pair dedups, -100 pair dedups, -inf dropped


def test_learn_with_hyps_end_to_end(setup):
    batch, cfg, hyps, st = setup
    import dataclasses
    cfg2 = dataclasses.replace(cfg, learn_hyps=True, numtrials=2)
    res, info = vbhmm.learn(jax.random.key(5), batch, 2, cfg2)
    assert "learned_hyps" in info
    means = np.asarray(res.model.mean)
    order = np.argsort(means[:, 0])
    np.testing.assert_allclose(means[order], [[0, 0], [3, 3]], atol=0.4)


def test_batched_lbfgs_matches_scipy_oracle(setup):
    """The vmapped optax L-BFGS hyp path must reach the same ELBO as
    the scipy L-BFGS-B oracle on the same solution (same init posterior,
    same objective)."""
    batch, cfg, hyps, st = setup
    _, st_scipy, _ = vbhmm.optimize_solution_hyps(batch, st.post, hyps, cfg)
    posts = jax.tree.map(lambda a: a[None], st.post)
    hyps_b, sts = vbhmm.optimize_solution_hyps_batched(batch, posts, hyps,
                                                       cfg)
    ll_scipy = float(st_scipy.ll)
    ll_batched = float(sts.ll[0])
    # both must improve on the un-optimized solution ...
    assert ll_batched >= float(st.ll) - 1e-9
    # ... and agree to 0.1% relative (different line searches)
    assert ll_batched >= ll_scipy - 1e-3 * abs(ll_scipy), \
        (ll_batched, ll_scipy)


def test_lbfgs_box_respects_bounds():
    lo = jnp.asarray([-1.0, 0.5])
    hi = jnp.asarray([2.0, 3.0])

    def f(th):
        return (th[0] + 5.0) ** 2 + (th[1] - 1.0) ** 2

    th, v, it = hypmod.lbfgs_box(f, jnp.zeros(2), lo, hi, max_steps=50)
    np.testing.assert_allclose(np.asarray(th), [-1.0, 1.0], atol=1e-6)


def test_optimize_hyps_joint_matches_batched():
    """The host-outer-loop joint optimizer (the GPU path) must reach the
    same separable optima as the in-graph vmapped L-BFGS on a smooth
    per-lane objective."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from vbhem_tpu import hyp as hypmod
    from vbhem_tpu.config import HypBounds
    from vbhem_tpu.models.vbhmm import VBHyps

    specs = hypmod.vb_specs(2, HypBounds(), ("alpha0", "beta0"))
    hyps0 = VBHyps(alpha0=jnp.asarray(1.0), epsilon0=jnp.asarray(0.1),
                   beta0=jnp.asarray(1.0), v0=jnp.asarray(5.0),
                   m0=jnp.zeros((2,)), w0=jnp.ones((2,)))
    targets = jnp.asarray([[0.5, 2.0], [3.0, 0.25], [1.5, 1.5]])

    def neg_elbo(h, t):
        # smooth separable objective with per-lane optimum at t
        return (jnp.log(h.alpha0 / t[0]) ** 2
                + jnp.log(h.beta0 / t[1]) ** 2)

    hb, _, _ = hypmod.optimize_hyps_batched(neg_elbo, hyps0, specs,
                                            (targets,), max_steps=50)
    hj, _, _ = hypmod.optimize_hyps_joint(neg_elbo, hyps0, specs,
                                          (targets,), max_evals=200)
    np.testing.assert_allclose(np.asarray(hj.alpha0),
                               np.asarray(targets[:, 0]), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(hj.beta0),
                               np.asarray(targets[:, 1]), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(hj.alpha0),
                               np.asarray(hb.alpha0), rtol=1e-3)


def test_optimize_hyps_batched_tail_chunk_smaller_than_pad():
    """Regression: a tail lane-chunk SMALLER than its pad amount used to
    be emptied by the unpad slice (200 lanes at chunk 64 returned 192
    results and crashed the VBEM bank hyp stage on the accelerator)."""
    import jax.numpy as jnp
    import numpy as np
    from vbhem_tpu import hyp as hypmod
    from vbhem_tpu.config import HypBounds
    from vbhem_tpu.models.vbhmm import VBHyps

    specs = hypmod.vb_specs(2, HypBounds(), ("alpha0",))
    hyps0 = VBHyps(alpha0=jnp.asarray(1.0), epsilon0=jnp.asarray(0.1),
                   beta0=jnp.asarray(1.0), v0=jnp.asarray(5.0),
                   m0=jnp.zeros((2,)), w0=jnp.ones((2,)))
    # 10 lanes, chunk 8 -> tail chunk of 2 with pad 6 > 2
    targets = jnp.asarray(np.linspace(0.5, 3.0, 10))

    def neg_elbo(h, t):
        return jnp.log(h.alpha0 / t) ** 2

    hb, vals, _ = hypmod.optimize_hyps_batched(
        neg_elbo, hyps0, specs, (targets,), max_steps=50, lane_chunk=8)
    assert np.asarray(hb.alpha0).shape == (10,)
    np.testing.assert_allclose(np.asarray(hb.alpha0),
                               np.asarray(targets), rtol=1e-4)


def test_optimize_hyps_joint_chunked_matches_unchunked():
    """Chunked joint evaluation (zero-weight cyclic tail padding) must
    be exact: same optimum as the single-program evaluation, including
    a tail chunk smaller than its pad."""
    import jax.numpy as jnp
    import numpy as np
    from vbhem_tpu import hyp as hypmod
    from vbhem_tpu.config import HypBounds
    from vbhem_tpu.models.vbhmm import VBHyps

    specs = hypmod.vb_specs(2, HypBounds(), ("alpha0",))
    hyps0 = VBHyps(alpha0=jnp.asarray(1.0), epsilon0=jnp.asarray(0.1),
                   beta0=jnp.asarray(1.0), v0=jnp.asarray(5.0),
                   m0=jnp.zeros((2,)), w0=jnp.ones((2,)))
    targets = jnp.asarray([0.5, 2.0, 3.0, 0.8, 1.7])  # 5 lanes, chunk 2

    def neg_elbo(h, t):
        return jnp.log(h.alpha0 / t) ** 2

    h_full, v_full, _ = hypmod.optimize_hyps_joint(
        neg_elbo, hyps0, specs, (targets,), max_evals=200)
    h_chunk, v_chunk, _ = hypmod.optimize_hyps_joint(
        neg_elbo, hyps0, specs, (targets,), max_evals=200, lane_chunk=2)
    np.testing.assert_allclose(np.asarray(h_chunk.alpha0),
                               np.asarray(targets), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(h_chunk.alpha0),
                               np.asarray(h_full.alpha0), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(v_chunk), np.asarray(v_full),
                               atol=1e-10)


def test_degenerate_hyp_solutions_fall_back():
    """Degenerate hyp-optimized lanes (ELBO blown up positive, shrunk
    by >10x, or NaN) must revert to their pre-optimization solutions;
    legitimate improvements must be kept."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from vbhem_tpu import hyp as hypmod

    pre_ll = np.asarray([-743e3, -743e3, -743e3, -743e3])
    post_ll = np.asarray([-741e3,      # legit improvement -> keep
                          +7.6e6,      # positive blow-up -> revert
                          -30.4,       # |post| << |pre| -> revert
                          np.nan])     # NaN -> revert
    mask = hypmod.degenerate_mask(pre_ll, post_ll)
    np.testing.assert_array_equal(mask, [False, True, True, True])

    # a legitimately-positive bound improving is NOT degenerate (the
    # sign-flip test only applies when pre < 0)
    np.testing.assert_array_equal(
        hypmod.degenerate_mask(np.asarray([100.0]), np.asarray([150.0])),
        [False])

    # a lane whose post-opt bound is WORSE than pre must also revert
    # (minimize_new is monotone from hyps0, so post >= pre in the
    # reference by construction)
    out_w, n_w, bad_w = hypmod.fallback_degenerate_lanes(
        {"ll": jnp.asarray([-741e3, -698419.0])},
        {"ll": jnp.asarray([-743e3, -695169.0])},
        np.asarray([-743e3, -695169.0]),
        np.asarray([-741e3, -698419.0]))
    np.testing.assert_array_equal(bad_w, [False, True])
    np.testing.assert_allclose(np.asarray(out_w["ll"]),
                               [-741e3, -695169.0])

    pre = {"ll": jnp.asarray(pre_ll), "x": jnp.arange(8.).reshape(4, 2)}
    post = {"ll": jnp.asarray(post_ll), "x": -jnp.ones((4, 2))}
    out, n_bad, bad = hypmod.fallback_degenerate_lanes(
        post, pre, pre["ll"], post["ll"])
    assert n_bad == 3
    np.testing.assert_array_equal(bad, [False, True, True, True])
    np.testing.assert_allclose(np.asarray(out["ll"]),
                               [-741e3, -743e3, -743e3, -743e3])
    np.testing.assert_allclose(np.asarray(out["x"])[0], [-1.0, -1.0])
    np.testing.assert_allclose(np.asarray(out["x"])[1], [2.0, 3.0])

    # reverted lanes must also revert their learned hyps to hyps0 so the
    # stored/rescored hyps match the state actually kept (ADVICE r4)
    hyps_b = {"a": jnp.asarray([10., 20., 30., 40.]),
              "w": jnp.ones((4, 2)) * 5.0}
    hyps0 = {"a": jnp.asarray(1.0), "w": jnp.asarray([2.0, 3.0])}
    sub = hypmod.substitute_lanes(hyps_b, hyps0, bad)
    np.testing.assert_allclose(np.asarray(sub["a"]), [10., 1., 1., 1.])
    np.testing.assert_allclose(np.asarray(sub["w"])[0], [5., 5.])
    np.testing.assert_allclose(np.asarray(sub["w"])[2], [2., 3.])
