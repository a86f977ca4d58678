"""Forward-backward correctness against a brute-force path-enumeration
oracle.

The reference verified its MEX kernel against the MATLAB mirror
(`vbhmm_fb.m:179-192`, disabled `if 0` blocks); here the oracle is
exact enumeration of all K^T hidden paths, which independently pins
down gamma, xi_sum, and phi_norm for the *sub-normalized* scores used
by the VBHMM E-step (exp of digamma expectations)."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vbhem_tpu.containers import NIW, SeqBatch
from vbhem_tpu.ops.fb import expected_log_gauss, forward_backward


def brute_force_fb(log_pz1, log_trans, log_rho_seq):
    """Exact posterior over hidden paths for ONE sequence.

    log_rho_seq: [T, K].  Path weight = pz1[z1] * prod A[z_{t-1}, z_t]
    * prod rho[t, z_t]; all scores may be sub-normalized.
    """
    t_len, k = log_rho_seq.shape
    logw = {}
    for path in itertools.product(range(k), repeat=t_len):
        lw = log_pz1[path[0]] + log_rho_seq[0, path[0]]
        for t in range(1, t_len):
            lw += log_trans[path[t - 1], path[t]] + log_rho_seq[t, path[t]]
        logw[path] = lw
    lws = np.array(list(logw.values()))
    mx = lws.max()
    z = np.exp(lws - mx).sum()
    phi_norm = mx + np.log(z)
    gamma = np.zeros((t_len, k))
    xi = np.zeros((k, k))
    for path, lw in logw.items():
        p = np.exp(lw - phi_norm)
        for t, s in enumerate(path):
            gamma[t, s] += p
        for t in range(1, t_len):
            xi[path[t - 1], path[t]] += p
    return gamma, xi, phi_norm


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    k, d = 3, 2
    # sub-normalized scores like exp(digamma expectations)
    log_pz1 = np.log(rng.dirichlet(np.ones(k)) * 0.8)
    log_trans = np.log(rng.dirichlet(np.ones(k), size=k) * 0.9)
    lengths = np.array([5, 3, 4, 1], dtype=np.int32)
    t_max = int(lengths.max())
    log_rho = rng.normal(size=(len(lengths), t_max, k))
    return log_pz1, log_trans, log_rho, lengths


def test_fb_matches_bruteforce(setup):
    log_pz1, log_trans, log_rho, lengths = setup
    n, t_max, k = log_rho.shape
    mask = np.arange(t_max)[None, :] < lengths[:, None]
    out = forward_backward(jnp.asarray(log_pz1), jnp.asarray(log_trans),
                           jnp.asarray(log_rho), jnp.asarray(mask))
    for i in range(n):
        g_ref, xi_ref, pn_ref = brute_force_fb(
            log_pz1, log_trans, log_rho[i, : lengths[i]])
        np.testing.assert_allclose(np.asarray(out.gamma)[i, : lengths[i]],
                                   g_ref, atol=1e-10)
        np.testing.assert_allclose(np.asarray(out.xi_sum)[i], xi_ref,
                                   atol=1e-10)
        np.testing.assert_allclose(float(out.phi_norm[i]), pn_ref, atol=1e-10)


def test_fb_padding_is_inert(setup):
    """Extra padding must not change any output."""
    log_pz1, log_trans, log_rho, lengths = setup
    n, t_max, k = log_rho.shape
    mask = np.arange(t_max)[None, :] < lengths[:, None]
    out1 = forward_backward(jnp.asarray(log_pz1), jnp.asarray(log_trans),
                            jnp.asarray(log_rho), jnp.asarray(mask))
    pad = np.concatenate([log_rho, np.full((n, 3, k), 7.7)], axis=1)
    mask2 = np.arange(t_max + 3)[None, :] < lengths[:, None]
    out2 = forward_backward(jnp.asarray(log_pz1), jnp.asarray(log_trans),
                            jnp.asarray(pad), jnp.asarray(mask2))
    np.testing.assert_allclose(np.asarray(out2.gamma)[:, :t_max],
                               np.asarray(out1.gamma), atol=1e-12)
    np.testing.assert_allclose(np.asarray(out2.xi_sum),
                               np.asarray(out1.xi_sum), atol=1e-12)
    np.testing.assert_allclose(np.asarray(out2.phi_norm),
                               np.asarray(out1.phi_norm), atol=1e-12)
    assert np.all(np.asarray(out2.gamma)[:, t_max:] == 0)


def test_expected_log_gauss_matches_direct():
    """logrho = 0.5 ElogdetLambda - 0.5 (D/beta + v (x-m)'W(x-m)) - D/2 log 2pi."""
    rng = np.random.default_rng(1)
    n, t, k, d = 2, 4, 3, 2
    x = rng.normal(size=(n, t, d))
    m = rng.normal(size=(k, d))
    a = rng.normal(size=(k, d, d))
    w = np.einsum("kde,kfe->kdf", a, a) + 2 * np.eye(d)
    beta = np.abs(rng.normal(size=k)) + 1
    v = np.abs(rng.normal(size=k)) + d + 1
    niw = NIW(beta=jnp.asarray(beta), v=jnp.asarray(v),
              m=jnp.asarray(m), w=jnp.asarray(w))
    got = np.asarray(expected_log_gauss(jnp.asarray(x), niw))

    from scipy.special import digamma
    for i in range(n):
        for tt in range(t):
            for kk in range(k):
                loglam = (digamma(0.5 * (v[kk] + 1 - np.arange(1, d + 1))).sum()
                          + d * np.log(2) + np.log(np.linalg.det(w[kk])))
                diff = x[i, tt] - m[kk]
                delta = d / beta[kk] + v[kk] * diff @ w[kk] @ diff
                want = 0.5 * loglam - 0.5 * delta - 0.5 * d * np.log(2 * np.pi)
                np.testing.assert_allclose(got[i, tt, kk], want, rtol=1e-8)


def _fb_problem(rng, n, t_max, k):
    lengths = rng.integers(min(2, t_max), t_max + 1, size=n)
    lengths[0] = t_max
    mask = np.arange(t_max)[None, :] < lengths[:, None]
    log_rho = rng.normal(size=(n, t_max, k)) * 2.0
    log_pz1 = np.log(rng.dirichlet(np.ones(k))) - 0.1
    log_trans = np.log(rng.dirichlet(np.ones(k), size=k)) - 0.1
    return (jnp.asarray(log_pz1, jnp.float32),
            jnp.asarray(log_trans, jnp.float32),
            jnp.asarray(log_rho, jnp.float32), jnp.asarray(mask))


def test_fb_pallas_matches_xla():
    """Pallas kernel (Triton route, interpret mode on CPU) vs the XLA
    scan path — the MEX-vs-MATLAB dual-path discipline
    (`vbhmm_fb.m:179-192`)."""
    from vbhem_tpu.ops.fb_pallas import forward_backward_pallas
    rng = np.random.default_rng(3)
    n, t_max, k = 7, 9, 3
    lengths = rng.integers(2, t_max + 1, size=n)
    lengths[0] = t_max
    mask = np.arange(t_max)[None, :] < lengths[:, None]
    log_rho = rng.normal(size=(n, t_max, k)) * 2.0
    log_pz1 = np.log(rng.dirichlet(np.ones(k))) - 0.1
    log_trans = np.log(rng.dirichlet(np.ones(k), size=k)) - 0.1

    args = (jnp.asarray(log_pz1, jnp.float32),
            jnp.asarray(log_trans, jnp.float32),
            jnp.asarray(log_rho, jnp.float32), jnp.asarray(mask))
    want = forward_backward(*args)
    got = forward_backward_pallas(*args, interpret=True)
    np.testing.assert_allclose(np.asarray(got.gamma),
                               np.asarray(want.gamma), atol=2e-6)
    np.testing.assert_allclose(np.asarray(got.xi_sum),
                               np.asarray(want.xi_sum), atol=2e-5)
    np.testing.assert_allclose(np.asarray(got.phi_norm),
                               np.asarray(want.phi_norm), rtol=2e-6)


@pytest.mark.parametrize("n,t_max,k", [
    (130, 5, 2),      # more sequences than one block (padded lanes)
    (3, 1, 2),        # a single time step: no recursion at all
    (9, 12, 1),       # one state
])
def test_fb_pallas_edge_shapes(n, t_max, k):
    """Kernel vs XLA path at the edges of the kernel's shapes.  phi_norm
    is a sum of T float32 logs that may sit near zero, so it is held to
    an absolute bound of a few float32 ulps per step."""
    from vbhem_tpu.ops.fb_pallas import forward_backward_pallas
    args = _fb_problem(np.random.default_rng(n), n, t_max, k)
    want = forward_backward(*args)
    got = forward_backward_pallas(*args, interpret=True)
    np.testing.assert_allclose(np.asarray(got.gamma),
                               np.asarray(want.gamma), atol=2e-6)
    np.testing.assert_allclose(np.asarray(got.xi_sum),
                               np.asarray(want.xi_sum), atol=2e-5)
    np.testing.assert_allclose(np.asarray(got.phi_norm),
                               np.asarray(want.phi_norm), rtol=2e-6,
                               atol=1e-6 * t_max)


def test_fb_pallas_groups_and_vmap_fold():
    """Per-sequence parameters (groups mode) + the custom_vmap fold of
    the trial axis into N (interpret mode) vs the XLA path: one kernel
    call for all trials."""
    from vbhem_tpu.ops.fb_pallas import forward_backward_pallas
    rng = np.random.default_rng(11)
    b, n, t_max, k = 3, 5, 6, 2
    lengths = rng.integers(2, t_max + 1, size=n); lengths[0] = t_max
    mask = jnp.asarray(np.arange(t_max)[None, :] < lengths[:, None])
    log_rho = jnp.asarray(rng.normal(size=(b, n, t_max, k)) * 2, jnp.float32)
    # per-sequence scores (groups mode), per-trial batch on top
    log_pz1 = jnp.asarray(
        np.log(rng.dirichlet(np.ones(k), size=(b, n))) - 0.1, jnp.float32)
    log_trans = jnp.asarray(
        np.log(rng.dirichlet(np.ones(k), size=(b, n, k))) - 0.1, jnp.float32)

    def fp(p, t, r):
        return forward_backward_pallas(p, t, r, mask, interpret=True)

    got = jax.vmap(fp)(log_pz1, log_trans, log_rho)
    want = jax.vmap(lambda p, t, r: forward_backward(p, t, r, mask))(
        log_pz1, log_trans, log_rho)
    np.testing.assert_allclose(np.asarray(got.gamma),
                               np.asarray(want.gamma), atol=2e-6)
    np.testing.assert_allclose(np.asarray(got.xi_sum),
                               np.asarray(want.xi_sum), atol=2e-5)
    np.testing.assert_allclose(np.asarray(got.phi_norm),
                               np.asarray(want.phi_norm), rtol=2e-6)
    jaxpr = jax.make_jaxpr(jax.vmap(fp))(log_pz1, log_trans, log_rho)
    assert str(jaxpr).count("pallas_call") == 1


@pytest.mark.parametrize("backend,dtype,k,want", [
    ("gpu", jnp.float32, 2, True),
    ("gpu", jnp.float32, 8, True),          # K_MAX
    ("gpu", jnp.float32, 9, False),
    ("cpu", jnp.float32, 2, False),         # never on the CPU
    ("gpu", jnp.float64, 2, False),         # never for f64
])
def test_fb_use_kernel(backend, dtype, k, want):
    from vbhem_tpu.ops import fb_pallas
    assert k != fb_pallas.K_MAX or want
    assert fb_pallas.use_kernel(backend, dtype, k) is want


def test_fb_auto_takes_xla_path_on_cpu(setup):
    from vbhem_tpu.ops.fb_pallas import forward_backward_auto
    log_pz1, log_trans, log_rho, lengths = setup
    mask = np.arange(log_rho.shape[1])[None, :] < lengths[:, None]
    args = tuple(map(jnp.asarray, (log_pz1, log_trans, log_rho, mask)))
    assert "pallas_call" not in str(
        jax.make_jaxpr(forward_backward_auto)(*args))
    got, want = forward_backward_auto(*args), forward_backward(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_fb_assoc_matches_sequential():
    """Associative-scan (log-depth) FB vs the sequential scan."""
    from vbhem_tpu.ops.fb import forward_backward_assoc
    rng = np.random.default_rng(7)
    n, t_max, k = 6, 33, 4
    lengths = rng.integers(2, t_max + 1, size=n); lengths[0] = t_max
    mask = np.arange(t_max)[None, :] < lengths[:, None]
    log_rho = rng.normal(size=(n, t_max, k)) * 3.0
    log_pz1 = np.log(rng.dirichlet(np.ones(k))) - 0.2
    log_trans = np.log(rng.dirichlet(np.ones(k), size=k)) - 0.2
    args = (jnp.asarray(log_pz1), jnp.asarray(log_trans),
            jnp.asarray(log_rho), jnp.asarray(mask))
    want = forward_backward(*args)
    got = forward_backward_assoc(*args)
    np.testing.assert_allclose(np.asarray(got.gamma),
                               np.asarray(want.gamma), atol=1e-9)
    np.testing.assert_allclose(np.asarray(got.xi_sum),
                               np.asarray(want.xi_sum), atol=1e-8)
    np.testing.assert_allclose(np.asarray(got.phi_norm),
                               np.asarray(want.phi_norm), rtol=1e-10)
