"""Tests for grouped VBEM, batch learning, hyp heuristics, io, plots."""
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vbhem_tpu.config import VBConfig
from vbhem_tpu.containers import SeqBatch
from vbhem_tpu.models import batch as batchmod
from vbhem_tpu.models import hmm_tools, vbhmm, vbhmm_groups
from vbhem_tpu.models.hyp_heuristics import format_hyps, set_hyperparam
from tests.test_vbhmm import make_gt_hmm


@pytest.fixture(scope="module")
def two_dyn_batch():
    """Sequences from two HMMs with shared emissions but different
    dynamics — the grouped-VBEM use case."""
    h1 = make_gt_hmm([[0.8, 0.2], [0.2, 0.8]])
    h2 = make_gt_hmm([[0.2, 0.8], [0.8, 0.2]])
    xs = []
    for gi, h in enumerate([h1, h2]):
        _, x = hmm_tools.sample(jax.random.key(gi), h, t=40, n=10)
        xs.append(x)
    x = jnp.concatenate(xs)
    group_map = jnp.asarray([0] * 10 + [1] * 10)
    return SeqBatch(x=x, lengths=jnp.full((20,), 40, jnp.int32)), group_map


def test_grouped_vbem_separates_dynamics(two_dyn_batch):
    batch, group_map = two_dyn_batch
    cfg = VBConfig(mu0=(1.5, 1.5), w0=1.0)
    hyps = vbhmm.VBHyps.from_config(cfg, 2, batch.x.dtype)
    post0u = vbhmm.random_init(jax.random.key(0), batch, 2, hyps)
    post0 = vbhmm_groups.from_ungrouped(post0u, 2)
    st = vbhmm_groups.vbem_em(batch, post0, hyps, group_map)
    assert np.isfinite(float(st.ll))
    # per-group transition matrices should differ strongly
    eps = np.asarray(st.post.epsilon)
    a0 = eps[0] / eps[0].sum(-1, keepdims=True)
    a1 = eps[1] / eps[1].sum(-1, keepdims=True)
    # one group self-transitions, the other alternates
    tr = np.trace(a0) + np.trace(a1)
    assert abs(np.trace(a0) - np.trace(a1)) > 0.8, (a0, a1)
    # shared emissions recover the two means
    means = np.sort(np.asarray(st.post.niw.m)[:, 0])
    np.testing.assert_allclose(means, [0, 3], atol=0.4)


def test_grouped_elbo_monotone(two_dyn_batch):
    batch, group_map = two_dyn_batch
    cfg = VBConfig(mu0=(1.5, 1.5), w0=1.0)
    hyps = vbhmm.VBHyps.from_config(cfg, 2, batch.x.dtype)
    post = vbhmm_groups.from_ungrouped(
        vbhmm.random_init(jax.random.key(1), batch, 2, hyps), 2)
    lls = []
    for _ in range(25):
        fb = vbhmm_groups.e_step(batch, post, group_map)
        stats = vbhmm_groups.grouped_stats(batch, fb, group_map, 2)
        lls.append(float(vbhmm_groups.elbo(batch, post, fb, stats, hyps)))
        post = vbhmm_groups.m_step(stats, hyps)
    diffs = np.diff(lls)
    assert np.all(diffs >= -1e-7 * np.abs(np.array(lls[:-1]))), lls


def test_group_split(two_dyn_batch):
    batch, group_map = two_dyn_batch
    cfg = VBConfig(mu0=(1.5, 1.5), w0=1.0)
    hyps = vbhmm.VBHyps.from_config(cfg, 2, batch.x.dtype)
    post = vbhmm_groups.from_ungrouped(
        vbhmm.random_init(jax.random.key(1), batch, 2, hyps), 2)
    parts = vbhmm_groups.split_groups(post)
    assert len(parts) == 2
    assert parts[0].alpha.shape == (2,)


def test_learn_batch_shared_hyps():
    h = make_gt_hmm([[0.6, 0.4], [0.4, 0.6]])
    batches = []
    for i in range(3):
        _, x = hmm_tools.sample(jax.random.key(20 + i), h, t=30, n=10)
        batches.append(SeqBatch(x=x, lengths=jnp.full((10,), 30, jnp.int32)))
    cfg = VBConfig(mu0=(1.5, 1.5), w0=1.0, numtrials=2)
    results, info = batchmod.learn_batch(jax.random.key(0), batches, 2,
                                         cfg, learn_hyps_batch=True,
                                         keep_inits=2)
    assert len(results) == 3
    assert "learned_hyps" in info
    for res in results:
        means = np.sort(np.asarray(res.model.mean)[:, 0])
        np.testing.assert_allclose(means, [0, 3], atol=0.5)


def test_set_hyperparam_modes(two_dyn_batch):
    batch, _ = two_dyn_batch
    cfg = set_hyperparam(VBConfig(), [batch], mode="d")
    assert abs(cfg.mu0[0] - float(batch.x[np.asarray(batch.mask)].mean(0)[0])) < 1e-6
    cfg_c = set_hyperparam(VBConfig(), [batch], mode="c",
                           image_size=(512, 384))
    assert cfg_c.mu0 == (256.0, 192.0)
    s = (0.5 * (512 + 384) / 8.0) / 4.0
    assert cfg_c.w0 == pytest.approx(s ** -2)


def test_format_hyps():
    hyps = vbhmm.VBHyps.from_config(VBConfig(mu0=(1.0, 2.0)), 2)
    s = format_hyps(hyps)
    assert "alpha0=0.1" in s and "m0=[1, 2]" in s


def test_read_fixations_csv(tmp_path):
    from vbhem_tpu.utils.io import read_fixations
    csv = tmp_path / "fix.csv"
    csv.write_text(
        "SubjectID,TrialID,FixX,FixY\n"
        "s1,1,10,20\ns1,1,11,21\ns1,2,30,40\n"
        "s2,1,50,60\n")
    out = read_fixations(str(csv))
    assert set(out) == {"s1", "s2"}
    assert out["s1"].x.shape == (2, 2, 2)
    assert list(np.asarray(out["s1"].lengths)) == [2, 1]
    np.testing.assert_allclose(np.asarray(out["s2"].x)[0, 0], [50, 60])


def test_plots_smoke(two_dyn_batch, tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    batch, _ = two_dyn_batch
    cfg = VBConfig(mu0=(1.5, 1.5), w0=1.0, numtrials=2)
    res, _ = vbhmm.learn(jax.random.key(0), batch, 2, cfg)
    from vbhem_tpu.utils import plots
    fig = plots.plot_vbhmm(res, batch=batch)
    fig.savefig(tmp_path / "hmm.png")
    assert (tmp_path / "hmm.png").stat().st_size > 0


def test_phase_timer():
    from vbhem_tpu.utils.profiling import PhaseTimer
    import time as _t
    pt = PhaseTimer()
    with pt.phase("a"):
        _t.sleep(0.01)
    with pt.phase("a"):
        _t.sleep(0.01)
    with pt.phase("b"):
        pass
    assert pt.counts["a"] == 2 and pt.totals["a"] >= 0.02
    assert "a" in pt.summary() and "b" in pt.summary()


def test_grouped_learn_front_end_selects_k(two_dyn_batch):
    """End-to-end grouped learn: restarts + model selection over K
    (`vbhmm_learn` flowing usegroups through everything) must select
    the true K=2 and recover each group's dynamics."""
    batch, group_map = two_dyn_batch
    cfg = VBConfig(mu0=(1.5, 1.5), w0=1.0, numtrials=4)
    res, info = vbhmm_groups.learn_grouped(
        jax.random.key(5), batch, [1, 2, 3], group_map, 2, cfg)
    assert info["model_best_k"] == 2, info["model_ll"]
    assert len(res.group_models) == 2
    # standardized shared emissions: state 0 = higher-count state; each
    # group's transition matrix matches its GT up to the shared order
    m0 = np.asarray(res.group_models[0].trans)
    m1 = np.asarray(res.group_models[1].trans)
    # group 0 is persistent (diag-dominant), group 1 is alternating
    assert m0[0, 0] > 0.6 and m0[1, 1] > 0.6, m0
    assert m1[0, 1] > 0.6 and m1[1, 0] > 0.6, m1


def test_grouped_learn_hyps(two_dyn_batch):
    """Grouped hyp learning improves (or matches) the grouped ELBO."""
    batch, group_map = two_dyn_batch
    cfg0 = VBConfig(mu0=(1.5, 1.5), w0=1.0, numtrials=2)
    res0, _ = vbhmm_groups.learn_grouped(
        jax.random.key(6), batch, 2, group_map, 2, cfg0)
    cfg1 = VBConfig(mu0=(1.5, 1.5), w0=1.0, numtrials=2,
                    learn_hyps=True, hyp_max_steps=15)
    res1, info1 = vbhmm_groups.learn_grouped(
        jax.random.key(6), batch, 2, group_map, 2, cfg1)
    assert "learned_hyps" in info1
    assert float(res1.ll) >= float(res0.ll) - 1e-6


DEMODATA_XLS = "/root/reference/demo/demodata.xls"


@pytest.mark.skipif(not os.path.exists(DEMODATA_XLS),
                    reason="reference demo data not present")
def test_read_legacy_xls_demodata():
    """The vendored BIFF8 reader (utils/xls.py) must ingest the
    reference's shipped `demo/demodata.xls` (the dataset of
    `vbdemo_face.m`; schema from `read_xls_fixations.m:6-34`)."""
    from vbhem_tpu.utils.io import read_fixations
    from vbhem_tpu.utils.xls import read_xls_table

    header, rows = read_xls_table(DEMODATA_XLS)
    assert header == ["SubjectID", "TrialID", "FixX", "FixY"]
    assert len(rows) == 1010
    # values are plain floats in screen coordinates
    assert all(isinstance(v, float) for v in rows[0])
    np.testing.assert_allclose(rows[0], [1.0, 1.0, 182.16, 209.52])

    out = read_fixations(DEMODATA_XLS)
    assert len(out) == 10
    total = sum(int(np.asarray(b.lengths).sum()) for b in out.values())
    assert total == 1010
    # every subject has ~40 trials of 1-3 fixations
    for b in out.values():
        assert b.x.shape[-1] == 2
        assert 1 <= int(np.asarray(b.lengths).min())
        assert int(np.asarray(b.lengths).max()) <= b.x.shape[1]


def test_weighted_kmeans_energy_matches_matlab_oracle():
    """`my_weighted_kmeans.m` parity: the Hartigan-style energy
    adjustment (member d2*wc/(wc-wi), non-member d2*wc/(wc+wi),
    `:36-56,87-100`) against a direct NumPy port of the MATLAB loop."""
    from vbhem_tpu.ops.kmeans import weighted_kmeans_energy

    rng = np.random.default_rng(4)
    m, d, k = 40, 2, 3
    x = np.concatenate([rng.normal(size=(m // 2, d)),
                        rng.normal(size=(m // 2, d)) + 4.0])
    w = rng.uniform(0.2, 2.0, size=m)
    init_c = x[rng.choice(m, k, replace=False)]

    # ---- NumPy port of my_weighted_kmeans.m ----
    def centroids(cl):
        cen = np.zeros((k, d))
        wc = np.zeros(k)
        for j in range(k):
            mem = cl == j
            wc[j] = w[mem].sum()
            if wc[j] > 0:
                cen[j] = (w[mem, None] * x[mem]).sum(0) / wc[j]
        return cen, wc

    def energies(cl, cen, wc):
        d2 = ((x[:, None] - cen[None]) ** 2).sum(-1)
        f = np.zeros(m)
        for j in range(k):
            mem = cl == j
            with np.errstate(divide="ignore", invalid="ignore"):
                f[mem] = d2[mem, j] * wc[j] / (wc[j] - w[mem])
        total = np.nansum(np.where(np.isfinite(f), w * f, 0.0))
        return d2, f, total

    cl = np.argmin(((x[:, None] - init_c[None]) ** 2).sum(-1), -1)
    cen, wc = centroids(cl)
    d2, f, old_e = energies(cl, cen, wc)
    for _ in range(100):
        fmat = np.zeros((m, k))
        for j in range(k):
            mem = cl == j
            fmat[mem, j] = f[mem]
            non = ~mem
            fmat[non, j] = d2[non, j] * wc[j] / (wc[j] + w[non])
        cl = np.argmin(fmat, -1)
        cen, wc = centroids(cl)
        d2, f, new_e = energies(cl, cen, wc)
        if abs(new_e - old_e) < 1e-6:
            break
        old_e = new_e

    got_cl, got_cen = weighted_kmeans_energy(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(init_c))
    np.testing.assert_array_equal(np.asarray(got_cl), cl)
    np.testing.assert_allclose(np.asarray(got_cen), cen, rtol=1e-10)


def test_inv_logdet_small_d_closed_form():
    """The D<=3 cofactor fast paths of inv_psd/logdet_psd must agree
    with the generic Cholesky path to f64 precision on random SPD
    batches (including near-ill-conditioned ones)."""
    import numpy as np

    from vbhem_tpu.utils.numeric import inv_psd, logdet_psd

    rng = np.random.default_rng(11)
    for d in (1, 2, 3, 4):
        a = rng.normal(size=(7, 5, d, d))
        spd = np.einsum("...de,...fe->...df", a, a) + 1e-3 * np.eye(d)
        spd[0, 0] *= 1e-4          # small-scale block
        spd[1, 0] *= 1e4           # large-scale block
        j = jnp.asarray(spd)
        got_inv = np.asarray(inv_psd(j))
        got_ld = np.asarray(logdet_psd(j))
        want_inv = np.linalg.inv(spd)
        want_ld = np.linalg.slogdet(spd)[1]
        np.testing.assert_allclose(got_inv, want_inv, rtol=2e-6,
                                   atol=1e-10 * np.abs(want_inv).max())
        np.testing.assert_allclose(got_ld, want_ld, rtol=1e-8, atol=1e-8)


def test_compile_cache_dir():
    """The persistent compilation cache honours JAX_COMPILATION_CACHE_DIR
    and otherwise sits at the fixed `.jax_cache/` in the checkout."""
    import os
    import vbhem_tpu
    assert vbhem_tpu.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/some/cache"}) == "/some/cache"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert vbhem_tpu.compile_cache_dir({}) == os.path.join(repo, ".jax_cache")
