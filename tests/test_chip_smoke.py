"""`chip_smoke.py` rehearsed on the CPU: the device phase refuses a CPU
backend, and the kernel, main-path and sharded phases run end to end at
tiny sizes (kernels in interpret mode; the script itself runs them on
the card at full size)."""
import json
import os
import subprocess
import sys

import pytest

import chip_smoke
from vbhem_tpu.config import VBConfig, VBHEMConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_script_refuses_cpu_backend():
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "VBHEM_TPU_NO_COMPILE_CACHE": "1"})
    assert proc.returncode != 0
    assert "needs a GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_device_phase_refuses_cpu_in_process():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.phase_device(1)
    assert exc.value.code not in (0, None)


def test_kernel_phase_tiny(capsys):
    chip_smoke.phase_kernels("cpu (interpret)", n_subj=2, n_trials=3,
                             n_seqs=4, t=7, k=3, interpret=True, reps=1)
    out = capsys.readouterr().out
    assert out.count("max_rel_err vs float64") == 1


def test_main_path_phase_tiny(tmp_path, capsys):
    """The runner path of phase (c) at the size of the repo's recovery
    tests (6 subjects per cluster, 15 sequences), which selects K=2, S=2
    with Rand index 1.0, then the EM-iteration check."""
    protocol = dict(
        n_per_cluster=6, n_seqs=15, t=50, k_grid=[1, 2, 3], s_grid=[1, 2],
        vb_config=VBConfig(mu0=(1.5, 1.5), w0=1.0, numtrials=3),
        vbhem_config=VBHEMConfig(alpha0=1e6, m0=(1.5, 1.5), w0=1.0, nv=100,
                                 tau=50, trials=6, initmode="baseem",
                                 learn_hyps=False),
        verbose=False)
    outdir = str(tmp_path / "main")
    os.makedirs(os.path.join(outdir, "stale"))     # cleared first
    chip_smoke.phase_main_path("cpu", outdir=outdir, trials=6,
                               protocol=protocol, em_kb=16, em_kr=2,
                               em_iters=3)
    out = capsys.readouterr().out
    assert "reduced: VBHEM restarts per (K,S) cell 6" in out
    assert "selected K=2 S=2 RI=1.0000" in out
    assert not os.path.exists(os.path.join(outdir, "stale"))
    with open(os.path.join(outdir, "summary.json")) as f:
        assert json.load(f)["vbhem"]["p_k_correct"] == 1.0


def test_sharded_phase_tiny(capsys):
    chip_smoke.phase_sharded("cpu", n_devices=4, kb=64, kr=3, iters=5)
    assert "on 4 devices: 5 iterations" in capsys.readouterr().out


def test_em_rising_rejects_a_falling_elbo(monkeypatch):
    import numpy as np
    from vbhem_tpu.models import vbhem
    monkeypatch.setattr(vbhem, "em_trace", lambda *a: (
        None, np.asarray([-10.0, -5.0, -7.0])))
    with pytest.raises(AssertionError, match="ELBO fell"):
        chip_smoke.em_rising(None, None, None, 1, 2, 3)
