"""Root conftest: a virtual 8-device CPU mesh and float64, so sharding
tests run without several GPUs and parity tests get MATLAB-grade
precision (SURVEY.md section 4 test strategy).

The platform is the CPU unless ``JAX_PLATFORMS`` names another one:
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` runs the tests that
need the card (marked ``gpu``) on it.
"""
import os

# The shared persistent compilation cache is for single-process runs
# (bench, experiment runner); concurrent pytest workers + other jobs
# racing on it can corrupt entries, so disable it under tests.
os.environ.setdefault("VBHEM_TPU_NO_COMPILE_CACHE", "1")

# XLA:CPU's parallel codegen creates thousands of small JIT code
# mappings per compiled module; a compile-heavy session exhausts the
# default vm.max_map_count=65530, LLVM reports "Cannot allocate memory"
# and the process segfaults (observed at ~59k maps).  Raise the limit
# when we can (root); xdist file sharding (pytest.ini) bounds per-process
# growth regardless.
try:
    with open("/proc/sys/vm/max_map_count") as _f:
        if int(_f.read()) < 1048576:
            with open("/proc/sys/vm/max_map_count", "w") as _g:
                _g.write("1048576")
except OSError:
    pass

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
_platforms = os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", _platforms)
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables between test modules: accumulated
    XLA:CPU JIT state across the whole suite in one process ends in a
    segfault (see pytest.ini); clearing per module bounds the growth."""
    yield
    jax.clear_caches()
