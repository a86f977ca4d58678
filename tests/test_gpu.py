"""The kernel compiled for the card against the XLA path.  Marked `gpu`;
they skip unless JAX runs on a GPU:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    """Decided per test, at run time: never while the module imports."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")


def test_fb_kernel_compiled(gpu):
    from vbhem_tpu.ops.fb import forward_backward
    from vbhem_tpu.ops.fb_pallas import forward_backward_auto
    rng = np.random.default_rng(0)
    n, t, k = 300, 20, 3
    lengths = rng.integers(2, t + 1, size=n)
    mask = jnp.asarray(np.arange(t)[None, :] < lengths[:, None])
    args = (jnp.asarray(np.log(rng.dirichlet(np.ones(k))), jnp.float32),
            jnp.asarray(np.log(rng.dirichlet(np.ones(k), size=k)),
                        jnp.float32),
            jnp.asarray(rng.normal(size=(n, t, k)), jnp.float32), mask)
    assert "pallas_call" in str(jax.make_jaxpr(forward_backward_auto)(*args))
    got = jax.jit(forward_backward_auto)(*args)
    want = forward_backward(*args)
    np.testing.assert_allclose(np.asarray(got.gamma), np.asarray(want.gamma),
                               atol=2e-6)
    np.testing.assert_allclose(np.asarray(got.phi_norm),
                               np.asarray(want.phi_norm), rtol=2e-6)
