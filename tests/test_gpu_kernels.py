"""GPU-only: the DP kernels compiled for the card against their lax
twins. Skips without a GPU; run on the card with `pytest -m gpu`."""
import numpy as np
import pytest

KEYS = ("score", "qle", "tle", "gscore", "gtle", "max_off")

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m gpu)")


@pytest.mark.parametrize("zdrop,opt_ext,w", [
    (0, False, 300), (0, True, 300), (100, True, 100), (100, True, 10)])
def test_kernel_compiled_matches_lax(gpu, zdrop, opt_ext, w):
    import jax.numpy as jnp

    import chip_smoke
    from bwamem_tpu.ops.extend import (ExtendParams, extend_batch,
                                       make_score_matrix)
    from bwamem_tpu.ops.pallas.dp_kernel import extend_batch_gpu

    rng = np.random.default_rng(w + zdrop)
    p = ExtendParams(w=w, zdrop=zdrop, opt_ext=opt_ext)
    args = [jnp.asarray(x) for x in chip_smoke.ext_jobs(
        rng, 3000, 150, 192, 512, w=w)]
    want = extend_batch(*args, jnp.asarray(make_score_matrix()), p)
    got = extend_batch_gpu(*args, p)
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("o,e", [(6, 1), (5, 2)])
def test_sw_kernel_compiled_matches_lax(gpu, o, e):
    import jax.numpy as jnp

    import chip_smoke
    from bwamem_tpu.ops.extend import make_score_matrix
    from bwamem_tpu.ops.pallas.dp_kernel import sw_align_batch_gpu_stacked
    from bwamem_tpu.ops.swalign import sw_align_batch_stacked

    rng = np.random.default_rng(o + e)
    Q, T, ql, tl, minsc = (jnp.asarray(x) for x in chip_smoke.rescue_jobs(
        rng, 1500, 150, 192, 512))
    want = sw_align_batch_stacked(Q, T, ql, tl,
                                  jnp.asarray(make_score_matrix()), minsc,
                                  o, e, o + 1, e, 1)
    got = sw_align_batch_gpu_stacked(Q, T, ql, tl, minsc, 1, 4, o, e,
                                     o + 1, e)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_aligner_uses_the_kernel(gpu):
    from bwamem_tpu.ops.kernels import use_gpu_kernels

    assert use_gpu_kernels()
