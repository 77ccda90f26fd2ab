"""Kernel choice: one selection function, no backend-name branches, and
interpret mode never inferred from the backend."""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bwamem_tpu
from bwamem_tpu.ops import extend, kernels

PKG = pathlib.Path(bwamem_tpu.__file__).parent


@pytest.mark.parametrize("backend,want", [
    ("gpu", True), ("cpu", False), ("rocm", False), ("METAL", False)])
def test_use_gpu_kernels_follows_default_backend(monkeypatch, backend, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert kernels.use_gpu_kernels() is want


def test_one_selection_point_in_the_package():
    """Only ops/kernels.py asks for the backend, and no source infers
    `interpret` from it."""
    asks = []
    for path in PKG.rglob("*.py"):
        src = path.read_text()
        if "default_backend(" in src:
            asks.append(path.relative_to(PKG).as_posix())
        assert not re.search(r"interpret\s*=\s*(jax\.)?default_backend",
                             src), path
        assert "interpret: bool | None" not in src, path
    assert asks == ["ops/kernels.py"]


def _args(n=5, qmax=12, tmax=20):
    rng = np.random.default_rng(3)
    return (jnp.asarray(rng.integers(0, 4, (n, qmax)), jnp.int32),
            jnp.asarray(rng.integers(0, 4, (n, tmax)), jnp.int32),
            jnp.full(n, qmax, jnp.int32), jnp.full(n, tmax, jnp.int32),
            jnp.full(n, 10, jnp.int32))


def test_auto_takes_the_kernel_compiled_when_selected(monkeypatch):
    from bwamem_tpu.ops.pallas import dp_kernel

    seen = {}

    def fake(query, target, qlen, tlen, h0, params, **kw):
        seen.update(kw, called=True)
        return "kernel"

    monkeypatch.setattr(dp_kernel, "extend_batch_gpu", fake)
    monkeypatch.setattr(extend, "use_gpu_kernels", lambda: True)
    q, t, ql, tl, h0 = _args()
    mat = jnp.asarray(extend.make_score_matrix())
    assert extend.extend_batch_auto(q, t, ql, tl, h0, mat,
                                    extend.ExtendParams()) == "kernel"
    assert seen == {"called": True}   # no interpret flag passed


def test_auto_takes_the_lax_twin_elsewhere():
    q, t, ql, tl, h0 = _args()
    mat = jnp.asarray(extend.make_score_matrix())
    p = extend.ExtendParams()
    got = extend.extend_batch_auto(q, t, ql, tl, h0, mat, p)
    want = extend.extend_batch(q, t, ql, tl, h0, mat, p)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]))
