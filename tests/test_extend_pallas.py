"""GPU extension kernel vs the lax twin, in the Pallas interpreter on the
CPU (on the GPU the same kernel runs compiled: tests/test_gpu_kernels.py)."""
import jax.numpy as jnp
import numpy as np
import pytest

from bwamem_tpu.ops.extend import ExtendParams, extend_batch, make_score_matrix
from bwamem_tpu.ops.pallas.dp_kernel import LANES, extend_batch_gpu
from tests.test_extend import _random_cases

KEYS = ("score", "qle", "tle", "gscore", "gtle", "max_off")


def _check(Q, T, ql, tl, h0, params):
    mat = make_score_matrix(params.max_mat, params.mismatch)
    want = extend_batch(jnp.asarray(Q), jnp.asarray(T), jnp.asarray(ql),
                        jnp.asarray(tl), jnp.asarray(h0), jnp.asarray(mat),
                        params)
    got = extend_batch_gpu(jnp.asarray(Q), jnp.asarray(T), jnp.asarray(ql),
                           jnp.asarray(tl), jnp.asarray(h0), params,
                           interpret=True)
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("zdrop,opt_ext,w", [
    (0, False, 300),   # fork decoy configuration
    (0, True, 300),
    (100, True, 100),  # vanilla-like
])
def test_pallas_matches_lax(zdrop, opt_ext, w):
    rng = np.random.default_rng(1000 + zdrop + w)
    params = ExtendParams(o_del=6, e_del=1, o_ins=6, e_ins=1, w=w,
                          zdrop=zdrop, end_bonus=5, opt_ext=opt_ext,
                          max_mat=1, mismatch=4)
    cases = _random_cases(rng, 33, with_n=True)
    QMAX = max(len(q) for q, _, _ in cases)
    TMAX = max(len(t) for _, t, _ in cases)
    N = len(cases)
    Q = np.full((N, QMAX), 4, np.int32)
    T = np.full((N, TMAX), 4, np.int32)
    ql = np.zeros(N, np.int32)
    tl = np.zeros(N, np.int32)
    h0 = np.zeros(N, np.int32)
    for i, (q, t, h) in enumerate(cases):
        Q[i, : len(q)] = q
        T[i, : len(t)] = t
        ql[i], tl[i], h0[i] = len(q), len(t), h
    _check(Q, T, ql, tl, h0, params)


def test_bucketed_dispatch_matches_scan():
    """The wrapper's tlen sort, padding to a multiple of LANES and inverse
    permutation, over several programs and degenerate lanes (qlen 0,
    tlen 0, qlen == QMAX, narrow band, int8 codes)."""
    rng = np.random.default_rng(11)
    N, QMAX, TMAX = 3 * LANES + 5, 160, 64
    query = rng.integers(0, 4, (N, QMAX)).astype(np.int8)
    target = rng.integers(0, 4, (N, TMAX)).astype(np.int8)
    target[: N // 2, :40] = query[: N // 2, :40]
    qlen = rng.integers(0, QMAX + 1, N).astype(np.int32)
    qlen[:6] = [0, 1, QMAX, 126, 127, 2]
    tlen = rng.integers(0, TMAX + 1, N).astype(np.int32)
    tlen[6:9] = [0, 1, TMAX]
    h0 = rng.integers(1, 100, N).astype(np.int32)
    _check(query, target, qlen, tlen, h0, ExtendParams(w=20, zdrop=50))


@pytest.mark.parametrize("a,b,o,e", [(1, 4, 6, 1), (2, 3, 5, 2)])
def test_pallas_scoring_params(a, b, o, e):
    """The kernel's bwa-form scoring follows `params` (match a, mismatch
    b, gap open o / extend e), as the lax twin's matrix does."""
    rng = np.random.default_rng(50 + a)
    params = ExtendParams(o_del=o, e_del=e, o_ins=o + 1, e_ins=e,
                          max_mat=a, mismatch=b, w=40, zdrop=0)
    cases = _random_cases(rng, 20, with_n=True)
    QMAX = max(len(q) for q, _, _ in cases)
    TMAX = max(len(t) for _, t, _ in cases)
    N = len(cases)
    Q = np.full((N, QMAX), 4, np.int32)
    T = np.full((N, TMAX), 4, np.int32)
    ql, tl = np.zeros(N, np.int32), np.zeros(N, np.int32)
    h0 = np.zeros(N, np.int32)
    for i, (q, t, h) in enumerate(cases):
        Q[i, : len(q)], T[i, : len(t)] = q, t
        ql[i], tl[i], h0[i] = len(q), len(t), h * a
    _check(Q, T, ql, tl, h0, params)
