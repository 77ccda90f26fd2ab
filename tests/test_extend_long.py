"""Long-read extension: the dense lax DP against the scalar ksw_extend
oracle on 400-1,000 bp queries, where the band binds (the `-x pacbio` /
`-x ont2d` regime; the reference caps reads at GASAL2's MAX_SEQ_LEN=300
and never meets it). A banded kernel whose per-row work follows the band
instead of the read is listed in ROADMAP.md; until then the dense DP is
the product path here and must stay exact."""
import jax.numpy as jnp
import numpy as np
import pytest

from bwamem_tpu.ops.extend import (ExtendParams, extend_batch,
                                   make_score_matrix)
from bwamem_tpu.oracle.ksw import ksw_extend


def _long_jobs(rng, n, sim=0.88):
    """Query = read tail, target = a mutated copy with indels, sometimes
    followed by unrelated sequence so extensions die mid-target."""
    jobs = []
    for _ in range(n):
        q = rng.integers(0, 4, int(rng.integers(400, 1001)))
        t = q.copy()
        m = rng.random(len(t)) > sim
        t[m] = (t[m] + rng.integers(1, 4, int(m.sum()))) % 4
        for _ in range(int(rng.integers(1, 6))):
            cut = int(rng.integers(1, 6))
            pos = int(rng.integers(1, len(t) - cut))
            if rng.random() < 0.5:
                t = np.concatenate([t[:pos], t[pos + cut:]])
            else:
                t = np.concatenate(
                    [t[:pos], rng.integers(0, 4, cut), t[pos:]])
        if rng.random() < 0.5:
            t = np.concatenate([t[: int(rng.integers(200, len(t)))],
                                rng.integers(0, 4, 100)])
        jobs.append((q, t, int(rng.integers(20, 120))))
    return jobs


@pytest.mark.parametrize("zdrop", [0, 100])
@pytest.mark.parametrize("w", [50, 100, 300])
def test_long_read_extension_matches_oracle(w, zdrop):
    rng = np.random.default_rng(7 * w + zdrop)
    # -x pacbio scoring (cli.py presets): a=1 b=1 o=1 e=1
    a, b, o, e = 1, 1, 1, 1
    mat = make_score_matrix(a, b)
    params = ExtendParams(o_del=o, e_del=e, o_ins=o, e_ins=e, w=w,
                          zdrop=zdrop, end_bonus=5, max_mat=a, mismatch=b)
    jobs = _long_jobs(rng, 4)
    N = len(jobs)
    QMAX = max(len(q) for q, _, _ in jobs)
    TMAX = max(len(t) for _, t, _ in jobs)
    Q = np.full((N, QMAX), 4, np.int32)
    T = np.full((N, TMAX), 4, np.int32)
    ql, tl, h0 = (np.zeros(N, np.int32) for _ in range(3))
    for i, (q, t, h) in enumerate(jobs):
        Q[i, : len(q)], T[i, : len(t)] = q, t
        ql[i], tl[i], h0[i] = len(q), len(t), h
    out = extend_batch(jnp.asarray(Q), jnp.asarray(T), jnp.asarray(ql),
                       jnp.asarray(tl), jnp.asarray(h0), jnp.asarray(mat),
                       params)
    out = {k: np.asarray(v) for k, v in out.items()}
    for i, (q, t, h) in enumerate(jobs):
        exp = ksw_extend(q, t, mat, o, e, o, e, w, 5, zdrop, h)
        # the consumer's end_choice triple (src/bwamem.c:1887-1901)
        sg, qg, tg = (int(out["score"][i]), int(out["qle"][i]),
                      int(out["tle"][i]))
        gs, gt = int(out["gscore"][i]), int(out["gtle"][i])
        got = (sg, qg, tg) if (gs <= 0 or gs <= sg - 5) \
            else (gs, len(q), gt)
        want = (exp.score, exp.qle, exp.tle) \
            if (exp.gscore <= 0 or exp.gscore <= exp.score - 5) \
            else (exp.gscore, len(q), exp.gtle)
        assert got == want, f"job {i}: {got} vs {want}"
        assert (sg, qg, tg) == (exp.score, exp.qle, exp.tle), f"job {i}"
