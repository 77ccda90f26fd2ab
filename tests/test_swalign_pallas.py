"""GPU local-SW (ksw_align2) kernel vs the lax reference path, in the
Pallas interpreter on the CPU (compiled on the card: test_gpu_kernels.py).

The lax path (ops/swalign.py) is itself tested against the scalar ksw
oracle in test_pairing.py, so exact agreement here transitively pins the
kernel to the reference's mate-rescue semantics
(reference: src/ksw.c:355-612, src/bwamem_pair.c:119-159).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from bwamem_tpu.ops.extend import make_score_matrix
from bwamem_tpu.ops.pallas.dp_kernel import sw_align_batch_gpu_stacked
from bwamem_tpu.ops.swalign import SW_KEYS, sw_align_batch


def _random_sw_cases(rng, n, qmax=96, tmax=160, with_n=True):
    cases = []
    for i in range(n):
        ql = int(rng.integers(1, qmax + 1))
        tl = int(rng.integers(1, tmax + 1))
        q = rng.integers(0, 4, ql).astype(np.int32)
        t = rng.integers(0, 4, tl).astype(np.int32)
        if i % 3 == 0 and tl >= ql:
            # plant a mutated copy so real alignments appear
            off = int(rng.integers(0, tl - ql + 1))
            t[off:off + ql] = q
            nmut = int(rng.integers(0, max(ql // 8, 1)))
            for _ in range(nmut):
                p = int(rng.integers(0, ql))
                t[off + p] = rng.integers(0, 4)
        if with_n and i % 5 == 0:
            q[rng.integers(0, ql)] = 4
            t[rng.integers(0, tl)] = 4
        cases.append((q, t))
    return cases


@pytest.mark.parametrize("seed,odel,edel,oins,eins", [
    (0, 6, 1, 6, 1),    # bwa defaults
    (1, 5, 2, 7, 1),    # asymmetric gaps
])
def test_pallas_sw_matches_lax(seed, odel, edel, oins, eins):
    rng = np.random.default_rng(2000 + seed)
    a, b = 1, 4
    mat = make_score_matrix(a, b)
    cases = _random_sw_cases(rng, 37)
    N = len(cases)
    QMAX = max(len(q) for q, _ in cases)
    TMAX = max(len(t) for _, t in cases)
    Q = np.full((N, QMAX), 4, np.int32)
    T = np.full((N, TMAX), 4, np.int32)
    ql = np.zeros(N, np.int32)
    tl = np.zeros(N, np.int32)
    for i, (q, t) in enumerate(cases):
        Q[i, : len(q)] = q
        T[i, : len(t)] = t
        ql[i], tl[i] = len(q), len(t)
    minsc = np.full(N, 19 * a, np.int32)
    minsc[::4] = 0  # exercise both XSUBO eligibility regimes

    lax_out = sw_align_batch(jnp.asarray(Q), jnp.asarray(T),
                             jnp.asarray(ql), jnp.asarray(tl),
                             jnp.asarray(mat), jnp.asarray(minsc),
                             odel, edel, oins, eins, a)
    pal = np.asarray(sw_align_batch_gpu_stacked(
        jnp.asarray(Q), jnp.asarray(T), jnp.asarray(ql), jnp.asarray(tl),
        jnp.asarray(minsc), a, b, odel, edel, oins, eins, interpret=True))
    for ki, k in enumerate(SW_KEYS):
        np.testing.assert_array_equal(pal[ki], np.asarray(lax_out[k]),
                                      err_msg=k)


def test_pallas_sw_degenerate_lanes():
    """Zero-length / all-N lanes and the padded tail behave like lax."""
    a, b = 1, 4
    mat = make_score_matrix(a, b)
    Q = np.full((5, 16), 4, np.int32)
    T = np.full((5, 24), 4, np.int32)
    ql = np.array([0, 4, 16, 1, 8], np.int32)
    tl = np.array([8, 0, 24, 1, 8], np.int32)
    Q[1, :4] = [0, 1, 2, 3]
    Q[2, :16] = np.arange(16) % 4
    T[2, 4:20] = np.arange(16) % 4
    Q[4, :8] = 2
    T[4, :8] = 2
    minsc = np.zeros(5, np.int32)
    lax_out = sw_align_batch(jnp.asarray(Q), jnp.asarray(T),
                             jnp.asarray(ql), jnp.asarray(tl),
                             jnp.asarray(mat), jnp.asarray(minsc),
                             6, 1, 6, 1, a)
    pal = np.asarray(sw_align_batch_gpu_stacked(
        jnp.asarray(Q), jnp.asarray(T), jnp.asarray(ql), jnp.asarray(tl),
        jnp.asarray(minsc), a, b, 6, 1, 6, 1, interpret=True))
    for ki, k in enumerate(SW_KEYS):
        np.testing.assert_array_equal(pal[ki], np.asarray(lax_out[k]),
                                      err_msg=k)


def test_rescue_descriptor_path_matches_host(tiny_index):
    """sw_rescue_desc_stacked (device window gather + the DP) ==
    sw_align_batch_stacked on host-fetched windows — the two _run_sw_jobs
    arms of pipeline/pairing.py — and the GPU kernel (interpret mode) on
    the device-gathered windows agrees too."""
    from bwamem_tpu.index.device import DeviceFMIndex
    from bwamem_tpu.ops.refgather import gather_window_fast
    from bwamem_tpu.ops.swalign import (sw_align_batch_stacked,
                                        sw_rescue_desc_stacked)
    from bwamem_tpu.pipeline.options import MemOptions

    genome, idx = tiny_index
    fm = DeviceFMIndex.from_host(idx)
    opt = MemOptions()
    rng = np.random.default_rng(31)
    lp = idx.l_pac
    QMAX, TMAX = 96, 256
    N = 24
    Q = np.full((N, QMAX), 4, np.int32)
    T = np.full((N, TMAX), 4, np.int32)
    ql = np.zeros(N, np.int32)
    tl = np.zeros(N, np.int32)
    rb = np.zeros(N, np.int64)
    for i in range(N):
        l_ms = int(rng.integers(40, QMAX + 1))
        # windows on both strands, like _matesw_build produces
        strand_rev = bool(i % 2)
        span = int(rng.integers(l_ms, TMAX + 1))
        lo = lp if strand_rev else 0
        hi = 2 * lp if strand_rev else lp
        b = int(rng.integers(lo, hi - span + 1))
        mid = (b + b + span) >> 1
        b2, e2, ref, rid = idx.fetch_seq_rid(b, b + span, mid=mid)
        assert rid == 0 and e2 > b2
        # mate query: a mutated slice of the window (some rescues hit)
        off = int(rng.integers(0, max(e2 - b2 - l_ms, 0) + 1))
        q = np.asarray(ref[off : off + l_ms], np.int32).copy()
        if len(q) < l_ms:
            q = np.pad(q, (0, l_ms - len(q)), constant_values=4)
        for _ in range(int(rng.integers(0, 6))):
            q[int(rng.integers(0, l_ms))] = int(rng.integers(0, 4))
        Q[i, :l_ms] = q
        T[i, : e2 - b2] = ref
        ql[i], tl[i], rb[i] = l_ms, e2 - b2, b2
    minsc = np.full(N, opt.min_seed_len * opt.a, np.int32)
    host = np.asarray(sw_align_batch_stacked(
        jnp.asarray(Q), jnp.asarray(T), jnp.asarray(ql), jnp.asarray(tl),
        jnp.asarray(opt.mat), jnp.asarray(minsc),
        opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.a))
    desc = np.asarray(sw_rescue_desc_stacked(
        fm, jnp.asarray(Q.astype(np.int8)), jnp.asarray(ql),
        jnp.asarray(rb), jnp.asarray(tl), jnp.asarray(minsc),
        opt.a, opt.b, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, TMAX))
    np.testing.assert_array_equal(desc, host)
    kern = np.asarray(sw_align_batch_gpu_stacked(
        jnp.asarray(Q), gather_window_fast(fm, jnp.asarray(rb), TMAX),
        jnp.asarray(ql), jnp.asarray(tl), jnp.asarray(minsc), opt.a, opt.b,
        opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, interpret=True))
    np.testing.assert_array_equal(kern, host)


def test_rescue_batch_desc_equals_host(tiny_index):
    """mem_pe_rescue_batch on the descriptor arm (the product path, given
    the device index) mutates pair_regs identically to the host-window
    reference arm (no device index)."""
    import copy

    from bwamem_tpu.pipeline import pairing
    from bwamem_tpu.pipeline.aligner import MemAligner
    from bwamem_tpu.pipeline.options import MemOptions

    genome, idx = tiny_index
    rng = np.random.default_rng(77)
    seqs = []
    for i in range(24):
        isize = 300 + int(rng.integers(0, 60))
        p = int(rng.integers(0, 2000 - isize - 1))
        frag = genome[p : p + isize]
        a = frag[:80].astype(np.uint8).copy()
        b = (3 - frag[-80:])[::-1].astype(np.uint8).copy()
        if i % 4 == 0:  # shattered mate -> rescue target
            b = rng.integers(0, 4, 80, dtype=np.uint8)
        seqs += [a, b]
    al = MemAligner(MemOptions(), idx)
    per_read = al.collect_regs_batch(seqs)
    from bwamem_tpu.pipeline.regarrays import RegArrays

    if isinstance(per_read, RegArrays):
        per_read = per_read.to_lists()
    pes = pairing.mem_pestat(al.opt, idx.l_pac, per_read)
    pair_seqs = [(seqs[2 * i], seqs[2 * i + 1]) for i in range(24)]

    def regs():
        return [[copy.deepcopy(per_read[2 * i]),
                 copy.deepcopy(per_read[2 * i + 1])] for i in range(24)]

    host_regs = regs()
    n_host = pairing.mem_pe_rescue_batch(al.opt, idx, pes, pair_seqs,
                                         host_regs, dev=None)
    desc_regs = regs()
    n_desc = pairing.mem_pe_rescue_batch(al.opt, idx, pes, pair_seqs,
                                         desc_regs, dev=al.fm)
    assert n_host == n_desc and n_host > 0
    for pi in range(24):
        for e in (0, 1):
            ra, rb_ = host_regs[pi][e], desc_regs[pi][e]
            assert len(ra) == len(rb_)
            for x, y in zip(ra, rb_):
                assert (x.rb, x.re, x.qb, x.qe, x.score, x.csub) == \
                       (y.rb, y.re, y.qb, y.qe, y.score, y.csub)
