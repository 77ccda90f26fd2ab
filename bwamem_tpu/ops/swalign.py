"""Batched local Smith-Waterman with start positions — ksw_align2 semantics.

Batched re-design of the reference's SSE striped local SW (reference:
src/ksw.c:355-612 ksw_u8/ksw_i16/ksw_align2), used by paired-end mate
rescue (reference: src/bwamem_pair.c:119-188 mem_matesw). Instead of one
SSE-striped alignment per call, the whole rescue round runs as ONE batched
launch: a lax.scan over target rows, each step elementwise work over the
(batch, query) plane with the intra-row F recurrence closed by a prefix max
(same trick as ops/extend.py, exact for affine gaps since re-opening inside
a gap never beats extending it).

Semantics (matching ksw_align2 observable behavior):
  * best = max over all cells of the local affine-gap score;
  * (te, qe) = 0-based coordinates of the best cell; ties: earliest target
    row wins (strict > on row max, reference src/ksw.c:457), earliest query
    column within the row;
  * score2 = best row-max >= minsc at a target row outside the window
    te +- ceil(score / max_match) (the KSW_XSUBO second-best rule,
    reference src/ksw.c:472-489,568-575);
  * (tb, qb) from a reverse pass over the reversed prefixes, as in
    ksw_align2's second call with KSW_XSTOP (reference src/ksw.c:594-610).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .kernels import use_gpu_kernels

NEG = jnp.int32(-0x40000000)


@partial(jax.jit, static_argnames=("o_del", "e_del", "o_ins", "e_ins"))
def _sw_forward(query, target, qlen, tlen, mat,
                o_del: int, e_del: int, o_ins: int, e_ins: int):
    """One forward local-SW sweep. Returns (best, qe, te, rowmax) where
    qe/te are 0-based inclusive end coordinates (-1 if best == 0) and
    rowmax is the (N, TMAX) per-target-row maximum (for score2)."""
    N, QMAX = query.shape
    TMAX = target.shape[1]
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins

    j_ids = jnp.arange(QMAX, dtype=jnp.int32)
    qmask = j_ids[None, :] < qlen[:, None]
    qcodes = jnp.clip(query, 0, 4)

    H0 = jnp.zeros((N, QMAX), jnp.int32)
    E0 = jnp.zeros((N, QMAX), jnp.int32)

    def row_step(carry, i):
        H_prev, E_prev, best, qe, te = carry
        active = i < tlen
        tchar = jnp.clip(target[:, i], 0, 4)
        S = mat[tchar[:, None], qcodes]                       # (N, QMAX)

        # M(j) = H(i-1, j-1) + S ; H(i-1, -1) = 0
        Hd = jnp.concatenate(
            [jnp.zeros((N, 1), jnp.int32), H_prev[:, :-1]], axis=1)
        M = Hd + S
        # E(i, j) from the FULL previous-row H (gap in target / deletion)
        E = jnp.maximum(E_prev - e_del, H_prev - oe_del)
        E = jnp.maximum(E, 0)
        Hp = jnp.maximum(jnp.maximum(M, E), 0)
        Hp = jnp.where(qmask, Hp, 0)
        # F(j) = max_{j' < j} (Hp(j') - o_ins - e_ins*(j - j')) via prefix max
        G = Hp + e_ins * j_ids[None, :]
        Gc = jax.lax.associative_scan(jnp.maximum, G, axis=1)
        F = jnp.concatenate(
            [jnp.full((N, 1), NEG, jnp.int32), Gc[:, :-1]], axis=1) \
            - e_ins * j_ids[None, :] - o_ins
        H = jnp.maximum(Hp, jnp.maximum(F, 0))
        H = jnp.where(qmask, H, 0)

        rmax = jnp.max(H, axis=1)
        # earliest column achieving the row max
        rj = jnp.min(jnp.where(H == rmax[:, None], j_ids[None, :], QMAX),
                     axis=1)
        upd = jnp.logical_and(active, rmax > best)
        best = jnp.where(upd, rmax, best)
        qe = jnp.where(upd, rj, qe)
        te = jnp.where(upd, i, te)

        H_keep = jnp.where(active[:, None], H, H_prev)
        E_keep = jnp.where(active[:, None], E, E_prev)
        rmax = jnp.where(active, rmax, 0)
        return (H_keep, E_keep, best, qe, te), rmax

    init = (H0, E0,
            jnp.zeros(N, jnp.int32),
            jnp.full(N, -1, jnp.int32),
            jnp.full(N, -1, jnp.int32))
    (_, _, best, qe, te), rowmax = jax.lax.scan(
        row_step, init, jnp.arange(TMAX, dtype=jnp.int32))
    return best, qe, te, rowmax.T  # (N, TMAX)


@partial(jax.jit,
         static_argnames=("o_del", "e_del", "o_ins", "e_ins", "max_mat"))
def sw_align_batch(query, target, qlen, tlen, mat, minsc,
                   o_del: int, e_del: int, o_ins: int, e_ins: int,
                   max_mat: int = 1):
    """Batched ksw_align2: returns dict of (N,) int32 arrays
    score, qb, qe, tb, te (ends inclusive, 0-based; -1s when score == 0)
    and score2 (0 when no qualifying second-best).

    `minsc` is the KSW_XSUBO threshold (per-lane int32): row maxima below
    it are not eligible as second-best (reference src/ksw.c:414,573).
    """
    N, QMAX = query.shape
    TMAX = target.shape[1]
    best, qe, te, rowmax = _sw_forward(query, target, qlen, tlen, mat,
                                       o_del, e_del, o_ins, e_ins)

    # score2: best row max outside te +- ceil(best / max_mat)
    t_ids = jnp.arange(TMAX, dtype=jnp.int32)
    halfw = (best + max_mat - 1) // max_mat
    outside = jnp.logical_or(t_ids[None, :] < (te - halfw)[:, None],
                             t_ids[None, :] > (te + halfw)[:, None])
    ok = jnp.logical_and(outside, rowmax >= minsc[:, None])
    score2 = jnp.max(jnp.where(ok, rowmax, 0), axis=1)

    # reverse pass over reversed prefixes query[:qe+1], target[:te+1]
    rqlen = jnp.maximum(qe + 1, 0)
    rtlen = jnp.maximum(te + 1, 0)
    qg = qe[:, None] - jnp.arange(QMAX, dtype=jnp.int32)[None, :]
    tg = te[:, None] - jnp.arange(TMAX, dtype=jnp.int32)[None, :]
    rquery = jnp.take_along_axis(query, jnp.clip(qg, 0, QMAX - 1), axis=1)
    rtarget = jnp.take_along_axis(target, jnp.clip(tg, 0, TMAX - 1), axis=1)
    rbest, rqe, rte, _ = _sw_forward(rquery, rtarget, rqlen, rtlen, mat,
                                     o_del, e_del, o_ins, e_ins)
    # start = end - reverse_end (valid whenever the reverse pass reproduces
    # the forward score; reference src/ksw.c:607-609 keeps qb/tb = -1 else)
    good = rbest == best
    qb = jnp.where(good, qe - rqe, -1)
    tb = jnp.where(good, te - rte, -1)
    return dict(score=best, qb=qb, qe=qe, tb=tb, te=te, score2=score2)


SW_KEYS = ("score", "qb", "qe", "tb", "te", "score2")


@partial(jax.jit,
         static_argnames=("o_del", "e_del", "o_ins", "e_ins", "max_mat"))
def sw_align_batch_stacked(query, target, qlen, tlen, mat, minsc,
                           o_del: int, e_del: int, o_ins: int, e_ins: int,
                           max_mat: int = 1):
    """sw_align_batch with the outputs stacked as one (6, N) array in
    SW_KEYS order INSIDE the jit: one launch + one D2H instead of an
    extra eager stack."""
    out = sw_align_batch(query, target, qlen, tlen, mat, minsc,
                         o_del, e_del, o_ins, e_ins, max_mat)
    return jnp.stack([out[k] for k in SW_KEYS])


@partial(jax.jit,
         static_argnames=("a", "b", "o_del", "e_del", "o_ins", "e_ins",
                          "tmax"))
def sw_rescue_desc_stacked(fm, query, qlen, rb, tlen, minsc,
                           a: int, b: int, o_del: int, e_del: int,
                           o_ins: int, e_ins: int, tmax: int):
    """Mate-rescue SW fed by TARGET DESCRIPTORS: each job's reference
    window [rb, rb+tlen) is gathered on-device from the packed genome
    (ops/refgather.gather_window_fast) instead of being materialized
    host-side and shipped over the host->device link (~TMAX*4 bytes/job
    vs ~12 bytes of descriptor). The DP runs on the GPU kernel where
    ops.kernels selects it, else on the lax twin. Returns the (6, N)
    stacked result in SW_KEYS order, bit-identical to
    sw_align_batch_stacked on host-fetched windows (the reference fetches the same window via
    bns_get_seq, src/bwamem_pair.c:135-147).
    """
    from .extend import make_score_matrix
    from .refgather import gather_window_fast

    target = gather_window_fast(fm, rb, tmax)
    if use_gpu_kernels():
        from .pallas.dp_kernel import sw_align_batch_gpu_stacked

        return sw_align_batch_gpu_stacked(
            query, target, qlen, tlen, minsc, a, b, o_del, e_del, o_ins,
            e_ins)
    return sw_align_batch_stacked(
        query.astype(jnp.int32), target, qlen, tlen,
        jnp.asarray(make_score_matrix(a, b)), minsc,
        o_del, e_del, o_ins, e_ins, a)
