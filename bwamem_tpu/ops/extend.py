"""Batched seed extension on device — ksw-extend semantics, row-vectorized.

The plain-JAX twin of the GASAL2 extension kernel (the GPU kernel is
ops/pallas/dp_kernel.py, and must equal this). The semantics contract is the
reference's CPU decoy (reference: src/bwamem.c:1791-1908 decoy_cpu_align ->
src/ksw.c:864-988 ksw_extend2): one-sided affine-gap extension DP seeded
with h0, tracking

  * the best local cell (score, qle, tle), row max tie-broken to the LAST
    column, global max to the EARLIEST row;
  * the best to-query-end score (gscore, gtle), tie-broken to the LATEST row;
  * max_off, the largest |column - row| offset at a best-score improvement;
  * early termination when a row max hits 0, and the z-drop heuristic
    (fork default zdrop=0 disables it, reference src/bwamem.c:112).

Design: instead of the reference's per-alignment thread with a sequential
column loop, each lax.scan step processes ONE target row for ALL alignments
in the batch, with the intra-row F dependency closed in parallel:

  F(u) = max_{u' < u} ( max(M(u') - oe_ins, 0) + e_ins*u' ) - e_ins*(u-1)

i.e. a running (cumulative) max along the query axis — F never depends on H
of the same row because the recurrence separates M from H (see the eh/f
update order in ksw_extend2). That turns the whole row into a handful of
elementwise int32 ops + one cummax along the query axis.

Banding (`opt_ext`) is applied as a mask; out-of-band cells are treated as
never-computed zeros. With the fork's defaults (w=300 vs reads <= ~150 bp)
the band never binds, so this is exact; for narrow bands the right band
edge differs slightly from the reference's stale-cell behavior.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .kernels import use_gpu_kernels

NEG = jnp.int32(-0x40000000)


@dataclass(frozen=True)
class ExtendParams:
    o_del: int = 6
    e_del: int = 1
    o_ins: int = 6
    e_ins: int = 1
    w: int = 300          # band width (fork default, src/bwamem.c:109)
    zdrop: int = 0        # fork default: disabled (src/bwamem.c:112)
    end_bonus: int = 5    # = pen_clip (used in the w clamp)
    opt_ext: bool = True  # apply the band inside the DP loop
    max_mat: int = 1      # match score a / max matrix entry (w clamp)
    mismatch: int = 4     # mismatch penalty b (the GPU kernel's scoring)


def make_score_matrix(a: int = 1, b: int = 4) -> np.ndarray:
    """5x5 matrix: +a match, -b mismatch, -1 vs N
    (equivalent of bwa_fill_scmat, reference src/bwa.c:99)."""
    mat = np.full((5, 5), -b, dtype=np.int32)
    np.fill_diagonal(mat, a)
    mat[4, :] = -1
    mat[:, 4] = -1
    return mat


@partial(jax.jit, static_argnames=("params",))
def extend_batch(
    query,    # (N, QMAX) int32 codes 0..4 (pad anything)
    target,   # (N, TMAX) int32 codes 0..4
    qlen,     # (N,) int32
    tlen,     # (N,) int32
    h0,       # (N,) int32, must be > 0 for real lanes
    mat,      # (5, 5) int32
    params: ExtendParams = ExtendParams(),
):
    """Returns dict of (N,) arrays: score, qle, tle, gscore, gtle, max_off.

    qle/tle are consumed-length counts (0 = no extension), gscore = -1 when
    the query end was never reached, exactly as ksw_extend2 reports.
    """
    query = query.astype(jnp.int32)
    target = target.astype(jnp.int32)
    N, QMAX = query.shape
    TMAX = target.shape[1]
    p = params
    oe_del = p.o_del + p.e_del
    oe_ins = p.o_ins + p.e_ins

    u_ids = jnp.arange(QMAX + 1, dtype=jnp.int32)  # column = #query consumed

    # per-lane clamped band width (reference w-clamp with C truncation)
    max_ins = jnp.maximum(
        ((qlen * p.max_mat + p.end_bonus - p.o_ins) // p.e_ins + 1), 1
    )
    max_del = jnp.maximum(
        ((qlen * p.max_mat + p.end_bonus - p.o_del) // p.e_del + 1), 1
    )
    w_lane = jnp.minimum(jnp.minimum(max_ins, max_del), p.w)  # (N,)

    # first row: H(0, u) = max(h0 - o_ins - e_ins*u, 0), H(0,0) = h0
    H0 = jnp.maximum(h0[:, None] - p.o_ins - p.e_ins * u_ids[None, :], 0)
    H0 = H0.at[:, 0].set(h0)
    E0 = jnp.zeros((N, QMAX + 1), jnp.int32)

    qmask = u_ids[None, :] <= qlen[:, None]           # real columns (incl. 0)
    qcol = jnp.clip(qlen, 0, QMAX)

    # score profile S(u) per target symbol: computed per row via gather
    # query codes padded region -> force column mask anyway
    qcodes = jnp.clip(query, 0, 4)

    def row_step(carry, i):
        (H_prev, E, best, qle, tle, gscore, gtle, max_off, dead) = carry
        tchar = jnp.clip(target[:, i], 0, 4)             # (N,)
        active = jnp.logical_and(jnp.logical_not(dead), i < tlen)

        S = mat[tchar[:, None], qcodes]                  # (N, QMAX)
        Hd = H_prev[:, :-1]                              # H(i-1, u-1)
        M = jnp.where(Hd > 0, Hd + S, 0)                 # (N, QMAX) for u>=1
        M = jnp.concatenate([jnp.zeros((N, 1), jnp.int32), M], axis=1)

        if p.opt_ext:
            # band: u-1 in [i - w, i + w + 1)
            j = u_ids[None, :] - 1
            in_band = jnp.logical_and(
                j >= i - w_lane[:, None], j < i + w_lane[:, None] + 1
            )
            in_band = jnp.logical_or(in_band, u_ids[None, :] == 0)
        else:
            in_band = jnp.ones((N, QMAX + 1), jnp.bool_)
        live = jnp.logical_and(in_band, qmask)

        Mx = jnp.where(live, M, 0)
        Ex = jnp.where(live, E, 0)

        # F via running max along the query axis
        t_ins = jnp.maximum(Mx - oe_ins, 0)
        G = t_ins + p.e_ins * u_ids[None, :]
        G = G.at[:, 0].set(NEG)
        Gc = jax.lax.associative_scan(jnp.maximum, G, axis=1)
        F = jnp.maximum(
            jnp.concatenate([jnp.full((N, 1), NEG, jnp.int32), Gc[:, :-1]],
                            axis=1)
            - p.e_ins * (u_ids[None, :] - 1),
            0,
        )
        F = jnp.where(live, F, 0)

        H = jnp.maximum(jnp.maximum(Mx, Ex), F)
        # boundary column
        b0 = jnp.maximum(h0 - (p.o_del + p.e_del * (i + 1)), 0)
        H = H.at[:, 0].set(b0)

        E_next = jnp.maximum(Ex - p.e_del, jnp.maximum(Mx - oe_del, 0))
        E_next = jnp.where(live, E_next, 0)

        # row max over real columns u >= 1, tie -> LAST column
        Ht = jnp.where(jnp.logical_and(live, u_ids[None, :] >= 1), H, -1)
        rowmax = jnp.max(Ht, axis=1)
        mj = jnp.max(jnp.where(Ht == rowmax[:, None], u_ids[None, :], -1),
                     axis=1)

        # gscore (to-query-end), tie -> LATER row; only when the band
        # reaches the last query column (reference: the j == qlen test)
        h_end = jnp.take_along_axis(H, qcol[:, None], axis=1)[:, 0]
        g_upd = jnp.logical_and(active, h_end >= gscore)
        if p.opt_ext:
            g_upd = jnp.logical_and(g_upd, i + w_lane + 1 >= qlen)
        gscore = jnp.where(g_upd, h_end, gscore)
        gtle = jnp.where(g_upd, i + 1, gtle)

        # best local, strict improvement -> EARLIER row wins ties
        b_upd = jnp.logical_and(active, rowmax > best)
        best = jnp.where(b_upd, rowmax, best)
        qle = jnp.where(b_upd, mj, qle)
        tle = jnp.where(b_upd, i + 1, tle)
        max_off = jnp.where(
            b_upd, jnp.maximum(max_off, jnp.abs(mj - 1 - i)), max_off
        )

        # termination: row max 0, or z-drop (only when not improving)
        dead = jnp.logical_or(dead, jnp.logical_and(active, rowmax == 0))
        if p.zdrop > 0:
            di = i - (tle - 1)
            dj = (mj - 1) - (qle - 1)
            zd = jnp.where(
                di > dj,
                best - rowmax - (di - dj) * p.e_del > p.zdrop,
                best - rowmax - (dj - di) * p.e_ins > p.zdrop,
            )
            dead = jnp.logical_or(
                dead,
                jnp.logical_and(jnp.logical_and(active, ~b_upd), zd),
            )
        dead = jnp.logical_or(dead, i + 1 >= tlen)

        H_keep = jnp.where(active[:, None], H, H_prev)
        E_keep = jnp.where(active[:, None], E_next, E)
        return (H_keep, E_keep, best, qle, tle, gscore, gtle, max_off,
                dead), None

    init = (
        H0, E0,
        h0.astype(jnp.int32),                       # best = h0
        jnp.zeros(N, jnp.int32),                    # qle (max_j+1 with -1 init)
        jnp.zeros(N, jnp.int32),                    # tle
        jnp.full(N, -1, jnp.int32),                 # gscore
        jnp.zeros(N, jnp.int32),                    # gtle (max_ie+1)
        jnp.zeros(N, jnp.int32),                    # max_off
        tlen <= 0,                                  # dead
    )
    (_, _, best, qle, tle, gscore, gtle, max_off, _), _ = jax.lax.scan(
        row_step, init, jnp.arange(TMAX, dtype=jnp.int32)
    )
    return dict(score=best, qle=qle, tle=tle, gscore=gscore, gtle=gtle,
                max_off=max_off)


def extend_batch_auto(query, target, qlen, tlen, h0, mat, params):
    """extend_batch on the GPU kernel where ops.kernels selects it (the
    kernel scores with the bwa matrix form carried on `params`), on the
    lax twin everywhere else. Both give identical outputs."""
    if use_gpu_kernels():
        from .pallas.dp_kernel import extend_batch_gpu

        return extend_batch_gpu(query, target, qlen, tlen, h0, params)
    return extend_batch(query, target, qlen, tlen, h0, mat, params)


@partial(jax.jit, static_argnames=("params", "pen_clip"))
def extend_choose_jit(query, target, qlen, tlen, h0, mat, params,
                      pen_clip: int):
    """extend_batch_auto + end_choice fused under ONE jit, so the kernel
    wrapper's sort/pad glue and the selection run as one launch. Returns
    a stacked (3, N) array (score, qle, tle)."""
    out = extend_batch_auto(query, target, qlen, tlen, h0, mat, params)
    sc, qe, te = end_choice(out["score"], out["qle"], out["tle"],
                            out["gscore"], out["gtle"], qlen, pen_clip)
    return jnp.stack([sc, qe, te])


@partial(jax.jit,
         static_argnames=("params", "pen_clip", "qmax", "tmax"))
def extend_choose_desc_jit(fm, reads_dev, j_read, j_qstart, j_qlen,
                           j_tstart, j_tlen, j_dir, h0, mat, params,
                           pen_clip: int, qmax: int, tmax: int):
    """extend_choose_jit fed by JOB DESCRIPTORS instead of materialized
    Q/T tiles: query base i = reads_dev[j_read, j_qstart + j_dir*i],
    target base i = pac_doubled[j_tstart + j_dir*i] (device-resident
    packed genome via refgather.gather_bases, reverse strand
    complemented). Only ~20 bytes/job cross the host->device link instead
    of the materialized (N, QMAX) and (N, TMAX) tiles. The left
    job's reversal is j_dir = -1 (reference builds reversed copies
    instead, src/bwamem.c:1324-1341)."""
    from .refgather import (_extract_words_ascending, gather_window_fast,
                            pack_codes_2bit)

    B, L = reads_dev.shape
    # Word-granular window extraction: a job's bases are CONTIGUOUS in
    # its read / in the genome, so gather 16-base packed words and
    # extract in-register — ~9x fewer gather indices than the per-base
    # path.
    # A descending (left-extension, j_dir=-1) window is the static
    # column flip of the ascending window that ENDS at the start point.
    dirp = (j_dir > 0)
    arq = jnp.arange(qmax, dtype=jnp.int32)[None, :]
    qv = arq < j_qlen[:, None]
    q_words, q_nplane = pack_codes_2bit(reads_dev)
    Wr = q_words.shape[1]
    q0 = jnp.where(dirp, j_qstart, j_qstart - (qmax - 1))
    # flatten to word-table coords; windows stay within one read row for
    # all VALID columns (job construction), the rest is masked to 4 (a
    # negative or neighbor-row start only ever feeds masked columns)
    qf0 = j_read * (Wr * 16) + q0
    Qa = _extract_words_ascending(q_words.reshape(-1), qf0, qmax)
    Qn = _extract_words_ascending(q_nplane.reshape(-1), qf0, qmax)
    Qa = jnp.where(Qn > 0, 4, Qa)
    Q = jnp.where(dirp[:, None], Qa, Qa[:, ::-1])
    Q = jnp.where(qv, Q, 4)
    art = jnp.arange(tmax, dtype=jnp.int32)[None, :]
    t0 = jnp.where(dirp, j_tstart,
                   j_tstart - jnp.asarray(tmax - 1, j_tstart.dtype))
    Ta = gather_window_fast(fm, t0, tmax)
    T = jnp.where(dirp[:, None], Ta, Ta[:, ::-1])
    T = jnp.where(art < j_tlen[:, None], T, 4)
    # dtype parity with the materialized path (int8 staging)
    out = extend_batch_auto(Q.astype(jnp.int8), T.astype(jnp.int8),
                            j_qlen, j_tlen, h0, mat, params)
    sc, qe, te = end_choice(out["score"], out["qle"], out["tle"],
                            out["gscore"], out["gtle"], j_qlen, pen_clip)
    return jnp.stack([sc, qe, te])


def end_choice(score, qle, tle, gscore, gtle, qlen, pen_clip):
    """Local-vs-to-query-end selection (reference: src/bwamem.c:1887-1901).
    Returns (score, qle, tle)."""
    take_local = jnp.logical_or(gscore <= 0, gscore <= score - pen_clip)
    return (
        jnp.where(take_local, score, gscore),
        jnp.where(take_local, qle, qlen),
        jnp.where(take_local, tle, gtle),
    )
