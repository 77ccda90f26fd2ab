"""Pallas (Triton) GPU kernel for the aligner's two DPs.

One DP core, two modes:

  * extension (GASAL2's role): ksw_extend2, whose contract is the lax
    twin ops.extend.extend_batch;
  * local Smith-Waterman for mate rescue: ksw_align2, whose contract is
    the lax twin ops.swalign.sw_align_batch.

Every output field must equal the twin's.

Layout, after GASAL2 (one CUDA thread per alignment): one lane of a
program's job vector is one alignment. A program walks its target in
blocks of ROWS rows; inside a block it walks the query one column at a
time and computes the ROWS cells of that column top to bottom, so the
row-above state (H and E of the block's last row, kept in two scratch
outputs) is read and written once per ROWS rows. Everything else -- the
rows' left H, running F, row maxima and their columns -- stays in
registers. Jobs are stored column-major ((QMAX, N) query, (TMAX, N)
target), so one column load of a program's lanes is contiguous.

Scoring is the bwa matrix form (match a, mismatch -b, anything vs N =
-1), the only form the aligner builds (bwa_fill_scmat, reference
src/bwa.c:99). All arithmetic is int32.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

ROWS = 8          # target rows per block
LANES = 64        # alignments per program
NUM_WARPS = LANES // 32   # one lane per thread
NEG = -0x40000000
EXT_KEYS = ("score", "qle", "tle", "gscore", "gtle", "max_off")


def _make_kernel(local, QMAX, R, a, b, o_del, e_del, o_ins, e_ins, zdrop,
                 opt_ext):
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins

    def kernel(q_ref, t_ref, meta_ref, out_ref, rm_ref, hh_ref, ee_ref):
        # q_ref (QMAX, L) codes; t_ref (TMAXP, L) codes; meta_ref (4, L)
        # [qlen, tlen, h0, w_lane]; out_ref (8, L); rm_ref (TMAXP, L) row
        # maxima (local mode); hh_ref/ee_ref (QMAX+1, L): H and E of the
        # last row computed so far, column u holding query position u-1.
        qlen = meta_ref[0, :]
        tlen = meta_ref[1, :]
        h0 = meta_ref[2, :]
        wl = meta_ref[3, :]
        zero = qlen * 0
        qcol = jnp.minimum(qlen, QMAX)
        ncol = jnp.minimum(jnp.max(qlen), QMAX)
        tl_max = jnp.max(tlen)

        def init_col(u, c):
            if local:
                hh_ref[u, :] = zero
            else:
                hh_ref[u, :] = jnp.where(
                    u == 0, h0, jnp.maximum(h0 - o_ins - e_ins * u, 0))
            ee_ref[u, :] = zero
            return c

        jax.lax.fori_loop(0, ncol + 1, init_col, 0)
        if local:   # rows the block loop never reaches report 0
            def init_row(i, c):
                rm_ref[i, :] = zero
                return c

            jax.lax.fori_loop(0, rm_ref.shape[0], init_row, 0)

        def cell_extend(r, u, qc, tc, diag, above, e_in, f, rows):
            """ksw_extend2 cell (ops/extend.py row_step, one column)."""
            live = u <= qlen
            if opt_ext:
                live = live & (u - 1 >= rows[r] - wl) & (
                    u - 1 < rows[r] + wl + 1)
            s = jnp.where(qc == tc, a, -b)
            s = jnp.where((qc > 3) | (tc > 3), -1, s)
            mx = jnp.where(live & (diag > 0), diag + s, 0)
            ex = jnp.where(live, e_in, 0)
            h = jnp.maximum(jnp.maximum(mx, ex), jnp.where(live, f, 0))
            e_out = jnp.where(
                live, jnp.maximum(ex - e_del, jnp.maximum(mx - oe_del, 0)),
                0)
            f = jnp.maximum(f - e_ins, jnp.maximum(mx - oe_ins, 0))
            return h, e_out, f, live

        def cell_local(r, u, qc, tc, diag, above, e_in, f, rows):
            """ksw_align2 cell (ops/swalign.py _sw_forward, one column)."""
            in_q = u <= qlen
            s = jnp.where(qc == tc, a, -b)
            s = jnp.where((qc > 3) | (tc > 3), -1, s)
            e = jnp.maximum(jnp.maximum(e_in - e_del, above - oe_del), 0)
            hp = jnp.where(in_q, jnp.maximum(jnp.maximum(diag + s, e), 0),
                           0)
            h = jnp.where(in_q, jnp.maximum(hp, jnp.maximum(f, 0)), 0)
            f = jnp.maximum(f - e_ins, hp - oe_ins)
            return h, e, f, in_q

        cell = cell_local if local else cell_extend

        def block(c):
            i0, trk = c
            rows = [i0 + r for r in range(R)]
            tch = [t_ref[i, :] for i in rows]
            if local:
                b0 = [zero] * R
            else:
                b0 = [jnp.maximum(h0 - (o_del + e_del * (i + 1)), 0)
                      for i in rows]

            def col(u, cc):
                hup_prev, hl, fc, rmax, mj, hend = cc
                qc = q_ref[u - 1, :]
                e_in = ee_ref[u, :]
                hup = hh_ref[u, :]
                diag, above = hup_prev, hup
                hl2, fc2, rmax2, mj2, hend2 = [], [], [], [], []
                for r in range(R):
                    h, e_in, f, live = cell(r, u, qc, tch[r], diag, above,
                                            e_in, fc[r], rows)
                    fc2.append(f)
                    if local:   # row max, EARLIEST column wins ties
                        upd = h > rmax[r]
                        mj2.append(jnp.where(upd, u - 1, mj[r]))
                    else:       # row max over live cells, LAST column wins
                        upd = live & (h >= rmax[r])
                        mj2.append(jnp.where(upd, u, mj[r]))
                        hend2.append(jnp.where(u == qcol, h, hend[r]))
                    rmax2.append(jnp.where(upd, h, rmax[r]))
                    diag, above = hl[r], h
                    hl2.append(h)
                hh_ref[u, :] = hl2[-1]
                ee_ref[u, :] = e_in
                return (hup, tuple(hl2), tuple(fc2), tuple(rmax2),
                        tuple(mj2), tuple(hend2))

            if local:
                init = (hh_ref[0, :], tuple(b0), (zero + NEG,) * R,
                        (zero,) * R, (zero,) * R, ())
            else:
                init = (hh_ref[0, :], tuple(b0), (zero,) * R,
                        (zero - 1,) * R, (zero + QMAX,) * R,
                        tuple(jnp.where(qcol == 0, x, 0) for x in b0))
            _, _, _, rmax, mj, hend = jax.lax.fori_loop(1, ncol + 1, col,
                                                        init)
            hh_ref[0, :] = b0[-1]
            for r in range(R):
                trk = (_rows_local if local else _rows_extend)(
                    rows[r], rmax[r], mj[r], hend[r] if hend else None, trk)
                if local:
                    rm_ref[rows[r], :] = jnp.where(rows[r] < tlen, rmax[r],
                                                   0)
            return i0 + R, trk

        def _rows_extend(i, rmax, mj, hend, trk):
            """End-of-row bookkeeping of ops/extend.py row_step."""
            best, qle, tle, gscore, gtle, moff, dead = trk
            active = (dead == 0) & (i < tlen)
            g_upd = active & (hend >= gscore)
            if opt_ext:
                g_upd = g_upd & (i + wl + 1 >= qlen)
            gscore = jnp.where(g_upd, hend, gscore)
            gtle = jnp.where(g_upd, i + 1, gtle)
            b_upd = active & (rmax > best)
            best = jnp.where(b_upd, rmax, best)
            qle = jnp.where(b_upd, mj, qle)
            tle = jnp.where(b_upd, i + 1, tle)
            moff = jnp.where(b_upd, jnp.maximum(moff, jnp.abs(mj - 1 - i)),
                             moff)
            kill = active & (rmax == 0)
            if zdrop > 0:
                di = i - (tle - 1)
                dj = (mj - 1) - (qle - 1)
                zgap = jnp.where(di > dj, (di - dj) * e_del,
                                 (dj - di) * e_ins)
                kill = kill | (active & ~b_upd & (best - rmax - zgap > zdrop))
            kill = kill | (i + 1 >= tlen)
            dead = jnp.where(kill, 1, dead)
            return (best, qle, tle, gscore, gtle, moff, dead)

        def _rows_local(i, rmax, mj, hend, trk):
            """End-of-row bookkeeping of ops/swalign.py _sw_forward."""
            best, qe, te = trk
            upd = (i < tlen) & (rmax > best)
            return (jnp.where(upd, rmax, best), jnp.where(upd, mj, qe),
                    jnp.where(upd, i, te))

        if local:
            trk0 = (zero, zero - 1, zero - 1)

            def cond(c):
                return c[0] < tl_max
        else:
            trk0 = (h0, zero, zero, zero - 1, zero, zero,
                    jnp.where(tlen <= 0, zero + 1, zero))

            def cond(c):
                return (c[0] < tl_max) & (jnp.min(c[1][-1]) == 0)

        _, trk = jax.lax.while_loop(cond, block, (jnp.int32(0), trk0))
        for k, v in enumerate(trk[:6]):
            out_ref[k, :] = v

    return kernel


@partial(jax.jit, static_argnames=("local", "qmax", "params_tuple",
                                   "interpret"))
def _dp_call(qT, tT, meta, local, qmax, params_tuple, interpret):
    a, b, o_del, e_del, o_ins, e_ins, zdrop, opt_ext = params_tuple
    Np = qT.shape[1]
    TMAXP = tT.shape[0]
    kernel = _make_kernel(local, qmax, ROWS, a, b, o_del, e_del, o_ins,
                          e_ins, zdrop, opt_ext)

    def lanes(rows):
        return pl.BlockSpec((rows, LANES), lambda p: (0, p))

    rm_rows = TMAXP if local else 1
    out, rm, _, _ = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((8, Np), jnp.int32),
                   jax.ShapeDtypeStruct((rm_rows, Np), jnp.int32),
                   jax.ShapeDtypeStruct((qmax + 1, Np), jnp.int32),
                   jax.ShapeDtypeStruct((qmax + 1, Np), jnp.int32)),
        grid=(Np // LANES,),
        in_specs=[lanes(qmax), lanes(TMAXP), lanes(4)],
        out_specs=(lanes(8), lanes(rm_rows), lanes(qmax + 1),
                   lanes(qmax + 1)),
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        backend="triton",
        interpret=interpret,
        name="ksw_local" if local else "ksw_extend",
    )(qT, tT, meta)
    return out, rm


def _lanes_major(query, target, lanes_meta, order):
    """Sort jobs by `order`, pad to a multiple of LANES (padding lanes
    carry tlen 0 and are born finished) and transpose to column-major;
    target rows are padded to a multiple of ROWS with N codes."""
    N, QMAX = query.shape
    TMAX = target.shape[1]
    Np = -(-N // LANES) * LANES
    TMAXP = -(-TMAX // ROWS) * ROWS
    qT = jnp.full((QMAX, Np), 4, jnp.int32).at[:, :N].set(
        jnp.clip(query[order].astype(jnp.int32), 0, 4).T)
    tT = jnp.full((TMAXP, Np), 4, jnp.int32).at[:TMAX, :N].set(
        jnp.clip(target[order].astype(jnp.int32), 0, 4).T)
    meta = jnp.zeros((4, Np), jnp.int32).at[:, :N].set(
        jnp.stack([x.astype(jnp.int32)[order] for x in lanes_meta]))
    return qT, tT, meta


def _tlen_order(tlen):
    """Stable tlen sort (a program's lanes then finish together) and its
    inverse permutation, by scatter: XLA:GPU rewrites an argsort of a
    permutation into a scatter that fails its verifier under x64."""
    n = tlen.shape[0]
    order = jnp.argsort(tlen.astype(jnp.int32), stable=True).astype(
        jnp.int32)
    inv = jnp.zeros(n, jnp.int32).at[order].set(
        jnp.arange(n, dtype=jnp.int32))
    return order, inv


def extend_batch_gpu(query, target, qlen, tlen, h0, params, *,
                     interpret: bool = False):
    """Same contract as ops.extend.extend_batch, on the GPU kernel.
    `interpret=True` runs the kernel in the Pallas interpreter (tests)."""
    N, QMAX = query.shape
    p = params
    qlen = qlen.astype(jnp.int32)
    max_ins = jnp.maximum(
        (qlen * p.max_mat + p.end_bonus - p.o_ins) // p.e_ins + 1, 1)
    max_del = jnp.maximum(
        (qlen * p.max_mat + p.end_bonus - p.o_del) // p.e_del + 1, 1)
    w_lane = jnp.minimum(jnp.minimum(max_ins, max_del), p.w)
    order, inv = _tlen_order(tlen)
    qT, tT, meta = _lanes_major(query, target, (qlen, tlen, h0, w_lane),
                                order)
    pt = (p.max_mat, p.mismatch, p.o_del, p.e_del, p.o_ins, p.e_ins,
          p.zdrop, p.opt_ext)
    out, _ = _dp_call(qT, tT, meta, False, QMAX, pt, interpret)
    out = out[:, :N][:, inv]
    return {k: out[i] for i, k in enumerate(EXT_KEYS)}


def _sw_forward_gpu(query, target, qlen, tlen, pt, interpret):
    """(best, qe, te, rowmax (N, TMAX)) as ops.swalign._sw_forward."""
    N, QMAX = query.shape
    TMAX = target.shape[1]
    order, inv = _tlen_order(tlen)
    z = jnp.zeros_like(qlen)
    qT, tT, meta = _lanes_major(query, target, (qlen, tlen, z, z), order)
    out, rm = _dp_call(qT, tT, meta, True, QMAX, pt, interpret)
    out = out[:, :N][:, inv]
    return out[0], out[1], out[2], rm[:TMAX, :N][:, inv].T


@partial(jax.jit, static_argnames=("a", "b", "o_del", "e_del", "o_ins",
                                   "e_ins", "interpret"))
def sw_align_batch_gpu_stacked(query, target, qlen, tlen, minsc,
                               a: int, b: int, o_del: int, e_del: int,
                               o_ins: int, e_ins: int,
                               interpret: bool = False):
    """Same contract as ops.swalign.sw_align_batch_stacked (the bwa
    matrix form for `a`, `b`): one (6, N) int32 array in SW_KEYS order,
    from a forward kernel sweep, the second-best rule in plain XLA, and
    a reverse sweep over the reversed prefixes for the start
    coordinates."""
    N, QMAX = query.shape
    TMAX = target.shape[1]
    query = query.astype(jnp.int32)
    target = target.astype(jnp.int32)
    qlen = qlen.astype(jnp.int32)
    tlen = tlen.astype(jnp.int32)
    pt = (a, b, o_del, e_del, o_ins, e_ins, 0, False)
    best, qe, te, rowmax = _sw_forward_gpu(query, target, qlen, tlen, pt,
                                           interpret)
    t_ids = jnp.arange(TMAX, dtype=jnp.int32)
    halfw = (best + a - 1) // a
    outside = jnp.logical_or(t_ids[None, :] < (te - halfw)[:, None],
                             t_ids[None, :] > (te + halfw)[:, None])
    ok = jnp.logical_and(outside, rowmax >= minsc[:, None])
    score2 = jnp.max(jnp.where(ok, rowmax, 0), axis=1)
    rqlen = jnp.maximum(qe + 1, 0)
    rtlen = jnp.maximum(te + 1, 0)
    qg = qe[:, None] - jnp.arange(QMAX, dtype=jnp.int32)[None, :]
    tg = te[:, None] - t_ids[None, :]
    rquery = jnp.take_along_axis(query, jnp.clip(qg, 0, QMAX - 1), axis=1)
    rtarget = jnp.take_along_axis(target, jnp.clip(tg, 0, TMAX - 1), axis=1)
    rbest, rqe, rte, _ = _sw_forward_gpu(rquery, rtarget, rqlen, rtlen, pt,
                                         interpret)
    good = rbest == best
    qb = jnp.where(good, qe - rqe, -1)
    tb = jnp.where(good, te - rte, -1)
    return jnp.stack([best, qb, qe, tb, te, score2])
