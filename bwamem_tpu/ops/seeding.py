"""Batched SMEM seeding on device — a batched re-design of GPUSeed.

Replaces the reference's CUDA two-pass seeding (reference:
src/GPUSeed/seed_gen.cu:868-973 find_seed_intervals_fow, :977-1085
find_seed_intervals_back, :520-663 seeds_to_threads/locate_seeds_gpu) with
fixed-shape XLA programs:

  pass 1 (forward): lax.scan over read positions; per read a running FMD
    bi-interval; a candidate (segment_start, end=i, interval-before-step) is
    emitted into its per-position slot whenever the interval size changes —
    including shrink-to-zero, ambiguous bases and the read end (the
    reference restarts its walk at the failing position; we do the same via
    the restart branch).
  global compaction: all emitted candidates scatter into ONE flat pool of
    capacity B * cand_pool (cumsum + scatter — the reference uses CUB
    DeviceSelect::Flagged). Pool order is (read, end) ascending, so
    per-read segment structure survives as contiguous runs.
  pass 2 (backward): masked while_loop extending every pooled candidate
    maximally to the left. Only the k-side interval is carried (the l-side
    is never needed again), with single-code occ counts.
  containment filter: a candidate is an SMEM iff its qbeg is strictly
    below every later-ending candidate's qbeg within the same read — a
    reversed SEGMENTED exclusive cummin over the pool (replaces the
    N_SHUFFLES warp dedup + filter_seed_intervals_gpu).
  occurrence expansion: per-SMEM subsampling with stride step = s//max_occ
    capped at max_occ entries (the mem_chain rule, src/bwamem.c:426-431),
    global exclusive scan + searchsorted into a flat seed pool, then
    batched SA lookups bounded by the text-position sampling interval.

Outputs are FLAT seed arrays sorted by (read, qend, SA rank); for SMEMs
qend order equals qbeg order (SMEMs never nest).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..index.device import DeviceFMIndex
from . import fm as fmops

BIG = jnp.int32(0x3FFFFFFF)


@dataclass(frozen=True)
class SeedConfig:
    min_seed_len: int = 19
    cand_pool: int = 32    # candidate pool slots per read (global pool;
    #                        ~27/read measured at 1% error — the adaptive
    #                        retry in the aligner doubles on overflow)
    seed_pool: int = 4     # expanded-seed pool slots per read (global
    #                        pool; ~2/read typical at 1% error — the
    #                        adaptive retry doubles on overflow; the SA
    #                        walk and expansion run over B*seed_pool
    #                        lanes, so slack directly costs walk time)
    max_occ: int = 500     # subsample SMEMs above this occurrence count
    mode: str = "smem"     # "smem" (default) | "mem" (-g: keep nested MEMs,
    #                        reference GPUSeed is_smem=0 kernels,
    #                        seed_gen.cu:758-812) | "fwdmem" (-u 3:
    #                        forward-only MEMs, src/bwt.c:719 bwt_fwd_mem)
    # vanilla bwa's 2nd/3rd seeding rounds (bwa_index/bwamem.c:114-162;
    # the fork gates them off by default, src/bwamem.c:140 re_seed=0, but
    # the golden-SAM oracle methodology runs vanilla, which always
    # re-seeds — without these rounds the second-best locus at a diverged
    # repeat copy is never discovered and MAPQ/XS/XA diverge).
    reseed: bool = False   # run rounds 2+3 (smem mode only)
    split_factor: float = 1.5
    split_width: int = 10
    max_mem_intv: int = 20
    r2_pool: int = 4       # round-2 walk lanes per read (global pool)
    r2_cand: int = 8       # round-2 backward candidate slots per read
    r3_pool: int = 8       # round-3 seed slots per read
    merge_pool: int = 12   # merged-interval slots per read feeding the
    #                        final (qbeg, qend) sort: the 3 rounds'
    #                        SURVIVORS are compacted here before the
    #                        argsort, so the sort runs over ~live-count
    #                        keys instead of the 3 pools' combined width
    pair_backward: bool = False  # occ2 pair-step backward walk: halves
    #                        the serial trip chain but ~2.8x the rank
    #                        work per base; kept for A/B
    # round-2 backward-walk staged-compaction schedule ((trip, divisor)
    # pairs; see the bwdecay-fit comment at the call site). A tighter
    # schedule that undershoots a stage's survivor count is SAFE — the
    # staged compactor falls back to the full-width path for that stage
    # (lax.cond on n_alive > cap) — it just wastes the compaction.
    r2_schedule: tuple = ((3, 2), (6, 4), (9, 8), (12, 8), (16, 8))
    # round-1 walk schedule (floor-1 walks live longer: alive 46% @6
    # trips, 5% @12 on the bench simgenome — the defaults hug that)
    r1_schedule: tuple = ((6, 2), (12, 4), (16, 8))
    text_walk: bool | None = None  # unique-suffix (s==1) lanes retire to
    #                        direct text comparison. At L=150 the
    #                        (P, 16)-wide per-trip text gathers cost
    #                        more than the FM trips they save; the
    #                        win case is long reads, where FM-to-
    #                        completion is O(L) full-width trips. None =
    #                        auto: on iff the read bucket is >= 384 bp.


def _forward_pass(fm: DeviceFMIndex, reads, lens, min_seed_len,
                  emit_mode: str = "shrink"):
    """reads: (B, L) int32 codes (pad/amb = 4); lens: (B,).
    Returns candidate fields, each (B, L+1): start, k, l, s, emit.

    emit_mode "shrink": emit on every interval-size change (SMEM/mem
    candidates for the backward pass). emit_mode "segment": emit only when
    the walk dies (forward-only MEMs, reference src/bwt.c:719-769
    bwt_fwd_mem — one maximal segment per restart)."""
    B, L = reads.shape
    reads_pad = jnp.concatenate(
        [reads, jnp.full((B, 1), 4, jnp.int32)], axis=1
    )

    four = jnp.arange(4, dtype=jnp.int32)[None, :]

    def _sel4(m, c):  # m: (B, 4), c: (B,) -> m[i, c[i]] without a gather
        return jnp.where(four == c[:, None], m, 0).sum(axis=1, dtype=m.dtype)

    def step(carry, i):
        k, l, s, seg_start = carry
        base = reads_pad[:, i]
        base_c = jnp.clip(base, 0, 3)
        valid = jnp.logical_and(i < lens, base < 4)
        active = s > 0

        k4, l4, s4 = fmops.forward_ext4_batch(fm, k, l, s)
        okk = _sel4(k4, base_c)
        okl = _sel4(l4, base_c)
        oks = _sel4(s4, base_c)
        oks = jnp.where(valid, oks, 0)

        if emit_mode == "segment":
            dies = jnp.logical_and(active, oks == 0)
            emit = jnp.logical_and(dies, i - seg_start >= min_seed_len)
        else:
            shrink = jnp.logical_and(active, oks != s)
            emit = jnp.logical_and(shrink, i >= min_seed_len)
        cand = (seg_start, k, s, emit)

        ext_ok = jnp.logical_and(valid, jnp.logical_and(active, oks > 0))
        restart = jnp.logical_and(valid, jnp.logical_not(ext_ok))
        L2c = fmops._L2(fm)
        L2f = L2c[:4][None, :]
        L2n = L2c[1:5][None, :]
        ik = _sel4(jnp.broadcast_to(L2f, (B, 4)), base_c) + 1
        il = _sel4(jnp.broadcast_to(L2f, (B, 4)), 3 - base_c) + 1
        is_ = (_sel4(jnp.broadcast_to(L2n, (B, 4)), base_c)
               - (ik - 1))
        k_n = jnp.where(ext_ok, okk, jnp.where(restart, ik, 0))
        l_n = jnp.where(ext_ok, okl, jnp.where(restart, il, 0))
        s_n = jnp.where(ext_ok, oks, jnp.where(restart, is_, 0))
        seg_n = jnp.where(ext_ok, seg_start, i)
        return (k_n, l_n, s_n, seg_n), cand

    dt = fmops.idx_dt(fm)
    zi = jnp.zeros((B,), dt)
    z32 = jnp.zeros((B,), jnp.int32)
    _, cands = jax.lax.scan(
        step, (zi, zi, zi, z32), jnp.arange(L + 1, dtype=jnp.int32)
    )
    start, k, s, emit = (jnp.swapaxes(c, 0, 1) for c in cands)
    return start, k, s, emit


def _forward_pass2(fm: DeviceFMIndex, reads, lens, min_seed_len,
                   strategy: tuple | None = None):
    """2-step variant of _forward_pass over the dinucleotide pair table:
    each scan trip appends a base PAIR via ONE fused occ2 gather
    (fm.forward_ext2_batch) and emits BOTH positions' candidates, halving
    the serial trip chain. Restarts mid-pair re-enter through the
    precomputed 2-mer bi-interval table (fm.occ2_pat). Emissions are
    field-identical to _forward_pass ("shrink" mode).

    strategy=(min_len, max_intv): ALSO run the round-3 LAST-like seeding
    automaton (_seed_strategy_pass semantics) inside the same scan — its
    per-trip gather is independent of round 1's, so the two overlap
    instead of serializing as back-to-back scans would. Returns the four
    round-1 planes plus (x3, k3, s3, emit3), each (B, L), seed of
    column i ending at i + 1."""
    B, L = reads.shape
    T2 = (L + 2) // 2  # trips; positions covered: 0 .. 2*T2-1 >= L+1
    NP = 2 * T2
    reads_pad = jnp.concatenate(
        [reads, jnp.full((B, NP - L), 4, jnp.int32)], axis=1)

    four = jnp.arange(4, dtype=jnp.int32)[None, :]

    def _sel4(m, c):
        return jnp.where(four == c[:, None], m, 0).sum(axis=1, dtype=m.dtype)

    dt = fmops.idx_dt(fm)
    L2c = fmops._L2(fm)
    L2f = jnp.broadcast_to(L2c[:4][None, :], (B, 4))
    L2n = jnp.broadcast_to(L2c[1:5][None, :], (B, 4))
    patk = fm.occ2_pat[0].astype(dt)
    patl = fm.occ2_pat[1].astype(dt)
    pats = fm.occ2_pat[2].astype(dt)

    def init1(b):
        """Bi-interval of the single base b (restart)."""
        bc = jnp.clip(b, 0, 3)
        ik = _sel4(L2f, bc) + 1
        il = _sel4(L2f, 3 - bc) + 1
        is_ = _sel4(L2n, bc) - (ik - 1)
        return ik, il, is_

    def step(carry, it):
        if strategy is None:
            k, l, s, seg = carry
        else:
            k, l, s, seg, x3, k3, l3, s3 = carry
        i = 2 * it
        b1 = reads_pad[:, i]
        b2 = reads_pad[:, i + 1]
        valid1 = jnp.logical_and(i < lens, b1 < 4)
        valid2 = jnp.logical_and(i + 1 < lens, b2 < 4)
        active = s > 0

        (k1, l1, s1), (k2, l2, s2) = fmops.forward_ext2_batch(
            fm, k, l, s, b1, b2)
        if strategy is not None:
            # round-3 extension rides the same trip; independent of the
            # round-1 gather above, so the two passes overlap
            (k31, l31, s31), (k32, l32, s32) = fmops.forward_ext2_batch(
                fm, k3, l3, s3, b1, b2)

        # ---- sub-step A (position i) ----
        s1v = jnp.where(valid1, s1, 0)
        shrinkA = jnp.logical_and(active, s1v != s)
        emitA = jnp.logical_and(shrinkA, i >= min_seed_len)
        candA = (seg, k, s, emitA)
        ext1 = jnp.logical_and(valid1, jnp.logical_and(active, s1 > 0))
        restart1 = jnp.logical_and(valid1, jnp.logical_not(ext1))
        ik1, il1, is1 = init1(b1)
        kA = jnp.where(ext1, k1, jnp.where(restart1, ik1, 0))
        lA = jnp.where(ext1, l1, jnp.where(restart1, il1, 0))
        sA = jnp.where(ext1, s1, jnp.where(restart1, is1, 0))
        segA = jnp.where(ext1, seg, i)

        # ---- sub-step B (position i+1) ----
        # three sources: pair path (ext1), 2-mer table (restart1), dead
        d12 = jnp.clip(b1, 0, 3) * 4 + jnp.clip(b2, 0, 3)
        sB = jnp.where(ext1, s2, jnp.where(restart1, _sel16d(pats, d12), 0))
        kB = jnp.where(ext1, k2, jnp.where(restart1, _sel16d(patk, d12), 0))
        lB = jnp.where(ext1, l2, jnp.where(restart1, _sel16d(patl, d12), 0))
        activeB = sA > 0
        sBv = jnp.where(valid2, sB, 0)
        shrinkB = jnp.logical_and(activeB, sBv != sA)
        emitB = jnp.logical_and(shrinkB, i + 1 >= min_seed_len)
        candB = (segA, kA, sA, emitB)
        ext2 = jnp.logical_and(valid2, jnp.logical_and(activeB, sB > 0))
        restart2 = jnp.logical_and(valid2, jnp.logical_not(ext2))
        ik2, il2, is2 = init1(b2)
        kN = jnp.where(ext2, kB, jnp.where(restart2, ik2, 0))
        lN = jnp.where(ext2, lB, jnp.where(restart2, il2, 0))
        sN = jnp.where(ext2, sB, jnp.where(restart2, is2, 0))
        segN = jnp.where(ext2, segA, i + 1)
        if strategy is None:
            return (kN, lN, sN, segN), (candA, candB)

        # ---- round-3 automaton, both sub-steps (the scalar rules of
        # _seed_strategy_pass verbatim; bwa_index/bwt.c:434-455) ----
        min_len3, max_intv3 = strategy
        # (ik1/il1/is1, ik2/il2/is2 computed by round 1 above are reused)
        # sub-step A (position i)
        walkA = jnp.logical_and(valid1, x3 < i)
        emit3A = walkA & (s31 < max_intv3) & (i - x3 >= min_len3)
        cand3A = (x3, k31, s31, emit3A)
        startA = jnp.logical_and(valid1, x3 == i)
        contA3 = walkA & jnp.logical_not(emit3A)
        k3A = jnp.where(contA3, k31, jnp.where(startA, ik1, 0))
        l3A = jnp.where(contA3, l31, jnp.where(startA, il1, 0))
        s3A = jnp.where(contA3, s31, jnp.where(startA, is1, 0))
        x3A = jnp.where(jnp.logical_or(jnp.logical_not(valid1), emit3A),
                        i + 1, x3)
        # sub-step B (position i+1): pair path for contA3 lanes, 2-mer
        # table for lanes that started at i, fresh start at i+1
        d12 = jnp.clip(b1, 0, 3) * 4 + jnp.clip(b2, 0, 3)
        k3B = jnp.where(contA3, k32, jnp.where(startA,
                                               _sel16d(patk, d12), 0))
        l3B = jnp.where(contA3, l32, jnp.where(startA,
                                               _sel16d(patl, d12), 0))
        s3B = jnp.where(contA3, s32, jnp.where(startA,
                                               _sel16d(pats, d12), 0))
        walkB = jnp.logical_and(valid2, x3A < i + 1)
        emit3B = walkB & (s3B < max_intv3) & (i + 1 - x3A >= min_len3)
        cand3B = (x3A, k3B, s3B, emit3B)
        startB = jnp.logical_and(valid2, x3A == i + 1)
        contB3 = walkB & jnp.logical_not(emit3B)
        k3N = jnp.where(contB3, k3B, jnp.where(startB, ik2, 0))
        l3N = jnp.where(contB3, l3B, jnp.where(startB, il2, 0))
        s3N = jnp.where(contB3, s3B, jnp.where(startB, is2, 0))
        x3N = jnp.where(jnp.logical_or(jnp.logical_not(valid2), emit3B),
                        i + 2, x3A)
        return ((kN, lN, sN, segN, x3N, k3N, l3N, s3N),
                (candA, candB, cand3A, cand3B))

    def _sel16d(tbl, d):
        sel = (jnp.arange(16, dtype=jnp.int32)[None, :] == d[:, None])
        return jnp.where(sel, tbl[None, :], 0).sum(axis=1, dtype=tbl.dtype)

    zi = jnp.zeros((B,), dt)
    z32 = jnp.zeros((B,), jnp.int32)
    if strategy is None:
        _, (cA, cB) = jax.lax.scan(
            step, (zi, zi, zi, z32), jnp.arange(T2, dtype=jnp.int32))
    else:
        _, (cA, cB, c3A, c3B) = jax.lax.scan(
            step, (zi, zi, zi, z32, z32, zi, zi, zi),
            jnp.arange(T2, dtype=jnp.int32))

    # interleave: trip t's A is position 2t, B is 2t+1
    def weave(fa, fb):
        x = jnp.stack([fa, fb], axis=1).reshape(NP, B)
        return jnp.swapaxes(x, 0, 1)

    start, kk, ss, emit = (weave(fa, fb) for fa, fb in zip(cA, cB))
    if strategy is None:
        return start, kk, ss, emit
    x3, k3, s3, emit3 = (weave(fa, fb)[:, :L]
                         for fa, fb in zip(c3A, c3B))
    return start, kk, ss, emit, (x3, k3, s3, emit3)


def _compact_global(fields, emit, pool_size):
    """Scatter emitted entries (flat scan order) into a flat pool.
    fields: tuple of (B, N) arrays. Returns (pooled fields, read_id, valid,
    need) — `need` is the TOTAL emission count, so the caller can size a
    retry pool in one jump instead of doubling blind.

    ONE index scatter + per-field gathers (instead of one big scatter per
    field — scatters over the (B*(L+1),) emission plane were ~half the
    forward stage's time; gathers at pool size are ~5x cheaper)."""
    B, N = emit.shape
    flat_emit = emit.reshape(-1)
    dst = jnp.cumsum(flat_emit.astype(jnp.int32), dtype=jnp.int32) - 1
    ok = jnp.logical_and(flat_emit, dst < pool_size)
    # non-emitted lanes get UNIQUE out-of-bounds indices (dropped by the
    # scatter): with every index unique, XLA lowers a fully parallel
    # scatter — the old shared spill slot forced the serialized
    # duplicate-safe form
    ar = jnp.arange(B * N, dtype=jnp.int32)
    dst_u = jnp.where(ok, dst, pool_size + ar)
    src = jnp.zeros((pool_size,), jnp.int32).at[dst_u].set(
        ar, mode="drop", unique_indices=True)
    n = jnp.minimum(dst[-1] + 1, pool_size)
    valid = jnp.arange(pool_size, dtype=jnp.int32) < n
    # invalid tail slots hold field value 0 (matching the old
    # zero-initialised per-field scatters; downstream masks rely on it)
    pooled = tuple(jnp.where(valid, f.reshape(-1)[src], 0) for f in fields)
    rid = jnp.where(valid, src // N, 0)
    return pooled, rid, valid, dst[-1] + 1


def _backward_pass(fm: DeviceFMIndex, reads, rid, qbeg, k, s, valid,
                   floor=None, group=None, text_walk=True,
                   fixed_trips: int = 16,
                   compact_schedule: tuple = ((6, 2), (12, 4),
                                              (16, 8))):
    """Extend each pooled candidate maximally to the left. Flat (P,).

    floor: optional (P,) minimum interval size to keep extending
    (bwt_smem1a's min_intv — extension keeps s >= floor; default 1).
    group: optional (P,) segment key for the contained-walker early kill
    (defaults to rid; round-2 re-seed lanes pass their lane id so lanes
    of the same read never cross-kill).

    Contained-walker early kill (the reference's warp-shuffle dedup,
    seed_gen.cu:993-1066): when two candidates of the same read and same
    current left edge converge to the same interval size, the
    shorter-ending one (earlier pool slot, pool is (read, end)-ordered) is
    contained and stops walking. The final containment filter already
    guarantees it is dropped — this only saves iterations. Dead lanes also
    redirect their occ gathers to block 0 so they stop touching HBM.

    Lanes that reach s == 1 (only possible at floor 1) leave the FM loop
    and finish on the text path (_text_extend_left, same contract as
    _backward_pass2): the suffix is unique, so left-maximality is a
    direct text comparison from one SA anchor.

    This single-step walk (8-column occ rows) is the ROUND-1 hot path:
    the occ2 pair-step variant halves the serial trip chain but costs
    ~2.8x the rank work per base.

    fixed_trips: length of the no-cond window phase (callers with high
    floors — round-2 re-seed — pass fewer; their walks die early).
    compact_schedule: ((trip, divisor), ...) — at each `trip`, ALIVE
    lanes compact into a pool 1/divisor of the CURRENT width; remaining
    trips and the while tail then run at the reduced gather/rank cost.
    Dead lanes otherwise pay full work to walk nowhere, and on repeat
    genomes the tail is LONG and THIN (on the bench simgenome at B=16k:
    alive 46% @6 trips, 5% @12 — but hundreds of lanes still walking
    past trip 47 inside repeats). If a stage's
    survivors exceed its cap, a lax.cond keeps the current width and
    retries at the NEXT schedule point — never drops a lane. ()
    disables. Default hugs the measured round-1 decay (tools/bwdecay.py
    on the bench simgenome: alive/pool 0.46 @6, 0.04 @12, 0.002 @16);
    the final stage runs the whole while tail at 1/64 width.
    """
    B, L = reads.shape
    reads_flat = reads.reshape(-1)
    floor = jnp.ones_like(s) if floor is None else floor.astype(s.dtype)
    group = rid if group is None else group
    textable = jnp.logical_and(valid, floor <= 1) if text_walk else \
        jnp.zeros_like(valid)

    ext = lambda k_, s_, c_: fmops.backward_ext_ks_batch(fm, k_, s_, c_)

    # prefetch each lane's left-of-start window in ONE pass: while a
    # lane is still extending at trip t, the base it needs is exactly
    # window[:, t] (its qb only moves when it extends), so the per-trip
    # random gather becomes a column slice. Lanes that walk past the
    # window fall through to the gather path in the while tail.
    # Word-granular: the window is contiguous in the read, so extract
    # 16-base packed words (descending = static flip of the ascending
    # window ending at qbeg-1) — 1/16th the gather indices of the
    # per-element build (which was ~12.6M indices at 786k lanes).
    FT = max(int(fixed_trips), 1)  # default 16: p100 walk = 17 on
    #                    1%-error reads; the while tail handles longer
    from .refgather import _extract_words_ascending, pack_codes_2bit

    w_off = jnp.arange(FT, dtype=jnp.int32)
    r_words, r_nplane = pack_codes_2bit(reads)
    Wr16 = r_words.shape[1] * 16
    wf0 = rid * Wr16 + qbeg - FT
    w_asc = _extract_words_ascending(r_words.reshape(-1), wf0, FT)
    w_n = _extract_words_ascending(r_nplane.reshape(-1), wf0, FT)
    window = jnp.where(w_n[:, ::-1] > 0, 4, w_asc[:, ::-1])
    window = jnp.where(qbeg[:, None] - 1 - w_off[None, :] >= 0,
                       window, 4)
    P = qbeg.shape[0]

    def cond(state):
        _, _, _, done, it = state
        return jnp.logical_and(jnp.logical_not(jnp.all(done)), it < L)

    def make_body(win, rid_, floor_, group_, textable_):
        """Loop body over a (possibly compacted) lane set. win=None uses
        the exact per-lane gather path (while tail)."""
        def body(state):
            qb, kk, ss, done, it = state
            j = qb - 1
            can = jnp.logical_and(jnp.logical_not(done), j >= 0)
            if win is not None:
                base = jax.lax.dynamic_index_in_dim(
                    win, it, axis=1, keepdims=False)
            else:
                base = reads_flat[jnp.clip(rid_ * L + j, 0, B * L - 1)]
            can = jnp.logical_and(can, base < 4)
            kq = jnp.where(can, kk, 0)
            sq = jnp.where(can, ss, 1)
            nk, ns = ext(kq, sq, jnp.where(can, jnp.clip(base, 0, 3), 0))
            ok = jnp.logical_and(can, ns >= floor_)
            qb = jnp.where(ok, j, qb)
            kk = jnp.where(ok, nk, kk)
            ss = jnp.where(ok, ns, ss)
            done = jnp.logical_not(ok)
            # unique suffix: retire to the text path (_text_extend_left)
            done = jnp.logical_or(done,
                                  jnp.logical_and(textable_, ss == 1))
            # early kill: same group + same current qb + same interval as
            # a later-ending live candidate => contained. (Sound for ANY
            # same-group pair, not just original neighbours: identical
            # walk state walks identically forever, so the earlier-ending
            # lane can never strictly undercut — the containment filter
            # drops it regardless. Lane compaction therefore only makes
            # this test MORE effective.)
            nxt = lambda a: jnp.concatenate([a[1:], a[-1:]])
            same = (jnp.concatenate(
                [group_[1:], jnp.full((1,), -1, group_.dtype)]) == group_)
            same &= nxt(qb) == qb
            same &= nxt(ss) == ss
            same &= nxt(kk) == kk
            done = jnp.logical_or(done, same)
            return qb, kk, ss, done, it + 1

        return body

    done0 = jnp.logical_or(jnp.logical_not(valid),
                           jnp.logical_and(textable, s == 1))
    state = (qbeg, k, s, done0, jnp.int32(0))
    FT_L = min(FT, L)
    sched = tuple((int(t), int(d)) for t, d in (compact_schedule or ())
                  if 0 < t <= FT_L and d > 1)
    if P < 4096:
        sched = ()

    def _walk(st, trip0, win, rid_, grp_, fl_, tx_, sched_):
        """Run trips [trip0, FT) + the while tail over the current lane
        set, compacting ALIVE lanes at each remaining schedule point
        (recursive stages; each stage scatters its survivors back over
        its parent's frozen state). Returns final (qb, kk, ss) at the
        current width."""
        W = st[0].shape[0]
        body = make_body(win, rid_, fl_, grp_, tx_)
        body_t = make_body(None, rid_, fl_, grp_, tx_)
        if not sched_:
            st = jax.lax.fori_loop(trip0, FT_L,
                                   lambda _, s_: body(s_), st)
            qb, kk, ss, _, _ = jax.lax.while_loop(cond, body_t, st)
            return qb, kk, ss
        (t_next, div), rest = sched_[0], sched_[1:]
        st = jax.lax.fori_loop(trip0, t_next,
                               lambda _, s_: body(s_), st)
        cap = max(W // div, 256)
        if cap >= W:  # too narrow to be worth another stage
            return _walk(st, t_next, win, rid_, grp_, fl_, tx_, rest)

        def run_full(st):
            # survivors exceed this stage's cap (repeat-heavy batch):
            # stay at the current width but keep trying the LATER
            # schedule points — the decay curve has a fat body and a
            # thin tail, so a stage that misses by 2x at trip t usually
            # engages comfortably at the next point
            return _walk(st, t_next, win, rid_, grp_, fl_, tx_, rest)

        def run_compact(st):
            qb0, kk0, ss0, dn0, it0 = st
            org0 = jnp.arange(W, dtype=jnp.int32)
            (qbc, kkc, ssc, ridc, grpc, flc, txc, org), vc, _ = \
                _compact_flat(
                    (qb0, kk0, ss0, rid_, grp_, fl_,
                     tx_.astype(jnp.int32), org0),
                    jnp.logical_not(dn0), cap)
            stc = (qbc, kkc, ssc, jnp.logical_not(vc), it0)
            qbc, kkc, ssc = _walk(stc, t_next, win[org], ridc, grpc,
                                  flc, txc.astype(bool), rest)
            # scatter survivors back over this stage's frozen state
            # (dead lanes keep their frozen values); invalid slots get
            # unique dropped indices so the scatter stays parallel
            dstq = jnp.where(vc, org,
                             W + jnp.arange(cap, dtype=jnp.int32))

            def scat(base_arr, vals):
                return base_arr.at[dstq].set(vals, mode="drop",
                                             unique_indices=True)

            return scat(qb0, qbc), scat(kk0, kkc), scat(ss0, ssc)

        n_alive = jnp.sum(jnp.logical_not(st[3]).astype(jnp.int32))
        return jax.lax.cond(n_alive > cap, run_full, run_compact, st)

    qb, kk, ss = _walk(state, 0, window, rid, group, floor, textable,
                       sched)
    if not text_walk:
        return qb, kk, ss, jnp.full_like(kk, -1)
    to_text = jnp.logical_and(textable, ss == 1)
    qb, rdir = _text_extend_left(fm, reads, rid, qb, kk, to_text)
    return qb, kk, ss, rdir


def _text_extend_left(fm: DeviceFMIndex, reads, rid, qb, kk, to_text):
    """Finish s==1 lanes by direct text comparison.

    Once a backward walk's interval is a single row, the suffix is
    unique: left-maximality is just the longest common suffix of
    read[:qb] and text[:p0], where p0 (the lone occurrence's start) comes
    from ONE bounded SA walk. Each trip compares 16 bases with one
    independent word-granular gather per side, where the FM walk pays a
    DEPENDENT occ2 gather per 2 bases — and one long unique lane no
    longer holds the whole while_loop hostage. Conceptual twin of the
    reference's bounded SA-resolution in locate_seeds_gpu
    (src/GPUSeed/seed_gen.cu:520-663); the unique-suffix shortcut itself
    has no reference counterpart (ROADMAP item: unique-suffix text walk).

    Returns (qb_final, rbeg_direct); rbeg_direct = -1 on non-text lanes
    (their SA resolution happens in _expand_occurrences as before).
    """
    from .refgather import gather_bases

    B, L = reads.shape
    reads_flat = reads.reshape(-1)
    dt = fmops.idx_dt(fm)
    p0 = fmops.sa_lookup_batch(fm, jnp.where(to_text, kk, 0).astype(dt))
    ar = jnp.arange(16, dtype=jnp.int32)[None, :]
    max_trips = jnp.int32((L + 15) // 16 + 1)

    def cond(st):
        _, _, alive, it = st
        return jnp.logical_and(jnp.any(alive), it < max_trips)

    def body(st):
        qb_c, rb_c, alive, it = st
        tpos = rb_c[:, None].astype(dt) - 1 - ar.astype(dt)
        rpos = qb_c[:, None] - 1 - ar
        tc = gather_bases(fm, tpos)
        rc = jnp.where(
            rpos >= 0,
            reads_flat[jnp.clip(rid[:, None] * L + rpos, 0, B * L - 1)],
            4)
        ok = (alive[:, None] & (tc == rc) & (rc < 4) & (tc < 4)
              & (rpos >= 0) & (tpos >= 0))
        # matched-prefix length of this 16-base block (prefix-AND + sum)
        run = jnp.cumprod(ok.astype(jnp.int32), axis=1, dtype=jnp.int32)
        m = run.sum(axis=1, dtype=jnp.int32)
        qb_c = qb_c - jnp.where(alive, m, 0)
        rb_c = rb_c - jnp.where(alive, m, 0).astype(rb_c.dtype)
        alive = jnp.logical_and(alive, m == 16)
        return qb_c, rb_c, alive, it + 1

    qbf, rbf, _, _ = jax.lax.while_loop(
        cond, body, (qb, p0, to_text, jnp.int32(0)))
    neg1 = jnp.asarray(-1, dt)
    return (jnp.where(to_text, qbf, qb),
            jnp.where(to_text, rbf, neg1))


def _backward_pass2(fm: DeviceFMIndex, reads, rid, qbeg, k, s, valid,
                    floor=None, group=None, text_walk=True):
    """2-step variant of _backward_pass over the dinucleotide occ2 table:
    each trip prepends a base PAIR with one fused row-gather pass (half
    the serial pass chain of the per-base walk); the pair query's same
    gathered rows also yield the single-base fallback used at the walk's
    death point (odd-length extension). Post-containment-filter results
    are identical to _backward_pass; raw walks may differ only on
    early-killed (contained) lanes, whose frozen qb can never win the
    strictly-below suffix-min test against their surviving neighbour.

    Lanes that reach s == 1 (only possible at floor 1) leave the FM loop
    and finish on the text path (_text_extend_left); they return a
    direct rbeg and their k is left stale (consumers use rbeg instead).
    Early-kill interplay: a frozen s==1 lane and a walker converging on
    its state represent the same string, so the kill stays sound — and a
    `same`-killed s==1 lane still text-walks to its true maximal qb,
    where it ties (never strictly undercuts) its longer keeper and is
    dropped by the containment filter exactly as its frozen qb was.
    Returns (qbeg, k, s, rbeg_direct)."""
    B, L = reads.shape
    reads_flat = reads.reshape(-1)
    floor = jnp.ones_like(s) if floor is None else floor.astype(s.dtype)
    group = rid if group is None else group
    textable = jnp.logical_and(valid, floor <= 1)

    FT2 = 9  # pair trips in the no-cond phase (covers 18 bases; p100
    #          single-step walk = 17 on 1%-error reads)
    w_off = jnp.arange(2 * FT2, dtype=jnp.int32)
    w_idx = (rid * L + qbeg - 1)[:, None] - w_off[None, :]
    window = jnp.where(
        qbeg[:, None] - 1 - w_off[None, :] >= 0,
        reads_flat[jnp.clip(w_idx, 0, B * L - 1)], 4)

    def cond(state):
        _, _, _, done, it = state
        return jnp.logical_and(jnp.logical_not(jnp.all(done)), it < L)

    def make_body(use_window: bool):
        def body(state):
            qb, kk, ss, done, it = state
            if use_window:
                c2 = jax.lax.dynamic_index_in_dim(
                    window, 2 * it, axis=1, keepdims=False)
                c1 = jax.lax.dynamic_index_in_dim(
                    window, 2 * it + 1, axis=1, keepdims=False)
            else:
                c2 = jnp.where(
                    qb - 1 >= 0,
                    reads_flat[jnp.clip(rid * L + qb - 1, 0, B * L - 1)], 4)
                c1 = jnp.where(
                    qb - 2 >= 0,
                    reads_flat[jnp.clip(rid * L + qb - 2, 0, B * L - 1)], 4)
            alive = jnp.logical_not(done)
            can1 = alive & (qb - 1 >= 0) & (c2 < 4)
            can2 = can1 & (qb - 2 >= 0) & (c1 < 4)
            kq = jnp.where(can1, kk, 0)
            sq = jnp.where(can1, ss, 1)
            k2, s2, k1, s1 = fmops.backward_ext2_ks_batch(
                fm, kq, sq, jnp.where(can2, jnp.clip(c1, 0, 3), 0),
                jnp.where(can1, jnp.clip(c2, 0, 3), 0))
            ok2 = can2 & (s2 >= floor)
            ok1 = jnp.logical_not(ok2) & can1 & (s1 >= floor)
            qb = jnp.where(ok2, qb - 2, jnp.where(ok1, qb - 1, qb))
            kk = jnp.where(ok2, k2, jnp.where(ok1, k1, kk))
            ss = jnp.where(ok2, s2, jnp.where(ok1, s1, ss))
            # a lane survives only via the pair step; a single step is the
            # death-point fix-up (the next prepend is already known dead)
            done = jnp.logical_not(ok2)
            # unique suffix: hand the lane to the text path (maximal left
            # extension by direct comparison; see _text_extend_left)
            done = jnp.logical_or(done, jnp.logical_and(textable, ss == 1))
            # early kill: contained candidate converged with its longer
            # neighbour (same as _backward_pass)
            nxt = lambda a: jnp.concatenate([a[1:], a[-1:]])
            same = (jnp.concatenate(
                [group[1:], jnp.full((1,), -1, group.dtype)]) == group)
            same &= nxt(qb) == qb
            same &= nxt(ss) == ss
            same &= nxt(kk) == kk
            done = jnp.logical_or(done, same)
            return qb, kk, ss, done, it + 1

        return body

    done0 = jnp.logical_or(jnp.logical_not(valid),
                           jnp.logical_and(textable, s == 1))
    state = (qbeg, k, s, done0, jnp.int32(0))
    state = jax.lax.fori_loop(
        0, min(FT2, (L + 1) // 2), lambda _, st: make_body(True)(st), state)
    qb, kk, ss, _, _ = jax.lax.while_loop(cond, make_body(False), state)
    if not text_walk:
        return qb, kk, ss, jnp.full_like(kk, -1)
    to_text = jnp.logical_and(textable, ss == 1)
    qb, rdir = _text_extend_left(fm, reads, rid, qb, kk, to_text)
    return qb, kk, ss, rdir


def _segmented_suffix_min(v, seg):
    """For each i: min(v[j] for j > i with seg[j] == seg[i]) (exclusive),
    BIG if none. v, seg: (P,) int32."""
    vr = v[::-1]
    sr = seg[::-1]

    def op(a, b):
        av, ag = a
        bv, bg = b
        return jnp.where(bg == ag, jnp.minimum(av, bv), bv), bg

    mv, _ = jax.lax.associative_scan(op, (vr, sr))
    inc = mv[::-1]  # inclusive suffix min within segment
    nxt_v = jnp.concatenate([inc[1:], jnp.full((1,), BIG, v.dtype)])
    nxt_g = jnp.concatenate([seg[1:], jnp.full((1,), -1, seg.dtype)])
    return jnp.where(nxt_g == seg, nxt_v, BIG)


def _containment_filter(qbeg, qend, rid, valid, min_seed_len):
    q = jnp.where(valid, qbeg, BIG)
    seg = jnp.where(valid, rid, -2)
    suff = _segmented_suffix_min(q, seg)
    keep = jnp.logical_and(valid, qbeg < suff)
    return jnp.logical_and(keep, (qend - qbeg) >= min_seed_len)


def _dup_filter(qbeg, rid, s, valid, qend, min_seed_len):
    """mem mode (-g): keep nested MEMs; drop only adjacent duplicates with
    the same (read, qbeg) and the same interval size (reference:
    filter_seed_intervals_gpu_mem, seed_gen.cu:783-812; the count
    subtraction of nested occurrence lists is skipped — duplicate
    occurrences are contained seeds, absorbed by chaining's containment
    test, src/bwamem.c:342-345)."""
    nxt_rid = jnp.concatenate([rid[1:], jnp.full((1,), -1, rid.dtype)])
    nxt_qb = jnp.concatenate([qbeg[1:], jnp.full((1,), -1, qbeg.dtype)])
    nxt_s = jnp.concatenate([s[1:], jnp.zeros((1,), s.dtype)])
    dup = (nxt_rid == rid) & (nxt_qb == qbeg) & (nxt_s == s)
    keep = jnp.logical_and(valid, jnp.logical_not(dup))
    return jnp.logical_and(keep, (qend - qbeg) >= min_seed_len)


def _sel4m(m, c):
    """m: (P, 4), c: (P,) in 0..3 -> m[i, c[i]] without a gather."""
    four = jnp.arange(4, dtype=jnp.int32)[None, :]
    return jnp.where(four == c[:, None], m, 0).sum(axis=1, dtype=m.dtype)


def _init_single(fm, base):
    """Bi-interval of a single base code per lane (bwt_set_intv)."""
    bc = jnp.clip(base, 0, 3)
    P = base.shape[0]
    L2c = fmops._L2(fm)
    L2f = jnp.broadcast_to(L2c[:4][None, :], (P, 4))
    L2n = jnp.broadcast_to(L2c[1:5][None, :], (P, 4))
    k = _sel4m(L2f, bc) + 1
    l = _sel4m(L2f, 3 - bc) + 1
    s = _sel4m(L2n, bc) - (k - 1)
    return k, l, s


def _compact_flat(fields, emit, cap):
    """1-D _compact_global: compact flat emissions into a pool of `cap`.
    Returns (pooled, valid, need) with `need` the total emission count."""
    P = emit.shape[0]
    dst = jnp.cumsum(emit.astype(jnp.int32), dtype=jnp.int32) - 1
    ok = jnp.logical_and(emit, dst < cap)
    ar = jnp.arange(P, dtype=jnp.int32)
    # unique OOB indices for dropped lanes -> parallel scatter lowering
    dst_u = jnp.where(ok, dst, cap + ar)
    src = jnp.zeros((cap,), jnp.int32).at[dst_u].set(
        ar, mode="drop", unique_indices=True)
    n = jnp.minimum(dst[-1] + 1, cap)
    valid = jnp.arange(cap, dtype=jnp.int32) < n
    pooled = tuple(jnp.where(valid, f[src], 0) for f in fields)
    return pooled, valid, dst[-1] + 1


def _seed_strategy_pass(fm, reads, lens, min_len: int, max_intv: int):
    """Vanilla round-3 LAST-like seeding as one forward lax.scan
    (bwt_seed_strategy1 under the mem_collect_intv restart loop,
    reference tree: bwa_index/bwt.c:434-455, bwa_index/bwamem.c:144-158).

    Per read a single walk from x: the first position where the extended
    interval drops below max_intv with match length > min_len emits ONE
    seed [x, i+1) and restarts at i+1. N bases restart without emitting;
    a dead interval keeps walking until the length gate fires, emitting
    an empty seed the caller filters with s > 0 (the scalar code's exact
    restart arithmetic — later seeds depend on it).

    Returns (x, k, s, emit) planes of shape (B, L); column i's seed ends
    at i + 1."""
    B, L = reads.shape
    dt = fmops.idx_dt(fm)

    def step(carry, i):
        x, k, l, s = carry
        b = reads[:, i]
        bc = jnp.clip(b, 0, 3)
        validb = jnp.logical_and(i < lens, b < 4)
        walking = jnp.logical_and(validb, x < i)
        k4, l4, s4 = fmops.forward_ext4_batch(fm, k, l, s)
        kn = _sel4m(k4, bc)
        ln = _sel4m(l4, bc)
        sn = _sel4m(s4, bc)
        emit = walking & (sn < max_intv) & (i - x >= min_len)
        cand = (x, kn, sn, emit)
        is_start = jnp.logical_and(validb, x == i)
        ik, il, is_ = _init_single(fm, b)
        cont = walking & jnp.logical_not(emit)
        k2 = jnp.where(cont, kn, jnp.where(is_start, ik, 0))
        l2 = jnp.where(cont, ln, jnp.where(is_start, il, 0))
        s2 = jnp.where(cont, sn, jnp.where(is_start, is_, 0))
        x2 = jnp.where(jnp.logical_or(jnp.logical_not(validb), emit),
                       i + 1, x)
        return (x2, k2, l2, s2), cand

    z = jnp.zeros((B,), dt)
    _, cands = jax.lax.scan(
        step, (jnp.zeros((B,), jnp.int32), z, z, z),
        jnp.arange(L, dtype=jnp.int32))
    return tuple(jnp.swapaxes(c, 0, 1) for c in cands)


def _reseed_forward(fm, reads, lens, lrid, lx, lfloor, lvalid,
                    min_seed_len: int):
    """Round-2 split re-seed forward walks (vanilla bwt_smem1a's forward
    loop with min_intv = parent occ + 1 from the parent SMEM's midpoint,
    reference tree: bwa_index/bwamem.c:133-141, bwa_index/bwt.c:381-394).

    One lane per qualifying parent SMEM. A while_loop with all-dead early
    exit (floors are >= 2, so walks die in tens of steps, not L); each
    trip appends one base and records a candidate (k/s before the step,
    end = current position) whenever the interval size changes —
    including the end-of-walk push at read end, N bases and below-floor
    death, exactly the scalar push rules.

    On occ2 indexes each trip appends a base PAIR from ONE fused gather
    (fmops.forward_ext2_batch, the same trick as the round-1 scan),
    emitting both positions' candidates — half the serial trip chain;
    the per-base body remains for indexes without the pair table.

    Emissions are TRIP-INDEXED: a trip at relative offset j can emit at
    most one candidate per position, and it owns column j of the
    (R, L+2) slot plane outright, so the write is one O(R)
    dynamic-slice column per position instead of an (R, E) one-hot pass
    per trip. The plane always fits every
    possible emission, which also retires the r2_emit pool knob and its
    whole overflow-retry/recompile class.

    Returns (kb, sb, eb, filled): (R, L+2) candidate planes in
    (lane, end)-ascending order; filled marks real emissions."""
    R = lrid.shape[0]
    B, L = reads.shape
    reads_flat = reads.reshape(-1)
    dt = fmops.idx_dt(fm)
    lens_l = lens[lrid]
    b0 = jnp.where(lvalid,
                   reads_flat[jnp.clip(lrid * L + lx, 0, B * L - 1)], 4)
    k0, l0, s0 = _init_single(fm, b0)
    alive0 = lvalid & (b0 < 4) & (lx < lens_l)
    T = L + 2  # columns indexed by relative trip offset j in [1, L+1]
    lfloor = lfloor.astype(dt)

    def cond(st):
        j, _, _, _, alive = st[:5]
        return jnp.logical_and(jnp.any(alive), j <= L)

    # word-granular walk-window prefetch: the walk reads positions
    # lx+1..lx+L in order, so extract each lane's window once (~10
    # word-gathers/lane) and make the per-trip fetch a column slice
    from .refgather import _extract_words_ascending, pack_codes_2bit

    r_words, r_nplane = pack_codes_2bit(reads)
    Wr16 = r_words.shape[1] * 16
    wf0 = lrid * Wr16 + lx + 1
    w_b = _extract_words_ascending(r_words.reshape(-1), wf0, L + 1)
    w_nf = _extract_words_ascending(r_nplane.reshape(-1), wf0, L + 1)
    win = jnp.where(w_nf > 0, 4, w_b)

    def fetch(i, j):
        col = jax.lax.dynamic_index_in_dim(win, j - 1, axis=1,
                                           keepdims=False)
        return jnp.where(i < lens_l, col, 4)

    def push(kb, sb, eb, fill, j, emit, kv, sv, ev):
        z = jnp.zeros_like(j)
        upd = lambda a, v: jax.lax.dynamic_update_slice(
            a, jnp.where(emit, v, 0).astype(a.dtype)[:, None], (z, j))
        return (upd(kb, kv), upd(sb, sv), upd(eb, ev),
                jax.lax.dynamic_update_slice(fill, emit[:, None], (z, j)))

    def body(st):
        j, k, l, s, alive, kb, sb, eb, fill = st
        i = lx + j
        b = fetch(i, j)
        validb = (i < lens_l) & (b < 4)
        k4, l4, s4 = fmops.forward_ext4_batch(fm, k, l, s)
        bc = jnp.clip(b, 0, 3)
        kn = _sel4m(k4, bc)
        ln = _sel4m(l4, bc)
        sn = jnp.where(validb & alive, _sel4m(s4, bc), 0)
        emit = alive & (sn != s) & (i >= min_seed_len)
        kb, sb, eb, fill = push(kb, sb, eb, fill, j, emit, k, s, i)
        alive2 = alive & validb & (sn >= lfloor)
        k = jnp.where(alive2, kn, k)
        l = jnp.where(alive2, ln, l)
        s = jnp.where(alive2, sn, s)
        return j + 1, k, l, s, alive2, kb, sb, eb, fill

    def body2(st):
        j, k, l, s, alive, kb, sb, eb, fill = st
        i1 = lx + j
        i2 = i1 + 1
        b1 = fetch(i1, j)
        b2 = fetch(i2, j + 1)
        v1 = (i1 < lens_l) & (b1 < 4)
        v2 = (i2 < lens_l) & (b2 < 4)
        (k1, l1, s1), (k2, l2, s2) = fmops.forward_ext2_batch(
            fm, k, l, s, jnp.clip(b1, 0, 3), jnp.clip(b2, 0, 3))
        # sub-step 1 (position i1): emit against the pre-pair state
        s1n = jnp.where(v1 & alive, s1, 0)
        emit1 = alive & (s1n != s) & (i1 >= min_seed_len)
        kb, sb, eb, fill = push(kb, sb, eb, fill, j, emit1, k, s, i1)
        alive1 = alive & v1 & (s1n >= lfloor)
        # sub-step 2 (position i2): only lanes that survived sub-step 1
        s2n = jnp.where(v2 & alive1, s2, 0)
        emit2 = alive1 & (s2n != s1n) & (i2 >= min_seed_len)
        kb, sb, eb, fill = push(kb, sb, eb, fill, j + 1, emit2, k1, s1n,
                                i2)
        alive2 = alive1 & v2 & (s2n >= lfloor)
        # freeze-on-death: a lane dead at sub-step 1 keeps the pre-pair
        # state; dead at sub-step 2 keeps the after-one-append state
        k = jnp.where(alive2, k2, jnp.where(alive1, k1, k))
        l = jnp.where(alive2, l2, jnp.where(alive1, l1, l))
        s = jnp.where(alive2, s2n, jnp.where(alive1, s1n, s))
        return j + 2, k, l, s, alive2, kb, sb, eb, fill

    st = (jnp.int32(1), k0, l0, s0, alive0,
          jnp.zeros((R, T), dt), jnp.zeros((R, T), dt),
          jnp.zeros((R, T), jnp.int32), jnp.zeros((R, T), bool))
    st = jax.lax.while_loop(cond, body2 if fm.has_occ2 else body, st)
    _, _, _, _, _, kb, sb, eb, fill = st
    return kb, sb, eb, fill


def _expand_occurrences(fm, rid, qbeg, qend, k, s, keep, pool_size,
                        max_occ, rdir=None):
    """rdir: optional (P,) direct rbeg for unique candidates finished on
    the text path (_text_extend_left) — their k is stale, so the SA walk
    result is overridden by the known occurrence start. -1 = resolve via
    SA as usual (such lanes always have count == 1, so only off == 0
    slots can carry a direct value)."""
    P = qbeg.shape[0]
    s_v = jnp.where(keep, s, 0)
    step = jnp.where(s_v > max_occ, s_v // max_occ, 1)
    count = jnp.where(s_v > 0, (s_v + step - 1) // step, 0)
    count = jnp.minimum(count, max_occ).astype(jnp.int32)
    cum = jnp.cumsum(count, dtype=jnp.int32)
    total = cum[-1]
    cum_excl = cum - count

    t = jnp.arange(pool_size, dtype=jnp.int32)
    # slot -> candidate mapping via scatter + cummax (searchsorted costs
    # ~log2(P) dependent gather passes; this is two passes). Group-head
    # slots are unique (cum_excl strictly increases when count > 0), so a
    # plain .set scatter suffices.
    idx = jnp.arange(P, dtype=jnp.int32)
    # unique indices -> parallel scatter lowering: live in-bounds writes
    # use the (strictly increasing) cum_excl; everything else (empty
    # groups, overflow past the pool) gets a unique index in the
    # disjoint dropped range [pool_size, pool_size + P)
    in_b = jnp.logical_and(count > 0, cum_excl < pool_size)
    dst = jnp.where(in_b, cum_excl, pool_size + idx)
    marks = jnp.zeros(pool_size, jnp.int32).at[dst].set(
        idx + 1, mode="drop", unique_indices=True)
    cand = jax.lax.associative_scan(jnp.maximum, marks) - 1
    cand = jnp.clip(cand, 0, P - 1)
    seed_valid = t < jnp.minimum(total, pool_size)
    # ONE fused row gather serves every per-candidate field
    if rdir is None:
        rdir = jnp.full_like(k, -1)
    tbl = jnp.stack(
        [cum_excl.astype(k.dtype), k, step.astype(k.dtype),
         rid.astype(k.dtype), qbeg.astype(k.dtype), qend.astype(k.dtype),
         s.astype(k.dtype), rdir.astype(k.dtype)], axis=1)
    got = tbl[cand]
    off = t - got[:, 0].astype(jnp.int32)
    rows = jnp.where(seed_valid, got[:, 1] + off.astype(k.dtype) * got[:, 2],
                     k.dtype.type(0))
    fields = {"rid": got[:, 3].astype(jnp.int32),
              "qbeg": got[:, 4].astype(jnp.int32),
              "qend": got[:, 5].astype(jnp.int32),
              "s": got[:, 6]}
    g = lambda a: a[cand]
    # NOTE: the 2-step SA walk (fmops.sa_lookup2_batch) trades an extra
    # occ2-row gather per trip for a halved trip count at sa_intv=8, so
    # SA resolution stays single-step even when the pair table exists.
    rbeg = fmops.sa_lookup_batch(fm, rows)
    rbeg = jnp.where(got[:, 7] >= 0, got[:, 7], rbeg)
    return dict(
        read_id=jnp.where(seed_valid, fields["rid"], -1),
        rbeg=jnp.where(seed_valid, rbeg, -1),
        qbeg=jnp.where(seed_valid, fields["qbeg"], -1),
        qend=jnp.where(seed_valid, fields["qend"], -1),
        n_occ=jnp.where(seed_valid, fields["s"], 0),
        valid=seed_valid,
        n_seeds=jnp.minimum(total, pool_size),
        overflow=total > pool_size,
        need=total,
    )


@partial(jax.jit,
         static_argnames=("seed_len", "stride", "inexact", "seed_pool",
                          "max_occ", "ktab_k"))
def bowtie_seed_batch(fm: DeviceFMIndex, reads, lens, seed_len: int,
                      stride: int, inexact: bool, seed_pool: int = 24,
                      max_occ: int = 500, ktab=None, ktab_k: int = 0):
    """Fixed-length exact (or <=1-mismatch) seeds at a start stride — the
    -u 2 / -u 4 seed types (reference: src/bwt.c:593-624 bwt_bowtie_seed,
    :627-718 bwt_bowtie_seed_inexact; dispatch src/bwamem.c:242-255 with
    x += seed_intv).

    The reference explores 1-mismatch alternatives with a LIFO stack per
    start (latest position, then highest base wins); here every
    (mismatch-position, base) branch walks in parallel as one more lane in
    the (start, candidate) plane and the winner is an argmax over the same
    priority key — no stack, no divergence.
    """
    reads = reads.astype(jnp.int32)
    lens = lens.astype(jnp.int32)
    B, L = reads.shape
    S = max((L - seed_len) // stride + 1, 1)
    NL = B * S
    rid = jnp.repeat(jnp.arange(B, dtype=jnp.int32), S)
    x0 = jnp.tile(jnp.arange(S, dtype=jnp.int32) * stride, B)
    lane_ok = x0 + seed_len <= lens[rid]

    if inexact:
        tj = jnp.arange(seed_len * 3, dtype=jnp.int32)
        ct = jnp.concatenate([tj // 3, jnp.full((1,), -1, jnp.int32)])
        cj = jnp.concatenate([tj % 3, jnp.zeros((1,), jnp.int32)])
    else:
        ct = jnp.full((1,), -1, jnp.int32)  # exact only
        cj = jnp.zeros((1,), jnp.int32)
    C = ct.shape[0]

    reads_flat = reads.reshape(-1)

    def base_at(off):
        return reads_flat[jnp.clip(rid * L + x0 + off, 0, B * L - 1)]

    def chosen_base(rb, t):
        """Candidate's base at offset t: the read base, or (at its own
        mismatch offset) the cj-th base != read base."""
        alt = cj[None, :] + (cj[None, :] >= rb[:, None]).astype(jnp.int32)
        return jnp.where(ct[None, :] == t, alt,
                         jnp.broadcast_to(rb[:, None], (NL, C)))

    if ktab is not None and 1 < ktab_k < seed_len:
        # jump the first K steps with one table-row gather (precomputed
        # K-mer bi-intervals, fmops.kmer_intv_table): exact here because
        # fixed-length seeds emit nothing before the final interval.
        # Every candidate (incl. mismatch branches inside the prefix)
        # looks up its own chosen-base code.
        code = jnp.zeros((NL, C), jnp.int32)
        ok0 = lane_ok[:, None]
        for t in range(ktab_k):
            rb = base_at(t)
            ok0 = ok0 & (rb < 4)[:, None]
            code = code * 4 + jnp.clip(chosen_base(rb, t), 0, 3)
        row = ktab[code.reshape(-1)].reshape(NL, C, 3)
        k, l, s = row[..., 0], row[..., 1], row[..., 2]
        alive = ok0 & (s >= 1)
        t_start = ktab_k
    else:
        rb0 = base_at(0)
        ch0 = chosen_base(rb0, 0)
        L2c = fmops._L2(fm)
        k = L2c[ch0] + 1
        l = L2c[3 - ch0] + 1
        s = L2c[ch0 + 1] - L2c[ch0]
        alive = (lane_ok & (rb0 < 4))[:, None] & (s >= 1)
        t_start = 1

    def step(carry, t):
        k, l, s, alive = carry
        rb = base_at(t)
        ch = chosen_base(rb, t)
        kf, lf, sf = (a.reshape(-1) for a in (k, l, s))
        k4, l4, s4 = fmops.forward_ext4_batch(
            fm,
            jnp.where(alive.reshape(-1), kf, 0),
            jnp.where(alive.reshape(-1), lf, 0),
            jnp.where(alive.reshape(-1), sf, 1))
        chf = jnp.clip(ch.reshape(-1), 0, 3)
        take = lambda a: jnp.take_along_axis(
            a, chf[:, None], axis=1)[:, 0].reshape(NL, C)
        kn, ln, sn = take(k4), take(l4), take(s4)
        alive = alive & (rb < 4)[:, None] & (sn >= 1)
        k = jnp.where(alive, kn, k)
        l = jnp.where(alive, ln, l)
        s = jnp.where(alive, sn, s)
        return (k, l, s, alive), None

    (k, l, s, alive), _ = jax.lax.scan(
        step, (k, l, s, alive),
        jnp.arange(t_start, seed_len, dtype=jnp.int32))

    # priority: exact first (reference returns before touching the stack),
    # else latest mismatch position, then highest alternate base (LIFO)
    prio = jnp.where(ct[None, :] < 0, BIG, ct[None, :] * 4 + cj[None, :])
    prio = jnp.where(alive, prio, -1)
    best = jnp.argmax(prio, axis=1)
    any_ok = jnp.max(prio, axis=1) >= 0
    g = lambda a: jnp.take_along_axis(a, best[:, None], axis=1)[:, 0]
    out = _expand_occurrences(
        fm, rid, x0, x0 + seed_len, g(k), g(s), any_ok,
        B * seed_pool, max_occ)
    cap = B * seed_pool
    out["over_mult"] = (out["need"].astype(jnp.int32) + (cap - 1)) // cap
    return out


@partial(jax.jit, static_argnames=("cfg",))
def smem_seed_batch_stacked(fm: DeviceFMIndex, reads, lens,
                            cfg: "SeedConfig"):
    """smem_seed_batch with the output pool pre-stacked on device so the
    host fetch is a single coalesced D2H with no eager stacking
    dispatches. The head row packs the scalars
    [n_seeds, overflow, over_mult, mults x 6, needs x 6] into its first
    lanes (a second tiny D2H costs a full round-trip, so the scalars ride
    in a pool row).

    Two formats, chosen statically (the aligner's fetch dispatches on
    row count):
      * packed v3 (3, P+5) int32 — narrow indexes with B <= 2^15,
        L < 2^15, max_occ < 2^16:
        [read_id<<16|min(n_occ,0xFFFF), qbeg<<16|qend, rbeg] data rows
        with the 15 head scalars column-major in the first 5 lanes of
        each row. n_occ is only ever COMPARED against max_occ
        downstream (frac_rep, native/chain.cpp:137-152), so the 16-bit
        clamp is exact while max_occ < 0xFFFF. Valid slots are a
        PREFIX (slot < n_seeds; _expand_occurrences emits prefixes),
        so no invalid row is copied, and ONE prefix slice carries
        scalars + seeds (the aligner's speculative one-shot fetch).
        ~57% fewer D2H bytes than the wide format.
      * wide (7, P) int64 — genomes needing >31-bit rbeg or huge
        L/B/max_occ: the original unpacked rows + valid row.
    """
    out = smem_seed_batch(fm, reads, lens, cfg)
    dt = out["rbeg"].dtype
    B, L = reads.shape
    P = out["rbeg"].shape[0]

    def head_into(row):
        row = row.at[0].set(out["n_seeds"].astype(row.dtype))
        row = row.at[1].set(out["overflow"].astype(row.dtype))
        row = row.at[2].set(out["over_mult"].astype(row.dtype))
        row = jax.lax.dynamic_update_slice(
            row, out["mults"].astype(row.dtype), (3,))
        nf = out["mults"].shape[0]
        return jax.lax.dynamic_update_slice(
            row, out["needs"].astype(row.dtype), (3 + nf,))

    if dt == jnp.int32 and B <= 0x8000 and L <= 0x7FFF \
            and cfg.max_occ < 0xFFFF:
        # packed v3 (3, P + 5): the 15 head scalars ride COLUMN-MAJOR in
        # the first 5 lanes of the 3 data rows (scalar j at row j%3,
        # lane j//3), so a single prefix slice raw[:, :5+nf] carries the
        # scalars AND the first nf seeds with zero wasted rows — the
        # aligner's speculative one-shot prefix fetch depends on this
        # (a separate head row costs either a second round-trip or a
        # wider transfer).
        nf = out["mults"].shape[0]
        head15 = jnp.stack(
            [out["n_seeds"].astype(jnp.int32),
             out["overflow"].astype(jnp.int32),
             out["over_mult"].astype(jnp.int32)]
            + [out["mults"][i].astype(jnp.int32) for i in range(nf)]
            + [out["needs"][i].astype(jnp.int32) for i in range(nf)])
        hdr = head15.reshape(5, 3).T
        qpack = (jnp.maximum(out["qbeg"], 0) << 16) | \
            (out["qend"] & 0xFFFF)
        ridocc = (out["read_id"].astype(jnp.int32) << 16) | \
            jnp.minimum(out["n_occ"], 0xFFFF).astype(jnp.int32)
        data = jnp.stack([
            ridocc,
            qpack.astype(jnp.int32),
            out["rbeg"].astype(jnp.int32),
        ])
        return jnp.concatenate([hdr, data], axis=1)
    pool = jnp.stack(
        [out[k].astype(dt)
         for k in ("read_id", "qbeg", "qend", "rbeg", "n_occ")]
        + [out["valid"].astype(dt),
           head_into(jnp.zeros((P,), dt))])
    return pool


@partial(jax.jit, static_argnames=("cfg",))
def smem_seed_batch(fm: DeviceFMIndex, reads, lens,
                    cfg: SeedConfig = SeedConfig()):
    """End-to-end batched seeding.

    reads: (B, L) int32 base codes (amb/pad = 4); lens: (B,) int32.
    Returns FLAT pooled seed arrays (size B*seed_pool) sorted by
    (read, qend, SA rank): read_id, rbeg (doubled coords, like the
    reference's mem_seed_v_gpu, seed_gen.h:69-76), qbeg, qend, n_occ,
    valid + scalars n_seeds / overflow.
    """
    reads = reads.astype(jnp.int32)
    lens = lens.astype(jnp.int32)
    B, L = reads.shape
    emit_mode = "segment" if cfg.mode == "fwdmem" else "shrink"
    fuse_r3 = (cfg.reseed and cfg.mode == "smem" and cfg.max_mem_intv > 0
               and fm.has_occ2 and emit_mode == "shrink")
    r3_planes = None
    if fm.has_occ2 and emit_mode == "shrink":
        out_fwd = _forward_pass2(
            fm, reads, lens, cfg.min_seed_len,
            strategy=((cfg.min_seed_len, cfg.max_mem_intv)
                      if fuse_r3 else None))
        if fuse_r3:
            start, k, s, emit, r3_planes = out_fwd
        else:
            start, k, s, emit = out_fwd
    else:
        start, k, s, emit = _forward_pass(fm, reads, lens,
                                          cfg.min_seed_len, emit_mode)
    NP = emit.shape[1]
    end = jnp.broadcast_to(jnp.arange(NP, dtype=jnp.int32), (B, NP))
    cand_cap = B * cfg.cand_pool
    (start, end, k, s), rid, valid, c_need = _compact_global(
        (start, end, k, s), emit, cand_cap)
    if cfg.mode == "fwdmem":
        # forward-only MEMs: no left extension, segments are disjoint
        qbeg = start
        rdir = jnp.full_like(k, -1)
        keep = jnp.logical_and(valid,
                               end - qbeg >= cfg.min_seed_len)
    else:
        bw = (_backward_pass2 if fm.has_occ2 and cfg.pair_backward
              else _backward_pass)
        tw = cfg.text_walk if cfg.text_walk is not None else (L >= 384)
        kw1 = ({} if bw is _backward_pass2
               else dict(compact_schedule=cfg.r1_schedule))
        qbeg, k, s, rdir = bw(fm, reads, rid, start, k, s, valid,
                              text_walk=tw, **kw1)
        if cfg.mode == "mem":
            keep = _dup_filter(qbeg, rid, s, valid, end, cfg.min_seed_len)
        else:
            keep = _containment_filter(qbeg, end, rid, valid,
                                       cfg.min_seed_len)
    # retry sizing: PER-STAGE (need / cap) ratios, so a retry resizes
    # only the overflowing pools (one global max would multiply EVERY
    # pool: the backward pass then runs over B*cand_pool lanes it never
    # needed for a seed_pool-only overflow)
    _cd = lambda need, cap: (need.astype(jnp.int32) + (cap - 1)) // cap
    one = jnp.int32(1)
    zero = jnp.int32(0)
    m_cand = _cd(c_need, cand_cap)
    m_r2lane = m_r2cand = m_r3 = m_merge = one
    n_r2lane = n_r2cand = n_r3 = n_merge = zero
    if cfg.reseed and cfg.mode == "smem":
        # vanilla bwa's rounds 2+3 (bwa_index/bwamem.c:129-159); the
        # merged interval list is re-sorted to vanilla's (qbeg, qend)
        # introsort order so chain insertion order matches exactly.
        dt = fmops.idx_dt(fm)
        parts = []
        # ---- round 2: split re-seed of long low-occ SMEMs ----
        split_len = int(cfg.min_seed_len * cfg.split_factor + 0.499)
        qualify = keep & (end - qbeg >= split_len) & (s <= cfg.split_width)
        lane_cap = B * cfg.r2_pool
        (lrid, lx, lfloor), lvalid, l_need = _compact_flat(
            (rid, (qbeg + end) >> 1, (s + 1).astype(dt)), qualify, lane_cap)
        kb, sb, eb, filled = _reseed_forward(
            fm, reads, lens, lrid, lx, lfloor, lvalid, cfg.min_seed_len)
        E = kb.shape[1]  # trip-indexed plane: always fits, never retries
        flat = lambda a: jnp.broadcast_to(a[:, None], (lane_cap, E)
                                          ).reshape(-1)
        lane_ids = flat(jnp.arange(lane_cap, dtype=jnp.int32))
        cand2_cap = B * cfg.r2_cand
        (rid2, lane2, x2, floor2, k2, s2, end2), v2, c2_need = _compact_flat(
            (flat(lrid), lane_ids, flat(lx), flat(lfloor),
             kb.reshape(-1), sb.reshape(-1), eb.reshape(-1)),
            filled.reshape(-1), cand2_cap)
        bw2 = (_backward_pass2 if fm.has_occ2 and cfg.pair_backward
               else _backward_pass)
        # floors here are >= 2, so no lane can ever qualify for the
        # text path — skip its SA-anchor chain statically. Walks with
        # floor >= 2 also die much earlier than round-1's, so the
        # no-cond window phase is shorter and lanes compact sooner.
        # round-2 decay on the bench simgenome (tools/bwdecay.py,
        # B=16k, 524288 lanes, alive/pool): 0.39 @4, 0.18 @8, 0.025
        # @12, 0.0075 @16 — then a LONG thin tail (0.001 past trip
        # 47). The schedule hugs that curve with ~1.5-2.5x margins;
        # the final stage puts the whole while tail at 1/64 width
        # (the single-point (10,16) schedule never engaged here: its
        # cap sat 2.7x BELOW the trip-10 survivor count, so the tail
        # ran half-width).
        kw2 = ({} if bw2 is _backward_pass2
               else dict(fixed_trips=16,
                         compact_schedule=cfg.r2_schedule))
        qb2, k2e, s2e, rdir2 = bw2(fm, reads, rid2, x2, k2, s2, v2,
                                   floor=floor2, group=lane2,
                                   text_walk=False, **kw2)
        keep2 = _containment_filter(qb2, end2, lane2, v2, cfg.min_seed_len)
        parts.append((rid2, qb2, end2, k2e, s2e, keep2, rdir2))
        m_r2lane = _cd(l_need, lane_cap)
        m_r2cand = _cd(c2_need, cand2_cap)
        n_r2lane = l_need.astype(jnp.int32)
        n_r2cand = c2_need.astype(jnp.int32)
        # ---- round 3: LAST-like forward seeds ----
        if cfg.max_mem_intv > 0:
            if r3_planes is not None:  # fused into the round-1 scan
                x3p, k3p, s3p, emit3 = r3_planes
            else:
                x3p, k3p, s3p, emit3 = _seed_strategy_pass(
                    fm, reads, lens, cfg.min_seed_len, cfg.max_mem_intv)
            L3 = emit3.shape[1]
            rid3_p = jnp.broadcast_to(
                jnp.arange(B, dtype=jnp.int32)[:, None], (B, L3))
            end3_p = jnp.broadcast_to(
                jnp.arange(L3, dtype=jnp.int32)[None, :] + 1, (B, L3))
            (rid3, qb3, end3, k3, s3), v3, c3_need = _compact_flat(
                (rid3_p.reshape(-1), x3p.reshape(-1), end3_p.reshape(-1),
                 k3p.reshape(-1), s3p.reshape(-1)),
                emit3.reshape(-1), B * cfg.r3_pool)
            parts.append((rid3, qb3, end3, k3, s3, v3 & (s3 > 0),
                          jnp.full_like(k3, -1)))
            m_r3 = _cd(c3_need, B * cfg.r3_pool)
            n_r3 = c3_need.astype(jnp.int32)
        # ---- merge + vanilla (qbeg, qend) interval sort ----
        cols = list(zip((rid, qbeg, end, k.astype(dt), s.astype(dt), keep,
                         rdir.astype(dt)),
                        *parts))
        rid_m, qb_m, end_m, k_m, s_m, keep_m, rdir_m = (
            jnp.concatenate([c.astype(cols[i][0].dtype) for c in cols[i]])
            for i in range(7))
        # compact the SURVIVORS of all 3 rounds into B*merge_pool slots
        # BEFORE sorting: the argsort over the pools' combined width
        # (cand_pool + r2_cand + r3_pool per read) was the single
        # largest seeding stage (441 of 560 ms at B=16k,
        # seed_stages_r4b.out) while live intervals are ~10-20/read.
        # _compact_flat is stable, so the live order — and therefore the
        # stable-argsort result — is identical to sorting uncompacted.
        merge_cap = B * cfg.merge_pool
        (rid_m, qb_m, end_m, k_m, s_m, rdir_m), keep_m, mg_need = \
            _compact_flat((rid_m, qb_m, end_m, k_m, s_m, rdir_m),
                          keep_m, merge_cap)
        m_merge = _cd(mg_need, merge_cap)
        n_merge = mg_need.astype(jnp.int32)
        # 32-bit sort keys when (B, L) fit — half the bytes of int64
        # keys. Any live key is < B*(L+2)^2, so
        # requiring that bound <= sentinel guarantees dropped rows
        # (= sentinel) sort strictly after every live one.
        if B * (L + 2) * (L + 2) <= (1 << 30) + (1 << 29):
            kdt, sentinel = jnp.int32, jnp.int32((1 << 30) + (1 << 29))
        else:
            kdt, sentinel = jnp.int64, jnp.int64(1) << 62
        span = kdt(L + 2)
        key = jnp.where(
            keep_m,
            (rid_m.astype(kdt) * span
             + jnp.clip(qb_m, 0, L + 1).astype(kdt)) * span
            + jnp.clip(end_m, 0, L + 1).astype(kdt),
            sentinel)
        perm = jnp.argsort(key)
        rid, qbeg, end, k, s, keep, rdir = (
            a[perm] for a in (rid_m, qb_m, end_m, k_m, s_m, keep_m, rdir_m))
    out = _expand_occurrences(
        fm, rid, qbeg, end, k, s, keep, B * cfg.seed_pool, cfg.max_occ,
        rdir=rdir)
    m_seed = _cd(out["need"], B * cfg.seed_pool)
    # per-stage multipliers, order matching poolstore.POOL_FIELDS:
    # (cand_pool, r2_pool, r2_cand, r3_pool, merge_pool, seed_pool)
    mults = jnp.stack([m_cand, m_r2lane, m_r2cand, m_r3, m_merge, m_seed])
    out["mults"] = mults
    # absolute per-pool emission counts (same field order): the sidecar
    # learns a high-water mark from these so later processes can start
    # SMALLER than a one-off worst case — oversized pools directly cost
    # backward/SA-walk lanes and argsort width
    out["needs"] = jnp.stack([c_need.astype(jnp.int32), n_r2lane,
                              n_r2cand, n_r3, n_merge,
                              out["need"].astype(jnp.int32)])
    mult = jnp.max(mults)
    out["over_mult"] = mult
    out["overflow"] = mult > 1
    return out
