"""End-to-end single-end alignment: the batched mem_align1_core.

Orchestration (reference: src/bwamem.c:1918-2342 mem_align1_core +
:1170-1479 mem_chain2aln, re-architected for batched device programs):

  device:  batched SMEM seeding over the whole read batch (ops/seeding)
  host:    chaining + chain filtering (pipeline/chain)
  host:    extension-job construction with the fork's estimated-extent
           contained-seed test (FILTER_COEF logic)
  device:  ONE batched extension launch per length bucket (ops/extend) —
           replaces the reference's SHORT/LONG double-buffered CUDA streams;
           bucketing by query length keeps padding waste low
  host:    L/R merge (score = L + R - seedlen when two-sided), dedup/patch,
           primary marking, mapQ, CIGAR, SAM text

The independent left/right extensions with h0 = seed length and the merge
rule follow the fork (reference: src/bwamem.c:2296-2305), not vanilla BWA's
chained left-then-right extension.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..index.device import DeviceFMIndex
from ..index.format import FMIndex
from ..ops.extend import ExtendParams, end_choice, extend_batch_auto
from ..ops.seeding import SeedConfig, smem_seed_batch
from ..utils.shapes import bucket_count, bucket_len
from .chain import Chain, mem_chain, mem_chain_flt
from .options import (FILTER_COEF, MemOptions, MEM_F_ALL, MEM_F_NO_MULTI,
                      MEM_F_NO_RESCUE, cal_max_gap)
from .regions import AlnReg, mem_mark_primary_se, mem_sort_dedup_patch
from .samgen import (MemAln, mem_aln2sam, mem_gen_alt, mem_reg2aln,
                     mem_reg2sam)  # noqa: F401  (re-export; lives in samgen)

LEFT, RIGHT = 0, 1
from .samgen import INT_MAX  # noqa: E402,F401


@dataclass
class ExtJob:
    query: np.ndarray
    target: np.ndarray
    h0: int
    reg: AlnReg
    side: int


def chain2aln_jobs(opt: MemOptions, idx: FMIndex, l_query: int,
                   query: np.ndarray, c: Chain, regs: list[AlnReg],
                   jobs: list[ExtJob]) -> None:
    """Build alignment regions + extension jobs for one chain
    (reference: src/bwamem.c:1170-1479 mem_chain2aln)."""
    if not c.seeds:
        return
    l_pac = idx.l_pac
    rmax0, rmax1 = l_pac << 1, 0
    for t in c.seeds:
        b = t.rbeg - (t.qbeg + cal_max_gap(opt, t.qbeg))
        e = (t.rbeg + t.len
             + (l_query - t.qbeg - t.len)
             + cal_max_gap(opt, l_query - t.qbeg - t.len))
        rmax0 = min(rmax0, b)
        rmax1 = max(rmax1, e)
    rmax0 = max(rmax0, 0)
    rmax1 = min(rmax1, l_pac << 1)
    if rmax0 < l_pac < rmax1:  # crossing the boundary; choose one side
        if c.seeds[0].rbeg < l_pac:
            rmax1 = l_pac
        else:
            rmax0 = l_pac
    rmax0, rmax1, rseq, _rid = idx.fetch_seq_rid(rmax0, rmax1,
                                                 mid=c.seeds[0].rbeg)

    # process seeds best-score-first (ties: later index first)
    srt = sorted(range(len(c.seeds)),
                 key=lambda i: (c.seeds[i].score, i))
    skipped = [False] * len(c.seeds)
    for k in range(len(srt) - 1, -1, -1):
        s = c.seeds[srt[k]]
        # contained-in-existing-alignment test on ESTIMATED extents
        hit = -1
        for idx_p, p in enumerate(regs):
            if (s.rbeg < p.rb_est or s.rbeg + s.len > p.re_est
                    or s.qbeg < p.qb_est or s.qbeg + s.len > p.qe_est):
                continue
            if s.len - p.seedlen0 > 0.1 * l_query:
                continue
            qd, rd = s.qbeg - p.qb_est, s.rbeg - p.rb_est
            w = min(cal_max_gap(opt, min(qd, rd)), p.w)
            if qd - rd < w and rd - qd < w:
                hit = idx_p
                break
            qd = p.qe_est - (s.qbeg + s.len)
            rd = p.re_est - (s.rbeg + s.len)
            w = min(cal_max_gap(opt, min(qd, rd)), p.w)
            if qd - rd < w and rd - qd < w:
                hit = idx_p
                break
        if hit >= 0:
            # contained: only extend if an overlapping seed disagrees
            disagree = False
            for i2 in range(k + 1, len(srt)):
                if skipped[srt[i2]]:
                    continue
                t = c.seeds[srt[i2]]
                if t.len < s.len * 0.95:
                    continue
                if (s.qbeg <= t.qbeg
                        and s.qbeg + s.len - t.qbeg >= s.len >> 2
                        and t.qbeg - s.qbeg != t.rbeg - s.rbeg):
                    disagree = True
                    break
                if (t.qbeg <= s.qbeg
                        and t.qbeg + t.len - s.qbeg >= s.len >> 2
                        and s.qbeg - t.qbeg != s.rbeg - t.rbeg):
                    disagree = True
                    break
            if not disagree:
                skipped[srt[k]] = True
                continue

        a = AlnReg(w=opt.w, score=-1, truesc=-1, rid=c.rid,
                   frac_rep=c.frac_rep, is_alt=c.is_alt)
        # estimated extents (fork FILTER_COEF logic, src/bwamem.c:1284-1298)
        fwd = int(FILTER_COEF * (l_query - (s.qbeg + s.len)))
        a.qe_est = min(s.qbeg + s.len + fwd, l_query)
        a.re_est = min(s.rbeg + s.len + fwd, l_pac << 1)
        back = int(FILTER_COEF * (s.qbeg + 1))
        a.qb_est = max(s.qbeg - back, 0)
        a.rb_est = max(s.rbeg - back, 0)
        if a.rb_est < l_pac < a.re_est:
            if s.rbeg < l_pac:
                a.re_est = l_pac
            else:
                a.rb_est = l_pac
        a.seedlen0 = s.len
        a.query_seed_begin = s.qbeg
        a.target_seed_begin = s.rbeg
        a._chain_seeds = c.seeds  # for post-merge seedcov

        lql = s.qbeg
        lrl = s.rbeg - rmax0
        rql = l_query - (lql + s.len)
        rrl = (rmax1 - rmax0) - (lrl + s.len)
        h0 = s.len * opt.a
        if lql > 0:
            jobs.append(ExtJob(
                query=query[:lql][::-1].copy(),
                target=rseq[:lrl][::-1].copy(),
                h0=h0, reg=a, side=LEFT))
        if rql > 0:
            jobs.append(ExtJob(
                query=query[lql + s.len:].copy(),
                target=rseq[lrl + s.len:].copy(),
                h0=h0, reg=a, side=RIGHT))
        a.align_sides = (lql > 0) + (rql > 0)
        if a.align_sides == 0:  # seed spans the whole read
            # reference: s->score < 0 ? s->len * opt->a : s->score
            a.score = a.truesc = (s.score if s.sw_scored
                                  else s.len * opt.a)
            a.qb, a.qe = 0, l_query
            a.rb, a.re = s.rbeg, s.rbeg + s.len
            a.seedcov = sum(
                t.len for t in c.seeds
                if (t.qbeg >= a.qb and t.qbeg + t.len <= a.qe
                    and t.rbeg >= a.rb and t.rbeg + t.len <= a.re))
        regs.append(a)


def run_extension_jobs(fm_params: ExtendParams, mat: np.ndarray,
                       jobs: list[ExtJob], pen_clip: int,
                       bucket_bounds=(64, 192, 1 << 30),
                       mesh=None) -> None:
    """Execute all jobs on device, bucketed by query length (the
    generalization of the reference's SHORT/LONG split,
    src/bntseq.h:85-99), then scatter chosen (score, qle, tle) into
    reg.part[side]."""
    if not jobs:
        return
    buckets: dict[int, list[ExtJob]] = {}
    for j in jobs:
        for b in bucket_bounds:
            if len(j.query) <= b:
                buckets.setdefault(b, []).append(j)
                break
    n_dev = mesh.devices.size if mesh is not None else 1
    for sub in buckets.values():
        # quantized pads: finite executable set, no per-batch recompiles
        QMAX = bucket_len(max(len(j.query) for j in sub))
        TMAX = bucket_len(max(len(j.target) for j in sub))
        N = bucket_count(len(sub))
        N = -(-N // n_dev) * n_dev
        Q = np.full((N, QMAX), 4, np.int8)
        T = np.full((N, TMAX), 4, np.int8)
        ql = np.zeros(N, np.int32)
        tl = np.zeros(N, np.int32)
        h0 = np.ones(N, np.int32)  # padding lanes: h0>0, tlen=0 -> inert
        for i, j in enumerate(sub):
            Q[i, : len(j.query)] = j.query
            T[i, : len(j.target)] = j.target
            ql[i], tl[i], h0[i] = len(j.query), len(j.target), j.h0
        if mesh is not None:
            from ..parallel.sharded import sharded_extend_batch

            out = sharded_extend_batch(
                mesh, jnp.asarray(Q), jnp.asarray(T), jnp.asarray(ql),
                jnp.asarray(tl), jnp.asarray(h0), jnp.asarray(mat),
                fm_params)
        else:
            out = extend_batch_auto(
                jnp.asarray(Q), jnp.asarray(T), jnp.asarray(ql),
                jnp.asarray(tl), jnp.asarray(h0), jnp.asarray(mat),
                fm_params)
        sc, qe, te = end_choice(out["score"], out["qle"], out["tle"],
                                out["gscore"], out["gtle"], jnp.asarray(ql),
                                pen_clip)
        # one stacked D2H instead of three
        sc, qe, te = np.asarray(jnp.stack([sc, qe, te]))
        for i, j in enumerate(sub):
            j.reg.part[j.side] = [int(sc[i]), int(qe[i]), int(te[i])]


def merge_extension_results(l_query: int, regs: list[AlnReg],
                            a_match: int = 1) -> None:
    """L/R merge (reference: src/bwamem.c:2296-2311) + post-merge seedcov
    (vanilla-style; the fork leaves seedcov 0 for extended regions, which
    only matters for the non-default mapQ_coef_len=0 formula).

    When both sides extended, each side's score counts the whole seed
    (h0 = seedlen0 * a), so one seed score must come back out. The
    reference subtracts bare `seedlen0` (src/bwamem.c:2298) — correct
    only at the default a=1; at -A 2 that inflates every two-sided score
    by seedlen0*(a-1) above the theoretical max. We subtract
    seedlen0 * a, which matches vanilla bwa-mem's chained-extension
    scores for every a (verified by the -A flag cell of the concordance
    matrix, tests/test_bwa_concordance_flags.py)."""
    for a in regs:
        if a.align_sides > 0:
            a.score = a.part[LEFT][0] + a.part[RIGHT][0]
            if a.align_sides == 2:
                a.score -= a.seedlen0 * a_match
            a.qb = a.query_seed_begin - a.part[LEFT][1]
            a.qe = a.query_seed_begin + a.seedlen0 + a.part[RIGHT][1]
            a.rb = a.target_seed_begin - a.part[LEFT][2]
            a.re = a.target_seed_begin + a.seedlen0 + a.part[RIGHT][2]
            a.truesc = a.score
            seeds = a._chain_seeds
            a.seedcov = sum(
                t.len for t in seeds
                if (t.qbeg >= a.qb and t.qbeg + t.len <= a.qe
                    and t.rbeg >= a.rb and t.rbeg + t.len <= a.re))


def _dump_chains(idx, seeds, per_read_chains) -> None:
    """Debug dump of seeds + chains (equivalent of the reference's
    bwa_verbose>=4 traces / mem_print_chain, src/bwamem.c:386-402 and
    mem_print_gpu, src/bwamem.c:304)."""
    import sys

    for b, chains in enumerate(per_read_chains):
        print(f"=====> read {b}: {len(seeds[b])} seeds, "
              f"{len(chains)} chains <=====", file=sys.stderr)
        for q0, q1, rb, occ in seeds[b]:
            print(f"  seed q[{q0},{q1}) r={rb} occ={occ}", file=sys.stderr)
        for ci, c in enumerate(chains):
            parts = "; ".join(f"{s.qbeg},{s.rbeg},{s.len}" for s in c.seeds)
            print(f"  chain({ci}) w={c.w} rid={c.rid}: {parts}",
                  file=sys.stderr)


def _dump_regs(per_read_regs, stage: str) -> None:
    import sys

    for b, regs in enumerate(per_read_regs):
        for a in regs:
            print(f"  [{stage}] read {b}: q[{a.qb},{a.qe}) r[{a.rb},{a.re})"
                  f" score={a.score} w={a.w} seedcov={a.seedcov}",
                  file=sys.stderr)


class MemAligner:
    """The flagship end-to-end model: index in HBM, batched device stages,
    host post-processing. Single-end in v1."""

    def __init__(self, opt: MemOptions, idx: FMIndex,
                 fm: DeviceFMIndex | None = None,
                 seed_cfg: SeedConfig | None = None,
                 mesh=None):
        """mesh: optional jax.sharding.Mesh — device stages run
        data-parallel over it (index replicated per chip, reads sharded
        by contiguous range; SURVEY §2.5's replacement for the
        reference's absent distributed backend)."""
        self.opt = opt
        self.idx = idx
        self.mesh = mesh
        # run counters (reference: no_of_extensions[tid] src/bwamem.c:2113
        # and the seed/extension tallies in the exit report)
        self.stats = {"n_reads": 0, "n_seeds": 0, "n_extensions": 0}
        # optional fine-grained stage timing (the reference's time_struct
        # splits GPU seeding/extension/host stages; src/utils.h:139-161);
        # set by run_pipeline so the -v report breaks "collect" down
        self.timings = None
        self.pes_fixed = None  # -I fixed insert-size model (pes0)
        # per-pool-width "seeds last chunk" counts for the prefix-fetch
        # heuristic (see fetch() in seed_batch_arrays)
        self._last_nf: dict[int, int] = {}
        from .poolstore import get_store

        self.pool_store = get_store()
        from .. import tune_cache_for_backend

        tune_cache_for_backend()  # cpu backend: no cache writes (segfault)
        self.fm = fm or DeviceFMIndex.from_host(idx)
        if mesh is not None:
            from ..parallel.sharded import replicate_index

            self.fm = replicate_index(mesh, self.fm)
        self.seed_cfg = seed_cfg or SeedConfig(
            min_seed_len=opt.min_seed_len, max_occ=opt.max_occ,
            reseed=opt.full_reseed, split_factor=opt.split_factor,
            split_width=opt.split_width, max_mem_intv=opt.max_mem_intv)
        self.ext_params = ExtendParams(
            o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
            e_ins=opt.e_ins, w=opt.w, zdrop=opt.zdrop,
            end_bonus=opt.pen_clip5, opt_ext=opt.opt_ext, max_mat=opt.a,
            mismatch=opt.b)

    def _span(self, label: str):
        from contextlib import nullcontext

        return (self.timings.span(label) if self.timings is not None
                else nullcontext())

    def seed_batch_arrays(self, seqs: list[np.ndarray]) -> dict:
        """Device seeding; returns compacted flat seed arrays
        (qbeg/qend/rbeg/n_occ) + per-read bounds, in (read, qend, SA-rank)
        order."""
        B = bucket_count(len(seqs))
        # finer grid than the extension tiles: the forward scan's SERIAL
        # trip chain is ~L/2, so padding 150->192 would cost 20% latency
        from ..utils.shapes import bucket_read_len

        L = bucket_read_len(max(len(s) for s in seqs))
        # int8 staging: sequence codes cast to int32 in-graph on device,
        # so host->device traffic shrinks 4x (stall exposure likewise)
        reads = np.full((B, L), 4, np.int8)
        lens = np.zeros(B, np.int32)
        for i, s in enumerate(seqs):
            reads[i, : len(s)] = s
            lens[i] = len(s)
        opt = self.opt
        if self.mesh is not None:
            # pad the batch to the mesh size for even contiguous shards
            n_dev = self.mesh.devices.size
            Bp = -(-B // n_dev) * n_dev
            if Bp != B:
                reads = np.concatenate(
                    [reads, np.full((Bp - B, L), 4, reads.dtype)])
                lens = np.concatenate([lens, np.zeros(Bp - B, lens.dtype)])
        # ONE upload shared by every retry launch AND by the extension
        # stage's descriptor gather (extend_choose_desc_jit). The buffer
        # travels WITH the batch (in the returned seed-arrays dict), never
        # as aligner instance state: lookahead=2 runs two collect()
        # threads concurrently on this aligner, and a shared stash would
        # hand chunk A's extension chunk B's reads (silent corruption).
        # The upload itself is a 2-bit plane + N exception list
        # (ops/readpack) — 4x fewer bytes on the pipeline's largest H2D
        # (the device-side unpack is one cheap dispatch).
        lens_j = jnp.asarray(lens)
        reads_j = None
        if self.mesh is None:
            from ..ops.readpack import pack_reads_host, unpack_reads

            words, npos, ok = pack_reads_host(reads, lens)
            if ok:
                reads_j = unpack_reads(jnp.asarray(words), lens_j,
                                       jnp.asarray(npos), L)
        if reads_j is None:
            reads_j = jnp.asarray(reads)
        reads_stage = ((len(seqs), L, reads_j)
                       if self.mesh is None else None)

        def launch(cfg):
            if opt.seed_type in (2, 4):
                from ..ops import fm as fmops
                from ..ops.seeding import bowtie_seed_batch

                ktab_k = 8 if opt.min_seed_len > 8 else 0
                ktab = (fmops.get_kmer_table(self.fm, ktab_k)
                        if ktab_k else None)
                return bowtie_seed_batch(
                    self.fm, reads_j, lens_j,
                    seed_len=opt.min_seed_len,
                    stride=opt.seed_intv or opt.min_seed_len,
                    inexact=(opt.seed_type == 4),
                    seed_pool=cfg.seed_pool, max_occ=cfg.max_occ,
                    ktab=ktab, ktab_k=ktab_k)
            mode = ("fwdmem" if opt.seed_type == 3
                    else "mem" if opt.re_seed else "smem")
            if cfg.mode != mode:
                from dataclasses import replace as _r
                cfg = self.seed_cfg = _r(cfg, mode=mode)
            if self.mesh is not None:
                from ..parallel.sharded import sharded_seed_batch

                return sharded_seed_batch(
                    self.mesh, self.fm, reads_j, lens_j, cfg)
            from ..ops.seeding import smem_seed_batch_stacked

            return smem_seed_batch_stacked(self.fm, reads_j, lens_j, cfg)

        # adaptive pool sizing: on overflow retry with doubled pools (the
        # reference aborts instead, seed_gen.cu:2037-2042; a retry costs one
        # extra launch and never silently unmaps tail reads)
        from dataclasses import replace as _dc_replace

        from .poolstore import POOL_CAPS, POOL_FIELDS, PoolStore

        def fetch(raw):
            """Coalesced D2H: ONE stacked pool transfer (head scalars ride
            in the first lanes; see formats below). The smem path
            pre-stacks on device (smem_seed_batch_stacked — packed
            (3, P+5) int32 on narrow indexes, wide (7, P) otherwise);
            other paths stack here."""
            if not isinstance(raw, dict) and raw.shape[0] == 3:
                # packed v3 (3, P+5): head scalars column-major in the
                # first 5 lanes of each row (see smem_seed_batch_stacked)
                HD = 5
                P = raw.shape[1] - HD
                import os as _os
                pf_min = int(_os.environ.get(
                    "BWAMEM_TPU_PREFIX_FETCH_MIN", 65536))

                def _qprefix(n):
                    """Round up to the quarter-power-of-two grid (bounds
                    the slice-executable variety to ~4 per octave while
                    wasting <25% of the transfer)."""
                    if n <= 8192:
                        return 8192
                    base = 1 << max((n - 1).bit_length() - 2, 0)
                    return -(-n // base) * base

                # when the pool ran ~full last chunk the prefix fetch
                # degenerates to full-pool + one extra round-trip; skip
                # it. Keyed by pool width: concurrent collect() threads
                # (lookahead=2) may interleave writes, but only chunks of
                # the same shape class share an entry, so a stale read is
                # just "the other in-flight chunk's count" — an equally
                # valid predictor (GIL makes the dict update atomic).
                near_full = self._last_nf.get(P, 0) > 0.75 * P
                if P > pf_min and not near_full:
                    # speculative ONE-SHOT prefix fetch: the previous
                    # chunk's live-seed count predicts this one's (same
                    # shape class, same genome). One D2H slice carries
                    # the head scalars AND a 1.25x-padded seed prefix;
                    # only a short prediction (first chunk, workload
                    # shift) pays a second, delta-only fetch, instead of
                    # a round-trip every chunk to size the transfer.
                    last_n = self._last_nf.get(P, 0)
                    nf = min(_qprefix(int(last_n * 1.25)), P)
                    spec = np.asarray(raw[:, :HD + nf] if nf < P else raw)
                    head = spec[:, :HD].T.reshape(-1)[
                        :3 + 2 * len(POOL_FIELDS)]
                    n = int(head[0])
                    self._last_nf[P] = n
                    if n <= nf or nf >= P:
                        pool = spec[:, HD:]
                    else:  # prediction short: fetch only the delta
                        n2 = min(_qprefix(n), P)
                        rest = np.asarray(raw[:, HD + nf:HD + n2])
                        pool = np.concatenate([spec[:, HD:], rest], axis=1)
                else:
                    full = np.asarray(raw)  # packed, single D2H
                    head = full[:, :HD].T.reshape(-1)[
                        :3 + 2 * len(POOL_FIELDS)]
                    pool = full[:, HD:]
                    n = int(head[0])
                    self._last_nf[P] = n
                F = len(POOL_FIELDS)
                mults = {f: max(int(head[3 + i]), 1)
                         for i, f in enumerate(POOL_FIELDS)}
                needs = {f: int(head[3 + F + i])
                         for i, f in enumerate(POOL_FIELDS)}
                u0 = pool[0].astype(np.uint32)
                return dict(
                    read_id=(u0 >> 16).astype(np.int32),
                    qbeg=pool[1] >> 16,
                    qend=pool[1] & 0xFFFF, rbeg=pool[2],
                    n_occ=(u0 & 0xFFFF).astype(np.int32),
                    valid=np.arange(pool.shape[1]) < n,
                    n_seeds=head[0], overflow=head[1] > 0,
                    over_mult=max(int(head[2]), 1), mults=mults,
                    needs=needs)
            if not isinstance(raw, dict):
                pool = np.asarray(raw)  # (7, P), single D2H
                head = pool[6]
            else:
                dt = raw["rbeg"].dtype
                pool_d = jnp.stack(
                    [raw[k].astype(dt)
                     for k in ("read_id", "qbeg", "qend", "rbeg", "n_occ")]
                    + [raw["valid"].astype(dt)])
                om = raw["over_mult"].astype(jnp.int32)
                head_d = jnp.concatenate([
                    jnp.stack([raw["n_seeds"].astype(jnp.int32),
                               raw["overflow"].astype(jnp.int32), om]),
                    # paths without per-stage mults (bowtie) have ONE
                    # pool: map over_mult onto the seed_pool slot
                    raw["mults"].astype(jnp.int32) if "mults" in raw
                    else jnp.stack([jnp.int32(1)] * (len(POOL_FIELDS) - 1)
                                   + [om]),
                    raw["needs"].astype(jnp.int32) if "needs" in raw
                    else jnp.zeros(len(POOL_FIELDS), jnp.int32)])
                pool = np.asarray(pool_d)
                head = np.asarray(head_d)
            F = len(POOL_FIELDS)
            mults = {f: max(int(head[3 + i]), 1)
                     for i, f in enumerate(POOL_FIELDS)}
            needs = ({f: int(head[3 + F + i])
                      for i, f in enumerate(POOL_FIELDS)}
                     if head.shape[0] >= 3 + 2 * F else {})
            return dict(read_id=pool[0], qbeg=pool[1], qend=pool[2],
                        rbeg=pool[3], n_occ=pool[4],
                        valid=pool[5].astype(bool),
                        n_seeds=head[0], overflow=head[1] > 0,
                        over_mult=max(int(head[2]), 1), mults=mults,
                        needs=needs)

        # seed counts grow linearly with read length: pre-scale the two
        # round-1 pools for long-read chunks so the first one doesn't pay
        # 3-4 overflow retries (each a recompile + a full re-seed pass).
        # 192 is the short-read length bucket the 32/4 defaults were
        # measured at; scale stays a power of two to keep the executable
        # set finite.
        need = -(-L // 192)
        scale = 1 << (need - 1).bit_length()
        if scale > 1 and self.seed_cfg.cand_pool > 0:
            updates = {}
            for f in ("cand_pool", "seed_pool"):
                cur = getattr(self.seed_cfg, f)
                tgt = min(cur * scale, 4096)
                if tgt > cur:
                    updates[f] = tgt
            if updates:
                self.seed_cfg = _dc_replace(self.seed_cfg, **updates)

        # learned pool sizes from earlier processes (poolstore sidecar):
        # adopt any field a previous converged run found necessary for
        # this (mode, read-length) class, so steady-state runs and the
        # bench start right-sized with ZERO overflow retries.
        pool_key = PoolStore.key(
            f"st{opt.seed_type}" if opt.seed_type in (2, 4)
            else ("fwdmem" if opt.seed_type == 3
                  else "mem" if opt.re_seed else "smem"),
            self.seed_cfg.reseed, opt.min_seed_len, L,
            gid=int(getattr(self.idx, "l_pac", 0)))
        learned = self.pool_store.lookup(pool_key)
        if learned:
            # adopt the learned size in BOTH directions: lookup returns
            # hwm x margin, so a class whose true need sits below the
            # static default starts SMALLER (pool width is paid every
            # chunk in backward/SA-walk lanes and sort keys); an
            # underestimate costs one overflow retry and re-raises hwm
            updates = {f: v for f, v in learned.items()
                       if v != getattr(self.seed_cfg, f)}
            if updates:
                self.seed_cfg = _dc_replace(self.seed_cfg, **updates)

        while True:
            with self._span("seed_device"):
                with self._span("seed_launch"):
                    raw = launch(self.seed_cfg)
                    # the stacked launch is async; block so launch/fetch
                    # spans split compute from the D2H transfer
                    if self.timings is not None and not isinstance(raw,
                                                                   dict):
                        raw.block_until_ready()
                with self._span("seed_fetch"):
                    out = fetch(raw)
            # per-stage one-jump resize: only the overflowing pools grow
            # (a global multiplier made the backward pass 4x wider for a
            # seed_pool-only overflow). Each jump
            # goes straight to a fitting power-of-two size; the loop
            # stays because a lifted truncation can reveal new need.
            updates = {}
            for f, v in out["mults"].items():
                cur = getattr(self.seed_cfg, f)
                if v > 1 and cur < POOL_CAPS[f]:
                    m = 1 << max(v - 1, 1).bit_length()
                    updates[f] = min(cur * m, POOL_CAPS[f])
            if not updates:
                break
            self.seed_cfg = _dc_replace(self.seed_cfg, **updates)
            import sys

            print(f"[bwamem-tpu] seed pool overflow; retrying with "
                  + ", ".join(f"{f}={v}" for f, v in updates.items()),
                  file=sys.stderr)
        if not bool(out["overflow"]):
            # converged: persist caps + per-read need high-water so the
            # NEXT process starts right-sized — neither retrying up nor
            # dragging a one-off worst case's oversized pools around
            needs = out.get("needs") or {}
            hwm = {f: v / max(len(seqs), 1)
                   for f, v in needs.items() if v > 0}
            self.pool_store.update(pool_key, {
                f: getattr(self.seed_cfg, f) for f in POOL_FIELDS},
                hwm=hwm)
        if bool(out["overflow"]):
            # spill path: pools are at their per-read cap and STILL
            # overflow. The pool is GLOBAL (B * cap slots shared across
            # the batch), so residual overflow means a few repeat-dense
            # hog reads ate everyone's share — halving the batch isolates
            # the hogs, and the batch-bucket floor (bucket_count >= 16)
            # hands a lone read a 16x pool share at the recursion base.
            # The reference ABORTS here (seed_gen.cu:2037-2042); dropping
            # seeds silently is not acceptable either (unmapped tails).
            if len(seqs) > 1:
                import sys
                mid = len(seqs) // 2
                print(f"[bwamem-tpu] seed pool at cap; splitting batch "
                      f"{len(seqs)} -> {mid}+{len(seqs) - mid}",
                      file=sys.stderr)
                lo = self.seed_batch_arrays(seqs[:mid])
                hi = self.seed_batch_arrays(seqs[mid:])
                bounds = np.concatenate(
                    [lo["bounds"][:-1], lo["bounds"][-1] + hi["bounds"]])
                # no reads_dev: the split halves each uploaded their own
                # half-batch buffer — extension re-uploads fresh
                return dict(
                    qbeg=np.concatenate([lo["qbeg"], hi["qbeg"]]),
                    qend=np.concatenate([lo["qend"], hi["qend"]]),
                    rbeg=np.concatenate([lo["rbeg"], hi["rbeg"]]),
                    n_occ=np.concatenate([lo["n_occ"], hi["n_occ"]]),
                    bounds=bounds.astype(np.int64))
            import sys
            print("[bwamem-tpu] warning: single read exceeds the device "
                  "seed-pool cap; its seed list is truncated",
                  file=sys.stderr)
        self.stats["n_seeds"] += int(out["n_seeds"])
        v = out["valid"].astype(bool)
        rid = out["read_id"][v]
        bounds = np.searchsorted(rid, np.arange(len(seqs) + 1))
        return dict(qbeg=out["qbeg"][v], qend=out["qend"][v],
                    rbeg=out["rbeg"][v], n_occ=out["n_occ"][v],
                    bounds=bounds.astype(np.int64),
                    reads_dev=reads_stage)

    def seed_batch(self, seqs: list[np.ndarray]) -> list[list[tuple]]:
        """Tuple-list view of seed_batch_arrays (compat for the
        object-path consumers: Python chaining, fastmap, tests)."""
        arr = self.seed_batch_arrays(seqs)
        cols = np.stack([arr["qbeg"], arr["qend"], arr["rbeg"],
                         arr["n_occ"]], axis=1)
        b = arr["bounds"]
        return [
            [tuple(int(x) for x in row) for row in cols[b[i]:b[i + 1]]]
            for i in range(len(seqs))
        ]

    def _collect_native(self, seqs, seeds):
        # `seeds` is the flat-array dict from seed_batch_arrays
        """Fast path: chaining AND chain2aln job construction run in the
        native C++ core (flat arrays + sequence streams; no per-seed
        Python objects). Used when the per-seed SW/SHD filter is inactive
        (short reads, no -F); returns None to fall back."""
        opt, idx = self.opt, self.idx
        if opt.min_chain_weight > 0 or opt.verbose >= 4:
            return None
        from ..native import loader
        from .chain import chain_batch_raw

        lib = loader.try_load()
        if lib is None:
            return None
        lqs = [len(s) for s in seqs]
        with self._span("chain_native"):
            raw = chain_batch_raw(opt, idx, lqs, None, seed_arrays=seeds)
        if raw is None:
            return None
        if opt.shd_filter or max(lqs, default=0) >= 500:
            # -F SHD / long-read SW per-seed filter: one batched device
            # launch over the flat arrays (no per-seed objects)
            from .seedflt import filter_seed_arrays

            with self._span("seed_filter"):
                filter_seed_arrays(opt, idx, raw, seqs)
        B = len(seqs)
        L = max(lqs)
        reads = np.full((B, L), 4, np.uint8)
        for i, s in enumerate(seqs):
            reads[i, : len(s)] = s
        with self._span("chain2aln_native"):
            out = loader.chain2aln_native(
                lib, opt, idx, raw, reads.reshape(-1), L,
                np.asarray(lqs, np.int32))
        nR = out["n_regs"]
        R = out["regs"]

        self.stats["n_reads"] += B
        self.stats["n_extensions"] += out["n_jobs"]
        partL = np.zeros((nR, 3), np.int64)
        partR = np.zeros((nR, 3), np.int64)
        # the seeding stage's device reads buffer serves the extension
        # descriptor gather; it rides in this batch's seed-arrays dict
        # (NOT instance state — two collect() threads run concurrently),
        # absent only after a spill split — then re-upload fresh
        stash = seeds.get("reads_dev")
        reads_dev = None
        if (self.mesh is None and stash is not None and stash[0] == B
                and stash[1] >= L):
            reads_dev = stash[2]
        elif self.mesh is None:
            reads_dev = jnp.asarray(reads)  # rare: re-upload fresh
        self._run_jobs_arrays(out, (partL, partR), reads_dev=reads_dev)

        # vectorized L/R merge (reference rule: src/bwamem.c:2296-2311)
        merge_span = self._span("merge_numpy")
        merge_span.__enter__()
        sides = R["sides"][:nR].astype(np.int64)
        seedlen0 = R["seedlen0"][:nR].astype(np.int64)
        qseed = R["qseed"][:nR].astype(np.int64)
        rseed = R["rseed"][:nR]
        ext = sides > 0
        # two-sided merge subtracts the double-counted seed at its SCORE
        # (seedlen0 * a), not its length — see merge_extension_results
        score = np.where(
            ext, partL[:, 0] + partR[:, 0] - (sides == 2) * seedlen0 * opt.a,
            R["score0"][:nR])
        qb = np.where(ext, qseed - partL[:, 1], R["qb0"][:nR])
        qe = np.where(ext, qseed + seedlen0 + partR[:, 1], R["qe0"][:nR])
        rb = np.where(ext, rseed - partL[:, 2], R["rb0"][:nR])
        re = np.where(ext, rseed + seedlen0 + partR[:, 2], R["re0"][:nR])

        sq = raw["s_qbeg"].astype(np.int64)
        sr = raw["s_rbeg"]
        sl = raw["s_len"].astype(np.int64)
        soffs = R["chain_soff"][:nR].astype(np.int64)
        nss = R["chain_ns"][:nR].astype(np.int64)
        # vectorized seedcov: one (reg, seed) pair table + masked bincount
        total = int(nss.sum())
        pair_reg = np.repeat(np.arange(nR), nss)
        cum = np.zeros(nR, np.int64)
        np.cumsum(nss[:-1], out=cum[1:])
        pair_seed = np.repeat(soffs - cum, nss) + np.arange(total)
        tq = sq[pair_seed]
        tr = sr[pair_seed]
        tl = sl[pair_seed]
        pm = ((tq >= qb[pair_reg]) & (tq + tl <= qe[pair_reg])
              & (tr >= rb[pair_reg]) & (tr + tl <= re[pair_reg]))
        scov = np.bincount(pair_reg[pm], weights=tl[pm],
                           minlength=nR).astype(np.int64)
        scov = np.where(ext, scov, R["seedcov0"][:nR])
        rids = R["rid"][:nR]
        alts = R["is_alt"][:nR]
        fracs = R["frac"][:nR]
        reads_of = R["read"][:nR]

        # native dedup + patch over the flat arrays (twin:
        # regions.mem_sort_dedup_patch); objects are built only for the
        # survivors, in final (score desc, rb, qb) order
        from ..native.loader import dedup_patch_native

        # regions arrive grouped by read (chain2aln emits reads in order);
        # the searchsorted grouping below silently corrupts output if not
        assert reads_of.size == 0 or (np.diff(reads_of) >= 0).all()
        reg_off = np.searchsorted(
            reads_of, np.arange(B + 1, dtype=np.int64)).astype(np.int64)
        qlens = np.fromiter((len(q) for q in seqs), np.int64, B)
        q_off = np.zeros(B, np.int64)
        np.cumsum(qlens[:-1], out=q_off[1:])
        qstream = (np.concatenate([np.asarray(q, np.uint8) for q in seqs])
                   if B else np.zeros(0, np.uint8))
        F = dict(
            rb=np.ascontiguousarray(rb, np.int64),
            re=np.ascontiguousarray(re, np.int64),
            qb=np.ascontiguousarray(qb, np.int32),
            qe=np.ascontiguousarray(qe, np.int32),
            score=np.ascontiguousarray(score, np.int32),
            truesc=np.ascontiguousarray(score, np.int32),
            w=np.full(nR, opt.w, np.int32),
            seedcov=np.ascontiguousarray(scov, np.int32),
            sub=np.zeros(nR, np.int32),
            csub=np.zeros(nR, np.int32),
            n_comp=np.ones(nR, np.int32),
            rid=np.ascontiguousarray(rids, np.int32),
        )
        merge_span.__exit__(None, None, None)
        lib = loader.try_load()
        with self._span("dedup_native"):
            oi, oc = dedup_patch_native(lib, opt, idx, reg_off, qstream,
                                        q_off, F)
        obj_span = self._span("reg_objects")
        obj_span.__enter__()
        # vectorized survivor selection into the array-backed container —
        # an AlnReg-object round-trip here is GIL-holding Python per
        # region, and the native finalize re-flattens the objects anyway
        from .regarrays import RegArrays

        oc64 = oc.astype(np.int64)
        new_off = np.zeros(B + 1, np.int64)
        np.cumsum(oc64, out=new_off[1:])
        tot = int(new_off[-1])
        row_start = np.repeat(reg_off[:B], oc64)
        within = np.arange(tot, dtype=np.int64) - np.repeat(
            new_off[:B], oc64)
        take = oi[row_start + within]
        cols = {name: F[name][take]
                for name in ("rb", "re", "qb", "qe", "score", "truesc",
                             "sub", "csub", "w", "seedcov", "rid")}
        cols["is_alt"] = alts[take].astype(np.int8)
        cols["frac"] = np.asarray(fracs, np.float64)[take]
        per = RegArrays(new_off, cols, n_comp=F["n_comp"][take])
        obj_span.__exit__(None, None, None)
        return per

    def _run_jobs_arrays(self, out, parts, reads_dev=None) -> None:
        """Bucketed device extension over array-form jobs; results land in
        parts[(side)][reg, 0:3] = (score, qle, tle) (the native fast
        path's equivalent of run_extension_jobs).

        reads_dev: the seeding stage's (B, L) device reads buffer. When
        given (single-device path), jobs ship as DESCRIPTORS and the
        device gathers Q from this buffer and T from the HBM-resident
        packed genome (extend_choose_desc_jit) — the materialized-tile
        H2D was the pipeline's largest host->device payload."""
        from ..native import loader

        opt = self.opt
        J = out["jobs"]
        nJ = out["n_jobs"]
        if nJ == 0:
            return
        lib = loader.try_load()
        qlen = J["qlen"][:nJ]
        n_dev = self.mesh.devices.size if self.mesh is not None else 1
        use_desc = reads_dev is not None and self.mesh is None

        # tlen clamp to the provable DP reach: on repeat-dense chains the
        # rmax window spans the WHOLE chain (kilobases), but an extension
        # from one seed can never score past qlen + band (opt_ext) or
        # qlen + (h0 + a*qlen - o_del)/e_del (unbanded — every H value at
        # deeper rows is provably <= 0, and the kernel's rowmax==0 early
        # kill fires there anyway). Clamping is therefore OUTPUT-EXACT
        # for the chosen (score, qle, tle): rows past the reach cannot
        # update best/qle/tle, and a gscore flatlined at 0 is discarded
        # by end_choice's take_local. It kills both the runtime tail
        # (one huge-tlen job no longer spins its whole kernel program)
        # and the TMAX executable churn (a new compile per data-dependent
        # TMAX bucket).
        p = self.ext_params
        q64 = qlen.astype(np.int64)
        h064 = J["h0"][:nJ].astype(np.int64)
        if p.opt_ext:
            reach = q64 + int(p.w) + 1
        else:
            e_min = max(min(p.e_del, p.e_ins), 1)
            o_min = min(p.o_del, p.o_ins)
            reach = q64 + np.maximum(
                h064 + int(p.max_mat) * q64 - o_min, 0) // e_min + 2
        tlen = np.minimum(J["tlen"][:nJ].astype(np.int64),
                          reach).astype(np.int32)
        # full-width clamped copy for scatter_jobs (bm_scatter_jobs
        # memcpy's lens[j] bytes and must never exceed TMAX)
        tlen_full = J["tlen"].copy()
        tlen_full[:nJ] = tlen

        # bucket merge: every extra launch costs a dispatch + D2H
        # round-trip (costed below as 64 MB of padding). On
        # the descriptor path padding ships NO extra bytes (the device
        # gathers only masked windows), so one merged launch is always
        # right — and keeps the executable family at one member per
        # (read-length, N-bucket) pair. The materialized-tile paths keep
        # the pad-bytes-vs-trips cost model.
        bounds: tuple = (64, 192, 1 << 30)
        if use_desc:
            bounds = (1 << 30,)
        else:
            sels_cost = []
            assigned = np.zeros(nJ, bool)
            for bound in bounds:
                m = (~assigned) & (qlen <= bound)
                assigned |= m
                if m.any():
                    sels_cost.append(
                        bucket_count(int(m.sum()))
                        * (bucket_len(int(qlen[m].max()))
                           + bucket_len(int(tlen[m].max()))))
            if len(sels_cost) > 1:
                merged_cost = bucket_count(nJ) * (
                    bucket_len(int(qlen.max()))
                    + bucket_len(int(tlen.max())))
                trip_bytes = (len(sels_cost) - 1) * (64 << 20)
                if merged_cost - sum(sels_cost) < trip_bytes:
                    bounds = (1 << 30,)

        assigned = np.zeros(nJ, bool)
        # two passes: scatter + launch EVERY bucket first (async device
        # dispatch), fetch afterwards — bucket k+1's device compute and
        # host scatter overlap bucket k's execution instead of
        # serializing behind its D2H round-trip
        launched: list[tuple] = []
        for bound in bounds:
            m = (~assigned) & (qlen <= bound)
            assigned |= m
            sel = np.nonzero(m)[0].astype(np.int64)
            if not len(sel):
                continue
            if use_desc:
                # family-stable shapes: derive QMAX/TMAX from the READ
                # LENGTH bucket + score params, not per-chunk data maxima
                # — one executable per (read-length, N-bucket) family
                # instead of a fresh 30-40 s compile whenever a chunk's
                # longest job shifts a bucket. Padding is free here: the
                # device gathers only masked windows (no pad H2D), and
                # the kernel's programs run to their own longest tlen.
                Lb = reads_dev.shape[1]
                QMAX = bucket_len(Lb)
                if p.opt_ext:
                    TMAX = bucket_len(QMAX + int(p.w) + 1)
                else:
                    TMAX = bucket_len(
                        QMAX + (int(p.max_mat) * Lb - o_min) // e_min + 2)
            else:
                QMAX = bucket_len(int(qlen[sel].max()))
                TMAX = bucket_len(int(tlen[sel].max()))
            N = -(-bucket_count(len(sel)) // n_dev) * n_dev
            ql = np.zeros(N, np.int32)
            tl = np.zeros(N, np.int32)
            h0 = np.ones(N, np.int32)
            ql[: len(sel)] = qlen[sel]
            tl[: len(sel)] = tlen[sel]
            h0[: len(sel)] = J["h0"][:nJ][sel]
            if use_desc:
                from ..ops.extend import extend_choose_desc_jit

                jr = np.zeros(N, np.int32)
                jqs = np.zeros(N, np.int32)
                jts = np.zeros(N, np.int64)
                jdir = np.ones(N, np.int8)
                jr[: len(sel)] = J["read"][:nJ][sel]
                jqs[: len(sel)] = J["qstart"][:nJ][sel]
                jts[: len(sel)] = J["tstart"][:nJ][sel]
                jdir[: len(sel)] = J["dir"][:nJ][sel]
                with self._span("ext_dispatch"):
                    stacked = extend_choose_desc_jit(
                        self.fm, reads_dev, jnp.asarray(jr),
                        jnp.asarray(jqs), jnp.asarray(ql),
                        jnp.asarray(jts), jnp.asarray(tl),
                        jnp.asarray(jdir), jnp.asarray(h0),
                        jnp.asarray(opt.mat), self.ext_params,
                        int(opt.pen_clip5), QMAX, TMAX)
                launched.append((stacked, sel))
                continue
            with self._span("ext_scatter"):
                Q = loader.scatter_jobs(lib, out["qstream"], J["qoff"],
                                        J["qlen"], sel, QMAX)
                T = loader.scatter_jobs(lib, out["tstream"], J["toff"],
                                        tlen_full, sel, TMAX)
            if N != len(sel):
                Q = np.vstack(
                    [Q, np.full((N - len(sel), QMAX), 4, np.int8)])
                T = np.vstack(
                    [T, np.full((N - len(sel), TMAX), 4, np.int8)])
            if self.mesh is not None:
                from ..parallel.sharded import sharded_extend_batch

                res = sharded_extend_batch(
                    self.mesh, jnp.asarray(Q), jnp.asarray(T),
                    jnp.asarray(ql), jnp.asarray(tl), jnp.asarray(h0),
                    jnp.asarray(opt.mat), self.ext_params)
                sc, qe, te = end_choice(
                    res["score"], res["qle"], res["tle"], res["gscore"],
                    res["gtle"], jnp.asarray(ql), opt.pen_clip5)
                stacked = jnp.stack([sc, qe, te])
            else:
                from ..ops.extend import extend_choose_jit

                stacked = extend_choose_jit(
                    jnp.asarray(Q), jnp.asarray(T), jnp.asarray(ql),
                    jnp.asarray(tl), jnp.asarray(h0), jnp.asarray(opt.mat),
                    self.ext_params, int(opt.pen_clip5))
            launched.append((stacked, sel))
        for stacked, sel in launched:
            with self._span("ext_device"):
                sc, qe, te = np.asarray(stacked)[:, : len(sel)]
            jreg = J["reg"][:nJ][sel]
            jside = J["side"][:nJ][sel]
            for side in (0, 1):
                m = jside == side
                parts[side][jreg[m], 0] = sc[m]
                parts[side][jreg[m], 1] = qe[m]
                parts[side][jreg[m], 2] = te[m]

    def collect_regs_batch(
            self, seqs: list[np.ndarray]) -> list[list[AlnReg]]:
        """Device seeding + host chaining + ONE batched device extension
        per bucket + L/R merge + dedup/patch. Equivalent of worker1 ->
        mem_align1_core output (reference: src/bwamem.c:2440-2449), before
        primary marking."""
        from .seedflt import SeedFilterBatch

        opt, idx = self.opt, self.idx
        with self._span("seed_total"):
            seed_arr = self.seed_batch_arrays(seqs)
        with self._span("native_total"):
            fast = self._collect_native(seqs, seed_arr)
        if fast is not None:
            return fast
        cols = np.stack([seed_arr["qbeg"], seed_arr["qend"],
                         seed_arr["rbeg"], seed_arr["n_occ"]], axis=1)
        bnd = seed_arr["bounds"]
        seeds = [
            [tuple(int(x) for x in row) for row in cols[bnd[i]:bnd[i + 1]]]
            for i in range(len(seqs))
        ]

        # phase 1: chains + chain filter for every read (native C++ core
        # when available, one GIL-free call for the whole batch); per-seed
        # filter jobs accumulate for one batched launch (reference runs
        # the filter per read inside worker1, src/bwamem.c:2071-2073)
        from .chain import chain_batch

        per_read_chains = chain_batch(opt, idx, [len(s) for s in seqs],
                                      seeds)
        flt = SeedFilterBatch(opt, idx)
        for b, seq in enumerate(seqs):
            flt.add_read(len(seq), seq, per_read_chains[b])
        flt.run()

        if opt.verbose >= 4:
            _dump_chains(idx, seeds, per_read_chains)

        # phase 2: extension-job construction, then one launch per bucket
        per_read_regs: list[list[AlnReg]] = []
        jobs: list[ExtJob] = []
        for b, seq in enumerate(seqs):
            regs: list[AlnReg] = []
            for c in per_read_chains[b]:
                chain2aln_jobs(opt, idx, len(seq), seq, c, regs, jobs)
            per_read_regs.append(regs)
        if opt.verbose >= 4:
            _dump_regs(per_read_regs, stage="pre-extension")

        self.stats["n_reads"] += len(seqs)
        self.stats["n_extensions"] += len(jobs)
        run_extension_jobs(self.ext_params, opt.mat, jobs, opt.pen_clip5,
                           mesh=self.mesh)

        out: list[list[AlnReg]] = []
        for b, seq in enumerate(seqs):
            regs = per_read_regs[b]
            merge_extension_results(len(seq), regs, a_match=opt.a)
            out.append(mem_sort_dedup_patch(opt, idx, seq, regs))
        if opt.verbose >= 4:
            _dump_regs(out, stage="post-dedup")
        return out

    def emit_sam_batch(self, names, seqs, quals, per_read_regs,
                       n_processed: int = 0, comments=None,
                       native: bool = True) -> list[str]:
        """worker2 equivalent for SE (reference: src/bwamem.c:2451-2460):
        mark-primary + SAM per read, given collected regions. The whole
        finalization (mark-primary + selection + XA + CIGAR/NM/MD + SAM
        text) runs in ONE native call when the C++ library is available
        (twin: the Python path below, kept as the differential oracle)."""
        from .samgen import mem_reg2sam_batch

        opt, idx = self.opt, self.idx
        cms = comments if (comments and opt.copy_comment) else None
        rg = getattr(opt, "rg_id", None)
        if native:
            from ..native import loader

            lib = loader.try_load()
            if lib is not None:
                blob = loader.finalize_se_native(
                    lib, opt, idx, names, seqs, quals, per_read_regs,
                    n_processed, cms, rg)
                return blob.decode().splitlines()
        marked = [mem_mark_primary_se(opt, per_read_regs[b],
                                      n_processed + b)[0]
                  for b in range(len(seqs))]
        return mem_reg2sam_batch(opt, idx, names, seqs, quals, marked,
                                 comments=cms, rg_id=rg)

    def align_batch(self, names: list[str], seqs: list[np.ndarray],
                    quals: list[str | None] | None = None,
                    n_processed: int = 0) -> list[str]:
        """Single-end: returns SAM lines (one or more per read, in input
        order)."""
        quals = quals or [None] * len(seqs)
        per_read_regs = self.collect_regs_batch(seqs)
        return self.emit_sam_batch(names, seqs, quals, per_read_regs,
                                   n_processed)

    def align_one(self, seq, name: str = "read",
                  qual: str | None = None) -> list[str]:
        """One-read convenience API (equivalent of mem_align1, reference:
        src/bwamem_extra.c:82). Accepts codes (np array) or an ACGT
        string; returns the read's SAM lines."""
        if isinstance(seq, (str, bytes)):
            from ..utils.dna import encode

            seq = encode(seq.encode() if isinstance(seq, str) else seq)
        return self.align_batch([name], [np.asarray(seq)], [qual])

    def collect_pairs_batch(self, seqs: list[np.ndarray],
                            pes: list | None = None):
        """PE collection: regions + insert-size inference + batched mate
        rescue (everything device-bound / order-independent). Returns
        (pair_regs, pes) for the finalization stage."""
        from .pairing import mem_pe_rescue_batch, mem_pestat

        opt, idx = self.opt, self.idx
        if len(seqs) % 2:
            raise SystemExit(
                "[bwamem-tpu] error: paired-end input has an odd number of "
                "reads — not valid interleaved PE data")
        per_read_regs = self.collect_regs_batch(seqs)
        from .regarrays import RegArrays

        if isinstance(per_read_regs, RegArrays):
            # materialize ONCE: pestat iteration + pair grouping below
            # would otherwise each rebuild the objects per read
            per_read_regs = per_read_regs.to_lists()
        if pes is None:
            with self._span("pestat"):
                pes = self.pes_fixed or mem_pestat(opt, idx.l_pac,
                                                   per_read_regs)
        n_pairs = len(seqs) >> 1
        pair_seqs = [(seqs[i << 1], seqs[i << 1 | 1])
                     for i in range(n_pairs)]
        pair_regs = [[per_read_regs[i << 1], per_read_regs[i << 1 | 1]]
                     for i in range(n_pairs)]
        if not (opt.flag & MEM_F_NO_RESCUE):
            with self._span("pe_rescue"):
                mem_pe_rescue_batch(opt, idx, pes, pair_seqs, pair_regs,
                                    dev=self.fm, span=self._span,
                                    stats=self.stats)
        return pair_regs, pes

    def align_pairs_batch(self, names: list[str], seqs: list[np.ndarray],
                          quals: list[str | None] | None = None,
                          n_processed: int = 0,
                          pes: list | None = None) -> list[str]:
        """Paired-end: `seqs` is interleaved (read1, read2, ...). Insert
        sizes inferred from this chunk unless `pes` is given (equivalent of
        mem_process_seqs's PE path, reference: src/bwamem.c:2504-2512 +
        src/bwamem_pair.c mem_sam_pe)."""
        from .pairing import Reg2AlnCtx, mem_sam_pe_plan, mem_sam_pe_render

        opt, idx = self.opt, self.idx
        quals = quals or [None] * len(seqs)
        pair_regs, pes = self.collect_pairs_batch(seqs, pes)
        from .hostpool import _emit_pe

        return _emit_pe(opt, idx, names, seqs, quals, pair_regs, pes,
                        n_processed >> 1)
