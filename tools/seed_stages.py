"""On-card per-stage timing of the seeding program: jit cumulative
prefixes of smem_seed_batch's stages (sync = scalar reduce, 4B D2H) and
difference them. Mirrors ops/seeding.py's call sequence — keep in sync.
"""
from __future__ import annotations

import os
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax
    import jax.numpy as jnp

    from bwamem_tpu.index.build import build_index_from_codes
    from bwamem_tpu.index.device import DeviceFMIndex
    from bwamem_tpu.index.format import Annotation
    from bwamem_tpu.ops import fm as fmops
    from bwamem_tpu.ops import seeding as S

    rng = np.random.default_rng(12345)
    G = 4_600_000
    L = 150
    B = next((int(a) for a in sys.argv[1:] if a.isdigit()), 8192)
    # same genome family as bench.py --e2e (repeat-rich simgenome;
    # --random for the old uniform A/B)
    import bench as benchmod
    g, _contigs, idx = benchmod._bench_world(
        G, random_genome="--random" in sys.argv)
    fm = DeviceFMIndex.from_host(idx)

    reads = np.full((B, L), 4, np.int8)
    for i in range(B):
        p = int(rng.integers(0, G - L))
        r = g[p:p + L].copy()
        err = rng.random(L) < 0.01
        r[err] = (r[err] + 1) % 4
        reads[i] = r
    lens = np.full(B, L, np.int32)
    rj = jnp.asarray(reads)
    lj = jnp.asarray(lens)

    # product pools: adopt the learned sidecar sizes for this class the
    # way MemAligner does, so the breakdown times the REAL executable
    # (env overrides: SEED_STAGES_<FIELD>=n)
    from bwamem_tpu.pipeline.poolstore import PoolStore
    learned = (PoolStore().lookup(PoolStore.key("smem", True, 19, 160,
                                                gid=G))
               or PoolStore().lookup(PoolStore.key("smem", True, 19, 160))
               or {})
    for f in ("cand_pool", "r2_pool", "r2_cand", "r3_pool",
              "seed_pool"):
        v = os.environ.get(f"SEED_STAGES_{f.upper()}")
        if v is not None:
            learned[f] = int(v)
    cfg = S.SeedConfig(reseed=True, **{"seed_pool": 16, **learned})
    pair = os.environ.get("SEED_STAGES_PAIR", "0") == "1"
    bw = S._backward_pass2 if pair else S._backward_pass
    print(f"cfg pools: cand={cfg.cand_pool} seed={cfg.seed_pool} "
          f"r2_pool={cfg.r2_pool} "
          f"r2_cand={cfg.r2_cand} r3_pool={cfg.r3_pool} "
          f"backward={'pair' if pair else 'single'}", flush=True)

    def stage_fn(upto: str):
        @jax.jit
        def run(reads, lens):
            reads = reads.astype(jnp.int32)
            lens = lens.astype(jnp.int32)
            B, L = reads.shape
            out_fwd = S._forward_pass2(
                fm, reads, lens, cfg.min_seed_len,
                strategy=(cfg.min_seed_len, cfg.max_mem_intv))
            start, k, s, emit, r3_planes = out_fwd
            if upto == "scan":
                return sum(x.sum() for x in (start, k, s)) + emit.sum()
            NP = emit.shape[1]
            end = jnp.broadcast_to(jnp.arange(NP, dtype=jnp.int32), (B, NP))
            cand_cap = B * cfg.cand_pool
            (start, end, k, s), rid, valid, c_need = S._compact_global(
                (start, end, k, s), emit, cand_cap)
            if upto == "compact":
                return start.sum() + end.sum() + k.sum() + s.sum()
            qbeg, k, s, rdir = bw(fm, reads, rid, start, k, s, valid,
                                  text_walk=L >= 384)
            if upto == "backward":
                return qbeg.sum() + k.sum() + s.sum() + rdir.sum()
            keep = S._containment_filter(qbeg, end, rid, valid,
                                         cfg.min_seed_len)
            dt = fmops.idx_dt(fm)
            parts = []
            split_len = int(cfg.min_seed_len * cfg.split_factor + 0.499)
            qualify = keep & (end - qbeg >= split_len) & (s <= cfg.split_width)
            lane_cap = B * cfg.r2_pool
            (lrid, lx, lfloor), lvalid, l_need = S._compact_flat(
                (rid, (qbeg + end) >> 1, (s + 1).astype(dt)), qualify,
                lane_cap)
            kb, sb, eb, filled = S._reseed_forward(
                fm, reads, lens, lrid, lx, lfloor, lvalid, cfg.min_seed_len)
            if upto == "r2_walk":
                return kb.sum() + sb.sum() + eb.sum()
            E = kb.shape[1]
            flat = lambda a: jnp.broadcast_to(
                a[:, None], (lane_cap, E)).reshape(-1)
            lane_ids = flat(jnp.arange(lane_cap, dtype=jnp.int32))
            cand2_cap = B * cfg.r2_cand
            (rid2, lane2, x2, floor2, k2, s2, end2), v2, c2n = \
                S._compact_flat(
                    (flat(lrid), lane_ids, flat(lx), flat(lfloor),
                     kb.reshape(-1), sb.reshape(-1), eb.reshape(-1)),
                    filled.reshape(-1), cand2_cap)
            if upto == "r2_compact":
                return x2.sum() + k2.sum() + s2.sum()
            kw2 = ({} if pair
                   else dict(fixed_trips=16,
                             compact_schedule=((4, 2), (8, 2), (12, 4),
                                               (16, 4))))
            qb2, k2e, s2e, rdir2 = bw(
                fm, reads, rid2, x2, k2, s2, v2, floor=floor2, group=lane2,
                text_walk=False, **kw2)
            keep2 = S._containment_filter(qb2, end2, lane2, v2,
                                          cfg.min_seed_len)
            parts.append((rid2, qb2, end2, k2e, s2e, keep2, rdir2))
            if upto == "round2":
                return qb2.sum() + k2e.sum() + s2e.sum()
            x3p, k3p, s3p, emit3 = r3_planes
            L3 = emit3.shape[1]
            rid3_p = jnp.broadcast_to(
                jnp.arange(B, dtype=jnp.int32)[:, None], (B, L3))
            end3_p = jnp.broadcast_to(
                jnp.arange(L3, dtype=jnp.int32)[None, :] + 1, (B, L3))
            (rid3, qb3, end3, k3, s3), v3, c3n = S._compact_flat(
                (rid3_p.reshape(-1), x3p.reshape(-1), end3_p.reshape(-1),
                 k3p.reshape(-1), s3p.reshape(-1)),
                emit3.reshape(-1), B * cfg.r3_pool)
            parts.append((rid3, qb3, end3, k3, s3, v3 & (s3 > 0),
                          jnp.full_like(k3, -1)))
            if upto == "round3":
                return qb3.sum() + k3.sum() + s3.sum()
            cols = list(zip((rid, qbeg, end, k.astype(dt), s.astype(dt),
                             keep, rdir.astype(dt)), *parts))
            rid_m, qb_m, end_m, k_m, s_m, keep_m, rdir_m = (
                jnp.concatenate([c.astype(cols[i][0].dtype)
                                 for c in cols[i]])
                for i in range(7))
            span = jnp.int64(L + 2)
            key = jnp.where(
                keep_m,
                (rid_m.astype(jnp.int64) * span
                 + jnp.clip(qb_m, 0, L + 1).astype(jnp.int64)) * span
                + jnp.clip(end_m, 0, L + 1).astype(jnp.int64),
                jnp.int64(1) << 62)
            perm = jnp.argsort(key)
            rid_s, qbeg_s, end_s, k_s, s_s, keep_s, rdir_s = (
                a[perm] for a in (rid_m, qb_m, end_m, k_m, s_m, keep_m,
                                  rdir_m))
            if upto == "sort":
                return qbeg_s.sum() + k_s.sum()
            out = S._expand_occurrences(
                fm, rid_s, qbeg_s, end_s, k_s, s_s, keep_s,
                B * cfg.seed_pool, cfg.max_occ, rdir=rdir_s)
            return out["rbeg"].sum() + out["qbeg"].sum()

        return run

    stages = ["scan", "compact", "backward", "r2_walk", "r2_compact",
              "round2", "round3", "sort", "full"]
    prev = 0.0
    for st in stages:
        fn = stage_fn(st)
        t0 = time.perf_counter()
        float(fn(rj, lj))
        ct = time.perf_counter() - t0
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            float(fn(rj, lj))
        dt = (time.perf_counter() - t0) / reps
        print(f"{st:10s} cum={dt * 1e3:7.1f} ms  delta={1e3 * (dt - prev):7.1f} ms"
              f"  (compile {ct:.0f}s)", flush=True)
        prev = dt


if __name__ == "__main__":
    main()
