"""On-card stage breakdown of EXACTLY the bench.py --e2e workload.

Runs the same pipelined e2e run as bench.py and prints the Timings
report (seed_device / chain_native / chain2aln_native / ext_scatter /
ext_device / merge_numpy / dedup_native / reg_objects / finalize /
sam_write / collect), so the device-vs-pipeline gap is attributed
instead of guessed. Runs on JAX's default backend.

Usage: python tools/profile_chip.py [--pe] [--reads N] [--iters N]
Writes the report to stdout.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pe", action="store_true")
    ap.add_argument("--reads", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--genome", type=int, default=4_600_000)
    ap.add_argument("--random-genome", action="store_true",
                    help="old uniform-random genome (default: the "
                    "repeat-rich simgenome the headline bench runs on)")
    ap.add_argument("--no-reseed", action="store_true")
    ap.add_argument("--serial", action="store_true",
                    help="lookahead=0: no overlap, clean span attribution")
    args = ap.parse_args()

    from bwamem_tpu.index.build import build_index_from_codes
    from bwamem_tpu.index.format import Annotation
    from bwamem_tpu.io.fastx import SeqRecord
    from bwamem_tpu.pipeline.aligner import MemAligner
    from bwamem_tpu.pipeline.options import MemOptions
    from bwamem_tpu.pipeline.runtime import run_pipeline
    from bwamem_tpu.utils.timing import Timings

    rng = np.random.default_rng(12345 if not args.pe else 777)
    genome_len = args.genome
    read_len = 150
    batch = args.reads
    t_build0 = time.perf_counter()
    if args.random_genome:
        g = rng.integers(0, 4, genome_len, dtype=np.uint8)
        ann = Annotation(names=["ref"], lengths=[genome_len], offsets=[0])
        idx = build_index_from_codes(g, ann, sa_intv=4)
    else:
        # the headline bench's repeat-rich genome, bit-identical setup
        sys.argv = [sys.argv[0]]  # _bench_world peeks at sys.argv
        import bench as _bench

        g, _contigs, idx = _bench._bench_world(
            genome_len, seed=777 if args.pe else 12345)
    print(f"[profile] index build: {time.perf_counter() - t_build0:.1f}s",
          file=sys.stderr)
    opt = MemOptions()
    if args.no_reseed:
        opt.full_reseed = False
    al = MemAligner(opt, idx)

    def mk_se(seed):
        r2 = np.random.default_rng(seed)
        recs = []
        for i in range(batch):
            p = int(r2.integers(0, genome_len - read_len))
            r = g[p: p + read_len].copy()
            err = r2.random(read_len) < 0.01
            r[err] = (r[err] + 1) % 4
            if i % 2:
                r = (3 - r)[::-1]
            recs.append(SeqRecord(name=f"r{i}", seq=r, qual=None,
                                  comment=None))
        return recs

    def mk_pe(seed):
        r2 = np.random.default_rng(seed)
        recs = []
        for i in range(batch // 2):
            isize = max(260, int(r2.normal(350, 50)))
            p = int(r2.integers(0, genome_len - isize - 1))
            frag = g[p:p + isize]
            a = frag[:read_len].copy()
            b = (3 - frag[-read_len:])[::-1].copy()
            for r in (a, b):
                err = r2.random(read_len) < 0.01
                r[err] = (r[err] + 1) % 4
            recs.append(SeqRecord(name=f"p{i}", seq=a, qual=None,
                                  comment=None))
            recs.append(SeqRecord(name=f"p{i}", seq=b, qual=None,
                                  comment=None))
        return recs

    mk = mk_pe if args.pe else mk_se

    # warm compiles (same as bench.py)
    t_w0 = time.perf_counter()
    for s_ in (1, 2):
        run_pipeline(iter(mk(s_)), al, batch * read_len, io.StringIO(),
                     paired=args.pe)
    print(f"[profile] warmup: {time.perf_counter() - t_w0:.1f}s",
          file=sys.stderr)

    batches = [mk(s_) for s_ in range(3, 3 + args.iters)]

    def records():
        for b in batches:
            yield from b

    tm = Timings()
    sink = io.StringIO()
    la = 0 if args.serial else 2
    t0 = time.perf_counter()
    n_done = run_pipeline(records(), al, batch * read_len, sink, timings=tm,
                          lookahead=la, paired=args.pe)
    wall = time.perf_counter() - t0
    dt = wall / args.iters
    print(tm.report())
    print(f"[profile] stats: {al.stats}")
    # overlap efficiency: with lookahead, concurrent
    # stage spans sum past the wall clock; spans/wall > 1 means overlap
    # is real, and device_busy shows how much of the wall the chip works
    spans = dict(tm.totals)
    ssum = sum(v for k, v in spans.items() if k != "collect")
    dev = sum(spans.get(k, 0.0) for k in ("seed_device", "ext_device",
                                          "pe_rescue"))
    if wall > 0:
        print(f"[profile] overlap: wall={wall:.2f}s span_sum={ssum:.2f}s "
              f"({ssum / wall:.2f}x) device_busy={dev / wall:.1%}")
    unit = "pairs/s" if args.pe else "reads/s"
    per = (batch // 2) if args.pe else batch
    print(json.dumps({"metric": "profile_e2e", "value": round(per / dt, 1),
                      "unit": unit, "n": n_done}))


if __name__ == "__main__":
    main()
