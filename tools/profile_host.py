"""Host-side span profiler for the SE/PE pipeline.

Runs one chunk through MemAligner with fine-grained Timings attached and
prints the span report. Device spans are only meaningful on the card;
on the CPU backend (JAX_PLATFORMS=cpu) the HOST spans (chaining,
chain2aln, merge, dedup, object construction, pestat, rescue build,
finalize) are representative — use this to find Python/host hotspots
without the card.

Usage: python tools/profile_host.py [--pe] [--batch N] [--genome N]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pe", action="store_true")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--genome", type=int, default=1_000_000)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--iters", type=int, default=2)
    args = ap.parse_args()

    from bwamem_tpu.index.build import build_index_from_codes
    from bwamem_tpu.index.format import Annotation
    from bwamem_tpu.pipeline.aligner import MemAligner
    from bwamem_tpu.pipeline.options import MemOptions
    from bwamem_tpu.utils.timing import Timings

    rng = np.random.default_rng(7)
    G = args.genome
    g = rng.integers(0, 4, G, dtype=np.uint8)
    ann = Annotation(names=["ref"], lengths=[G], offsets=[0])
    t0 = time.perf_counter()
    idx = build_index_from_codes(g, ann, sa_intv=4)
    print(f"index build: {time.perf_counter() - t0:.1f}s")
    al = MemAligner(MemOptions(), idx)

    rl = args.read_len
    ins_mean, ins_std = 400, 50

    def mk(seed):
        r2 = np.random.default_rng(seed)
        names, seqs = [], []
        if args.pe:
            for i in range(args.batch // 2):
                ins = int(r2.normal(ins_mean, ins_std))
                ins = max(rl + 10, min(ins, G - 1))
                p = int(r2.integers(0, G - ins))
                frag = g[p : p + ins]
                r1 = frag[:rl].copy()
                r2b = (3 - frag[-rl:])[::-1].copy()
                for r in (r1, r2b):
                    err = r2.random(rl) < 0.01
                    r[err] = (r[err] + 1) % 4
                names += [f"p{i}", f"p{i}"]
                seqs += [r1, r2b]
        else:
            for i in range(args.batch):
                p = int(r2.integers(0, G - rl))
                r = g[p : p + rl].copy()
                err = r2.random(rl) < 0.01
                r[err] = (r[err] + 1) % 4
                if i % 2:
                    r = (3 - r)[::-1]
                names.append(f"r{i}")
                seqs.append(r)
        return names, seqs

    # warm compile
    names, seqs = mk(1)
    quals = [None] * len(seqs)
    if args.pe:
        al.align_pairs_batch(names, seqs, quals)
    else:
        al.align_batch(names, seqs, quals)

    tm = Timings()
    al.timings = tm
    t0 = time.perf_counter()
    for s in range(2, 2 + args.iters):
        names, seqs = mk(s)
        quals = [None] * len(seqs)
        with tm.span("TOTAL_collect+emit"):
            if args.pe:
                with tm.span("collect_pairs"):
                    pair_regs, pes = al.collect_pairs_batch(seqs)
                from bwamem_tpu.pipeline.hostpool import _emit_pe
                with tm.span("finalize_pe"):
                    _emit_pe(al.opt, al.idx, names, seqs, quals,
                             pair_regs, pes, 0)
            else:
                with tm.span("collect_se"):
                    regs = al.collect_regs_batch(seqs)
                with tm.span("finalize_se"):
                    al.emit_sam_batch(names, seqs, quals, regs)
    dt = time.perf_counter() - t0
    n = args.batch * args.iters
    print(tm.report())
    print(f"\n{n} reads in {dt:.2f}s = {n / dt:.0f} reads/s "
          f"({'PE' if args.pe else 'SE'}, CPU backend)")


if __name__ == "__main__":
    main()
