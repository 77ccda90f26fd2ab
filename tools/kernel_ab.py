"""A/B of the DP kernels on the card (ops/pallas/dp_kernel.py, extension
and mate-rescue SW) against their lax twins, end to end through the
aligner's pipelined runtime (SE and PE), in one process and on one card.

    python tools/kernel_ab.py [--se 20000] [--pairs 10000] [--rounds 1]
        [--trace DIR]

Each round runs the two arms in the order lax, kernel, kernel, lax; each
arm aligns the whole SE set and then the whole PE set after one untimed
warm-up of both arms. Prints one line per timed run and the span report
of the last run of each arm. With --trace, one more SE and PE run per arm
is traced with jax.profiler into DIR/<arm>-<lib>, and the device time per
XLA module and per kernel is printed.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--se", type=int, default=20_000)
    ap.add_argument("--pairs", type=int, default=10_000)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--threads", type=int, default=chip_smoke.THREADS)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    from bwamem_tpu.index.build import build_index
    from bwamem_tpu.io.fastx import read_fastx
    from bwamem_tpu.pipeline.hostpool import HostPool
    from bwamem_tpu.pipeline.options import MEM_F_PE, MemOptions

    work = os.path.join(chip_smoke.WORK, "ab")
    chip_smoke.make_inputs(work, chip_smoke.GENOME_LEN, args.se, args.pairs)
    idx = build_index(os.path.join(work, "ref.fa"))
    opts = {"se": MemOptions(), "pe": MemOptions()}
    opts["pe"].flag |= MEM_F_PE
    for o in opts.values():
        o.n_threads = args.threads
    # fork the host pools before the first device use (pipeline/hostpool)
    pools = {k: HostPool(o, idx, args.threads) for k, o in opts.items()}
    recs = {"se": list(read_fastx(os.path.join(work, "se.fq"))),
            "pe": [r for pair in zip(
                read_fastx(os.path.join(work, "r1.fq")),
                read_fastx(os.path.join(work, "r2.fq"))) for r in pair]}

    import jax

    import bwamem_tpu.ops.extend as ext
    import bwamem_tpu.ops.swalign as sw
    from bwamem_tpu.pipeline.aligner import MemAligner
    from bwamem_tpu.pipeline.runtime import run_pipeline
    from bwamem_tpu.utils.timing import Timings

    print(f"[ab] {chip_smoke.nvidia_smi()}; {jax.devices()}", flush=True)
    aligners = {k: MemAligner(o, idx) for k, o in opts.items()}

    # one set of jitted DP entry points per arm, so switching arms
    # neither retraces nor recompiles
    entry = {(ext, "extend_choose_desc_jit"): ("params", "pen_clip", "qmax",
                                               "tmax"),
             (ext, "extend_choose_jit"): ("params", "pen_clip"),
             (sw, "sw_rescue_desc_stacked"): ("a", "b", "o_del", "e_del",
                                              "o_ins", "e_ins", "tmax")}
    def fresh(f):
        # JAX caches traces by function object: each arm needs its own
        return types.FunctionType(f.__code__, f.__globals__, f.__name__,
                                  f.__defaults__, f.__closure__)

    jits = {k: {key: jax.jit(fresh(getattr(*key).__wrapped__),
                             static_argnames=st)
                for key, st in entry.items()} for k in (False, True)}

    def arm(kernel: bool):
        ext.use_gpu_kernels = sw.use_gpu_kernels = lambda: kernel
        for (mod, name), fn in jits[kernel].items():
            setattr(mod, name, fn)

    def run(lib: str) -> tuple[float, Timings]:
        t = Timings()
        sink = open(os.devnull, "w")
        t0 = time.perf_counter()
        n = run_pipeline(iter(recs[lib]), aligners[lib],
                         opts[lib].chunk_size * args.threads, sink,
                         timings=t, paired=lib == "pe",
                         host_pool=pools[lib])
        dt = time.perf_counter() - t0
        assert n == len(recs[lib]), (n, len(recs[lib]))
        return dt, t

    for kernel in (False, True):          # warm-up: compile both arms
        arm(kernel)
        for lib in ("se", "pe"):
            dt, _ = run(lib)
            print(f"[ab] warm-up {'kernel' if kernel else 'lax'} {lib}: "
                  f"{dt:.3f} s", flush=True)
    last = {}
    for _ in range(args.rounds):
        for kernel in (False, True, True, False):
            arm(kernel)
            name = "kernel" if kernel else "lax"
            for lib in ("se", "pe"):
                dt, t = run(lib)
                ext_s = t.totals.get("ext_device", 0.0) + t.totals.get(
                    "ext_dispatch", 0.0)
                print(f"[ab] {name} {lib}: {dt:.3f} s, "
                      f"{len(recs[lib]) / dt:.1f} reads/s, extension "
                      f"spans {ext_s:.3f} s, rescue SW span "
                      f"{t.totals.get('pe_rescue_sw', 0.0):.3f} s",
                      flush=True)
                last[(name, lib)] = t
    for (name, lib), t in sorted(last.items()):
        print(f"[ab] spans, last {name} {lib}:\n{t.report()}", flush=True)
    if args.trace:
        for kernel in (False, True):
            arm(kernel)
            for lib in ("se", "pe"):
                d = os.path.join(args.trace,
                                 f"{'kernel' if kernel else 'lax'}-{lib}")
                with jax.profiler.trace(d):
                    dt, _ = run(lib)
                print(f"[ab] traced {d}: {dt:.3f} s", flush=True)
                trace_summary(d)
    for p in pools.values():
        p.close()


def trace_summary(d: str, top: int = 12) -> None:
    """Device busy time of a profiler trace: the union of op intervals
    on each GPU plane, and the summed duration per event name on each
    of its lines (XLA modules, XLA ops / kernels)."""
    import glob
    from collections import defaultdict

    from jax.profiler import ProfileData

    for f in glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                       recursive=True):
        for plane in ProfileData.from_file(f).planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                tot = defaultdict(float)
                n = defaultdict(int)
                spans = []
                for ev in line.events:
                    tot[ev.name] += ev.duration_ns
                    n[ev.name] += 1
                    spans.append((ev.start_ns, ev.end_ns))
                if not spans:
                    continue
                spans.sort()
                busy, cur_s, cur_e = 0.0, *spans[0]
                for s0, e0 in spans[1:]:
                    if s0 > cur_e:
                        busy += cur_e - cur_s
                        cur_s, cur_e = s0, e0
                    else:
                        cur_e = max(cur_e, e0)
                busy += cur_e - cur_s
                window = spans[-1][1] - spans[0][0]
                print(f"[trace] {plane.name} / {line.name}: busy "
                      f"{busy / 1e6:.3f} ms of a {window / 1e6:.3f} ms "
                      f"window, {len(spans)} events", flush=True)
                for name, ns in sorted(tot.items(), key=lambda x: -x[1])[
                        :top]:
                    print(f"[trace]   {ns / 1e6:10.3f} ms  x{n[name]:<6d} "
                          f"{name[:110]}", flush=True)


if __name__ == "__main__":
    main()
