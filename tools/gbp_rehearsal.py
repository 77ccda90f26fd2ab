"""Human-genome-scale dress rehearsal (BASELINE configs #3/#4).

Builds a synthetic repeat-rich genome of --gbp gigabases, indexes it
with the native SA-IS (recording per-phase wall time + peak host RSS),
loads the index HBM-resident at --sa-intv, and runs device seeding plus
full e2e alignment on sampled read chunks. This exercises the split
hi/lo SA words (>2^32 doubled positions) and the occ2-off big-genome
path end-to-end — the same scale regime as the reference's packed
upper-bits SA (/root/reference/bwa_index/bwt.c:88-116) and its GRCh38
two-pass build flow (build_index.sh).

The built index is cached under /tmp/bwamem_gbp_<Gbp>_<intv>.bmt.npz so
repeat invocations skip the ~30-60 min 1-vCPU build. Prints one JSON
line of results. Runs on JAX's default backend.

Usage:
  python tools/gbp_rehearsal.py [--gbp 1.0] [--sa-intv 8] [--reads 16384]
      [--chunks 3] [--build-only]
"""
from __future__ import annotations

import json
import os
import resource
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _arg(flag, default, cast=float):
    if flag in sys.argv:
        return cast(sys.argv[sys.argv.index(flag) + 1])
    return default


def _rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def build_world(gbp: float, sa_intv: int, cache: str):
    """(codes, FMIndex, build_report). Cached on disk."""
    from bwamem_tpu.index.format import Annotation, FMIndex
    from bwamem_tpu.io.fastx import _CODE_LUT
    from bwamem_tpu.utils.simgenome import RepeatSpec, make_repeat_genome

    size = int(gbp * 1e9)
    rng = np.random.default_rng(31)
    rep = {"genome_bp": size, "sa_intv": sa_intv}

    codes_cache = f"/tmp/bwamem_gbp_{gbp:g}_codes.npy"
    if os.path.exists(codes_cache) and os.path.exists(cache):
        t0 = time.perf_counter()
        g = np.load(codes_cache, mmap_mode="r")
        idx = FMIndex.load(cache)
        rep["index_load_s"] = round(time.perf_counter() - t0, 1)
        print(f"[gbp] cached codes+index loaded in {rep['index_load_s']}s",
              flush=True)
        return g, idx, rep
    if os.path.exists(codes_cache):
        # codes cached but this sa_intv's index isn't (the A/B case):
        # skip the ~6-15 min pure-Python genome regeneration
        g = np.load(codes_cache, mmap_mode="r")
        names = [f"gbp{i}" for i in range(2)]
        half = len(g) // 2
        lengths, offsets = [half, len(g) - half], [0, half]
        from bwamem_tpu.index.build import build_index_from_codes

        ann = Annotation(names=names, lengths=lengths, offsets=offsets)
        t0 = time.perf_counter()
        idx = build_index_from_codes(np.asarray(g), ann, sa_intv=sa_intv)
        rep["index_build_s"] = round(time.perf_counter() - t0, 1)
        rep["rss_after_build_gb"] = round(_rss_gb(), 2)
        t0 = time.perf_counter()
        idx.save(cache)
        rep["index_save_s"] = round(time.perf_counter() - t0, 1)
        rep["index_file_gb"] = round(os.path.getsize(cache) / 1e9, 2)
        return g, idx, rep

    t0 = time.perf_counter()
    # repeat density ~1 SINE / 2 kb: repeat-rich enough to stress
    # max_occ subsampling without a multi-hour pure-Python placement loop
    spec = RepeatSpec(sine_copies=size // 2000,
                      tandem_arrays=size // 100_000,
                      segdup_len=min(1_000_000, size // 8),
                      homopolymers=size // 50_000,
                      str_arrays=size // 100_000,
                      n_runs=max(4, size // 50_000_000))
    contigs, _ = make_repeat_genome(rng, size, spec=spec, n_contigs=2)
    g_parts, names, lengths, offsets = [], [], [], []
    off = 0
    for name, seq in contigs:
        c = _CODE_LUT[np.frombuffer(seq.encode(), np.uint8)].copy()
        amb = c > 3
        c[amb] = rng.integers(0, 4, int(amb.sum()), dtype=np.uint8)
        g_parts.append(c)
        names.append(name)
        lengths.append(len(c))
        offsets.append(off)
        off += len(c)
    del contigs
    g = np.concatenate(g_parts)
    del g_parts
    rep["genome_gen_s"] = round(time.perf_counter() - t0, 1)
    rep["rss_after_gen_gb"] = round(_rss_gb(), 2)
    print(f"[gbp] genome generated: {size / 1e9:.2f} Gbp in "
          f"{rep['genome_gen_s']}s rss={rep['rss_after_gen_gb']} GB",
          flush=True)

    np.save(codes_cache, g)
    if os.path.exists(cache):
        t0 = time.perf_counter()
        idx = FMIndex.load(cache)
        rep["index_load_s"] = round(time.perf_counter() - t0, 1)
        print(f"[gbp] cached index loaded in {rep['index_load_s']}s",
              flush=True)
        return g, idx, rep

    from bwamem_tpu.index.build import build_index_from_codes

    ann = Annotation(names=names, lengths=lengths, offsets=offsets)
    t0 = time.perf_counter()
    idx = build_index_from_codes(g, ann, sa_intv=sa_intv)
    rep["index_build_s"] = round(time.perf_counter() - t0, 1)
    rep["rss_after_build_gb"] = round(_rss_gb(), 2)
    print(f"[gbp] index built in {rep['index_build_s']}s "
          f"(peak rss={rep['rss_after_build_gb']} GB)", flush=True)
    t0 = time.perf_counter()
    idx.save(cache)
    rep["index_save_s"] = round(time.perf_counter() - t0, 1)
    rep["index_file_gb"] = round(os.path.getsize(cache) / 1e9, 2)
    return g, idx, rep


def main() -> None:
    gbp = _arg("--gbp", 1.0)
    sa_intv = int(_arg("--sa-intv", 8, int))
    n_reads = int(_arg("--reads", 16384, int))
    n_chunks = int(_arg("--chunks", 3, int))
    cache = f"/tmp/bwamem_gbp_{gbp:g}_{sa_intv}.bmt.npz"

    g, idx, rep = build_world(gbp, sa_intv, cache)
    if "--build-only" in sys.argv:
        _persist(rep)
        return

    import jax
    import jax.numpy as jnp  # noqa: F401

    from bwamem_tpu.pipeline.aligner import MemAligner
    from bwamem_tpu.pipeline.options import MemOptions

    dev = jax.devices()[0]
    rep["backend"] = dev.platform
    al = MemAligner(MemOptions(), idx)

    # HBM budget of the resident index
    fm = al.fm
    hbm = {}
    for f in ("occ_blocks", "ssa_vals", "ssa_vals_hi", "pac_words",
              "occ2_blocks"):
        a = getattr(fm, f, None)
        if a is not None and hasattr(a, "nbytes"):
            hbm[f] = round(a.nbytes / 1e9, 3)
    rep["hbm_index_gb"] = hbm
    rep["hbm_index_total_gb"] = round(sum(hbm.values()), 3)
    rep["occ2_resident"] = bool(fm.has_occ2)
    print(f"[gbp] HBM index footprint: {rep['hbm_index_total_gb']} GB "
          f"{hbm} occ2={fm.has_occ2}", flush=True)

    L = 150
    rng = np.random.default_rng(7)

    def mk_chunk(seed):
        r2 = np.random.default_rng(seed)
        names, seqs = [], []
        for i in range(n_reads):
            p = int(r2.integers(0, len(g) - L))
            r = g[p:p + L].copy()
            err = r2.random(L) < 0.01
            r[err] = (r[err] + 1) % 4
            if i % 2:
                r = (3 - r)[::-1]
            names.append(f"q{seed}_{i}")
            seqs.append(r)
        return names, seqs

    # seeding-only span (the SA-walk cost at this sa_intv is the
    # scaling question)
    names, seqs = mk_chunk(1)
    t0 = time.perf_counter()
    al.seed_batch_arrays(seqs)
    rep["seed_first_s"] = round(time.perf_counter() - t0, 2)  # + compile
    t0 = time.perf_counter()
    al.seed_batch_arrays(seqs)
    dt = time.perf_counter() - t0
    rep["seed_steady_s"] = round(dt, 3)
    rep["seed_reads_per_s"] = round(n_reads / dt, 1)
    print(f"[gbp] seeding: {rep['seed_reads_per_s']} reads/s "
          f"(chunk {dt:.2f}s)", flush=True)

    # full e2e alignment chunks
    done = 0
    t0 = time.perf_counter()
    for c in range(n_chunks):
        names, seqs = mk_chunk(100 + c)
        quals = [None] * len(seqs)
        regs = al.collect_regs_batch(seqs)
        al.emit_sam_batch(names, seqs, quals, regs)
        done += len(seqs)
        if c == 0:  # drop the compile-heavy first chunk from the rate
            t0 = time.perf_counter()
            done = 0
    dt = time.perf_counter() - t0
    if done:
        rep["e2e_reads_per_s"] = round(done / dt, 1)
        print(f"[gbp] e2e: {rep['e2e_reads_per_s']} reads/s "
              f"({done} reads in {dt:.1f}s, first chunk excluded)",
              flush=True)
    rep["rss_final_gb"] = round(_rss_gb(), 2)
    _persist(rep)


def _persist(rep: dict) -> None:
    print(json.dumps(rep), flush=True)


if __name__ == "__main__":
    main()
