"""Benchmark. Headline (default): END-TO-END aligner throughput — the
full BWA-parity pipeline (seeding + chaining + extension + dedup +
mark-primary + SAM emit) per chip. `--device` measures the device-only
fused seed+extend step (the two stages the reference offloads to GPU).

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N}

Measured on an E. coli-scale REPEAT-RICH simulated genome
(utils/simgenome.py: isochores, SINE family, tandem/microsatellite
arrays, a segmental duplication) with 150 bp reads at 1% substitution
error — the same genome family every concordance suite runs on, so the
perf headline and the correctness evidence share a distribution.
`--random-genome` keeps the old uniform-random genome as an A/B line
(uniform random has almost no repeats: shorter backward walks, fewer
occurrences — an easier workload).

vs_baseline: BASELINE.json publishes no absolute numbers; the reference
README's single-thread end-to-end speedup is 6.8-8.7x over bwa-mem on a
2080 Ti. We normalize against 50,000 reads/s per chip, a 2080 Ti-class
throughput estimate for this read profile (so 1.0 ~= GPU parity per
chip), for BOTH metrics — the e2e number is the one that counts.

Runs on JAX's default backend and exits without a GPU.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

BASELINE_READS_PER_S = 50_000.0
N_REPEATS = int(os.environ.get("BWAMEM_BENCH_REPEATS", 3))  # median-of-N


def _require_gpu() -> dict:
    """The benchmark measures the GPU: fail without one. Returns the
    device description every result line carries."""
    import jax

    d = jax.devices()
    if d[0].platform != "gpu":
        sys.exit(f"[bench] no GPU: JAX's default backend is {d[0].platform}")
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def _bench_world(genome_len: int, seed: int = 12345, random_genome=None):
    """(codes, contig_strs, index) for the bench genome. Default:
    repeat-rich simulated genome (one contig — contig count doesn't
    change the work); --random-genome: the old uniform A/B.
    BENCH_SA_INTV overrides the SA sampling interval (default 4), so a
    seeding-cost-vs-intv sweep measures the same world the headline
    runs on."""
    from bwamem_tpu.index.build import build_index_from_codes
    from bwamem_tpu.index.format import Annotation

    sa_intv = int(os.environ.get("BENCH_SA_INTV", 4))
    if random_genome is None:
        random_genome = "--random-genome" in sys.argv
    rng = np.random.default_rng(seed)
    if random_genome:
        g = rng.integers(0, 4, genome_len, dtype=np.uint8)
        ann = Annotation(names=["ref"], lengths=[genome_len], offsets=[0])
        idx = build_index_from_codes(g, ann, sa_intv=sa_intv)
        return g, None, idx
    from bwamem_tpu.io.fastx import _CODE_LUT
    from bwamem_tpu.utils.simgenome import make_repeat_genome

    contigs, _ = make_repeat_genome(rng, genome_len, n_contigs=1)
    seq = contigs[0][1]
    g = _CODE_LUT[np.frombuffer(seq.encode(), np.uint8)].copy()
    amb = g > 3
    # pac convention: ambiguous bases stored as random ACGT (the .amb
    # sidecar records the N runs; reads over them simply mismatch)
    g[amb] = rng.integers(0, 4, int(amb.sum()), dtype=np.uint8)
    ann = Annotation(names=[contigs[0][0]], lengths=[len(g)], offsets=[0])
    idx = build_index_from_codes(g, ann, sa_intv=sa_intv)
    return g, contigs, idx


def main_e2e() -> None:
    """--e2e: full-pipeline steady-state throughput (seeding + chaining +
    extension + dedup + SAM) on one chip, reported the same way."""
    from bwamem_tpu.pipeline.aligner import MemAligner
    from bwamem_tpu.pipeline.options import MemOptions

    device = _require_gpu()
    genome_len = 4_600_000
    read_len = 150
    # 16k-read chunks; vanilla bwa's own chunk is 10 Mbp (~67k reads of
    # 150 bp)
    batch = int(os.environ.get("BWAMEM_BENCH_BATCH", 16384))
    g, _contigs, idx = _bench_world(genome_len)
    al = MemAligner(MemOptions(), idx)

    def mk(seed):
        r2 = np.random.default_rng(seed)
        names, seqs = [], []
        for i in range(batch):
            p = int(r2.integers(0, genome_len - read_len))
            r = g[p : p + read_len].copy()
            err = r2.random(read_len) < 0.01
            r[err] = (r[err] + 1) % 4
            if i % 2:
                r = (3 - r)[::-1]
            names.append(f"r{i}")
            seqs.append(r)
        return names, seqs

    for s_ in (1, 2):  # warm compiles for the shape family
        al.align_batch(*mk(s_))

    # measure through the PRODUCT path: the pipelined runtime
    # (reader/collector/finalize/writer overlap, the reference's
    # kt_pipeline equivalent) — what `bwamem-tpu mem` actually runs.
    import io

    from bwamem_tpu.io.fastx import SeqRecord
    from bwamem_tpu.pipeline.runtime import run_pipeline

    n_iter = 6  # 6 chunks: amortize pipeline ramp (lookahead=2)
    batches = [mk(s_) for s_ in range(3, 3 + n_iter)]  # outside the clock

    def records():
        for names, seqs in batches:
            for nm, sq in zip(names, seqs):
                yield SeqRecord(name=nm, seq=sq, qual=None, comment=None)

    # median-of-N streams in ONE process
    reps = N_REPEATS
    rates = []
    for rep in range(reps):
        sink = io.StringIO()
        t0 = time.perf_counter()
        n_done = run_pipeline(records(), al, batch * read_len, sink)
        dt = (time.perf_counter() - t0) / n_iter
        assert n_done == batch * n_iter
        rates.append(round(batch / dt, 1))
        print(f"[bench] SE stream {rep + 1}/{reps}: {rates[-1]} reads/s",
              file=sys.stderr)
    value = float(np.median(rates))
    result = {
        "metric": "e2e_align_reads_per_s",
        "value": value,
        "unit": "reads/s/device",
        "vs_baseline": round(value / BASELINE_READS_PER_S, 3),
        "runs": rates,
        "device": device,
    }
    print(json.dumps(result))


def main_pe() -> None:
    """--pe: steady-state PAIRED-END throughput through the pipelined
    runtime (insert inference + pairing + rescue + PE finalize), pairs/s
    per chip. vs_baseline normalizes against half the SE bar (a pair is
    two reads)."""
    import io

    from bwamem_tpu.io.fastx import SeqRecord
    from bwamem_tpu.pipeline.aligner import MemAligner
    from bwamem_tpu.pipeline.options import MemOptions
    from bwamem_tpu.pipeline.runtime import run_pipeline

    device = _require_gpu()
    genome_len = 4_600_000
    read_len = 150
    n_pairs = 8192  # 16k reads/chunk, same as SE
    g, _contigs, idx = _bench_world(genome_len, seed=777)
    al = MemAligner(MemOptions(), idx)

    def mk(seed):
        r2 = np.random.default_rng(seed)
        recs = []
        for i in range(n_pairs):
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

    for s_ in (1, 2):  # warm compiles
        batch = mk(s_)
        run_pipeline(iter(batch), al, n_pairs * 2 * read_len,
                     io.StringIO(), paired=True)

    n_iter = 6  # stream ALL chunks through ONE pipeline, like the SE
    # leg: separate run_pipeline calls per chunk serialize
    # seed->ext->finalize (no lookahead overlap) and pay the ramp n_iter
    # times.
    batches = [mk(s_) for s_ in range(3, 3 + n_iter)]

    def records():
        for batch in batches:
            yield from batch

    reps = N_REPEATS  # median-of-N (see SE leg)
    rates = []
    for rep in range(reps):
        sink = io.StringIO()
        t0 = time.perf_counter()
        n_done = run_pipeline(records(), al, n_pairs * 2 * read_len,
                              sink, paired=True)
        dt = (time.perf_counter() - t0) / n_iter
        assert n_done == 2 * n_pairs * n_iter
        rates.append(round(n_pairs / dt, 1))
        print(f"[bench] PE stream {rep + 1}/{reps}: {rates[-1]} pairs/s",
              file=sys.stderr)
    value = float(np.median(rates))
    result = {
        "metric": "e2e_align_pairs_per_s",
        "value": value,
        "unit": "pairs/s/device",
        "vs_baseline": round(value / (BASELINE_READS_PER_S / 2), 3),
        "runs": rates,
        "device": device,
    }
    print(json.dumps(result))


def main() -> None:
    import jax
    import jax.numpy as jnp

    from bwamem_tpu.index.device import DeviceFMIndex
    from bwamem_tpu.models.mem import AlignStepConfig, device_align_step

    device = _require_gpu()
    rng = np.random.default_rng(12345)
    genome_len = 4_600_000  # E. coli scale
    read_len = 150
    batch = 16384

    g, _contigs, idx = _bench_world(genome_len)
    fm = DeviceFMIndex.from_host(idx)

    pos = rng.integers(0, genome_len - read_len, batch)
    reads = np.empty((batch, read_len), np.int32)
    for i in range(batch):
        r = g[pos[i] : pos[i] + read_len].copy()
        err = rng.random(read_len) < 0.01
        r[err] = (r[err] + 1 + rng.integers(0, 3, err.sum())) % 4
        if i % 2:
            r = (3 - r)[::-1]
        reads[i] = r
    lens = np.full(batch, read_len, np.int32)

    cfg = AlignStepConfig()
    reads_j = jnp.asarray(reads)
    lens_j = jnp.asarray(lens)

    # warmup / compile
    out = device_align_step(fm, reads_j, lens_j, cfg)
    jax.block_until_ready(out)

    n_iter = 5
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out = device_align_step(fm, reads_j, lens_j, cfg)
        jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n_iter

    reads_per_s = batch / dt
    aligned = float(np.mean(np.asarray(out["score"]) > 100))
    result = {
        "metric": "device_align_reads_per_s",
        "value": round(reads_per_s, 1),
        "unit": "reads/s/device",
        "vs_baseline": round(reads_per_s / BASELINE_READS_PER_S, 3),
        "device": device,
    }
    # sanity: the step must actually be aligning
    assert aligned > 0.95, f"only {aligned:.2%} of reads aligned"
    print(json.dumps(result))


if __name__ == "__main__":
    if "--device" in sys.argv:
        main()
    elif "--pe" in sys.argv:
        main_pe()
    elif "--e2e" in sys.argv:
        main_e2e()
    else:
        # default: PE line FIRST, SE e2e line LAST (the headline)
        main_pe()
        main_e2e()
