#!/usr/bin/env python3
"""Smoke test of the aligner's main path on one NVIDIA GPU.

    python3 chip_smoke.py              # one card: every phase below
    python3 chip_smoke.py --four-cards # four cards: --n-chips 4 vs 1 only

Phases (one card):
  1. Report the card (nvidia-smi name and power limit), JAX's version,
     devices, XLA_FLAGS and compile-cache directory. Fail unless JAX's
     platform is `gpu` and the native C++ library loads.
  2. Build a 4.6 Mbp repeat-rich genome (E. coli scale) and simulated
     150 bp reads with substitutions and indels, all from a fixed seed;
     run `python -m bwamem_tpu index`, then `align -t 4` SE (100k reads)
     and PE (50k pairs) on the card, and check the SAM against the
     simulation truth. The first SUBSET reads (SE) and pairs (PE) are
     aligned with JAX_PLATFORMS=cpu, beside the card's runs; their SAM
     (without @PG) must be byte-identical to the card's: the first SUBSET
     reads of the full SE run, and a PE run of the subset on the card
     (insert-size inference is per chunk).
  3. Compare each GPU kernel with its lax twin on the card at the shapes
     the aligner launches; outputs must be equal, and both times print.
  4. Run the GPU-only tests (`pytest -m gpu`).

Every phase runs in a child process: the parent never initialises JAX,
and only one child at a time uses the card (the CPU references never
open it). The last line of
standard output is one JSON object naming the device; any failed phase
exits non-zero before it.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, ".smoke")

SEED = 20261016
GENOME_LEN = 4_600_000
READ_LEN = 150
N_SE = 100_000
N_PAIRS = 50_000
SUBSET = 2_000          # reads (SE) and pairs (PE) compared GPU vs CPU
THREADS = 4             # align -t: exercises the HostPool fork
# Four-card phase: one sample spread over the node. The mesh path, not
# throughput, is checked, and compiles dominate a short run, so it uses
# the subset's sizes (whose --n-chips 1 programs the one-card run builds).
N_SE_4 = SUBSET
N_PAIRS_4 = SUBSET

# Truth thresholds (fraction of reads). A read is correct when its
# primary record maps to the simulated contig and strand, at a start
# (POS minus leading soft clip) within POS_SLACK of the truth. The CPU
# backend on the same genome and read simulator (2,000 SE reads, 1,000
# pairs; PERF.md, "Smoke truth") measured SE mapped 1.0, correct 0.9985,
# correct among MAPQ >= 30 1.0; PE mapped 1.0, correct 0.999, correct
# among MAPQ >= 30 1.0. The floors leave room for the repeat families'
# share to vary with the sample; this script prints the CPU subset's
# numbers on every run beside the GPU's.
POS_SLACK = 10
MIN_MAPPED = 0.995
MIN_CORRECT = 0.98
MIN_CORRECT_Q30 = 0.998


def log(msg: str) -> None:
    print(msg, flush=True)


def child_env(platform: str) -> dict:
    env = dict(os.environ, JAX_PLATFORMS=platform)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run(cmd: list[str], platform: str = "cuda", cwd: str | None = None,
        timeout: float = 900) -> subprocess.CompletedProcess:
    """Run one child to completion (in WORK unless `cwd` is given); raise
    with its stderr on failure."""
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=cwd or WORK, env=child_env(platform),
                       capture_output=True, text=True, timeout=timeout)
    return _check(cmd, platform, r, time.perf_counter() - t0)


def _check(cmd, platform, r, dt):
    log(f"[smoke] {' '.join(cmd[1:])} ({platform}): rc {r.returncode}, "
        f"{dt:.1f} s")
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-4000:] + r.stderr[-8000:])
        raise RuntimeError(f"child failed: {' '.join(cmd)}")
    return r


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        raise RuntimeError("nvidia-smi found no card")
    return r.stdout.strip().splitlines()[0]


_DEVICE_PROBE = """
import json, os, jax
from bwamem_tpu.native import loader
d = jax.devices()
print(json.dumps(dict(
    jax=jax.__version__, devices=[str(x) for x in d],
    platform=d[0].platform, kind=d[0].device_kind, count=len(d),
    native=loader.try_load() is not None,
    cache=jax.config.jax_compilation_cache_dir,
    xla_flags=os.environ.get("XLA_FLAGS", ""))))
"""


def device_report(want_count: int) -> dict:
    """Phase 1: what JAX sees, from a child that uses no CPU fallback."""
    log(f"[smoke] card: {nvidia_smi()}")
    r = run([sys.executable, "-c", _DEVICE_PROBE], cwd=HERE, timeout=300)
    info = json.loads(r.stdout.strip().splitlines()[-1])
    for k in ("jax", "devices", "xla_flags", "cache"):
        log(f"[smoke] {k}: {info[k]}")
    if info["platform"] != "gpu":
        raise RuntimeError(f"JAX platform is {info['platform']}, not gpu")
    if not info["native"]:
        raise RuntimeError("the native C++ library did not load")
    if info["count"] < want_count:
        raise RuntimeError(f"{info['count']} devices, need {want_count}")
    return info


# ------------------------------------------------------------ inputs --

def make_inputs(workdir: str, genome_len: int, n_se: int, n_pairs: int,
                seed: int = SEED) -> None:
    """Genome FASTA, SE and PE FASTQ, and a truth TSV per read set."""
    import numpy as np

    from bwamem_tpu.utils.simgenome import (make_repeat_genome,
                                             simulate_pairs, simulate_reads,
                                             write_fasta, write_fastq)

    os.makedirs(workdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    contigs, _ = make_repeat_genome(rng, genome_len, n_contigs=2)
    write_fasta(os.path.join(workdir, "ref.fa"), contigs)
    se = simulate_reads(rng, contigs, n_se, read_len=READ_LEN, sub=0.01,
                        ins=0.001, dele=0.001)
    write_fastq(os.path.join(workdir, "se.fq"), se)
    pairs = simulate_pairs(rng, contigs, n_pairs, read_len=READ_LEN,
                           sub=0.01)
    write_fastq(os.path.join(workdir, "r1.fq"), [a for a, _ in pairs])
    write_fastq(os.path.join(workdir, "r2.fq"), [b for _, b in pairs])
    with open(os.path.join(workdir, "truth.tsv"), "w") as f:
        for r in se:
            f.write(f"{r.name}\t0\t{r.contig}\t{r.pos}\t{r.strand}\n")
        for a, b in pairs:
            for k, r in ((1, a), (2, b)):
                f.write(f"{r.name}\t{k}\t{r.contig}\t{r.pos}\t"
                        f"{r.strand}\n")


def head_fastq(src: str, dst: str, n_records: int) -> None:
    with open(src) as f, open(dst, "w") as g:
        for i, line in enumerate(f):
            if i >= 4 * n_records:
                break
            g.write(line)


# ------------------------------------------------------------- truth --

def load_truth(path: str) -> dict:
    truth = {}
    with open(path) as f:
        for line in f:
            name, mate, contig, pos, strand = line.rstrip("\n").split("\t")
            truth[(name, int(mate))] = (contig, int(pos), int(strand))
    return truth


_LEAD_CLIP = re.compile(r"^(\d+)[SH]")


def truth_stats(sam_path: str, truth: dict) -> dict:
    """Fractions of reads mapped, correct, and correct among MAPQ >= 30,
    from the primary records of a SAM file."""
    n = mapped = correct = q30 = q30_ok = 0
    with open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fl = line.split("\t", 6)
            flag = int(fl[1])
            if flag & 0x900:
                continue
            mate = 1 if flag & 0x40 else 2 if flag & 0x80 else 0
            want = truth.get((fl[0], mate))
            if want is None:
                raise ValueError(f"read {fl[0]}/{mate} is not in the truth")
            n += 1
            if flag & 0x4:
                continue
            mapped += 1
            clip = _LEAD_CLIP.match(fl[5])
            start = int(fl[3]) - 1 - (int(clip.group(1)) if clip else 0)
            ok = (fl[2] == want[0] and bool(flag & 0x10) == bool(want[2])
                  and abs(start - want[1]) <= POS_SLACK)
            correct += ok
            if int(fl[4]) >= 30:
                q30 += 1
                q30_ok += ok
    if n == 0:
        raise ValueError(f"{sam_path} holds no primary records")
    return dict(reads=n, mapped=mapped / n, correct=correct / n,
                correct_q30=q30_ok / max(q30, 1), q30=q30 / n)


def check_truth(label: str, stats: dict) -> None:
    log(f"[smoke] truth {label}: " + json.dumps(
        {k: round(v, 6) if isinstance(v, float) else v
         for k, v in stats.items()}))
    bad = [k for k, lim in (("mapped", MIN_MAPPED), ("correct", MIN_CORRECT),
                            ("correct_q30", MIN_CORRECT_Q30))
           if stats[k] < lim]
    if bad:
        raise RuntimeError(f"{label}: below threshold in {bad}")


def sam_body(path: str, n_reads: int | None = None) -> bytes:
    """SAM without @PG lines; with `n_reads`, only the records of the
    first n_reads reads (a read's records are consecutive)."""
    out, last, seen = [], None, 0
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"@PG"):
                continue
            if n_reads is not None and not line.startswith(b"@"):
                name = line.split(b"\t", 1)[0]
                if name != last:
                    if seen == n_reads:
                        break
                    last, seen = name, seen + 1
            out.append(line)
    return b"".join(out)


def align(args: list[str], out: str, platform: str = "cuda") -> None:
    run([sys.executable, "-m", "bwamem_tpu", "align", "-t", str(THREADS),
         *args, "-o", out], platform=platform)


# ----------------------------------------------------------- kernels --

def ext_jobs(rng, n: int, read_len: int, qmax: int, tmax: int,
             w: int = 300):
    """Extension jobs shaped like the aligner's: the query is what is
    left of a read past a seed, the target the reference beyond it
    (clamped to qlen + w + 1), 1% substitutions; one job in ten is
    unrelated sequence and dies early."""
    import numpy as np

    qlen = rng.integers(1, read_len - 18, n).astype(np.int32)
    tlen = np.minimum(qlen + w + 1, tmax).astype(np.int32)
    T = rng.integers(0, 4, (n, tmax)).astype(np.int8)
    Q = T[:, :qmax].copy()
    sub = rng.random(Q.shape) < 0.01
    Q[sub] = (Q[sub] + 1) % 4
    junk = rng.random(n) < 0.1
    Q[junk] = rng.integers(0, 4, (int(junk.sum()), qmax))
    Q[np.arange(qmax)[None, :] >= qlen[:, None]] = 4
    T[np.arange(tmax)[None, :] >= tlen[:, None]] = 4
    h0 = rng.integers(19, 2 * read_len, n).astype(np.int32)
    return Q, T, qlen, tlen, h0


def _time(fn, reps: int = 5) -> float:
    import jax
    import numpy as np

    jax.block_until_ready(fn())          # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# (label, N, read length, QMAX, TMAX): QMAX/TMAX are the descriptor
# path's buckets for that read length (pipeline/aligner.py _run_jobs_arrays)
EXT_SHAPES = (("ext-150bp", 32768, 150, 192, 512),
              ("ext-150bp", 65536, 150, 192, 512),
              ("ext-250bp", 32768, 250, 256, 768))


def rescue_jobs(rng, n: int, read_len: int, qmax: int, tmax: int):
    """Mate-rescue jobs shaped like the aligner's: the query is a mate
    read, the target a reference window of up to tmax bases; half the
    windows hold a 1%-mutated copy of the mate, the rest miss (most
    rescue probes fail)."""
    import numpy as np

    qlen = np.full(n, read_len, np.int32)
    tlen = rng.integers(read_len, tmax + 1, n).astype(np.int32)
    T = rng.integers(0, 4, (n, tmax)).astype(np.int8)
    Q = np.full((n, qmax), 4, np.int8)
    Q[:, :read_len] = rng.integers(0, 4, (n, read_len))
    for i in np.nonzero(rng.random(n) < 0.5)[0]:
        off = int(rng.integers(0, tlen[i] - read_len + 1))
        m = T[i, off:off + read_len].copy()
        sub = rng.random(read_len) < 0.01
        m[sub] = (m[sub] + 1) % 4
        Q[i, :read_len] = m
    T[np.arange(tmax)[None, :] >= tlen[:, None]] = 4
    minsc = np.full(n, 19, np.int32)
    return Q, T, qlen, tlen, minsc


# (label, N, read length, QMAX, TMAX)
SW_SHAPES = (("rescue", 2048, 150, 256, 512),
             ("rescue", 16384, 150, 256, 512))


def kernel_phase() -> None:
    """Phase 3 (runs in a child): each GPU kernel against its lax twin on
    the card, exact equality on every output field, median times."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bwamem_tpu.ops.extend import (ExtendParams, extend_batch,
                                       make_score_matrix)
    from bwamem_tpu.ops.pallas.dp_kernel import (
        extend_batch_gpu, sw_align_batch_gpu_stacked)
    from bwamem_tpu.ops.swalign import sw_align_batch_stacked

    assert jax.default_backend() == "gpu", jax.default_backend()
    rng = np.random.default_rng(SEED)
    p = ExtendParams()
    mat = jnp.asarray(make_score_matrix(p.max_mat, p.mismatch))
    lax_fn = jax.jit(extend_batch, static_argnames=("params",))
    gpu_fn = jax.jit(extend_batch_gpu, static_argnames=("params",))
    for label, n, rl, qmax, tmax in EXT_SHAPES:
        args = [jnp.asarray(x) for x in ext_jobs(rng, n, rl, qmax, tmax)]
        want = lax_fn(*args, mat, params=p)
        got = gpu_fn(*args, params=p)
        for k in want:
            if not np.array_equal(np.asarray(got[k]), np.asarray(want[k])):
                raise RuntimeError(f"{label} N={n}: kernel != lax in {k}")
        t_lax = _time(lambda: lax_fn(*args, mat, params=p))
        t_gpu = _time(lambda: gpu_fn(*args, params=p))
        log(f"[smoke] kernel {label} N={n} QMAX={qmax} TMAX={tmax}: "
            f"equal; lax {t_lax * 1e3:.3f} ms, kernel {t_gpu * 1e3:.3f} ms")
    g = (1, 4, 6, 1, 6, 1)   # a, b, o_del, e_del, o_ins, e_ins
    for label, n, rl, qmax, tmax in SW_SHAPES:
        Q, T, ql, tl, minsc = (jnp.asarray(x)
                               for x in rescue_jobs(rng, n, rl, qmax, tmax))
        def lax_sw():
            return sw_align_batch_stacked(Q, T, ql, tl, mat, minsc, *g[2:],
                                          g[0])
        def gpu_sw():
            return sw_align_batch_gpu_stacked(Q, T, ql, tl, minsc, *g)
        if not np.array_equal(np.asarray(lax_sw()), np.asarray(gpu_sw())):
            raise RuntimeError(f"{label} N={n}: kernel != lax")
        t_lax, t_gpu = _time(lax_sw), _time(gpu_sw)
        log(f"[smoke] kernel {label} N={n} QMAX={qmax} TMAX={tmax}: "
            f"equal; lax {t_lax * 1e3:.3f} ms, kernel {t_gpu * 1e3:.3f} ms")


# ------------------------------------------------------------ phases --

def cpu_references() -> None:
    """The subsets aligned with JAX_PLATFORMS=cpu (run in a child)."""
    align(["idx", "se_sub.fq"], "se_sub_cpu.sam", platform="cpu")
    align(["idx", "r1_sub.fq", "r2_sub.fq"], "pe_sub_cpu.sam",
          platform="cpu")


def one_card() -> dict:
    info = device_report(1)
    t0 = time.perf_counter()
    make_inputs(WORK, GENOME_LEN, N_SE, N_PAIRS)
    log(f"[smoke] inputs: {GENOME_LEN} bp genome, {N_SE} SE reads, "
        f"{N_PAIRS} pairs in {time.perf_counter() - t0:.1f} s")
    run([sys.executable, "-m", "bwamem_tpu", "index", "ref.fa", "-p",
         "idx"], platform="cpu")
    for src in ("se", "r1", "r2"):
        head_fastq(os.path.join(WORK, f"{src}.fq"),
                   os.path.join(WORK, f"{src}_sub.fq"), SUBSET)
    # The CPU references run beside the GPU phases: a JAX_PLATFORMS=cpu
    # process never opens the card.
    cmd = [sys.executable, "-c",
           "import chip_smoke; chip_smoke.cpu_references()"]
    t0 = time.perf_counter()
    cpu_ref = subprocess.Popen(cmd, cwd=HERE, env=child_env("cpu"),
                               stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
    try:
        truth = load_truth(os.path.join(WORK, "truth.tsv"))
        align(["idx", "se.fq"], "se.sam")
        check_truth("SE", truth_stats(os.path.join(WORK, "se.sam"), truth))
        align(["idx", "r1.fq", "r2.fq"], "pe.sam")
        check_truth("PE", truth_stats(os.path.join(WORK, "pe.sam"), truth))
        # PE insert-size inference is per chunk, so the PE subset runs on
        # the card too; an SE read's records do not depend on its chunk
        align(["idx", "r1_sub.fq", "r2_sub.fq"], "pe_sub_gpu.sam")
    finally:
        out, err = cpu_ref.communicate(timeout=900)
    sys.stdout.write(out)
    _check(cmd, "cpu", subprocess.CompletedProcess(
        cmd, cpu_ref.returncode, out, err), time.perf_counter() - t0)
    for lib, gpu_sam in (("se", "se.sam"), ("pe", "pe_sub_gpu.sam")):
        a = sam_body(os.path.join(WORK, gpu_sam), SUBSET if lib == "se"
                     else None)
        b = sam_body(os.path.join(WORK, f"{lib}_sub_cpu.sam"))
        if a != b:
            raise RuntimeError(f"{lib.upper()} subset SAM differs GPU vs CPU")
        log(f"[smoke] {lib.upper()} subset ({SUBSET}): GPU SAM == CPU SAM "
            f"({len(a)} bytes)")
    check_truth("SE subset (CPU)", truth_stats(
        os.path.join(WORK, "se_sub_cpu.sam"), truth))
    check_truth("PE subset (CPU)", truth_stats(
        os.path.join(WORK, "pe_sub_cpu.sam"), truth))

    r = run([sys.executable, "-c",
             "import chip_smoke; chip_smoke.kernel_phase()"], cwd=HERE)
    sys.stdout.write(r.stdout)
    r = run([sys.executable, "-m", "pytest", "-m", "gpu", "-q",
             "-p", "no:cacheprovider", "tests/test_gpu_kernels.py"],
            cwd=HERE)
    log("[smoke] pytest -m gpu: " + r.stdout.strip().splitlines()[-1])
    return info


def four_cards() -> dict:
    info = device_report(4)
    make_inputs(WORK, GENOME_LEN, N_SE_4, N_PAIRS_4)
    run([sys.executable, "-m", "bwamem_tpu", "index", "ref.fa", "-p",
         "idx"], platform="cpu")
    for lib, reads in (("se", ["se.fq"]), ("pe", ["r1.fq", "r2.fq"])):
        for n in (1, 4):
            align(["--n-chips", str(n), "idx", *reads], f"{lib}_{n}.sam")
        a = sam_body(os.path.join(WORK, f"{lib}_1.sam"))
        b = sam_body(os.path.join(WORK, f"{lib}_4.sam"))
        if a != b:
            raise RuntimeError(f"{lib.upper()}: --n-chips 4 SAM differs "
                               "from --n-chips 1")
        log(f"[smoke] {lib.upper()}: --n-chips 4 SAM == --n-chips 1 "
            f"({len(a)} bytes)")
    info["count"] = 4
    return info


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="only align --n-chips 4 against --n-chips 1")
    args = ap.parse_args()
    info = four_cards() if args.four_cards else one_card()
    log(f"[smoke] card: {nvidia_smi()}")
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
