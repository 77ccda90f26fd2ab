"""Independent correctness: concordance against the vanilla bwa oracle.

The reference's correctness methodology is golden-SAM diff against its
bundled vanilla bwa (reference: bwa_index/; BASELINE config 1 "exact SAM
golden output").  We rebuild that binary out-of-tree (the prebuilt one was
left compiled at the GPU-index OCC shift and its packed-SA restore is
write/read inconsistent — tools/build_oracle_bwa.sh) and compare primary
records on a repeat-rich synthetic genome, SE and PE.

This is the one suite the repo's own goldens cannot replace: the oracle
was not written by us.
"""
import os
import shutil
import subprocess

import numpy as np
import pytest

from bwamem_tpu.utils.simgenome import (
    make_repeat_genome, simulate_pairs, simulate_reads, write_fasta,
    write_fastq)

import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from concordance import (  # noqa: E402
    compare, ensure_oracle, parse_sam, run_ours, run_vanilla_bwa)


pytestmark = pytest.mark.skipif(
    not os.path.isdir("/root/reference/bwa_index"),
    reason="reference bwa tree not present")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("concord"))
    rng = np.random.default_rng(23)
    contigs, _ = make_repeat_genome(rng, 220_000)
    fasta = os.path.join(d, "g.fa")
    write_fasta(fasta, contigs)
    ensure_oracle()
    return d, rng, contigs, fasta


def test_se_concordance(world):
    d, rng, contigs, fasta = world
    reads = simulate_reads(rng, contigs, 700, 150)
    fq = os.path.join(d, "se.fq")
    write_fastq(fq, reads)
    theirs = parse_sam(run_vanilla_bwa(d, fasta, fq))
    ours = parse_sam(run_ours(d, fasta, fq))
    rep = compare(ours, theirs, 150)
    assert rep["total"] == len(reads)
    assert rep["agree_pct"] >= 99.5, rep["counts"]
    assert rep["exact_pct"] >= 98.0, rep["counts"]
    # MAPQ parity on dense repeats requires the vanilla 2nd/3rd seeding
    # rounds (split re-seed + LAST-like): without them the second-best
    # locus at a diverged repeat copy is never discovered and XS stays 0.
    # 88.6% round-1-only -> raised as re-seeding lands.
    # 99%+ since the int-truncated mapQ_coef_fac port (bwa stores
    # log(50) into an int field, src/bwamem.h:61 — the factor is 3)
    assert rep["mapq_within_5"] >= 98.0, rep["mapq_delta"]


def test_longread_concordance(world):
    """1 kbp reads with indel errors: exercises the long-read extension
    path (the dense DP with the band applied as a mask) against the
    independent oracle. The reference cannot run this regime at all
    (GASAL2 MAX_SEQ_LEN=300) — parity target is vanilla bwa itself.
    Prototype run: 150/150 exact (pos+strand+CIGAR) at seed 41."""
    d, rng, contigs, fasta = world
    reads = simulate_reads(rng, contigs, 100, read_len=1000, sub=0.01,
                           ins=0.002, dele=0.002, prefix="L")
    fq = os.path.join(d, "lr.fq")
    write_fastq(fq, reads)
    theirs = parse_sam(run_vanilla_bwa(d, fasta, fq))
    ours = parse_sam(run_ours(d, fasta, fq))
    rep = compare(ours, theirs, 1000)
    assert rep["total"] == len(reads)
    assert rep["agree_pct"] >= 99.0, rep["counts"]
    assert rep["exact_pct"] >= 95.0, rep["counts"]


def test_pe_concordance(world):
    d, rng, contigs, fasta = world
    pairs = simulate_pairs(rng, contigs, 350, 150)
    fq1 = os.path.join(d, "pe1.fq")
    fq2 = os.path.join(d, "pe2.fq")
    write_fastq(fq1, [a for a, _ in pairs])
    write_fastq(fq2, [b for _, b in pairs])
    theirs = parse_sam(run_vanilla_bwa(d, fasta, fq1, fq2))
    ours = parse_sam(run_ours(d, fasta, fq1, fq2))
    rep = compare(ours, theirs, 150)
    assert rep["total"] == 2 * len(pairs)
    assert rep["agree_pct"] >= 99.5, rep["counts"]
    assert rep["exact_pct"] >= 98.0, rep["counts"]
