"""chr21-scale (46.7 Mbp) end-to-end: build, align, oracle concordance.

Makes the chr21-scale claim a test in the suite: a repeat-rich genome at the BASELINE config-2 size (hg38 chr21,
46,709,983 bp) goes through the REAL toolchain — native SA-IS index
build, the full aligner pipeline, and vanilla-bwa concordance — not a
seeding-only microcheck. Opt-in (BWAMEM_TPU_SCALE=1): the run costs
~20 min on a 1-vCPU host, most of it the two index builds.
"""
import os
import sys

import numpy as np
import pytest

from bwamem_tpu.utils.simgenome import (RepeatSpec, make_repeat_genome,
                                        simulate_reads, write_fasta,
                                        write_fastq)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from concordance import (  # noqa: E402
    compare, ensure_oracle, parse_sam, run_ours, run_vanilla_bwa)

pytestmark = [
    pytest.mark.skipif(os.environ.get("BWAMEM_TPU_SCALE") != "1",
                       reason="opt-in scale test (BWAMEM_TPU_SCALE=1)"),
    pytest.mark.skipif(not os.path.isdir("/root/reference/bwa_index"),
                       reason="reference bwa tree not present"),
]

SIZE = 46_709_983  # hg38 chr21 (BASELINE config 2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("chr21"))
    rng = np.random.default_rng(21)
    # repeat density matched to the 150 kb fixture (1 SINE per ~750 b,
    # segdup scaled up to 500 kb — chr21's real repeat content is richer
    # still, but this already stresses max_occ subsampling and XA)
    spec = RepeatSpec(sine_copies=SIZE // 750, tandem_arrays=SIZE // 20_000,
                      segdup_len=500_000, n_runs=40)
    contigs, _ = make_repeat_genome(rng, SIZE, spec=spec, n_contigs=2)
    fasta = os.path.join(d, "g.fa")
    write_fasta(fasta, contigs)
    ensure_oracle()
    return d, rng, contigs, fasta


def test_chr21_scale_e2e(world):
    d, rng, contigs, fasta = world
    reads = simulate_reads(rng, contigs, 2000, 150)
    fq = os.path.join(d, "r.fq")
    write_fastq(fq, reads)
    ours = parse_sam(run_ours(d, fasta, fq))
    # sim-truth: primary position within 200 bp of the sampled locus
    # (repeat placements make some multi-mapping legitimate)
    ok = n = 0
    for r in reads:
        rec = ours.get((r.name, 0))
        if rec is None:
            continue
        n += 1
        if (rec.rname == r.contig and abs(rec.pos - 1 - r.pos) <= 200):
            ok += 1
    assert n == len(reads)
    assert ok / n >= 0.95, (ok, n)

    theirs = parse_sam(run_vanilla_bwa(d, fasta, fq))
    rep = compare(ours, theirs, 150)
    assert rep["total"] == len(reads), rep["counts"]
    assert rep["agree_pct"] >= 99.5, rep["counts"]
    assert rep["mapq_within_5"] >= 98.0, rep["mapq_delta"]
