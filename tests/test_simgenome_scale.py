"""Default-CI mid-scale slice: 5 Mbp REPEAT-RICH simulated genome,
e2e alignment truth + vanilla-bwa concordance.

Without it the default suite's largest genomes would be uniform
random (test_ecoli_scale, 4.6 Mbp) or small repeat-rich (220 kbp
concordance fixtures) — nothing would exercise the repeat-heavy regime
(SINEs, microsatellites, segdups) at Mbp scale un-gated. This module
runs it on every CI pass; the multi-Gbp rehearsal stays opt-in
(test_chr21_scale / BWAMEM_TPU_SCALE=1).

Reference methodology: golden-SAM comparison against the bundled
vanilla bwa (reference: bwa_index/, README "Further Reading").
"""
import os
import sys

import numpy as np
import pytest

from bwamem_tpu.index.build import build_index_from_codes
from bwamem_tpu.index.format import Annotation
from bwamem_tpu.io.fastx import _CODE_LUT
from bwamem_tpu.pipeline.aligner import MemAligner
from bwamem_tpu.pipeline.options import MemOptions
from bwamem_tpu.utils.simgenome import (make_repeat_genome,
                                        simulate_reads, write_fasta,
                                        write_fastq)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

SIZE = 5_000_000


@pytest.fixture(scope="module")
def world5m(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sim5m"))
    rng = np.random.default_rng(55)
    contigs, _ = make_repeat_genome(rng, SIZE, n_contigs=2)
    fasta = os.path.join(d, "g5.fa")
    write_fasta(fasta, contigs)
    return d, rng, contigs, fasta


def _codes(contigs, rng):
    parts, names, lengths, offsets = [], [], [], []
    off = 0
    for name, seq in contigs:
        c = _CODE_LUT[np.frombuffer(seq.encode(), np.uint8)].copy()
        amb = c > 3
        c[amb] = rng.integers(0, 4, int(amb.sum()), dtype=np.uint8)
        parts.append(c)
        names.append(name)
        lengths.append(len(c))
        offsets.append(off)
        off += len(c)
    return (np.concatenate(parts),
            Annotation(names=names, lengths=lengths, offsets=offsets))


def test_e2e_truth_5mbp_repeat_genome(world5m):
    """Simulation-truth at 5 Mbp on the repeat-rich genome: >= 99% of
    150 bp reads (1% substitutions) must map to their true locus."""
    d, rng, contigs, fasta = world5m
    g, ann = _codes(contigs, rng)
    idx = build_index_from_codes(g, ann, sa_intv=8)
    al = MemAligner(MemOptions(), idx)
    reads = simulate_reads(rng, contigs, 256, 150, sub=0.01,
                           ins=0.0, dele=0.0)
    seqs = [_CODE_LUT[np.frombuffer(r.seq.encode(), np.uint8)]
            for r in reads]
    sams = al.align_batch([r.name for r in reads], seqs)
    ok = total = 0
    by_name = {}
    for line in sams:
        f = line.split("\t")
        if int(f[1]) & 0x900:  # secondary/supplementary
            continue
        by_name[f[0]] = f
    for r in reads:
        f = by_name[r.name]
        total += 1
        if (f[2] == r.contig and int(f[1]) & 16 == (16 if r.strand else 0)
                and abs(int(f[3]) - 1 - r.pos) <= 20):
            ok += 1
    assert total == len(reads)
    assert ok / total >= 0.99, f"{ok}/{total} at truth locus"


@pytest.mark.skipif(not os.path.isdir("/root/reference/bwa_index"),
                    reason="reference bwa tree not present")
def test_se_concordance_5mbp(world5m):
    """Primary-record concordance vs the independently built vanilla-bwa
    oracle on the 5 Mbp repeat genome (same harness as the 220 kbp
    suite, tools/concordance.py)."""
    from concordance import (compare, ensure_oracle, parse_sam, run_ours,
                             run_vanilla_bwa)

    d, rng, contigs, fasta = world5m
    ensure_oracle()
    reads = simulate_reads(rng, contigs, 300, 150, sub=0.01)
    fq = os.path.join(d, "se5.fq")
    write_fastq(fq, reads)
    theirs = parse_sam(run_vanilla_bwa(d, fasta, fq))
    ours = parse_sam(run_ours(d, fasta, fq))
    rep = compare(ours, theirs, 150)
    assert rep["total"] == len(reads)
    assert rep["agree_pct"] >= 99.5, rep["counts"]
    assert rep["mapq_within_5"] >= 98.0, rep["mapq_delta"]
