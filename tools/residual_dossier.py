"""Residual-diff dossiers for the worst concordance cells.

For each selected flag cell (the <99% floors of the flag matrix plus the
pacbio long-read cell) this runs BOTH tools, takes every record the
concordance comparator does NOT count as agreement, and commits a
per-cell dossier with the full SAM lines and an automated tie-break
verdict derived from both tools' AS/XS/XA tags and the simulator's
truth locus:

  tie_equal_AS   both primaries report the same alignment score at
                 different loci -> legitimate repeat ambiguity
  ours_better    our AS is strictly higher (we found a better local
                 alignment; by BWA's own objective this is not an error)
  bwa_better     bwa's AS is strictly higher -> POTENTIAL BUG, must fix
  sub_tie        the lower-scoring tool's own XS equals its AS (its
                 second-best locus ties its best -> placement ambiguous)
  one_sided      mapped by exactly one tool (dossier shows both lines)

The -A2 cell caught a real merge bug in round 2 (seedlen0*a fix,
commit 2e86000) exactly because this class of mining pays; the dossier
makes the remaining residuals inspectable instead of asserted-away.

Usage: python tools/residual_dossier.py [--outdir tests/data/residuals]
Exit code 1 if any cell contains a `bwa_better` residual.
"""
from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from concordance import (  # noqa: E402
    AGREE, classify, compare, ensure_oracle, parse_sam, run_ours,
    run_vanilla_bwa)

# (cell id, flags, paired?, read_len, n_reads, error profile)
CELLS = [
    ("match_2_rescale", ("-A", "2"), False, 150, 2000, {}),
    ("mismatch_2", ("-B", "2"), False, 150, 2000, {}),
    ("chain_extend_3", ("-N", "3"), False, 150, 2000, {}),
    ("pe_skip_rescue", ("-S",), True, 150, 800, {}),
    ("pacbio", ("-x", "pacbio"), False, 1000, 150,
     dict(sub=0.04, ins=0.03, dele=0.03)),
]


def _truth_of(reads):
    return {r.name: (r.contig, r.pos, r.strand) for r in reads}


def _verdict(a, b, truth):
    """a = ours, b = bwa (primary Rec objects)."""
    if a.mapped != b.mapped:
        return "one_sided"
    try:
        as_a = int(a.tags.get("AS", "nan"))
        as_b = int(b.tags.get("AS", "nan"))
    except ValueError:
        return "no_AS"
    if as_a == as_b:
        return "tie_equal_AS"
    if as_a > as_b:
        # bwa's own XS: does bwa know a locus scoring as high as ours?
        xs_b = b.tags.get("XS")
        if xs_b is not None and int(xs_b) >= as_b:
            return "ours_better+bwa_sub_tie"
        return "ours_better"
    # as_a < as_b: we scored lower. If OUR second-best ties our best the
    # locus choice was ambiguous for us, but bwa still found more score
    # somewhere -> must investigate.
    return "bwa_better"


def _fmt_rec(tag, r):
    return f"    - {tag}: `{r.line[:240]}`"


def run_cell(workdir, name, flags, paired, read_len, n, errkw, contigs,
             simmod):
    import numpy as np

    d = os.path.join(workdir, name)
    os.makedirs(d, exist_ok=True)
    fasta = os.path.join(workdir, "genome.fa")
    rng = np.random.default_rng(hash(name) % 2**31)
    if paired:
        pairs = simmod.simulate_pairs(rng, contigs, n, read_len,
                                      prefix=f"{name[:2]}")
        fq1 = os.path.join(d, "r1.fq")
        fq2 = os.path.join(d, "r2.fq")
        simmod.write_fastq(fq1, [a for a, _ in pairs])
        simmod.write_fastq(fq2, [b for _, b in pairs])
        truth = _truth_of([a for a, _ in pairs] + [b for _, b in pairs])
        theirs = parse_sam(run_vanilla_bwa(d, fasta, fq1, fq2,
                                           extra=flags))
        ours = parse_sam(run_ours(d, fasta, fq1, fq2, extra=flags))
    else:
        reads = simmod.simulate_reads(rng, contigs, n, read_len,
                                      prefix=f"{name[:2]}", **errkw)
        fq = os.path.join(d, "r.fq")
        simmod.write_fastq(fq, reads)
        truth = _truth_of(reads)
        theirs = parse_sam(run_vanilla_bwa(d, fasta, fq, extra=flags))
        ours = parse_sam(run_ours(d, fasta, fq, extra=flags))

    rep = compare(ours, theirs, read_len)
    residuals = []
    for k in sorted(set(ours) | set(theirs)):
        a, b = ours.get(k), theirs.get(k)
        if a is None or b is None:
            residuals.append((k, "missing_record", a, b))
            continue
        c = classify(a, b, read_len)
        if c not in AGREE:
            residuals.append((k, c, a, b))
    lines = [f"# Residual dossier: cell `{name}` (flags: "
             f"`{' '.join(flags)}`)", "",
             f"- records: {rep['total']}, agreement "
             f"{rep['agree_pct']:.3f}%, residuals: {len(residuals)}",
             f"- buckets: {rep['counts']}", ""]
    verdicts = {}
    for k, c, a, b in residuals:
        qname = k[0]
        t = truth.get(qname)
        if a is None or b is None:
            v = "missing_record"
        else:
            v = _verdict(a, b, t)
        verdicts[v] = verdicts.get(v, 0) + 1
        lines.append(f"- `{qname}` mate={k[1]} bucket={c} "
                     f"**verdict={v}** truth={t}")
        if a is not None:
            lines.append(_fmt_rec("ours", a))
        if b is not None:
            lines.append(_fmt_rec("bwa ", b))
    lines += ["", f"## verdict summary: {verdicts}", ""]
    if verdicts.get("bwa_better") or verdicts.get("missing_record"):
        lines.append("**ACTION REQUIRED: non-tie residuals present.**")
    else:
        lines.append("All residuals are equal-score ties, strictly "
                     "better placements by our tool, or one-sided "
                     "mappings at ambiguous loci — no score regressions "
                     "vs the oracle.")
    return "\n".join(lines) + "\n", verdicts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir",
                    default=os.path.join(REPO, "tests", "data",
                                         "residuals"))
    ap.add_argument("--workdir", default="/tmp/residuals")
    ap.add_argument("--size", type=int, default=150_000)
    ap.add_argument("--seed", type=int, default=51)
    args = ap.parse_args(argv)

    import numpy as np

    if os.environ.get("CONCORD_CPU", "1") == "1":
        os.environ["JAX_PLATFORMS"] = "cpu"  # before the first jax import
    from bwamem_tpu.utils import simgenome as simmod

    ensure_oracle()
    os.makedirs(args.workdir, exist_ok=True)
    os.makedirs(args.outdir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    contigs, _ = simmod.make_repeat_genome(rng, args.size)
    simmod.write_fasta(os.path.join(args.workdir, "genome.fa"), contigs)

    bad = 0
    for name, flags, paired, rl, n, errkw in CELLS:
        print(f"[dossier] {name} ...", file=sys.stderr)
        text, verdicts = run_cell(args.workdir, name, flags, paired, rl,
                                  n, errkw, contigs, simmod)
        with open(os.path.join(args.outdir, f"{name}.md"), "w") as f:
            f.write(text)
        print(f"  {name}: {verdicts}", file=sys.stderr)
        bad += verdicts.get("bwa_better", 0) + \
            verdicts.get("missing_record", 0)
    print(f"[dossier] total must-fix residuals: {bad}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
