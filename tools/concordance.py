"""Concordance harness: bwamem-tpu vs the vanilla `bwa` oracle.

The reference fork's correctness methodology is golden-SAM diff against
the bundled vanilla bwa binary (reference: test script usage in
README.md / run files; the binary lives at bwa_index/bwa).  This harness
re-creates that: align the same reads with both tools on the same FASTA
(vanilla run with `-w 300 -d 0` to match the fork's mem_opt_init defaults,
reference src/bwamem.c:109-112), then compare primary records.

Diff taxonomy (each read/mate lands in exactly one bucket, first match):
  exact       rname, pos, strand, cigar all equal
  pos         rname, pos, strand equal; cigar differs (clip/indel layout)
  xa_equiv    one side's primary locus appears in the other's XA list
  score_tie   both sides report equal AS at different loci (repeat tie)
  mapq_amb    both sides mapq <= 3 (ambiguous placement either way)
  near        same rname+strand, |delta pos| <= 2*read_len (shifted rep)
  unmapped    both unmapped
  one_sided   mapped by exactly one tool
  diff        everything else (true disagreement)

Agreement = exact+pos+xa_equiv+score_tie+mapq_amb+unmapped (near and
one_sided are reported but NOT counted as agreement).

Usage: python tools/concordance.py [--size N] [--reads N] [--pairs N]
           [--out CONCORDANCE.md] [--seed N] [--vanilla-seed]
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from collections import Counter
from dataclasses import dataclass

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The prebuilt /root/reference/bwa_index/bwa segfaults (compiled at the
# GPU-index OCC shift; broken packed-SA restore) — build a fixed copy.
BWA = "/tmp/vanilla_bwa/bwa"


def ensure_oracle():
    if not os.path.exists(BWA):
        subprocess.run(["bash", os.path.join(REPO, "tools",
                                             "build_oracle_bwa.sh")],
                       check=True)
    return BWA


# ---------------------------------------------------------------- SAM parse

@dataclass
class Rec:
    flag: int
    rname: str
    pos: int        # 1-based
    mapq: int
    cigar: str
    tags: dict
    line: str

    @property
    def mapped(self):
        return not (self.flag & 4)

    @property
    def strand(self):
        return (self.flag >> 4) & 1

    def xa_loci(self):
        """[(rname, 1-based pos, strand)] from XA:Z."""
        xa = self.tags.get("XA")
        out = []
        if xa:
            for ent in xa.rstrip(";").split(";"):
                f = ent.split(",")
                if len(f) >= 2:
                    out.append((f[0], abs(int(f[1])),
                                1 if f[1].startswith("-") else 0))
        return out


def parse_sam(text: str):
    """-> {(qname, mate_bit): Rec} over primary records only."""
    out = {}
    for ln in text.splitlines():
        if not ln or ln.startswith("@"):
            continue
        f = ln.split("\t")
        flag = int(f[1])
        if flag & 0x900:            # secondary / supplementary
            continue
        tags = {}
        for t in f[11:]:
            k, _, v = t.split(":", 2)
            tags[k] = v
        key = (f[0], flag & 0xC0)
        out[key] = Rec(flag, f[2], int(f[3]), int(f[4]), f[5], tags, ln)
    return out


# ---------------------------------------------------------------- compare

def classify(a: Rec, b: Rec, read_len=150):
    if not a.mapped and not b.mapped:
        return "unmapped"
    if a.mapped != b.mapped:
        return "one_sided"
    la = (a.rname, a.pos, a.strand)
    lb = (b.rname, b.pos, b.strand)
    if la == lb:
        return "exact" if a.cigar == b.cigar else "pos"
    if lb in [(r, p, s) for (r, p, s) in a.xa_loci()] or \
       la in [(r, p, s) for (r, p, s) in b.xa_loci()]:
        return "xa_equiv"
    if a.tags.get("AS") is not None and a.tags.get("AS") == b.tags.get("AS"):
        return "score_tie"
    if a.mapq <= 3 and b.mapq <= 3:
        return "mapq_amb"
    if a.rname == b.rname and a.strand == b.strand and \
            abs(a.pos - b.pos) <= 2 * read_len:
        return "near"
    return "diff"


AGREE = {"exact", "pos", "xa_equiv", "score_tie", "mapq_amb", "unmapped"}


def compare(ours: dict, theirs: dict, read_len=150, max_examples=20):
    keys = sorted(set(ours) | set(theirs))
    counts = Counter()
    mapq_delta = Counter()
    examples = {}
    for k in keys:
        a, b = ours.get(k), theirs.get(k)
        if a is None or b is None:
            counts["missing_record"] += 1
            examples.setdefault("missing_record", []).append(
                (k, a.line if a else "<absent>", b.line if b else "<absent>"))
            continue
        c = classify(a, b, read_len)
        counts[c] += 1
        if c in ("exact", "pos"):
            d = abs(a.mapq - b.mapq)
            mapq_delta[min(d, 10)] += 1
        if c not in AGREE and len(examples.get(c, [])) < max_examples:
            examples.setdefault(c, []).append((k, a.line, b.line))
    total = sum(counts.values())
    agree = sum(v for k, v in counts.items() if k in AGREE)
    return {
        "total": total,
        "agree": agree,
        "agree_pct": 100.0 * agree / max(total, 1),
        "exact_pct": 100.0 * counts["exact"] / max(total, 1),
        "counts": dict(counts),
        "mapq_delta": dict(mapq_delta),
        "mapq_within_5": 100.0 * sum(
            v for d, v in mapq_delta.items() if d <= 5
        ) / max(sum(mapq_delta.values()), 1),
        "examples": examples,
    }


# ---------------------------------------------------------------- runners

def run_vanilla_bwa(workdir, fasta, fq1, fq2=None, extra=()):
    ensure_oracle()
    pfx = os.path.join(workdir, "vref")
    if not os.path.exists(pfx + ".sa"):
        subprocess.run([BWA, "index", "-p", pfx, fasta],
                       check=True, capture_output=True)
    cmd = [BWA, "mem", "-w", "300", "-d", "0", *extra, pfx, fq1]
    if fq2:
        cmd.append(fq2)
    r = subprocess.run(cmd, check=True, capture_output=True, text=True)
    return r.stdout


def run_ours(workdir, fasta, fq1, fq2=None, extra=(), inproc=True):
    pfx = os.path.join(workdir, "tref")
    out = os.path.join(workdir, "ours.sam")
    if inproc:
        from bwamem_tpu.cli import main as cli_main
        if not os.path.exists(pfx + ".bmt.npz"):
            assert cli_main(["index", "-p", pfx, fasta]) == 0
        args = ["align", *extra, "-o", out, pfx, fq1]
        if fq2:
            args.append(fq2)
        assert cli_main(args) == 0
    else:
        env = {**os.environ,
               "PYTHONPATH": REPO + ":" + os.environ.get("PYTHONPATH", "")}
        if not os.path.exists(pfx + ".bmt.npz"):
            subprocess.run([sys.executable, "-m", "bwamem_tpu", "index",
                            "-p", pfx, fasta], check=True, env=env)
        cmd = [sys.executable, "-m", "bwamem_tpu", "align", *extra,
               "-o", out, pfx, fq1]
        if fq2:
            cmd.append(fq2)
        subprocess.run(cmd, check=True, env=env)
    with open(out) as f:
        return f.read()


# ---------------------------------------------------------------- report

def render_report(title, results):
    lines = [f"# {title}", ""]
    for name, rep in results:
        lines += [f"## {name}", "",
                  f"- records compared: **{rep['total']}**",
                  f"- agreement: **{rep['agree_pct']:.3f}%** "
                  f"(exact {rep['exact_pct']:.3f}%)",
                  f"- mapq within ±5 (pos-agreeing): "
                  f"{rep['mapq_within_5']:.2f}%",
                  "- buckets: " + ", ".join(
                      f"{k}={v}" for k, v in sorted(
                          rep["counts"].items(), key=lambda kv: -kv[1])),
                  ""]
        if rep["examples"]:
            lines.append("### residual diffs (ours vs bwa)")
            for cat, exs in rep["examples"].items():
                lines.append(f"- **{cat}** ({rep['counts'].get(cat, 0)}):")
                for k, al, bl in exs[:5]:
                    lines.append(f"  - `{k}`")
                    lines.append(f"    - ours: `{al[:180]}`")
                    lines.append(f"    - bwa:  `{bl[:180]}`")
            lines.append("")
    lines += [
        "## Interpretation notes",
        "",
        "- `near` diffs observed so far are placements shifted by whole",
        "  units inside tandem-repeat arrays: both tools report the same",
        "  alignment score and the oracle gives MAPQ 0 — the locus is",
        "  ambiguous; the pair-rescoring tie is broken differently.",
        "- `score_tie`: identical AS at two repeat copies (segdup/SINE);",
        "  primary choice is tool-internal tie-breaking.",
        "- The oracle is the reference tree's own bwa, rebuilt at",
        "  OCC_INTV_SHIFT=7 with its packed-SA restore bug fixed",
        "  (tools/build_oracle_bwa.sh); run as `bwa mem -w 300 -d 0` to",
        "  match the fork's mem_opt_init defaults (src/bwamem.c:109-112).",
        "",
    ]
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1_000_000)
    ap.add_argument("--reads", type=int, default=4000)
    ap.add_argument("--pairs", type=int, default=2000)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--out", default=os.path.join(REPO, "CONCORDANCE.md"))
    ap.add_argument("--workdir", default="/tmp/concord")
    ap.add_argument("--ours-extra", default="",
                    help="extra CLI flags for bwamem-tpu align")
    args = ap.parse_args(argv)

    import numpy as np
    sys.path.insert(0, REPO)
    if os.environ.get("CONCORD_CPU", "1") == "1":
        os.environ["JAX_PLATFORMS"] = "cpu"  # before the first jax import
    from bwamem_tpu.utils.simgenome import (
        make_repeat_genome, simulate_pairs, simulate_reads, write_fasta,
        write_fastq)

    os.makedirs(args.workdir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    contigs, _ = make_repeat_genome(rng, args.size)
    fasta = os.path.join(args.workdir, "genome.fa")
    write_fasta(fasta, contigs)

    se = simulate_reads(rng, contigs, args.reads, args.read_len)
    fq = os.path.join(args.workdir, "se.fq")
    write_fastq(fq, se)
    pairs = simulate_pairs(rng, contigs, args.pairs, args.read_len)
    fq1 = os.path.join(args.workdir, "pe_1.fq")
    fq2 = os.path.join(args.workdir, "pe_2.fq")
    write_fastq(fq1, [a for a, _ in pairs])
    write_fastq(fq2, [b for _, b in pairs])

    extra = tuple(args.ours_extra.split()) if args.ours_extra else ()
    results = []
    print(f"[concordance] SE: {len(se)} reads ...", file=sys.stderr)
    b_se = run_vanilla_bwa(args.workdir, fasta, fq)
    o_se = run_ours(args.workdir, fasta, fq, extra=extra)
    results.append(("single-end",
                    compare(parse_sam(o_se), parse_sam(b_se),
                            args.read_len)))
    print(f"[concordance] PE: {len(pairs)} pairs ...", file=sys.stderr)
    b_pe = run_vanilla_bwa(args.workdir, fasta, fq1, fq2)
    o_pe = run_ours(args.workdir, fasta, fq1, fq2, extra=extra)
    results.append(("paired-end",
                    compare(parse_sam(o_pe), parse_sam(b_pe),
                            args.read_len)))

    rep = render_report(
        f"Concordance vs vanilla bwa 0.7.17 (`bwa mem -w 300 -d 0`), "
        f"repeat-rich genome {args.size // 1000}kb, seed {args.seed}",
        results)
    with open(args.out, "w") as f:
        f.write(rep)
    for name, r in results:
        print(f"{name}: agree {r['agree_pct']:.3f}% exact "
              f"{r['exact_pct']:.3f}% of {r['total']}  "
              f"buckets={r['counts']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
