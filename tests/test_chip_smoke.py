"""The smoke script's CPU-testable parts: its truth checker (on hand-made
SAM records and on a tiny CPU alignment of its own simulated inputs) and
its file helpers. The script itself runs on the card."""
import os

import pytest

import chip_smoke


def _sam(tmp_path, records):
    p = tmp_path / "t.sam"
    p.write_text("@HD\tVN:1.6\n@PG\tID:x\n" + "".join(
        "\t".join(map(str, r)) + "\n" for r in records))
    return str(p)


def test_truth_stats_rules(tmp_path):
    truth = {("a", 0): ("chr1", 100, 0), ("b", 0): ("chr1", 500, 1),
             ("c", 0): ("chr2", 7, 0), ("d", 0): ("chr1", 900, 0),
             ("e", 0): ("chr1", 50, 0)}
    sam = _sam(tmp_path, [
        ("a", 0, "chr1", 101, 60, "150M", "*", 0, 0, "A", "I"),
        ("a", 256, "chr2", 1, 0, "150M", "*", 0, 0, "A", "I"),  # secondary
        ("b", 16, "chr1", 506, 60, "5S145M", "*", 0, 0, "A", "I"),
        ("c", 16, "chr2", 8, 60, "150M", "*", 0, 0, "A", "I"),  # strand
        ("d", 0, "chr1", 1200, 0, "150M", "*", 0, 0, "A", "I"),  # locus
        ("e", 4, "*", 0, 0, "*", "*", 0, 0, "A", "I"),           # unmapped
    ])
    st = chip_smoke.truth_stats(sam, truth)
    assert st["reads"] == 5
    assert st["mapped"] == pytest.approx(4 / 5)
    assert st["correct"] == pytest.approx(2 / 5)
    assert st["q30"] == pytest.approx(3 / 5)
    assert st["correct_q30"] == pytest.approx(2 / 3)
    with pytest.raises(RuntimeError, match="correct"):
        chip_smoke.check_truth("t", st)


def test_truth_stats_pairs_and_unknown_reads(tmp_path):
    truth = {("p", 1): ("chr1", 10, 0), ("p", 2): ("chr1", 200, 1)}
    ok = _sam(tmp_path, [
        ("p", 99, "chr1", 11, 60, "150M", "=", 201, 340, "A", "I"),
        ("p", 147, "chr1", 201, 60, "150M", "=", 11, -340, "A", "I")])
    st = chip_smoke.truth_stats(ok, truth)
    assert st == {"reads": 2, "mapped": 1.0, "correct": 1.0,
                  "correct_q30": 1.0, "q30": 1.0}
    chip_smoke.check_truth("pe", st)
    bad = _sam(tmp_path, [("q", 0, "chr1", 1, 60, "150M", "*", 0, 0,
                           "A", "I")])
    with pytest.raises(ValueError, match="not in the truth"):
        chip_smoke.truth_stats(bad, truth)


def test_file_helpers(tmp_path):
    src = tmp_path / "a.fq"
    src.write_text("".join(f"@r{i}\nACGT\n+\nIIII\n" for i in range(5)))
    chip_smoke.head_fastq(str(src), str(tmp_path / "b.fq"), 2)
    assert (tmp_path / "b.fq").read_text().count("@r") == 2
    sam = tmp_path / "c.sam"
    sam.write_text("@HD\tVN:1.6\n@PG\tID:x\tCL:a b\nr\t4\n"
                   "s\t0\ns\t2048\nt\t0\n")
    assert chip_smoke.sam_body(str(sam)) == \
        b"@HD\tVN:1.6\nr\t4\ns\t0\ns\t2048\nt\t0\n"
    # the first 2 reads keep all their records (s has a supplementary)
    assert chip_smoke.sam_body(str(sam), 2) == \
        b"@HD\tVN:1.6\nr\t4\ns\t0\ns\t2048\n"


def test_truth_on_tiny_cpu_run(tmp_path):
    """make_inputs + the aligner on the CPU + truth_stats, end to end, at
    a size the CPU suite affords."""
    from bwamem_tpu.index.build import build_index
    from bwamem_tpu.io.fastx import read_fastx
    from bwamem_tpu.pipeline.aligner import MemAligner
    from bwamem_tpu.pipeline.options import MemOptions

    chip_smoke.make_inputs(str(tmp_path), 120_000, 200, 0)
    idx = build_index(os.path.join(tmp_path, "ref.fa"))
    recs = list(read_fastx(os.path.join(tmp_path, "se.fq")))
    lines = MemAligner(MemOptions(), idx).align_batch(
        [r.name for r in recs], [r.seq for r in recs])
    sam = tmp_path / "se.sam"
    sam.write_text("".join(line + "\n" for line in lines))
    st = chip_smoke.truth_stats(
        str(sam), chip_smoke.load_truth(os.path.join(tmp_path, "truth.tsv")))
    assert st["reads"] == 200
    chip_smoke.check_truth("tiny SE", st)
