"""End-to-end single-end alignment on a synthetic genome."""
import numpy as np
import pytest

from bwamem_tpu.index.build import build_index_from_codes
from bwamem_tpu.index.format import Annotation
from bwamem_tpu.pipeline.aligner import MemAligner
from bwamem_tpu.pipeline.options import MemOptions


@pytest.fixture(scope="module")
def aligner():
    rng = np.random.default_rng(7)
    g = rng.integers(0, 4, 20000, dtype=np.uint8)
    ann = Annotation(names=["chr1"], lengths=[20000], offsets=[0])
    idx = build_index_from_codes(g, ann, sa_intv=8)
    return g, MemAligner(MemOptions(), idx)


def _sample_reads(rng, g, n, ln=120, n_err=3):
    names, seqs, truth = [], [], []
    for i in range(n):
        pos = int(rng.integers(0, len(g) - ln))
        r = g[pos : pos + ln].copy()
        for _ in range(n_err):
            j = int(rng.integers(0, ln))
            r[j] = (r[j] + 1 + rng.integers(0, 3)) % 4
        rev = i % 2 == 1
        if rev:
            r = (3 - r)[::-1]
        names.append(f"r{i}")
        seqs.append(r)
        truth.append((pos, rev))
    return names, seqs, truth


def test_align_batch_positions(aligner):
    g, al = aligner
    rng = np.random.default_rng(21)
    names, seqs, truth = _sample_reads(rng, g, 30)
    lines = al.align_batch(names, seqs)
    n_primary = 0
    ok = 0
    for line in lines:
        f = line.split("\t")
        flag = int(f[1])
        if flag & 0x900:
            continue
        n_primary += 1
        i = int(f[0][1:])
        tp, trev = truth[i]
        if abs(int(f[3]) - 1 - tp) <= 3 and bool(flag & 16) == trev:
            ok += 1
    assert n_primary == 30
    assert ok >= 29  # rare legitimate clip shifts allowed


def test_align_batch_fields(aligner):
    g, al = aligner
    rng = np.random.default_rng(22)
    names, seqs, _ = _sample_reads(rng, g, 6, n_err=2)
    lines = al.align_batch(names, seqs)
    for line in lines:
        f = line.split("\t")
        assert len(f) >= 11
        flag = int(f[1])
        if flag & 4:
            continue
        assert f[2] == "chr1"
        assert f[5] != "*"
        tags = {t.split(":")[0] for t in f[11:]}
        assert {"NM", "MD", "AS"} <= tags
        # MD must be consistent with CIGAR M-length
        import re
        m_len = sum(int(x) for x, op in re.findall(r"(\d+)([MIDSH])", f[5])
                    if op == "M")
        md = [t for t in f[11:] if t.startswith("MD:Z:")][0][5:]
        md_len = sum(int(x) for x in re.findall(r"(\d+)", md)) + \
            len(re.findall(r"[ACGTN]", re.sub(r"\^[ACGTN]+", "", md)))
        assert md_len == m_len, (f[5], md)


def test_unmapped_read(aligner):
    g, al = aligner
    rng = np.random.default_rng(23)
    # random read not from the genome: should come back unmapped (flag 4)
    r = rng.integers(0, 4, 120, dtype=np.uint8)
    lines = al.align_batch(["junk"], [r])
    assert len(lines) == 1
    f = lines[0].split("\t")
    assert int(f[1]) & 4 or int(f[4]) == 0  # unmapped or mapq 0


def test_read_with_n_bases(aligner):
    g, al = aligner
    rng = np.random.default_rng(24)
    pos = 5000
    r = g[pos : pos + 120].copy()
    r[40] = 4
    r[41] = 4
    lines = al.align_batch(["nn"], [r])
    prim = [l for l in lines if not int(l.split("\t")[1]) & 0x900]
    assert len(prim) == 1
    assert abs(int(prim[0].split("\t")[3]) - 1 - pos) <= 2


def test_align_one_convenience(tiny_index):
    """mem_align1-equivalent one-read API (reference: src/bwamem_extra.c:82)."""
    from bwamem_tpu.pipeline.aligner import MemAligner
    from bwamem_tpu.pipeline.options import MemOptions

    g, idx = tiny_index
    al = MemAligner(MemOptions(), idx)
    frag = "".join("ACGT"[c] for c in g[300:420])
    lines = al.align_one(frag, name="one")
    f = lines[0].split("\t")
    assert f[0] == "one" and not int(f[1]) & 4
    assert int(f[3]) - 1 == 300


def test_fastmap_output_format(tmp_path, capsys=None):
    """fastmap subcommand emits the reference's SQ/EM block format
    (reference: src/fastmap.c main_fastmap): SQ name len, then one EM
    line per SMEM with qb, qe, n_occ and up to max hits chrom:+-pos."""
    import os
    import subprocess
    import sys

    import numpy as np

    from bwamem_tpu.index.build import build_index_from_codes
    from bwamem_tpu.index.format import Annotation

    rng = np.random.default_rng(3)
    G = 60_000
    g = rng.integers(0, 4, G, dtype=np.uint8)
    idx = build_index_from_codes(
        g, Annotation(names=["z1"], lengths=[G], offsets=[0]), sa_intv=8)
    pfx = tmp_path / "fmidx"
    idx.save(str(pfx) + ".bmt")
    p = int(rng.integers(0, G - 120))
    s = "".join("ACGT"[c] for c in g[p:p + 120])
    fq = tmp_path / "q.fq"
    fq.write_text(f"@q0\n{s}\n+\n{'I' * 120}\n")
    # Force the child onto the CPU backend so it never contends with the
    # parent for a single device (see tests/test_cli_io.py).
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": "/root/repo"}
    out = subprocess.run(
        [sys.executable, "-m", "bwamem_tpu", "fastmap",
         str(pfx), str(fq)],
        capture_output=True, text=True, cwd="/root/repo", env=env)
    assert out.returncode == 0, out.stderr[-500:]
    lines = [ln for ln in out.stdout.splitlines() if ln]
    assert lines[0].startswith("SQ\tq0\t120")
    ems = [ln for ln in lines if ln.startswith("EM\t")]
    assert ems, out.stdout
    f = ems[0].split("\t")
    qb, qe, n = int(f[1]), int(f[2]), int(f[3])
    assert 0 <= qb < qe <= 120 and n >= 1
    assert f[4].startswith("z1:+") or f[4].startswith("z1:-")
    assert lines[-1] == "//"
