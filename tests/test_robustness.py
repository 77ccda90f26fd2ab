"""Edge-case robustness: ambiguous bases, -a all-hits mode, read groups,
quality passthrough, empty/short reads."""
import os
import tempfile

import numpy as np
import pytest

from bwamem_tpu.index.build import build_index_from_codes
from bwamem_tpu.index.format import Annotation
from bwamem_tpu.pipeline.aligner import MemAligner
from bwamem_tpu.pipeline.options import MemOptions, MEM_F_ALL


@pytest.fixture(scope="module")
def env():
    rng = np.random.default_rng(31)
    g = rng.integers(0, 4, 30000, dtype=np.uint8)
    ann = Annotation(names=["c1", "c2"], lengths=[20000, 10000],
                     offsets=[0, 20000])
    idx = build_index_from_codes(g, ann, sa_intv=8)
    return g, idx


def test_reads_with_N_bases(env):
    """N (code 4) restarts seeding and scores -1 in extension; reads with
    scattered Ns must still map (reference: ambiguous-base restart,
    seed_gen.cu:906-916)."""
    g, idx = env
    al = MemAligner(MemOptions(), idx)
    rng = np.random.default_rng(1)
    names, seqs, truth = [], [], []
    for i in range(10):
        p = int(rng.integers(0, 20000 - 150))
        r = g[p : p + 150].copy()
        for _ in range(3):
            r[int(rng.integers(0, 150))] = 4  # N
        names.append(f"n{i}")
        seqs.append(r)
        truth.append(p)
    lines = al.align_batch(names, seqs)
    prim = {l.split("\t")[0]: l.split("\t") for l in lines
            if not int(l.split("\t")[1]) & 0x900}
    ok = sum(1 for i in range(10)
             if not int(prim[f"n{i}"][1]) & 4
             and abs(int(prim[f"n{i}"][3]) - 1 - truth[i]) <= 5)
    assert ok >= 9
    # SEQ column renders N
    assert any("N" in l.split("\t")[9] for l in lines)


def test_all_N_read_unmapped(env):
    g, idx = env
    al = MemAligner(MemOptions(), idx)
    lines = al.align_batch(["allN"], [np.full(100, 4, np.uint8)])
    assert int(lines[0].split("\t")[1]) & 4


def test_all_hits_mode(env):
    """-a (MEM_F_ALL): secondary hits of a repeated segment are emitted as
    0x100 records instead of XA."""
    g, idx = env
    # plant an exact repeat
    seg = g[1000:1100]
    g2 = g.copy()
    g2[15000:15100] = seg
    ann = Annotation(names=["c1", "c2"], lengths=[20000, 10000],
                     offsets=[0, 20000])
    idx2 = build_index_from_codes(g2, ann, sa_intv=8)
    opt = MemOptions()
    opt.flag |= MEM_F_ALL
    al = MemAligner(opt, idx2)
    lines = al.align_batch(["rep"], [seg.copy()])
    flags = [int(l.split("\t")[1]) for l in lines]
    assert len(lines) >= 2
    assert sum(1 for f in flags if f & 0x100) >= 1  # secondary emitted
    assert sum(1 for f in flags if not (f & 0x900)) == 1  # one primary


def test_xa_tag_for_repeat(env):
    """Default mode: the repeat shows up as XA:Z on the primary."""
    g, idx = env
    seg = g[1000:1100]
    g2 = g.copy()
    g2[15000:15100] = seg
    ann = Annotation(names=["c1", "c2"], lengths=[20000, 10000],
                     offsets=[0, 20000])
    idx2 = build_index_from_codes(g2, ann, sa_intv=8)
    al = MemAligner(MemOptions(), idx2)
    lines = al.align_batch(["rep"], [seg.copy()])
    assert len(lines) == 1
    assert "XA:Z:" in lines[0]
    assert int(lines[0].split("\t")[4]) == 0  # ambiguous -> mapq 0


def test_quality_passthrough(env):
    g, idx = env
    al = MemAligner(MemOptions(), idx)
    q = "".join(chr(33 + (i % 40)) for i in range(120))
    r = g[500:620].copy()
    lines = al.align_batch(["q1"], [r], [q])
    f = lines[0].split("\t")
    assert f[10] == q  # forward strand: qual verbatim
    rc = (3 - r)[::-1]
    lines = al.align_batch(["q2"], [rc], [q])
    f = lines[0].split("\t")
    assert f[10] == q[::-1]  # reverse strand: qual reversed


def test_short_read(env):
    """Reads shorter than min_seed_len are unmapped, not crashed."""
    g, idx = env
    al = MemAligner(MemOptions(), idx)
    lines = al.align_batch(["tiny"], [g[100:110].copy()])
    assert int(lines[0].split("\t")[1]) & 4


def test_alt_contig_handling(tmp_path):
    """A contig listed in <prefix>.alt is an ALT: reads matching both the
    primary locus and its ALT copy map to the PRIMARY deterministically
    (reference: is_alt precedence in mem_chain_flt/mem_mark_primary_se),
    with the alt score in the pa:f tag; without the .alt file the tie is
    hash-random with mapq 0."""
    from bwamem_tpu.index.format import FMIndex

    rng = np.random.default_rng(77)
    g1 = rng.integers(0, 4, 12000, dtype=np.uint8)
    alt_copy = g1[4000:5000]
    g = np.concatenate([g1, alt_copy])
    ann = Annotation(names=["chr1", "chr1_alt"], lengths=[12000, 1000],
                     offsets=[0, 12000])
    idx = build_index_from_codes(g, ann, sa_intv=8)
    p = str(tmp_path / "alt_idx.bmt")
    idx.save(p)
    (tmp_path / "alt_idx.alt").write_text("chr1_alt\t0\t*\n")

    read = g1[4200:4350].copy()

    # without .alt: ambiguous (mapq 0)
    al0 = MemAligner(MemOptions(), idx)
    l0 = al0.align_batch(["r"], [read.copy()])
    assert int(l0[0].split("\t")[4]) == 0

    # with .alt: primary contig wins, confident mapq, pa tag present
    idx2 = FMIndex.load(p)
    assert idx2.ann.alt_of(1) and not idx2.ann.alt_of(0)
    al = MemAligner(MemOptions(), idx2)
    lines = al.align_batch(["r"], [read.copy()])
    prim = [l for l in lines if not int(l.split("\t")[1]) & 0x900]
    assert len(prim) == 1
    f = prim[0].split("\t")
    assert f[2] == "chr1" and abs(int(f[3]) - 1 - 4200) <= 5
    assert int(f[4]) > 0
    # the ALT hit is reported via XA on the primary record
    xa = [t for t in f[11:] if t.startswith("XA:Z:")]
    assert xa and "chr1_alt" in xa[0]


def test_longread_1kb_extension_vmem(petest_idx=None):
    """1 kb reads go through the dense extension DP at their full width
    (QMAX/TMAX buckets past 1 kb); pacbio-style noise exercises
    dense-indel CIGARs through the object path."""
    import numpy as np
    from bwamem_tpu.index.build import build_index_from_codes
    from bwamem_tpu.index.format import Annotation
    from bwamem_tpu.pipeline.aligner import MemAligner
    from bwamem_tpu.pipeline.options import MemOptions

    rng = np.random.default_rng(17)
    G = 150_000
    g = rng.integers(0, 4, G, dtype=np.uint8)
    idx = build_index_from_codes(
        g, Annotation(names=["r"], lengths=[G], offsets=[0]), sa_intv=8)
    al = MemAligner(MemOptions(), idx)
    names, seqs = [], []
    for i in range(4):
        p = int(rng.integers(0, G - 1000))
        r = g[p:p + 1000]
        out = []
        for b in r:
            x = rng.random()
            if x < 0.02:
                continue
            if x < 0.04:
                out.append(int(rng.integers(0, 4)))
            out.append(int(b) if x >= 0.05 else int((b + 1) % 4))
        names.append(f"lr{i}")
        seqs.append(np.array(out, np.uint8))
    lines = al.align_batch(names, seqs)
    assert len(lines) >= 4
    mapped = [ln for ln in lines if int(ln.split("\t")[1]) & 0x4 == 0]
    assert len(mapped) >= 4


def test_seed_pool_spill_no_drops(env, monkeypatch):
    """Overflow at the pool cap splits the batch instead of dropping
    seeds (the reference aborts, seed_gen.cu:2037-2042). seed_pool's
    adaptive-retry cap is pinned at its starting size so the very first
    launch takes the spill path; results must equal an ample-pool run
    exactly."""
    from bwamem_tpu.ops.seeding import SeedConfig
    from bwamem_tpu.pipeline import poolstore

    g, idx = env
    rng = np.random.default_rng(5)
    reads = []
    for _ in range(32):
        p = int(rng.integers(0, 20000 - 80))
        reads.append(g[p:p + 80].copy())
    ample = MemAligner(MemOptions(), idx)
    want = ample.seed_batch(reads)
    monkeypatch.setitem(poolstore.POOL_CAPS, "seed_pool", 1)
    # fresh sidecar: the ample run's learned sizes must not be adopted
    # (they would lift seed_pool above the pinned cap and skip the spill)
    monkeypatch.setenv(
        "BWAMEM_TPU_POOLS",
        os.path.join(tempfile.mkdtemp(prefix="bwamem_pools_spill_"),
                     "pools.json"))
    tight = MemAligner(
        MemOptions(), idx,
        seed_cfg=SeedConfig(min_seed_len=19, max_occ=500, cand_pool=64,
                            seed_pool=1, reseed=True))
    got = tight.seed_batch(reads)
    assert got == want


def test_pool_sizes_persist_across_aligners(env, monkeypatch):
    """A converged pool configuration is written to the sidecar and a
    SECOND aligner (fresh store, as a fresh process would see) starts at
    the learned sizes — zero overflow retries (reference analog: GASAL2's pre-sized pools, src/fastmap.c:495-507)."""
    from bwamem_tpu.ops.seeding import SeedConfig
    from bwamem_tpu.pipeline import poolstore

    g, idx = env
    monkeypatch.setenv(
        "BWAMEM_TPU_POOLS",
        os.path.join(tempfile.mkdtemp(prefix="bwamem_pools_persist_"),
                     "pools.json"))
    rng = np.random.default_rng(6)
    reads = []
    for _ in range(24):
        p = int(rng.integers(0, 20000 - 100))
        reads.append(g[p:p + 100].copy())
    a1 = MemAligner(MemOptions(), idx,
                    seed_cfg=SeedConfig(seed_pool=1, reseed=True))
    a1.seed_batch(reads)
    learned = a1.seed_cfg.seed_pool
    assert learned > 1  # the tight start must have forced a retry
    # simulate a fresh process: drop the in-memory singleton so the
    # second aligner re-reads the sidecar from disk
    monkeypatch.setattr(poolstore, "_default", None)
    a2 = MemAligner(MemOptions(), idx,
                    seed_cfg=SeedConfig(seed_pool=1, reseed=True))
    import io
    import sys

    cap = io.StringIO()
    old = sys.stderr
    sys.stderr = cap
    try:
        got = a2.seed_batch(reads)
    finally:
        sys.stderr = old
    assert a2.seed_cfg.seed_pool >= learned
    assert "seed pool overflow" not in cap.getvalue()
    assert got == a1.seed_batch(reads)


def test_prefix_fetch_identical_seeds(env, monkeypatch):
    """The two-step prefix D2H (scalars first, then only the valid pool
    prefix — bench pools ship ~10 MB of mostly-garbage slots otherwise)
    must produce byte-identical seed lists to the full-pool fetch."""
    import numpy as np

    from bwamem_tpu.index.build import build_index_from_codes
    from bwamem_tpu.index.format import Annotation
    from bwamem_tpu.ops.seeding import SeedConfig
    from bwamem_tpu.pipeline.aligner import MemAligner
    from bwamem_tpu.pipeline.options import MemOptions

    rng = np.random.default_rng(31)
    g = rng.integers(0, 4, 30000, dtype=np.uint8)
    ann = Annotation(names=["c"], lengths=[30000], offsets=[0])
    idx = build_index_from_codes(g, ann, sa_intv=8)
    reads = []
    for _ in range(40):
        p = int(rng.integers(0, 30000 - 120))
        reads.append(g[p:p + 120].copy())
    full = MemAligner(MemOptions(), idx,
                      seed_cfg=SeedConfig(reseed=True)).seed_batch(reads)
    monkeypatch.setenv("BWAMEM_TPU_PREFIX_FETCH_MIN", "1")
    pref = MemAligner(MemOptions(), idx,
                      seed_cfg=SeedConfig(reseed=True)).seed_batch(reads)
    assert full == pref
