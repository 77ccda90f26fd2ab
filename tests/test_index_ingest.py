"""Reference index-format ingest (SURVEY §7 step 1 / §2.2).

Builds a real two-pass reference index with the in-tree binaries
(tools/build_oracle_bwa.sh compiles the shift-7 stage exactly as the
reference's build_index.sh does; the prebuilt shift-6 binary provides
the final GPU-layout .bwt), ingests it, and requires structural AND
behavioral equality with an index built natively from the same FASTA —
proving index-build equivalence against `bwa index` output."""
import os
import subprocess

import numpy as np
import pytest

from bwamem_tpu.index.build import build_index
from bwamem_tpu.index.ingest import load_reference_index

REF_BWA = "/root/reference/bwa_index/bwa"
ORACLE_BUILD = os.path.join(os.path.dirname(__file__), "..", "tools",
                            "build_oracle_bwa.sh")

pytestmark = pytest.mark.skipif(
    not os.path.exists(REF_BWA), reason="reference bwa binary not present")


@pytest.fixture(scope="module")
def ref_index(tmp_path_factory):
    d = tmp_path_factory.mktemp("ingest")
    rng = np.random.default_rng(13)
    g = rng.integers(0, 4, 30000)
    bases = "ACGT"
    s = "".join(bases[c] for c in g)
    fa = d / "ref.fa"
    fa.write_text(">seq1 first contig\n"
                  + "\n".join(s[i:i + 61] for i in range(0, 17000, 61))
                  + "\n>seq2\n"
                  + "\n".join(s[i:i + 61] for i in range(17000, 30000, 61))
                  + "\n")
    # two-pass reference build (reference: build_index.sh): shift-7
    # binary for -s sa, prebuilt shift-6 binary for the final -s bwt
    subprocess.run(["bash", ORACLE_BUILD], check=True, capture_output=True)
    pfx = str(d / "P")
    subprocess.run(["/tmp/vanilla_bwa/bwa", "index", "-s", "sa", "-r",
                    "16", "-p", pfx, str(fa)],
                   check=True, capture_output=True)
    os.unlink(pfx + ".bwt")
    subprocess.run([REF_BWA, "index", "-s", "bwt", "-p", pfx, str(fa)],
                   check=True, capture_output=True)
    os.unlink(pfx + ".bwt1")
    return d, pfx, str(fa)


def test_ingest_structures_match_native_build(ref_index):
    d, pfx, fa = ref_index
    got = load_reference_index(pfx, sa_intv=4)
    want = build_index(fa, sa_intv=4)
    assert got.l_pac == want.l_pac
    assert got.seq_len == want.seq_len
    assert got.primary == want.primary
    assert (got.L2 == want.L2).all()
    assert (got.occ_blocks == want.occ_blocks).all()
    assert (got.ssa_blocks == want.ssa_blocks).all()
    assert (got.ssa_vals == want.ssa_vals).all()
    assert (got.ssa_vals_hi == want.ssa_vals_hi).all()
    assert (got.pac_words == want.pac_words).all()
    assert got.ann.names == want.ann.names
    assert got.ann.lengths == want.ann.lengths
    assert got.ann.offsets == want.ann.offsets


def test_ingested_index_seeds_identically(ref_index):
    """Identical seed lists from both index sources (same FASTA, two
    index pipelines, same seeds)."""
    from bwamem_tpu.pipeline.aligner import MemAligner
    from bwamem_tpu.pipeline.options import MemOptions

    d, pfx, fa = ref_index
    ing = load_reference_index(pfx, sa_intv=4)
    nat = build_index(fa, sa_intv=4)
    rng = np.random.default_rng(3)
    reads = []
    for _ in range(16):
        p = int(rng.integers(0, ing.l_pac - 110))
        q = ing.get_base(np.arange(p, p + 100)).copy()
        q[int(rng.integers(0, 100))] ^= 1
        reads.append(q)
    al_i = MemAligner(MemOptions(), ing)
    al_n = MemAligner(MemOptions(), nat)
    assert al_i.seed_batch(reads) == al_n.seed_batch(reads)


def test_sa_crosscheck_detects_corruption(ref_index):
    d, pfx, fa = ref_index
    import shutil

    cpy = str(d / "C")
    for ext in (".ann", ".amb", ".pac", ".bwt", ".sa"):
        shutil.copyfile(pfx + ext, cpy + ext)
    raw = bytearray(open(cpy + ".sa", "rb").read())
    raw[56 + 4 * 7] ^= 0x40  # corrupt one sampled SA value
    open(cpy + ".sa", "wb").write(raw)
    with pytest.raises(ValueError, match="cross-check"):
        load_reference_index(cpy, sa_intv=4)


def test_cli_ingest_roundtrip(ref_index, tmp_path):
    import sys

    from bwamem_tpu.index.format import FMIndex

    d, pfx, fa = ref_index
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": "/root/repo"}
    out = subprocess.run(
        [sys.executable, "-m", "bwamem_tpu", "ingest", pfx, "-p",
         str(tmp_path / "out")],
        env=env, cwd="/root/repo", capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-500:]
    idx = FMIndex.load(str(tmp_path / "out") + ".bmt")
    want = build_index(fa, sa_intv=4)
    assert (idx.occ_blocks == want.occ_blocks).all()
    assert (idx.ssa_vals == want.ssa_vals).all()
