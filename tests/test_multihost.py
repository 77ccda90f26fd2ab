"""Multi-host (N=2 process) data-path parity.

The distributed design (parallel/multihost.py): hosts own
contiguous record ranges, align on local chips, write ordered SAM
shards, host 0 cats. These tests spawn two real CLI processes (CPU
backend) over a shared fixture and require the merged output to be
byte-identical to the single-host run (modulo @PG, whose CL differs).
SURVEY §2.5 last row / §5 last bullet — the reference has no
distributed backend at all (single node, src/kthread.c)."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from bwamem_tpu.parallel.multihost import record_range, take_range

ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": "/root/repo"}


def test_record_range_even():
    assert record_range(100, 0, 2) == (0, 50)
    assert record_range(100, 1, 2) == (50, 100)


def test_record_range_remainder():
    spans = [record_range(103, r, 4) for r in range(4)]
    assert spans[0][0] == 0 and spans[-1][1] == 103
    for a, b in zip(spans, spans[1:]):
        assert a[1] == b[0]
    sizes = [hi - lo for lo, hi in spans]
    assert max(sizes) - min(sizes) <= 1


def test_record_range_paired_granularity():
    # pair-aligned: no mate ever splits across hosts
    for n in (10, 14, 22, 30):
        for w in (2, 3):
            for r in range(w):
                lo, hi = record_range(n, r, w, granularity=2)
                assert lo % 2 == 0 and (hi % 2 == 0 or hi == n)


def test_take_range():
    assert list(take_range(iter(range(10)), 3, 7)) == [3, 4, 5, 6]
    assert list(take_range(iter(range(4)), 0, 4)) == [0, 1, 2, 3]
    assert list(take_range(iter(range(4)), 4, 4)) == []


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh")
    rng = np.random.default_rng(7)
    g = rng.integers(0, 4, 40000)
    bases = "ACGT"
    s = "".join(bases[c] for c in g)
    (d / "ref.fa").write_text(
        ">chr1\n" + "\n".join(s[i:i + 70] for i in range(0, len(s), 70))
        + "\n")
    with open(d / "se.fq", "w") as fq:
        for i in range(48):
            p = int(rng.integers(0, 40000 - 120))
            r = list(s[p:p + 100])
            r[int(rng.integers(0, 100))] = bases[int(rng.integers(0, 4))]
            fq.write(f"@s{i}\n{''.join(r)}\n+\n{'I' * 100}\n")
    with open(d / "r1.fq", "w") as f1, open(d / "r2.fq", "w") as f2:
        for i in range(24):
            p = int(rng.integers(0, 40000 - 320))
            a = s[p:p + 100]
            b = "".join("TGCA"[c] for c in g[p + 200:p + 300][::-1])
            f1.write(f"@p{i}\n{a}\n+\n{'I' * 100}\n")
            f2.write(f"@p{i}\n{b}\n+\n{'I' * 100}\n")
    subprocess.run(
        [sys.executable, "-m", "bwamem_tpu", "index", str(d / "ref.fa"),
         "-p", str(d / "idx")],
        check=True, env=ENV, cwd="/root/repo", capture_output=True)
    return d


def _align(extra, out, timeout=900):
    return subprocess.Popen(
        [sys.executable, "-m", "bwamem_tpu", "align"] + extra
        + ["-o", str(out)],
        env=ENV, cwd="/root/repo", stderr=subprocess.PIPE, text=True)


def _records(path):
    return [ln for ln in open(path).read().splitlines()
            if not ln.startswith("@PG")]


def _free_port():
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


@pytest.mark.parametrize("world", [2, 4])
def test_multihost_se_parity(fixture_dir, world):
    """SE byte-parity at world=2 (with a jax.distributed coordinator,
    covering the control-plane join) and world=4 (filesystem-only
    launch, exercising the remainder math + 4-way shard merge)."""
    d = fixture_dir
    base = [str(d / "idx"), str(d / "se.fq")]
    out = d / f"mh_se_{world}.sam"
    p = _align(base, d / "ref_se.sam")
    assert p.wait(900) == 0, p.stderr.read()[-800:]
    extra = (["--coordinator", f"127.0.0.1:{_free_port()}"]
             if world == 2 else [])
    procs = [
        _align(base + ["--n-hosts", str(world), "--host-id", str(r)]
               + extra, out)
        for r in range(world)
    ]
    for p in procs:
        assert p.wait(900) == 0, p.stderr.read()[-800:]
    assert _records(out) == _records(d / "ref_se.sam")
    for r in range(world):
        assert not (d / f"{out.name}.shard{r}").exists()  # shards cleaned


@pytest.mark.parametrize("world,chips", [(2, 1), (4, 1), (2, 2)])
def test_multihost_pe_parity_fixed_insert(fixture_dir, world, chips):
    """PE with -I (fixed insert model): per-host pestat re-estimation is
    vanilla per-chunk semantics but would differ from the single-host
    chunking, so parity is pinned under the fixed model. world=4 checks
    the pair-aligned (granularity=2) range math beyond 2 ways — 24
    pairs over 4 hosts leaves uneven shards. The (2, 2) cell runs each
    host over a 2-device mesh so pairs cross multihost sharding AND
    shard_map in the same run."""
    d = fixture_dir
    base = [str(d / "idx"), str(d / "r1.fq"), str(d / "r2.fq"),
            "-I", "300,30"]
    out = d / f"mh_pe_{world}_{chips}.sam"
    p = _align(base, d / "ref_pe.sam")
    assert p.wait(900) == 0, p.stderr.read()[-800:]
    chip_args = ["--n-chips", str(chips)] if chips > 1 else []
    procs = [
        _align(base + ["--n-hosts", str(world), "--host-id", str(r)]
               + chip_args, out)
        for r in range(world)
    ]
    for p in procs:
        assert p.wait(900) == 0, p.stderr.read()[-800:]
    assert _records(out) == _records(d / "ref_pe.sam")
