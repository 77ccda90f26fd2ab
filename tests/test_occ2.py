"""Dinucleotide (2-step) FM tables: pair extension, 2-step SA walk,
and end-to-end seeding parity vs the single-step walk.

The occ2 table halves the serial gather-pass chains of the backward SMEM
walk and the SA lookup (the batched analog of the reference's per-base
find_occ_gpu chains, seed_gen.cu:160-272,607-663).
"""
import jax
import jax.numpy as jnp
import numpy as np

from bwamem_tpu.index.device import DeviceFMIndex
from bwamem_tpu.ops import fm as fmops
from bwamem_tpu.oracle.fmd import FMOracle


def test_pair_ext_matches_two_single_steps(tiny_index):
    g, idx = tiny_index
    fm = DeviceFMIndex.from_host(idx)
    assert fm.has_occ2
    rng = np.random.default_rng(9)

    # genuine pattern intervals (the only inputs the walk ever queries)
    ks, ss, c1s, c2s = [], [], [], []
    orc = FMOracle(idx)
    for _ in range(200):
        ln = int(rng.integers(1, 10))
        pos = int(rng.integers(2, len(g) - ln))
        pat = g[pos: pos + ln]
        iv = orc.set_intv(int(pat[0]))
        for c in pat[1:]:
            iv = orc.extend_forward(iv)[int(c)]
        ks.append(iv.k)
        ss.append(iv.s)
        c2s.append(int(g[pos - 1]))
        c1s.append(int(g[pos - 2]))
    # plus arbitrary row ranges (equality holds for any contiguous range)
    for _ in range(100):
        k = int(rng.integers(1, idx.seq_len - 1))
        s = int(rng.integers(1, idx.seq_len - k))
        ks.append(k)
        ss.append(s)
        c1s.append(int(rng.integers(0, 4)))
        c2s.append(int(rng.integers(0, 4)))

    k = jnp.asarray(ks, jnp.int32)
    s = jnp.asarray(ss, jnp.int32)
    c1 = jnp.asarray(c1s, jnp.int32)
    c2 = jnp.asarray(c2s, jnp.int32)

    k2, s2, k1, s1 = jax.jit(fmops.backward_ext2_ks_batch)(fm, k, s, c1, c2)
    # reference: two chained single steps
    rk1, rs1 = jax.jit(fmops.backward_ext_ks_batch)(fm, k, s, c2)
    rk2, rs2 = jax.jit(fmops.backward_ext_ks_batch)(
        fm, rk1, jnp.maximum(rs1, 0), c1)
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(rs1))
    np.testing.assert_array_equal(np.asarray(k1), np.asarray(rk1))
    np.testing.assert_array_equal(np.asarray(s2), np.asarray(rs2))
    # k2 is only meaningful when the pair interval is non-empty
    m = np.asarray(s2) > 0
    np.testing.assert_array_equal(np.asarray(k2)[m], np.asarray(rk2)[m])


def test_forward_ext2_matches_two_single_steps(tiny_index):
    from bwamem_tpu.ops.fm import forward_ext4_batch, forward_ext2_batch

    g, idx = tiny_index
    fm = DeviceFMIndex.from_host(idx)
    rng = np.random.default_rng(17)
    ks, ls, ss, b1s, b2s = [], [], [], [], []
    orc = FMOracle(idx)
    for _ in range(150):
        ln = int(rng.integers(1, 9))
        pos = int(rng.integers(0, len(g) - ln - 2))
        pat = g[pos: pos + ln]
        iv = orc.set_intv(int(pat[0]))
        for c in pat[1:]:
            iv = orc.extend_forward(iv)[int(c)]
        ks.append(iv.k)
        ls.append(iv.l)
        ss.append(iv.s)
        b1s.append(int(g[pos + ln]))
        b2s.append(int(g[pos + ln + 1]))
    k = jnp.asarray(ks, jnp.int32)
    l = jnp.asarray(ls, jnp.int32)
    s = jnp.asarray(ss, jnp.int32)
    b1 = jnp.asarray(b1s, jnp.int32)
    b2 = jnp.asarray(b2s, jnp.int32)

    (k1, l1, s1), (k2, l2, s2) = jax.jit(forward_ext2_batch)(
        fm, k, l, s, b1, b2)
    # reference: two chained single steps with per-lane picks
    pick = lambda m, c: np.asarray(m)[np.arange(len(ks)), np.asarray(c)]
    k4, l4, s4 = jax.jit(forward_ext4_batch)(fm, k, l, s)
    rk1, rl1, rs1 = pick(k4, b1), pick(l4, b1), pick(s4, b1)
    k4b, l4b, s4b = jax.jit(forward_ext4_batch)(
        fm, jnp.asarray(rk1), jnp.asarray(rl1),
        jnp.asarray(np.maximum(rs1, 1)))
    rk2, rl2, rs2 = pick(k4b, b2), pick(l4b, b2), pick(s4b, b2)
    np.testing.assert_array_equal(np.asarray(s1), rs1)
    np.testing.assert_array_equal(np.asarray(k1), rk1)
    np.testing.assert_array_equal(np.asarray(l1), rl1)
    m = rs1 > 0  # second step defined only on live intermediates
    np.testing.assert_array_equal(np.asarray(s2)[m], rs2[m])
    np.testing.assert_array_equal(np.asarray(k2)[m & (rs2 > 0)],
                                  rk2[m & (rs2 > 0)])
    np.testing.assert_array_equal(np.asarray(l2)[m & (rs2 > 0)],
                                  rl2[m & (rs2 > 0)])


def test_sa_lookup2_all_rows(tiny_index):
    g, idx = tiny_index
    fm = DeviceFMIndex.from_host(idx)
    orc = FMOracle(idx)
    rows = np.arange(idx.seq_len + 1, dtype=np.int32)
    got = np.asarray(jax.jit(fmops.sa_lookup2_batch)(fm, jnp.asarray(rows)))
    want = np.asarray([orc.sa_lookup(int(r)) for r in rows])
    np.testing.assert_array_equal(got, want)


def test_sa_lookup2_odd_interval():
    from bwamem_tpu.index.build import build_index_from_codes
    from bwamem_tpu.index.format import Annotation

    g = np.random.default_rng(21).integers(0, 4, 1500, dtype=np.uint8)
    ann = Annotation(names=["c"], lengths=[1500], offsets=[0])
    idx = build_index_from_codes(g, ann, sa_intv=5)
    fm = DeviceFMIndex.from_host(idx)
    orc = FMOracle(idx)
    rows = np.arange(idx.seq_len + 1, dtype=np.int32)
    got = np.asarray(jax.jit(fmops.sa_lookup2_batch)(fm, jnp.asarray(rows)))
    want = np.asarray([orc.sa_lookup(int(r)) for r in rows])
    np.testing.assert_array_equal(got, want)


def test_seeding_parity_occ2_vs_single_step(tiny_index, rng):
    from bwamem_tpu.ops.seeding import SeedConfig, smem_seed_batch

    g, idx = tiny_index
    fm2 = DeviceFMIndex.from_host(idx)
    fm1 = DeviceFMIndex.from_host(idx, occ2=False)
    assert fm2.has_occ2 and not fm1.has_occ2

    B, L = 32, 101
    reads = np.full((B, L), 4, np.int32)
    lens = np.full(B, L, np.int32)
    r2 = np.random.default_rng(33)
    for i in range(B):
        pos = int(r2.integers(0, len(g) - L))
        r = g[pos: pos + L].copy()
        err = r2.random(L) < 0.03
        r[err] = (r[err] + 1 + r2.integers(0, 3, err.sum())) % 4
        if i % 2:
            r = (3 - r)[::-1]
        if i % 7 == 0:
            r[L // 2] = 4  # ambiguous base mid-read
        reads[i] = r
    cfg = SeedConfig(cand_pool=48, seed_pool=16)
    out1 = smem_seed_batch(fm1, jnp.asarray(reads), jnp.asarray(lens), cfg)
    out2 = smem_seed_batch(fm2, jnp.asarray(reads), jnp.asarray(lens), cfg)
    for key in ("read_id", "rbeg", "qbeg", "qend", "n_occ", "valid"):
        np.testing.assert_array_equal(
            np.asarray(out1[key]), np.asarray(out2[key]), err_msg=key)


def test_seeding_parity_repetitive_genome():
    """Tandem repeats drive the contained-candidate early-kill, where the
    raw 2-step walk may legally diverge; post-filter output must not."""
    from bwamem_tpu.index.build import build_index_from_codes
    from bwamem_tpu.index.format import Annotation
    from bwamem_tpu.ops.seeding import SeedConfig, smem_seed_batch

    r = np.random.default_rng(55)
    unit = r.integers(0, 4, 83, dtype=np.uint8)
    g = np.concatenate([np.tile(unit, 30),
                        r.integers(0, 4, 1500, dtype=np.uint8),
                        np.tile(unit[:40], 20)])
    ann = Annotation(names=["c"], lengths=[len(g)], offsets=[0])
    idx = build_index_from_codes(g, ann, sa_intv=8)
    fm2 = DeviceFMIndex.from_host(idx)
    fm1 = DeviceFMIndex.from_host(idx, occ2=False)

    B, L = 24, 120
    reads = np.empty((B, L), np.int32)
    for i in range(B):
        pos = int(r.integers(0, len(g) - L))
        rd = g[pos: pos + L].copy()
        err = r.random(L) < 0.02
        rd[err] = (rd[err] + 1 + r.integers(0, 3, err.sum())) % 4
        if i % 2:
            rd = (3 - rd)[::-1]
        reads[i] = rd
    lens = np.full(B, L, np.int32)
    cfg = SeedConfig(cand_pool=64, seed_pool=48, max_occ=30)
    out1 = smem_seed_batch(fm1, jnp.asarray(reads), jnp.asarray(lens), cfg)
    out2 = smem_seed_batch(fm2, jnp.asarray(reads), jnp.asarray(lens), cfg)
    for key in ("read_id", "rbeg", "qbeg", "qend", "n_occ", "valid"):
        np.testing.assert_array_equal(
            np.asarray(out1[key]), np.asarray(out2[key]), err_msg=key)
