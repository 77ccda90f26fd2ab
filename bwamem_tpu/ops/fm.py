"""Batched FM-index primitives on device: occ, bi-interval extension, LF,
SA lookup.

Batched re-expression of the reference's GPU FM machinery
(reference: src/GPUSeed/seed_gen.cu:57-272 pop_count/bwt_occ_gpu/
find_occ4_gpu, :607-663 locate_seeds_gpu): rank queries are one 32-byte
row gather (occ checkpoint + 64 packed bases) followed by masked 2-bit
popcounts; the SA walk is a fixed-trip LF loop bounded by the
text-position sampling interval (see index/format.py).

Width conventions (genome scale: human fwd+rev needs 33-bit rows; the
reference threads split 33-bit positions through its kernels,
seed_gen.cu:530-531,943):
  * BWT rows / text positions / interval sizes / L2: int64 (a small
    share of the work — gathers dominate);
  * occ block indices (row >> 6, < 2^27): int32 — gather indices stay
    narrow;
  * per-block checkpoint counts: uint32 in memory (each base's global
    count < 2^32), widened to int64 after the popcount.

Design notes baked into the shapes: dependent gather passes serialize,
so rank pairs are fused into single passes; tiny-table lookups (a
4-entry L2, a 17-entry mask table) would also lower to gathers and are
computed arithmetically instead.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..index.device import DeviceFMIndex

# 2-bit code c replicated 16x
_PAT = [0x00000000, 0x55555555, 0xAAAAAAAA, 0xFFFFFFFF]

_I64 = jnp.int64
_U32 = jnp.uint32



def idx_dt(fm):
    """Row/position dtype for this index: int64 only when needed."""
    return jnp.int64 if fm.wide else jnp.int32


def _prim(fm):
    return fm.primary.astype(idx_dt(fm))


def _L2(fm):
    return fm.L2.astype(idx_dt(fm))


def _prefix_mask(r_w):
    """uint32 mask keeping the top 2*r_w bits, r_w in [0, 16] — computed
    arithmetically (table lookups are gathers)."""
    full = _U32(0xFFFFFFFF)
    sh = jnp.clip(32 - 2 * r_w, 0, 31).astype(_U32)
    m = (full << sh) & full
    return jnp.where(r_w <= 0, _U32(0), m)


def _select4(vec4, c):
    """vec4[c] for c in 0..3 without a gather (compare + sum)."""
    sel = (jnp.arange(4, dtype=jnp.int32) == c).astype(vec4.dtype)
    return (vec4 * sel).sum(dtype=vec4.dtype)


def _row_base_counts(row, dt=_I64):
    """Checkpoint counts of a gathered occ row (stored uint32), widened to
    the index dtype."""
    return row[..., :4].astype(_U32).astype(dt)


def _blk_of(j):
    """Occ block index of adjusted row j (int64) as an int32 gather index."""
    return (j >> 6).astype(jnp.int32)


def _count_codes_masked(words, r):
    """Count occurrences of each 2-bit code among the first `r` bases of a
    4-word (64-base) group. words: (4,) int32; r: scalar int in [0, 64].
    Returns (4,) int64."""
    w = words.astype(_U32)  # (4,)
    r_w = jnp.clip(jnp.asarray(r, jnp.int32)
                   - 16 * jnp.arange(4, dtype=jnp.int32), 0, 16)
    masks = _prefix_mask(r_w)  # (4,)
    pats = jnp.asarray(_PAT, dtype=_U32)  # (4,)
    x = w[None, :] ^ pats[:, None]          # (code, word)
    y = ~x
    pairs = y & (y >> 1) & _U32(0x55555555)
    pairs = pairs & masks[None, :]
    return jax.lax.population_count(pairs).sum(axis=1).astype(_I64)


def occ4(fm: DeviceFMIndex, i):
    """Counts of bases 0..3 in BWT$[0:i] (sentinel excluded). i: scalar in
    [0, seq_len+1]. Returns (4,) index-dtype."""
    dt = idx_dt(fm)
    i = jnp.asarray(i, dt)
    j = i - (i > _prim(fm)).astype(dt)
    row = fm.occ_blocks[_blk_of(j)]  # (8,)
    return _row_base_counts(row, dt) + _count_codes_masked(
        row[4:], (j & 63).astype(jnp.int32)).astype(dt)


def occ1(fm: DeviceFMIndex, i, c):
    """Count of base c in BWT$[0:i] — single-code fast path."""
    dt = idx_dt(fm)
    i = jnp.asarray(i, dt)
    j = i - (i > _prim(fm)).astype(dt)
    row = fm.occ_blocks[_blk_of(j)]
    r = (j & 63).astype(jnp.int32)
    w = row[4:].astype(_U32)
    r_w = jnp.clip(r - 16 * jnp.arange(4, dtype=jnp.int32), 0, 16)
    c = jnp.asarray(c, jnp.int32)
    pat = c.astype(_U32) * _U32(0x55555555)
    y = ~(w ^ pat)
    pairs = y & (y >> 1) & _U32(0x55555555)
    pairs = pairs & _prefix_mask(r_w)
    base = _select4(_row_base_counts(row, dt), c)
    return base + jax.lax.population_count(pairs).sum().astype(dt)


def lf(fm: DeviceFMIndex, row):
    """LF mapping over BWT$ rows; LF(primary) = 0. One row gather serves
    both the BWT symbol and the rank."""
    dt = idx_dt(fm)
    row = jnp.asarray(row, dt)
    j = row - (row > _prim(fm)).astype(dt)
    occ_row = fm.occ_blocks[_blk_of(j)]
    r = (j & 63).astype(jnp.int32)
    w4 = occ_row[4:].astype(_U32)
    word = _select4(w4.astype(jnp.int32), r >> 4).astype(_U32)
    c = ((word >> (30 - 2 * (r & 15)).astype(_U32)) & 3).astype(jnp.int32)
    r_w = jnp.clip(r - 16 * jnp.arange(4, dtype=jnp.int32), 0, 16)
    pat = c.astype(_U32) * _U32(0x55555555)
    y = ~(w4 ^ pat)
    pairs = y & (y >> 1) & _U32(0x55555555) & _prefix_mask(r_w)
    occ_c = (_select4(_row_base_counts(occ_row, dt), c)
             + jax.lax.population_count(pairs).sum().astype(dt))
    l2c = _select4(_L2(fm)[:4], c)
    dest = l2c + 1 + occ_c
    return jnp.where(row == _prim(fm), dt(0), dest)


def bwt_char(fm: DeviceFMIndex, row):
    """BWT$ symbol at `row` (0..3; caller handles row == primary)."""
    dt = idx_dt(fm)
    row = jnp.asarray(row, dt)
    j = row - (row > _prim(fm)).astype(dt)
    r = (j & 63).astype(jnp.int32)
    w4 = fm.occ_blocks[_blk_of(j)][4:].astype(jnp.int32)
    w = _select4(w4, r >> 4).astype(_U32)
    return ((w >> (30 - 2 * (r & 15)).astype(_U32)) & 3).astype(jnp.int32)


def backward_ext_ks(fm: DeviceFMIndex, k, s, c):
    """Backward extension of the k-side interval only (prepend base c).
    Scalar reference version; the hot path uses backward_ext_ks_batch."""
    dt = idx_dt(fm)
    ok = occ1(fm, k, c)
    ol = occ1(fm, jnp.asarray(k, dt) + jnp.asarray(s, dt), c)
    l2c = _select4(_L2(fm)[:4], jnp.asarray(c, jnp.int32))
    return l2c + 1 + ok, ol - ok


def _occ_pair_rows(fm: DeviceFMIndex, a, b):
    """Gather occ rows for row-indices a and b (each (P,) int64) in ONE
    fused pass. Returns (rows_a, rows_b, r_a, r_b) with r_* the in-block
    offsets (int32)."""
    i2 = jnp.concatenate([a, b])
    j = i2 - (i2 > _prim(fm)).astype(i2.dtype)
    rows = fm.occ_blocks[_blk_of(j)]
    r = (j & 63).astype(jnp.int32)
    P = a.shape[0]
    return rows[:P], rows[P:], r[:P], r[P:]


def _word_prefix_masks(r, W: int, data_lo: int, n_words: int):
    """(P, W) uint32 per-column prefix masks: packed-data column
    data_lo + w keeps its first clip(r - 16w) bases; all other columns 0.
    Lets rank kernels consume gathered rows WHOLE — slicing a gathered
    array makes XLA fission the gather into one narrow gather per
    slice."""
    col = jnp.arange(W, dtype=jnp.int32)[None, :]
    w_of = col - data_lo
    pm = _prefix_mask(jnp.clip(r[:, None] - 16 * w_of, 0, 16))
    in_range = (col >= data_lo) & (col < data_lo + n_words)
    return jnp.where(in_range, pm, _U32(0))


def _col_pick(rows, c, dt):
    """rows[i, c[i]] via a masked reduce over the full row (no slice)."""
    col = jnp.arange(rows.shape[1], dtype=jnp.int32)[None, :]
    picked = jnp.where(col == c[:, None], rows.astype(_U32), _U32(0))
    return picked.sum(axis=1, dtype=_U32).astype(dt)


def _rank1(rows, r, c, dt=_I64, data_lo: int = 4):
    """Count of code c among the first r bases of each gathered row.
    rows: (P, W) int32 with count columns 0..3 and 4 packed-data words at
    columns [data_lo, data_lo+4); r, c: (P,) int32. Returns (P,) dt.
    Full-row consumption (no slicing; see _word_prefix_masks)."""
    u = rows.astype(_U32)
    pat = (c.astype(_U32) * _U32(0x55555555))[:, None]
    y = ~(u ^ pat)
    bits = y & (y >> 1) & _U32(0x55555555)
    bits = bits & _word_prefix_masks(r, rows.shape[1], data_lo, 4)
    pc = jax.lax.population_count(bits).sum(axis=1).astype(dt)
    return _col_pick(rows, c, dt) + pc


def backward_ext_ks_batch(fm: DeviceFMIndex, k, s, c):
    """Batched backward_ext_ks over (P,) int64 intervals with the two rank
    gathers fused into ONE row-gather pass (dependent passes serialize;
    the reference fuses the same pair into shared cache lines,
    seed_gen.cu:160-272 find_occ_gpu)."""
    dt = idx_dt(fm)
    k = k.astype(dt)
    s = s.astype(dt)
    rows_k, rows_ks, r_k, r_ks = _occ_pair_rows(fm, k, k + s)
    c32 = c.astype(jnp.int32)
    ok = _rank1(rows_k, r_k, c32, dt)
    ol = _rank1(rows_ks, r_ks, c32, dt)
    sel = (jnp.arange(4, dtype=jnp.int32)[None, :] == c32[:, None])
    l2c = jnp.where(sel, _L2(fm)[:4][None, :], 0).sum(axis=1, dtype=dt)
    return l2c + 1 + ok, ol - ok


def _rank4(rows, r, dt=_I64, data_lo: int = 4):
    """Counts of all 4 codes among the first r bases of each gathered row.
    rows: (P, W) int32 (counts at cols 0..3, data at [data_lo,
    data_lo+4)); r: (P,) int32. Returns (P, 4) dt. Full-row consumption."""
    u = rows.astype(_U32)
    masks = _word_prefix_masks(r, rows.shape[1], data_lo, 4)
    pats = (jnp.arange(4, dtype=_U32) * _U32(0x55555555))[None, :, None]
    y = ~(u[:, None, :] ^ pats)
    bits = y & (y >> 1) & _U32(0x55555555) & masks[:, None, :]
    pc = jax.lax.population_count(bits).sum(axis=2).astype(dt)
    col = jnp.arange(rows.shape[1], dtype=jnp.int32)[None, None, :]
    base = jnp.where(col == jnp.arange(4, dtype=jnp.int32)[None, :, None],
                     u[:, None, :], _U32(0)).sum(axis=2, dtype=_U32)
    return base.astype(dt) + pc


def backward_ext4(fm: DeviceFMIndex, k, l, s):
    """All four backward extensions of bi-interval (k, l, s). Scalar
    reference version. Returns (k4, l4, s4), each (4,) int64."""
    dt = idx_dt(fm)
    k = jnp.asarray(k, dt)
    l = jnp.asarray(l, dt)
    s = jnp.asarray(s, dt)
    ok = occ4(fm, k)
    ol = occ4(fm, k + s)
    cnt = ol - ok
    cnt_sent = jnp.logical_and(k <= _prim(fm), _prim(fm) < k + s)
    k4 = _L2(fm)[:4] + 1 + ok
    s4 = cnt
    suffix = jnp.cumsum(cnt[::-1], dtype=cnt.dtype)[::-1] - cnt
    l4 = l + cnt_sent.astype(dt) + suffix
    return k4, l4, s4


def forward_ext4(fm: DeviceFMIndex, k, l, s):
    """All four forward extensions (append base b). Scalar reference
    version. Returns (k4, l4, s4), index = appended base."""
    bk4, bl4, bs4 = backward_ext4(fm, l, k, s)
    return bl4[::-1], bk4[::-1], bs4[::-1]


def forward_ext4_batch(fm: DeviceFMIndex, k, l, s):
    """Batched forward extension over (P,) int64 bi-intervals, both rank
    gathers fused into ONE pass. Returns (k4, l4, s4), each (P, 4)."""
    dt = idx_dt(fm)
    k = k.astype(dt)
    l = l.astype(dt)
    s = s.astype(dt)
    rows_l, rows_ls, r_l, r_ls = _occ_pair_rows(fm, l, l + s)
    ok = _rank4(rows_l, r_l, dt)
    ol = _rank4(rows_ls, r_ls, dt)
    cnt = ol - ok                                  # (P, 4) per prepended c
    cnt_sent = jnp.logical_and(l <= _prim(fm), _prim(fm) < l + s)
    bk4 = _L2(fm)[:4][None, :] + 1 + ok
    suffix = (jnp.cumsum(cnt[:, ::-1], axis=1, dtype=cnt.dtype)[:, ::-1]
              - cnt)
    bl4 = k[:, None] + cnt_sent[:, None].astype(dt) + suffix
    bs4 = cnt
    return bl4[:, ::-1], bk4[:, ::-1], bs4[:, ::-1]


def set_intv(fm: DeviceFMIndex, c):
    """Initial bi-interval of single base c (c in 0..3)."""
    L2 = _L2(fm)
    k = L2[c] + 1
    l = L2[3 - c] + 1
    s = L2[c + 1] - L2[c]
    return k, l, s


@partial(jax.jit, static_argnames=("K",))
def kmer_intv_table(fm: DeviceFMIndex, K: int = 8):
    """(4^K, 3) table of bi-intervals (k, l, s) for every K-mer; code =
    c_0*4^(K-1) + ... + c_{K-1} with c_0 the leftmost base. Built in K-1
    batched forward-extension rounds, so every entry is bit-identical to
    stepping the walk base by base.

    The idea is the reference's pre-computed seed-interval table
    (reference: src/GPUSeed/seed_gen.cu:1169-1205
    pre_calc_seed_intervals_gpu, vestigial there; SURVEY §2.4 flags it as
    worth keeping): a fresh walk can skip its first K dependent rank
    gathers with one table-row gather. Only sound for walks with no
    emissions in the first K steps — see DESIGN.md §seeding; used by the
    fixed-length bowtie seed modes (-u 2/4)."""
    L2 = _L2(fm)
    k = L2[:4] + 1
    l = L2[jnp.array([3, 2, 1, 0])] + 1
    s = L2[1:5] - L2[:4]
    for _ in range(K - 1):
        k4, l4, s4 = forward_ext4_batch(fm, k, l, s)
        k, l, s = k4.reshape(-1), l4.reshape(-1), s4.reshape(-1)
    return jnp.stack([k, l, s], axis=1)


_KMER_TABLE_CACHE: dict = {}


def get_kmer_table(fm: DeviceFMIndex, K: int = 8):
    """Process-lifetime cache of kmer_intv_table per device index."""
    key = (id(fm.occ_blocks), K)
    tab = _KMER_TABLE_CACHE.get(key)
    if tab is None:
        tab = _KMER_TABLE_CACHE[key] = kmer_intv_table(fm, K)
    return tab


def _match_bits(w, pat):
    """Per-base match bitmask (01 pattern) of packed words vs code."""
    y = ~(w ^ pat)
    return y & (y >> 1) & _U32(0x55555555)


# occ2 pair-table layout constants (build_occ2_host: 128 rows/block,
# pair counts at cols 0..15, packed 4-bit pair codes at cols 16..31)
_O2_SHIFT = 7
_O2_MASK = 127
_O2_DATA = 16


def _nib_prefix_masks(r):
    """(P, 32) uint32 per-column 4-bit-granular prefix masks: data column
    _O2_DATA + w keeps its first clip(r - 8w) nibbles; others 0."""
    col = jnp.arange(32, dtype=jnp.int32)[None, :]
    q = jnp.clip(r[:, None] - 8 * (col - _O2_DATA), 0, 8)
    full = _U32(0xFFFFFFFF)
    sh = jnp.clip(32 - 4 * q, 0, 31).astype(_U32)
    pm = jnp.where(q <= 0, _U32(0), (full << sh) & full)
    return jnp.where(col >= _O2_DATA, pm, _U32(0))


def _rank_pair_single(fm, rows, r, j, d, dt=_I64):
    """(pair-rank of code d, single-rank of code d&3) over gathered occ2
    rows — ONE nibble-match chain serves both: a nibble equals d iff all
    4 bit-matches hold, and its BWT char equals d&3 iff the low 2 hold.
    Full-row consumption, no lane rolls (both break gather fusion)."""
    u = rows.astype(_U32)
    pm = _nib_prefix_masks(r)
    y = ~(u ^ (d.astype(_U32) * _U32(0x11111111))[:, None])
    low2 = y & (y >> 1) & _U32(0x11111111) & pm
    all4 = low2 & (y >> 2) & (y >> 3)
    pc2 = jax.lax.population_count(all4).sum(axis=1).astype(dt)
    pc1 = jax.lax.population_count(low2).sum(axis=1).astype(dt)
    col = jnp.arange(32, dtype=jnp.int32)[None, :]
    base2 = jnp.where(col == d[:, None], u, _U32(0)).sum(
        axis=1, dtype=_U32).astype(dt)
    csel = (col < 16) & ((col & 3) == (d & 3)[:, None])
    base1 = jnp.where(csel, u, _U32(0)).sum(axis=1, dtype=_U32).astype(dt)
    # bogus-row corrections (previous char = sentinel at row sa1_j): the
    # stored nibble is (0, cur); pair counts exclude it, single includes
    sa1_j = fm.sa1_scalars[0].astype(j.dtype)
    sa1_pair = fm.sa1_scalars[1]
    bogus = ((d == sa1_pair)
             & ((j >> _O2_SHIFT) == (sa1_j >> _O2_SHIFT))
             & ((sa1_j & _O2_MASK).astype(jnp.int32) < r))
    back = (((d & 3) == (sa1_pair & 3))
            & ((sa1_j >> _O2_SHIFT) < (j >> _O2_SHIFT)))
    return (base2 + pc2 - bogus.astype(dt),
            base1 + pc1 + back.astype(dt))


def _sel16(tbl, d, dt):
    """tbl[d] for d in 0..15 without a gather. tbl: (16,); d: (P,)."""
    sel = (jnp.arange(16, dtype=jnp.int32)[None, :] == d[:, None])
    return jnp.where(sel, tbl.astype(dt)[None, :], 0).sum(axis=1, dtype=dt)


def _occ2_pair_rows(fm: DeviceFMIndex, a, b):
    """Gather occ2 rows for BWT$ row-indices a and b in ONE fused pass.
    Returns (rows_a, rows_b, j_a, j_b, r_a, r_b)."""
    i2 = jnp.concatenate([a, b])
    j = i2 - (i2 > _prim(fm)).astype(i2.dtype)
    rows = fm.occ2_blocks[(j >> _O2_SHIFT).astype(jnp.int32)]
    r = (j & _O2_MASK).astype(jnp.int32)
    P = a.shape[0]
    return rows[:P], rows[P:], j[:P], j[P:], r[:P], r[P:]


def backward_ext2_ks_batch(fm: DeviceFMIndex, k, s, c1, c2):
    """2-step backward extension of the k-side interval: prepend c2 then
    c1 (i.e. the new prefix is c1 c2 + current suffix) using the
    dinucleotide occ2 table — ONE fused row-gather pass yields BOTH the
    pair result and the single-step (c2 only) fallback:
      returns (k2, s2, k1, s1).
    Semantics: (k2, s2) == backward_ext_ks(backward_ext_ks(k,s,c2), c1);
    (k1, s1) == backward_ext_ks(k, s, c2).
    """
    dt = idx_dt(fm)
    k = k.astype(dt)
    s = s.astype(dt)
    P = k.shape[0]
    i2 = jnp.concatenate([k, k + s])
    j = i2 - (i2 > _prim(fm)).astype(i2.dtype)
    rows = fm.occ2_blocks[(j >> _O2_SHIFT).astype(jnp.int32)]
    r = (j & _O2_MASK).astype(jnp.int32)
    c2_32 = c2.astype(jnp.int32)
    d = (c1.astype(jnp.int32) << 2) | c2_32
    # one rank computation over BOTH endpoints (the wide ops run once on
    # the (2P, 32) gathered rows instead of twice on each half)
    d2 = jnp.concatenate([d, d])
    r2_, r1_ = _rank_pair_single(fm, rows, r, j, d2, dt)
    ok2, ol2 = r2_[:P], r2_[P:]
    ok1, ol1 = r1_[:P], r1_[P:]
    k2 = _sel16(fm.occ2_start, d, dt) + ok2
    s2 = ol2 - ok2
    sel = (jnp.arange(4, dtype=jnp.int32)[None, :] == c2_32[:, None])
    l2c = jnp.where(sel, _L2(fm)[:4][None, :], 0).sum(axis=1, dtype=dt)
    k1 = l2c + 1 + ok1
    s1 = ol1 - ok1
    return k2, s2, k1, s1


def _rank4p(fm, rows, r, j, dt=_I64):
    """All-4-code single ranks from gathered occ2 pair rows: checkpoint =
    per-cur sums of the 16 pair counts, in-block = low-2-bit nibble match
    chains. Only 3 of 4 codes are counted explicitly — in-block counts
    sum to r and checkpoint sums to the 16-column total — and the three
    popcounts ride ONE packed weighted reduction (counts <= 128 fit in a
    byte each). Returns (P, 4) dt (+ the bogus-row add-back)."""
    u = rows.astype(_U32)
    pm = _nib_prefix_masks(r)
    col = jnp.arange(32, dtype=jnp.int32)[None, :]
    sa1_j = fm.sa1_scalars[0]
    sa1_c = (fm.sa1_scalars[1] & 3).astype(jnp.int32)
    packed = jnp.zeros(u.shape, _U32)
    for c in range(3):
        y = ~(u ^ _U32(c * 0x11111111))
        low2 = y & (y >> 1) & _U32(0x11111111) & pm
        packed += jax.lax.population_count(low2).astype(_U32) << _U32(8 * c)
    psum = packed.sum(axis=1, dtype=_U32)
    pcs = [(psum >> _U32(8 * c)).astype(jnp.int32) & 255 for c in range(3)]
    pcs.append(r - pcs[0] - pcs[1] - pcs[2])
    in16 = jnp.where(col < 16, u, _U32(0)).sum(axis=1, dtype=_U32)
    bases = []
    for c in range(3):
        csel = (col < 16) & ((col & 3) == c)
        bases.append(jnp.where(csel, u, _U32(0)).sum(axis=1, dtype=_U32))
    bases.append(in16 - bases[0] - bases[1] - bases[2])
    # the 4th code's derived totals double-count nothing, but the bogus
    # row is EXCLUDED from all 16 checkpoint counts while r counts it —
    # its code therefore needs +1 from checkpoint blocks after it, and
    # the derived in-block count is already correct (nibble is real)
    back_blk = (sa1_j.astype(j.dtype) >> _O2_SHIFT) < (j >> _O2_SHIFT)
    outs = []
    for c in range(4):
        v = bases[c].astype(dt) + pcs[c].astype(dt)
        back = (sa1_c == c) & back_blk
        outs.append(v + back.astype(dt))
    return jnp.stack(outs, axis=1), jnp.stack(pcs, axis=1)


def _pair4(fm, rows, r, j, c1, pc1_inblk, dt=_I64):
    """Pair counts (prev=c', cur=c1) for all four c' from gathered occ2
    rows. c1: (P,) int32; pc1_inblk: in-block single count of c1 (the
    pair in-block counts sum to it). Returns (P, 4) dt (bogus-pair
    discounted)."""
    u = rows.astype(_U32)
    pm = _nib_prefix_masks(r)
    yc = ~(u ^ (c1.astype(_U32) * _U32(0x11111111))[:, None])
    low2 = yc & (yc >> 1) & _U32(0x11111111) & pm
    sa1_j = fm.sa1_scalars[0].astype(j.dtype)
    sa1_pair = fm.sa1_scalars[1]
    in_blk = (((j >> _O2_SHIFT) == (sa1_j >> _O2_SHIFT))
              & ((sa1_j & _O2_MASK).astype(jnp.int32) < r))
    packed = jnp.zeros(u.shape, _U32)
    for cp in range(3):
        yh = ~(u ^ _U32((cp << 2) * 0x11111111))
        all4 = low2 & (yh >> 2) & (yh >> 3)
        packed += jax.lax.population_count(all4).astype(_U32) << _U32(8 * cp)
    psum = packed.sum(axis=1, dtype=_U32)
    pcs = [(psum >> _U32(8 * cp)).astype(jnp.int32) & 255
           for cp in range(3)]
    pcs.append(pc1_inblk - pcs[0] - pcs[1] - pcs[2])
    outs = []
    for cp in range(4):
        d = (cp << 2) | c1
        base = _col_pick(rows, d, dt)
        bogus = (d == sa1_pair) & in_blk
        outs.append(base + pcs[cp].astype(dt) - bogus.astype(dt))
    return jnp.stack(outs, axis=1)


def forward_ext2_batch(fm: DeviceFMIndex, k, l, s, b1, b2):
    """TWO forward extensions (append b1 then b2) from ONE fused occ2
    gather pass at rows (l, l+s) — the second sub-step's 4-way counts are
    the pair counts (prev=c', cur=3-b1) of the SAME rows, so no dependent
    gather is needed. Returns ((k1, l1, s1), (k2, l2, s2)), the full
    bi-intervals after one and after both appends; each equals the
    corresponding chain of forward_ext4_batch picks."""
    dt = idx_dt(fm)
    P = k.shape[0]
    k = k.astype(dt)
    l = l.astype(dt)
    s = s.astype(dt)
    c1 = 3 - jnp.clip(b1.astype(jnp.int32), 0, 3)
    c2 = 3 - jnp.clip(b2.astype(jnp.int32), 0, 3)
    i2 = jnp.concatenate([l, l + s])
    j = i2 - (i2 > _prim(fm)).astype(i2.dtype)
    rows = fm.occ2_blocks[(j >> _O2_SHIFT).astype(jnp.int32)]
    r = (j & _O2_MASK).astype(jnp.int32)
    c1d = jnp.concatenate([c1, c1])
    R4, pcs_raw = _rank4p(fm, rows, r, j, dt)        # (2P, 4)
    fourc = jnp.arange(4, dtype=jnp.int32)[None, :]
    pc1_inblk = jnp.where(fourc == c1d[:, None], pcs_raw, 0).sum(
        axis=1, dtype=jnp.int32)
    P4 = _pair4(fm, rows, r, j, c1d, pc1_inblk, dt)  # (2P, 4)
    R4lo, R4hi = R4[:P], R4[P:]
    P4lo, P4hi = P4[:P], P4[P:]
    d4 = R4hi - R4lo
    pd4 = P4hi - P4lo

    four = jnp.arange(4, dtype=jnp.int32)[None, :]
    sel = lambda m, c: jnp.where(four == c[:, None], m, 0).sum(
        axis=1, dtype=m.dtype)
    suffsum = lambda m, c: jnp.where(four > c[:, None], m, 0).sum(
        axis=1, dtype=m.dtype)

    L2c = _L2(fm)[:4][None, :]
    s1 = sel(d4, c1)
    l1 = jnp.where(four == c1[:, None], L2c, 0).sum(axis=1, dtype=dt) \
        + 1 + sel(R4lo, c1)
    sent1 = jnp.logical_and(l <= _prim(fm), _prim(fm) < l + s)
    k1 = k + sent1.astype(dt) + suffsum(d4, c1)

    s2 = sel(pd4, c2)
    d12 = (c2 << 2) | c1
    l2 = _sel16(fm.occ2_start, d12, dt) + sel(P4lo, c2)
    # sentinel membership of the intermediate interval: the one row whose
    # previous char is the sentinel lies in [l, l+s) and carries cur c1
    sa1_j = fm.sa1_scalars[0].astype(dt)
    r1row = sa1_j + (sa1_j >= _prim(fm)).astype(dt)
    sent2 = ((l <= r1row) & (r1row < l + s)
             & ((fm.sa1_scalars[1] & 3).astype(jnp.int32) == c1))
    k2 = k1 + sent2.astype(dt) + suffsum(pd4, c2)
    return (k1, l1, s1), (k2, l2, s2)


def _ssa_bits(ssa_row, off):
    """(is_sampled_bit, rank_before_row) from a padded SSA bitmap row
    [rank_before, bits_lo, bits_hi, ...]. Columns are extracted with
    masked reduces so the row gather stays whole (see
    _word_prefix_masks)."""
    P = off.shape[0]
    zero = jnp.zeros((P,), jnp.int32)
    rank0 = _col_pick(ssa_row, zero, jnp.int32)
    lo = _col_pick(ssa_row, zero + 1, jnp.int32).astype(_U32)
    hi = _col_pick(ssa_row, zero + 2, jnp.int32).astype(_U32)
    word = jnp.where(off < 32, lo, hi)
    bit = (word >> (off & 31).astype(_U32)) & 1
    below_lo = lo & ((_U32(1) << jnp.clip(off, 0, 31).astype(_U32)) - 1)
    below_lo = jnp.where(off >= 32, lo, below_lo)
    below_hi = jnp.where(
        off > 32,
        hi & ((_U32(1) << jnp.clip(off - 32, 0, 31).astype(_U32)) - 1),
        _U32(0))
    rank = (rank0
            + jax.lax.population_count(below_lo).astype(jnp.int32)
            + jax.lax.population_count(below_hi).astype(jnp.int32))
    return bit, rank


def sa_lookup2_batch(fm: DeviceFMIndex, rows):
    """Batched SA$ lookup via a 2-step (dinucleotide) LF walk: each trip
    advances TWO text positions with one occ2-row gather (pair table)
    plus one fused SSA-bitmap pass over {row r, previous trip's
    intermediate row m} — the two gathers hit different tables and
    overlap. The intermediate row's sampled test is deferred one trip —
    exact, since a hit freezes the lane's recorded (rank, step)
    regardless of where r has wandered meanwhile."""
    P = rows.shape[0]
    four = jnp.arange(4, dtype=jnp.int32)[None, :]
    dt = idx_dt(fm)
    rows = rows.astype(dt)

    def trip(carry, t):
        r, m, rank_hit, step_hit, done = carry
        j = r - (r > _prim(fm)).astype(dt)
        occ_row = fm.occ2_blocks[(j >> _O2_SHIFT).astype(jnp.int32)]
        idx2 = fm.n_occ_blocks + jnp.concatenate(
            [(r >> 6).astype(jnp.int32), (m >> 6).astype(jnp.int32)])
        ssa2 = fm.occ_blocks[idx2]               # (2P, 8), narrow table
        ssa_r, ssa_m = ssa2[:P], ssa2[P:]
        # deferred test of the PREVIOUS trip's intermediate row (odd step)
        bit_m, rank_m = _ssa_bits(ssa_m, (m & 63).astype(jnp.int32))
        hit_m = (bit_m == 1) & jnp.logical_not(done) & (t > 0)
        rank_hit = jnp.where(hit_m, rank_m, rank_hit)
        step_hit = jnp.where(hit_m, 2 * t - 1, step_hit)
        done = done | hit_m
        # test of the current (even step) row
        bit_r, rank_r = _ssa_bits(ssa_r, (r & 63).astype(jnp.int32))
        hit_r = (bit_r == 1) & jnp.logical_not(done)
        rank_hit = jnp.where(hit_r, rank_r, rank_hit)
        step_hit = jnp.where(hit_r, 2 * t, step_hit)
        done = done | hit_r
        # single LF (intermediate) + double LF (next even row), both from
        # the already-gathered occ2 row: one nibble holds (prev, cur)
        rr = (j & _O2_MASK).astype(jnp.int32)
        w = _col_pick(occ_row, _O2_DATA + (rr >> 3), jnp.int32).astype(_U32)
        d = ((w >> (28 - 4 * (rr & 7)).astype(_U32)) & 15).astype(jnp.int32)
        c2 = d & 3        # BWT char
        occ2_c, occ_c = _rank_pair_single(fm, occ_row, rr, j, d, dt)
        l2c = jnp.where(four == c2[:, None], _L2(fm)[:4][None, :], 0).sum(
            axis=1, dtype=dt)
        m_new = jnp.where(r == _prim(fm), dt(0), l2c + 1 + occ_c)
        r2 = _sel16(fm.occ2_start, d, dt) + occ2_c
        # the double step is invalid when the intermediate row is the
        # primary (prev char = sentinel) — but then SA[m]=0 is sampled, so
        # the lane is caught by next trip's deferred test; r2 is garbage
        # only for a lane that is already guaranteed done.
        r = jnp.where(done, r, r2)
        m = jnp.where(done, m, m_new)
        return (r, m, rank_hit, step_hit, done), None

    n_trips = fm.sa_intv // 2 + 1
    init = (rows, jnp.zeros(P, dt), jnp.zeros(P, jnp.int32),
            jnp.zeros(P, jnp.int32), jnp.zeros(P, jnp.bool_))
    (_, _, rank_hit, step_hit, _), _ = jax.lax.scan(
        trip, init, jnp.arange(n_trips, dtype=jnp.int32))
    return _ssa_combine(fm, rank_hit, step_hit)


def _ssa_combine(fm: DeviceFMIndex, rank, step):
    """Sampled-SA value: uint32 low word + uint8 upper bits + walk steps."""
    dt = idx_dt(fm)
    lo = fm.ssa_vals[rank].astype(_U32).astype(dt)
    if fm.wide:
        hi = fm.ssa_vals_hi[rank].astype(dt)
        lo = (hi << 32) | lo
    return lo + step.astype(dt)


def sa_lookup_batch(fm: DeviceFMIndex, rows):
    """Batched SA$ lookup over (P,) int64 rows: fixed-trip LF walk where
    each trip issues ONE fused gather pass (occ row for LF + sampled-SA
    bitmap row, both in the combined fm.occ_blocks table); the ssa_vals
    gather is deferred to a single pass after the loop."""
    P = rows.shape[0]
    four = jnp.arange(4, dtype=jnp.int32)[None, :]
    dt = idx_dt(fm)
    rows = rows.astype(dt)

    def trip(carry, step):
        r, rank_hit, step_hit, done = carry
        j = r - (r > _prim(fm)).astype(dt)
        idx2 = jnp.concatenate(
            [_blk_of(j), fm.n_occ_blocks + (r >> 6).astype(jnp.int32)])
        rows2 = fm.occ_blocks[idx2]              # ONE pass (2P, 8)
        occ_row, ssa_row = rows2[:P], rows2[P:]
        # sampled test + rank (bitmap of sampled rows, 64 rows/block)
        off = (r & 63).astype(jnp.int32)
        bit, rank = _ssa_bits(ssa_row, off)
        hit = jnp.logical_and(bit == 1, jnp.logical_not(done))
        rank_hit = jnp.where(hit, rank, rank_hit)
        step_hit = jnp.where(hit, step, step_hit)
        done = jnp.logical_or(done, hit)
        # LF from the already-gathered occ row
        rr = (j & 63).astype(jnp.int32)
        w = _col_pick(occ_row, 4 + (rr >> 4), jnp.int32).astype(_U32)
        c = ((w >> (30 - 2 * (rr & 15)).astype(_U32)) & 3).astype(jnp.int32)
        occ_c = _rank1(occ_row, rr, c, dt)
        sel = four == c[:, None]
        l2c = jnp.where(sel, _L2(fm)[:4][None, :], 0).sum(axis=1, dtype=dt)
        dest = jnp.where(r == _prim(fm), dt(0), l2c + 1 + occ_c)
        r = jnp.where(done, r, dest)
        return (r, rank_hit, step_hit, done), None

    init = (rows, jnp.zeros(P, jnp.int32), jnp.zeros(P, jnp.int32),
            jnp.zeros(P, jnp.bool_))
    (r, rank_hit, step_hit, _), _ = jax.lax.scan(
        trip, init, jnp.arange(fm.sa_intv, dtype=jnp.int32))
    return _ssa_combine(fm, rank_hit, step_hit)   # one deferred pass


def sa_lookup(fm: DeviceFMIndex, row):
    """SA$[row] via a fixed-trip LF walk to a text-position-sampled row.
    Scalar reference version (vmappable); the hot path uses
    sa_lookup_batch."""

    def sampled_rank(r):
        blk = (r >> 6).astype(jnp.int32)
        off = (r & 63).astype(jnp.int32)
        b = fm.occ_blocks[fm.n_occ_blocks + blk]  # SSA row of combined table
        lo = b[1].astype(_U32)
        hi = b[2].astype(_U32)
        word = jnp.where(off < 32, lo, hi)
        bit = (word >> (off & 31).astype(_U32)) & 1
        below_lo = lo & ((_U32(1) << jnp.clip(off, 0, 31).astype(_U32)) - 1)
        below_lo = jnp.where(off >= 32, lo, below_lo)
        below_hi = jnp.where(
            off > 32,
            hi & ((_U32(1) << jnp.clip(off - 32, 0, 31).astype(_U32)) - 1),
            _U32(0),
        )
        rank = (
            b[0]
            + jax.lax.population_count(below_lo).astype(jnp.int32)
            + jax.lax.population_count(below_hi).astype(jnp.int32)
        )
        return bit.astype(jnp.int32), rank

    def body(step, carry):
        r, val, done = carry
        is_samp, rank = sampled_rank(r)
        hit = jnp.logical_and(is_samp == 1, jnp.logical_not(done))
        val = jnp.where(hit, _ssa_combine(fm, rank, step), val)
        done = jnp.logical_or(done, hit)
        r_next = jnp.where(done, r, lf(fm, r))
        return r_next, val, done

    dt = idx_dt(fm)
    _, val, _ = jax.lax.fori_loop(
        0, fm.sa_intv, body,
        (jnp.asarray(row, dt), dt(0), jnp.bool_(False))
    )
    return val
