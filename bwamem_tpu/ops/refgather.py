"""Device-side reference window gathers from the packed 2-bit genome.

Equivalent of bns_get_seq/bns_fetch_seq (reference: src/bntseq.c, and the
commented-out direct-to-device fetch bns_get_seq_gpu at src/bntseq.c:429)
but running on the device: positions in doubled (fwd+rev) coordinates index
pac_words; reverse-strand positions map to complemented forward bases.
Out-of-range positions yield code 4 so downstream scoring treats them as
ambiguous padding.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..index.device import DeviceFMIndex


def gather_bases(fm: DeviceFMIndex, pos):
    """Base codes at doubled-coordinate positions `pos` (any shape int;
    positions are int64 — genomes can exceed 2^31 doubled bases).
    Invalid (out of [0, 2*l_pac)) positions -> 4."""
    from .fm import idx_dt

    dt = idx_dt(fm)
    lp = fm.l_pac.astype(dt)
    pos = pos.astype(dt)
    valid = jnp.logical_and(pos >= 0, pos < 2 * lp)
    is_rev = pos >= lp
    fpos = jnp.where(is_rev, 2 * lp - 1 - pos, pos)
    fpos = jnp.clip(fpos, 0, jnp.maximum(lp - 1, 0))
    w = fm.pac_words[(fpos >> 4).astype(jnp.int32)].astype(jnp.uint32)
    sh = (30 - 2 * (fpos & 15)).astype(jnp.uint32)
    base = ((w >> sh) & 3).astype(jnp.int32)
    base = jnp.where(is_rev, 3 - base, base)
    return jnp.where(valid, base, 4)


def _extract_words_ascending(words, f0, length: int):
    """Base codes of windows [f0, f0+length) over an arbitrary packed
    2-bit word table (base j of word w at bit shift 30 - 2*(j & 15)).
    Out-of-range positions yield garbage — callers mask."""
    N = f0.shape[0]
    W = length // 16 + 2
    w0 = f0 >> 4
    a0 = (f0 & 15).astype(jnp.uint32)
    n_words = words.shape[0]
    widx = jnp.clip(w0[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :],
                    0, n_words - 1).astype(jnp.int32)
    w = words[widx].astype(jnp.uint32)                 # (N, W)
    sh = (2 * a0)[:, None]
    lo = jnp.where(sh > 0, w << sh, w)
    hi = jnp.where(sh > 0, w >> (32 - sh), jnp.uint32(0))
    comb = lo | jnp.concatenate(
        [hi[:, 1:], jnp.zeros((N, 1), jnp.uint32)], axis=1)  # (N, W)
    # replicate each aligned word across its 16 base columns
    rep = jnp.repeat(comb, 16, axis=1)[:, :length]     # (N, length)
    t = jnp.arange(length, dtype=jnp.uint32)[None, :]
    return ((rep >> (30 - 2 * (t & 15))) & 3).astype(jnp.int32)


def pack_codes_2bit(codes):
    """Pack (B, L) int codes into the extractor's word layout. Returns
    (words, nplane): (B, ceil(L/16)) uint32 each — 2-bit base codes
    (N/pad packed as 0) and a parallel 2-bit N/pad-flag plane, both
    consumable by _extract_words_ascending on flattened indices."""
    B, L = codes.shape
    Wr = -(-L // 16)
    pad = Wr * 16 - L
    c = codes.astype(jnp.int32)
    if pad:
        c = jnp.concatenate(
            [c, jnp.full((B, pad), 4, jnp.int32)], axis=1)
    is_n = (c >= 4) | (c < 0)
    b2 = jnp.where(is_n, 0, c).astype(jnp.uint32).reshape(B, Wr, 16)
    nf = is_n.astype(jnp.uint32).reshape(B, Wr, 16)
    sh = (30 - 2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    words = (b2 << sh).sum(axis=2, dtype=jnp.uint32)
    nplane = (nf << sh).sum(axis=2, dtype=jnp.uint32)
    return words, nplane


def _extract_ascending(fm: DeviceFMIndex, f0, length: int):
    """Forward-pac window extraction (see _extract_words_ascending)."""
    f0 = f0.astype(jnp.int64) if fm.wide else f0.astype(jnp.int32)
    return _extract_words_ascending(fm.pac_words, f0, length)


def gather_window_fast(fm: DeviceFMIndex, start, length: int):
    """Ascending doubled-coordinate windows [start, start+length) with
    per-position strand mapping — same outputs as
    gather_bases(fm, start[:, None] + arange(length)) but built from two
    word-granular contiguous pac fetches (forward part + complemented
    reverse part) instead of per-base gathers."""
    from .fm import idx_dt

    dt = idx_dt(fm)
    lp = fm.l_pac.astype(dt)
    start = start.astype(dt)
    offs = jnp.arange(length, dtype=jnp.int32)[None, :]
    pos = start[:, None] + offs
    fwd = _extract_ascending(fm, start, length)
    # reverse part: positions p >= l_pac read fpos = 2lp-1-p, which is an
    # ascending pac run when traversed from the window's END
    r0 = (2 * lp - length) - start
    rev = _extract_ascending(fm, r0, length)
    rev = (3 - rev[:, ::-1]).astype(jnp.int32)
    out = jnp.where(pos < lp, fwd, rev)
    valid = jnp.logical_and(pos >= 0, pos < 2 * lp)
    return jnp.where(valid, out, 4)


def gather_window(fm: DeviceFMIndex, start, length: int, strand_clip=True):
    """Windows [start, start+length) per batch element.

    start: (N,) int32 in doubled coords; length: static int.
    When strand_clip is set, positions crossing the forward/reverse
    boundary relative to the window start are masked to 4 (the reference
    clips extension windows at the boundary, src/bwamem.c:1195-1201).
    """
    offs = jnp.arange(length, dtype=jnp.int32)[None, :]
    pos = start[:, None] + offs
    codes = gather_bases(fm, pos)
    if strand_clip:
        lp = fm.l_pac
        start_rev = (start >= lp)[:, None]
        pos_rev = pos >= lp
        codes = jnp.where(start_rev == pos_rev, codes, 4)
    return codes
