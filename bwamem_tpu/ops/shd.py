"""Shifted-Hamming-Distance seed pre-filter — batched re-design of the
reference's SSE SHD library (reference: src/vector_filter.cpp:294-370
bit_vec_filter_m128_sse1, src/bit_convert.cpp, src/mask.cpp; gated by the
-F flag via mem_shd_flt_chained_seeds, src/bwamem.c:809-969).

The SSE version packs 128 bases into two 1-bit planes per m128 register and
ANDs XOR masks across read/ref shifts of 0..max_error, bridging short
zero-runs ("speculative removal": a lone match between mismatches is a
false match — SHD, Xin et al. 2015). Here there is no bit-packing: the
(batch, window) plane is the array layout, shifts are slices, and the
whole filter is a handful of elementwise bool ops + one reduction,
batched over every flank window of a chunk in one launch.

Semantics (cleaned up vs the reference, which leaves tail bytes of the
shorter window unmasked at shift 0): a position participates only when
both windows cover it (pos < len); shifted terms additionally require
pos >= shift. A window pair passes when the AND-accumulated, zero-run-
bridged mismatch mask has <= max_error set positions.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _bridge_false_zeros(d, m):
    """Flip 0-runs of length <= 2 that are flanked by 1s (the reference's
    flip_false_zero, src/vector_filter.cpp:224-292), within mask m."""
    N, W = d.shape
    z = jnp.zeros((N, 1), jnp.bool_)

    def sl(x, k):  # x shifted so position i sees x[i+k] (out of range = 0)
        if k > 0:
            return jnp.concatenate([x[:, k:], jnp.zeros((N, k), jnp.bool_)],
                                   axis=1)
        if k < 0:
            return jnp.concatenate([jnp.zeros((N, -k), jnp.bool_),
                                    x[:, :k]], axis=1)
        return x

    one_l = sl(d, -1)                      # d[i-1]
    b1 = one_l & sl(d, 1)                  # 1 0 1
    b2 = one_l & sl(d, 2)                  # 1 0 0 1 -> covers d[i], d[i+1]
    b2 = b2 | sl(b2, -1)
    return d | ((b1 | b2) & m)


@partial(jax.jit, static_argnames=("max_error",))
def shd_filter_batch(read_w, ref_w, lens, max_error: int = 7):
    """read_w, ref_w: (N, W) int32 base codes (0..3; 4/N treated as A — the
    reference's converter does the same for non-ACGT bytes); lens: (N,)
    shared valid length. Returns (N,) bool pass flags."""
    N, W = read_w.shape
    r0 = (read_w & 1).astype(jnp.bool_)
    r1 = ((read_w >> 1) & 1).astype(jnp.bool_)
    f0 = (ref_w & 1).astype(jnp.bool_)
    f1 = ((ref_w >> 1) & 1).astype(jnp.bool_)
    pos = jnp.arange(W, dtype=jnp.int32)[None, :]
    valid = pos < lens[:, None]

    def diff(a0, a1, b0, b1, shift):
        """(a shifted right by `shift`) vs b: position i compares a[i-shift]
        with b[i]."""
        if shift:
            pad = jnp.zeros((N, shift), jnp.bool_)
            a0 = jnp.concatenate([pad, a0[:, :-shift]], axis=1)
            a1 = jnp.concatenate([pad, a1[:, :-shift]], axis=1)
        d = (a0 ^ b0) | (a1 ^ b1)
        m = valid if not shift else valid & (pos >= shift)
        return d & m, m

    acc, m0 = diff(r0, r1, f0, f1, 0)
    acc = _bridge_false_zeros(acc, m0)
    for j in range(1, max_error + 1):
        d, m = diff(r0, r1, f0, f1, j)          # read shifted right
        acc = acc & _bridge_false_zeros(d, m)
        d, m = diff(f0, f1, r0, r1, j)          # ref shifted right
        acc = acc & _bridge_false_zeros(d, m)
    total = jnp.sum(acc, axis=1)
    return total <= max_error
