"""2-bit read packing for the host->device upload.

The per-chunk read upload ((B, L) int8 codes) is the largest H2D
payload of the pipeline. Codes are 0..4, so the chunk ships as a 2-bit
plane (4x smaller) plus a short exception list of in-read N positions
(code 4 inside a read is rare; PADDING positions are reconstructed
from `lens` on device, not shipped). The reference ships raw ASCII to
the GPU and packs there (pack_4bit_fow, seed_gen.cu:1088-1108); packing
host-side moves 4x fewer bytes over the host->device link.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

N_CAP = 4096  # exception-list capacity; above this ship unpacked


def pack_reads_host(reads: np.ndarray, lens: np.ndarray):
    """(B, L) int8 codes (pad = 4) -> (words (B, L//16) uint32,
    npos int64 (N_CAP,) flat indices of IN-READ code-4 positions or -1,
    ok bool). Padding positions (col >= lens[row]) are NOT exceptions —
    the device unpack reconstructs them from `lens`. L must be a
    multiple of 16 (bucket_read_len guarantees multiples of 32). Caller
    falls back to the unpacked upload when not ok."""
    B, L = reads.shape
    if L % 16:
        return None, None, False
    r = reads.astype(np.uint32) & 3
    sh = (30 - 2 * np.arange(16, dtype=np.uint32))[None, None, :]
    words = (r.reshape(B, L // 16, 16) << sh).sum(
        axis=2, dtype=np.uint32)
    in_read = np.arange(L, dtype=np.int32)[None, :] < \
        np.asarray(lens).reshape(-1, 1)
    flat_n = np.flatnonzero((reads > 3) & in_read)
    if flat_n.size > N_CAP:
        return None, None, False
    npos = np.full(N_CAP, -1, np.int64)
    npos[: flat_n.size] = flat_n
    return words, npos.astype(np.int64), True


@partial(jax.jit, static_argnames=("L", "out_dtype"))
def unpack_reads(words, lens, npos, L: int, out_dtype=jnp.int8):
    """Device-side inverse of pack_reads_host: (B, L) codes with
    positions >= lens[b] restored to 4 and the exception list scattered
    back as 4."""
    B = words.shape[0]
    t = jnp.arange(L, dtype=jnp.uint32)[None, :]
    w = words[:, (jnp.arange(L) // 16)]
    codes = ((w >> (30 - 2 * (t & 15))) & 3).astype(jnp.int32)
    codes = jnp.where(
        jnp.arange(L, dtype=jnp.int32)[None, :] < lens[:, None],
        codes, 4)
    flat = codes.reshape(-1)
    idx = jnp.where(npos >= 0, npos, B * L)  # OOB -> dropped
    flat = flat.at[idx].set(4, mode="drop")
    return flat.reshape(B, L).astype(out_dtype)
