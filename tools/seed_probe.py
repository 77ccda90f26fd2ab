"""On-card anatomy of the seeding program: which reseed component costs.

Times smem_seed_batch_stacked variants on the bench workload:
  a) reseed OFF
  b) reseed ON, bench-converged pools (cand=128 scale: ALL pools x4)
  c) reseed ON, per-stage right-sized pools (cand x4, r2/r3 default)
  d) reseed ON, round 3 unfused (separate scan)  [via max_mem_intv=0 + c]
  e) reseed ON, round 2 disabled (split_width=0)

Usage: python tools/seed_probe.py
"""
from __future__ import annotations

import os
import sys
import time
from dataclasses import replace

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax
    import jax.numpy as jnp

    from bwamem_tpu.index.build import build_index_from_codes
    from bwamem_tpu.index.device import DeviceFMIndex
    from bwamem_tpu.index.format import Annotation
    from bwamem_tpu.ops.seeding import SeedConfig, smem_seed_batch_stacked

    rng = np.random.default_rng(12345)
    G = 4_600_000
    L = 150
    B = 8192
    g = rng.integers(0, 4, G, dtype=np.uint8)
    ann = Annotation(names=["ref"], lengths=[G], offsets=[0])
    idx = build_index_from_codes(g, ann, sa_intv=4)
    fm = DeviceFMIndex.from_host(idx)

    reads = np.full((B, L), 4, np.int8)
    for i in range(B):
        p = int(rng.integers(0, G - L))
        r = g[p:p + L].copy()
        err = rng.random(L) < 0.01
        r[err] = (r[err] + 1) % 4
        if i % 2:
            r = (3 - r)[::-1]
        reads[i] = r
    lens = np.full(B, L, np.int32)
    reads_j = jnp.asarray(reads)
    lens_j = jnp.asarray(lens)

    base = SeedConfig(reseed=True)

    variants = {
        "on_single_bw": replace(base, seed_pool=16),
        "on_pair_bw": replace(base, seed_pool=16, pair_backward=True),
        "off_single_bw": replace(base, reseed=False),
        "off_pair_bw": replace(base, reseed=False, pair_backward=True),
    }
    pools = {}
    for name, cfg in variants.items():
        t0 = time.perf_counter()
        out = smem_seed_batch_stacked(fm, reads_j, lens_j, cfg)
        out.block_until_ready()
        compile_t = time.perf_counter() - t0
        pool = np.asarray(out)  # include the D2H like the product path
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            out = smem_seed_batch_stacked(fm, reads_j, lens_j, cfg)
            pool = np.asarray(out)
        dt = (time.perf_counter() - t0) / reps
        pools[name] = pool
        # head row is the last row in both stacked formats (packed (5,P)
        # int32 / wide (7,P) int64, ops/seeding.py:997-1045)
        n_seeds = int(pool[-1, 0])
        overflow = int(pool[-1, 1])
        print(f"{name:16s} {dt * 1e3:8.1f} ms  ({B / dt:9.0f} reads/s) "
              f" n_seeds={n_seeds} ovf={overflow} compile={compile_t:.0f}s",
              flush=True)
    for a, b in (("on_single_bw", "on_pair_bw"),
                 ("off_single_bw", "off_pair_bw")):
        if a in pools and b in pools:
            same = np.array_equal(pools[a][:-1], pools[b][:-1])
            print(f"pools equal {a} vs {b}: {same}")


if __name__ == "__main__":
    main()
