"""Data-parallel scaling harness (BASELINE config 5's shape).

Measures the sharded full alignment step over a 1..N-device mesh of the
default backend's devices and reports scaling efficiency. On a CPU host,
XLA_FLAGS=--xla_force_host_platform_device_count=8 gives a virtual mesh
that validates the sharding program and the harness, not interconnect
bandwidth.

Prints one JSON line per mesh size:
  {"devices": N, "reads_per_s": ..., "efficiency_vs_1": ...}
"""
from __future__ import annotations

import json
import time

import numpy as np


def main() -> None:
    import jax

    from bwamem_tpu.index.build import build_index_from_codes
    from bwamem_tpu.index.device import DeviceFMIndex
    from bwamem_tpu.index.format import Annotation
    from bwamem_tpu.models.mem import AlignStepConfig
    from bwamem_tpu.parallel.sharded import (make_mesh, replicate_index,
                                             shard_reads,
                                             sharded_align_step)

    rng = np.random.default_rng(7)
    G = 1_000_000
    B = 4096
    RL = 150
    g = rng.integers(0, 4, G, dtype=np.uint8)
    ann = Annotation(names=["ref"], lengths=[G], offsets=[0])
    idx = build_index_from_codes(g, ann, sa_intv=8)
    fm = DeviceFMIndex.from_host(idx)
    pos = rng.integers(0, G - RL, B)
    reads = np.empty((B, RL), np.int32)
    for i in range(B):
        r = g[pos[i] : pos[i] + RL].copy()
        err = rng.random(RL) < 0.01
        r[err] = (r[err] + 1) % 4
        reads[i] = r
    lens = np.full(B, RL, np.int32)

    n_avail = len(jax.devices())
    base = None
    for n in [x for x in (1, 2, 4, 8) if x <= n_avail]:
        mesh = make_mesh(n)
        fm_r = replicate_index(mesh, fm)
        r_sh, l_sh, _ = shard_reads(mesh, reads, lens)
        step = sharded_align_step(mesh, AlignStepConfig(), gather_out=False)
        out, _ = step(fm_r, r_sh, l_sh)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(3):
            out, _ = step(fm_r, r_sh, l_sh)
            jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / 3
        rps = B / dt
        if base is None:
            base = rps
        print(json.dumps({
            "devices": n,
            "reads_per_s": round(rps, 1),
            "efficiency_vs_1": round(rps / (base * n), 3),
            "backend": jax.default_backend(),
            "device": jax.devices()[0].device_kind,
        }))


if __name__ == "__main__":
    main()
