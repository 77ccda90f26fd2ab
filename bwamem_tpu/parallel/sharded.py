"""Multi-chip data-parallel alignment over a jax.sharding.Mesh.

Replaces the reference's pthread pool + single-GPU design (SURVEY §2.5:
the reference has NO distributed backend) with this layout:

  * the FMD index is REPLICATED per chip (P() specs — human-scale occ+SA
    fit in HBM),
  * read batches are SHARDED over the 'data' mesh axis,
  * per-shard results stay SHARD-RESIDENT (P(axis) out_specs reassemble
    them in range order at the jit boundary) — emit consumes per-shard
    slices, so no O(global) allgather crosses NVLink; only scalar counters are
    psum'd. Multi-HOST scale-out is a separate layer (multihost.py):
    hosts own disjoint read ranges, so nothing crosses DCN.

Work stealing (reference: src/kthread.c:59-85) has no analog here: equal
read counts per shard give static balance; length bucketing upstream
handles the variance the reference's stealing compensated for.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index.device import DeviceFMIndex
from ..models.mem import AlignStepConfig, device_align_step


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    """Per-host data-parallel mesh. Uses LOCAL devices: under
    jax.distributed each host aligns its own read range on its own chips
    (see parallel/multihost.py) — no cross-host collectives sit on the
    data path, so the mesh never spans hosts."""
    devs = jax.local_devices()[: n_devices or len(jax.local_devices())]
    return Mesh(np.array(devs), (axis,))


def sharded_align_step(mesh: Mesh, cfg: AlignStepConfig = AlignStepConfig(),
                       axis: str = "data", gather_out: bool = True):
    """Returns a jitted function (fm, reads, lens) -> per-read outputs.

    fm is replicated; reads/lens are sharded on the batch dimension; the
    outputs are allgathered (so each process holds the full result) plus a
    psum'd total-seed count to exercise a reduction collective.

    The shard_map's in_specs must mirror the index's exact pytree
    (including static flags like has_occ2), so the jitted step is built
    lazily per index structure and cached."""
    jitted: dict = {}

    def build(fm_specs):
        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(fm_specs, P(axis), P(axis)),
            out_specs=(P(axis) if not gather_out else P(), P()),
            check_vma=False,
        )
        def step(fm, reads, lens):
            out = device_align_step(fm, reads, lens, cfg)
            total_seeds = jax.lax.psum(jnp.sum(out.pop("n_seeds")), axis)
            if gather_out:
                out = jax.tree_util.tree_map(
                    lambda x: jax.lax.all_gather(x, axis, axis=0,
                                                 tiled=True),
                    out,
                )
            return out, total_seeds

        return jax.jit(step)

    def call(fm, reads, lens):
        specs, treedef = _fm_specs(fm)
        if treedef not in jitted:
            jitted[treedef] = build(specs)
        return jitted[treedef](fm, reads, lens)

    return call


def sharded_seed_batch(mesh: Mesh, fm: DeviceFMIndex, reads, lens, cfg,
                       axis: str = "data"):
    """Full-pipeline seeding over the mesh: index replicated, reads
    sharded by contiguous range, flat seed pools allgathered with
    read ids rebased to global read numbers. Drop-in for
    ops.seeding.smem_seed_batch (same output dict)."""
    from ..ops.seeding import smem_seed_batch

    n_dev = mesh.devices.size
    B = reads.shape[0]
    assert B % n_dev == 0, "caller pads the batch to the mesh size"
    fm_specs, _ = _fm_specs(fm)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(fm_specs, P(axis), P(axis)),
             out_specs=(P(axis), P()),
             check_vma=False)
    def step(fm_, reads_, lens_):
        out = smem_seed_batch(fm_, reads_, lens_, cfg)
        shard = jax.lax.axis_index(axis)
        b_loc = reads_.shape[0]
        out["read_id"] = jnp.where(
            out["read_id"] >= 0, out["read_id"] + shard * b_loc,
            out["read_id"])
        # pools stay SHARD-RESIDENT (out_specs P(axis) concatenates the
        # per-shard slices in axis order — read_id stays globally sorted,
        # consumers select on `valid`); only the two scalars ride a psum.
        # An all_gather here would be O(global pool) traffic per device
        # per step.
        n_seeds = jax.lax.psum(out.pop("n_seeds"), axis)
        out.pop("need", None)
        over_mult = jax.lax.pmax(out.pop("over_mult"), axis)
        mults = jax.lax.pmax(out.pop("mults"), axis)
        # per-pool emission counts: SUM across shards (the sidecar stores
        # a per-READ high-water mark — total emissions / global batch —
        # so a P(axis)-concatenated vector would parse as shard 0 only)
        needs = jax.lax.psum(out.pop("needs"), axis)
        out.pop("overflow")
        return out, (n_seeds, over_mult, mults, needs)

    out, (n_seeds, over_mult, mults, needs) = jax.jit(step)(fm, reads, lens)
    out["n_seeds"] = n_seeds
    out["over_mult"] = over_mult
    out["mults"] = mults
    out["needs"] = needs
    out["overflow"] = over_mult > 1
    return out


def sharded_extend_batch(mesh: Mesh, query, target, qlen, tlen, h0, mat,
                         params, axis: str = "data"):
    """Batched extension over the mesh (drop-in for extend_batch_auto;
    caller pads N to the mesh size)."""
    from ..ops.extend import extend_batch_auto

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P()),
             out_specs=P(axis),
             check_vma=False)
    def step(q, t, ql, tl, h, m):
        # outputs stay shard-resident; P(axis) reassembles job order
        return extend_batch_auto(q, t, ql, tl, h, m, params)

    return jax.jit(step)(query, target, qlen, tlen, h0, mat)


def _fm_specs(fm: DeviceFMIndex):
    """(replicated PartitionSpecs, treedef) mirroring this index's pytree
    structure — static fields (wide/has_occ2/sa_intv) are part of the
    treedef, so specs must be derived from the actual index."""
    leaves, treedef = jax.tree_util.tree_flatten(fm)
    return jax.tree_util.tree_unflatten(
        treedef, [P() for _ in leaves]), treedef


def shard_reads(mesh: Mesh, reads: np.ndarray, lens: np.ndarray,
                axis: str = "data"):
    """Pad the batch to a multiple of the mesh size and device_put with a
    batch-sharded layout (range-based: shard i gets a contiguous slice,
    keeping SAM output order trivially mergeable)."""
    n_dev = mesh.devices.size
    B = reads.shape[0]
    Bp = -(-B // n_dev) * n_dev
    if Bp != B:
        reads = np.concatenate(
            [reads, np.full((Bp - B, reads.shape[1]), 4, reads.dtype)])
        lens = np.concatenate([lens, np.zeros(Bp - B, lens.dtype)])
    sh = NamedSharding(mesh, P(axis))
    return (jax.device_put(jnp.asarray(reads), sh),
            jax.device_put(jnp.asarray(lens), sh), B)


def replicate_index(mesh: Mesh, fm: DeviceFMIndex) -> DeviceFMIndex:
    sh = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), fm)
