"""Multi-chip scaling: data parallelism over the read batch.

Mapping is embarrassingly parallel per read, so the scaling design
(SURVEY.md §2.3) is:
  - the read batch axis is sharded over every chip of a Mesh via
    shard_map (the equivalent of the reference's pthread
    work-stealing, alignerGreedy.cpp:367-431); the cards of a host are
    joined all to all (NVLink), so the mesh is one flat axis,
  - the index is replicated — it is read-only shared state, exactly as
    in the reference's shared-memory model — or, with --shard-index,
    its two large tables are bucket-range sharded over the same axis
    (sharded_packed_fn) for graphs exceeding one card's memory,
  - statistics counters are reduced with psum on device (the
    reference's atomics, aligner.h:68),
  - multi-host: same program under jax.distributed with a global mesh;
    per-host input shards are concatenated in file order by the writer.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..constants import (
    STATUS_ALIGNED_FWD,
    STATUS_ALIGNED_RC,
    STATUS_FAILED,
    STATUS_NO_OVERLAP_FWD,
    STATUS_RC_NO_OVERLAP,
)
from ..engine.core import (
    IndexArrays,
    align_batch,
    align_batch_packed,
    align_batches_packed,
)

READS_AXIS = "reads"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """Mesh over the first n LOCAL devices (all if None).

    jax.local_devices(), not jax.devices(): under jax.distributed the
    latter returns every process's devices and shard_map over the
    runner's host-local numpy batches would address non-addressable
    devices.  Cross-process scaling composes the per-process mesh with
    record-range input sharding (dist.multihost), not a global mesh.
    """
    devices = jax.local_devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (READS_AXIS,))


def status_counts(status: jax.Array) -> jax.Array:
    """[6] histogram of per-read outcome codes."""
    return jnp.stack([
        jnp.sum(status == s, dtype=jnp.int32)
        for s in range(6)
    ])


def align_batch_sharded(
    mesh: Mesh,
    ix: IndexArrays,
    codes, nmask, lens,
    *,
    k: int, m: int, effort: int,
):
    """Batch sharded over the mesh's reads axis; index replicated;
    stats psum-reduced on device.  Batch size must divide the mesh."""

    def shard_fn(ix, codes, nmask, lens):
        res = align_batch(
            ix, codes, nmask, lens,
            k=k, m=m, effort=effort,
        )
        res.pop("iters")
        counts = jax.lax.psum(status_counts(res["status"]), READS_AXIS)
        return res, counts

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(READS_AXIS), P(READS_AXIS), P(READS_AXIS)),
        out_specs=(P(READS_AXIS), P()),
        check_vma=False,
    )
    return fn(ix, codes, nmask, lens)


def shard_batch_fn(mesh: Mesh, batch_fn):
    """Wrap a single-device engine call (any mode's align_batch_* with
    its static args already bound, returning a dict with at least
    status/paths/plen) so the batch axis is sharded over the mesh and
    only the compact results + a psum'd status histogram leave the
    device.  (Legacy dict contract; the production runner uses
    sharded_packed_fn.)"""

    def shard_fn(ix, codes, nmask, lens):
        res = batch_fn(ix, codes, nmask, lens)
        out = {kk: res[kk] for kk in ("status", "paths", "plen")}
        counts = jax.lax.psum(status_counts(res["status"]), READS_AXIS)
        return out, counts

    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(READS_AXIS), P(READS_AXIS), P(READS_AXIS)),
        out_specs=(P(READS_AXIS), P()),
        check_vma=False,
    )


@functools.lru_cache(maxsize=64)
def sharded_packed_fn(
    mesh: Mesh, *, mode: str, k: int, m: int, effort: int, L: int,
    pmax: int, jl_meta=None, partial: bool = False,
    shard_index: bool = False,
):
    """Sharded production batch call over the fused packed contract
    (core.align_batch_packed): batch axis sharded, psum'd status
    histogram.  Memoized on (mesh, static args) so the shard_map
    wrapper is built and traced once per shape combination instead of
    per batch (the per-batch rebuild added measurable host dispatch
    overhead across thousands of batches).

    shard_index=False (default): index replicated per device — the
    reference's shared-memory model (read-only, SURVEY §2.3).
    shard_index=True: the two large tables (fused junction ScanTable +
    closure ProbeTable) are bucket-range sharded over the SAME mesh
    axis as the reads; lookups all_gather the bucket ids and
    reduce-scatter the answering rows (core._sharded_rows), so each
    device holds 1/D of the index — the >HBM-graph scaling mode."""

    axis = READS_AXIS if shard_index else None

    def shard_fn(ix, words, nmbits, lens):
        fused = align_batch_packed(
            ix, words, nmbits, lens, mode=mode, k=k, m=m,
            effort=effort, L=L, pmax=pmax, jl_meta=jl_meta,
            partial=partial, shard_axis=axis,
        )
        counts = jax.lax.psum(
            status_counts(fused[:, 0].astype(jnp.int32)), READS_AXIS
        )
        return fused, counts

    if shard_index:
        ix_spec = IndexArrays(
            st_fused=P(READS_AXIS), st_seed=P(), umeta=P(),
            pool_rows=P(), n_chunks=P(), pt_rows=P(READS_AXIS),
            pt_seed=P(), at_fused=P(), at_seed=P(), mph_rows=P(),
            mph_jrows=P(), mph_f=P(), amph_rows=P(), amph_arows=P(),
            amph_f=P(),
        )
    else:
        ix_spec = P()
    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(ix_spec, P(READS_AXIS), P(READS_AXIS), P(READS_AXIS)),
        out_specs=(P(READS_AXIS), P()),
        check_vma=False,
    )


@functools.lru_cache(maxsize=64)
def sharded_packed_group_fn(
    mesh: Mesh, *, mode: str, k: int, m: int, effort: int, L: int,
    pmax: int, jl_meta=None, partial: bool = False,
    shard_index: bool = False,
):
    """Grouped sharded production call (core.align_batches_packed under
    shard_map): stacked [G, B, ·] batches, batch axis (dim 1) sharded
    over the mesh, ONE dispatch per group — the multi-card variant of
    the runner's dispatch grouping.
    The lax.map trip count is static and identical on every device, so
    the sharded-index collectives inside the body stay mesh-uniform."""

    axis = READS_AXIS if shard_index else None

    def shard_fn(ix, words_t, nmbits_t, lens_t):
        fused_s = align_batches_packed(
            ix, words_t, nmbits_t, lens_t, mode=mode, k=k, m=m,
            effort=effort, L=L, pmax=pmax, jl_meta=jl_meta,
            partial=partial, shard_axis=axis,
        )
        counts = jax.lax.psum(
            status_counts(fused_s[:, :, 0].astype(jnp.int32).ravel()),
            READS_AXIS,
        )
        return fused_s, counts

    if shard_index:
        ix_spec = IndexArrays(
            st_fused=P(READS_AXIS), st_seed=P(), umeta=P(),
            pool_rows=P(), n_chunks=P(), pt_rows=P(READS_AXIS),
            pt_seed=P(), at_fused=P(), at_seed=P(), mph_rows=P(),
            mph_jrows=P(), mph_f=P(), amph_rows=P(), amph_arows=P(),
            amph_f=P(),
        )
    else:
        ix_spec = P()
    # the batch args are TUPLES of per-batch [B, ·] arrays (prefix
    # pytree spec: P(READS_AXIS) shards every leaf's batch dim); the
    # fused result is stacked [G, B, ·], sharded on dim 1
    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(ix_spec, P(READS_AXIS), P(READS_AXIS), P(READS_AXIS)),
        out_specs=(P(None, READS_AXIS), P()),
        check_vma=False,
    )
