"""Multi-host scaling (SURVEY.md §2.3, §5 communication backend).

The reference is a single pthread process; dbgtpu's multi-host story is
the JAX collective stack:

  - one process per card: `bind_local_card` restricts process i to
    local card i before JAX opens any device (a JAX process reserves
    most of every card it opens, so a second process on the same card
    would fail for want of memory),
  - `init_distributed()` wraps jax.distributed.initialize for runs
    that reduce statistics across processes; the cards of a host are
    joined all to all (NVLink), so no mesh shape follows the wiring,
  - input sharding: each host maps a deterministic subset of the read
    files (`shard_files`), or byte-ranges of one big file
    (`shard_ranges`) — reads are embarrassingly parallel, so hosts
    never exchange read data,
  - the index is built once per host from the same unitig file (or
    loaded from a persisted npz) and replicated to local devices; it is
    read-only, exactly like the reference's shared-memory index,
  - statistics are reduced with psum on device (dist.mesh) and, across
    hosts, by the natural device-global psum of a global-mesh
    shard_map,
  - output: each host writes `<out>.shard<P>`; `merge_shards` (host 0,
    or any later step) concatenates them in process order, preserving
    the single-process output order per shard — byte-equal to a
    single-host run over the concatenated inputs.

Failure/elastic recovery (SURVEY.md §5): mapping is stateless per read,
so recovery is re-streaming unacknowledged shards; `merge_shards`
refuses to merge when a shard is missing.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple


def bind_local_card(process_id: int) -> None:
    """Let this process see only local card `process_id`.

    A launcher that sets CUDA_VISIBLE_DEVICES has already chosen the
    card, and this sets nothing.  Must run before JAX opens a device;
    other platforms ignore the setting."""
    if "CUDA_VISIBLE_DEVICES" in os.environ:
        return
    import jax

    jax.config.update("jax_cuda_visible_devices", str(process_id))


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """jax.distributed.initialize with env fallbacks (JAX_COORDINATOR,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID).  No-op if already initialized
    or single-process."""
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR"
    )
    if coordinator_address is None:
        return
    if num_processes is None:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_stats_sum(local):
    """Sum a per-process int64 stats vector across every process of a
    jax.distributed run (the replacement for the reference's
    shared-memory atomic counters, aligner.h:68): gathered over the
    global device mesh, summed on host.  Identity when single-process.
    """
    import jax
    import numpy as np

    if jax.process_count() == 1:
        return np.asarray(local)
    from jax.experimental import multihost_utils

    gathered = multihost_utils.process_allgather(np.asarray(local))
    return np.asarray(gathered).sum(axis=0)


def shard_files(
    files: Sequence[str], process_id: int, num_processes: int
) -> List[str]:
    """Deterministic round-robin file assignment (file order preserved
    within a host's shard)."""
    return [f for i, f in enumerate(files) if i % num_processes == process_id]


def shard_ranges(
    total: int, num_shards: int
) -> List[Tuple[int, int]]:
    """Split [0, total) into num_shards contiguous [start, end) ranges
    (for record-index sharding of a single large file)."""
    base = total // num_shards
    rem = total % num_shards
    out = []
    start = 0
    for i in range(num_shards):
        n = base + (1 if i < rem else 0)
        out.append((start, start + n))
        start += n
    return out


def shard_path(base: str, process_id: int) -> str:
    return f"{base}.shard{process_id}"


def merge_shards(
    base: str, num_processes: int, remove: bool = True
) -> None:
    """Concatenate `<base>.shard0..N-1` into `<base>` in process order.
    Raises FileNotFoundError if any shard is missing (incomplete run —
    re-stream the missing shard rather than merging silently)."""
    shards = [shard_path(base, i) for i in range(num_processes)]
    for s in shards:
        if not os.path.exists(s):
            raise FileNotFoundError(f"missing output shard: {s}")
    with open(base, "wb") as out:
        for s in shards:
            with open(s, "rb") as f:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    out.write(chunk)
    if remove:
        for s in shards:
            os.remove(s)
