"""Host-side batching around the device engine.

Collects parsed reads into fixed-shape batches (static B, length-
bucketed L so jit compiles once per bucket), ships them through the
transfer-minimal packed engine entry in dispatch GROUPS of G batches
(core.align_batches_packed: one lax.map dispatch and one stacked
result fetch per group), and unpacks per-read paths in input order.

Transfer discipline: reads go up as 2-bit words + packed N-bits
(2.25 bits/base), results come back as ONE fused [G, B, 2+pmax] int16
array per GROUP with a capped pmax (true path lengths reported; the
rare overflow rows are recomputed on host via the spec), and result
D2H is started asynchronously at dispatch time so it overlaps later
groups' host work and device compute.

A device or transfer error propagates: there is no host fallback for
a failed batch, so a broken device path cannot pass as a slow one.
"""

from __future__ import annotations

import os

import numpy as np

from ..constants import STATUS_ALIGNED_FWD, STATUS_ALIGNED_RC
from ..index.build import UnitigGraph
from ..index.device import DeviceIndex, build_device_index
from ..seq import encode, n_mask
from .core import (
    align_batches_packed,
    align_batches_packed_compact,
    al_meta_of,
    index_to_device,
    jl_meta_of,
)

_ALIGNED = (STATUS_ALIGNED_FWD, STATUS_ALIGNED_RC)

# capped device-side path-slot bound (offset + signed ids).  The
# worst-case bound (_pmax_for) can reach ~L when the graph holds one
# very short unitig, which made the padded result D2H 30 MB/batch; real
# paths are ~2-10 slots.  Rows whose true plen exceeds the cap are
# recomputed on host (exact, rare).  The effective cap scales with the
# read length (max(PMAX_CAP, L/4), see _pmax_cap) so long-read batches
# keep their exact bound instead of degrading into mass host
# recomputes — only stride~1 pathological graphs ever hit the cap.
PMAX_CAP = int(os.environ.get("DBGTPU_PMAX_CAP", 30))


def _pmax_cap(L: int) -> int:
    return max(PMAX_CAP, L // 4)


# Adaptive result width (the D2H diet): the static bound above is 30+
# on any graph with one short unitig, but measured paths on the survey
# workload are 2-6 slots — so the padded fused result shipped 64 B/read
# where ~12 carry information.  Batches therefore dispatch with a small
# starting cap; a batch whose true
# plens exceed the cap is re-dispatched ONCE to the device at the full
# bound (exact, device-speed — not the per-row host spec) and the cap
# ratchets up (quantized to limit program recompiles) for the rest of
# the run.  The per-row host-spec net remains for rows beyond the full
# bound.
PMAX_INIT = int(os.environ.get("DBGTPU_PMAX_INIT", 8))
# overflow rows tolerated on the slow per-row host net before the
# whole batch is re-dispatched to the device at the full bound instead
OVER_REDISPATCH_MIN = 8


def _quantize_pmax(p: int) -> int:
    """Round the adaptive cap up to a multiple of 4 (each distinct pmax
    is a separate XLA program; quantizing bounds the compile count)."""
    return ((max(p, 4) + 3) // 4) * 4


def _pre_len(s: int, B: int, pmax: int) -> int:
    """Quantized compact-flat prefix length for `s` populated slots:
    the quantum scales with the array so there are at most ~8 distinct
    slice programs regardless of batch geometry."""
    q = max(4096, (B * pmax) // 8)
    return min(-(-s // q) * q, B * pmax)

# batches fused into one device dispatch (dispatches and result
# fetches per read drop by this factor; the group is one lax.map
# program).  2 keeps groups pipelining against each other
# (H2D/compute/D2H of successive groups overlap) even on short runs
DISPATCH_GROUP = 2


def get_device_index(
    graph: UnitigGraph, layout: str = "scan"
) -> DeviceIndex:
    attr = "_device_index" if layout == "scan" else f"_device_index_{layout}"
    di = getattr(graph, attr, None)
    if di is None:
        di = build_device_index(graph, layout=layout)
        setattr(graph, attr, di)
    return di


def _bucket_len(n: int, k: int) -> int:
    """Round read length up to a bucket (multiples of 16 up to 256,
    then multiples of 256) to bound jit recompiles.  16-granular
    buckets keep scan/compare work proportional to the real read
    length (a 100 bp read maps at L=112, not 128 — the pow-2 bucketing
    wasted ~15% of the mapping step); reads within a batch share one
    bucket, and datasets are near-uniform length in practice."""
    n = max(n, k + 1, 64)
    if n <= 256:
        return ((n + 15) // 16) * 16
    return ((n + 255) // 256) * 256


def pack_batch(seqs: list[bytes], B: int, L: int):
    codes = np.zeros((B, L), np.uint8)
    nm = np.zeros((B, L), bool)
    lens = np.zeros(B, np.int32)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = encode(s)
        nm[i, : len(s)] = n_mask(s)
        lens[i] = len(s)
    return codes, nm, lens


def _pmax_for(di: DeviceIndex, L: int) -> int:
    """Static packed-path bound: offset slot + signed-id slots.

    Tight: the LEFT and RIGHT walks partition the read between them
    (left covers [0, anchor], right covers [anchor, L-k+1] in position
    space), and every non-final junction push advances the walk
    position by (unitig_len - (k-1)) >= stride read bases, so the id
    count is bounded by ceil((L-k+1)/stride) + one final push per
    direction + one dog-mode preloaded id.  (The former bound summed
    BOTH directions at full read length — 2x too wide — which doubled
    the padded result D2H of every batch.)  Overflow rows (plen > pmax)
    are recomputed on host (exact; cannot happen within this bound).
    """
    ul = di.ulen[1:]
    stride = max(1, int(ul.min(initial=1)) - (di.k - 1))
    span = L - (di.k - 1)
    return int(1 + (span + stride - 1) // stride + 4)


def pack_words_batch(codes: np.ndarray, nmask: np.ndarray):
    """[B, L] uint8 codes + bool N-mask -> (words uint32 [B, ceil(L/16)],
    nmbits uint32 [B, ceil(L/32)]): the H2D payload of
    core.align_batch_packed (2 bits/base + 1 N-bit)."""
    B, L = codes.shape
    Lw = (L + 15) // 16
    pad = Lw * 16 - L
    c = np.pad(codes, ((0, 0), (0, pad))) if pad else codes
    words = (
        c.reshape(B, Lw, 16).astype(np.uint32)
        << (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    ).sum(axis=2, dtype=np.uint32)
    Lb = (L + 31) // 32
    padb = Lb * 32 - L
    nmp = np.pad(nmask, ((0, 0), (0, padb))) if padb else nmask
    nmbits = (
        nmp.reshape(B, Lb, 32).astype(np.uint32)
        << np.arange(32, dtype=np.uint32)[None, None, :]
    ).sum(axis=2, dtype=np.uint32)
    return words, nmbits


def align_bulk(
    graph: UnitigGraph,
    parsed,                      # native.ParsedReads
    m: int,
    effort: int,
    batch_size: int = 8192,
    mode: str = "greedy",
    partial: bool = False,
    mesh=None,                   # jax.sharding.Mesh: shard batches over it
    index_layout: str = "scan",  # "mphf" = compact junction layout
    shard_index: bool = False,   # shard the big index tables over the
    #                              mesh (1/D HBM per device; greedy only)
    progress=None,               # callable(done, total, aligned) or None
    on_batch=None,               # callable(slot, s0, nb, status, counts,
    #                              flat) fired per completed batch from
    #                              the drain thread (serialized) — lets
    #                              the caller format output incrementally
    #                              behind later groups' transfers/compute
    xfer=None,                   # dict: filled with h2d/d2h payload
    #                              byte counts and the overflow rows
    #                              recomputed on the host spec
):
    """Bulk array alignment, input order preserved.

    Returns (status int32 [N], path_off int64 [N+1], paths_flat int32)
    where aligned reads' spans hold [offset, signed ids...] and
    non-aligned reads have empty spans.

    With `mesh`, every batch is sharded over the mesh's reads axis
    (index replicated, packed paths computed per shard on device, stats
    psum-reduced) — the multi-chip path; output bytes are identical to
    the single-device run.

    `progress` is called from the drain thread after each completed
    batch with (reads_done, reads_total, reads_aligned_so_far) — the
    periodic in-run stats surface (reference prints a stats block every
    10 read-batches, alignerExhaustive.cpp:306-316).
    """
    if mode == "greedy":
        from ..model import align_read_greedy

        def spec_align(graph, codes, nm):
            return align_read_greedy(graph, codes, nm, m, effort)
    elif mode == "anchors":
        from ..anchors import align_read_greedy_anchors

        def spec_align(graph, codes, nm):
            return align_read_greedy_anchors(graph, codes, nm, m, effort)
    elif mode == "exhaustive":
        from ..exhaustive import align_read_exhaustive

        def spec_align(graph, codes, nm):
            return align_read_exhaustive(graph, codes, nm, m, partial)
    else:
        raise ValueError(f"no device engine for mode {mode!r}")
    di = get_device_index(graph, index_layout)
    jlm = jl_meta_of(di)
    alm = al_meta_of(di)
    ix = index_to_device(di)
    k = graph.k
    group_n = max(1, int(os.environ.get(
        "DBGTPU_DISPATCH_GROUP", DISPATCH_GROUP
    )))

    # eager start: the closure probe table is ~90% of the index H2D
    # (64 of 73 MB on the survey graph), so a cold / --load-index start
    # used to stall its first dispatch behind that upload.  While the probe rows are still in flight, dispatch
    # groups against a probe-less view of the index — the engine's
    # per-position membership fallback is byte-identical, just more
    # scan gathers — and switch to the probed program the moment the
    # upload lands.  (Single-device path only; mesh placement differs.)
    ix_light = None
    eager_min = int(os.environ.get(
        "DBGTPU_EAGER_START_MIN_BYTES", 16 << 20
    ))
    if (mesh is None and os.environ.get("DBGTPU_EAGER_START", "1") != "0"
            and ix.pt_rows.shape[0] > 0
            and ix.pt_rows.nbytes > eager_min
            and hasattr(ix.pt_rows, "is_ready")):
        import jax.numpy as jnp

        ix_light = ix._replace(
            pt_rows=jnp.zeros((0, ix.pt_rows.shape[1]), jnp.uint32)
        )

    # compact-D2H result transform (single-device path): ship only the
    # populated path slots + a tiny meta block instead of padded rows
    use_compact = (
        mesh is None
        and os.environ.get("DBGTPU_COMPACT_D2H", "1") != "0"
    )
    if mesh is None:
        def group_fn(ix, words_s, nmbits_s, blens_s, *, L, pmax):
            return align_batches_packed(
                ix, words_s, nmbits_s, blens_s, mode=mode, k=k, m=m,
                effort=effort, L=L, pmax=pmax, jl_meta=jlm,
                al_meta=alm, partial=partial,
            )

        def compact_group_fn(ix, words_s, nmbits_s, blens_s, *, L, pmax):
            return align_batches_packed_compact(
                ix, words_s, nmbits_s, blens_s, mode=mode, k=k, m=m,
                effort=effort, L=L, pmax=pmax, jl_meta=jlm,
                al_meta=alm, partial=partial,
            )
    else:
        from ..dist.mesh import sharded_packed_group_fn

        nmesh = mesh.devices.size
        if batch_size % nmesh:
            batch_size = ((batch_size + nmesh - 1) // nmesh) * nmesh
        if shard_index:
            nb_st = di.scan_tbl.keys.shape[0] if di.scan_tbl else 0
            nb_pt = di.probe_tbl.rows.shape[0] if di.probe_tbl else 0
            if mode != "greedy" or nb_st < nmesh or (
                0 < nb_pt < nmesh
            ):
                raise ValueError(
                    "--shard-index requires greedy mode and index "
                    "tables with at least one bucket row per device"
                )
            if nb_st % nmesh or nb_pt % nmesh:
                # bucket counts are powers of two; _sharded_rows'
                # global bucket arithmetic assumes exactly equal
                # shards, and shard_map would otherwise fail with an
                # opaque uneven-sharding error mid-run
                raise ValueError(
                    "--shard-index requires the bucket counts to "
                    f"divide the mesh evenly (junction {nb_st} rows, "
                    f"probe {nb_pt} rows, mesh {nmesh}); bucket counts "
                    "are powers of two, so use a power-of-two mesh size"
                )

        def group_fn(ix, words_s, nmbits_s, blens_s, *, L, pmax):
            fn = sharded_packed_group_fn(
                mesh, mode=mode, k=k, m=m, effort=effort, L=L,
                pmax=pmax, jl_meta=jlm, partial=partial,
                shard_index=shard_index,
            )
            fused_s, _counts = fn(ix, words_s, nmbits_s, blens_s)
            return fused_s

    N = parsed.n
    lens_all = np.diff(parsed.seq_off).astype(np.int32)
    status_all = np.zeros(N, np.int32)
    counts_all = np.zeros(N, np.int64)
    flat_parts: list = []     # per-batch flat path rows, filled by slot
    prog = {"done": 0, "aligned": 0}
    if xfer is None:
        xfer = {}
    xfer.setdefault("h2d_bytes", 0)
    xfer.setdefault("d2h_bytes", 0)
    xfer.setdefault("overflow_rows", 0)
    # adaptive result-width cap (see PMAX_INIT): ratchets up when a
    # batch's true plens overflow it; read by the main thread at pack
    # time, written by the drain thread (benign race — a stale read
    # only delays the ratchet by one group)
    pm = {"cap": _quantize_pmax(PMAX_INIT)}
    # running max of populated slots per batch: sizes the SPECULATIVE
    # flat-prefix fetch (compact D2H) that is queued at dispatch time,
    # so the meta fetch and the slot fetch are queued back to back
    # instead of paying two serialized fetch latencies per group
    est = {"smax": 0}

    def _note_progress(s0, nb):
        prog["done"] += nb
        prog["aligned"] += int(
            np.isin(status_all[s0 : s0 + nb], _ALIGNED).sum()
        )
        if progress is not None:
            progress(prog["done"], N, prog["aligned"])

    def _ratchet(max_plen: int):
        pm["cap"] = max(pm["cap"], _quantize_pmax(max_plen + 2))

    def drain_rows(out, s0, nb, pmax, slot, L, pmax_full,
                   allow_redispatch=True):
        """Unpack one batch's [B, 2+pmax] host rows into the result
        arrays (runs on the drain thread; disjoint row ranges)."""
        status = out[:nb, 0].astype(np.int32)
        plen = out[:nb, 1].astype(np.int32)
        aligned = (status == 1) | (status == 2)
        over = aligned & (plen > pmax)
        n_over = int(over.sum())
        if n_over:
            _ratchet(int(plen[over].max()))
        if (allow_redispatch and n_over > OVER_REDISPATCH_MIN
                and pmax < pmax_full):
            # the adaptive cap undershot this batch en masse: re-run
            # the WHOLE batch on device at the full bound (exact, and
            # ~1000x faster than the per-row host spec); the ratchet
            # above keeps later batches from repeating this
            words, nmbits, blens = pack_one(s0, nb, L)
            fused = group_fn(
                ix, (words,), (nmbits,), (blens,),
                L=L, pmax=pmax_full,
            )
            out2 = np.asarray(fused)[0]
            xfer["h2d_bytes"] += (
                words.nbytes + nmbits.nbytes + blens.nbytes
            )
            xfer["d2h_bytes"] += out2.nbytes
            return drain_rows(
                out2, s0, nb, pmax_full, slot, L, pmax_full,
                allow_redispatch=False,
            )
        paths = out[:nb, 2:].astype(np.int32)
        counts = np.where(aligned, np.minimum(plen, pmax), 0)
        inv = di.id_inv
        if inv is not None:
            # renumbered device ids -> file-order ids (slot 0 of each
            # packed path is the offset, not an id; overflow rows are
            # about to be host-recomputed with file-order ids already)
            cols_ = np.arange(paths.shape[1])[None, :]
            m = ((aligned & ~over)[:, None]
                 & (cols_ >= 1) & (cols_ < counts[:, None]))
            vv = paths[m]
            paths[m] = np.sign(vv) * inv[np.abs(vv)]
        if over.any():
            # exact fallback: the capped device buffer truncated these
            # paths; recompute them on host via the executable spec
            xfer["overflow_rows"] += n_over
            full = {}
            for i in np.nonzero(over)[0]:
                gi = s0 + int(i)
                _, codes, nm = parsed.record(gi)
                st, path = spec_align(graph, codes, nm)
                status[i] = st
                full[int(i)] = path or []
            aligned = (status == 1) | (status == 2)
            wide = max([pmax] + [len(p) for p in full.values()])
            if wide > paths.shape[1]:
                paths = np.pad(paths, ((0, 0), (0, wide - paths.shape[1])))
            for i, path in full.items():
                paths[i, : len(path)] = path
                paths[i, len(path):] = 0
                counts[i] = len(path) if aligned[i] else 0
            counts = np.where(aligned, counts, 0)
        status_all[s0 : s0 + nb] = status
        counts_all[s0 : s0 + nb] = counts
        cols = np.arange(paths.shape[1])[None, :]
        mask = aligned[:, None] & (cols < counts[:, None])
        flat_parts[slot] = paths[mask]
        if on_batch is not None:
            on_batch(slot, s0, nb, status, counts, flat_parts[slot])
        _note_progress(s0, nb)

    def drain_group(metas, fused_s, pmax, L, pmax_full):
        out_s = np.asarray(fused_s)
        xfer["d2h_bytes"] += out_s.nbytes
        for g, (s0, nb, slot) in enumerate(metas):
            drain_rows(out_s[g], s0, nb, pmax, slot, L, pmax_full)

    def drain_group_compact(metas, meta_s, flat_s, spec_pre, pmax, L,
                            pmax_full):
        """Compact-D2H drain: fetch the [G, B, 2] meta block, compute
        the populated flat-prefix length from it, fetch only that
        prefix of the [G, B*pmax] slot array (served from the
        speculative in-flight fetch when it covers), and reconstruct
        the padded rows on host (cheap numpy) for the shared
        drain_rows.  The prefix length is rounded up in coarse quanta
        so the slice program compiles a handful of times, not per
        distinct size."""
        meta = np.asarray(meta_s)              # [G, B, 2]
        xfer["d2h_bytes"] += meta.nbytes
        G, B = meta.shape[0], meta.shape[1]
        status = meta[:, :, 0].astype(np.int32)
        plen = meta[:, :, 1].astype(np.int32)
        aligned = (status == 1) | (status == 2)
        counts = np.where(aligned, np.minimum(plen, pmax), 0)
        S = counts.sum(axis=1)                 # populated slots / batch
        est["smax"] = max(est["smax"], int(S.max(initial=0)))
        pre = None
        if int(S.max(initial=0)):
            Sr = _pre_len(int(S.max()), B, pmax)
            if (spec_pre is not None
                    and spec_pre.shape[1] >= int(S.max())):
                pre = np.asarray(spec_pre)       # already in flight
            else:
                pre = np.asarray(flat_s[:, :Sr])
            xfer["d2h_bytes"] += pre.nbytes
        iota = np.arange(B, dtype=np.int64)
        for g, (s0, nb, slot) in enumerate(metas):
            cg = counts[g]
            paths = np.zeros((B, pmax), meta.dtype)
            if pre is not None:
                # device order: counts descending, stable by row (the
                # key is unique, so np reproduces it exactly)
                order = np.argsort((pmax - cg) * B + iota)
                off = 0
                for j in range(pmax):
                    nj = int((cg > j).sum())
                    if nj == 0:
                        break
                    paths[order[:nj], j] = pre[g, off : off + nj]
                    off += nj
            out = np.concatenate(
                [meta[g], paths], axis=1
            )
            drain_rows(out, s0, nb, pmax, slot, L, pmax_full)

    # Drain on a single worker thread: np.asarray's device wait
    # releases the GIL, so result D2H + host unpack of group i overlap
    # the main thread's pack/dispatch of groups i+1.. — the host-side
    # pipeline the reference gets from its reader/worker threads
    # (aligner.cpp:550-597), here with exactly one consumer so the
    # result arrays need no locking (disjoint row ranges per batch).
    from concurrent.futures import ThreadPoolExecutor

    from .. import native

    use_native_pack = native.available()
    futures = []
    pend: list = []           # packed batches awaiting group dispatch
    pend_key = None           # (L, pmax) shared by the pending batches

    def pack_one(s0, nb, L):
        """Pack records [s0, s0+nb) into the H2D arrays (numpy)."""
        if use_native_pack:
            words, nmbits, blens = native.pack_batch_native(
                parsed, s0, nb, batch_size, L
            )
        else:
            lens = lens_all[s0 : s0 + nb]
            starts = parsed.seq_off[s0 : s0 + nb]
            col = np.arange(L, dtype=np.int64)[None, :]
            gidx = starts[:, None] + np.minimum(
                col, (lens - 1)[:, None]
            )
            valid = col < lens[:, None]
            codes = np.zeros((batch_size, L), np.uint8)
            nmask = np.zeros((batch_size, L), bool)
            codes[:nb] = np.where(valid, parsed.codes[gidx], 0)
            nmask[:nb] = parsed.nmask[gidx] & valid
            blens = np.zeros(batch_size, np.int32)
            blens[:nb] = lens
            words, nmbits = pack_words_batch(codes, nmask)
        if not nmbits.any():
            # provably N-free batch: drop the mask payload (~1/3
            # of the per-batch H2D; the engine's has-N work folds)
            nmbits = np.zeros((batch_size, 0), np.uint32)
        # read lengths always fit int16 (L <= 32767); halves that leg
        return words, nmbits, blens.astype(np.int16)

    def flush_group(pool):
        nonlocal pend
        if not pend:
            return
        L, pmax, _lb = pend_key
        pmax_full = min(_pmax_for(di, L), _pmax_cap(L))
        metas = [(p["s0"], p["nb"], p["slot"]) for p in pend]
        words_t = tuple(p["words"] for p in pend)
        nmbits_t = tuple(p["nmbits"] for p in pend)
        blens_t = tuple(p["blens"] for p in pend)
        pend = []
        use_ix = ix
        if ix_light is not None and not ix.pt_rows.is_ready():
            use_ix = ix_light     # probe rows still uploading
        if use_compact:
            meta_s, flat_s = compact_group_fn(
                use_ix, words_t, nmbits_t, blens_t, L=L, pmax=pmax
            )
            spec_pre = None
            if est["smax"]:
                # speculative prefix fetch sized by the running max
                # (+12% slack): queued now, so its transfer pipelines
                # right behind the meta block's
                sl = _pre_len(
                    int(est["smax"] * 1.12) + 256, batch_size, pmax
                )
                spec_pre = (flat_s[:, :sl] if sl < batch_size * pmax
                            else flat_s)
            meta_s.copy_to_host_async()
            if spec_pre is not None:
                spec_pre.copy_to_host_async()
            futures.append(pool.submit(
                drain_group_compact, metas, meta_s, flat_s, spec_pre,
                pmax, L, pmax_full,
            ))
            return
        fused_s = group_fn(
            use_ix, words_t, nmbits_t, blens_t, L=L, pmax=pmax
        )
        fused_s.copy_to_host_async()      # start D2H behind later work
        futures.append(pool.submit(
            drain_group, metas, fused_s, pmax, L, pmax_full
        ))

    import jax as _jax

    with ThreadPoolExecutor(max_workers=1) as pool:
        for slot, s0 in enumerate(range(0, N, batch_size)):
            nb = min(batch_size, N - s0)
            lens = lens_all[s0 : s0 + nb]
            L = _bucket_len(int(lens.max(initial=k + 1)), k)
            pmax = min(_pmax_for(di, L), _pmax_cap(L), pm["cap"])
            words, nmbits, blens = pack_one(s0, nb, L)
            xfer["h2d_bytes"] += (
                words.nbytes + nmbits.nbytes + blens.nbytes
            )
            key = (L, pmax, nmbits.shape[1])
            if pend and (key != pend_key or len(pend) >= group_n):
                flush_group(pool)
            pend_key = key
            if mesh is None:
                # per-batch async H2D: this batch's upload streams
                # behind the next batch's packing; the group dispatch
                # then references in-flight device buffers (mesh
                # batches go through shard_map's own placement instead)
                words = _jax.device_put(words)
                nmbits = _jax.device_put(nmbits)
                blens = _jax.device_put(blens)
            flat_parts.append(None)
            pend.append(dict(
                s0=s0, nb=nb, slot=slot,
                words=words, nmbits=nmbits, blens=blens,
            ))
            if len(pend) >= group_n:
                flush_group(pool)
            if len(futures) >= 3:     # bound in-flight device buffers
                futures.pop(0).result()
        flush_group(pool)
        for f in futures:
            f.result()

    path_off = np.zeros(N + 1, np.int64)
    np.cumsum(counts_all, out=path_off[1:])
    paths_flat = (
        np.concatenate(flat_parts) if flat_parts else np.zeros(0, np.int32)
    )
    return status_all, path_off, paths_flat
