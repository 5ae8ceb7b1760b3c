"""End-to-end mapping pipeline: parse -> align -> format.

The aligner is pluggable: `impl="python"` uses the executable spec in
model.py (one read at a time, host only); `impl="jax"` uses the batched
device engine.  Both must produce identical bytes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .constants import (
    STATUS_ALIGNED_FWD,
    STATUS_ALIGNED_RC,
    STATUS_NO_OVERLAP_FWD,
    STATUS_RC_NO_OVERLAP,
    STATUS_FAILED,
)
from .index.build import UnitigGraph, build_graph
from .io.fasta import iter_reads
from .model import align_read_greedy, format_path, recover_path
from .seq import decode, encode, n_mask, rc_codes


@dataclass
class RunStats:
    read_number: int = 0
    aligned: int = 0
    not_aligned: int = 0
    no_overlap: int = 0
    index_seconds: float = 0.0
    map_seconds: float = 0.0
    index_hbm: dict | None = None     # per-artifact device-index bytes
    # per-run host<->device payload (read batches up, fused results
    # down; excludes the one-time index upload)
    payload_h2d_bytes: int = 0
    payload_d2h_bytes: int = 0
    # reads whose path outgrew the device result bound and were
    # recomputed on the host spec (runner.align_bulk's exactness net)
    overflow_rows: int = 0
    # the engine that ran and, for the device engine, the devices JAX
    # ran it on and whether the native reader/formatter was loaded
    impl: str = "python"
    platform: str | None = None
    device_kind: str | None = None
    device_count: int = 0
    native_io: bool = False

    def summary(self) -> str:
        """Same shape as the reference's end-of-run block
        (aligner.cpp:588-596)."""
        rn = self.read_number
        got = self.aligned + self.not_aligned

        def pct(a, b):
            return (100.0 * a) / b if b else float("nan")

        return (
            "The End\n"
            f"Reads : {rn}\n"
            f"No overlap : {self.no_overlap} Percent : {_fmt(pct(self.no_overlap, rn))}\n"
            f"Got overlap : {got} Percent : {_fmt(pct(got, rn))}\n"
            f"Overlap and aligned : {self.aligned} Percent : {_fmt(pct(self.aligned, got))}\n"
            f"Overlap but not aligned : {self.not_aligned} Percent : {_fmt(pct(self.not_aligned, got))}\n"
            f"Reads/seconds : {int(rn / (int(self.map_seconds) + 1))}\n"
            f"Mapping in seconds : {int(self.map_seconds)}\n"
        )


    def as_dict(self) -> dict:
        """Structured run summary (SURVEY.md §5 observability note)."""
        return {
            "reads": self.read_number,
            "aligned": self.aligned,
            "not_aligned": self.not_aligned,
            "no_overlap": self.no_overlap,
            "index_seconds": round(self.index_seconds, 3),
            "map_seconds": round(self.map_seconds, 3),
            "reads_per_second": (
                round(self.read_number / self.map_seconds, 1)
                if self.map_seconds > 0 else None
            ),
            **({"index_hbm_bytes": self.index_hbm}
               if self.index_hbm else {}),
            **({"payload_h2d_bytes": self.payload_h2d_bytes,
                "payload_d2h_bytes": self.payload_d2h_bytes}
               if self.payload_h2d_bytes else {}),
            "overflow_rows": self.overflow_rows,
            "impl": self.impl,
            "platform": self.platform,
            "device_kind": self.device_kind,
            "device_count": self.device_count,
            "native_io": self.native_io,
        }


def _fmt(x: float) -> str:
    # C++ cout default: 6 significant digits
    if x != x:
        return "-nan"
    return f"{x:.6g}"


_NO_OVERLAP_STATUSES = (STATUS_NO_OVERLAP_FWD, STATUS_RC_NO_OVERLAP)

_CHARS = np.frombuffer(b"ACGT", np.uint8)


def _format_paths_python(headers, hdr_off, status, path_off, flat):
    out = []
    for i in range(len(status)):
        if status[i] not in (STATUS_ALIGNED_FWD, STATUS_ALIGNED_RC):
            continue
        h = headers[hdr_off[i] : hdr_off[i + 1]]
        p = flat[path_off[i] : path_off[i + 1]]
        out.append(h + b"\n" + ("".join(f"{v}." for v in p) + "\n").encode())
    return b"".join(out)


def _count_stats(stats, status):
    aligned = (status == STATUS_ALIGNED_FWD) | (status == STATUS_ALIGNED_RC)
    stats.read_number += len(status)
    stats.aligned += int(aligned.sum())
    stats.no_overlap += int(np.isin(status, _NO_OVERLAP_STATUSES).sum())
    stats.not_aligned += int((status == STATUS_FAILED).sum())
    return aligned


def _format_outputs(graph, parsed, status, path_off, flat, correction,
                    aligned):
    """(paths_bytes, not_aligned_bytes) for one aligned record block —
    shared by the buffered pipeline and the resumable per-segment
    writer (byte format per SURVEY §4.1 items 1-3)."""
    from . import native

    paths_out: list[bytes] = []
    na_out: list[bytes] = []
    if correction:
        if native.available():
            paths_out.append(
                native.format_corrected_native(
                    parsed.headers, parsed.hdr_off, status, path_off,
                    flat, parsed.seq_off, graph.pool, graph.offsets,
                    graph.lengths, graph.k,
                )
            )
        else:
            for i in np.nonzero(aligned)[0]:
                h = parsed.headers[parsed.hdr_off[i] : parsed.hdr_off[i + 1]]
                path = [int(v) for v in flat[path_off[i] : path_off[i + 1]]]
                rlen = int(parsed.seq_off[i + 1] - parsed.seq_off[i])
                corrected = recover_path(graph, path, rlen)
                if status[i] == STATUS_ALIGNED_RC:
                    corrected = rc_codes(corrected)
                paths_out.append(
                    h + b"\n" + decode(corrected).encode() + b"\n"
                )
    elif native.available():
        paths_out.append(
            native.format_paths_native(
                parsed.headers, parsed.hdr_off, status, path_off, flat
            )
        )
    else:
        paths_out.append(
            _format_paths_python(
                parsed.headers, parsed.hdr_off, status, path_off, flat
            )
        )

    if not aligned.all():
        chars = _CHARS[parsed.codes].copy()
        chars[parsed.nmask] = ord("N")
        if native.available():
            na_out.append(
                native.format_notaligned_native(
                    parsed.headers, parsed.hdr_off, status, chars,
                    parsed.seq_off,
                )
            )
        else:
            cb = chars.tobytes()
            for i in np.nonzero(~aligned)[0]:
                h = parsed.headers[parsed.hdr_off[i] : parsed.hdr_off[i + 1]]
                s, e = int(parsed.seq_off[i]), int(parsed.seq_off[i + 1])
                na_out.append(h + b"\n" + cb[s:e] + b"\n")
    return b"".join(paths_out), b"".join(na_out)


def make_progress_printer(every_batches: int):
    """Periodic in-run stats line (the reference prints a stats block
    every 10 read-batches, alignerExhaustive.cpp:306-316; BooPHF has a
    build ETA bar, BooPHF.h:51-202).  Returns an align_bulk `progress`
    callback printing to stderr every `every_batches` completed
    batches (and on the final batch), or None when disabled."""
    if not every_batches:
        return None
    import sys

    t0 = time.monotonic()
    # `done`/`total`/`aligned` reset on every align_bulk call (one call
    # per file / per resumable segment) while t0 spans the whole run;
    # callers mark call boundaries via progress.segment() so the line
    # reports cumulative counts against the cumulative elapsed time
    # instead of a per-segment count that collapses reads/s toward zero
    seen = {"n": 0, "done": 0, "total": 0, "aligned": 0,
            "prev": (0, 0, 0)}

    def segment():
        d, t, a = seen["prev"]
        seen["done"] += d
        seen["total"] += t
        seen["aligned"] += a
        seen["prev"] = (0, 0, 0)

    def progress(done, total, aligned):
        seen["n"] += 1
        seen["prev"] = (done, total, aligned)
        if seen["n"] % every_batches and done < total:
            return
        d = seen["done"] + done
        t = seen["total"] + total
        a = seen["aligned"] + aligned
        dt = max(time.monotonic() - t0, 1e-9)
        pct = 100.0 * a / max(d, 1)
        print(
            f"[progress] reads {d}/{t} | aligned {a} "
            f"({pct:.1f}%) | {d / dt:,.0f} reads/s",
            file=sys.stderr, flush=True,
        )

    progress.segment = segment
    return progress


def _run_file_bulk(
    graph, rf, m, effort, fastq, correction, batch_size,
    stats, paths_out, na_out, mode="greedy", partial=False,
    mesh=None, rec_range=None, index_layout="scan", shard_index=False,
    progress=None,
):
    import os
    import sys

    from . import native
    from .engine.runner import align_bulk, get_device_index

    timing = os.environ.get("DBGTPU_TIMING")

    def tick(label, t0):
        if timing:
            print(f"[timing] {label}: {time.monotonic() - t0:.2f}s",
                  file=sys.stderr, flush=True)
        return time.monotonic()

    t = time.monotonic()
    parsed = native.parse_reads(rf, graph.k, fastq)
    if rec_range is not None:
        s, e = rec_range(parsed.n)
        parsed = parsed.slice_records(s, e)
    t = tick("parse", t)

    # incremental per-batch formatting (native only): runs on the drain
    # thread, so the output bytes of batch i are built while later
    # groups are still transferring/computing — the format leg leaves
    # the post-align critical path entirely
    on_batch = None
    parts_p: dict = {}
    parts_n: dict = {}
    if native.available():
        def on_batch(slot, s0, nb, status_b, counts_b, flat_b):
            po = np.zeros(nb + 1, np.int64)
            np.cumsum(counts_b, out=po[1:])
            ho = parsed.hdr_off[s0 : s0 + nb + 1]
            if correction:
                parts_p[slot] = native.format_corrected_native(
                    parsed.headers, ho, status_b, po, flat_b,
                    parsed.seq_off[s0 : s0 + nb + 1],
                    graph.pool, graph.offsets, graph.lengths, graph.k,
                )
            else:
                parts_p[slot] = native.format_paths_native(
                    parsed.headers, ho, status_b, po, flat_b,
                )
            al = (status_b == STATUS_ALIGNED_FWD) | (
                status_b == STATUS_ALIGNED_RC
            )
            if al.all():
                parts_n[slot] = b""
            else:
                so = parsed.seq_off[s0 : s0 + nb + 1]
                chars = _CHARS[parsed.codes[so[0] : so[-1]]].copy()
                chars[parsed.nmask[so[0] : so[-1]]] = ord("N")
                parts_n[slot] = native.format_notaligned_native(
                    parsed.headers, ho, status_b, chars, so - so[0],
                )

    xfer: dict = {}
    status, path_off, flat = align_bulk(
        graph, parsed, m, effort, batch_size=batch_size, mode=mode,
        partial=partial, mesh=mesh, index_layout=index_layout,
        shard_index=shard_index, progress=progress, on_batch=on_batch,
        xfer=xfer,
    )
    stats.payload_h2d_bytes += xfer.get("h2d_bytes", 0)
    stats.payload_d2h_bytes += xfer.get("d2h_bytes", 0)
    stats.overflow_rows += xfer.get("overflow_rows", 0)
    t = tick("align", t)
    if stats.index_hbm is None:
        from .index.device import hbm_report

        stats.index_hbm = hbm_report(get_device_index(graph, index_layout))
    aligned = _count_stats(stats, status)
    if on_batch is not None:
        paths_out.append(b"".join(
            parts_p[i] for i in sorted(parts_p)
        ))
        na_out.append(b"".join(
            parts_n[i] for i in sorted(parts_n)
        ))
    else:
        pb, nab = _format_outputs(
            graph, parsed, status, path_off, flat, correction, aligned
        )
        paths_out.append(pb)
        na_out.append(nab)
    tick("format", t)


def align_stream_python(
    graph: UnitigGraph, records, m: int, effort: int,
    mode: str = "greedy", partial: bool = False,
):
    """Yield (header, seq, status, path) using the executable spec."""
    if mode == "greedy":
        def align(codes, nm):
            return align_read_greedy(graph, codes, nm, m, effort)
    elif mode == "exhaustive":
        from .exhaustive import align_read_exhaustive

        def align(codes, nm):
            return align_read_exhaustive(graph, codes, nm, m, partial)
    elif mode == "anchors":
        from .anchors import align_read_greedy_anchors

        def align(codes, nm):
            return align_read_greedy_anchors(graph, codes, nm, m, effort)
    elif mode == "paths":
        from .paths_mode import align_read_greedy_path

        def align(codes, nm):
            return align_read_greedy_path(graph, codes, nm, m, effort, partial)
    elif mode == "paths-exhaustive":
        from .paths_mode import align_read_exhaustive_path

        def align(codes, nm):
            return align_read_exhaustive_path(graph, codes, nm, m, partial)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    for header, seq in records:
        codes = encode(seq)
        nm = n_mask(seq)
        status, path = align(codes, nm)
        yield header, seq, status, path


def run_pipeline(
    reads_files: list[str],
    unitig_file: str,
    k: int,
    m: int = 2,
    effort: int = 2,
    fastq: bool = False,
    correction: bool = False,
    impl: str = "python",
    batch_size: int = 4096,
    graph: UnitigGraph | None = None,
    mode: str = "greedy",
    partial: bool = False,
    save_index: str | None = None,
    mesh_devices: int = 0,
    process_id: int = 0,
    num_processes: int = 1,
    index_layout: str = "scan",
    shard_index: bool = False,
    progress_every: int = 0,
):
    """Returns (paths_bytes, not_aligned_bytes, RunStats).

    mesh_devices: shard device batches over the first N local devices
    (-1 = all) via shard_map — the multi-chip path (jax impl only).
    process_id/num_processes: multi-host input sharding; this process
    maps a contiguous record range of every input file (hosts never
    exchange read data, SURVEY.md §2.3); the caller merges per-process
    outputs in process order (dist.multihost.merge_shards) for bytes
    equal to a single-process run.
    """
    stats = RunStats()
    t0 = time.monotonic()
    if graph is None:
        graph = build_graph(unitig_file, k, dog_mode=(mode == "anchors"))
    if save_index:
        from .index.persist import save_index as _save_index

        # v2: persists the device-ready layout too, so --load-index
        # starts mapping in O(file read) with no rebuild; honors
        # --index-layout so the mphf junction artifacts persist
        _save_index(graph, save_index, layout=index_layout)
    stats.index_seconds = time.monotonic() - t0

    paths_out: list[bytes] = []
    na_out: list[bytes] = []
    t1 = time.monotonic()

    if mode not in ("greedy", "anchors", "exhaustive") and impl == "jax":
        # path modes run on the executable spec (reference-dead code)
        impl = "python"

    rec_range = None
    if num_processes > 1:
        from .dist.multihost import shard_ranges

        def rec_range(n, _p=process_id, _np=num_processes):
            return shard_ranges(n, _np)[_p]

    stats.impl = impl
    if impl == "jax":
        _note_device(stats)
        mesh = None
        if mesh_devices:
            from .dist.mesh import make_mesh

            mesh = make_mesh(
                None if mesh_devices < 0 else mesh_devices
            )
        # bulk array path: native parse -> device batches -> native format
        # start the index H2D now (device_put is async): the upload —
        # the largest transfer of a run, and the whole startup cost of
        # a --load-index start — streams while the reads file parses,
        # instead of stalling the first batch dispatch
        from .engine.core import index_to_device
        from .engine.runner import get_device_index

        index_to_device(get_device_index(graph, index_layout))
        progress = make_progress_printer(progress_every)
        for rf in reads_files:
            if progress is not None:
                progress.segment()
            _run_file_bulk(
                graph, rf, m, effort, fastq, correction, batch_size,
                stats, paths_out, na_out, mode=mode, partial=partial,
                mesh=mesh, rec_range=rec_range, index_layout=index_layout,
                shard_index=shard_index, progress=progress,
            )
        stats.map_seconds = time.monotonic() - t1
        return b"".join(paths_out), b"".join(na_out), stats

    if impl != "python":
        raise ValueError(f"unknown impl {impl!r}")

    def stream(records):
        return align_stream_python(graph, records, m, effort, mode, partial)

    def records_for(rf):
        recs = iter_reads(rf, k, fastq)
        if rec_range is None:
            return recs
        all_recs = list(recs)
        s, e = rec_range(len(all_recs))
        return all_recs[s:e]

    for rf in reads_files:
        for header, seq, status, path in stream(records_for(rf)):
            stats.read_number += 1
            if status in (STATUS_ALIGNED_FWD, STATUS_ALIGNED_RC):
                stats.aligned += 1
                if correction:
                    corrected = recover_path(graph, path, len(seq))
                    if status == STATUS_ALIGNED_RC:
                        corrected = rc_codes(corrected)
                    paths_out.append(
                        header + b"\n" + decode(corrected).encode() + b"\n"
                    )
                else:
                    paths_out.append(header + b"\n" + format_path(path))
            else:
                if status in _NO_OVERLAP_STATUSES:
                    stats.no_overlap += 1
                elif status == STATUS_FAILED:
                    stats.not_aligned += 1
                na_out.append(header + b"\n" + seq + b"\n")
    stats.map_seconds = time.monotonic() - t1
    return b"".join(paths_out), b"".join(na_out), stats


def _note_device(stats: RunStats) -> None:
    from . import native
    from .runtime import device_facts

    d = device_facts()
    stats.platform = d["platform"]
    stats.device_kind = d["device_kind"]
    stats.device_count = d["device_count"]
    stats.native_io = native.available()


def _journal_fingerprint(reads_files, unitig_file, k, m, effort, mode,
                         fastq, correction, partial) -> str:
    """Every OUTPUT-AFFECTING parameter must be in this blob: --resume's
    correctness rests on the fingerprint rejecting a resume whose
    records would be computed differently from the journaled ones
    (e.g. a run killed without -i and resumed with -i would silently
    mix partial and non-partial alignments)."""
    import hashlib

    blob = repr((list(reads_files), unitig_file, k, m, effort, mode,
                 bool(fastq), bool(correction), bool(partial))).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def run_pipeline_resumable(
    reads_files: list[str],
    unitig_file: str,
    k: int,
    paths_file: str,
    na_file: str,
    m: int = 2,
    effort: int = 2,
    fastq: bool = False,
    correction: bool = False,
    batch_size: int = 32768,
    graph: UnitigGraph | None = None,
    mode: str = "greedy",
    partial: bool = False,
    mesh_devices: int = 0,
    index_layout: str = "scan",
    shard_index: bool = False,
    segment_records: int = 0,
    progress_every: int = 0,
) -> RunStats:
    """Crash-resumable mapping run (SURVEY §5 checkpoint/resume:
    "resume mid-file by read offset" — a capability the reference lacks
    entirely: it rebuilds and restarts every run, aligner.cpp:537-547).

    Output is written incrementally per segment of `segment_records`
    reads and progress is journaled to `<paths_file>.resume.json`:
    append outputs -> flush+fsync -> atomically replace the journal
    (tmp+rename) with the new (file index, record offset, output byte
    offsets, running stats).  A killed run restarts with the SAME
    command + --resume: outputs are truncated to the journaled byte
    offsets (dropping any torn tail past the last fsync) and mapping
    continues at the journaled record offset, so the final bytes equal
    a single uninterrupted run's.  The journal is removed on
    completion."""
    import json
    import os

    from . import native
    from .engine.runner import align_bulk

    t_ix = time.monotonic()
    if graph is None:
        graph = build_graph(unitig_file, k, dog_mode=(mode == "anchors"))
    t_ix = time.monotonic() - t_ix
    if not segment_records:
        segment_records = 4 * batch_size
    segment_records = max(segment_records, batch_size)

    mesh = None
    if mesh_devices:
        from .dist.mesh import make_mesh

        mesh = make_mesh(None if mesh_devices < 0 else mesh_devices)

    journal_file = paths_file + ".resume.json"
    fp = _journal_fingerprint(
        reads_files, unitig_file, k, m, effort, mode, fastq, correction,
        partial,
    )
    state = {
        "version": 1, "fingerprint": fp, "file_idx": 0, "record_off": 0,
        "paths_bytes": 0, "na_bytes": 0,
        "stats": dict(read_number=0, aligned=0, not_aligned=0,
                      no_overlap=0),
    }
    if os.path.exists(journal_file):
        with open(journal_file) as f:
            prev = json.load(f)
        if prev.get("fingerprint") != fp:
            raise ValueError(
                f"--resume journal {journal_file} was written by a run "
                "with different inputs/parameters; delete it to start "
                "fresh"
            )
        state = prev

    # truncate any torn tail beyond the last journaled fsync, then
    # append from there
    for path, off in ((paths_file, state["paths_bytes"]),
                      (na_file, state["na_bytes"])):
        if os.path.exists(path):
            with open(path, "r+b") as f:
                f.truncate(off)
        elif off:
            raise ValueError(
                f"--resume journal expects {off} bytes in {path}, "
                "but the file is missing; delete the journal to start "
                "fresh"
            )
    stats = RunStats(**state["stats"])
    stats.index_seconds = t_ix
    stats.impl = "jax"
    _note_device(stats)
    t1 = time.monotonic()
    from .engine.core import index_to_device
    from .engine.runner import get_device_index

    index_to_device(get_device_index(graph, index_layout))  # async H2D
    progress = make_progress_printer(progress_every)

    with open(paths_file, "ab") as pf, open(na_file, "ab") as naf:
        for fi, rf in enumerate(reads_files):
            if fi < state["file_idx"]:
                continue
            parsed_all = native.parse_reads(rf, graph.k, fastq)
            start = state["record_off"] if fi == state["file_idx"] else 0
            for s0 in range(start, parsed_all.n, segment_records):
                e0 = min(s0 + segment_records, parsed_all.n)
                parsed = parsed_all.slice_records(s0, e0)
                if progress is not None:
                    progress.segment()
                xfer: dict = {}
                status, path_off, flat = align_bulk(
                    graph, parsed, m, effort, batch_size=batch_size,
                    mode=mode, partial=partial, mesh=mesh,
                    index_layout=index_layout, shard_index=shard_index,
                    progress=progress, xfer=xfer,
                )
                stats.overflow_rows += xfer["overflow_rows"]
                aligned = _count_stats(stats, status)
                pb, nab = _format_outputs(
                    graph, parsed, status, path_off, flat, correction,
                    aligned,
                )
                pf.write(pb)
                pf.flush()
                os.fsync(pf.fileno())
                naf.write(nab)
                naf.flush()
                os.fsync(naf.fileno())
                state.update(
                    file_idx=fi, record_off=e0,
                    paths_bytes=state["paths_bytes"] + len(pb),
                    na_bytes=state["na_bytes"] + len(nab),
                    stats=dict(
                        read_number=stats.read_number,
                        aligned=stats.aligned,
                        not_aligned=stats.not_aligned,
                        no_overlap=stats.no_overlap,
                    ),
                )
                tmp = journal_file + ".tmp"
                with open(tmp, "w") as jf:
                    json.dump(state, jf)
                    jf.flush()
                    os.fsync(jf.fileno())
                os.replace(tmp, journal_file)
            state["file_idx"] = fi + 1
            state["record_off"] = 0
    stats.map_seconds = time.monotonic() - t1
    if os.path.exists(journal_file):
        os.remove(journal_file)
    return stats
