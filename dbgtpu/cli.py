"""bgreat-compatible command line.

Flag names mirror the reference (bgreat.cpp:67-109) so parity harnesses
can swap binaries:
  -r reads (comma-separated), -k k, -g unitigs, -m mismatches,
  -t threads (accepted; batching replaces it), -e effort, -f paths file,
  -a notAligned file, -q fastq, -c correction, -G dog/anchor mode,
  -b exhaustive.
dbgtpu additions use long names (--impl, --batch-size, ...).

Defects of the reference deliberately not replicated: `-o`/`-p` are
accepted by its getopt string but have no handlers (unreachable); we
simply do not define them.
"""

from __future__ import annotations

import argparse
import sys
import time


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dbgtpu",
        description="de Bruijn graph read mapper on a JAX accelerator "
        "(BGREAT-compatible)",
    )
    p.add_argument("-r", dest="reads", required=True,
                   help="read file(s), comma separated")
    p.add_argument("-k", dest="k", type=int, default=30, help="k value (30)")
    p.add_argument("-g", dest="unitigs", default="unitig.fa",
                   help="unitig file (unitig.fa)")
    p.add_argument("-m", dest="mismatches", type=int, default=2,
                   help="allowed mismatches (2)")
    p.add_argument("-t", dest="threads", type=int, default=1,
                   help="accepted for compatibility; device batching "
                        "replaces host threads")
    p.add_argument("-e", dest="effort", type=int, default=2,
                   help="mapping effort / anchors tried (2)")
    p.add_argument("-f", dest="paths_file", default="paths",
                   help="paths output file (paths)")
    p.add_argument("-a", dest="not_aligned_file", default="notAligned.fa",
                   help="not-aligned output file (notAligned.fa)")
    p.add_argument("-q", dest="fastq", action="store_true",
                   help="fastq input")
    p.add_argument("-c", dest="correction", action="store_true",
                   help="output corrected reads instead of paths")
    p.add_argument("-G", dest="dog_mode", action="store_true",
                   help="anchor (k-mer) mode")
    p.add_argument("-b", dest="exhaustive", action="store_true",
                   help="exhaustive search mode")
    p.add_argument("-i", dest="partial", action="store_true",
                   help="accept partial alignments (exhaustive mode)")
    p.add_argument("-p", dest="paths_mode", action="store_true",
                   help="simple-path mode (reachable here, unlike the "
                        "reference whose -p flag has no handler)")
    p.add_argument("--impl", choices=["auto", "python", "jax"],
                   default="auto",
                   help="alignment engine: auto (default) = the batched "
                        "device engine whenever a non-CPU JAX backend "
                        "is present, executable python spec otherwise "
                        "(the choice is printed on stderr); jax/python "
                        "force one")
    p.add_argument("--batch-size", type=int, default=32768,
                   help="reads per device batch (32768 measured best "
                        "for the pipelined jax runner)")
    p.add_argument("--save-index", metavar="FILE",
                   help="persist the built index (npz) and continue")
    p.add_argument("--load-index", metavar="FILE",
                   help="load a persisted index instead of rebuilding "
                        "(-g/-k are then ignored)")
    p.add_argument("--json-summary", metavar="FILE",
                   help="write a structured run summary (JSON)")
    p.add_argument("--mesh", dest="mesh", type=int, default=0,
                   metavar="N",
                   help="shard device batches over the first N local "
                        "devices (-1 = all) via shard_map (jax impl)")
    p.add_argument("--coordinator", metavar="HOST:PORT",
                   help="jax.distributed coordinator address "
                        "(multi-host runs)")
    p.add_argument("--num-processes", type=int, default=1,
                   help="total processes in a multi-host run; this "
                        "process maps a contiguous record range of "
                        "every input file and writes "
                        "<out>.shard<process-id>; process i binds to "
                        "local card i unless CUDA_VISIBLE_DEVICES is "
                        "set")
    p.add_argument("--process-id", type=int, default=0,
                   help="this process's id in a multi-host run")
    p.add_argument("--merge-shards", type=int, default=0, metavar="N",
                   help="merge <paths>.shard0..N-1 and "
                        "<notAligned>.shard0..N-1 written by a "
                        "multi-host run, then exit")
    p.add_argument("--shard-index", action="store_true",
                   help="with --mesh: shard the junction/probe tables "
                        "over the mesh devices (1/D of the tables per "
                        "card; lookups ride collectives between the "
                        "cards) — for graphs exceeding one card's "
                        "memory (greedy mode)")
    p.add_argument("--index-layout", choices=["scan", "mphf"],
                   default="scan",
                   help="junction index layout: scan = one-gather "
                        "fused table (fast, ~320 B/key); mphf = "
                        "BBHash-style compact layout (~41 B/key) for "
                        "graphs pressing HBM limits")
    p.add_argument("--profile-dir", metavar="DIR",
                   help="capture a jax.profiler trace of the mapping "
                        "phase into DIR (view with TensorBoard/XProf)")
    p.add_argument("--progress", type=int, default=0, metavar="N",
                   help="print an in-run stats line to stderr every N "
                        "completed device batches (reads done, aligned "
                        "count/%%, reads/s) — the reference's periodic "
                        "stats block (alignerExhaustive.cpp:306-316)")
    p.add_argument("--resume", action="store_true",
                   help="journaled run: append output per segment and "
                        "record (file, read offset) in "
                        "<paths>.resume.json; rerunning the same "
                        "command with --resume after a crash continues "
                        "mid-file and produces byte-identical output "
                        "(requires --impl jax)")
    return p


def main(argv: list[str] | None = None) -> int:
    parser = make_parser()
    args = parser.parse_args(argv)
    if args.load_index is None and not 2 <= args.k <= 32:
        # fail loudly instead of silently corrupting: k > 32 overflows
        # the 64-bit kmer representation (the reference shares the cap,
        # utils.h:27-28, but does not enforce it either)
        parser.error(
            f"-k {args.k} is out of range: supported k is 2..32 "
            "(kmers are 64-bit, as in the reference)"
        )
    if args.progress:
        # --progress also surfaces the index-build phase log (the
        # reference's BooPHF progress bar analogue) on stderr
        import logging

        logging.basicConfig(stream=sys.stderr)
        logging.getLogger("dbgtpu").setLevel(logging.INFO)
    from .pipeline import run_pipeline

    if args.merge_shards:
        from .dist.multihost import merge_shards

        merge_shards(args.paths_file, args.merge_shards)
        merge_shards(args.not_aligned_file, args.merge_shards)
        return 0

    if args.num_processes > 1:
        from .dist.multihost import bind_local_card, init_distributed

        bind_local_card(args.process_id)
        if args.coordinator:
            init_distributed(
                args.coordinator, args.num_processes, args.process_id
            )

    graph = None
    if args.load_index:
        from .index.persist import load_graph

        graph = load_graph(args.load_index)
        args.k = graph.k

    facts = None
    if args.impl != "python":
        from .runtime import device_facts, enable_compile_cache

        enable_compile_cache()
        facts = device_facts()
    if args.impl == "auto":
        # the drop-in bgreat command line must run the real engine on
        # real hardware (the reference's default invocation runs its
        # real engine, bgreat.cpp:112-115); the python spec remains the
        # CPU-only fallback and an explicit choice
        args.impl = "jax" if facts["platform"] != "cpu" else "python"

    reads_files = args.reads.split(",")
    mode = (
        ("paths-exhaustive" if args.exhaustive else "paths")
        if args.paths_mode
        else "exhaustive" if args.exhaustive
        else "anchors" if args.dog_mode
        else "greedy"
    )
    # path modes run on the executable spec whatever --impl says
    engine = args.impl if not args.paths_mode else "python"
    where = (f" (JAX platform {facts['platform']}, {facts['device_kind']}"
             f", {facts['device_count']} device(s))" if facts else "")
    print(f"dbgtpu: engine {engine}{where}", file=sys.stderr)
    profiling = False
    if args.profile_dir:
        import jax

        jax.profiler.start_trace(args.profile_dir)
        profiling = True

    if args.resume:
        if args.impl != "jax":
            print("--resume requires --impl jax", file=sys.stderr)
            return 2
        if args.num_processes > 1:
            print("--resume does not combine with multi-process runs "
                  "(each process journals its own shard files instead)",
                  file=sys.stderr)
            return 2
        from .pipeline import run_pipeline_resumable

        t0 = time.monotonic()
        stats = run_pipeline_resumable(
            reads_files, args.unitigs, k=args.k,
            paths_file=args.paths_file, na_file=args.not_aligned_file,
            m=args.mismatches, effort=args.effort, fastq=args.fastq,
            correction=args.correction, batch_size=args.batch_size,
            graph=graph, mode=mode, partial=args.partial,
            mesh_devices=args.mesh, index_layout=args.index_layout,
            shard_index=args.shard_index, progress_every=args.progress,
        )
        if profiling:
            import jax

            jax.profiler.stop_trace()
        print(f"Indexing in seconds : {int(stats.index_seconds)}")
        for rf in reads_files:
            print(rf)
        sys.stdout.write(stats.summary())
        if args.json_summary:
            import json

            with open(args.json_summary, "w") as f:
                json.dump(stats.as_dict(), f, indent=2)
                f.write("\n")
        return 0

    t0 = time.monotonic()
    paths, na, stats = run_pipeline(
        reads_files,
        args.unitigs,
        k=args.k,
        m=args.mismatches,
        effort=args.effort,
        fastq=args.fastq,
        correction=args.correction,
        impl=args.impl,
        batch_size=args.batch_size,
        mode=mode,
        partial=args.partial,
        graph=graph,
        save_index=args.save_index,
        mesh_devices=args.mesh,
        process_id=args.process_id,
        num_processes=args.num_processes,
        index_layout=args.index_layout,
        shard_index=args.shard_index,
        progress_every=args.progress,
    )
    if profiling:
        import jax

        jax.profiler.stop_trace()
    paths_file, na_file = args.paths_file, args.not_aligned_file
    if args.num_processes > 1:
        from .dist.multihost import shard_path

        paths_file = shard_path(paths_file, args.process_id)
        na_file = shard_path(na_file, args.process_id)
    with open(paths_file, "wb") as f:
        f.write(paths)
    with open(na_file, "wb") as f:
        f.write(na)
    print_summary = True
    if args.num_processes > 1 and args.coordinator:
        # coordinated run: reduce the counters across processes on the
        # global mesh (the reference's shared atomics, aligner.h:68)
        # and print ONE global stats block, on process 0
        import numpy as np

        from .dist.multihost import global_stats_sum

        tot = global_stats_sum(np.array(
            [stats.read_number, stats.aligned, stats.not_aligned,
             stats.no_overlap], np.int64,
        ))
        if args.process_id == 0:
            (stats.read_number, stats.aligned, stats.not_aligned,
             stats.no_overlap) = (int(v) for v in tot)
        else:
            print_summary = False
    if print_summary:
        print(f"Indexing in seconds : {int(stats.index_seconds)}")
        for rf in reads_files:
            print(rf)
        sys.stdout.write(stats.summary())
    if args.json_summary:
        import json

        with open(args.json_summary, "w") as f:
            json.dump(stats.as_dict(), f, indent=2)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
