"""Smoke run of dbgtpu on GPUs, through the command line a user calls.

Generates an E. coli-sized graph and read set from a seed (a 4.6 Mbp
genome, ~70k unitigs of 40-150 bp at k=31, 262,144 reads of 100 bp,
half with 1-2 substitutions, 3% with an N) and maps it with
`python -m dbgtpu --impl jax`:

  - greedy (-m 2) on every read, -c on 65,536, -G on 65,536 and -b on
    32,768 reads, each mode run twice (the second run finds its
    programs in the persistent compile cache);
  - greedy with --save-index, then with --load-index.

Checks, each by byte equality:

  - golden: k=4 on tests/data gives `0.1.3.4.-6.` and `0.1.3.5.-6.`;
  - spec: each mode's outputs for the first 4,096 reads equal
    `--impl python` (the executable spec) run on those reads;
  - persistence: the --load-index run equals the fresh greedy run;
  - device: every device run's --json-summary reports impl jax,
    platform gpu and a loaded native reader.

Device runs are child processes with JAX_PLATFORMS=cuda, so none can
fall back to the CPU, and they run one at a time: a JAX process
reserves most of a card's memory.  This process never imports JAX.
The spec runs are CPU-only children.

    python chip_smoke.py           # one card
    python chip_smoke.py --multi   # four cards: --mesh 4,
                                   # --mesh 4 --shard-index, and four
                                   # processes (one per card) merged,
                                   # each against a one-card run

The last line of stdout is {"ok": true, "device": {...}}; it is
printed only when every phase passed.  Any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

SEED = 20261016
GENOME_LEN = 4_600_000
K = 31
READ_LEN = 100
N_READS = 262_144
SPEC_READS = 4_096
# (phase, CLI flags, reads mapped)
MODES = (
    ("greedy", [], N_READS),
    ("correct", ["-c"], 65_536),
    ("anchors", ["-G"], 65_536),
    ("exhaustive", ["-b"], 32_768),
)
GOLDEN = b">nomiss\n0.1.3.4.-6.\n>nomiss\n0.1.3.5.-6.\n"
CHILD_TIMEOUT = 300    # seconds; the slowest child takes ~40 s on an H100
# what device runs ask JAX for, and what their summaries must report
JAX_PLATFORM = "cuda"
PLATFORM = "gpu"


class SmokeError(Exception):
    """A phase failed."""


def make_dataset(seed: int, genome_len: int,
                 n_reads: int) -> tuple[bytes, bytes]:
    """(reads FASTA, unitigs FASTA), a pure function of its arguments.
    Reads are named r0, r1, ... in file order."""
    import numpy as np

    from tests import synth

    rng = np.random.default_rng(seed)
    genome = synth.make_genome(rng, genome_len)
    unitigs = synth.chop_unitigs(genome, K, rng, 40, 150)
    unitigs = synth.orient_shuffle(unitigs, rng)
    reads = synth.sample_reads(
        genome, rng, n_reads, READ_LEN, err_frac=0.5, n_frac=0.03
    )
    return synth.to_fasta(reads), synth.to_fasta(unitigs, prefix=b"u")


def head_records(fasta: bytes, n: int) -> bytes:
    """The first n records of a FASTA file of two-line records."""
    lines = fasta.split(b"\n")
    return b"".join(line + b"\n" for line in lines[: 2 * n])


def records_below(out: bytes, n: int) -> bytes:
    """Records of a paths / notAligned / corrected-reads file whose read
    is among the first n (header `>r<i>` with i < n)."""
    lines = out.split(b"\n")
    keep = []
    for i in range(0, len(lines) - 1, 2):
        if int(lines[i][2:]) < n:
            keep.append(lines[i] + b"\n" + lines[i + 1] + b"\n")
    return b"".join(keep)


def last_line(platform: str, kind: str, count: int) -> str:
    return json.dumps({
        "ok": True,
        "device": {"platform": platform, "kind": kind, "count": count},
    })


class Run:
    """One finished CLI child: wall seconds, summary and outputs."""

    def __init__(self, tag, wall, summary, paths, na):
        self.tag, self.wall, self.summary = tag, wall, summary
        self.paths, self.na = paths, na

    @property
    def map_seconds(self) -> float:
        return self.summary["map_seconds"]


def _env(device: bool) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p
    )
    env["JAX_PLATFORMS"] = JAX_PLATFORM if device else "cpu"
    return env


def _argv(tag: str, args: list[str]) -> list[str]:
    return [
        sys.executable, "-m", "dbgtpu", *args,
        "-f", str(WORK / f"{tag}.paths"),
        "-a", str(WORK / f"{tag}.na"),
        "--json-summary", str(WORK / f"{tag}.json"),
    ]


def _collect(tag: str, proc: subprocess.Popen, t0: float,
             device: bool, suffix: str = "") -> Run:
    try:
        proc.wait(timeout=max(1.0, t0 + CHILD_TIMEOUT - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        proc.kill()
        proc.wait()
    wall = time.monotonic() - t0
    if proc.returncode != 0:
        err = (WORK / f"{tag}.err").read_text(errors="replace")
        raise SmokeError(f"{tag}: exit {proc.returncode} after {wall:.0f} s"
                         f"\n{err[-4000:]}")
    summary = json.loads((WORK / f"{tag}.json").read_text())
    if device:
        got = (summary["impl"], summary["platform"], summary["native_io"])
        if got != ("jax", PLATFORM, True):
            raise SmokeError(
                f"{tag}: ran as impl/platform/native_io {got}, "
                f"want ('jax', {PLATFORM!r}, True)"
            )
    return Run(
        tag, wall, summary,
        (WORK / f"{tag}.paths{suffix}").read_bytes(),
        (WORK / f"{tag}.na{suffix}").read_bytes(),
    )


def start(tag: str, args: list[str], *, device: bool = True) -> tuple:
    print(f"start {tag}", file=sys.stderr, flush=True)
    with open(WORK / f"{tag}.err", "wb") as err:
        proc = subprocess.Popen(
            _argv(tag, args), cwd=WORK, env=_env(device),
            stdout=subprocess.DEVNULL, stderr=err,
        )
    return tag, proc, time.monotonic(), device


def run(tag: str, args: list[str], *, device: bool = True) -> Run:
    return _collect(*start(tag, args, device=device))


def expect_equal(what: str, got: bytes, want: bytes) -> None:
    if got != want:
        raise SmokeError(
            f"{what}: outputs differ ({len(got)} vs {len(want)} bytes)"
        )


def card_lines() -> list[str]:
    """`name, power.limit` of each card, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise SmokeError(f"no GPU: nvidia-smi failed ({e})") from e
    return [line.strip() for line in out.splitlines() if line.strip()]


def _rate(reads: int, seconds: float) -> str:
    return f"{reads / seconds:,.0f}" if seconds > 0 else "n/a"


def write_dataset() -> dict:
    t0 = time.monotonic()
    reads, unitigs = make_dataset(SEED, GENOME_LEN, N_READS)
    (WORK / "unitig.fa").write_bytes(unitigs)
    files = {}
    for n in sorted({n for _, _, n in MODES} | {SPEC_READS}):
        files[n] = WORK / f"reads_{n}.fa"
        files[n].write_bytes(head_records(reads, n))
    print(f"dataset: seed {SEED}, genome {GENOME_LEN} bp, "
          f"{unitigs.count(b'>')} unitigs, {N_READS} reads "
          f"({time.monotonic() - t0:.1f} s)", flush=True)
    return files


def smoke_one_card() -> tuple:
    from dbgtpu import native

    if not native.available():
        raise SmokeError("the native reader (dbgtpu/native) did not load")
    print("native reader: loaded", flush=True)

    fixture = ROOT / "tests" / "data"
    golden = run("golden", [
        "-r", str(fixture / "reads.fa"), "-g", str(fixture / "unitig.fa"),
        "-k", "4", "--impl", "jax",
    ])
    expect_equal("golden fixture paths", golden.paths, GOLDEN)
    expect_equal("golden fixture notAligned", golden.na, b"")
    print(f"phase golden: 2 reads, wall {golden.wall:.1f} s, "
          "paths equal the golden output", flush=True)

    files = write_dataset()
    common = ["-g", str(WORK / "unitig.fa"), "-k", str(K), "-m", "2"]
    spec = [
        start(f"{name}_spec",
              ["-r", str(files[SPEC_READS]), *common, *flags,
               "--impl", "python"], device=False)
        for name, flags, _ in MODES
    ]
    try:
        device_runs = {}
        for name, flags, n in MODES:
            args = ["-r", str(files[n]), *common, *flags, "--impl", "jax"]
            first = run(f"{name}_1", args)
            second = run(f"{name}_2", args + (
                ["--save-index", str(WORK / "index.npz")]
                if name == "greedy" else []
            ))
            expect_equal(f"{name} run 2 paths", second.paths, first.paths)
            expect_equal(f"{name} run 2 notAligned", second.na, first.na)
            device_runs[name] = (first, second)
            print(
                f"phase {name}: {n} reads | run 1 wall "
                f"{first.wall:.1f} s, map {first.map_seconds:.3f} s | "
                f"run 2 wall {second.wall:.1f} s, map "
                f"{second.map_seconds:.3f} s | "
                f"{_rate(n, second.map_seconds)} reads/s (run 2 map), "
                f"{_rate(n, second.wall)} reads/s (run 2 wall) | "
                f"overflow rows on host "
                f"{second.summary['overflow_rows']}",
                flush=True,
            )
        loaded = run("load_index", [
            "-r", str(files[N_READS]), "--load-index",
            str(WORK / "index.npz"), "-m", "2", "--impl", "jax",
        ])
        fresh = device_runs["greedy"][0]
        expect_equal("--load-index paths", loaded.paths, fresh.paths)
        expect_equal("--load-index notAligned", loaded.na, fresh.na)
        print(f"phase load-index: {N_READS} reads, wall "
              f"{loaded.wall:.1f} s, map {loaded.map_seconds:.3f} s, "
              f"{_rate(N_READS, loaded.map_seconds)} reads/s (map); "
              "bytes equal the fresh greedy run", flush=True)

        for tag, proc, t0, dev in spec:
            want = _collect(tag, proc, t0, dev)
            name = tag[: -len("_spec")]
            got = device_runs[name][0]
            expect_equal(f"{name} paths vs spec",
                         records_below(got.paths, SPEC_READS), want.paths)
            expect_equal(f"{name} notAligned vs spec",
                         records_below(got.na, SPEC_READS), want.na)
            print(f"phase spec {name}: first {SPEC_READS} reads equal "
                  f"--impl python ({want.summary['aligned']} aligned)",
                  flush=True)
    finally:
        for _, proc, _, _ in spec:
            proc.kill()
    s = loaded.summary
    return s["platform"], s["device_kind"], s["device_count"]


def smoke_four_cards() -> tuple:
    files = write_dataset()
    args = ["-r", str(files[N_READS]), "-g", str(WORK / "unitig.fa"),
            "-k", str(K), "-m", "2", "--impl", "jax"]
    ref = run("one_card", args)
    print(f"phase one-card: {N_READS} reads, wall {ref.wall:.1f} s, "
          f"map {ref.map_seconds:.3f} s, "
          f"{_rate(N_READS, ref.map_seconds)} reads/s (map)", flush=True)
    mesh = None
    for tag, extra in (("mesh4", ["--mesh", "4"]),
                       ("mesh4_shard_index",
                        ["--mesh", "4", "--shard-index"])):
        r = run(tag, args + extra)
        expect_equal(f"{tag} paths", r.paths, ref.paths)
        expect_equal(f"{tag} notAligned", r.na, ref.na)
        if r.summary["device_count"] != 4:
            raise SmokeError(f"{tag}: saw {r.summary['device_count']} "
                             "cards, want 4")
        mesh = mesh or r
        print(f"phase {tag}: wall {r.wall:.1f} s, map "
              f"{r.map_seconds:.3f} s, {_rate(N_READS, r.map_seconds)} "
              "reads/s (map); bytes equal the one-card run", flush=True)

    t0 = time.monotonic()
    procs = [
        start(f"proc{i}", args + ["--num-processes", "4",
                                  "--process-id", str(i)])
        for i in range(4)
    ]
    try:
        shards = [_collect(*p, suffix=f".shard{i}")
                  for i, p in enumerate(procs)]
    finally:
        for _, proc, _, _ in procs:
            proc.kill()
    wall = time.monotonic() - t0
    for r in shards:
        if r.summary["device_count"] != 1:
            raise SmokeError(f"{r.tag}: saw {r.summary['device_count']} "
                             "cards, want its own one")
    merged = ["-r", "-", "--merge-shards", "4",
              "-f", str(WORK / "proc.paths"), "-a", str(WORK / "proc.na")]
    for i in range(4):
        for kind in ("paths", "na"):
            os.replace(WORK / f"proc{i}.{kind}.shard{i}",
                       WORK / f"proc.{kind}.shard{i}")
    subprocess.run([sys.executable, "-m", "dbgtpu", *merged], cwd=WORK,
                   env=_env(False), check=True, timeout=CHILD_TIMEOUT)
    expect_equal("4-process merged paths",
                 (WORK / "proc.paths").read_bytes(), ref.paths)
    expect_equal("4-process merged notAligned",
                 (WORK / "proc.na").read_bytes(), ref.na)
    print(f"phase 4-process: wall {wall:.1f} s (all four), map "
          + ", ".join(f"{r.map_seconds:.3f}" for r in shards)
          + " s; merged bytes equal the one-card run", flush=True)
    s = mesh.summary
    return s["platform"], s["device_kind"], s["device_count"]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phases")
    args = ap.parse_args(argv)
    if not (ROOT / "dbgtpu" / "cli.py").exists() or not (
        ROOT / "tests" / "synth.py"
    ).exists():
        print("chip_smoke.py must run from a dbgtpu checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        cards = card_lines()
        shutil.rmtree(WORK, ignore_errors=True)
        WORK.mkdir(parents=True)
        t0 = time.monotonic()
        platform, kind, count = (
            smoke_four_cards() if args.multi else smoke_one_card()
        )
    except SmokeError as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    print(f"total wall {time.monotonic() - t0:.1f} s")
    for line in cards:
        print(f"card: {line}")
    print(last_line(platform, kind, count))
    return 0


if __name__ == "__main__":
    sys.exit(main())
