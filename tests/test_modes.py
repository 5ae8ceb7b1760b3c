"""Exhaustive (-b) and dog/anchor (-G) mode tests.

Parity strategy per mode (SURVEY.md §4):
  - -G: byte parity vs the reference on the bundled fixture (SURVEY §4.1
    item 6 verified dogMode reproduces the default paths there); on
    synthetic data the reference's rolling-hash bug (position-0-only
    anchors) makes byte parity meaningless, so we check semantic
    validity (recover_path reproduces the read within budget) and that
    the fixed scan aligns at least the reads the reference does,
  - -b: the reference discards its output, so parity is on the stats
    block (its counters work); our output is additionally checked for
    semantic validity and for covering every greedy forward success.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest

from dbgtpu.anchors import align_read_greedy_anchors, get_n_anchors
from dbgtpu.constants import (
    STATUS_ALIGNED_FWD,
    STATUS_ALIGNED_RC,
)
from dbgtpu.exhaustive import align_read_exhaustive
from dbgtpu.index.build import build_graph_from_seqs
from dbgtpu.model import align_read_greedy, recover_path
from dbgtpu.pipeline import run_pipeline
from dbgtpu.seq import encode, hamming, n_mask

from . import synth
from .oracle import reference_available, run_reference

pytestmark = pytest.mark.slow  # heavy parity/scale suite (full gate)

DATA = Path(__file__).with_name("data")
FIXTURE_READS = (DATA / "reads.fa").read_bytes()
FIXTURE_UNITIGS = (DATA / "unitig.fa").read_bytes()

_ALIGNED = (STATUS_ALIGNED_FWD, STATUS_ALIGNED_RC)


def _parse_seqs(fa: bytes) -> list[bytes]:
    lines = fa.strip().split(b"\n")
    return [lines[i + 1] for i in range(0, len(lines), 2)]


def _run(tmp_path, reads_fa, unitigs_fa, k, **kw):
    rf = tmp_path / "r.fa"
    uf = tmp_path / "u.fa"
    rf.write_bytes(reads_fa)
    uf.write_bytes(unitigs_fa)
    return run_pipeline([str(rf)], str(uf), k=k, **kw)


@pytest.mark.skipif(not reference_available(), reason="no reference")
def test_dog_mode_fixture_byte_parity(tmp_path):
    ref_paths, ref_na, _ = run_reference(
        FIXTURE_READS, FIXTURE_UNITIGS, k=4, extra_flags=["-G"]
    )
    paths, na, _ = _run(
        tmp_path, FIXTURE_READS, FIXTURE_UNITIGS, k=4, mode="anchors"
    )
    assert paths == ref_paths
    assert na == ref_na


def test_dog_mode_synthetic_validity():
    reads_fa, unitigs_fa = synth.make_dataset(
        seed=11, genome_len=20000, k=31, n_reads=300, err_frac=0.4
    )
    reads = _parse_seqs(reads_fa)
    g = build_graph_from_seqs(_parse_seqs(unitigs_fa), 31, dog_mode=True)
    aligned = 0
    for r in reads:
        codes, nm = encode(r), n_mask(r)
        status, path = align_read_greedy_anchors(g, codes, nm, 2, 2)
        if status in _ALIGNED:
            aligned += 1
            rc = codes if status == STATUS_ALIGNED_FWD else (3 - codes)[::-1]
            rec = recover_path(g, path, len(r))
            assert len(rec) == len(r)
            assert hamming(rc, rec, nm if status == STATUS_ALIGNED_FWD
                           else np.zeros(len(r), bool)) <= 2
    assert aligned / len(reads) > 0.9


@pytest.mark.skipif(not reference_available(), reason="no reference")
def test_dog_mode_aligns_at_least_reference(tmp_path):
    """The fixed rolling scan must align a superset count of reads."""
    reads_fa, unitigs_fa = synth.make_dataset(
        seed=12, genome_len=15000, k=21, n_reads=200, err_frac=0.3
    )
    _, _, stdout = run_reference(
        reads_fa, unitigs_fa, k=21, extra_flags=["-G"]
    )
    ref_aligned = int(
        re.search(r"Overlap and aligned : (\d+)", stdout).group(1)
    )
    _, _, stats = _run(tmp_path, reads_fa, unitigs_fa, k=21, mode="anchors")
    assert stats.aligned >= ref_aligned


@pytest.mark.skipif(not reference_available(), reason="no reference")
@pytest.mark.parametrize("m", [0, 2])
def test_exhaustive_stats_parity(tmp_path, m):
    """Same search -> same aligned/notAligned counters as reference -b."""
    reads_fa, unitigs_fa = synth.make_dataset(
        seed=13, genome_len=15000, k=21, n_reads=200, err_frac=0.5
    )
    _, _, stdout = run_reference(
        reads_fa, unitigs_fa, k=21, m=m, extra_flags=["-b"]
    )
    ref_aligned = int(
        re.search(r"Overlap and aligned : (\d+)", stdout).group(1)
    )
    ref_not = int(
        re.search(r"Overlap but not aligned : (\d+)", stdout).group(1)
    )
    _, _, stats = _run(
        tmp_path, reads_fa, unitigs_fa, k=21, m=m, mode="exhaustive"
    )
    assert (stats.aligned, stats.not_aligned) == (ref_aligned, ref_not)


def test_exhaustive_covers_greedy_forward_and_is_valid():
    reads_fa, unitigs_fa = synth.make_dataset(
        seed=14, genome_len=15000, k=21, n_reads=200, err_frac=0.5
    )
    reads = _parse_seqs(reads_fa)
    g = build_graph_from_seqs(_parse_seqs(unitigs_fa), 21)
    n_exh = 0
    for r in reads:
        codes, nm = encode(r), n_mask(r)
        gs, _ = align_read_greedy(g, codes, nm, 2, 2)
        es, path = align_read_exhaustive(g, codes, nm, 2)
        if gs == STATUS_ALIGNED_FWD:
            # exhaustive tries every anchor and keeps the min -> must
            # find any forward alignment greedy found
            assert es == STATUS_ALIGNED_FWD
        if es == STATUS_ALIGNED_FWD:
            n_exh += 1
            rec = recover_path(g, path, len(r))
            assert hamming(codes, rec, nm) <= 2
    assert n_exh > 0


def test_exhaustive_partial_accepts_dead_ends():
    """-i: a read walking off a graph dead end is accepted when the
    right extension has no candidates."""
    k = 5
    # one unitig; read starts inside it and runs past its end into
    # sequence absent from the graph
    u = b"AAAACCCCGGGG"
    g = build_graph_from_seqs([u], k)
    read = u[4:] + b"TTTTT"  # tail not in graph
    codes, nm = encode(read), n_mask(read)
    st, _ = align_read_exhaustive(g, codes, nm, 0, partial=False)
    st_p, path = align_read_exhaustive(g, codes, nm, 0, partial=True)
    assert st != STATUS_ALIGNED_FWD
    assert st_p == STATUS_ALIGNED_FWD
    assert path[0] == 4 and path[1] == 1


@pytest.mark.skipif(not reference_available(), reason="no reference")
def test_exhaustive_reference_output_is_empty_ours_is_not(tmp_path):
    """Documents the deviation: reference -b discards output."""
    ref_paths, _, _ = run_reference(
        FIXTURE_READS, FIXTURE_UNITIGS, k=4, extra_flags=["-b"]
    )
    assert ref_paths == b""
    paths, _, _ = _run(
        tmp_path, FIXTURE_READS, FIXTURE_UNITIGS, k=4, mode="exhaustive"
    )
    assert b"0.1.3.4.-6." in paths


@pytest.mark.skipif(not reference_available(), reason="no reference")
def test_dog_mode_fixture_byte_parity_jax(tmp_path):
    ref_paths, ref_na, _ = run_reference(
        FIXTURE_READS, FIXTURE_UNITIGS, k=4, extra_flags=["-G"]
    )
    paths, na, _ = _run(
        tmp_path, FIXTURE_READS, FIXTURE_UNITIGS, k=4, mode="anchors",
        impl="jax",
    )
    assert paths == ref_paths
    assert na == ref_na


@pytest.mark.parametrize("seed,k,m,n_frac,min_u,max_u", [
    (201, 31, 2, 0.0, 40, 150),
    (202, 15, 2, 0.0, 40, 150),
    (203, 21, 1, 0.3, 40, 150),   # N-carrying reads
    (204, 31, 0, 0.0, 40, 150),   # exact mode
    (205, 15, 2, 0.0, 16, 40),    # short unitigs: cases 3/4 dominate
])
def test_dog_engine_vs_spec(tmp_path, seed, k, m, n_frac, min_u, max_u):
    """Device dog mode == executable spec, byte for byte."""
    reads_fa, unitigs_fa = synth.make_dataset(
        seed=seed, genome_len=12000, k=k, n_reads=150, n_frac=n_frac,
        min_unitig=min_u, max_unitig=max_u,
    )
    kw = dict(k=k, m=m, effort=2, mode="anchors", batch_size=64)
    got = _run(tmp_path, reads_fa, unitigs_fa, impl="jax", **kw)
    want = _run(tmp_path, reads_fa, unitigs_fa, impl="python", **kw)
    assert got[0] == want[0]
    assert got[1] == want[1]


def test_dog_engine_vs_spec_long_reads_contained(tmp_path):
    """Unitigs longer than the reads: placement cases 3/4 + RC."""
    reads_fa, unitigs_fa = synth.make_dataset(
        seed=206, genome_len=8000, k=21, n_reads=120,
        min_unitig=150, max_unitig=400, read_len=80,
    )
    kw = dict(k=21, m=2, effort=2, mode="anchors", batch_size=64)
    got = _run(tmp_path, reads_fa, unitigs_fa, impl="jax", **kw)
    want = _run(tmp_path, reads_fa, unitigs_fa, impl="python", **kw)
    assert got[0] == want[0]
    assert got[1] == want[1]


@pytest.mark.parametrize("seed,k,m,n_frac,partial", [
    (301, 31, 2, 0.0, False),
    (302, 15, 2, 0.0, False),
    (303, 21, 1, 0.3, False),     # N-carrying reads (quirky anchors)
    (304, 21, 2, 0.0, True),      # -i partial acceptance
    (305, 15, 2, 0.0, False),
])
def test_exhaustive_engine_vs_spec(tmp_path, seed, k, m, n_frac, partial):
    """Device exhaustive DFS == executable spec, byte for byte."""
    reads_fa, unitigs_fa = synth.make_dataset(
        seed=seed, genome_len=9000, k=k, n_reads=120, n_frac=n_frac,
    )
    kw = dict(k=k, m=m, mode="exhaustive", partial=partial,
              batch_size=64)
    got = _run(tmp_path, reads_fa, unitigs_fa, impl="jax", **kw)
    want = _run(tmp_path, reads_fa, unitigs_fa, impl="python", **kw)
    assert got[0] == want[0]
    assert got[1] == want[1]


def test_exhaustive_engine_fixture(tmp_path):
    paths, _, _ = _run(
        tmp_path, FIXTURE_READS, FIXTURE_UNITIGS, k=4,
        mode="exhaustive", impl="jax",
    )
    want, _, _ = _run(
        tmp_path, FIXTURE_READS, FIXTURE_UNITIGS, k=4,
        mode="exhaustive", impl="python",
    )
    assert paths == want


def test_anchor_table_excludes_final_kmer():
    k = 5
    u = b"ACGTACGGA"
    g = build_graph_from_seqs([u], k, dog_mode=True)
    # k-mers at offsets 0..len-k-1 = 0..3 indexed; offset 4 (last) not
    anchors = get_n_anchors(g, encode(u[4 : 4 + k]), 1)
    assert anchors == []
    anchors = get_n_anchors(g, encode(u[3 : 3 + k]), 1)
    assert anchors and anchors[0][:2] == (1, 3)


def test_dog_mphf_anchor_layout_byte_parity(tmp_path, monkeypatch):
    """Large dog keysets take the MPHF anchor layout (the reference's
    own anchorsMPHF structure); engine output must equal the spec's and
    persistence must roundtrip device-ready.

    The engine runs execute in SUBPROCESS CLI invocations: compiling
    the dog-mphf program inside a long suite process segfaults XLA's
    CPU backend (reproducible at the same spot across runs, passes in
    any smaller selection — an XLA-internal state issue, not a dbgtpu
    one), and the CLI is the production surface anyway."""
    import subprocess
    import sys as _sys

    import numpy as np

    import dbgtpu.index.device as dm
    from dbgtpu.index.persist import load_index, save_index
    from dbgtpu.pipeline import run_pipeline

    from .synth import make_dataset

    reads_fa, unitigs_fa = make_dataset(
        seed=6161, genome_len=9000, k=21, n_reads=250, err_frac=0.4,
    )
    rf, uf = tmp_path / "r.fa", tmp_path / "u.fa"
    rf.write_bytes(reads_fa)
    uf.write_bytes(unitigs_fa)
    want = run_pipeline([str(rf)], str(uf), k=21, impl="python",
                        mode="anchors")

    import os as _os
    import dbgtpu as _pkg

    repo_root = _os.path.dirname(_os.path.dirname(_pkg.__file__))
    env = dict(
        _os.environ,
        JAX_PLATFORMS="cpu", DBGTPU_ANCHOR_MPHF_MIN="1",
        PYTHONPATH=repo_root,
    )

    def cli(*args):
        subprocess.run(
            [_sys.executable, "-m", "dbgtpu", *args],
            cwd=tmp_path, env=env, check=True,
            stdout=subprocess.DEVNULL,
        )

    cli("-r", "r.fa", "-k", "21", "-g", "u.fa", "-G", "--impl", "jax",
        "-f", "p1", "-a", "n1", "--save-index", "dog.idx.npz")
    assert (tmp_path / "p1").read_bytes() == want[0]
    assert (tmp_path / "n1").read_bytes() == want[1]

    # persisted artifacts carry the mphf anchor layout and load
    # device-ready; the loaded index maps byte-identically
    monkeypatch.setattr(dm, "ANCHOR_MPHF_MIN", 1)
    g2 = load_index(str(tmp_path / "dog.idx.npz"),
                    stream_device=False)
    d2 = getattr(g2, "_device_index", None)
    assert d2 is not None and d2.anchor_mphf is not None
    assert d2.anchor_scan is None
    assert len(d2.anchor_mphf.arows) == len(g2.anchors)
    cli("-r", "r.fa", "--load-index", "dog.idx.npz", "-G",
        "--impl", "jax", "-f", "p2", "-a", "n2")
    assert (tmp_path / "p2").read_bytes() == want[0]
    assert (tmp_path / "n2").read_bytes() == want[1]
