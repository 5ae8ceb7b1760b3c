"""Native C++ IO layer: byte parity with the python spec parser."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from dbgtpu import native
from dbgtpu.io.fasta import iter_reads

from . import synth

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native lib unavailable"
)


def _compare(path, k, fastq):
    got = native.parse_reads_native(str(path), k, fastq)
    want = list(iter_reads(str(path), k, fastq))
    assert got.n == len(want)
    for i, (hdr, seq) in enumerate(want):
        h, codes, nm = got.record(i)
        assert h == hdr
        assert got.seq_bytes(i) == seq
    # bulk parity with the python bulk fallback
    py = native.parse_reads_python(str(path), k, fastq)
    np.testing.assert_array_equal(got.codes, py.codes)
    np.testing.assert_array_equal(got.nmask, py.nmask)
    np.testing.assert_array_equal(got.seq_off, py.seq_off)
    assert got.headers == py.headers


def test_fixture_fasta(tmp_path):
    _compare(Path(__file__).with_name("data") / "reads.fa", 4, False)


def test_synthetic_fasta(tmp_path):
    reads_fa, _ = synth.make_dataset(
        seed=21, genome_len=5000, k=21, n_reads=100, n_frac=0.2
    )
    p = tmp_path / "r.fa"
    p.write_bytes(reads_fa)
    _compare(p, 21, False)


def test_multiline_and_rejects(tmp_path):
    p = tmp_path / "r.fa"
    p.write_bytes(
        b"junk-before-first-header-ignored\n"
        b">a\nACGTAC\nGTACGT\n"       # multi-line join, accepted
        b">b\nACG\n"                  # len 3 <= k -> rejected (k=5)
        b">c\nACGTXACGTA\n"           # bad char -> rejected
        b">d\nACGNNNACGT\n"           # N fine
        b">e\nACGTACGTA"              # no trailing newline
    )
    got = native.parse_reads_native(str(p), 5, False)
    want = list(iter_reads(str(p), 5, False))
    assert [h for h, _ in want] == [b">a", b">d", b">e"]
    assert got.n == 3
    for i, (hdr, seq) in enumerate(want):
        assert got.record(i)[0] == hdr
        assert got.seq_bytes(i) == seq


def test_fastq(tmp_path):
    reads_fa, _ = synth.make_dataset(
        seed=22, genome_len=5000, k=21, n_reads=50
    )
    seqs = [
        reads_fa.split(b"\n")[i + 1]
        for i in range(0, 100, 2)
    ]
    p = tmp_path / "r.fq"
    p.write_bytes(synth.to_fastq(seqs))
    _compare(p, 21, True)


def test_fastq_truncated_last_record(tmp_path):
    p = tmp_path / "r.fq"
    p.write_bytes(b"@a\nACGTACGT\n+\nIIIIIIII\n@b\nGGGGCCCC\n")
    _compare(p, 4, True)
    got = native.parse_reads_native(str(p), 4, True)
    assert got.n == 2  # no last-record duplication (reference defect)


def test_format_paths():
    headers = b">r0>r1>r2"
    hdr_off = np.array([0, 3, 6, 9], np.int64)
    status = np.array([1, 0, 2], np.int32)
    path_off = np.array([0, 3, 3, 5], np.int64)
    flat = np.array([0, 1, -6, 2, 4], np.int32)
    out = native.format_paths_native(headers, hdr_off, status, path_off, flat)
    assert out == b">r0\n0.1.-6.\n>r2\n2.4.\n"


def test_format_notaligned():
    headers = b">r0>r1>r2"
    hdr_off = np.array([0, 3, 6, 9], np.int64)
    status = np.array([1, 0, 5], np.int32)
    chars = np.frombuffer(b"ACGTGGCCAATT", np.uint8)
    seq_off = np.array([0, 4, 8, 12], np.int64)
    out = native.format_notaligned_native(
        headers, hdr_off, status, chars, seq_off
    )
    assert out == b">r1\nGGCC\n>r2\nAATT\n"


@pytest.mark.slow
def test_corrected_native_matches_python_spec(tmp_path):
    """-c output through the jax bulk pipeline (native recoverPath
    formatter) must byte-match the python spec pipeline."""
    from dbgtpu.pipeline import run_pipeline

    reads_fa, unitigs_fa = synth.make_dataset(
        seed=43, genome_len=12000, k=31, n_reads=200, err_frac=0.5,
    )
    rp, up = tmp_path / "r.fa", tmp_path / "u.fa"
    rp.write_bytes(reads_fa)
    up.write_bytes(unitigs_fa)
    pj, nj, _ = run_pipeline(
        [str(rp)], str(up), k=31, m=2, effort=2, impl="jax",
        correction=True, batch_size=128,
    )
    pp, np_, _ = run_pipeline(
        [str(rp)], str(up), k=31, m=2, effort=2, impl="python",
        correction=True,
    )
    assert pj == pp
    assert nj == np_
