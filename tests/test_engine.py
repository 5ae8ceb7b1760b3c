"""Device-engine tests: unit (kmer32, hash table) + parity vs the
executable spec and the compiled reference."""

from pathlib import Path

import numpy as np
import pytest

from dbgtpu import seq
from dbgtpu.engine import kmer32
from dbgtpu.index.build import build_graph_from_seqs
from dbgtpu.index.device import build_device_index, build_hash_table, ht_find_host
from dbgtpu.pipeline import run_pipeline

from . import oracle, synth

DATA = Path(__file__).with_name("data")


def test_rcb_pair_matches_numpy():
    rng = np.random.default_rng(0)
    for n in (4, 15, 16, 17, 31, 32):
        vs = rng.integers(0, 1 << (2 * n), size=200, dtype=np.uint64)
        hi, lo = kmer32.split64(vs)
        rhi, rlo = kmer32.rcb_pair(hi, lo, n)
        expect = seq.rcb(vs, n)
        got = kmer32.join64(rhi, rlo)
        np.testing.assert_array_equal(got, expect)


def test_mix32_numpy_jnp_identical():
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    hi = rng.integers(0, 2**32, size=100, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, size=100, dtype=np.uint64).astype(np.uint32)
    h_np = kmer32.mix32(hi, lo)
    h_j = np.asarray(kmer32.mix32(jnp.asarray(hi), jnp.asarray(lo)))
    np.testing.assert_array_equal(h_np, h_j)


def test_hash_table_exact_dict():
    rng = np.random.default_rng(2)
    keys = np.unique(rng.integers(0, 2**62, size=5000, dtype=np.uint64))
    vals = rng.integers(1, 100, size=(len(keys), 8)).astype(np.int32)
    t = build_hash_table(keys, vals)
    # every key findable via the two-choice host lookup
    hi, lo = kmer32.split64(keys)
    found = ht_find_host(t, hi, lo)
    assert (found >= 0).all()
    np.testing.assert_array_equal(t.vals.reshape(-1, 8)[found], vals)
    # absent keys never match
    absent = rng.integers(2**62, 2**63, size=1000, dtype=np.uint64)
    ahi, alo = kmer32.split64(absent)
    assert (ht_find_host(t, ahi, alo) < 0).all()


def _paths_by_engine(reads_fa, unitigs_fa, k, m, effort, tmp_path, impl,
                     batch_size=64):
    rp = tmp_path / f"reads_{impl}.fa"
    up = tmp_path / f"unitigs_{impl}.fa"
    rp.write_bytes(reads_fa)
    up.write_bytes(unitigs_fa)
    return run_pipeline(
        [str(rp)], str(up), k=k, m=m, effort=effort, impl=impl,
        batch_size=batch_size,
    )


def test_engine_fixture_golden(tmp_path):
    reads = (DATA / "reads.fa").read_bytes()
    unitigs = (DATA / "unitig.fa").read_bytes()
    paths, na, _ = _paths_by_engine(reads, unitigs, 4, 2, 2, tmp_path, "jax")
    assert paths == b">nomiss\n0.1.3.4.-6.\n>nomiss\n0.1.3.5.-6.\n"
    assert na == b""


@pytest.mark.parametrize("seed,k,m,n_frac", [
    (101, 31, 2, 0.0),
    (102, 15, 2, 0.0),
    (103, 21, 1, 0.3),
    (104, 31, 0, 0.0),
])
@pytest.mark.slow
def test_engine_vs_spec(tmp_path, seed, k, m, n_frac):
    reads_fa, unitigs_fa = synth.make_dataset(
        seed=seed, genome_len=12000, k=k, n_reads=150, n_frac=n_frac,
    )
    got = _paths_by_engine(reads_fa, unitigs_fa, k, m, 2, tmp_path, "jax")
    want = _paths_by_engine(reads_fa, unitigs_fa, k, m, 2, tmp_path, "python")
    assert got[0] == want[0]
    assert got[1] == want[1]


@pytest.mark.slow
def test_engine_vs_spec_short_unitigs(tmp_path):
    reads_fa, unitigs_fa = synth.make_dataset(
        seed=111, genome_len=6000, k=15, n_reads=120,
        min_unitig=15, max_unitig=40,
    )
    got = _paths_by_engine(reads_fa, unitigs_fa, 15, 2, 2, tmp_path, "jax")
    want = _paths_by_engine(reads_fa, unitigs_fa, 15, 2, 2, tmp_path,
                            "python")
    assert got[:2] == want[:2]


@pytest.mark.skipif(not oracle.reference_available(),
                    reason="reference not mounted")
@pytest.mark.slow
def test_engine_vs_reference_binary(tmp_path):
    reads_fa, unitigs_fa = synth.make_dataset(
        seed=121, genome_len=20000, k=31, n_reads=300, n_frac=0.2,
    )
    ref_paths, ref_na, _ = oracle.run_reference(
        reads_fa, unitigs_fa, k=31, m=2, effort=2
    )
    paths, na, _ = _paths_by_engine(
        reads_fa, unitigs_fa, 31, 2, 2, tmp_path, "jax"
    )
    assert paths == ref_paths
    assert na == ref_na


@pytest.mark.slow
def test_engine_pool_chunk_fallback_matches_embedded(tmp_path, monkeypatch):
    """The SW == 0 pool-chunk gather path (taken when unitigs exceed
    EMBED_CAP_BASES) must produce the same results as the embedded-seq
    fast path — force it by capping the embed threshold below the
    graph's max unitig length (the fallback has no coverage otherwise,
    since every synthetic graph uses the embedded path)."""
    from dbgtpu.index import device as D

    reads_fa, unitigs_fa = synth.make_dataset(
        seed=131, genome_len=12000, k=21, n_reads=150, n_frac=0.1,
    )
    want = _paths_by_engine(reads_fa, unitigs_fa, 21, 2, 2, tmp_path, "jax")
    monkeypatch.setattr(D, "EMBED_CAP_BASES", 8)
    got = _paths_by_engine(reads_fa, unitigs_fa, 21, 2, 2, tmp_path, "jax")
    assert got[0] == want[0]
    assert got[1] == want[1]


@pytest.mark.slow
def test_engine_mphf_layout_matches_scan(tmp_path):
    """--index-layout mphf (compact BBHash-backed junction table) must
    be byte-identical to the default one-gather scan layout across all
    three device modes (the MPHF is the >HBM-graph option,
    verified-key lookups, aliasing defense aligner.cpp:158-169)."""
    from dbgtpu.pipeline import run_pipeline

    reads_fa, unitigs_fa = synth.make_dataset(
        seed=141, genome_len=12000, k=21, n_reads=150, n_frac=0.1,
    )
    rf = tmp_path / "r.fa"
    uf = tmp_path / "u.fa"
    rf.write_bytes(reads_fa)
    uf.write_bytes(unitigs_fa)
    for mode in ("greedy", "anchors", "exhaustive"):
        want = run_pipeline(
            [str(rf)], str(uf), k=21, m=2, impl="jax", mode=mode,
            batch_size=256,
        )
        got = run_pipeline(
            [str(rf)], str(uf), k=21, m=2, impl="jax", mode=mode,
            batch_size=256, index_layout="mphf",
        )
        assert got[0] == want[0], mode
        assert got[1] == want[1], mode


@pytest.mark.parametrize("L,n", [(112, 30), (64, 3), (100, 31),
                                 (48, 32), (256, 20), (35, 14)])
def test_packed_kmer_scan_equals_naive(L, n):
    """The funnel-class packed scan (core._scan_kmer_pairs_words) must
    equal the naive per-offset shift-OR scan bit for bit."""
    import jax.numpy as jnp

    from dbgtpu.engine.core import (
        _pack_rows, _scan_kmer_pairs, _scan_kmer_pairs_words,
    )

    rng = np.random.default_rng(L * 37 + n)
    codes = jnp.asarray(rng.integers(0, 4, (9, L), np.uint32))
    Lw = (L + 15) // 16
    rw = _pack_rows(codes, 2 * Lw + 1)
    h1, l1 = _scan_kmer_pairs(codes, n, False)
    h2, l2 = _scan_kmer_pairs_words(rw, L, n)
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))


def test_renumbered_index_byte_identical(tmp_path, monkeypatch):
    """DBGTPU_RENUMBER=1 builds the device tables in BFS graph order
    (walk-gather locality); the runner translates ids back on drain, so
    pipeline output is byte-identical to the file-order build."""
    from dbgtpu.pipeline import run_pipeline

    from .synth import make_dataset

    reads_fa, unitigs_fa = make_dataset(
        seed=909, genome_len=15000, k=21, n_reads=300, err_frac=0.5,
    )
    rf = tmp_path / "r.fa"
    uf = tmp_path / "u.fa"
    rf.write_bytes(reads_fa)
    uf.write_bytes(unitigs_fa)
    want_p, want_n, want_s = run_pipeline(
        [str(rf)], str(uf), k=21, m=2, effort=2, impl="jax",
        batch_size=128,
    )
    monkeypatch.setenv("DBGTPU_RENUMBER", "1")
    got_p, got_n, got_s = run_pipeline(
        [str(rf)], str(uf), k=21, m=2, effort=2, impl="jax",
        batch_size=128,
    )
    assert got_p == want_p
    assert got_n == want_n
    assert got_s.aligned == want_s.aligned


@pytest.mark.slow
def test_engine_long_reads_parity(tmp_path):
    """500 bp reads: the L=512 bucket path with the length-scaled pmax
    cap (runner._pmax_cap) must stay byte-identical to the spec —
    formerly these batches hit the static 30-slot cap and fell back to
    per-read host recomputes for most aligned reads."""
    from dbgtpu.pipeline import run_pipeline

    from .synth import make_dataset

    reads_fa, unitigs_fa = make_dataset(
        seed=515, genome_len=40000, k=31, n_reads=120, err_frac=0.3,
        read_len=500,
    )
    rf = tmp_path / "r.fa"
    uf = tmp_path / "u.fa"
    rf.write_bytes(reads_fa)
    uf.write_bytes(unitigs_fa)
    want = run_pipeline([str(rf)], str(uf), k=31, m=2, effort=2,
                        impl="python")
    got = run_pipeline([str(rf)], str(uf), k=31, m=2, effort=2,
                       impl="jax", batch_size=64)
    assert got[0] == want[0]
    assert got[1] == want[1]
