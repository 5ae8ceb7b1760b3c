"""Index persistence roundtrip + CLI --save-index/--load-index."""

from __future__ import annotations

import json

import numpy as np

from dbgtpu.cli import main as cli_main
from dbgtpu.index.build import build_graph_from_seqs
from dbgtpu.index.persist import load_graph, load_index, save_graph, save_index

from . import synth


def _unitig_seqs(unitigs_fa: bytes):
    return [
        unitigs_fa.strip().split(b"\n")[i + 1]
        for i in range(0, unitigs_fa.strip().count(b"\n") + 1, 2)
    ]


def test_roundtrip_v1(tmp_path):
    _, unitigs_fa = synth.make_dataset(
        seed=31, genome_len=8000, k=21, n_reads=1
    )
    g = build_graph_from_seqs(_unitig_seqs(unitigs_fa), 21, dog_mode=True)
    p = str(tmp_path / "g.idx.npz")
    save_graph(g, p)
    g2 = load_graph(p)
    assert g2.k == g.k and g2.n_unitigs == g.n_unitigs
    assert g2.left == g.left and g2.right == g.right
    assert g2.anchors == g.anchors
    assert (g2.pool == g.pool).all()
    assert (g2.offsets == g.offsets).all()
    # the legacy loader reconstructs the vectorized slot table
    np.testing.assert_array_equal(g2.jkeys, g.jkeys)
    np.testing.assert_array_equal(g2.jvals, g.jvals)


def test_roundtrip_v2_device_ready(tmp_path):
    """v2 persists the device layout: the loaded graph carries a
    DeviceIndex identical to a fresh build — no rebuild on load."""
    from dbgtpu.index.device import build_device_index

    _, unitigs_fa = synth.make_dataset(
        seed=33, genome_len=8000, k=21, n_reads=1
    )
    g = build_graph_from_seqs(_unitig_seqs(unitigs_fa), 21)
    di = build_device_index(g)
    g._device_index = di
    p = str(tmp_path / "g2.idx.npz")
    save_index(g, p)
    g2 = load_index(p)
    d2 = getattr(g2, "_device_index", None)
    assert d2 is not None
    np.testing.assert_array_equal(d2.umeta, di.umeta)
    np.testing.assert_array_equal(d2.pool_rows, di.pool_rows)
    np.testing.assert_array_equal(d2.scan_tbl.keys, di.scan_tbl.keys)
    np.testing.assert_array_equal(d2.scan_tbl.vals, di.scan_tbl.vals)
    assert d2.scan_tbl.seed == di.scan_tbl.seed
    np.testing.assert_array_equal(d2.probe_tbl.rows, di.probe_tbl.rows)
    assert d2.probe_tbl.window == di.probe_tbl.window
    assert d2.n_chunks == di.n_chunks
    assert d2.halo_bases == di.halo_bases
    np.testing.assert_array_equal(g2.jkeys, g.jkeys)
    np.testing.assert_array_equal(g2.jvals, g.jvals)
    # spec-path dicts lazily materialize identically
    assert g2.left == g.left and g2.right == g.right


def test_cli_save_load_and_json(tmp_path, monkeypatch):
    reads_fa, unitigs_fa = synth.make_dataset(
        seed=32, genome_len=8000, k=21, n_reads=50
    )
    (tmp_path / "r.fa").write_bytes(reads_fa)
    (tmp_path / "u.fa").write_bytes(unitigs_fa)
    monkeypatch.chdir(tmp_path)
    cli_main([
        "-r", "r.fa", "-k", "21", "-g", "u.fa",
        "--save-index", "g.idx.npz", "--json-summary", "run.json",
    ])
    first = (tmp_path / "paths").read_bytes()
    s = json.loads((tmp_path / "run.json").read_text())
    assert s["reads"] == s["aligned"] + s["not_aligned"] + s["no_overlap"]
    # rerun from the persisted index: identical output
    cli_main(["-r", "r.fa", "--load-index", "g.idx.npz"])
    assert (tmp_path / "paths").read_bytes() == first


def test_persist_renumbered_index_roundtrip(tmp_path, monkeypatch):
    """A saved renumbered index carries its id map (d_id_inv); a
    --load-index start emits file-order ids, byte-identical to a
    file-order build."""
    from dbgtpu.index.persist import load_index, save_index
    from dbgtpu.pipeline import run_pipeline

    from .synth import make_dataset

    reads_fa, unitigs_fa = make_dataset(
        seed=911, genome_len=12000, k=21, n_reads=200, err_frac=0.5,
    )
    rf = tmp_path / "r.fa"
    uf = tmp_path / "u.fa"
    rf.write_bytes(reads_fa)
    uf.write_bytes(unitigs_fa)
    want_p, want_n, _ = run_pipeline(
        [str(rf)], str(uf), k=21, m=2, effort=2, impl="jax",
        batch_size=64,
    )
    monkeypatch.setenv("DBGTPU_RENUMBER", "1")
    from dbgtpu.index.build import build_graph

    g = build_graph(str(uf), 21)
    idx = str(tmp_path / "ix.npz")
    from dbgtpu.index.device import build_device_index

    di = build_device_index(g)
    assert di.id_inv is not None
    save_index(g, idx, di)
    monkeypatch.delenv("DBGTPU_RENUMBER")
    g2 = load_index(idx)
    assert g2._device_index.id_inv is not None
    got_p, got_n, _ = run_pipeline(
        [str(rf)], str(uf), k=21, m=2, effort=2, impl="jax",
        batch_size=64, graph=g2,
    )
    assert got_p == want_p
    assert got_n == want_n


def test_roundtrip_v2_mphf_layout(tmp_path):
    """--save-index under --index-layout mphf persists the MPHF
    junction artifacts; a load + mphf run is device-ready with no
    rebuild, and maps byte-identically."""
    from dbgtpu.index.device import build_device_index
    from dbgtpu.pipeline import run_pipeline

    reads_fa, unitigs_fa = synth.make_dataset(
        seed=35, genome_len=8000, k=21, n_reads=120, err_frac=0.3,
    )
    rf, uf = tmp_path / "r.fa", tmp_path / "u.fa"
    rf.write_bytes(reads_fa)
    uf.write_bytes(unitigs_fa)
    g = build_graph_from_seqs(_unitig_seqs(unitigs_fa), 21)
    di = build_device_index(g, layout="mphf")
    g._device_index_mphf = di
    p = str(tmp_path / "gm.idx.npz")
    save_index(g, p, layout="mphf")
    g2 = load_index(p)
    d2 = getattr(g2, "_device_index_mphf", None)
    assert d2 is not None and d2.mphf_junction is not None
    np.testing.assert_array_equal(
        d2.mphf_junction.jrows, di.mphf_junction.jrows
    )
    m1, m2 = di.mphf_junction.mphf, d2.mphf_junction.mphf
    np.testing.assert_array_equal(m2.words, m1.words)
    np.testing.assert_array_equal(m2.samples, m1.samples)
    assert (m2.final_tbl is None) == (m1.final_tbl is None)
    # the loaded index must NOT rebuild when used for an mphf run, and
    # must produce the same bytes as a python-spec run
    want = run_pipeline([str(rf)], str(uf), k=21, impl="python")
    import dbgtpu.engine.runner as runner_mod
    calls = {"n": 0}
    orig = runner_mod.build_device_index
    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)
    runner_mod.build_device_index = counting
    try:
        got = run_pipeline(
            [str(rf)], str(uf), k=21, impl="jax", graph=g2,
            index_layout="mphf", batch_size=64,
        )
    finally:
        runner_mod.build_device_index = orig
    assert calls["n"] == 0          # device-ready: no rebuild
    assert got[0] == want[0] and got[1] == want[1]
