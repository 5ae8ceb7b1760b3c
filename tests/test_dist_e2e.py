"""End-to-end distributed tests (SURVEY.md §2.3):

  - CLI `--mesh 8` sharded run produces bytes identical to the
    single-device run (shard_map path incl. on-device pack_paths),
  - a REAL two-process run (separate interpreters, record-range input
    sharding, per-process output shards) merged with merge_shards is
    byte-identical to the single-process run.

Replaces: the reference's thread pool (aligner.cpp:550-597), whose
parity target is its deterministic -t 1 output.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from .synth import make_dataset

pytestmark = pytest.mark.slow  # heavy parity/scale suite (full gate)

_ENV = dict(
    os.environ,
    JAX_PLATFORMS="cpu",
    XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip(),
)


def _write_dataset(tmp_path, **kw):
    reads_fa, unitigs_fa = make_dataset(**kw)
    rf = tmp_path / "reads.fa"
    uf = tmp_path / "unitig.fa"
    rf.write_bytes(reads_fa)
    uf.write_bytes(unitigs_fa)
    return str(rf), str(uf)


def _cli(tmp_path, tag, rf, uf, *extra):
    paths = str(tmp_path / f"paths.{tag}")
    na = str(tmp_path / f"na.{tag}")
    argv = [
        sys.executable, "-m", "dbgtpu",
        "-r", rf, "-k", "21", "-g", uf, "-m", "2",
        "-f", paths, "-a", na, "--impl", "jax",
        "--batch-size", "256", *extra,
    ]
    subprocess.run(
        argv, check=True, env=_ENV,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True,
    )
    return paths, na


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_e2e")
    rf, uf = _write_dataset(
        tmp, seed=411, genome_len=20000, k=21, n_reads=603,
        err_frac=0.5, n_frac=0.02,
    )
    return tmp, rf, uf


def test_cli_mesh_matches_single(dataset):
    tmp, rf, uf = dataset
    p1, n1 = _cli(tmp, "single", rf, uf)
    p8, n8 = _cli(tmp, "mesh", rf, uf, "--mesh", "8")
    assert open(p8, "rb").read() == open(p1, "rb").read()
    assert open(n8, "rb").read() == open(n1, "rb").read()
    assert os.path.getsize(p1) > 0


def test_cli_sharded_index_matches_single(dataset):
    """--shard-index: junction/probe tables bucket-range sharded over
    the mesh, lookups via all_gather + reduce-scatter
    (core._sharded_rows) — byte parity with the replicated run
    (SURVEY §2.3 index-parallelism row, the >HBM-graph mode)."""
    tmp, rf, uf = dataset
    p1, n1 = _cli(tmp, "single2", rf, uf)
    ps, ns = _cli(tmp, "shardix", rf, uf, "--mesh", "8", "--shard-index")
    assert open(ps, "rb").read() == open(p1, "rb").read()
    assert open(ns, "rb").read() == open(n1, "rb").read()


def test_scaling_efficiency_harness():
    """scripts/scaling_eff.py runs the sharded packed loop at 1 and N
    virtual devices and emits the efficiency number (BASELINE.md's
    >=0.8-at-N-hosts target gets its harness here; on virtual CPU
    devices the number characterizes the harness, not silicon)."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "scaling_eff",
        pathlib.Path(__file__).parent.parent / "scripts" / "scaling_eff.py",
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(n_devices=4, n_reads=2048, genome_len=60_000)
    assert out["n_devices"] == 4
    assert out["reads_per_s_1"] > 0 and out["reads_per_s_n"] > 0
    assert 0 < out["scaling_efficiency"] < 4


def test_two_process_coordinator_jax_distributed(dataset, tmp_path):
    """SURVEY §4 item 3: a REAL jax.distributed run
    — two localhost processes, --coordinator, CPU devices.  Exercises
    init_distributed (global runtime bring-up), the cross-process
    stats reduction (global_stats_sum over the global mesh), and the
    merged-output byte parity."""
    import socket

    from dbgtpu.dist.multihost import merge_shards

    tmp, rf, uf = dataset
    p1, n1 = _cli(tmp, "coordref", rf, uf)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    paths = str(tmp_path / "paths")
    na = str(tmp_path / "na")
    procs = [
        subprocess.Popen(
            [
                sys.executable, "-m", "dbgtpu",
                "-r", rf, "-k", "21", "-g", uf, "-m", "2",
                "-f", paths, "-a", na, "--impl", "jax",
                "--batch-size", "256",
                "--coordinator", f"127.0.0.1:{port}",
                "--num-processes", "2", "--process-id", str(pid),
            ],
            env=_ENV,
            cwd=os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))
            ),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err.decode()
        outs.append(out.decode())
    # process 0 prints the GLOBAL stats block (counters psum'd across
    # processes); process 1 prints none
    n_total = open(rf, "rb").read().count(b">")
    assert f"Reads : {n_total}\n" in outs[0]
    assert "Reads :" not in outs[1]
    merge_shards(paths, 2)
    merge_shards(na, 2)
    assert open(paths, "rb").read() == open(p1, "rb").read()
    assert open(na, "rb").read() == open(n1, "rb").read()


def test_two_process_merge_matches_single(dataset, tmp_path):
    from dbgtpu.dist.multihost import merge_shards, shard_path

    tmp, rf, uf = dataset
    p1, n1 = _cli(tmp, "ref", rf, uf)

    paths = str(tmp_path / "paths")
    na = str(tmp_path / "na")
    procs = [
        subprocess.Popen(
            [
                sys.executable, "-m", "dbgtpu",
                "-r", rf, "-k", "21", "-g", uf, "-m", "2",
                "-f", paths, "-a", na, "--impl", "jax",
                "--batch-size", "256",
                "--num-processes", "2", "--process-id", str(pid),
            ],
            env=_ENV,
            cwd=os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))
            ),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        )
        for pid in range(2)
    ]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err.decode()
    for pid in range(2):
        assert os.path.exists(shard_path(paths, pid))
    merge_shards(paths, 2)
    merge_shards(na, 2)
    assert open(paths, "rb").read() == open(p1, "rb").read()
    assert open(na, "rb").read() == open(n1, "rb").read()
