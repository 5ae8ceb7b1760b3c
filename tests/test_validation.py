"""Product hardening: k-range validation, --impl auto resolution and
its report, no silent device fallback, compile-cache placement,
per-process card binding, journal fingerprint completeness, cumulative
progress."""

from __future__ import annotations

import json

import jax
import pytest

import dbgtpu.engine.runner as runner_mod
from dbgtpu import native
from dbgtpu.cli import main as cli_main
from dbgtpu.dist.multihost import bind_local_card
from dbgtpu.index.build import build_graph_from_seqs, validate_k
from dbgtpu.pipeline import (
    _journal_fingerprint,
    run_pipeline,
    run_pipeline_resumable,
)
from dbgtpu.runtime import CHECKOUT, enable_compile_cache

from .synth import make_dataset


def test_k_out_of_range_rejected():
    # k > 32 used to silently overflow the uint64 extremity shifts and
    # produce wrong output (reference cap: kmer=uint64, utils.h:27-28)
    for bad in (0, 1, 33, 34, 64):
        with pytest.raises(ValueError, match="out of range"):
            validate_k(bad)
        with pytest.raises(ValueError, match="out of range"):
            build_graph_from_seqs([b"ACGTACGTACGT" * 8], bad)
    for ok in (2, 4, 21, 31, 32):
        validate_k(ok)


def test_cli_rejects_bad_k(tmp_path, monkeypatch):
    reads_fa, unitigs_fa = make_dataset(
        seed=5, genome_len=3000, k=21, n_reads=10, err_frac=0.0,
    )
    (tmp_path / "r.fa").write_bytes(reads_fa)
    (tmp_path / "u.fa").write_bytes(unitigs_fa)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as ei:
        cli_main(["-r", "r.fa", "-k", "34", "-g", "u.fa"])
    assert ei.value.code == 2


def test_cli_impl_auto_resolves_on_cpu(tmp_path, monkeypatch, capsys):
    """Default invocation (no --impl) must run end-to-end; on the CPU
    test backend auto resolves to the python spec, on an accelerator to
    the device engine — output bytes are identical either way (parity
    suite).  Each run names its engine and JAX platform on stderr, and
    --json-summary records them, so a run that fell back to the CPU
    says so."""
    reads_fa, unitigs_fa = make_dataset(
        seed=7, genome_len=3000, k=21, n_reads=20, err_frac=0.3,
    )
    (tmp_path / "r.fa").write_bytes(reads_fa)
    (tmp_path / "u.fa").write_bytes(unitigs_fa)
    monkeypatch.chdir(tmp_path)
    base = ["-r", "r.fa", "-k", "21", "-g", "u.fa"]
    assert cli_main(base + ["--json-summary", "auto.json"]) == 0
    err = capsys.readouterr().err
    assert "dbgtpu: engine python (JAX platform cpu, cpu, 8 device(s))" \
        in err
    auto = json.loads((tmp_path / "auto.json").read_text())
    assert auto["impl"] == "python"
    assert auto["platform"] is None and auto["device_count"] == 0
    want_p = (tmp_path / "paths").read_bytes()
    assert want_p  # something aligned
    # explicit jax engine produces the same bytes
    (tmp_path / "paths").unlink()
    assert cli_main(base + ["--impl", "jax", "--json-summary", "j.json"]) == 0
    assert "dbgtpu: engine jax (JAX platform cpu" in capsys.readouterr().err
    assert (tmp_path / "paths").read_bytes() == want_p
    dev = json.loads((tmp_path / "j.json").read_text())
    assert dev["impl"] == "jax"
    assert (dev["platform"], dev["device_kind"], dev["device_count"]) == (
        "cpu", "cpu", 8
    )
    assert dev["native_io"] == native.available()
    assert dev["overflow_rows"] == 0


def test_cli_explicit_python_names_no_device(tmp_path, monkeypatch, capsys):
    reads_fa, unitigs_fa = make_dataset(
        seed=8, genome_len=3000, k=21, n_reads=10, err_frac=0.3,
    )
    (tmp_path / "r.fa").write_bytes(reads_fa)
    (tmp_path / "u.fa").write_bytes(unitigs_fa)
    monkeypatch.chdir(tmp_path)
    assert cli_main(["-r", "r.fa", "-k", "21", "-g", "u.fa",
                     "--impl", "python"]) == 0
    assert capsys.readouterr().err.strip().endswith("dbgtpu: engine python")


def test_device_dispatch_failure_propagates(tmp_path, monkeypatch):
    """A failed device dispatch fails the run: there is no host-spec
    recovery that would let a broken device path pass as a slow one."""
    reads_fa, unitigs_fa = make_dataset(
        seed=611, genome_len=4000, k=21, n_reads=40, err_frac=0.5,
    )
    rf, uf = tmp_path / "r.fa", tmp_path / "u.fa"
    rf.write_bytes(reads_fa)
    uf.write_bytes(unitigs_fa)

    def broken(*a, **kw):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(runner_mod, "align_batches_packed_compact", broken)
    with pytest.raises(RuntimeError, match="injected device failure"):
        run_pipeline([str(rf)], str(uf), k=21, impl="jax", batch_size=16)


@pytest.mark.parametrize("env_dir", [None, "/elsewhere/jax-cache"])
def test_compile_cache_placement(monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and the code sets nothing;
    otherwise the cache is <checkout>/.jax_cache."""
    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    try:
        got = enable_compile_cache()
        if env_dir is None:
            assert got == str(CHECKOUT / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
            assert (CHECKOUT / "dbgtpu" / "cli.py").exists()
        else:
            assert got == env_dir
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("launcher_set", [False, True])
def test_bind_local_card(monkeypatch, launcher_set):
    """Process i of a multi-process run sees only local card i, unless
    the launcher chose with CUDA_VISIBLE_DEVICES."""
    before = jax.config.read("jax_cuda_visible_devices")
    if launcher_set:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2")
    else:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    try:
        bind_local_card(3)
        assert jax.config.read("jax_cuda_visible_devices") == (
            before if launcher_set else "3"
        )
    finally:
        jax.config.update("jax_cuda_visible_devices", before)


def test_fingerprint_covers_partial():
    # a run killed without -i and resumed with -i must be rejected —
    # partial changes how records are computed
    base = dict(reads_files=["r.fa"], unitig_file="u.fa", k=21, m=2,
                effort=2, mode="exhaustive", fastq=False,
                correction=False)
    assert (_journal_fingerprint(**base, partial=False)
            != _journal_fingerprint(**base, partial=True))


def test_progress_cumulative_across_segments(tmp_path, capsys):
    """Per-segment align_bulk calls reset done/total; the printer must
    report cumulative counts (a per-segment count made the reads/s
    figure collapse toward zero after the first segment)."""
    reads_fa, unitigs_fa = make_dataset(
        seed=11, genome_len=8000, k=21, n_reads=200, err_frac=0.3,
    )
    rf, uf = tmp_path / "r.fa", tmp_path / "u.fa"
    rf.write_bytes(reads_fa)
    uf.write_bytes(unitigs_fa)
    run_pipeline_resumable(
        [str(rf)], str(uf), k=21,
        paths_file=str(tmp_path / "paths"),
        na_file=str(tmp_path / "na.fa"),
        m=2, effort=2, batch_size=32, segment_records=64,
        progress_every=1,
    )
    err = capsys.readouterr().err
    assert "reads 200/200" in err       # cumulative, not per-segment
