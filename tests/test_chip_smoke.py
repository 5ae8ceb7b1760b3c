"""chip_smoke.py's host-side helpers, on the CPU: the script imports
without a GPU, its dataset is a pure function of the seed, the subset
and filter helpers agree with each other, and its last line has the
exact format."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest


@pytest.fixture(scope="module")
def smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)       # importing opens no device
    return mod


def test_dataset_deterministic_from_seed(smoke):
    a = smoke.make_dataset(7, 20_000, 300)
    assert a == smoke.make_dataset(7, 20_000, 300)
    assert a != smoke.make_dataset(8, 20_000, 300)
    reads, unitigs = a
    assert reads.count(b">") == 300
    assert reads.startswith(b">r0\n") and b"\n>r299\n" in reads
    assert b"N" in reads.replace(b"\n>r", b"")    # some reads carry N
    lens = [len(s) for s in unitigs.split(b"\n")[1::2]]
    assert min(lens) >= smoke.K and max(lens) <= 150


def test_head_records_and_filter_agree(smoke):
    reads, _ = smoke.make_dataset(3, 10_000, 50)
    head = smoke.head_records(reads, 20)
    assert head.count(b">") == 20 and reads.startswith(head)
    assert smoke.records_below(reads, 20) == head
    assert smoke.records_below(reads, 50) == reads
    assert smoke.records_below(b"", 5) == b""


def test_last_line_exact_format(smoke):
    line = smoke.last_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


def test_refuses_to_run_outside_a_checkout(smoke, tmp_path, monkeypatch,
                                           capsys):
    monkeypatch.setattr(smoke, "ROOT", tmp_path)
    assert smoke.main([]) == 2
    out = capsys.readouterr()
    assert '"ok"' not in out.out
