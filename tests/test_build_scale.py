"""Index-build scalability.

The reference indexes 30k unitigs in <1 s (aligner.cpp:537-547) with a
shared-memory pthread build; dbgtpu's vectorized numpy build must stay
within the same order at 30k and scale to million-unitig graphs:

  - 200k unitigs: always-on test, full device index (window-4 probe
    table, ~2 GB rows) well under the wall bound — the bound is loose
    because the 2-vCPU CI container's first-touch page faults add high
    variance to multi-GB allocations,
  - 200k with a reduced byte cap: the build must auto-downgrade to the
    window-3 probe table (succ2-free keyset, [nb, 24] rows) and build
    much faster,
  - 1M unitigs (DBGTPU_SCALE_TESTS=1): the window-3 table fits the
    default 2 GB cap (the large-graph mid-tier).
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest

import dbgtpu.index.device as device_mod
from dbgtpu.index.build import build_graph_from_seqs
from dbgtpu.index.device import build_device_index, hbm_report

from . import synth

pytestmark = pytest.mark.slow  # heavy parity/scale suite (full gate)


def _unitigs(n_target: int, seed: int):
    # ~65 bases of unique genome per unitig at 40-150 bp, k=31
    rng = np.random.default_rng(seed)
    genome = synth.make_genome(rng, int(n_target * 65))
    return synth.chop_unitigs(genome, 31, rng, 40, 150)


def test_build_200k_unitigs_fast():
    unitigs = _unitigs(200_000, 17)
    t0 = time.monotonic()
    g = build_graph_from_seqs(unitigs, 31)
    di = build_device_index(g)
    dt = time.monotonic() - t0
    assert len(unitigs) > 150_000
    assert dt < 150, f"200k-unitig build took {dt:.1f}s"
    assert di.probe_tbl is not None  # within the bytes cap at this size
    rep = hbm_report(di)
    assert rep["total"] > 0


def test_build_200k_window3_downgrade(monkeypatch):
    """DBGTPU_PROBE_WINDOW=4 opts into the wider closure, but the byte
    cap still downgrades it to window 3 when the w4 keyset won't fit."""
    unitigs = _unitigs(200_000, 19)
    g = build_graph_from_seqs(unitigs, 31)
    monkeypatch.setenv("DBGTPU_PROBE_WINDOW", "4")
    monkeypatch.setattr(
        device_mod, "PROBE_TABLE_MAX_BYTES", 256 << 20
    )
    t0 = time.monotonic()
    di = build_device_index(g)
    dt = time.monotonic() - t0
    assert di.probe_tbl is not None
    assert di.probe_tbl.window == 3
    assert di.probe_tbl.rows.shape[1] == 3 * device_mod.PT_SLOTS
    assert di.probe_tbl.rows.nbytes <= 256 << 20
    assert dt < 60, f"window-3 200k build took {dt:.1f}s"


@pytest.mark.skipif(
    not os.environ.get("DBGTPU_SCALE_TESTS"),
    reason="set DBGTPU_SCALE_TESTS=1 (adds ~2 min)",
)
def test_build_1m_unitigs_window3():
    unitigs = _unitigs(1_000_000, 18)
    t0 = time.monotonic()
    g = build_graph_from_seqs(unitigs, 31)
    di = build_device_index(g)
    dt = time.monotonic() - t0
    assert len(unitigs) > 900_000
    # the window-4 closure would blow the 2 GB cap at this scale; the
    # build must pick the window-3 keyset, which fits
    assert di.probe_tbl is not None
    assert di.probe_tbl.window == 3
    assert dt < 240, f"1M-unitig build took {dt:.1f}s"
