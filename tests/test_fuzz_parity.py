"""Bulk randomized parity fuzz.

Opt-in: set DBGTPU_FUZZ=<n_cases> (e.g. 300 for a night run; any >0
enables).  Each case draws a random configuration — k across the
2..32 range, m, effort, N rate, unitig-length extremes (down to k+1,
which stresses the tiny-stride walk and the adaptive-pmax redispatch
net), palindromic (k-1)-mer insertions, reads of length exactly k-1 /
k / k+1 (the reference drops len<=k FASTA records) — and checks two
invariants per case:

  1. python spec == compiled reference, byte-for-byte (paths AND
     notAligned.fa), greedy and correction modes;
  2. device engine (CPU backend here) == python spec, byte-for-byte,
     for greedy / correction / exhaustive / dog modes.

Divergences are reported with the full reproduction recipe (seed +
drawn config)."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

from dbgtpu.pipeline import run_pipeline

from . import oracle, synth

N_CASES = int(os.environ.get("DBGTPU_FUZZ", "0"))

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(
        N_CASES <= 0,
        reason="opt-in fuzz: set DBGTPU_FUZZ=<n_cases>",
    ),
]


def _palindrome(rng, n: int) -> bytes:
    """A sequence of even length n equal to its reverse complement."""
    comp = dict(zip(b"ACGT", b"TGCA"))
    half = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), n // 2))
    return half + bytes(comp[c] for c in reversed(half))


def _make_case(seed: int):
    rng = np.random.default_rng(seed)
    k = int(rng.choice([4, 5, 11, 15, 21, 30, 31, 32]))
    m = int(rng.choice([0, 1, 2, 3]))
    effort = int(rng.choice([1, 2, 4]))
    n_frac = float(rng.choice([0.0, 0.0, 0.05, 0.3]))
    glen = int(rng.integers(1500, 12000))
    read_len = int(rng.choice([100, 100, 60, 150]))
    if read_len <= k:
        read_len = k + 10
    # unitig-length extremes: sometimes barely longer than k
    if rng.random() < 0.3:
        min_u, max_u = k + 1, k + 1 + int(rng.integers(1, 8))
    else:
        min_u, max_u = 40, int(rng.integers(60, 200))
    genome = synth.make_genome(rng, glen)
    if (k - 1) % 2 == 0 and rng.random() < 0.5:
        # splice palindromic (k-1)-mers into the genome so unitig
        # extremities can be their own reverse complement
        p = _palindrome(rng, k - 1)
        pos = int(rng.integers(0, max(1, glen - len(p))))
        genome = genome[:pos] + p + genome[pos + len(p):]
    unitigs = synth.chop_unitigs(genome, k, rng, min_u, max_u)
    unitigs = synth.add_decoys(unitigs, k, rng, 0.1)
    unitigs = synth.orient_shuffle(unitigs, rng)
    reads = synth.sample_reads(
        genome, rng, int(rng.integers(40, 120)), read_len,
        err_frac=float(rng.choice([0.0, 0.3, 0.7])),
        max_errs=m + 1, n_frac=n_frac,
    )
    # boundary-length reads: exactly k-1 / k (reference drops FASTA
    # records with len <= k) and k+1 (kept)
    for dl in (-1, 0, 1):
        p0 = int(rng.integers(0, max(1, glen - (k + dl))))
        reads.append(genome[p0 : p0 + k + dl])
    correction = bool(rng.random() < 0.25)
    return dict(k=k, m=m, effort=effort, correction=correction,
                reads_fa=synth.to_fasta(reads),
                unitigs_fa=synth.to_fasta(unitigs, prefix=b"u"))


def _run(tmp, case, impl, mode="greedy"):
    rf = tmp / f"r{impl}{mode}.fa"
    uf = tmp / f"u{impl}{mode}.fa"
    rf.write_bytes(case["reads_fa"])
    uf.write_bytes(case["unitigs_fa"])
    return run_pipeline(
        [str(rf)], str(uf), k=case["k"], m=case["m"],
        effort=case["effort"], correction=case["correction"],
        impl=impl, mode=mode, batch_size=64,
    )


@pytest.mark.skipif(not oracle.reference_available(),
                    reason="reference not mounted")
def test_fuzz_spec_vs_reference_and_engine(tmp_path):
    base = int(os.environ.get("DBGTPU_FUZZ_SEED", "900000"))
    failures = []
    for case_i in range(N_CASES):
        seed = base + case_i
        case = _make_case(seed)
        label = (f"seed={seed} k={case['k']} m={case['m']} "
                 f"e={case['effort']} corr={case['correction']}")
        # night runs watch the log: one line per case, flushed
        print(f"[fuzz] case {case_i + 1}/{N_CASES} {label} "
              f"({len(failures)} failures)",
              file=sys.stderr, flush=True)
        if case_i % 8 == 7:
            # every case compiles fresh shapes; XLA's CPU backend
            # segfaults once enough executables accumulate in one
            # process (see conftest._clear_jax_caches_between_modules)
            # — bound the accumulation inside this single long test
            import jax

            jax.clear_caches()
        try:
            flags = ["-c"] if case["correction"] else []
            ref_p, ref_na, _ = oracle.run_reference(
                case["reads_fa"], case["unitigs_fa"], case["k"],
                case["m"], case["effort"], extra_flags=flags,
            )
            spec = _run(tmp_path, case, "python")
            if spec[0] != ref_p or spec[1] != ref_na:
                failures.append(f"SPEC!=REF {label}")
                continue
            eng = _run(tmp_path, case, "jax")
            if eng[0] != spec[0] or eng[1] != spec[1]:
                failures.append(f"ENGINE!=SPEC {label}")
                continue
            # engine-vs-spec on the other device modes (reference -b
            # writes empty files by design; -G scan is buggy past pos 0)
            for mode in ("exhaustive", "anchors"):
                sp = _run(tmp_path, case, "python", mode)
                en = _run(tmp_path, case, "jax", mode)
                if en[0] != sp[0] or en[1] != sp[1]:
                    failures.append(f"ENGINE!=SPEC mode={mode} {label}")
                    break
        except Exception as e:  # noqa: BLE001 - report with recipe
            failures.append(f"ERROR {type(e).__name__}: {e} @ {label}")
    assert not failures, "\n".join(failures[:20]) + (
        f"\n... {len(failures)} total of {N_CASES}"
        if len(failures) > 20 else ""
    )
