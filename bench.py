"""dbgtpu benchmark: reads mapped/sec/chip at k=31, m=2.

Workload mirrors the measured CPU baseline in SURVEY.md §6 (reference
bgreat, 1 thread, 2-vCPU container: ~66k reads/s): 100 bp reads sampled
from a 2 Mbp synthetic genome, half carrying 1-2 errors, unitigs 40-150
bp (~30k unitigs), k=31, m=2, effort=2.

Needs an accelerator: with only a CPU backend it exits without a
result.

Reports (human lines on stderr, one JSON line on stdout):
  - cold-start split: XLA trace/lower vs backend compile vs first
    execution,
  - steady-state device mapping loop (headline metric),
  - end-to-end file->paths-bytes runs: cold (index build + H2D
    included) and warm (index device-resident — the persistent-service
    steady state), with the DBGTPU_TIMING phase breakdown printed.

JSON: {"metric": "reads_mapped_per_sec_chip", "value": N,
       "unit": "reads/s", "vs_baseline": N/66000, "device": {platform,
       device_kind, device_count}, ...e2e fields}
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_READS_PER_S = 66_000.0  # SURVEY.md §6, 1-thread reference

SEED = 20260817
GENOME_LEN = 2_000_000
K = 31
M = 2
EFFORT = 2
READ_LEN = 100
# 32k-read batches: the size the CLI runner uses by default
BATCH = int(os.environ.get("DBGTPU_BENCH_BATCH", 32768))
N_BATCHES = int(os.environ.get("DBGTPU_BENCH_NBATCHES", 4))
TIMED_REPS = int(os.environ.get("DBGTPU_BENCH_REPS", 3))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build_workload():
    """(unitig_seqs list[bytes], reads [N, READ_LEN] uint8 codes)."""
    from tests import synth
    from dbgtpu.seq import encode

    rng = np.random.default_rng(SEED)
    genome = synth.make_genome(rng, GENOME_LEN)
    unitigs = synth.chop_unitigs(genome, K, rng, 40, 150)
    unitigs = synth.orient_shuffle(unitigs, rng)
    reads = synth.sample_reads(
        genome, rng, BATCH * N_BATCHES, READ_LEN, err_frac=0.5
    )
    return unitigs, np.stack([encode(r) for r in reads])


def main() -> int:
    import jax
    import jax.numpy as jnp

    from dbgtpu.runtime import device_facts, enable_compile_cache

    enable_compile_cache()
    os.environ.setdefault("DBGTPU_TIMING", "1")

    facts = device_facts()
    if facts["platform"] == "cpu":
        log("bench.py measures an accelerator; JAX found only the CPU")
        return 1
    log(f"device: {facts}")
    dev = jax.devices()[0]

    t0 = time.monotonic()
    unitigs, codes_all = build_workload()
    n_reads = codes_all.shape[0]
    log(f"workload: {len(unitigs)} unitigs, {n_reads} reads "
        f"({time.monotonic() - t0:.1f}s)")

    from dbgtpu.index.build import build_graph_from_seqs
    from dbgtpu.index.device import build_device_index
    from dbgtpu.engine.core import align_batch_packed, index_to_device

    t0 = time.monotonic()
    g = build_graph_from_seqs(unitigs, K)
    di = build_device_index(g)
    g._device_index = di
    log(f"index build: {time.monotonic() - t0:.1f}s "
        f"({len(unitigs)} unitigs)")

    t0 = time.monotonic()
    ix = index_to_device(di)   # memoized: the e2e legs reuse this H2D
    jax.block_until_ready(ix)
    log(f"index H2D: {time.monotonic() - t0:.1f}s "
        f"({sum(np.asarray(a).nbytes for a in ix) >> 20} MB)")

    # device-resident batches in the SAME packed shape the pipeline
    # runner produces, so every leg shares one compiled program
    from dbgtpu.engine.runner import (
        PMAX_CAP, PMAX_INIT, _bucket_len, _pmax_for, _quantize_pmax,
        pack_words_batch,
    )

    L = _bucket_len(READ_LEN, K)
    # the production runner's adaptive steady-state width (measured
    # survey paths are <= 6 slots, so the quantized init of 8 holds);
    # the static bound shipped 2.7x the bytes for identical output
    PMAX = min(_pmax_for(di, L), PMAX_CAP, _quantize_pmax(PMAX_INIT))
    pad = np.zeros((BATCH, L - codes_all.shape[1]), np.uint8)
    nm = np.zeros((BATCH, L), bool)
    lens_np = np.full(BATCH, READ_LEN, np.int16)
    batches = []
    for i in range(N_BATCHES):
        words, nmbits = pack_words_batch(
            np.concatenate(
                [codes_all[i * BATCH : (i + 1) * BATCH], pad], axis=1
            ), nm,
        )
        # N-free batches drop the mask payload, as the runner does
        nmbits = np.zeros((BATCH, 0), np.uint32)
        batches.append((
            jax.device_put(words, dev), jax.device_put(nmbits, dev),
        ))
    lens_d = jax.device_put(lens_np, dev)
    jax.block_until_ready((batches, lens_d))

    import functools

    @functools.partial(jax.jit, static_argnames=("L", "pmax"))
    def step_jit(ix, words, nmbits, lens, *, L, pmax):
        # ONE dispatch per batch: the packed mapping program inlined
        # with its on-device summary (the former eager reductions added
        # several dispatch round-trips per batch to the measurement)
        fused = align_batch_packed.__wrapped__(
            ix, words, nmbits, lens,
            mode="greedy", k=K, m=M, effort=EFFORT, L=L, pmax=pmax,
        )
        status = fused[:, 0].astype(jnp.int32)
        aligned = jnp.sum((status == 1) | (status == 2))
        chk = jnp.sum(fused.astype(jnp.int32))
        return aligned.astype(jnp.int32), chk.astype(jnp.int32)

    def step(words, nmbits):
        return step_jit(ix, words, nmbits, lens_d, L=L, pmax=PMAX)

    @functools.partial(jax.jit, static_argnames=("L", "pmax"))
    def step_all_jit(ix, words_s, nmbits_s, lens, *, L, pmax):
        # whole workload in ONE dispatch: lax.map over the stacked
        # batch axis with the same 32k-shaped body, so per-call
        # dispatch and fetch costs are paid once per rep.
        def body(wb):
            w, b = wb
            fused = align_batch_packed.__wrapped__(
                ix, w, b, lens,
                mode="greedy", k=K, m=M, effort=EFFORT, L=L, pmax=pmax,
            )
            status = fused[:, 0].astype(jnp.int32)
            aligned = jnp.sum((status == 1) | (status == 2))
            chk = jnp.sum(fused.astype(jnp.int32))
            return aligned.astype(jnp.int32), chk.astype(jnp.int32)

        a, c = jax.lax.map(body, (words_s, nmbits_s))
        return jnp.sum(a), jnp.sum(c) ^ 0

    @functools.partial(jax.jit, static_argnames=("L", "pmax", "reps"))
    def step_reps_jit(ix, words_s, nmbits_s, lens, *, L, pmax, reps):
        # the compute-floor probe: run the whole workload `reps` times
        # inside ONE dispatch so per-call latency amortizes to ~nothing;
        # the device-only
        # step time is then (T(reps=R) - T(reps=1)) / (R-1) / n_batches.
        # The batch stack is rolled by the rep index so XLA's
        # while-loop-invariant code motion cannot hoist the (otherwise
        # identical) body out of the loop.
        def body(i, carry):
            a, c = carry
            ws = jnp.roll(words_s, i, axis=0)
            ns = jnp.roll(nmbits_s, i, axis=0)
            def one(wb):
                w, b = wb
                fused = align_batch_packed.__wrapped__(
                    ix, w, b, lens,
                    mode="greedy", k=K, m=M, effort=EFFORT, L=L,
                    pmax=pmax,
                )
                status = fused[:, 0].astype(jnp.int32)
                al = jnp.sum((status == 1) | (status == 2))
                chk = jnp.sum(fused.astype(jnp.int32))
                return al.astype(jnp.int32), chk.astype(jnp.int32)
            a2, c2 = jax.lax.map(one, (ws, ns))
            return a + jnp.sum(a2), c ^ jnp.sum(c2)
        return jax.lax.fori_loop(
            0, reps, body, (jnp.int32(0), jnp.int32(0))
        )

    # ---- cold-start split: XLA trace/lower vs backend compile
    # (persistent-cache-served on later runs) vs first execution ----
    w0, b0 = batches[0]
    t0 = time.monotonic()
    lowered = align_batch_packed.lower(
        ix, w0, b0, lens_d,
        mode="greedy", k=K, m=M, effort=EFFORT, L=L, pmax=PMAX,
    )
    t1 = time.monotonic()
    compiled = lowered.compile()
    t2 = time.monotonic()
    np.asarray(compiled(ix, w0, b0, lens_d))
    t3 = time.monotonic()
    log(f"cold start: trace/lower {t1 - t0:.1f}s, XLA compile "
        f"{t2 - t1:.1f}s, first exec {t3 - t2:.1f}s")

    # every timed rep ends with np.asarray of the summary scalars (a
    # host copy is a completion fence).  step()/step_jit warm the
    # per-batch program too (the e2e runner path uses those shapes).
    a, c = step(w0, b0)
    a, c = np.asarray(a), np.asarray(c)

    words_s = jnp.stack([w for w, _ in batches])
    nmbits_s = jnp.stack([b for _, b in batches])
    jax.block_until_ready((words_s, nmbits_s))
    # warm the fused whole-workload program
    a0, c0 = step_all_jit(ix, words_s, nmbits_s, lens_d, L=L, pmax=PMAX)
    np.asarray(a0)

    rates = []
    aligned_total = 0
    for rep in range(TIMED_REPS):
        t0 = time.monotonic()
        a0, c0 = step_all_jit(
            ix, words_s, nmbits_s, lens_d, L=L, pmax=PMAX,
        )
        flat = np.asarray(jnp.stack([a0, c0]))
        dt = time.monotonic() - t0
        rps = n_reads / dt
        aligned_total = int(flat[0])
        log(f"rep {rep}: {dt * 1e3:.0f} ms for {n_reads} reads "
            f"-> {rps:,.0f} reads/s ({aligned_total} aligned)")
        rates.append(rps)
    best = sorted(rates)[len(rates) // 2]  # median, robust + honest

    # ---- compute floor: device-only step time with per-call costs
    # differenced away (two in-dispatch repeat loops) ----
    R = int(os.environ.get("DBGTPU_BENCH_FLOOR_REPS", 9))
    times = {}
    for reps in (1, R):
        a0, c0 = step_reps_jit(
            ix, words_s, nmbits_s, lens_d, L=L, pmax=PMAX, reps=reps,
        )
        np.asarray(jnp.stack([a0, c0]))      # warm/compile
        t0 = time.monotonic()
        a0, c0 = step_reps_jit(
            ix, words_s, nmbits_s, lens_d, L=L, pmax=PMAX, reps=reps,
        )
        np.asarray(jnp.stack([a0, c0]))
        times[reps] = time.monotonic() - t0
    device_step_ms = (
        (times[R] - times[1]) / (R - 1) / N_BATCHES * 1e3
    )
    compute_rps = BATCH / (device_step_ms / 1e3)
    log(f"compute floor: device step {device_step_ms:.1f} ms per "
        f"{BATCH}-read batch -> {compute_rps:,.0f} reads/s "
        f"device-only (loop timings: reps=1 {times[1]*1e3:.0f} ms, "
        f"reps={R} {times[R]*1e3:.0f} ms)")

    # ---- per-mode device rates: the -b exhaustive
    # DFS and -G dog/anchor engines are production modes; one steady
    # in-dispatch loop figure each, same methodology as the headline.
    # 2 of the 4 batches keep this leg short; rates are per-read. ----
    mode_rates = {}
    words2 = words_s[:2]
    nmbits2 = nmbits_s[:2]

    @functools.partial(jax.jit,
                       static_argnames=("mode", "L", "pmax", "reps",
                                        "al_meta"))
    def mode_reps_jit(ix, words_s, nmbits_s, lens, *, mode, L, pmax,
                      reps, al_meta=None):
        def body(i, carry):
            ws = jnp.roll(words_s, i, axis=0)
            ns = jnp.roll(nmbits_s, i, axis=0)

            def one(wb):
                w, b = wb
                fused = align_batch_packed.__wrapped__(
                    ix, w, b, lens, mode=mode, k=K, m=M,
                    effort=EFFORT, L=L, pmax=pmax, al_meta=al_meta,
                )
                return jnp.sum(fused.astype(jnp.int32))
            return carry ^ jnp.sum(jax.lax.map(one, (ws, ns)))
        return jax.lax.fori_loop(0, reps, body, jnp.int32(0))

    def mode_rate(label, mode, mix, mL, mpmax, al_meta=None):
        times = {}
        Rm = 5
        for reps in (1, Rm):
            np.asarray(mode_reps_jit(
                mix, words2, nmbits2, lens_d, mode=mode, L=mL,
                pmax=mpmax, reps=reps, al_meta=al_meta,
            ))
            t0 = time.monotonic()
            np.asarray(mode_reps_jit(
                mix, words2, nmbits2, lens_d, mode=mode, L=mL,
                pmax=mpmax, reps=reps, al_meta=al_meta,
            ))
            times[reps] = time.monotonic() - t0
        ms = (times[Rm] - times[1]) / (Rm - 1) / 2 * 1e3
        rps = BATCH / (ms / 1e3)
        log(f"device mode {label}: {ms:.1f} ms/32k batch -> "
            f"{rps:,.0f} reads/s device-only")
        mode_rates[label] = rps

    mode_rate("exhaustive", "exhaustive", ix, L, PMAX)
    t0 = time.monotonic()
    g_dog = build_graph_from_seqs(unitigs, K, dog_mode=True)
    di_dog = build_device_index(g_dog, layout="scan")
    ix_dog = index_to_device(di_dog)
    jax.block_until_ready(ix_dog)
    log(f"dog index build+H2D: {time.monotonic() - t0:.1f}s")
    from dbgtpu.engine.core import al_meta_of

    mode_rate("anchors", "anchors", ix_dog, L, PMAX,
              al_meta=al_meta_of(di_dog))
    del ix_dog, di_dog, g_dog

    frac = aligned_total / n_reads
    log(f"aligned fraction: {frac:.1%} of all reads (the reference "
        f"aligns 99.96% of overlap-bearing reads on its own workload; "
        f"dbgtpu matches the reference read-for-read — the fraction "
        f"here reflects this workload's error injection, not a "
        f"sensitivity gap)")

    # ---- end-to-end: reads file on disk -> paths bytes (native parse,
    # packed device pipeline, native format), the honest comparison
    # against the reference's 66k reads/s wall number.  Cold = fresh
    # graph (index build + H2D inside); warm = device-resident index
    # (the persistent-service steady state). ----
    e2e = {}
    import tempfile

    from dbgtpu.pipeline import run_pipeline

    with tempfile.TemporaryDirectory() as td:
        uf = os.path.join(td, "unitig.fa")
        rf = os.path.join(td, "reads.fa")
        with open(uf, "wb") as f:
            for i, u in enumerate(unitigs):
                s = u if isinstance(u, bytes) else bytes(u)
                f.write(b">" + str(i).encode() + b"\n" + s + b"\n")
        chars = np.frombuffer(b"ACGT", np.uint8)
        with open(rf, "wb") as f:
            hdrs = [f">r{i}\n".encode() for i in range(n_reads)]
            rows = chars[codes_all]
            f.write(b"".join(
                h + r.tobytes() + b"\n" for h, r in zip(hdrs, rows)
            ))
        # e2e batches are 32k: four in-flight batches pipeline the
        # host pack / H2D / compute / D2H legs better than two big
        # ones (the steady-state loop above stays at BATCH, where
        # per-dispatch overhead is what matters)
        warm_info = []
        for label, graph in (
            ("cold", None),
            ("warm", g), ("warm", g), ("warm", g),
        ):
            t0 = time.monotonic()
            paths, na, st = run_pipeline(
                [rf], uf, k=K, m=M, effort=EFFORT, impl="jax",
                batch_size=32768, graph=graph,
            )
            dt = time.monotonic() - t0
            rate = n_reads / dt
            if label == "warm":
                warm_info.append(
                    (rate, dt, st.payload_h2d_bytes,
                     st.payload_d2h_bytes)
                )
            else:
                e2e[label] = rate
            log(f"end-to-end ({label}): {dt:.1f}s for {n_reads} "
                f"reads -> {rate:,.0f} reads/s "
                f"({len(paths)} path bytes, {st.aligned} aligned, "
                f"payload H2D {st.payload_h2d_bytes >> 20} MB / "
                f"D2H {st.payload_d2h_bytes >> 20} MB)")
        # median of 3 warm runs
        warm_info.sort()
        rate_m, _, ph2d, pd2h = warm_info[len(warm_info) // 2]
        e2e["warm"] = rate_m
        e2e["payload_h2d"] = ph2d
        e2e["payload_d2h"] = pd2h

        # persisted-index start: load a v2 npz (device-ready, no
        # rebuild) in a fresh graph object, then map — the
        # --load-index production start path
        from dbgtpu.index.persist import load_index, save_index

        idx = os.path.join(td, "index.npz")
        save_index(g, idx)
        t0 = time.monotonic()
        g2 = load_index(idx)
        t_load = time.monotonic() - t0
        # run_pipeline starts the fresh graph's index H2D
        # asynchronously before parsing, so the transfer overlaps
        # host work; everything after load_index is one "map" leg
        t0 = time.monotonic()
        paths, na, st = run_pipeline(
            [rf], uf, k=K, m=M, effort=EFFORT, impl="jax",
            batch_size=32768, graph=g2,
        )
        dt = time.monotonic() - t0
        e2e["load"] = n_reads / (dt + t_load)
        log(f"end-to-end (load-index): load {t_load:.1f}s + "
            f"H2D+map {dt:.1f}s -> {e2e['load']:,.0f} reads/s "
            f"({st.aligned} aligned)")

    out = {
        "metric": "reads_mapped_per_sec_chip",
        "value": round(best, 1),
        "unit": "reads/s",
        "vs_baseline": round(best / BASELINE_READS_PER_S, 2),
    }
    out["device"] = facts
    out["device_step_ms"] = round(device_step_ms, 2)
    out["compute_reads_per_sec"] = round(compute_rps, 1)
    out["device_exhaustive_reads_per_sec"] = round(
        mode_rates["exhaustive"], 1)
    out["device_anchors_reads_per_sec"] = round(mode_rates["anchors"], 1)
    out["end_to_end_reads_per_sec"] = round(e2e["warm"], 1)
    out["end_to_end_vs_baseline"] = round(
        e2e["warm"] / BASELINE_READS_PER_S, 2
    )
    out["payload_bytes_h2d"] = int(e2e["payload_h2d"])
    out["payload_bytes_d2h"] = int(e2e["payload_d2h"])
    out["end_to_end_cold_reads_per_sec"] = round(e2e["cold"], 1)
    out["end_to_end_load_index_reads_per_sec"] = round(e2e["load"], 1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
