"""Large-graph mapping benchmark: ~1M unitigs.

Measures, in ONE process (all configs on the same device, so rates are
comparable):
  - index build + H2D time per config,
  - steady-state packed mapping throughput at 131k reads (whole
    workload in ONE dispatch per rep, scalar fetch),
  - per-artifact HBM bytes (hbm_report),
for configs selected by argv (default: the first five):
  probe3_scan  — default window-3 closure probe table
  probe4_scan  — window-4 probe (DBGTPU_PROBE_WINDOW=4, 4 GB cap)
  noprobe_scan — probe table disabled (per-position scan fallback)
  mphf_probe3  — compact MPHF junction layout + the same probe table
  probe3_renum — BFS graph-order unitig renumbering
  shuf_probe3 / shuf_renum — argv-only: shuffled unitig file order,
    with and without renumbering (the locality question on its real
    input)

plus the persisted-index load path: save_index -> streaming
load_index -> first-batch.

Writes JSON lines to build/bench_scale/scale.jsonl in the checkout and
prints a summary table.

    python scripts/bench_scale.py [config ...]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT_DIR = os.path.join(ROOT, "build", "bench_scale")
N_UNITIGS = int(os.environ.get("DBGTPU_SCALE_UNITIGS", 1_000_000))
N_READS = 131072
K, M, EFFORT, READ_LEN = 31, 2, 2, 100


def rec(**kw):
    kw = {k: (round(v, 4) if isinstance(v, float) else v)
          for k, v in kw.items()}
    with open(os.path.join(OUT_DIR, "scale.jsonl"), "a") as out:
        out.write(json.dumps(kw) + "\n")
    print(kw, file=sys.stderr, flush=True)


def workload():
    from tests import synth
    from dbgtpu.seq import encode

    rng = np.random.default_rng(404)
    genome = synth.make_genome(rng, int(N_UNITIGS * 65))
    unitigs = synth.chop_unitigs(genome, K, rng, 40, 150)
    reads = synth.sample_reads(genome, rng, N_READS, READ_LEN, err_frac=0.5)
    return unitigs, np.stack([encode(r) for r in reads])


def main():
    import jax

    from dbgtpu.runtime import device_facts, enable_compile_cache

    enable_compile_cache()
    os.makedirs(OUT_DIR, exist_ok=True)
    dev = jax.devices()[0]
    rec(phase="device", **device_facts())

    t0 = time.monotonic()
    unitigs, codes_all = workload()
    rec(phase="workload", n_unitigs=len(unitigs),
        dt=time.monotonic() - t0)

    import dbgtpu.index.device as device_mod
    from dbgtpu.index.build import build_graph_from_seqs
    from dbgtpu.index.device import build_device_index, hbm_report
    from dbgtpu.engine.core import (
        align_batch_packed, al_meta_of, index_to_device, jl_meta_of,
    )
    from dbgtpu.engine.runner import (
        PMAX_CAP, _bucket_len, _pmax_for, pack_words_batch,
    )

    t0 = time.monotonic()
    g = build_graph_from_seqs(unitigs, K)
    rec(phase="graph_build", dt=time.monotonic() - t0)

    import functools

    import jax.numpy as jnp

    B = 32768
    L = _bucket_len(READ_LEN, K)
    n_batches = N_READS // B
    pad = np.zeros((B, L - codes_all.shape[1]), np.uint8)
    nm = np.zeros((B, L), bool)
    lens_d = jax.device_put(np.full(B, READ_LEN, np.int32), dev)
    ws, bs = [], []
    for i in range(n_batches):
        w, bts = pack_words_batch(
            np.concatenate([codes_all[i * B:(i + 1) * B], pad], axis=1),
            nm,
        )
        ws.append(w)
        bs.append(bts)
    words_s = jax.device_put(np.stack(ws), dev)
    nmbits_s = jax.device_put(np.stack(bs), dev)
    del ws, bs
    jax.block_until_ready((words_s, nmbits_s, lens_d))

    summary = []

    def run_config(name, layout, cap, graph=None, mode="greedy"):
        gg = g if graph is None else graph
        old = device_mod.PROBE_TABLE_MAX_BYTES
        device_mod.PROBE_TABLE_MAX_BYTES = cap
        try:
            t0 = time.monotonic()
            di = build_device_index(gg, layout=layout)
            t_build = time.monotonic() - t0
        finally:
            device_mod.PROBE_TABLE_MAX_BYTES = old
        rep = hbm_report(di)
        t0 = time.monotonic()
        ix = index_to_device(di)
        jax.block_until_ready(ix)
        t_h2d = time.monotonic() - t0
        jlm = jl_meta_of(di)
        alm = al_meta_of(di)
        pmax = min(_pmax_for(di, L), PMAX_CAP)
        MODE = mode

        # steady loop: whole workload in ONE dispatch, one stacked
        # scalar fetch per rep (the bench.py methodology)
        @functools.partial(jax.jit, static_argnames=("L", "pmax"))
        def whole(ix, words_s, nmbits_s, lens, *, L, pmax):
            def one(wb):
                w, b = wb
                fused = align_batch_packed.__wrapped__(
                    ix, w, b, lens, mode=MODE, k=K, m=M,
                    effort=EFFORT, L=L, pmax=pmax, jl_meta=jlm,
                    al_meta=alm,
                )
                st = fused[:, 0].astype(jnp.int32)
                return (jnp.sum((st == 1) | (st == 2)),
                        jnp.sum(fused.astype(jnp.int32)))

            a, c = jax.lax.map(one, (words_s, nmbits_s))
            return jnp.sum(a), jnp.sum(c)

        t0 = time.monotonic()
        first = np.asarray(align_batch_packed(
            ix, words_s[0], nmbits_s[0], lens_d, mode=MODE, k=K,
            m=M, effort=EFFORT, L=L, pmax=pmax, jl_meta=jlm,
            al_meta=alm,
        ))
        t_first = time.monotonic() - t0
        aligned = int(((first[:, 0] == 1) | (first[:, 0] == 2)).sum())
        a0, c0 = whole(ix, words_s, nmbits_s, lens_d, L=L, pmax=pmax)
        np.asarray(a0)                     # compile+warm
        ts = []
        for _ in range(3):
            t0 = time.monotonic()
            a0, c0 = whole(ix, words_s, nmbits_s, lens_d, L=L, pmax=pmax)
            np.asarray(jnp.stack([a0, c0]))
            ts.append(time.monotonic() - t0)
        med = sorted(ts)[1]
        rps = round(N_READS / med)

        # device-only step: in-dispatch repeat loop, differenced — the
        # per-dispatch+fetch cost is excluded, bench.py's compute-floor
        # methodology
        @functools.partial(jax.jit, static_argnames=("L", "pmax", "reps"))
        def whole_reps(ix, words_s, nmbits_s, lens, *, L, pmax, reps):
            def body(i, acc):
                ws = jnp.roll(words_s, i, axis=0)
                ns = jnp.roll(nmbits_s, i, axis=0)

                def one(wb):
                    w, b = wb
                    fused = align_batch_packed.__wrapped__(
                        ix, w, b, lens, mode=MODE, k=K, m=M,
                        effort=EFFORT, L=L, pmax=pmax, jl_meta=jlm,
                        al_meta=alm,
                    )
                    return jnp.sum(fused.astype(jnp.int32))
                return acc ^ jnp.sum(jax.lax.map(one, (ws, ns)))
            return jax.lax.fori_loop(0, reps, body, jnp.int32(0))

        Rr = 5
        times = {}
        for reps in (1, Rr):
            np.asarray(whole_reps(ix, words_s, nmbits_s, lens_d,
                                  L=L, pmax=pmax, reps=reps))
            t0 = time.monotonic()
            np.asarray(whole_reps(ix, words_s, nmbits_s, lens_d,
                                  L=L, pmax=pmax, reps=reps))
            times[reps] = time.monotonic() - t0
        step_ms = (times[Rr] - times[1]) / (Rr - 1) / n_batches * 1e3
        rec(phase="config", name=name, build_s=t_build, h2d_s=t_h2d,
            first_s=t_first, reads_per_s=rps, aligned_frac=aligned / B,
            device_step_ms=round(step_ms, 2),
            device_reads_per_s=round(B / step_ms * 1e3),
            hbm_mb={k: v >> 20 for k, v in rep.items()},
            probe_window=(di.probe_tbl.window if di.probe_tbl else 0))
        summary.append((name, t_build, t_h2d, rps, rep["total"] >> 20))
        # free device arrays between configs
        if hasattr(di, "_ix_arrays"):
            del di._ix_arrays
        for attr in ("_device_index", f"_device_index_{layout}"):
            if hasattr(gg, attr):
                delattr(gg, attr)
        return di

    import dbgtpu.index.device as _dm

    only = set(sys.argv[1:])

    def want(name):
        return not only or name in only

    di = None
    if want("probe3_scan"):
        di = run_config("probe3_scan", "scan", _dm.PROBE_TABLE_MAX_BYTES)
    if want("probe4_scan"):
        os.environ["DBGTPU_PROBE_WINDOW"] = "4"
        try:
            run_config("probe4_scan", "scan", 4 << 30)
        finally:
            os.environ.pop("DBGTPU_PROBE_WINDOW", None)
    if want("noprobe_scan"):
        run_config("noprobe_scan", "scan", 0)
    if want("mphf_probe3"):
        run_config("mphf_probe3", "mphf", _dm.PROBE_TABLE_MAX_BYTES)
    if want("probe3_renum"):
        # BFS graph-order unitig ids (walk-gather locality experiment);
        # byte parity is guaranteed by the drain-side id translation
        os.environ["DBGTPU_RENUMBER"] = "1"
        try:
            run_config("probe3_renum", "scan", _dm.PROBE_TABLE_MAX_BYTES)
        finally:
            os.environ.pop("DBGTPU_RENUMBER", None)
    if want("shuf_probe3") or want("shuf_renum"):
        # the renumbering question on its REAL input: unitig files from
        # assemblers are not genome-ordered, so shuffle the file order
        # and ask whether BFS renumbering recovers the locality that
        # genome order gave for free (argv-selected configs only)
        if only:
            rng = np.random.default_rng(77)
            perm = rng.permutation(len(unitigs))
            g_shuf = build_graph_from_seqs(
                [unitigs[i] for i in perm], K
            )
            if want("shuf_probe3"):
                run_config("shuf_probe3", "scan",
                           _dm.PROBE_TABLE_MAX_BYTES, graph=g_shuf)
            if want("shuf_renum"):
                os.environ["DBGTPU_RENUMBER"] = "1"
                try:
                    run_config("shuf_renum", "scan",
                               _dm.PROBE_TABLE_MAX_BYTES, graph=g_shuf)
                finally:
                    os.environ.pop("DBGTPU_RENUMBER", None)
    if want("dog_probe3"):
        # dog/anchor mode at scale: array-backed anchor
        # map build + -G device mapping on the 1M-unitig graph
        t0 = time.monotonic()
        g_dog = build_graph_from_seqs(unitigs, K, dog_mode=True)
        rec(phase="dog_graph_build", dt=time.monotonic() - t0)
        run_config("dog_probe3", "scan", _dm.PROBE_TABLE_MAX_BYTES,
                   graph=g_dog, mode="anchors")
        del g_dog

    if di is None:
        di = build_device_index(g, layout="scan")

    # persisted-index load path (uses the probe3 scan DeviceIndex)
    from dbgtpu.index.persist import load_index, save_index

    g._device_index = di
    p = os.path.join(OUT_DIR, "index.npz")
    t0 = time.monotonic()
    save_index(g, p, di)
    t_save = time.monotonic() - t0
    t0 = time.monotonic()
    g2 = load_index(p)
    t_load = time.monotonic() - t0
    di2 = g2._device_index
    t0 = time.monotonic()
    ix2 = index_to_device(di2)
    jax.block_until_ready(ix2)
    t_h2d2 = time.monotonic() - t0
    pmax = min(_pmax_for(di2, L), PMAX_CAP)
    t0 = time.monotonic()
    np.asarray(align_batch_packed(
        ix2, words_s[0], nmbits_s[0], lens_d, mode="greedy", k=K, m=M,
        effort=EFFORT, L=L, pmax=pmax,
    ))
    t_first2 = time.monotonic() - t0
    rec(phase="persist", save_s=t_save, load_s=t_load,
        h2d_s=t_h2d2, first_batch_s=t_first2,
        file_mb=os.path.getsize(p) >> 20)

    print("\nconfig            build_s  h2d_s  reads/s    hbm_MB")
    for name, tb, th, rps, mb in summary:
        print(f"{name:<16} {tb:7.1f} {th:6.1f} {rps:9,} {mb:8}")
    print(f"persist: save {t_save:.1f}s, load {t_load:.1f}s, "
          f"h2d {t_h2d2:.1f}s, first batch {t_first2:.1f}s")


if __name__ == "__main__":
    main()
