"""Scaling-efficiency harness (BASELINE.md: >=0.8 efficiency at N>=2).

Runs the packed mapping loop on a 1-device mesh and an N-device mesh
over the same read workload and reports reads/s + efficiency
(rate_N / (N * rate_1)).  On several cards of one host (joined all to
all by NVLink) this measures data parallelism across them; on a CPU
host it still exercises the full
shard_map path over virtual devices (set
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu)
— the efficiency number is then about the harness, not silicon.

Prints one JSON line:
  {"n_devices": N, "reads_per_s_1": r1, "reads_per_s_n": rN,
   "scaling_efficiency": rN / (N * r1)}
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(n_devices: int | None = None, n_reads: int = 16384,
         genome_len: int = 200_000) -> dict:
    import jax

    from dbgtpu.runtime import device_facts, enable_compile_cache

    enable_compile_cache()

    from tests import synth
    from dbgtpu.seq import encode
    from dbgtpu.index.build import build_graph_from_seqs
    from dbgtpu.index.device import build_device_index
    from dbgtpu.engine.core import index_to_device
    from dbgtpu.engine.runner import (
        PMAX_CAP, _bucket_len, _pmax_for, pack_words_batch,
    )
    from dbgtpu.dist.mesh import make_mesh, sharded_packed_fn

    K, M, EFFORT, READ_LEN = 31, 2, 2, 100
    ndev = n_devices or len(jax.local_devices())
    rng = np.random.default_rng(9)
    genome = synth.make_genome(rng, genome_len)
    unitigs = synth.chop_unitigs(genome, K, rng, 40, 150)
    reads = synth.sample_reads(genome, rng, n_reads, READ_LEN, err_frac=0.5)
    codes = np.stack([encode(r) for r in reads])

    g = build_graph_from_seqs(unitigs, K)
    di = build_device_index(g)
    ix = index_to_device(di)
    L = _bucket_len(READ_LEN, K)
    pmax = min(_pmax_for(di, L), PMAX_CAP)
    pad = np.zeros((n_reads, L - READ_LEN), np.uint8)
    words, nmbits = pack_words_batch(
        np.concatenate([codes, pad], axis=1),
        np.zeros((n_reads, L), bool),
    )
    lens = np.full(n_reads, READ_LEN, np.int32)

    def rate(n: int) -> float:
        mesh = make_mesh(n)
        fn = sharded_packed_fn(
            mesh, mode="greedy", k=K, m=M, effort=EFFORT, L=L, pmax=pmax,
        )
        fused, counts = fn(ix, words, nmbits, lens)   # compile+warm
        np.asarray(counts)
        ts = []
        for _ in range(3):
            t0 = time.monotonic()
            _, counts = fn(ix, words, nmbits, lens)
            np.asarray(counts)
            ts.append(time.monotonic() - t0)
        return n_reads / sorted(ts)[1]

    r1 = rate(1)
    rn = rate(ndev)
    out = {
        "device": device_facts(),
        "n_devices": ndev,
        "reads_per_s_1": round(r1),
        "reads_per_s_n": round(rn),
        "scaling_efficiency": round(rn / (ndev * r1), 3),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else None)
