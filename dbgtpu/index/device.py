"""Device-resident index layout + vectorized host construction.

The junction index is ONE open-addressing hash table over the union of
the reference's left/right canonical (k-1)-mer keysets; each slot holds
the 4 left IDs and the 4 right IDs (reference unitigIndices,
aligner.h:49-55).  Lookups on device run a fixed number of probes
(`probe_len`, the maximum displacement seen at build time) — absent
keys can never false-positive because full keys are compared, which is
the same defense the reference uses against MPHF aliasing
(aligner.cpp:158-169).

Construction is vectorized numpy (first-writer-wins claim rounds), not
a per-key python loop, so multi-million-key graphs build fast on host.
"""

from __future__ import annotations

import logging
import os

from dataclasses import dataclass

import numpy as np

from ..engine.kmer32 import mix32, mix32b, split64
from .build import UnitigGraph


_EMPTY_KEY = np.uint32(0xFFFFFFFF)  # (khi, klo) both all-ones = empty


@dataclass
class HashTable:
    """Two-choice bucketed hash table: nb buckets x 4 slots.

    A key lives in slot s of bucket h1(key) or h2(key); a device lookup
    is exactly TWO 4-slot bucket gathers + key compares (vs 13+ probes
    of the former linear-probe layout; lookups are gather-bound,
    SURVEY.md §7.3).  Empty slots hold all-ones keys
    (keys are canonical <=62-bit k-mers, so all-ones never collides).
    """

    khi: np.ndarray       # uint32 [nb, 4]
    klo: np.ndarray       # uint32 [nb, 4]
    vals: np.ndarray      # int32  [nb, 4, V]
    n_buckets: int
    # retained for compatibility with older call sites; always 2
    probe_len: int = 2

    @property
    def size(self) -> int:
        return self.n_buckets * 4

    @property
    def used(self) -> np.ndarray:
        return self.khi != _EMPTY_KEY


def build_hash_table(keys: np.ndarray, vals: np.ndarray) -> HashTable:
    """keys: uint64 [N] unique; vals: int32 [N, V]."""
    n = len(keys)
    vals = np.asarray(vals, np.int32)
    if vals.ndim == 1:
        vals = vals[:, None]
    V = vals.shape[1]
    nb = 1 << max(2, int(np.ceil(np.log2(max(1, n / 2)))))
    hi, lo = split64(np.asarray(keys, np.uint64))
    while True:
        khi = np.full((nb, 4), _EMPTY_KEY, np.uint32)
        klo = np.full((nb, 4), _EMPTY_KEY, np.uint32)
        out_vals = np.zeros((nb, 4, V), np.int32)
        if n == 0:
            return HashTable(khi, klo, out_vals, nb)
        mask = np.uint32(nb - 1)
        h1 = (mix32(hi, lo) & mask).astype(np.int64)
        h2 = (mix32b(hi, lo) & mask).astype(np.int64)
        remaining = np.arange(n)
        ok = True
        for attempt in (h1, h2):
            for s in range(4):
                if not len(remaining):
                    break
                cur = attempt[remaining]
                free = khi[cur, s] == _EMPTY_KEY
                claim = np.full(nb, -1, np.int64)
                claim[cur[::-1]] = remaining[::-1]
                won = (claim[cur] == remaining) & free
                w = remaining[won]
                b = cur[won]
                khi[b, s] = hi[w]
                klo[b, s] = lo[w]
                out_vals[b, s] = vals[w]
                remaining = remaining[~won]
        if len(remaining) == 0:
            return HashTable(khi, klo, out_vals, nb)
        # both candidate buckets full for some key (vanishingly rare at
        # load <= 0.5): double and retry
        nb <<= 1


def ht_find_host(tbl: HashTable, hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Numpy mirror of the device lookup: flat slot (bucket*4 + s) per
    query, or -1.  Index `tbl.vals.reshape(-1, V)` with the result."""
    hi = np.asarray(hi, np.uint32)
    lo = np.asarray(lo, np.uint32)
    mask = np.uint32(tbl.n_buckets - 1)
    res = np.full(hi.shape, -1, np.int64)
    for hfn in (mix32, mix32b):
        b = (hfn(hi, lo) & mask).astype(np.int64)
        ok = (tbl.khi[b] == hi[..., None]) & (tbl.klo[b] == lo[..., None])
        s = ok.argmax(axis=-1)
        res = np.where((res < 0) & ok.any(axis=-1), b * 4 + s, res)
    return res


# scan-table slots per bucket row (env-tunable for geometry A/Bs: the
# fused row is (2 + 8) * ST_SLOTS uint32 = 1280 B at 32 slots, 320 B at
# 8; the engine derives the slot count from the row width, so persisted
# tables built under one geometry load under any)
ST_SLOTS = int(os.environ.get("DBGTPU_ST_SLOTS", 32))
ST_TARGET_LOAD = max(2, (ST_SLOTS * 3) // 8)  # keys/bucket sizing aim


@dataclass
class ScanTable:
    """Single-hash fat-bucket table (the row-gather layout).

    Membership AND lookup are each ONE row gather ([B] indices into an
    [N, W] table) into as few, as dense rows as possible, in place of
    several element/point gathers.  The layout was chosen where row
    gathers were rate-bound by row COUNT, not width; whether that holds
    on a GPU is for a benchmark cell to show.  Each bucket row packs ST_SLOTS=32 slot keys as 64
    uint32 lanes (cols 0:32 key-hi, 32:64 key-lo), sized for
    ~ST_TARGET_LOAD keys/bucket (~2.7x denser than the former 8-slot
    near-empty layout — the junction table of a 1M-unitig graph drops
    from 640 MB to ~250 MB, which matters because walk-loop gather
    rates degrade with table footprint); vals sit in a parallel
    [nb*ST_SLOTS, V] row table.  The build grows nb until no bucket
    overflows.  Exactness is preserved: full 62-bit keys are compared
    on lookup, the same aliasing defense the reference uses after MPHF
    lookup (aligner.cpp:158-169)."""

    keys: np.ndarray      # uint32 [nb, 2*ST_SLOTS]
    vals: np.ndarray      # int32  [nb*ST_SLOTS, V]
    n_buckets: int
    seed: int             # uint32 hash seed

    @property
    def slots(self) -> int:
        """Slots per bucket, derived from the stored geometry (a table
        persisted under one DBGTPU_ST_SLOTS loads under any)."""
        return self.keys.shape[1] // 2

    @property
    def size(self) -> int:
        return self.n_buckets * self.slots


def _scan_hash(hi, lo, seed):
    """Bucket hash for ScanTable; bit-identical numpy/jnp (mix32)."""
    return mix32(hi ^ seed, lo)


def build_scan_table(keys: np.ndarray, vals: np.ndarray) -> ScanTable:
    """keys: uint64 [N] unique; vals: int32 [N, V]."""
    keys = np.asarray(keys, np.uint64)
    vals = np.asarray(vals, np.int32)
    if vals.ndim == 1:
        vals = vals[:, None]
    n, V = len(keys), vals.shape[1]
    S_ = ST_SLOTS
    hi, lo = split64(keys)
    nb0 = 1 << max(2, int(np.ceil(np.log2(max(1, n / ST_TARGET_LOAD)))))
    # growth bound: a byte cap, not an iteration count — a skewed
    # keyset degrades into a sparser (bigger) table instead of aborting
    # the build; only >S_ keys sharing BOTH full 32-bit bucket hashes
    # under both seeds (astronomically unlikely for unique <=62-bit
    # keys) can still fail
    # true device cost per bucket: tkeys row of 2*S_ uint32 plus S_
    # slots x V int32 vals (the fused [nb, 2*S_ + S_*V] rows)
    row_bytes = (2 * S_ + S_ * V) * 4
    cap = max(
        int(os.environ.get("DBGTPU_SCAN_TABLE_MAX_BYTES", 16 << 30)),
        nb0 * row_bytes * 4,
    )
    # seed/size search: hash once per seed, re-mask while growing nb
    # (bucket overflow is a load property, not a seed property); the
    # second seed guards against full-32-bit-hash collisions
    for attempt in range(2):
        seed = np.uint32((0x9E3779B1 * (attempt + 1)) & 0xFFFFFFFF)
        h = _scan_hash(hi, lo, seed) if n else np.zeros(0, np.uint32)
        nb = nb0
        while nb * row_bytes <= cap:
            b = (h & np.uint32(nb - 1)).astype(np.int64)
            counts = np.bincount(b, minlength=nb)
            if counts.max(initial=0) <= S_:
                tkeys = np.full((nb, 2 * S_), _EMPTY_KEY, np.uint32)
                tvals = np.zeros((nb * S_, V), np.int32)
                if n:
                    order = np.argsort(b, kind="stable")
                    bs = b[order]
                    start = np.zeros(nb + 1, np.int64)
                    np.cumsum(counts, out=start[1:])
                    slot = np.arange(n) - start[bs]
                    tkeys[bs, slot] = hi[order]
                    tkeys[bs, S_ + slot] = lo[order]
                    tvals[bs * S_ + slot] = vals[order]
                return ScanTable(tkeys, tvals, nb, int(seed))
            nb <<= 1
    raise RuntimeError(
        "scan table build failed: bucket overflow unresolvable within "
        f"{cap >> 20} MB (DBGTPU_SCAN_TABLE_MAX_BYTES); the keyset has "
        f">{ST_SLOTS} keys sharing both 32-bit bucket hashes"
    )


@dataclass
class ProbeTable:
    """Closure membership-probe table for the anchor scan.

    The anchor scan must test `canonical((k-1)-mer) ∈ S` (S = junction
    key set) at EVERY read position (reference getNOverlap,
    aligner.cpp:345-378); each test is a row gather, so a per-position
    probe dominates the whole mapping runtime.  This table
    answers membership for `window` consecutive positions per gather:

      probe the canonical kmer x_p at position p; its bucket slot
      stores precomputed bits for the whole 1-step neighbourhood:
        self:        x_p ∈ S
        pred1[o][b]: canonical(b-extended predecessor) ∈ S   (pos p-1)
        succ1[o][c]: canonical(c-extended successor)  ∈ S   (pos p+1)
        succ2[o][cc]: two-step successor   (window 4)        (pos p+2)
      (o = whether the read's forward kmer equals the stored canonical
      key or its reverse complement; consecutive read kmers are shift-
      related, so b/c/cc are read directly from the read's base codes.)

    window 4: keyset = canon(S ∪ succ(S±) ∪ succ²(S±)) ≈ 21·|S±|.
    Rows hold PT_SLOTS=32 slots each, sized for ~12 keys/bucket (fat
    buckets cut device memory ~4x vs the former 8-slot near-empty
    layout).  Row [nb, 128] uint32 — cols 0:32 ~key-hi
    (INVERTED so empty slots are natural zeros: key-hi < 2^30 for
    k <= 32, hence a stored ~hi is never 0 and a query's ~hi never
    matches an untouched slot — rows come from a lazily-zeroed
    allocation, no full-table fill pass), 32:64 key-lo, 64:96 bits
    word0, 96:128 bits word1.  Bit layout (49 bits): 0 self; 1+4o+c
    succ1; 9+4o+b pred1; 17+16o+cc succ2.

    window 3 (auto-selected when the window-4 rows would exceed
    PROBE_TABLE_MAX_BYTES — the large-graph mid-tier): keyset drops
    succ², ≈ 5·|S±| keys, and the 17 remaining bits fit word0, so rows
    are [nb, 96].  The engine derives the window from the row width.

    A probe that misses proves all `window` positions are non-members;
    this trades one-time host build + device memory for a `window`-fold
    cut in scan gathers — the batched inversion of the reference's
    per-position MPHF loop.
    """

    rows: np.ndarray      # uint32 [nb, 128] (window 4) / [nb, 96] (3)
    n_buckets: int
    seed: int
    window: int = 4


# probe-table slots per bucket row (env-tunable for A/Bs).  Fewer
# slots would cut the member stage's slot-compare work, but the max-
# bucket<=S build constraint then blows the bucket count up (12 MB ->
# 48 MB at 8 slots on the survey keyset), so the table is bigger to
# gather from.  32 was the faster choice on the earlier machine; it is
# not yet measured on a GPU.
PT_SLOTS = int(os.environ.get("DBGTPU_PT_SLOTS", 32))
PT_TARGET_LOAD = max(2, (PT_SLOTS * 3) // 8)  # keys/bucket sizing aim


# skip the probe table when its device rows would exceed this budget
# (the closure keyset makes the table the largest index artifact; the
# build first downgrades window 4 -> 3 (~4x fewer keys), then gives up
# and the engine falls back to exact per-position membership probes —
# correct, ~4x more scan gathers).  Overridable for experiments.
# Default 1 GB: at 1M unitigs a cap-filling window-4 table (2 GB) bought
# little mapping throughput over NO probe table at all on the earlier
# machine (the junction-walk gathers dominate at that scale), while
# costing 4x the build time and H2D of the window-3 layout this cap
# selects.  Not yet re-measured on a GPU.
PROBE_TABLE_MAX_BYTES = int(os.environ.get(
    "DBGTPU_PROBE_TABLE_MAX_BYTES", 1 << 30
))

_log = logging.getLogger("dbgtpu.index")


def _rc2(cc: np.ndarray) -> np.ndarray:
    """Reverse-complement of a 2-base code pair (b0b1 -> comp swapped)."""
    cc = np.asarray(cc, np.uint64)
    three = np.uint64(3)
    return (((three - (cc & three)) << np.uint64(2))
            | (three - (cc >> np.uint64(2))))


def build_probe_table(
    s_keys: np.ndarray, k1: int, window: int | None = None
) -> ProbeTable | None:
    """s_keys: uint64 canonical junction keys (the ScanTable keyset).

    Scatter-inversion build: rather than querying, for every closure
    key, whether each of its 48 oriented neighbours is a junction key
    (49 canon+searchsorted passes over 41|S| keys — the former
    bottleneck), iterate the |S±| junction keys themselves and SCATTER
    their membership into the neighbouring closure keys' bit words:
    w = succ1(zo, c) ∈ S± enumerates exactly the (z, o, c) triples
    whose succ1 bit is set, via zo = (w>>2)|(b0<<top) over the 4 top
    bases b0 (and symmetrically for pred1/succ2).  All reverse
    complements come from ONE rcb over S± plus shift identities
    (rcb(succ1(w, c)) = ((3-c)<<top) | (rcb(w)>>2), etc.), so the build
    does 24|S±| scatter emissions instead of 196|S±| query-side rcb +
    searchsorted operations.  Closure closedness (canon(pred(x)) =
    canon(succ1(rcb(x))) ∈ keys since S± is rc-closed) guarantees every
    emission lands on an existing key; tests/test_probe.py checks the
    result against a direct per-key query oracle.

    `window` is normally auto-selected: 3 by default — it matched
    window 4's full-step device speed on the 30k and 1M graphs on the
    earlier machine while costing ~5x less device memory, H2D and build
    time; window 4 opts in via DBGTPU_PROBE_WINDOW=4 (then the byte
    cap can still downgrade to 3), and any window downgrades to None
    past the cap.  The projection happens BEFORE the expansion arrays
    are materialized, so the byte cap also bounds host peak memory
    (closure dedupe is ~0-3% on real graphs, so the estimate
    nk ≈ |S| + {20,4}·|S±| is tight)."""
    S = np.sort(np.asarray(s_keys, np.uint64))
    n = len(S)
    if n == 0 or k1 < 3:
        return None
    mask = np.uint64((1 << (2 * k1)) - 1)
    top = np.uint64(2 * (k1 - 1))
    u2, u3, u4 = np.uint64(2), np.uint64(3), np.uint64(4)

    from ..seq import rcb

    s_pm = np.unique(np.concatenate([S, rcb(S, k1)]))   # S±, rc-closed
    rc_pm = rcb(s_pm, k1)
    p = len(s_pm)

    def proj_bytes(nk_est: int, width: int) -> int:
        nb_est = 1 << max(
            2, int(np.ceil(np.log2(max(1, nk_est / PT_TARGET_LOAD))))
        )
        return nb_est * width * 4

    if window is None:
        prefer4 = os.environ.get("DBGTPU_PROBE_WINDOW") == "4"
        if (prefer4 and proj_bytes(n + 20 * p, 4 * PT_SLOTS)
                <= PROBE_TABLE_MAX_BYTES):
            window = 4
        elif proj_bytes(n + 4 * p, 3 * PT_SLOTS) <= PROBE_TABLE_MAX_BYTES:
            window = 3
        else:
            _log.warning(
                "probe table skipped: ~%d closure keys (window 3) "
                "exceed PROBE_TABLE_MAX_BYTES=%d MB; anchor scan falls "
                "back to per-position membership probes (~4x more scan "
                "gathers)", n + 4 * p, PROBE_TABLE_MAX_BYTES >> 20,
            )
            return None
    width = 4 * PT_SLOTS if window == 4 else 3 * PT_SLOTS
    c4 = np.arange(4, dtype=np.uint64)

    # closure keyset: canon(S ∪ succ1(S±) [∪ succ2(S±) for window 4]);
    # rc of each neighbour from rc_pm via shift identities (no further
    # rcb calls)
    succ1 = ((s_pm[:, None] << u2) | c4[None, :]) & mask
    rc_s1 = ((u3 - c4)[None, :] << top) | (rc_pm[:, None] >> u2)
    parts = [S, np.minimum(succ1, rc_s1).ravel()]
    del succ1, rc_s1
    if window == 4:
        c16 = np.arange(16, dtype=np.uint64)
        succ2 = ((s_pm[:, None] << u4) | c16[None, :]) & mask
        rc_s2 = (_rc2(c16)[None, :] << (top - u2)) | (rc_pm[:, None] >> u4)
        parts.append(np.minimum(succ2, rc_s2).ravel())
        del succ2, rc_s2
    keys = np.unique(np.concatenate(parts))
    del parts

    nk = len(keys)
    bits0 = np.zeros(nk, np.uint32)
    bits1 = np.zeros(nk, np.uint32) if window == 4 else None

    # self bit: keys that are junction keys (keys and S both canonical)
    i = np.minimum(np.searchsorted(S, keys), n - 1)
    bits0[S[i] == keys] |= np.uint32(1)

    idx_parts: list[np.ndarray] = []
    w0_parts: list[np.ndarray] = []
    w1_parts: list[np.ndarray] = []

    def emit(cand, rc_cand, bit_o0, bit_o1):
        """Record bit_o0 where cand is canonical, bit_o1 where rc_cand
        is (both for palindromes); bit indices are [|S±|] int arrays."""
        kz = np.minimum(cand, rc_cand)
        o0 = cand <= rc_cand
        o1 = rc_cand <= cand
        bsel = np.where(o0, bit_o0, bit_o1).astype(np.uint64)
        both = o0 & o1
        idx = np.searchsorted(keys, kz)
        lo_m = np.where(bsel < 32,
                        np.uint32(1) << bsel.astype(np.uint32),
                        np.uint32(0))
        hi_m = np.where(bsel >= 32,
                        np.uint32(1) << (bsel - 32).astype(np.uint32),
                        np.uint32(0))
        if both.any():
            b1u = bit_o1.astype(np.uint64)
            lo_m = np.where(both & (b1u < 32),
                            lo_m | (np.uint32(1) << b1u.astype(np.uint32)),
                            lo_m)
            hi_m = np.where(
                both & (b1u >= 32),
                hi_m | (np.uint32(1)
                        << np.where(b1u >= 32, b1u - 32, 0).astype(
                            np.uint32)),
                hi_m)
        idx_parts.append(idx)
        w0_parts.append(lo_m)
        w1_parts.append(hi_m)

    c_last = (s_pm & u3).astype(np.int64)         # succ1 extension base
    b_first = ((s_pm >> top) & u3).astype(np.int64)   # pred1 lost base
    for b0 in range(4):
        # succ1(zo, c_last) == w: zo = (w>>2) | (b0<<top)
        cand = (s_pm >> u2) | (np.uint64(b0) << top)
        rc_c = ((rc_pm << u2) | (u3 - np.uint64(b0))) & mask
        emit(cand, rc_c, 1 + c_last, 5 + c_last)
    for c0 in range(4):
        # pred1(zo, b_first) == w: zo = ((w<<2) | c0) & mask
        cand = ((s_pm << u2) | np.uint64(c0)) & mask
        rc_c = ((u3 - np.uint64(c0)) << top) | (rc_pm >> u2)
        emit(cand, rc_c, 9 + b_first, 13 + b_first)
    if window == 4:
        cc_last = (s_pm & np.uint64(15)).astype(np.int64)  # succ2 pair
        for bb in range(16):
            # succ2(zo, cc_last) == w: zo = (w>>4) | (bb<<(top-2))
            cand = (s_pm >> u4) | (np.uint64(bb) << (top - u2))
            rc_c = ((rc_pm << u4) & mask) | _rc2(np.uint64(bb))
            emit(cand, rc_c, 17 + cc_last, 33 + cc_last)

    idx_all = np.concatenate(idx_parts)
    w0_all = np.concatenate(w0_parts)
    w1_all = np.concatenate(w1_parts)
    order = np.argsort(idx_all, kind="stable")
    si = idx_all[order]
    starts = np.flatnonzero(np.r_[True, si[1:] != si[:-1]])
    tgt = si[starts]
    bits0[tgt] |= np.bitwise_or.reduceat(w0_all[order], starts)
    if window == 4:
        bits1[tgt] |= np.bitwise_or.reduceat(w1_all[order], starts)

    hi, lo = split64(keys)
    # seed/size search: ONE 32-bit hash per seed; growing nb only
    # re-masks it (a former version rehashed all keys for 16 seeds per
    # size — pure waste, since overflow is a load property, not a seed
    # property).  A second seed guards against full-32-bit-hash
    # collisions; growth stops at the byte cap and downgrades.
    S_ = PT_SLOTS
    nb0 = 1 << max(2, int(np.ceil(np.log2(max(1, nk / PT_TARGET_LOAD)))))
    for attempt in range(2):
        seed = np.uint32((0x9E3779B1 * (attempt + 1)) & 0xFFFFFFFF)
        h = _scan_hash(hi, lo, seed)
        nb = nb0
        while nb * width * 4 <= max(PROBE_TABLE_MAX_BYTES, nb0 * width * 4):
            b = (h & np.uint32(nb - 1)).astype(np.int64)
            counts = np.bincount(b, minlength=nb)
            if counts.max(initial=0) <= S_:
                # lazily-zeroed rows; empty slots are all-zero (the
                # stored ~key-hi of a real key is never 0, see class doc)
                rows = np.zeros((nb, width), np.uint32)
                order = np.argsort(b, kind="stable")
                bs = b[order]
                start = np.zeros(nb + 1, np.int64)
                np.cumsum(counts, out=start[1:])
                slot = np.arange(nk) - start[bs]
                rows[bs, slot] = ~hi[order]
                rows[bs, S_ + slot] = lo[order]
                rows[bs, 2 * S_ + slot] = bits0[order]
                if window == 4:
                    rows[bs, 3 * S_ + slot] = bits1[order]
                return ProbeTable(rows, nb, int(seed), window)
            nb <<= 1
    if window == 4:
        _log.warning(
            "window-4 probe table exceeded PROBE_TABLE_MAX_BYTES while "
            "resolving bucket overflow; downgrading to window 3"
        )
        return build_probe_table(s_keys, k1, window=3)
    _log.warning(
        "probe table skipped: bucket overflow unresolvable within "
        "PROBE_TABLE_MAX_BYTES; anchor scan falls back to per-position "
        "membership probes"
    )
    return None


def pt_member_host(pt: ProbeTable, hi, lo) -> np.ndarray:
    """Numpy mirror of the device self-membership bit (testing aid)."""
    S_ = PT_SLOTS
    hi = np.asarray(hi, np.uint32)
    lo = np.asarray(lo, np.uint32)
    b = (_scan_hash(hi, lo, np.uint32(pt.seed))
         & np.uint32(pt.n_buckets - 1)).astype(np.int64)
    row = pt.rows[b]
    ok = (row[..., 0:S_] == ~hi[..., None]) & (
        row[..., S_ : 2 * S_] == lo[..., None]
    )
    w0 = np.where(ok, row[..., 2 * S_ : 3 * S_], 0).sum(
        axis=-1
    ).astype(np.uint32)
    return (w0 & 1).astype(bool)


def st_find_host(tbl: ScanTable, hi, lo) -> np.ndarray:
    """Numpy mirror of the device lookup: flat slot (bucket*slots +
    s) per query, or -1."""
    S_ = tbl.slots
    hi = np.asarray(hi, np.uint32)
    lo = np.asarray(lo, np.uint32)
    b = (_scan_hash(hi, lo, np.uint32(tbl.seed))
         & np.uint32(tbl.n_buckets - 1)).astype(np.int64)
    row = tbl.keys[b]                                   # [..., 2*S_]
    ok = (row[..., 0:S_] == hi[..., None]) & (
        row[..., S_ : 2 * S_] == lo[..., None]
    )
    s = ok.argmax(axis=-1)
    return np.where(ok.any(axis=-1), b * S_ + s, -1)


def pack_words(codes: np.ndarray) -> np.ndarray:
    """2-bit codes -> uint32 words, 16 bases per word, base i at bit
    2*(i%16) of word i//16; padded with 2 guard words so device funnel
    shifts can always read word w+1."""
    codes = np.asarray(codes, np.uint8)
    n = len(codes)
    nw = (n + 15) >> 4
    padded = np.zeros(nw * 16, np.uint8)
    padded[:n] = codes
    lanes = padded.reshape(nw, 16).astype(np.uint32)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    words = (lanes << shifts).sum(axis=1, dtype=np.uint32)
    return np.concatenate([words, np.zeros(2, np.uint32)])


CHUNK_BASES = 128          # pool chunk granularity (power of two)

# embedded-sequence umeta rows (see build_device_index): skip embedding
# for graphs with very long unitigs or where the widened table would
# dominate HBM; the engine then uses the pool-chunk gather path.
EMBED_CAP_BASES = 1024
EMBED_CAP_BYTES = 2 << 30


def build_pool_rows(pool_words: np.ndarray, n_bases: int,
                    halo_bases: int) -> np.ndarray:
    """Overlapping fixed-width chunk rows over a packed base pool.

    Row r covers bases [128r, 128r + 128 + halo): any window of up to
    `halo` bases starting anywhere inside chunk r lies fully within row
    r, so a windowed compare is ONE row gather + an in-register shift
    instead of a word-granular element gather.  +1 trailing word so funnel shifts can read word j+1.
    """
    n_chunks = max(1, (n_bases + CHUNK_BASES - 1) // CHUNK_BASES)
    row_words = (CHUNK_BASES + halo_bases) // 16 + 1
    idx = (CHUNK_BASES // 16) * np.arange(n_chunks)[:, None] + np.arange(
        row_words
    )[None, :]
    ok = idx < len(pool_words)
    return np.where(ok, pool_words[np.clip(idx, 0, len(pool_words) - 1)], 0)


def build_rc_pool(pool: np.ndarray, offsets: np.ndarray,
                  lengths: np.ndarray) -> np.ndarray:
    """Per-unitig reverse-complemented pool at identical offsets:
    rc_pool[uoff[u] : uoff[u]+ulen[u]] == RC(unitig u).  Window
    arithmetic for RC candidates then reuses the forward offsets."""
    P = len(pool)
    if P == 0:
        return pool.copy()
    owner = np.repeat(np.arange(len(lengths)), lengths.astype(np.int64))
    src = (2 * offsets[owner].astype(np.int64)
           + lengths[owner].astype(np.int64) - 1) - np.arange(P)
    return (3 - pool[src]).astype(np.uint8)


@dataclass
class DeviceIndex:
    """Everything the device engine needs, as flat numpy arrays (the
    runner ships them to device once and reuses)."""

    k: int
    # unitig pool
    pool: np.ndarray          # uint8 [P]
    pool_words: np.ndarray    # uint32 [ceil(P/16)+2]; base i at bits 2*(i%16)
    uoff: np.ndarray          # int32 [U+1]
    ulen: np.ndarray          # int32 [U+1]
    # extremity (k-1)-mers and their reverse complements, split u32
    ubeg_hi: np.ndarray
    ubeg_lo: np.ndarray
    uend_hi: np.ndarray
    uend_lo: np.ndarray
    rcbeg_hi: np.ndarray
    rcbeg_lo: np.ndarray
    rcend_hi: np.ndarray
    rcend_lo: np.ndarray
    max_ulen: int
    # dog-mode anchor table: canonical k-mer -> (uid, upos, ucanon)
    # where ucanon says the unitig's k-mer at upos IS the canonical key
    # (the engine derives anchor orientation by comparing it with the
    # read k-mer's own canonicity, equivalent to the reference's string
    # compare at alignerGreedy.cpp:75-82)
    anchor_scan: ScanTable | None = None
    anchor_mphf: "MphfAnchors | None" = None  # compact large-keyset form
    # ---- row-gather layout (row-gather-only access patterns) ----
    scan_tbl: ScanTable | None = None   # junction keys, 1 gather/lookup
    umeta: np.ndarray | None = None     # int32 [U+1, 16] per-unitig row
    pool_rows: np.ndarray | None = None  # uint32 [2*n_chunks, row_words]
    n_chunks: int = 0                   # fwd rows; rc rows follow
    halo_bases: int = 0                 # max window a chunk row covers
    probe_tbl: ProbeTable | None = None  # W-position closure anchor scan
    mphf_junction: MphfJunction | None = None  # compact layout (mphf)
    # graph-order unitig renumbering (DBGTPU_RENUMBER=1): device tables
    # use BFS-order ids so a junction's <=4 candidates sit in adjacent
    # umeta rows; id_inv maps device ids back to file-order ids (the
    # runner translates paths on drain, so output bytes are unchanged)
    id_inv: np.ndarray | None = None     # int32 [U+1], id_inv[new]=orig


@dataclass
class MphfJunction:
    """Compact MPHF-backed junction index (--index-layout mphf).

    The reference's index IS an MPHF (BooPHF, aligner.cpp:449-460);
    dbgtpu's default ScanTable trades device memory (~320 B/key) for
    one-gather lookups.  This layout is the >HBM-graph option:
    ~3 bits/key of level bitvectors (index.mphf, BBHash algorithm)
    plus a DENSE 40 B/key slot table `jrows` [n, 10] uint32 =
    (key-hi, key-lo, 8 junction ID slots) at the MPHF slot of each key
    — ~8x smaller than the ScanTable.  Lookups verify the stored key,
    the reference's own aliasing defense (aligner.cpp:158-169); cost is
    n_levels bit-test gathers + one row gather instead of one fused
    gather, the documented speed/space tradeoff."""

    mphf: "object"                # index.mphf.MPHF
    jrows: np.ndarray             # uint32 [n_keys, 10]


@dataclass
class MphfAnchors:
    """Compact MPHF-backed dog-mode anchor table.

    The reference's anchor index IS an MPHF (anchorsMPHF +
    anchorsPosition, aligner.cpp:434-443): the dog keyset is every
    k-mer of every unitig (~34M at 1M unitigs), where the dense
    ScanTable costs ~150 B/key (5.1 GB of HBM and a multi-GB host
    build); this layout is ~22 bits/key of level bitvectors plus a
    20 B/key verify/value row — ~0.7 GB, with n_levels+1 gathers per
    lookup instead of one."""

    mphf: "object"                # index.mphf.MPHF
    arows: np.ndarray             # uint32 [n_keys, 5] =
    #                               (key-hi, key-lo, uid, upos, ucanon)


# dog keysets at or above this size take the MPHF anchor layout
# (below it, the one-gather ScanTable wins and stays small)
ANCHOR_MPHF_MIN = int(os.environ.get("DBGTPU_ANCHOR_MPHF_MIN",
                                     4_000_000))


def build_mphf_anchors(keys: np.ndarray, vals: np.ndarray) -> MphfAnchors:
    from .mphf import build_mphf

    keys = np.asarray(keys, np.uint64)
    vals = np.asarray(vals, np.int32)
    m = build_mphf(keys, gamma=16.0, max_levels=3)
    slots = m.lookup(keys)
    hi, lo = split64(keys)
    arows = np.zeros((len(keys), 5), np.uint32)
    arows[slots, 0] = hi
    arows[slots, 1] = lo
    arows[slots, 2:5] = vals.view(np.uint32)
    return MphfAnchors(m, arows)


def build_mphf_junction(keys: np.ndarray, vals: np.ndarray) -> MphfJunction:
    from .mphf import build_mphf

    keys = np.asarray(keys, np.uint64)
    vals = np.asarray(vals, np.int32)
    # gamma mirrors the reference's gammaFactor=10 (aligner.h:94) but
    # is a device latency knob here, not just a build-speed one: the
    # device lookup pays one row gather per LEVEL for every query
    # (unrolled, no early exit), so a short fat cascade beats a long
    # lean one.  gamma=16 with the cascade capped at 3 levels resolves
    # all but ~1k of 2M keys (the exact final table catches the tail)
    # at ~22 bits/key — ~5.6 MB next to the 80 MB jrows slot table it
    # indexes, for 5 gathers/lookup instead of 13+ at the former
    # space-lean gamma=2
    m = build_mphf(keys, gamma=16.0, max_levels=3)
    slots = m.lookup(keys)
    hi, lo = split64(keys)
    jrows = np.zeros((len(keys), 10), np.uint32)
    jrows[slots, 0] = hi
    jrows[slots, 1] = lo
    jrows[slots, 2:10] = vals.view(np.uint32)
    return MphfJunction(m, jrows)


def hbm_report(di: DeviceIndex) -> dict:
    """Per-artifact device-resident bytes of the index (what
    engine.core.index_to_device ships to device memory), for
    --json-summary capacity planning."""
    if di.scan_tbl is not None:
        jbytes = int(di.scan_tbl.keys.nbytes + di.scan_tbl.vals.nbytes)
    elif di.mphf_junction is not None:
        mj = di.mphf_junction
        jbytes = int(
            mj.jrows.nbytes + (mj.mphf.total_bits() + 7) // 8
        )
    else:
        jbytes = 0
    rep = {
        "junction_table": jbytes,
        "umeta": int(di.umeta.nbytes) if di.umeta is not None else 0,
        "pool_rows": int(di.pool_rows.nbytes)
        if di.pool_rows is not None else 0,
        "probe_table": int(di.probe_tbl.rows.nbytes)
        if di.probe_tbl is not None else 0,
        "anchor_table": (
            int(di.anchor_scan.keys.nbytes + di.anchor_scan.vals.nbytes)
            if di.anchor_scan is not None
            else int(di.anchor_mphf.arows.nbytes
                     + (di.anchor_mphf.mphf.total_bits() + 7) // 8)
            if di.anchor_mphf is not None else 0
        ),
    }
    rep["total"] = sum(rep.values())
    return rep


def _renumber_perm(jvals: np.ndarray, n_unitigs: int) -> np.ndarray:
    """BFS order over the junction co-occurrence graph.

    Unitigs stored in the same junction slot row are exactly the <=4
    candidates a walk step gathers together (and walk transitions move
    between row-sharing unitigs), so BFS over "shares a junction row"
    makes graph-adjacent unitigs adjacent umeta rows in device memory
    (a walk-gather locality experiment).  Returns perm
    int32 [U+1] with perm[orig] = new id (perm[0] = 0: the reference's
    1-based sentinel, aligner.cpp:408, is preserved).  Slot ORDER
    inside each row is untouched, so the engine's earliest-slot
    tie-breaks — and therefore the selected paths — are identical."""
    U = n_unitigs
    v = jvals.astype(np.int64)
    nz = v > 0
    has = nz.any(axis=1)
    first = np.zeros(len(v), np.int64)
    first[has] = v[has][np.arange(has.sum()), nz[has].argmax(axis=1)]
    src = np.repeat(first, v.shape[1])
    dst = v.ravel()
    m = (dst > 0) & (src > 0) & (src != dst)
    es = np.concatenate([src[m], dst[m]])
    et = np.concatenate([dst[m], src[m]])
    order = np.argsort(es, kind="stable")
    s_sorted = es[order]
    t_sorted = et[order]
    indptr = np.zeros(U + 2, np.int64)
    np.add.at(indptr, s_sorted + 1, 1)
    np.cumsum(indptr, out=indptr)

    from collections import deque

    visited = np.zeros(U + 1, bool)
    visited[0] = True
    out = np.empty(U + 1, np.int64)
    out[0] = 0
    pos = 1
    for s0 in range(1, U + 1):
        if visited[s0]:
            continue
        visited[s0] = True
        dq = deque([s0])
        while dq:
            u = dq.popleft()
            out[pos] = u
            pos += 1
            for t in t_sorted[indptr[u] : indptr[u + 1]]:
                if not visited[t]:
                    visited[t] = True
                    dq.append(int(t))
    perm = np.zeros(U + 1, np.int32)
    perm[out] = np.arange(U + 1, dtype=np.int32)
    return perm


def build_device_index(
    g: UnitigGraph, max_read_len: int = 256, layout: str = "scan",
    renumber: bool | None = None,
) -> DeviceIndex:
    from ..seq import rcb

    if layout not in ("scan", "mphf"):
        raise ValueError(f"unknown index layout {layout!r}")
    k1 = g.k - 1
    if renumber is None:
        renumber = bool(int(os.environ.get("DBGTPU_RENUMBER", "0")))
    if g.jkeys is not None:
        keys, vals = g.jkeys, g.jvals    # vectorized build.py slot table
    else:
        # graphs loaded from old persisted npz carry only the dicts
        all_keys = sorted(set(g.left) | set(g.right))
        keys = np.array(all_keys, dtype=np.uint64)
        vals = np.zeros((len(all_keys), 8), np.int32)
        for i, key in enumerate(all_keys):
            for j, uid in enumerate(g.left.get(key, [])[:4]):
                vals[i, j] = uid
            for j, uid in enumerate(g.right.get(key, [])[:4]):
                vals[i, 4 + j] = uid
    id_inv = None
    perm = None
    ubeg_src, uend_src = g.ubeg, g.uend
    uoff_src, ulen_src = g.offsets, g.lengths
    if renumber and g.n_unitigs > 1:
        perm = _renumber_perm(np.asarray(vals, np.int64), g.n_unitigs)
        inv = np.zeros_like(perm)
        inv[perm] = np.arange(len(perm), dtype=np.int32)
        id_inv = inv
        vals = np.where(
            vals > 0, perm[np.maximum(vals, 0)], 0
        ).astype(np.int32)
        # per-unitig arrays reordered to the new ids; the pool itself
        # (and its offsets) stays in file order — only metadata/seq
        # ROWS move, which is where the walk gathers land
        ubeg_src, uend_src = g.ubeg[inv], g.uend[inv]
        uoff_src, ulen_src = g.offsets[inv], g.lengths[inv]

    import time as _time

    # index-build phase log (the reference's BooPHF prints a build
    # progress/ETA bar, BooPHF.h:51-202; a 1M-unitig build here runs
    # ~50 s) — surfaced when the caller enables INFO logging, which the
    # CLI ties to --progress
    t0 = _time.monotonic()
    mphf_junction = None
    if layout == "mphf":
        scan_tbl = None
        mphf_junction = build_mphf_junction(keys, vals)
    else:
        scan_tbl = build_scan_table(keys, vals)
    _log.info("index build: junction table (%d keys) %.1fs",
              len(keys), _time.monotonic() - t0)
    t0 = _time.monotonic()
    probe_tbl = build_probe_table(keys, k1)
    _log.info("index build: closure probe table %s %.1fs",
              f"(window {probe_tbl.window})" if probe_tbl else "(skipped)",
              _time.monotonic() - t0)
    t0 = _time.monotonic()

    rcbeg = rcb(ubeg_src, k1)
    rcend = rcb(uend_src, k1)
    ubeg_hi, ubeg_lo = split64(ubeg_src)
    uend_hi, uend_lo = split64(uend_src)
    rcbeg_hi, rcbeg_lo = split64(rcbeg)
    rcend_hi, rcend_lo = split64(rcend)

    anchor_scan = None
    anchor_mphf = None
    if g.dog_mode and g.anchors:
        akeys = g.anchors.keys                     # uint64 [n], sorted
        av = g.anchors.vals.astype(np.int64)       # [n, 2]
        n_anchor = len(akeys)
        # ucanon = (the unitig k-mer at the anchored offset equals the
        # canonical key).  The graph build stores it on the AnchorView
        # (the k-mer array is in hand there); graphs loaded from older
        # npz files recompute it with ONE kmers_of pass over the pool
        # + a row gather (the former per-anchor 31-column gather-sum
        # was the dominant host cost of the 1M-unitig dog build)
        if g.anchors.ucanon is not None:
            ucanon = np.asarray(g.anchors.ucanon, bool)
        else:
            from ..seq import kmers_of

            pos = g.offsets[av[:, 0]] + av[:, 1]
            ucanon = kmers_of(g.pool, g.k)[pos] == akeys
        auid = av[:, 0] if perm is None else perm[av[:, 0]]
        avals = np.column_stack(
            [auid, av[:, 1], ucanon.astype(np.int64)]
        ).astype(np.int32)
        if n_anchor >= ANCHOR_MPHF_MIN or layout == "mphf":
            anchor_mphf = build_mphf_anchors(akeys, avals)
        else:
            anchor_scan = build_scan_table(akeys, avals)

    uoff = uoff_src.astype(np.int32)
    ulen = ulen_src.astype(np.int32)
    U1 = len(uoff)
    max_ulen = int(g.lengths.max(initial=0))

    # Embedded-sequence rows: append each unitig's packed bases (fwd then
    # rc) to its metadata row, so the junction step's candidate window
    # comes from the SAME row gather that fetches the metadata — the
    # pool-chunk gather (4 rows/read/step, the single largest gather in
    # the mapping loop) disappears.  Only when every unitig fits (engine
    # trusts seq columns to cover max_ulen) and the table stays small.
    sw = (max_ulen + 15) // 16 + 1 if max_ulen else 0
    if sw:
        # row-width cliff: on ~1M-row tables the earlier machine's row
        # gather ran ~4x faster at >= 256-byte rows than below (a
        # different emitter took over), and the candidate-meta gather
        # is the single largest walk cost on big graphs — pad the seq
        # word columns until the row reaches 64 int32 cols.  Whether
        # the pad pays on a GPU is not yet measured.  The pad columns
        # are zeros past each unitig's length, which the engine's
        # window masks never count.
        sw = max(sw, 24)
    # the byte cap is evaluated with the PADDED width: on many-unitig /
    # short-unitig graphs the pad dominates the row, and checking the
    # unpadded width would admit tables ~3.5x over EMBED_CAP_BYTES
    embed = (
        0 < max_ulen <= EMBED_CAP_BASES
        and U1 * (16 + 2 * sw) * 4 <= EMBED_CAP_BYTES
    )
    umeta = np.zeros((U1, 16 + (2 * sw if embed else 0)), np.int32)
    for c, a in enumerate(
        (uoff, ulen, ubeg_hi, ubeg_lo, uend_hi, uend_lo,
         rcbeg_hi, rcbeg_lo, rcend_hi, rcend_lo)
    ):
        umeta[:, c] = a.view(np.int32) if a.dtype == np.uint32 else a
    rc_pool = build_rc_pool(g.pool, g.offsets, g.lengths)
    if embed:
        # chunked packing: temporaries are [CH, 16*sw] int32 (~40 MB at
        # CH=64k, sw=160) instead of one [U1, 16*sw] int64 blow-up that
        # can reach ~25-30x the final column size near the table cap
        shifts = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
        cols = np.arange(16 * sw, dtype=np.int32)[None, :]
        CH = 1 << 16
        for r0 in range(0, U1, CH):
            r1 = min(r0 + CH, U1)
            base_idx = uoff[r0:r1, None] + cols
            inb = cols < ulen[r0:r1, None]
            np.clip(base_idx, 0, max(len(g.pool) - 1, 0), out=base_idx)
            for col0, src in ((16, g.pool), (16 + sw, rc_pool)):
                if len(src) == 0:
                    continue
                b = np.where(inb, src[base_idx], 0).astype(np.uint32)
                words = (b.reshape(r1 - r0, sw, 16) << shifts).sum(
                    axis=2, dtype=np.uint32
                )
                umeta[r0:r1, col0 : col0 + sw] = words.view(np.int32)

    halo = max(256, ((max_read_len + 15) // 16) * 16)
    pool_words = pack_words(g.pool)
    if embed:
        # the engine's candidate windows come entirely from the embedded
        # umeta columns (core._window_miss SW > 0 branch is chosen at
        # trace time), so chunk rows would be dead HBM weight: ship a
        # 1-row placeholder to keep IndexArrays' shape contract
        row_words = (CHUNK_BASES + halo) // 16 + 1
        fwd_rows = np.zeros((1, row_words), np.uint32)
        rc_rows = np.zeros((0, row_words), np.uint32)
    else:
        fwd_rows = build_pool_rows(pool_words, len(g.pool), halo)
        rc_rows = build_pool_rows(pack_words(rc_pool), len(g.pool), halo)

    _log.info("index build: unitig metadata/pool rows %.1fs "
              "(embed=%s)", _time.monotonic() - t0, embed)
    return DeviceIndex(
        k=g.k,
        pool=g.pool,
        pool_words=pool_words,
        uoff=uoff,
        ulen=ulen,
        ubeg_hi=ubeg_hi, ubeg_lo=ubeg_lo,
        uend_hi=uend_hi, uend_lo=uend_lo,
        rcbeg_hi=rcbeg_hi, rcbeg_lo=rcbeg_lo,
        rcend_hi=rcend_hi, rcend_lo=rcend_lo,
        max_ulen=max_ulen,
        anchor_scan=anchor_scan,
        anchor_mphf=anchor_mphf,
        scan_tbl=scan_tbl,
        umeta=umeta,
        pool_rows=np.concatenate([fwd_rows, rc_rows], axis=0),
        n_chunks=fwd_rows.shape[0],
        halo_bases=halo,
        probe_tbl=probe_tbl,
        mphf_junction=mphf_junction,
        id_inv=id_inv,
    )
