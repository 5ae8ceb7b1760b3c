"""Batched greedy alignment engine (JAX, jit-compiled).

Design (not a translation of the reference's recursion):
  - a batch of B reads advances in lockstep through a `lax.while_loop`;
    each iteration performs ONE junction step for every read that is
    mid-walk, plus cheap elementwise bookkeeping (anchor fetch, phase
    transitions, orientation switch),
  - per-read state machine phases: FETCH (pick next anchor or finish),
    LEFT (extend toward read start), RIGHT_FIRST (anchor step of the
    right extension, junction chars trusted), RIGHT_CONT (subsequent
    right steps, junction chars compared), DONE,
  - per junction step: one single-hash bucket lookup -> up to 4
    candidate unitigs -> windowed Hamming compare [B, 4, W] against the
    read -> argmin with earliest-index tie-break (equivalent to the
    reference's selection logic, see model.py) -> state update,
  - kmers are (hi, lo) uint32 pairs (engine/kmer32.py), so the engine
    runs without 64-bit integers,
  - everything is static-shaped; reads that finish early are masked.

Memory-access layout: every hot lookup is a gather of ROWS — a [B]
index vector into an [N, W] wide-row table — and every windowed
extraction is an elementwise masked log-roll + funnel shift, never a
per-element gather (1D tables, 3D index arrays, take_along_axis).  The
layout was chosen for a machine whose element gathers were slow;
whether it pays on a GPU is an open benchmark question:
  - junction membership/lookup: ONE row gather into the single-hash
    8-slot ScanTable ([nb, 16] key rows),
  - candidate metadata: row gathers into umeta [U+1, 16],
  - sequence windows: row gathers into overlapping 128-base pool chunk
    rows (fwd + RC copies), aligned in-register,
  - RC read images / mirrored anchor scans: flip + masked log-roll.

Semantics are cross-checked against dbgtpu.model (the executable spec)
and transitively against the compiled reference binary.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (
    STATUS_ALIGNED_FWD,
    STATUS_ALIGNED_RC,
    STATUS_FAILED,
    STATUS_NO_OVERLAP_FWD,
    STATUS_RC_NO_OVERLAP,
)
from .kmer32 import mix32, pair_le, rcb_pair, rev_pair

# phases
_FETCH, _LEFT, _RFIRST, _RCONT, _DONE = 0, 1, 2, 3, 4
_BIG = np.int32(1 << 30)
_LANE_LO = np.uint32(0x55555555)
_FULL32 = np.uint32(0xFFFFFFFF)
_CHUNK_SHIFT = 7            # log2(index.device.CHUNK_BASES)


def _pack_rows(vals32, out_words: int = 0):
    """[B, L] uint32 2-bit values -> [B, W] uint32 words, value at
    position i in bits 2*(i%16) of word i//16; zero-padded to
    `out_words` (>= ceil(L/16)+1) so rolled windows stay in bounds."""
    B, L = vals32.shape
    Lw = (L + 15) // 16
    pad = Lw * 16 - L
    if pad:
        vals32 = jnp.pad(vals32, ((0, 0), (0, pad)))
    lanes = vals32.reshape(B, Lw, 16)
    shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    words = jnp.sum(lanes << shifts, axis=2, dtype=jnp.uint32)
    out_words = max(out_words, Lw + 1)
    return jnp.concatenate(
        [words, jnp.zeros((B, out_words - Lw), jnp.uint32)], axis=1
    )


def _funnel(w0, w1, sh):
    """Per-lane funnel shift: (w0 >> sh) | (w1 << (32-sh)); sh is an
    even uint32 in [0, 30] (sh == 0 handled without the UB shift)."""
    hi = jnp.where(sh > 0, w1 << ((jnp.uint32(32) - sh) & jnp.uint32(31)),
                   jnp.uint32(0))
    return (w0 >> sh) | hi


def _roll_left(x, sh, max_sh: int):
    """Per-row left roll of the last axis by `sh` (broadcasts over
    x[..., W]): log2(max_sh) masked static rolls — pure elementwise
    work in place of take_along_axis windowing.
    Wrapped-around tail values are garbage; callers mask beyond the
    window they extract."""
    sh = sh.astype(jnp.int32)
    bit, amt = 0, 1
    while amt <= max_sh:
        cond = ((sh >> bit) & 1) == 1
        x = jnp.where(cond[..., None], jnp.roll(x, -amt, axis=-1), x)
        bit += 1
        amt <<= 1
    return x


class IndexArrays(NamedTuple):
    """Device-side view of DeviceIndex (all jnp arrays)."""

    st_fused: jax.Array     # uint32 [nb, 10*S] S=ST_SLOTS slot keys
    #                         (hi xS | lo xS) ++ S slots x 8 vals
    #                         (junction lookup = ONE gather: key compare
    #                         and value select from the same row;
    #                         membership reads cols 0:2S)
    st_seed: jax.Array      # uint32 [] bucket-hash seed
    umeta: jax.Array        # int32  [U+1, 16] per-unitig metadata row
    pool_rows: jax.Array    # uint32 [2*nc, RW] fwd then rc chunk rows
    n_chunks: jax.Array     # int32  [] fwd row count (rc rows follow)
    pt_rows: jax.Array      # uint32 [nbp, 32|24] closure probe rows
    #                         (width 32 = window 4, 24 = window 3;
    #                         (0, 32) when absent -> per-position scan
    #                         fallback)
    pt_seed: jax.Array      # uint32 [] probe bucket-hash seed
    at_fused: jax.Array     # uint32 [nba, 40] dog-mode anchor rows: 8
    #                         slot keys (hi x8 | lo x8) ++ 8 slots x 3
    #                         vals (uid, upos, ucanon); (0, 40) when the
    #                         index was not built in dog mode
    at_seed: jax.Array      # uint32 [] anchor bucket-hash seed
    # ---- compact MPHF junction layout (--index-layout mphf); empty
    # placeholders under the default scan layout.  The static level
    # structure travels separately as the hashable `jl_meta` arg.
    mph_rows: jax.Array     # uint32 [ng, 5] fused 128-bit rank groups:
    #                         col 0 = rank_base + sample, cols 1:5 the
    #                         4 level-bitvector words of the group (one
    #                         row gather answers bit-test AND rank,
    #                         in place of ~5 element gathers per level
    #                         per query)
    mph_jrows: jax.Array    # uint32 [n, 10] (khi, klo, 8 ID slots)
    mph_f: jax.Array        # uint32 [nbf, 12] final-level exact table
    #                         (khi x4 | klo x4 | slot-val x4)
    # ---- compact MPHF dog-mode anchor layout (large keysets); static
    # structure travels as the `al_meta` arg
    amph_rows: jax.Array    # uint32 [ng, 5] fused rank groups
    amph_arows: jax.Array   # uint32 [n, 5] (khi, klo, uid, upos, ucanon)
    amph_f: jax.Array       # uint32 [nbf, 12] final-level exact table


# umeta column layout (index.device.build_device_index)
_C_UOFF, _C_ULEN = 0, 1
_C_BEG_HI, _C_BEG_LO, _C_END_HI, _C_END_LO = 2, 3, 4, 5
_C_RCB_HI, _C_RCB_LO, _C_RCE_HI, _C_RCE_LO = 6, 7, 8, 9


def _fuse_scan_table(t) -> np.ndarray:
    """ScanTable -> fused [nb, 16 + 4*V] rows (keys ++ slot values), so
    key compare and value select ride ONE row gather."""
    nb = t.keys.shape[0]
    return np.concatenate(
        [t.keys, t.vals.reshape(nb, -1).view(np.uint32)], axis=1
    )


def _fuse_mphf(m):
    """MPHF -> (fused rank-group rows [ng, 5], final table [nbf, 12]):
    each 128-bit rank group packs rank_base+sample and its 4 level
    words into ONE row (a level lookup is one row gather; the
    words/samples element-gather formulation ran near-scalar).  Row
    index for level lvl = sample_off[lvl] + (w>>2) — rows and rank
    samples share the 4-word granularity, so the existing sample
    offsets ARE the row offsets."""
    ft = m.final_tbl
    if ft is not None:
        nbf = ft.n_buckets
        mph_f = np.concatenate(
            [ft.khi, ft.klo, ft.vals.reshape(nbf, 4).view(np.uint32)],
            axis=1,
        )
    else:
        mph_f = np.zeros((0, 12), np.uint32)
    rows_parts = []
    for lvl in range(m.n_levels):
        w = m.words[m.word_off[lvl] : m.word_off[lvl + 1]]
        s = m.samples[m.sample_off[lvl] : m.sample_off[lvl + 1]]
        ng = len(s)
        wp = np.zeros(ng * 4, np.uint32)
        wp[: len(w)] = w
        r = np.zeros((ng, 5), np.uint32)
        r[:, 0] = (
            s.astype(np.int64) + int(m.rank_base[lvl])
        ).astype(np.uint32)
        r[:, 1:5] = wp.reshape(ng, 4)
        rows_parts.append(r)
    mph_rows = (
        np.concatenate(rows_parts) if rows_parts
        else np.zeros((0, 5), np.uint32)
    )
    return mph_rows, mph_f


def index_to_device(di) -> IndexArrays:
    """DeviceIndex (numpy) -> IndexArrays (jnp), memoized on `di`.

    The memo matters: the index H2D is the single largest transfer of a
    run (the probe table alone can be hundreds of MB), and the runner
    calls this per file/batch group — without the cache every pipeline
    invocation re-uploaded the whole index."""
    cached = getattr(di, "_ix_arrays", None)
    if cached is not None:
        return cached
    t = di.scan_tbl
    pt = getattr(di, "probe_tbl", None)
    at = getattr(di, "anchor_scan", None)
    mj = getattr(di, "mphf_junction", None)
    if mj is not None:
        mph_rows, mph_f = _fuse_mphf(mj.mphf)
        mph = dict(
            mph_rows=jnp.asarray(mph_rows),
            mph_jrows=jnp.asarray(mj.jrows),
            mph_f=jnp.asarray(mph_f),
        )
    else:
        mph = dict(
            mph_rows=jnp.zeros((0, 5), jnp.uint32),
            mph_jrows=jnp.zeros((0, 10), jnp.uint32),
            mph_f=jnp.zeros((0, 12), jnp.uint32),
        )
    ma = getattr(di, "anchor_mphf", None)
    if ma is not None:
        amph_rows, amph_f = _fuse_mphf(ma.mphf)
        mph.update(
            amph_rows=jnp.asarray(amph_rows),
            amph_arows=jnp.asarray(ma.arows),
            amph_f=jnp.asarray(amph_f),
        )
    else:
        mph.update(
            amph_rows=jnp.zeros((0, 5), jnp.uint32),
            amph_arows=jnp.zeros((0, 5), jnp.uint32),
            amph_f=jnp.zeros((0, 12), jnp.uint32),
        )
    ix = IndexArrays(
        st_fused=(jnp.asarray(_fuse_scan_table(t)) if t is not None
                  else jnp.zeros((0, 320), jnp.uint32)),
        st_seed=jnp.uint32(t.seed if t is not None else 0),
        umeta=jnp.asarray(di.umeta),
        pool_rows=jnp.asarray(di.pool_rows),
        n_chunks=jnp.int32(di.n_chunks),
        pt_rows=(jnp.asarray(pt.rows) if pt is not None
                 else jnp.zeros((0, 32), jnp.uint32)),
        pt_seed=jnp.uint32(pt.seed if pt is not None else 0),
        at_fused=(jnp.asarray(_fuse_scan_table(at)) if at is not None
                  else jnp.zeros((0, 160), jnp.uint32)),
        at_seed=jnp.uint32(at.seed if at is not None else 0),
        **mph,
    )
    try:
        di._ix_arrays = ix
    except AttributeError:
        pass
    return ix


def _mphf_meta(m):
    return (
        m.n_levels,
        tuple(int(x) for x in m.mask),
        tuple(int(x) for x in m.word_off),
        tuple(int(x) for x in m.sample_off),
        tuple(int(x) for x in m.rank_base),
        m.final_tbl is not None,
        int(m.final_tbl.n_buckets) if m.final_tbl is not None else 0,
    )


def jl_meta_of(di):
    """Hashable static descriptor of the MPHF junction layout (None
    under the default scan layout); pass as align_batch*'s jl_meta."""
    mj = getattr(di, "mphf_junction", None)
    return None if mj is None else _mphf_meta(mj.mphf)


def al_meta_of(di):
    """Hashable static descriptor of the MPHF anchor layout (None when
    the dog anchor table is the ScanTable or absent)."""
    ma = getattr(di, "anchor_mphf", None)
    return None if ma is None else _mphf_meta(ma.mphf)


def _mphf_slot(ix: IndexArrays, jl_meta, qhi, qlo):
    """Device MPHF lookup against the junction-layout IndexArrays
    fields; see _mphf_slot_arrays."""
    return _mphf_slot_arrays(ix.mph_rows, ix.mph_f, jl_meta, qhi, qlo)


def _mphf_slot_arrays(rows, frows, jl_meta, qhi, qlo):
    """Device MPHF lookup (any query shape): ONE fused-row gather per
    level (`rows` packs rank_base+sample and the 4 words of each
    128-bit group) + the exact final table `frows` — bit-test, rank
    popcounts and the sample all come out of the same row, where the
    former words/samples formulation paid ~5 element gathers per level
    per query.  Returns int32 slots, -1 = not
    found (semantics of index.mphf.device_lookup)."""
    from ..index.mphf import _RANK_STRIDE, _level_hash
    from .kmer32 import mix32b

    (n_levels, masks, woffs, soffs, rbases, has_final, final_nb) = jl_meta
    res = jnp.full(qhi.shape, -1, jnp.int32)
    for lvl in range(n_levels):
        pos = (_level_hash(qhi, qlo, lvl)
               & jnp.uint32(masks[lvl])).astype(jnp.int32)
        w = pos >> 5
        row = rows[soffs[lvl] + (w >> 2)]        # [..., 5]
        wsel = w & 3
        word = row[..., 1]
        for j in range(1, _RANK_STRIDE):
            word = jnp.where(wsel == j, row[..., 1 + j], word)
        bit = (word >> (pos & 31).astype(jnp.uint32)) & jnp.uint32(1)
        below = (jnp.uint32(1)
                 << (pos & 31).astype(jnp.uint32)) - jnp.uint32(1)
        rank = row[..., 0].astype(jnp.int32)
        for j in range(_RANK_STRIDE):
            wordj = row[..., 1 + j]
            pc_full = jax.lax.population_count(wordj).astype(jnp.int32)
            pc_part = jax.lax.population_count(
                wordj & below
            ).astype(jnp.int32)
            rank = rank + jnp.where(
                wsel > j, pc_full, jnp.where(wsel == j, pc_part, 0)
            )
        res = jnp.where(
            (res < 0) & (bit == jnp.uint32(1)), rank, res
        )
    if has_final:
        fm = jnp.uint32(final_nb - 1)
        fval = jnp.full(qhi.shape, -1, jnp.int32)
        for hfn in (mix32, mix32b):
            frow = frows[(hfn(qhi, qlo) & fm).astype(jnp.int32)]
            ok = (frow[..., 0:4] == qhi[..., None]) & (
                frow[..., 4:8] == qlo[..., None]
            )
            v = jnp.sum(
                jnp.where(ok, frow[..., 8:12], jnp.uint32(0)),
                axis=-1, dtype=jnp.uint32,
            ).astype(jnp.int32)
            fval = jnp.where(
                (fval < 0) & jnp.any(ok, axis=-1), v, fval
            )
        res = jnp.where(res < 0, fval, res)
    return res


def _sharded_rows(table_shard, b, axis: str):
    """Row gather from a bucket-range-sharded table (SURVEY §2.3
    index-parallelism): `table_shard` is this device's [nb/D, W] slice
    of the global [nb, W] table, `b` holds GLOBAL bucket ids for this
    device's queries.  all_gather the query ids over the mesh axis,
    answer the residents locally (zeros elsewhere), reduce-scatter the
    row answers back — every device ends with its own queries' rows
    while holding 1/D of the index in its memory.  The collectives run
    between the cards (all to all over NVLink on one host); this is the
    capacity-over-bandwidth trade for graphs exceeding one card's
    memory (the reference's answer was BooPHF compactness,
    BooPHF.h:825).
    """
    nb_local, W = table_shard.shape
    me = jax.lax.axis_index(axis)
    flatb = b.reshape(-1)
    allb = jax.lax.all_gather(flatb, axis, tiled=True)     # [D*Q]
    local = allb - me * nb_local
    mine = (local >= 0) & (local < nb_local)
    rows = table_shard[jnp.where(mine, local, 0)]
    rows = jnp.where(mine[:, None], rows, jnp.zeros((), table_shard.dtype))
    rows = jax.lax.psum_scatter(
        rows, axis, scatter_dimension=0, tiled=True
    )                                                       # [Q, W]
    return rows.reshape(b.shape + (W,))


def _junction_vals(ix: IndexArrays, jl_meta, qhi, qlo, shard_axis=None):
    """Junction lookup for canonical (k-1)-mers (any query shape):
    (found mask, vals8 int32 [..., 8] = 4 left + 4 right ID slots).
    Scan layout: ONE fused-row gather (key compare + masked row-sum
    value select).  MPHF layout: _mphf_slot + one jrows gather with the
    stored-key verify (aliasing defense, aligner.cpp:158-169).
    shard_axis: mesh axis name when st_fused is bucket-range sharded
    (each device holds nb/D rows; bucket ids here are GLOBAL, computed
    against the global bucket count)."""
    if jl_meta is None:
        S_ = ix.st_fused.shape[1] // 10   # slots/bucket (geometry-free)

        if shard_axis is not None:
            D = jax.lax.axis_size(shard_axis)
            nbm = jnp.uint32(ix.st_fused.shape[0] * D - 1)
            b = (mix32(qhi ^ ix.st_seed, qlo) & nbm).astype(jnp.int32)
            frow = _sharded_rows(ix.st_fused, b, shard_axis)
        else:
            nbm = jnp.uint32(ix.st_fused.shape[0] - 1)
            frow = ix.st_fused[
                (mix32(qhi ^ ix.st_seed, qlo) & nbm).astype(jnp.int32)
            ]
        ok = (frow[..., 0:S_] == qhi[..., None]) & (
            frow[..., S_ : 2 * S_] == qlo[..., None]
        )
        vals8 = jnp.sum(
            jnp.where(ok[..., None],
                      frow[..., 2 * S_ : 10 * S_].reshape(
                          frow.shape[:-1] + (S_, 8)),
                      jnp.uint32(0)),
            axis=-2, dtype=jnp.uint32,
        ).astype(jnp.int32)
        return jnp.any(ok, axis=-1), vals8
    slot = _mphf_slot(ix, jl_meta, qhi, qlo)
    row = ix.mph_jrows[jnp.maximum(slot, 0)]
    found = (slot >= 0) & (row[..., 0] == qhi) & (row[..., 1] == qlo)
    return found, row[..., 2:10].astype(jnp.int32)


def _st_member(ix: IndexArrays, qhi, qlo, jl_meta=None, shard_axis=None):
    """Junction keyset membership (scan or MPHF layout)."""
    if jl_meta is None:
        S_ = ix.st_fused.shape[1] // 10   # slots/bucket (geometry-free)

        if shard_axis is not None:
            D = jax.lax.axis_size(shard_axis)
            mask = jnp.uint32(ix.st_fused.shape[0] * D - 1)
            b = (mix32(qhi ^ ix.st_seed, qlo) & mask).astype(jnp.int32)
            row = _sharded_rows(ix.st_fused, b, shard_axis)
        else:
            nb = ix.st_fused.shape[0]
            mask = jnp.uint32(nb - 1)
            b = (mix32(qhi ^ ix.st_seed, qlo) & mask).astype(jnp.int32)
            row = ix.st_fused[b]             # [..., 10*S_]
        ok = (row[..., 0:S_] == qhi[..., None]) & (
            row[..., S_ : 2 * S_] == qlo[..., None]
        )
        return jnp.any(ok, axis=-1)
    found, _ = _junction_vals(ix, jl_meta, qhi, qlo)
    return found


def _st_member_positions(ix, qhi, qlo, jl_meta=None, shard_axis=None,
                         chunk: int = 8):
    """Per-position junction membership for [B, Lk]-shaped query scans.

    A direct row gather materializes a [B, Lk, 10*ST_SLOTS] temp — with
    the dense 320-col fused rows that is 8+ GB at B=64k —
    so the position axis is processed in lax.map chunks (temp bounded
    at [B, chunk, 320]).  The bucket-range-sharded layout needs the
    same chunking: _sharded_rows all_gathers the ids AND gathers a
    [B*D, ·, 320] row temp, so an unchunked [B, Lk] query is the same
    blow-up times the mesh size.  Chunking is mesh-safe there — the
    chunk count is static and identical on every device, so each
    lax.map step issues the same collectives on all shards.  Only the
    per-position fallback paths use this (no probe table / has-N
    reads); point lookups in the walk stay on the unchunked
    _st_member."""
    if jl_meta is not None:
        # mphf layout: level words + 10-col jrows (no row blow-up)
        return _st_member(ix, qhi, qlo, jl_meta, shard_axis)
    B, Lk = qhi.shape
    nch = (Lk + chunk - 1) // chunk
    pad = nch * chunk - Lk
    qh = jnp.pad(qhi, ((0, 0), (0, pad))).reshape(
        B, nch, chunk).transpose(1, 0, 2)
    ql = jnp.pad(qlo, ((0, 0), (0, pad))).reshape(
        B, nch, chunk).transpose(1, 0, 2)
    m = jax.lax.map(
        lambda c: _st_member(ix, c[0], c[1], None, shard_axis), (qh, ql)
    )
    return m.transpose(1, 0, 2).reshape(B, nch * chunk)[:, :Lk]


def _closure_member(ix: IndexArrays, rep_hi, rep_lo, le, codes32, k1: int,
                    shard_axis=None):
    """Anchor-scan membership for every position via W-position closure
    probes (index.device.ProbeTable): ONE row gather per W read
    positions instead of one per position.  W is
    static, derived from the row width (32 cols = window 4 with succ2
    bits; 24 cols = window 3, bits all in word0).

    rep_hi/lo: canonical (k-1)-mer per position [B, Lk]; le: query
    orientation (True = forward kmer IS the canonical); codes32: the
    read base codes the kmers were scanned from (consecutive kmers are
    shift-related, so neighbour extension bases come straight from it).
    Only valid when rep is the true canonical of the scanned kmers
    (i.e. the no-N path; N quirks break the shift relation's canon)."""
    from ..index.device import PT_SLOTS as S_

    B, Lk = rep_hi.shape
    L = codes32.shape[1]
    nbp = ix.pt_rows.shape[0]
    W = 4 if ix.pt_rows.shape[1] == 4 * S_ else 3
    J = (Lk + W - 1) // W
    pcols = [min(W * j + 1, Lk - 1) for j in range(J)]

    def at(arr, cols):
        return jnp.stack([arr[:, c] for c in cols], axis=1)

    qhi = at(rep_hi, pcols)
    qlo = at(rep_lo, pcols)
    if shard_axis is not None:
        D = jax.lax.axis_size(shard_axis)
        b = (mix32(qhi ^ ix.pt_seed, qlo)
             & jnp.uint32(nbp * D - 1)).astype(jnp.int32)
        row = _sharded_rows(ix.pt_rows, b, shard_axis)
    else:
        b = (mix32(qhi ^ ix.pt_seed, qlo) & jnp.uint32(nbp - 1)).astype(
            jnp.int32
        )
        row = ix.pt_rows[b]                          # [B, J, {4,3}*S_]
    # rows store ~key-hi so empty slots are natural zeros (device.py)
    ok = (row[..., 0:S_] == (qhi ^ _FULL32)[..., None]) & (
        row[..., S_ : 2 * S_] == qlo[..., None]
    )
    w0 = jnp.sum(
        jnp.where(ok, row[..., 2 * S_ : 3 * S_], jnp.uint32(0)),
        axis=-1, dtype=jnp.uint32,
    )                                                # [B, J]
    if W == 4:
        w1 = jnp.sum(
            jnp.where(ok, row[..., 3 * S_ : 4 * S_], jnp.uint32(0)),
            axis=-1, dtype=jnp.uint32,
        )

    onum = jnp.where(at(le, pcols), jnp.uint32(0), jnp.uint32(1))
    fb = at(codes32, [max(p - 1, 0) for p in pcols])     # pred base
    c1 = at(codes32, [min(p + k1, L - 1) for p in pcols])

    def bit(idx):
        idx = idx.astype(jnp.uint32)
        return ((w0 >> idx) & jnp.uint32(1)) != 0

    m_by_d = {
        -1: bit(jnp.uint32(9) + 4 * onum + fb),
        0: bit(jnp.broadcast_to(jnp.uint32(0), onum.shape)),
        1: bit(jnp.uint32(1) + 4 * onum + c1),
    }
    if W == 4:
        c2 = at(codes32, [min(p + k1 + 1, L - 1) for p in pcols])
        cc = (c1 << 2) | c2
        idx2 = (jnp.uint32(17) + 16 * onum + cc).astype(jnp.uint32)
        lo_ = (w0 >> idx2) & jnp.uint32(1)
        hi_ = (w1 >> jnp.where(idx2 >= 32, idx2 - 32, jnp.uint32(0))
               ) & jnp.uint32(1)
        m_by_d[2] = jnp.where(idx2 < 32, lo_, hi_) != 0
    # position i is answered by probe j = i//W at offset d = i - p_j.
    # For unclamped probes (p_j = W*j+1) the group's positions W*j ..
    # W*j+W-1 are exactly offsets d = -1..W-2 in order, so the whole
    # member matrix is ONE stack+reshape instead of Lk per-column
    # slices; only the end-clamped last group (p_J-1 = Lk-1 < W*j+1)
    # deviates and is patched column-wise (d <= 0 there).
    bulk = jnp.stack(
        [m_by_d[d] for d in range(-1, W - 1)], axis=2
    ).reshape(B, J * W)[:, :Lk]
    first_clamped = ((Lk - 2) // W + 1) * W   # first i in a clamped group
    if first_clamped < Lk:
        tail = [
            m_by_d[i - pcols[i // W]][:, (i // W) : (i // W) + 1]
            for i in range(max(first_clamped, 0), Lk)
        ]
        return jnp.concatenate(
            [bulk[:, :max(first_clamped, 0)]] + tail, axis=1
        )
    return bulk


def _scan_kmer_pairs_words(words, L: int, n: int):
    """n-mer (hi, lo) values at every position, from the PACKED 2-bit
    word rows (base i at bits 2*(i%16) of word i//16; width >= T+2
    words or zero-padded here).  Equals _scan_kmer_pairs(codes32, n,
    False) on the valid positions.

    The naive formulation (n shifted ORs over [B, Lk] slices) compiles
    to ~n wide kernels and measured ~26 ms of a 37 ms mapping step;
    here each of the 16 position-classes (p mod 16) needs only two
    32-bit funnel extractions + one 2-bit-group reversal over [B, T]
    arrays — the 64-bit little-endian window starting at bit 2p IS the
    kmer, read in reverse (kmer32.rev_pair)."""
    B, W = words.shape
    Lk = L - n + 1
    T = (Lk + 15) // 16
    if W < T + 2:
        words = jnp.pad(words, ((0, 0), (0, T + 2 - W)))
    w0 = words[:, 0:T]
    w1 = words[:, 1 : T + 1]
    w2 = words[:, 2 : T + 2]
    his, los = [], []
    for c in range(16):
        if c == 0:
            le_lo, le_hi = w0, w1
        else:
            sh = jnp.uint32(2 * c)
            bk = jnp.uint32(32 - 2 * c)
            le_lo = (w0 >> sh) | (w1 << bk)
            le_hi = (w1 >> sh) | (w2 << bk)
        vhi, vlo = rev_pair(le_hi, le_lo, n)
        his.append(vhi)
        los.append(vlo)
    hi = jnp.stack(his, axis=2).reshape(B, T * 16)[:, :Lk]
    lo = jnp.stack(los, axis=2).reshape(B, T * 16)[:, :Lk]
    return hi, lo


def _scan_kmer_pairs(codes32, n: int, complement: bool):
    """All n-mer (hi, lo) pairs per position of a [B, L] uint32 code
    array.  complement=True builds the reverse-complement value
    directly (base j weighted 4^j with 3-code)."""
    B, L = codes32.shape
    Lk = L - n + 1
    hi = jnp.zeros((B, Lk), jnp.uint32)
    lo = jnp.zeros((B, Lk), jnp.uint32)
    for j in range(n):
        c = codes32[:, j : j + Lk]
        if complement:
            c = jnp.uint32(3) - c
            shift = 2 * j
        else:
            shift = 2 * (n - 1 - j)
        if shift >= 32:
            hi = hi | (c << (shift - 32))
        else:
            lo = lo | (c << shift)
            if shift > 30:  # cannot happen: shifts are even, <=30 fit
                raise AssertionError
    return hi, lo


def _masked_rank_extract(member, rank, values, E: int):
    """Per row, the value tuple at the position whose 1-based `rank`
    equals e+1, for e in [0, E): each selector mask has at most one True
    per row, so a masked row-sum replaces the near-scalar
    take_along_axis gather.  `values` is a tuple of [B, Lk] arrays (any
    integer dtype); returns a tuple of [B, E] arrays."""
    outs = []
    for v in values:
        zero = jnp.zeros((), v.dtype)
        outs.append(jnp.stack(
            [jnp.sum(jnp.where((rank == e + 1) & member, v, zero),
                     axis=1, dtype=v.dtype) for e in range(E)],
            axis=1,
        ))
    return tuple(outs)


def _first_k_hits(member, values, E: int):
    """First E True positions per row (+ the value tuple there).
    Returns (pos [B, E], values tuple of [B, E], n [B])."""
    Lk = member.shape[1]
    scan_col = jnp.broadcast_to(
        jnp.arange(Lk, dtype=jnp.int32)[None, :], member.shape
    )
    cum = jnp.cumsum(member.astype(jnp.int32), axis=1)
    n = jnp.minimum(cum[:, -1], E)
    outs = _masked_rank_extract(member, cum, (scan_col,) + tuple(values), E)
    return outs[0], outs[1:], n.astype(jnp.int32)


def _last_k_hits_rc(member, values, lens, n_mer: int, E: int):
    """RC-anchor extraction without mirroring the scan arrays: the
    (e+1)-th member counted from the END of the forward scan is the RC
    read's e-th anchor, at rc-read position lens - n_mer - i (fwd scan
    position i), with the rc value of fwd position i.  `n_mer` is the
    scan window length (k-1 for junction scans, k for dog anchors).
    Returns (rc_pos [B, E], values tuple of [B, E], n [B])."""
    B, Lk = member.shape
    scan_col = jnp.arange(Lk, dtype=jnp.int32)[None, :]
    memi = member.astype(jnp.int32)
    cum = jnp.cumsum(memi, axis=1)
    total = cum[:, -1:]
    rev = total - cum + memi        # rank from the end (1-based at hits)
    rcpos = jnp.broadcast_to(lens[:, None] - n_mer - scan_col, member.shape)
    outs = _masked_rank_extract(member, rev, (rcpos,) + tuple(values), E)
    return outs[0], outs[1:], jnp.minimum(total[:, 0], E).astype(jnp.int32)


def _pick(arrs, j, n: int):
    """arrs[:, j] for per-row j in [0, n) as an unrolled where-chain
    (elementwise; avoids take_along_axis)."""
    out = arrs[:, 0]
    for c in range(1, n):
        out = jnp.where(j == c, arrs[:, c], out)
    return out


def _read_images(codes, nmask, lens, RWr: int):
    """Per-read device images: 2-bit code row, reverse-complement code
    row (flip + masked log-roll; RC('N') == 'A' == 3 - code), and the
    packed 16-bases-per-word rows for windowed compares."""
    B, L = codes.shape
    codes32 = codes.astype(jnp.uint32)
    col = jnp.arange(L, dtype=jnp.int32)[None, :]
    lshift = (jnp.int32(L) - lens)[:, None]          # [B, 1]
    flipped = jnp.flip(codes32, axis=1)
    rc32 = jnp.where(
        col < lens[:, None],
        jnp.uint32(3) - _roll_left(flipped, lshift[:, 0], L - 1),
        0,
    )
    rwf = _pack_rows(codes32, RWr)
    rwr = _pack_rows(rc32, RWr)
    nmw = _pack_rows(nmask.astype(jnp.uint32), RWr)
    return codes32, rc32, rwf, rwr, nmw


def _window_miss(
    ix: IndexArrays, meta, is_fwd, uoffc, ustart, rstart, w,
    rw_cur, nm_rows, W2: int, Lw: int,
):
    """Windowed Hamming between candidate unitigs and the read.

    meta [B,C,>=16] uint32 umeta rows (embedded seq at cols 16:16+2*SW
    when SW > 0); is_fwd/uoffc/ustart/rstart/w [B,C]; rw_cur [B,RWr]
    packed read rows already orientation-selected; nm_rows [B,RWr]
    packed N-mask rows (already zeroed where N must not count) or None.
    Returns miss [B,C] int32 over the w-base window (validity unmasked).

    Candidate side: fast path (SW > 0) reads the unitig's packed bases
    from the SAME row gather that fetched the metadata (fwd at cols
    16:16+SW, rc at 16+SW:16+2*SW, rc start already in RC coordinates).
    Fallback: chunk-row gather into the halo'd pool (row fully covers
    [ustart, ustart+w), w <= L <= halo).  All alignment is in-register
    (masked log-roll + funnel shift) — no element gathers.
    """
    Bc, C = is_fwd.shape
    RWr = rw_cur.shape[1]
    SW = (ix.umeta.shape[1] - 16) // 2
    if SW > 0:
        prow = jnp.where(
            is_fwd[..., None],
            meta[..., 16 : 16 + SW],
            meta[..., 16 + SW : 16 + 2 * SW],
        )                                               # [B,C,SW]
        if SW < W2 + 1:
            prow = jnp.concatenate(
                [prow, jnp.zeros(prow.shape[:-1] + (W2 + 1 - SW,),
                                 jnp.uint32)], axis=-1,
            )
        prow = _roll_left(prow, ustart >> 4, max(SW - 1, 1))
        sh_a = (2 * (ustart & 15)).astype(jnp.uint32)[:, :, None]
    else:
        g = uoffc + ustart                              # [B,C]
        row_idx = (g >> _CHUNK_SHIFT) + jnp.where(
            is_fwd, 0, ix.n_chunks
        )
        within = g & jnp.int32((1 << _CHUNK_SHIFT) - 1)
        prow = ix.pool_rows[jnp.maximum(row_idx, 0)]    # [B,C,RW]
        prow = _roll_left(prow, within >> 4,
                          (1 << _CHUNK_SHIFT) // 16 - 1)
        sh_a = (2 * (within & 15)).astype(jnp.uint32)[:, :, None]
    a = _funnel(prow[..., :W2], prow[..., 1 : W2 + 1], sh_a)

    # Read side: broadcast own packed row, roll to rstart.
    brow = jnp.broadcast_to(rw_cur[:, None, :], (Bc, C, RWr))
    brow = _roll_left(brow, rstart >> 4, Lw - 1)
    sh_b = (2 * (rstart & 15)).astype(jnp.uint32)[:, :, None]
    b = _funnel(brow[..., :W2], brow[..., 1 : W2 + 1], sh_b)

    x = a ^ b
    mismw = (x | (x >> 1)) & _LANE_LO
    if nm_rows is not None:
        nrow = jnp.broadcast_to(nm_rows[:, None, :], (Bc, C, RWr))
        nrow = _roll_left(nrow, rstart >> 4, Lw - 1)
        nb = _funnel(nrow[..., :W2], nrow[..., 1 : W2 + 1], sh_b)
        mismw = mismw | nb
    v = jnp.clip(
        w[:, :, None]
        - 16 * jnp.arange(W2, dtype=jnp.int32)[None, None, :],
        0, 16,
    )
    lane_mask = jnp.where(
        v >= 16, _FULL32,
        (jnp.uint32(1) << (2 * v).astype(jnp.uint32)) - jnp.uint32(1),
    ) & _LANE_LO
    return jnp.sum(
        jax.lax.population_count(mismw & lane_mask), axis=2,
    ).astype(jnp.int32)


def _junction_probe(
    ix: IndexArrays, mL, mRF, bhi, blo, pos, lens, rw_cur, nm_cur,
    W2: int, Lw: int, k1: int, jl_meta=None, shard_axis=None,
):
    """One junction evaluation: fused-row candidate lookup for the
    (k-1)-mer (bhi, blo) + windowed Hamming of all <=4 candidates
    against the read, for the walk phase encoded by the (mL, mRF) masks
    (mRC = ~mL & ~mRF).  Shared by the greedy junction step and the
    exhaustive DFS.  Returns a dict of [B, 4] candidate arrays:
    valid, sid (signed), is_fwd, miss, ended, ul, ust (window start in
    the oriented unitig = the path offset when ended on a LEFT walk),
    nxt_{l,r}_{hi,lo} (the follow-on junction kmers).
    """
    rhi, rlo = rcb_pair(bhi, blo, k1)
    is_canon = pair_le(bhi, blo, rhi, rlo)
    chi = jnp.where(is_canon, bhi, rhi)
    clo = jnp.where(is_canon, blo, rlo)
    # scan layout: ONE fused-row gather (slot-key compare + masked
    # row-sum value select); mphf layout: level bit-tests + jrows row
    found, vals8 = _junction_vals(
        ix, jl_meta, chi, clo, shard_axis
    )                                                      # [B], [B, 8]
    use_right = jnp.where(mL, is_canon, ~is_canon)
    cands = jnp.where(use_right[:, None], vals8[:, 4:8], vals8[:, 0:4])
    cands = jnp.where(found[:, None], cands, 0)         # [B, 4]
    valid_c = cands > 0

    # candidate metadata: one [B,4]-indexed row gather
    meta = jax.lax.bitcast_convert_type(
        ix.umeta[cands], jnp.uint32
    )                                                   # [B,4,16+]
    uoffc = meta[..., _C_UOFF].astype(jnp.int32)
    ul = meta[..., _C_ULEN].astype(jnp.int32)

    # orientation: LEFT wants unitigs ENDING with bin, RIGHT wants
    # unitigs BEGINNING with bin; forward iff that extremity matches
    ext_hi = jnp.where(mL[:, None], meta[..., _C_END_HI],
                       meta[..., _C_BEG_HI])
    ext_lo = jnp.where(mL[:, None], meta[..., _C_END_LO],
                       meta[..., _C_BEG_LO])
    is_fwd = (ext_hi == bhi[:, None]) & (ext_lo == blo[:, None])

    rem = jnp.where(mL, pos, jnp.where(mRF, lens - pos - k1, lens - pos))
    remc = rem[:, None]
    ended = (ul - k1) >= remc

    # window parameters (see model._walk_left/_walk_right)
    ustart = jnp.where(
        mL[:, None] & ended, ul - remc - k1,
        jnp.where(mRF[:, None], k1, 0),
    )
    rstart = jnp.where(
        mL[:, None],
        jnp.where(ended, 0, pos[:, None] - (ul - k1)),
        jnp.where(mRF[:, None], (pos + k1)[:, None], pos[:, None]),
    )
    w = jnp.where(
        ended, remc,
        jnp.where((mL | mRF)[:, None], ul - k1, jnp.minimum(ul, remc)),
    )
    miss = _window_miss(
        ix, meta, is_fwd, uoffc, ustart, rstart, w,
        rw_cur, nm_cur, W2, Lw,
    )

    # next-walk kmers per candidate, from its meta row:
    # LEFT : fwd -> begin kmer, rc -> rc(end kmer)
    # RIGHT: fwd -> end kmer,   rc -> rc(begin kmer)
    return dict(
        valid=valid_c,
        sid=jnp.where(is_fwd, cands, -cands),
        is_fwd=is_fwd,
        miss=miss,
        ended=ended,
        ul=ul,
        ust=ustart,
        nxt_l_hi=jnp.where(is_fwd, meta[..., _C_BEG_HI],
                           meta[..., _C_RCE_HI]),
        nxt_l_lo=jnp.where(is_fwd, meta[..., _C_BEG_LO],
                           meta[..., _C_RCE_LO]),
        nxt_r_hi=jnp.where(is_fwd, meta[..., _C_END_HI],
                           meta[..., _C_RCB_HI]),
        nxt_r_lo=jnp.where(is_fwd, meta[..., _C_END_LO],
                           meta[..., _C_RCB_LO]),
    )


def pack_paths(res: dict, pmax: int):
    """Device-side path compaction: [B, pmax] int32 where row i holds
    [offset, reversed left ids, right ids]; plus plen [B] (clamped to
    pmax; entries needing more than pmax slots report the true length
    so the host can recompute the rare overflow rows).  Keeps D2H
    traffic tiny compared to shipping the full lbuf/rbuf buffers.

    All alignment is flip + masked log-roll (elementwise), in place of
    a take_along_axis formulation."""
    offset, llen, rlen = res["offset"], res["llen"], res["rlen"]
    # buffers may be int16 in the loop (see _run_walks); widen here —
    # the int32 temp lives only inside this pack, not in the carry
    lbuf = res["lbuf"].astype(jnp.int32)
    rbuf = res["rbuf"].astype(jnp.int32)
    # the roll arithmetic below assumes one shared trailing width; a
    # caller with unequal buffers would silently corrupt packed paths
    assert lbuf.shape == rbuf.shape, (lbuf.shape, rbuf.shape)
    B, P = lbuf.shape
    # a[j] = lbuf[llen-1-j]: flip then roll left by P-llen; prepend the
    # offset column so a[j] answers output slots j in [0, llen]
    a = _roll_left(jnp.flip(lbuf, axis=1), (P - llen) % P, P - 1)
    a = jnp.concatenate([offset[:, None], a[:, : P - 1]], axis=1)
    # b[j] = rbuf[j-llen-1] for j > llen: roll right by llen+1
    b = _roll_left(rbuf, (P - ((llen + 1) % P)) % P, P - 1)
    j = jnp.arange(P, dtype=jnp.int32)[None, :]
    out = jnp.where(j <= llen[:, None], a, b)
    plen = 1 + llen + rlen
    out = jnp.where(j < plen[:, None], out, 0)
    if pmax > P:
        # slots beyond P can never hold real entries (P bounds the walk
        # length); pad zeros to honor the [B, pmax] contract
        out = jnp.pad(out, ((0, 0), (0, pmax - P)))
    return out[:, :pmax], plen


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "m", "effort", "max_iters", "pmax", "stage1_iters", "ablate",
        "jl_meta", "shard_axis",
    ),
)
def align_batch(
    ix: IndexArrays,
    codes,      # uint8 [B, L]
    nmask,      # bool  [B, L]
    lens,       # int32 [B]
    *,
    k: int,
    m: int,
    effort: int,
    max_iters: int = 0,
    pmax: int = 0,
    stage1_iters: int = 3,
    ablate: str = "all",  # profiling hook: "scan" stops after the
    #                       anchor scan (status := anchor counts);
    #                       capped loops are expressed via max_iters
    jl_meta=None,         # static MPHF junction descriptor (jl_meta_of)
    shard_axis=None,      # mesh axis name when st_fused/pt_rows are
    #                       bucket-range sharded (call under shard_map)
):
    """Align a batch.  Returns dict of per-read results."""
    B, L = codes.shape
    k1 = k - 1
    Lk = L - k1 + 1
    Lw = (L + 15) // 16     # read words
    W2 = Lw                 # compare words (window w <= L bases)
    RWr = 2 * Lw + 1        # packed read-row words (roll headroom)
    RW = ix.pool_rows.shape[1]
    E = effort
    P = L  # path buffer bound: every junction step advances >= 1 base
    uncapped = max_iters == 0
    if uncapped:
        max_iters = 2 * E * 2 * L + 64

    lens = lens.astype(jnp.int32)

    if ablate == "null":
        # per-call floor: same inputs/outputs, trivial compute
        return {
            "status": jnp.sum(codes.astype(jnp.int32), axis=1) * 0,
            "orient": lens * 0, "offset": lens * 0,
            "llen": lens * 0, "rlen": lens * 0,
            "lbuf": jnp.zeros((B, 1), jnp.int32),
            "rbuf": jnp.zeros((B, 1), jnp.int32),
            "iters": jnp.zeros((), jnp.int32),
            **({"paths": jnp.zeros((B, pmax), jnp.int32),
                "plen": lens * 0} if pmax else {}),
        }

    codes32, rc32, rwf, rwr, nmw = _read_images(codes, nmask, lens, RWr)
    col = jnp.arange(L, dtype=jnp.int32)[None, :]

    if ablate == "images":
        z = jnp.sum(rwf, axis=1) ^ jnp.sum(rwr, axis=1) ^ jnp.sum(
            nmw, axis=1) ^ jnp.sum(rc32, axis=1)
        return {
            "status": z.astype(jnp.int32), "orient": lens * 0,
            "offset": lens * 0, "llen": lens * 0, "rlen": lens * 0,
            "lbuf": jnp.zeros((B, 1), jnp.int32),
            "rbuf": jnp.zeros((B, 1), jnp.int32),
            "iters": jnp.zeros((), jnp.int32),
            **({"paths": jnp.zeros((B, pmax), jnp.int32),
                "plen": lens * 0} if pmax else {}),
        }

    # ---- anchor scan ----
    # std: N encodes 3 throughout; buggy: rolled-in N encodes 0
    # (reference str2num vs nuc2int quirk, see model.scan_kmers).
    # The buggy scan differs from std only when the batch carries Ns;
    # gate the extra k1-step scan behind the has-N cond.  Under a
    # sharded index the predicate must be GLOBALLY uniform (the
    # branches issue collectives; divergent branch choice would
    # deadlock the mesh).
    has_n = jnp.any(nmask)
    if shard_axis is not None:
        has_n = jax.lax.psum(has_n.astype(jnp.int32), shard_axis) > 0
    # fwd kmers straight from the packed read rows (16 funnel classes,
    # see _scan_kmer_pairs_words); rc values via the O(log) bit swizzle
    # of the forward scan — identical semantics to the naive scans
    std_hi, std_lo = _scan_kmer_pairs_words(rwf, L, k1)
    rcs_hi, rcs_lo = rcb_pair(std_hi, std_lo, k1)

    def _bug_scan():
        bcodes32 = jnp.where(nmask & (col >= k1), jnp.uint32(0), codes32)
        return _scan_kmer_pairs(bcodes32, k1, False)

    bug_hi, bug_lo = jax.lax.cond(
        has_n, _bug_scan, lambda: (std_hi, std_lo)
    )

    scan_col = jnp.arange(Lk, dtype=jnp.int32)[None, :]
    valid = scan_col <= (lens - k1)[:, None]

    def _ablate_out(chk):
        z = jnp.zeros((B,), jnp.int32)
        res = dict(
            status=chk, orient=z, offset=z, llen=z, rlen=z,
            lbuf=jnp.zeros((B, 1), jnp.int32),
            rbuf=jnp.zeros((B, 1), jnp.int32),
            iters=jnp.zeros((), jnp.int32),
        )
        if pmax:
            res["paths"] = jnp.zeros((B, pmax), jnp.int32)
            res["plen"] = z
        return res

    if ablate == "kmers":
        return _ablate_out(jnp.sum(
            (std_hi ^ rcs_lo ^ bug_lo).astype(jnp.int32), axis=1,
        ))

    le1 = pair_le(bug_hi, bug_lo, rcs_hi, rcs_lo)
    rep1_hi = jnp.where(le1, bug_hi, rcs_hi)
    rep1_lo = jnp.where(le1, bug_lo, rcs_lo)

    def _slow_members():
        """Per-position membership probes; handles the N-code quirks
        (reference str2num vs nuc2int, see model.scan_kmers) where the
        scanned 'canonical' is not a true canonical and the closure
        probe's shift relation does not hold."""
        m1 = _st_member_positions(ix, rep1_hi, rep1_lo, jl_meta, shard_axis) & valid
        le2 = pair_le(std_hi, std_lo, rcs_hi, rcs_lo)
        r_hi = jnp.where(le2, std_hi, rcs_hi)
        r_lo = jnp.where(le2, std_lo, rcs_lo)
        m2 = _st_member_positions(ix, r_hi, r_lo, jl_meta, shard_axis) & valid
        return m1, m2

    if ix.pt_rows.shape[0] > 0:
        def _fast_members():
            m = _closure_member(
                ix, rep1_hi, rep1_lo, le1, codes32, k1, shard_axis
            ) & valid
            return m, m
        member1, member2 = jax.lax.cond(
            has_n, _slow_members, _fast_members
        )
    else:
        member1 = _st_member_positions(ix, rep1_hi, rep1_lo, jl_meta, shard_axis) & valid

        def _member2():
            le2 = pair_le(std_hi, std_lo, rcs_hi, rcs_lo)
            r_hi = jnp.where(le2, std_hi, rcs_hi)
            r_lo = jnp.where(le2, std_lo, rcs_lo)
            return _st_member_positions(ix, r_hi, r_lo, jl_meta, shard_axis) & valid

        member2 = jax.lax.cond(has_n, _member2, lambda: member1)

    if ablate == "member":
        return _ablate_out(
            jnp.sum(member1.astype(jnp.int32)
                    + member2.astype(jnp.int32), axis=1)
        )

    # forward anchors: first E member1 hits, values = buggy fwd kmer
    apos_f, (ahi_f, alo_f), n_fwd = _first_k_hits(
        member1, (bug_hi, bug_lo), E
    )

    # rc anchors: scanning the RC read visits fwd position lens-k1-i at
    # rc position i with kmer value rc_std of that fwd position — i.e.
    # the RC read's e-th anchor is the fwd scan's (e+1)-th member from
    # the END; extract directly via reversed ranks (no mirror rolls).
    apos_r, (ahi_r, alo_r), n_rc = _last_k_hits_rc(
        member2, (rcs_hi, rcs_lo), lens, k1, E
    )

    if ablate == "scan":
        return _ablate_out(n_fwd + n_rc + apos_f[:, 0] + apos_r[:, 0])

    # greedy per-anchor walk inits (see _run_walks): walk starts LEFT at
    # the anchor with the full budget; the right restart point is the
    # anchor itself; nothing preloaded
    zi = jnp.zeros((B, E), jnp.int32)
    env = dict(
        lens=lens, rwf=rwf, rwr=rwr, nmw=nmw, n_f=n_fwd, n_r=n_rc,
        ph0_f=jnp.full((B, E), _LEFT, jnp.int32),
        cur_hi0_f=ahi_f, cur_lo0_f=alo_f, pos0_f=apos_f,
        ra_hi_f=ahi_f, ra_lo_f=alo_f, ra_pos_f=apos_f,
        bud0_f=jnp.full((B, E), m, jnp.int32),
        off0_f=zi, r0_f=zi, st0_f=zi,
        ph0_r=jnp.full((B, E), _LEFT, jnp.int32),
        cur_hi0_r=ahi_r, cur_lo0_r=alo_r, pos0_r=apos_r,
        ra_hi_r=ahi_r, ra_lo_r=alo_r, ra_pos_r=apos_r,
        bud0_r=jnp.full((B, E), m, jnp.int32),
        off0_r=zi, r0_r=zi, st0_r=zi,
    )
    return _run_walks(
        ix, env, k=k, E=E, pmax=pmax,
        max_iters=max_iters, stage1_iters=stage1_iters, uncapped=uncapped,
        jl_meta=jl_meta, shard_axis=shard_axis,
    )


def _run_walks(
    ix: IndexArrays,
    env: dict,
    *,
    k: int,
    E: int,
    pmax: int,
    max_iters: int,
    stage1_iters: int,
    uncapped: bool,
    jl_meta=None,
    shard_axis=None,
):
    """The batched walk state machine, generic over how walks start.

    `env` carries the per-read loop constants (lens + packed read
    images rwf/rwr/nmw) and per-anchor initial walk states, one set per
    orientation (suffix _f / _r), each [B, E]:
      ph0      initial phase (_LEFT, _RFIRST, or _DONE),
      cur_*0   initial walk (k-1)-mer, pos0 initial read position,
      ra_*     the RIGHT-walk restart point (kmer + pos) used when the
               LEFT walk reaches the read start,
      bud0     initial mismatch budget (negative = anchor already
               failed, e.g. a dog-mode verify miss),
      off0     preset path offset (dog-mode case 3/4),
      r0       signed unitig ID preloaded into the right path buffer
               (dog mode pins the anchored unitig; 0 = none),
      st0      status to record when ph0 == _DONE (dog-mode case 4).
    Greedy mode is the special case (LEFT at the anchor, full budget);
    dog mode precomputes placement-case inits per anchor.
    """
    B = env["lens"].shape[0]
    k1 = k - 1
    RWr = env["rwf"].shape[1]
    Lw = (RWr - 1) // 2       # read words (RWr = 2*Lw + 1, see caller)
    W2 = Lw                   # compare words (window w <= L bases)
    P = Lw * 16               # path buffer bound: >= read length, and
    #                           every junction step advances >= 1 base
    # int16 path buffers when every signed id provably fits (U < 32768
    # covers the survey workloads): halves the largest loop-carried
    # arrays, easing memory pressure toward bigger batches
    pdt = jnp.int16 if ix.umeta.shape[0] <= 32767 else jnp.int32

    state = dict(
        phase=jnp.full((B,), _FETCH, jnp.int32),
        status=jnp.zeros((B,), jnp.int32),
        orient=jnp.zeros((B,), jnp.int32),
        aidx=jnp.zeros((B,), jnp.int32),
        a_hi=jnp.zeros((B,), jnp.uint32),
        a_lo=jnp.zeros((B,), jnp.uint32),
        a_pos=jnp.zeros((B,), jnp.int32),
        cur_hi=jnp.zeros((B,), jnp.uint32),
        cur_lo=jnp.zeros((B,), jnp.uint32),
        pos=jnp.zeros((B,), jnp.int32),
        budget=jnp.zeros((B,), jnp.int32),
        offset=jnp.zeros((B,), jnp.int32),
        llen=jnp.zeros((B,), jnp.int32),
        rlen=jnp.zeros((B,), jnp.int32),
        lbuf=jnp.zeros((B, P), pdt),
        rbuf=jnp.zeros((B, P), pdt),
        iters=jnp.zeros((), jnp.int32),
    )

    def bookkeep(s, env):
        lens, n_f, n_r = env["lens"], env["n_f"], env["n_r"]
        phase, orient, aidx = s["phase"], s["orient"], s["aidx"]
        # --- FETCH resolution ---
        is_f = phase == _FETCH
        n_cur = jnp.where(orient == 0, n_f, n_r)
        have = aidx < n_cur
        fwd_exh = is_f & ~have & (orient == 0)
        rc_exh = is_f & ~have & (orient == 1)
        st_noov = fwd_exh & (n_f == 0)
        to_rc = fwd_exh & (n_f > 0)
        st_rcno = rc_exh & (n_r == 0)
        st_fail = rc_exh & (n_r > 0)

        ai = jnp.clip(aidx, 0, E - 1)

        def sel(name):
            return jnp.where(
                orient == 0,
                _pick(env[name + "_f"], ai, E),
                _pick(env[name + "_r"], ai, E),
            )

        # an anchor preloaded with a negative budget already failed its
        # placement verify (dog mode): skip straight to the next anchor
        bad = is_f & have & (sel("bud0") < 0)
        load = is_f & have & ~bad

        ph0 = sel("ph0")
        s = dict(s)
        s["status"] = jnp.where(
            st_noov, STATUS_NO_OVERLAP_FWD,
            jnp.where(st_rcno, STATUS_RC_NO_OVERLAP,
                      jnp.where(st_fail, STATUS_FAILED, s["status"])),
        )
        s["status"] = jnp.where(
            load & (ph0 == _DONE), sel("st0"), s["status"]
        )
        s["phase"] = jnp.where(
            st_noov | st_rcno | st_fail, _DONE,
            jnp.where(load, ph0, phase),
        )
        s["orient"] = jnp.where(to_rc, 1, orient)
        s["aidx"] = jnp.where(to_rc, 0, jnp.where(bad, aidx + 1, aidx))
        s["a_hi"] = jnp.where(load, sel("ra_hi"), s["a_hi"])
        s["a_lo"] = jnp.where(load, sel("ra_lo"), s["a_lo"])
        s["a_pos"] = jnp.where(load, sel("ra_pos"), s["a_pos"])
        s["cur_hi"] = jnp.where(load, sel("cur_hi0"), s["cur_hi"])
        s["cur_lo"] = jnp.where(load, sel("cur_lo0"), s["cur_lo"])
        s["pos"] = jnp.where(load, sel("pos0"), s["pos"])
        s["budget"] = jnp.where(load, sel("bud0"), s["budget"])
        s["llen"] = jnp.where(load, 0, s["llen"])
        r0 = sel("r0")
        s["rlen"] = jnp.where(load, (r0 != 0).astype(jnp.int32), s["rlen"])
        s["rbuf"] = s["rbuf"].at[:, 0].set(
            jnp.where(load & (r0 != 0), r0.astype(s["rbuf"].dtype),
                      s["rbuf"][:, 0])
        )
        s["offset"] = jnp.where(load, sel("off0"), s["offset"])

        # --- LEFT at read start: offset 0, switch to right walk ---
        l0 = (s["phase"] == _LEFT) & (s["pos"] == 0)
        s["offset"] = jnp.where(l0, 0, s["offset"])
        s["phase"] = jnp.where(l0, _RFIRST, s["phase"])
        s["cur_hi"] = jnp.where(l0, s["a_hi"], s["cur_hi"])
        s["cur_lo"] = jnp.where(l0, s["a_lo"], s["cur_lo"])
        s["pos"] = jnp.where(l0, s["a_pos"], s["pos"])

        # --- right-walk termination (nothing left to map) ---
        aligned_st = jnp.where(
            s["orient"] == 0, STATUS_ALIGNED_FWD, STATUS_ALIGNED_RC
        )
        rf_end = (s["phase"] == _RFIRST) & (lens - s["pos"] - k1 == 0)
        rc_end = (s["phase"] == _RCONT) & (lens - s["pos"] < k)
        fin = rf_end | rc_end
        s["status"] = jnp.where(fin, aligned_st, s["status"])
        s["phase"] = jnp.where(fin, _DONE, s["phase"])
        return s

    def junction(s, env):
        lens, rwf, rwr, nmw = env["lens"], env["rwf"], env["rwr"], env["nmw"]
        phase = s["phase"]
        mL = phase == _LEFT
        mRF = phase == _RFIRST
        mRC = phase == _RCONT
        active = mL | mRF | mRC
        pos = s["pos"]
        bhi, blo = s["cur_hi"], s["cur_lo"]

        # windowed compare reads the orientation-selected packed rows;
        # the N-mask counts only for forward-oriented reads
        orient = s["orient"]
        rw_cur = jnp.where((orient == 0)[:, None], rwf, rwr)
        nm_cur = jnp.where((orient == 0)[:, None], nmw, jnp.uint32(0))
        p = _junction_probe(
            ix, mL, mRF, bhi, blo, pos, lens, rw_cur, nm_cur,
            W2, Lw, k1, jl_meta, shard_axis,
        )
        miss = jnp.where(p["valid"], p["miss"], _BIG)

        bestj = jnp.argmin(miss, axis=1).astype(jnp.int32)

        def sel(x):
            return _pick(x, bestj, 4)

        best = sel(miss)
        fwd_s = sel(p["is_fwd"])
        end_s = sel(p["ended"])
        ul_s = sel(p["ul"])
        ust_s = sel(p["ust"])
        sid = sel(p["sid"])

        ok = active & (best <= s["budget"])
        fail = active & (best > s["budget"])

        s = dict(s)
        # path pushes
        push_l = ok & mL
        push_r = ok & (mRF | mRC)
        li = jnp.clip(s["llen"], 0, P - 1)
        ri = jnp.clip(s["rlen"], 0, P - 1)
        sid_b = sid.astype(s["lbuf"].dtype)
        # masked-where writes (an iota-compare select over [B, P]),
        # not .at[Bidx, idx].set per-row single-column scatters
        colP = jnp.arange(P, dtype=jnp.int32)[None, :]
        s["lbuf"] = jnp.where(
            (colP == li[:, None]) & push_l[:, None],
            sid_b[:, None], s["lbuf"],
        )
        s["rbuf"] = jnp.where(
            (colP == ri[:, None]) & push_r[:, None],
            sid_b[:, None], s["rbuf"],
        )
        s["llen"] = s["llen"] + push_l.astype(jnp.int32)
        s["rlen"] = s["rlen"] + push_r.astype(jnp.int32)
        s["budget"] = jnp.where(ok, s["budget"] - best, s["budget"])

        nxt_l_hi = sel(p["nxt_l_hi"])
        nxt_l_lo = sel(p["nxt_l_lo"])
        nxt_r_hi = sel(p["nxt_r_hi"])
        nxt_r_lo = sel(p["nxt_r_lo"])

        # LEFT ended -> record offset, restart from anchor going right
        le = ok & mL & end_s
        s["offset"] = jnp.where(le, ust_s, s["offset"])
        s["cur_hi"] = jnp.where(le, s["a_hi"], s["cur_hi"])
        s["cur_lo"] = jnp.where(le, s["a_lo"], s["cur_lo"])
        s["pos"] = jnp.where(le, s["a_pos"], s["pos"])
        # LEFT continue
        lc = ok & mL & ~end_s
        s["pos"] = jnp.where(lc, pos - (ul_s - k1), s["pos"])
        s["cur_hi"] = jnp.where(lc, nxt_l_hi, s["cur_hi"])
        s["cur_lo"] = jnp.where(lc, nxt_l_lo, s["cur_lo"])
        # RIGHT ended -> aligned
        re_ = ok & (mRF | mRC) & end_s
        aligned_st = jnp.where(
            s["orient"] == 0, STATUS_ALIGNED_FWD, STATUS_ALIGNED_RC
        )
        s["status"] = jnp.where(re_, aligned_st, s["status"])
        # RIGHT continue
        rc_ = ok & (mRF | mRC) & ~end_s
        s["pos"] = jnp.where(rc_, pos + (ul_s - k1), s["pos"])
        s["cur_hi"] = jnp.where(rc_, nxt_r_hi, s["cur_hi"])
        s["cur_lo"] = jnp.where(rc_, nxt_r_lo, s["cur_lo"])

        # phase transitions: fail -> next anchor; LEFT ended -> right
        # walk; RIGHT ended -> done; RIGHT continue -> RCONT; LEFT
        # continue stays LEFT
        s["phase"] = jnp.where(
            fail, _FETCH,
            jnp.where(le, _RFIRST, jnp.where(re_, _DONE, s["phase"])),
        )
        s["phase"] = jnp.where(rc_, _RCONT, s["phase"])
        s["aidx"] = jnp.where(fail, s["aidx"] + 1, s["aidx"])
        return s

    def run(state, env, cap: int):
        if shard_axis is None:
            def cond(s):
                live = jnp.any(s["phase"] != _DONE)
                return live & (s["iters"] < cap) if cap else live

            def body(s):
                # one bookkeep resolves a full transition chain (FETCH ->
                # LEFT -> RFIRST -> DONE checks run sequentially on the
                # updated state), so one call per junction step suffices
                s = bookkeep(s, env)
                s = junction(s, env)
                s["iters"] = s["iters"] + 1
                return s

            return jax.lax.while_loop(cond, body, state)

        # sharded index: the loop body issues collectives, so EVERY
        # device must iterate until the globally slowest shard is done
        # (a per-shard exit would stop issuing collectives and deadlock
        # the mesh).  Liveness is psum'd in the body and carried.
        state = dict(state, live=jnp.bool_(True))

        def cond(s):
            return s["live"] & (s["iters"] < cap) if cap else s["live"]

        def body(s):
            s = bookkeep(s, env)
            s = junction(s, env)
            s["iters"] = s["iters"] + 1
            l = jnp.any(s["phase"] != _DONE).astype(jnp.int32)
            s["live"] = jax.lax.psum(l, shard_axis) > 0
            return s

        state = jax.lax.while_loop(cond, body, state)
        state.pop("live")
        return state

    # ---- staged execution: the batch advances in lockstep, so the
    # while loop runs as long as the SLOWEST read walks (~15 junction
    # steps on the survey workload) while ~99% of reads finish within
    # ~5; run the full batch a few steps, compact the stragglers into a
    # B/8 sub-batch (row gathers), finish them there, scatter back.
    # The final uncapped full-batch loop is the correctness net for
    # sub-batch overflow; it is a no-op (one cond eval) in practice.
    if stage1_iters > 0 and uncapped and B >= 64:
        Btail = max(B // 8, 32)
        state = run(state, env, stage1_iters)
        pending = state["phase"] != _DONE
        tidx = jnp.nonzero(pending, size=Btail, fill_value=0)[0]
        tsel = pending[tidx]
        ts = {
            kk: (v if v.ndim == 0 else v[tidx]) for kk, v in state.items()
        }
        ts["phase"] = jnp.where(tsel, ts["phase"], _DONE)
        tenv = {kk: v[tidx] for kk, v in env.items()}
        ts = run(ts, tenv, max_iters)

        def merge(full, tail):
            if full.ndim == 0:
                return tail
            keep = tsel.reshape((-1,) + (1,) * (full.ndim - 1))
            return full.at[tidx].set(jnp.where(keep, tail, full[tidx]))

        state = {kk: merge(state[kk], ts[kk]) for kk in state}
        state = run(state, env, max_iters)
    else:
        state = run(state, env, max_iters)
    # flush terminal bookkeeping (a read can finish in bookkeep phase
    # right after the final junction iteration)
    for _ in range(2):
        state = bookkeep(state, env)

    res = dict(
        status=state["status"],
        orient=state["orient"],
        offset=state["offset"],
        llen=state["llen"],
        rlen=state["rlen"],
        lbuf=state["lbuf"],
        rbuf=state["rbuf"],
        iters=state["iters"],
    )
    if pmax:
        res["paths"], res["plen"] = pack_paths(res, pmax)
    return res


def _unpack_words(words, nmbits, L: int):
    """Inverse of the host-side 2-bit/1-bit packing (runner.pack_words
    batch variants): words uint32 [B, ceil(L/16)] -> codes uint8 [B, L];
    nmbits uint32 [B, ceil(L/32)] -> bool [B, L].  Pure elementwise
    reshapes and shifts — the H2D payload stays 2.25 bits/base instead of 16.

    A [B, 0]-shaped nmbits means "batch provably N-free" (the runner
    drops the mask payload then — it was ~1/3 of the per-batch H2D);
    the mask unpacks as all-False and the engine's has-N cond folds."""
    B, Lw = words.shape
    sh = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    codes = ((words[:, :, None] >> sh) & jnp.uint32(3)).reshape(
        B, Lw * 16
    )[:, :L].astype(jnp.uint8)
    if nmbits.shape[1] == 0:
        return codes, jnp.zeros((B, L), bool)
    shb = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    nm = (((nmbits[:, :, None] >> shb) & jnp.uint32(1)) != 0).reshape(
        B, -1
    )[:, :L]
    return codes, nm


@functools.partial(
    jax.jit,
    static_argnames=(
        "mode", "k", "m", "effort", "L", "pmax", "stage1_iters",
        "jl_meta", "al_meta", "partial", "out_dtype", "shard_axis",
    ),
)
def align_batch_packed(
    ix: IndexArrays,
    words,      # uint32 [B, ceil(L/16)] 2-bit packed read codes
    nmbits,     # uint32 [B, ceil(L/32)] packed N-mask bits
    lens,       # int32  [B]
    *,
    mode: str = "greedy",
    k: int,
    m: int,
    effort: int = 2,
    L: int,
    pmax: int,
    stage1_iters: int = 3,
    jl_meta=None,
    al_meta=None,              # static MPHF anchor descriptor (dog mode)
    partial: bool = False,
    out_dtype: str = "auto",   # "auto" = int16 when values fit; "int32"
    shard_axis=None,           # bucket-range-sharded index (greedy only)
):
    """Transfer-minimal production entry (all device modes).

    This wrapper (a) takes bit-packed reads (2 b/base + 1 N-bit vs 16 b),
    (b) returns ONE fused [B, 2 + pmax] array — col 0 status, col 1
    TRUE path length (rows with plen > pmax are recomputed on host —
    rare when pmax is the runner's capped bound), cols 2: the packed
    path — as int16 when every value provably fits (unitig count and
    path bound are static), halving D2H again.
    """
    codes, nm = _unpack_words(words, nmbits, L)
    if shard_axis is not None and mode != "greedy":
        raise ValueError("sharded index supports greedy mode only")
    if mode == "greedy":
        res = align_batch.__wrapped__(
            ix, codes, nm, lens, k=k, m=m, effort=effort, pmax=pmax,
            stage1_iters=stage1_iters, jl_meta=jl_meta,
            shard_axis=shard_axis,
        )
    elif mode == "anchors":
        from .dog import align_batch_anchors

        res = align_batch_anchors.__wrapped__(
            ix, codes, nm, lens, k=k, m=m, effort=effort, pmax=pmax,
            stage1_iters=stage1_iters, jl_meta=jl_meta, al_meta=al_meta,
        )
    elif mode == "exhaustive":
        from .exhaustive import align_batch_exhaustive

        # NOT forwarding stage1_iters: the DFS's unit is candidate
        # trials (~16x a greedy junction step), so it keeps its own
        # stage-1 depth default
        res = align_batch_exhaustive.__wrapped__(
            ix, codes, nm, lens, k=k, m=m, partial=partial, pmax=pmax,
            jl_meta=jl_meta,
        )
    else:
        raise ValueError(f"unknown mode {mode!r}")
    out = jnp.concatenate(
        [res["status"][:, None], res["plen"][:, None], res["paths"]],
        axis=1,
    )
    U = ix.umeta.shape[0]
    # int16 iff signed ids (|id| < U), offsets (< L) and true plens
    # (<= 2L+1) all fit
    if out_dtype == "auto" and U <= 32767 and 2 * L + 1 <= 32767:
        out = out.astype(jnp.int16)
    return out


def _compact_result(fused, pmax: int):
    """[B, 2+pmax] fused rows -> (meta [B, 2], flat [B*pmax]) where
    `flat`'s LEADING sum(counts) entries carry every real path slot and
    the tail is zeros — so the host can fetch just the prefix.

    Layout: rows are ordered by counts DESCENDING (stable by row index;
    the sort key is unique so any correct sort reproduces it on host),
    then slot columns are packed back to back, each truncated to its
    populated prefix n_j = #rows with count > j (a prefix exactly
    because counts are sorted).  Column placement at the data-dependent
    offsets is a sum of dynamic rolls (elementwise) rather than a
    scatter.

    Motivation: ~27% of rows are not aligned and aligned paths average
    ~3.3 of pmax slots, so the padded fused result ships ~3x the
    information bytes."""
    B = fused.shape[0]
    status = fused[:, 0].astype(jnp.int32)
    plen = fused[:, 1].astype(jnp.int32)
    aligned = (status == 1) | (status == 2)
    counts = jnp.where(aligned, jnp.minimum(plen, pmax), 0)
    iota = jnp.arange(B, dtype=jnp.int32)
    order = jnp.argsort((jnp.int32(pmax) - counts) * B + iota)
    sp = fused[:, 2:][order]                    # [B, pmax], counts desc
    n_j = [jnp.sum(counts > j) for j in range(pmax)]
    flat = jnp.zeros(B * pmax, fused.dtype)
    off = jnp.int32(0)
    zpad = jnp.zeros(B * (pmax - 1), fused.dtype)
    for j in range(pmax):
        col = jnp.where(iota < n_j[j], sp[:, j], 0)
        flat = flat + jnp.roll(jnp.concatenate([col, zpad]), off)
        off = off + n_j[j]
    return fused[:, :2], flat


@functools.partial(
    jax.jit,
    static_argnames=(
        "mode", "k", "m", "effort", "L", "pmax", "stage1_iters",
        "jl_meta", "al_meta", "partial", "out_dtype", "shard_axis",
    ),
)
def align_batches_packed_compact(
    ix: IndexArrays,
    words_t, nmbits_t, lens_t,
    *,
    mode: str = "greedy",
    k: int, m: int, effort: int = 2, L: int, pmax: int,
    stage1_iters: int = 3, jl_meta=None, al_meta=None,
    partial: bool = False,
    out_dtype: str = "auto", shard_axis=None,
):
    """align_batches_packed with the compact-D2H result transform:
    returns (meta [G, B, 2], flat [G, B*pmax]); the runner fetches meta
    plus only the populated prefix of flat (see _compact_result)."""
    words_s = jnp.stack(list(words_t))
    nmbits_s = jnp.stack(list(nmbits_t))
    lens_s = jnp.stack(list(lens_t))

    def body(args):
        w, nb, ln = args
        fused = align_batch_packed.__wrapped__(
            ix, w, nb, ln, mode=mode, k=k, m=m, effort=effort, L=L,
            pmax=pmax, stage1_iters=stage1_iters, jl_meta=jl_meta,
            al_meta=al_meta, partial=partial, out_dtype=out_dtype,
            shard_axis=shard_axis,
        )
        return _compact_result(fused, pmax)

    return jax.lax.map(body, (words_s, nmbits_s, lens_s))


@functools.partial(
    jax.jit,
    static_argnames=(
        "mode", "k", "m", "effort", "L", "pmax", "stage1_iters",
        "jl_meta", "al_meta", "partial", "out_dtype", "shard_axis",
    ),
)
def align_batches_packed(
    ix: IndexArrays,
    words_t,    # tuple of G uint32 [B, ceil(L/16)] packed batches
    nmbits_t,   # tuple of G uint32 [B, ceil(L/32)] (or [B, 0]: N-free)
    lens_t,     # tuple of G int32 [B]
    *,
    mode: str = "greedy",
    k: int,
    m: int,
    effort: int = 2,
    L: int,
    pmax: int,
    stage1_iters: int = 3,
    jl_meta=None,
    al_meta=None,
    partial: bool = False,
    out_dtype: str = "auto",
    shard_axis=None,
):
    """Grouped production entry: G stacked batches -> [G, B, 2 + pmax]
    in ONE device dispatch (lax.map over the group axis with the same
    per-batch body as align_batch_packed).

    Motivation: the per-batch runner paid one dispatch + one result
    fetch per 32k batch.  Grouping G batches per dispatch cuts those
    round-trips per read by G while keeping the per-batch program (and
    its compiled executable) identical — the
    same structure the reference amortizes with its 10k-read batch
    pulls under one mutex acquisition (alignerGreedy.cpp:373-377).

    The batches arrive as TUPLES of per-batch arrays, not a host-side
    stack: the runner device_puts each batch as soon as it is packed,
    so batch i's H2D streams behind batch i+1's packing, and the
    stack happens on device (free) at dispatch time."""

    words_s = jnp.stack(list(words_t))
    nmbits_s = jnp.stack(list(nmbits_t))
    lens_s = jnp.stack(list(lens_t))

    def body(args):
        w, nb, ln = args
        return align_batch_packed.__wrapped__(
            ix, w, nb, ln, mode=mode, k=k, m=m, effort=effort, L=L,
            pmax=pmax, stage1_iters=stage1_iters, jl_meta=jl_meta,
            al_meta=al_meta, partial=partial, out_dtype=out_dtype,
            shard_axis=shard_axis,
        )

    return jax.lax.map(body, (words_s, nmbits_s, lens_s))
