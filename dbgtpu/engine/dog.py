"""Batched dog/anchor mode (-G) on device.

Anchors are whole k-mers looked up in the anchor ScanTable (canonical
k-mer -> (unitig, offset, ucanon)); a hit pins the read to a placement
which is verified by ONE windowed Hamming compare and finished with the
SAME batched walk machine as greedy mode (reference
alignReadGreedyAnchors, alignerGreedy.cpp:60-164; semantics mirrored
from dbgtpu.anchors, the executable spec).

Vectorized shape: instead of the reference's per-anchor case-split
recursion, ALL placement cases for ALL anchors of ALL reads are
computed in one vectorized [B, E] precomputation (`_dog_inits`) that
emits per-anchor initial walk states for `_run_walks`:

  case 1  unitig inside the read  -> verify whole unitig, LEFT walk
          from its begin kmer, right restart at its end kmer,
  case 2  unitig overhangs the read end -> verify prefix, LEFT walk,
          right restart placed at lens-k+1 so the right phase
          terminates immediately,
  case 3  read overhangs the unitig end -> verify suffix, start in
          RIGHT-FIRST phase at the unitig end kmer, offset preset,
  case 4  read inside the unitig  -> verify only: initial phase DONE
          with the aligned status preset,
  failed verify -> negative initial budget; the walk machine skips
          straight to the next anchor.

Anchor orientation (reference string-compare, alignerGreedy.cpp:75-82)
is derived without touching the sequence pool: the table stores whether
the unitig k-mer at the anchored offset IS the canonical key (ucanon),
and the scan knows whether the read k-mer is canonical (le); the unitig
matches the read forward iff the two flags agree.

Deviation (documented in dbgtpu.anchors): the reference's rolling
k-mer anchor scan is buggy past read position 0 (k-1-sized update
registers, aligner.cpp:305-315, 381-405); dbgtpu scans correctly at
every position.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..constants import STATUS_ALIGNED_FWD, STATUS_ALIGNED_RC
from .core import (
    IndexArrays,
    _C_BEG_HI, _C_BEG_LO, _C_END_HI, _C_END_LO,
    _C_RCB_HI, _C_RCB_LO, _C_RCE_HI, _C_RCE_LO,
    _C_UOFF, _C_ULEN,
    _DONE, _LEFT, _RFIRST,
    _first_k_hits, _last_k_hits_rc, _read_images, _run_walks,
    _scan_kmer_pairs_words, _window_miss,
)
from .kmer32 import mix32, pair_le, rcb_pair


def _anchor_lookup(ix: IndexArrays, chi, clo, al_meta=None):
    """Canonical k-mer -> (member, uid, upos, ucanon).

    ScanTable layout: one fused row gather per query (S slot keys cols
    0:2S, S slots x 3 vals cols 2S:5S).  MPHF layout (al_meta set,
    large keysets): level rank-row gathers + one [n, 5] verify/value
    row — the reference's own anchor structure (anchorsMPHF +
    anchorsPosition, aligner.cpp:434-443) at ~22 bits/key + 20 B/key
    instead of ~150 B/key."""
    if al_meta is not None:
        from .core import _mphf_slot_arrays

        slot = _mphf_slot_arrays(
            ix.amph_rows, ix.amph_f, al_meta, chi, clo
        )
        row = ix.amph_arows[jnp.maximum(slot, 0)]
        member = (slot >= 0) & (row[..., 0] == chi) & (
            row[..., 1] == clo
        )
        vals = row[..., 2:5].astype(jnp.int32)
        return member, vals[..., 0], vals[..., 1], vals[..., 2]
    S_ = ix.at_fused.shape[1] // 5    # slots/bucket (2 key + 3 val cols)

    nba = ix.at_fused.shape[0]
    b = (mix32(chi ^ ix.at_seed, clo) & jnp.uint32(nba - 1)).astype(
        jnp.int32
    )
    row = ix.at_fused[b]                                 # [..., 5*S_]
    ok = (row[..., 0:S_] == chi[..., None]) & (
        row[..., S_ : 2 * S_] == clo[..., None]
    )
    vals = jnp.sum(
        jnp.where(ok[..., None],
                  row[..., 2 * S_ : 5 * S_].reshape(
                      row.shape[:-1] + (S_, 3)),
                  jnp.uint32(0)),
        axis=-2, dtype=jnp.uint32,
    ).astype(jnp.int32)                                  # [..., 3]
    member = jnp.any(ok, axis=-1)
    return member, vals[..., 0], vals[..., 1], vals[..., 2]


def _dog_inits(
    ix: IndexArrays, uid, upos, ucan, le, rpos, lens, rw_cur, nm_rows,
    *, k: int, m: int, W2: int, Lw: int, st_aligned: int,
):
    """Per-anchor initial walk states ([B, E] each) for _run_walks.

    uid/upos/ucan: anchor table values; le: whether the read k-mer at
    the anchor IS the canonical key; rpos: anchor read position; rw_cur
    / nm_rows: packed rows of the oriented read (nm_rows None for RC
    reads — RC('N') is a literal 'A').  Rows beyond the per-read anchor
    count carry garbage and are never consumed (guarded by n_f/n_r).
    """
    k1 = k - 1
    meta = jax.lax.bitcast_convert_type(ix.umeta[uid], jnp.uint32)
    ul = meta[..., _C_ULEN].astype(jnp.int32)
    fwd = le == ucan
    sid = jnp.where(fwd, uid, -uid)
    upos_o = jnp.where(fwd, upos, ul - k - upos)

    # oriented begin/end (k-1)-mers straight from the metadata row
    beg_hi = jnp.where(fwd, meta[..., _C_BEG_HI], meta[..., _C_RCE_HI])
    beg_lo = jnp.where(fwd, meta[..., _C_BEG_LO], meta[..., _C_RCE_LO])
    end_hi = jnp.where(fwd, meta[..., _C_END_HI], meta[..., _C_RCB_HI])
    end_lo = jnp.where(fwd, meta[..., _C_END_LO], meta[..., _C_RCB_LO])

    lensc = lens[:, None]
    rge = rpos >= upos_o            # unitig start lies inside the read
    vu = jnp.where(rge, 0, upos_o - rpos)   # unitig-side verify start
    vr = jnp.where(rge, rpos - upos_o, 0)   # read-side verify start
    w = jnp.minimum(ul - vu, lensc - vr)    # all four cases unified
    errors = _window_miss(
        ix, meta, fwd, meta[..., _C_UOFF].astype(jnp.int32),
        vu, vr, w, rw_cur, nm_rows, W2, Lw,
    )

    covers = (lensc - rpos) >= (ul - upos_o)  # read reaches unitig end
    case3 = ~rge & covers
    case4 = ~rge & ~covers
    ph0 = jnp.where(case4, _DONE, jnp.where(case3, _RFIRST, _LEFT))
    return dict(
        ph0=ph0,
        cur_hi0=jnp.where(case3, end_hi, beg_hi),
        cur_lo0=jnp.where(case3, end_lo, beg_lo),
        pos0=jnp.where(rge, vr, jnp.where(case3, ul - vu - k1, 0)),
        ra_hi=end_hi, ra_lo=end_lo,
        # case 2 (unitig overhangs the read): park the right restart at
        # lens-k+1 so the RIGHT-FIRST phase terminates immediately
        ra_pos=jnp.where(rge & covers, vr + ul - k1, lensc - k1),
        bud0=m - errors,
        off0=jnp.where(rge, 0, vu),
        r0=sid,
        st0=jnp.full_like(ph0, st_aligned),
    )


@functools.partial(
    jax.jit,
    static_argnames=("k", "m", "effort", "max_iters", "pmax",
                     "stage1_iters", "jl_meta", "al_meta"),
)
def align_batch_anchors(
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
    jl_meta=None,
    al_meta=None,
):
    """Align a batch in dog/anchor mode.  Same result dict as
    align_batch."""
    B, L = codes.shape
    if ix.at_fused.shape[0] == 0 and al_meta is None:
        raise ValueError("index was not built in dog mode "
                         "(anchor table is empty)")
    k1 = k - 1
    Lk = L - k + 1
    Lw = (L + 15) // 16
    W2 = Lw
    RWr = 2 * Lw + 1
    E = effort
    uncapped = max_iters == 0
    if uncapped:
        max_iters = 2 * E * 2 * L + 64

    lens = lens.astype(jnp.int32)
    codes32, rc32, rwf, rwr, nmw = _read_images(codes, nmask, lens, RWr)

    # k-mer scan (N encodes 3 throughout; no rolling quirk, see module
    # docstring) + canonical anchor lookup at every position.  The
    # lookup is chunked over the position axis (lax.map): a direct
    # [B, Lk] row gather materializes a [B, Lk, 5*S] temp — ~1.7 GB at
    # B=32k with the 160-col fused rows, too large to sit next to a
    # large-graph anchor table in device memory (same fix as core._st_member_positions).
    fhi, flo = _scan_kmer_pairs_words(rwf, L, k)
    rhi, rlo = rcb_pair(fhi, flo, k)
    le_f = pair_le(fhi, flo, rhi, rlo)
    chi = jnp.where(le_f, fhi, rhi)
    clo = jnp.where(le_f, flo, rlo)
    if al_meta is not None:
        # mphf layout: 5-col level/value rows, no [B, Lk, 5S] blow-up
        member, uid, upos, ucan = _anchor_lookup(
            ix, chi, clo, al_meta
        )
    else:
        chunk = 8
        nch = (Lk + chunk - 1) // chunk
        padc = nch * chunk - Lk
        qh = jnp.pad(chi, ((0, 0), (0, padc))).reshape(
            B, nch, chunk).transpose(1, 0, 2)
        ql = jnp.pad(clo, ((0, 0), (0, padc))).reshape(
            B, nch, chunk).transpose(1, 0, 2)
        member, uid, upos, ucan = jax.lax.map(
            lambda c: _anchor_lookup(ix, c[0], c[1]), (qh, ql)
        )

        def _unchunk(a):
            return a.transpose(1, 0, 2).reshape(B, nch * chunk)[:, :Lk]

        member, uid, upos, ucan = (
            _unchunk(member), _unchunk(uid), _unchunk(upos),
            _unchunk(ucan),
        )
    scan_col = jnp.arange(Lk, dtype=jnp.int32)[None, :]
    member = member & (scan_col <= (lens - k)[:, None])

    # forward anchors: first E hits in read order
    apos_f, (uid_f, upos_f, ucan_f, lef), n_f = _first_k_hits(
        member, (uid, upos, ucan, le_f.astype(jnp.int32)), E
    )
    # rc anchors: the RC read's e-th anchor is the fwd scan's (e+1)-th
    # member from the END (canonical keys are orientation-invariant);
    # the RC read's k-mer at that position is the rc of the fwd one
    le_r = pair_le(rhi, rlo, fhi, flo)
    apos_r, (uid_r, upos_r, ucan_r, ler), n_r = _last_k_hits_rc(
        member, (uid, upos, ucan, le_r.astype(jnp.int32)), lens, k, E
    )

    inits_f = _dog_inits(
        ix, uid_f, upos_f, ucan_f, lef, apos_f, lens, rwf, nmw,
        k=k, m=m, W2=W2, Lw=Lw, st_aligned=STATUS_ALIGNED_FWD,
    )
    inits_r = _dog_inits(
        ix, uid_r, upos_r, ucan_r, ler, apos_r, lens, rwr, None,
        k=k, m=m, W2=W2, Lw=Lw, st_aligned=STATUS_ALIGNED_RC,
    )
    env = dict(lens=lens, rwf=rwf, rwr=rwr, nmw=nmw, n_f=n_f, n_r=n_r)
    env.update({kk + "_f": v for kk, v in inits_f.items()})
    env.update({kk + "_r": v for kk, v in inits_r.items()})
    return _run_walks(
        ix, env, k=k, E=E, pmax=pmax,
        max_iters=max_iters, stage1_iters=stage1_iters,
        uncapped=uncapped, jl_meta=jl_meta,
    )
