"""Batched exhaustive (-b) aligner on device.

The reference's exhaustive mode (alignerExhaustive.cpp:61-155) is a
branch-and-bound DFS: at every junction ALL <=4 successors are
explored, keeping the strict-minimum-mismatch full extension; anchors
are EVERY read position in order (getListOverlap's `if(true)`,
aligner.cpp:318-342); no reverse-complement retry.  Semantics are
defined by dbgtpu.exhaustive (the executable spec, itself
stats-parity-tested against the reference binary).

Vectorized shape — recursion becomes an explicit per-read stack inside
one lockstep `lax.while_loop`:

  - the TOP stack frame lives in registers ([B] / [B, 4] state vars):
    candidate sids, misses, window flags and follow-on kmers, all
    produced by ONE `_junction_probe` call (the same fused-row gather
    bundle as the greedy junction step) when the frame is populated,
  - one loop iteration = populate the top frame, OR process one of its
    candidate trials (terminal -> best/path snapshot; viable -> spill
    the registers to the stack arrays and descend), OR pop,
  - the best path so far is snapshotted as a masked [B, D] copy of the
    chosen-sid chain (csid) — improvements are rare, the copy is
    elementwise and fused,
  - pruning is against the GLOBAL phase best (total-so-far < best)
    instead of the reference's frame-local minimum: for strict-minimum
    search with first-achiever tie-break the two explore orders select
    the SAME walk (a candidate whose prefix total cannot strictly beat
    the best is never chosen by either),
  - anchor iteration skips positions whose true-canonical (k-1)-mer is
    not a junction key (their left walk has zero candidates and fails
    immediately in the spec); position 0 is always tried (its left
    walk succeeds trivially).

Statuses: NO_OVERLAP if the read is shorter than k-1; ALIGNED_FWD on
the first anchor whose left+right walks fit the budget; FAILED
otherwise.  Output follows the spec's documented deviation: paths ARE
emitted (the reference discards them, alignerExhaustive.cpp:283-287).
`partial` (-i) accepts a right ROOT junction with zero candidates
(alignerExhaustive.cpp:217-221).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..constants import (
    STATUS_ALIGNED_FWD,
    STATUS_FAILED,
    STATUS_NO_OVERLAP_FWD,
)
from .core import (
    IndexArrays,
    _BIG,
    _closure_member,
    _junction_probe,
    _pick,
    _read_images,
    _scan_kmer_pairs,
    _scan_kmer_pairs_words,
    _st_member_positions,
    pack_paths,
)
from .kmer32 import pair_le, rcb_pair

# phases
_FETCHX, _LDFS, _RDFS, _LDONE, _RDONE, _LRDY, _DONEX = 0, 1, 2, 3, 4, 5, 6


def _ta(arr, idx):
    """arr[b, idx[b]] per row (advanced indexing; [B] or [B, 4] out)."""
    B = arr.shape[0]
    return arr[jnp.arange(B, dtype=jnp.int32), idx]


@functools.partial(
    jax.jit,
    static_argnames=("k", "m", "partial", "max_iters", "pmax",
                     "stage1_iters", "jl_meta"),
)
def align_batch_exhaustive(
    ix: IndexArrays,
    codes,      # uint8 [B, L]
    nmask,      # bool  [B, L]
    lens,       # int32 [B]
    *,
    k: int,
    m: int,
    partial: bool = False,
    max_iters: int = 0,
    pmax: int = 0,
    stage1_iters: int = 48,   # full-batch candidate trials before the
    #                           straggler compaction (0 disables)
    jl_meta=None,
):
    """Align a batch exhaustively.  Same result dict as align_batch
    (orient is always 0: the mode has no RC retry)."""
    B, L = codes.shape
    k1 = k - 1
    Lk = L - k1 + 1
    Lw = (L + 15) // 16
    W2 = Lw
    RWr = 2 * Lw + 1
    D = L - k1 + 2   # stack depth bound: each level consumes >=1 base
    uncapped = max_iters == 0

    lens = lens.astype(jnp.int32)
    codes32, _, rwf, _, nmw = _read_images(codes, nmask, lens, RWr)
    col = jnp.arange(L, dtype=jnp.int32)[None, :]
    scan_col = jnp.arange(Lk, dtype=jnp.int32)[None, :]
    valid = scan_col <= (lens - k1)[:, None]

    # ---- anchor values (the reference's rolling N-quirk, see
    # model.scan_kmers) + interesting-position mask over TRUE canonical
    # keys (get_end's lookup canon, not the scan's register-min rep) ----
    has_n = jnp.any(nmask)
    std_hi, std_lo = _scan_kmer_pairs_words(rwf, L, k1)
    rcs_hi, rcs_lo = rcb_pair(std_hi, std_lo, k1)

    def _bug_scan():
        bcodes32 = jnp.where(nmask & (col >= k1), jnp.uint32(0), codes32)
        return _scan_kmer_pairs(bcodes32, k1, False)

    bug_hi, bug_lo = jax.lax.cond(
        has_n, _bug_scan, lambda: (std_hi, std_lo)
    )

    def _slow_member():
        rbh, rbl = rcb_pair(bug_hi, bug_lo, k1)
        le = pair_le(bug_hi, bug_lo, rbh, rbl)
        return _st_member_positions(
            ix, jnp.where(le, bug_hi, rbh), jnp.where(le, bug_lo, rbl),
            jl_meta,
        )

    if ix.pt_rows.shape[0] > 0:
        def _fast_member():
            le1 = pair_le(std_hi, std_lo, rcs_hi, rcs_lo)
            return _closure_member(
                ix, jnp.where(le1, std_hi, rcs_hi),
                jnp.where(le1, std_lo, rcs_lo), le1, codes32, k1,
            )
        member = jax.lax.cond(has_n, _slow_member, _fast_member)
    else:
        member = _slow_member()
    inter = (member & valid) | (scan_col == 0)
    pos_or_big = jnp.where(inter, scan_col, _BIG)
    nxt_int = jnp.flip(
        jax.lax.cummin(jnp.flip(pos_or_big, axis=1), axis=1), axis=1
    )                                  # [B, Lk] next interesting >= i

    n_pos = lens - k1 + 1
    zi = jnp.zeros((B,), jnp.int32)
    zu = jnp.zeros((B,), jnp.uint32)
    z4i = jnp.zeros((B, 4), jnp.int32)
    z4u = jnp.zeros((B, 4), jnp.uint32)
    state = dict(
        phase=jnp.where(n_pos <= 0, _DONEX, _FETCHX).astype(jnp.int32),
        status=jnp.where(
            n_pos <= 0, STATUS_NO_OVERLAP_FWD, 0
        ).astype(jnp.int32),
        a=zi,                       # current anchor scan position
        ak_hi=zu, ak_lo=zu,         # anchor kmer (quirky fwd value)
        best=zi,                    # current phase best (m+1 = none)
        bl=zi,                      # left best (fixed when left done)
        bloff=zi, bllen=zi,         # best left path: offset + length
        brlen=zi,
        bl_buf=jnp.zeros((B, D), jnp.int32),
        br_buf=jnp.zeros((B, D), jnp.int32),
        csid=jnp.zeros((B, D), jnp.int32),   # chosen-sid chain
        sp=zi,                      # depth of the TOP (register) frame
        # top frame registers
        tk_hi=zu, tk_lo=zu, tpos=zi, tacc=zi, tci=zi, tn=zi,
        tpop=jnp.zeros((B,), bool),
        tc_sid=z4i, tc_miss=z4i, tc_end=z4i, tc_ust=z4i, tc_npos=z4i,
        tc_nhi=z4u, tc_nlo=z4u,
        # spilled frames 0..sp-1
        s_ci=jnp.zeros((B, D), jnp.int32),
        s_n=jnp.zeros((B, D), jnp.int32),
        s_acc=jnp.zeros((B, D), jnp.int32),
        s_sid=jnp.zeros((B, D, 4), jnp.int32),
        s_miss=jnp.zeros((B, D, 4), jnp.int32),
        s_end=jnp.zeros((B, D, 4), jnp.int32),
        s_ust=jnp.zeros((B, D, 4), jnp.int32),
        s_npos=jnp.zeros((B, D, 4), jnp.int32),
        s_nhi=jnp.zeros((B, D, 4), jnp.uint32),
        s_nlo=jnp.zeros((B, D, 4), jnp.uint32),
        iters=jnp.zeros((), jnp.int32),
    )

    dcol = jnp.arange(D, dtype=jnp.int32)[None, :]

    def bookkeepX(s, env):
        lens = env["lens"]
        nxt_int, n_pos = env["nxt_int"], env["n_pos"]
        bug_hi, bug_lo = env["bug_hi"], env["bug_lo"]
        s = dict(s)
        # --- LDONE: left stack exhausted ---
        ld = s["phase"] == _LDONE
        l_ok = ld & (s["best"] <= m)
        s["bl"] = jnp.where(l_ok, s["best"], s["bl"])
        s["phase"] = jnp.where(l_ok, _LRDY, s["phase"])
        l_fail = ld & ~l_ok
        s["a"] = jnp.where(l_fail, s["a"] + 1, s["a"])
        s["phase"] = jnp.where(l_fail, _FETCHX, s["phase"])
        # --- RDONE: right stack exhausted ---
        rd = s["phase"] == _RDONE
        r_ok = rd & (s["best"] <= m - s["bl"])
        s["status"] = jnp.where(r_ok, STATUS_ALIGNED_FWD, s["status"])
        s["phase"] = jnp.where(r_ok, _DONEX, s["phase"])
        r_fail = rd & ~r_ok
        s["a"] = jnp.where(r_fail, s["a"] + 1, s["a"])
        s["phase"] = jnp.where(r_fail, _FETCHX, s["phase"])
        # --- FETCHX: advance to the next interesting anchor ---
        fx = s["phase"] == _FETCHX
        ac = jnp.clip(s["a"], 0, Lk - 1)
        nxt = _ta(nxt_int, ac)
        none = fx & ((nxt >= n_pos) | (s["a"] > lens - k1))
        s["status"] = jnp.where(none, STATUS_FAILED, s["status"])
        s["phase"] = jnp.where(none, _DONEX, s["phase"])
        go = fx & ~none
        nc = jnp.clip(nxt, 0, Lk - 1)
        s["a"] = jnp.where(go, nxt, s["a"])
        s["ak_hi"] = jnp.where(go, _ta(bug_hi, nc), s["ak_hi"])
        s["ak_lo"] = jnp.where(go, _ta(bug_lo, nc), s["ak_lo"])
        s["best"] = jnp.where(go, m + 1, s["best"])
        s["bllen"] = jnp.where(go, 0, s["bllen"])
        s["bloff"] = jnp.where(go, 0, s["bloff"])
        s["sp"] = jnp.where(go, 0, s["sp"])
        s["tk_hi"] = jnp.where(go, s["ak_hi"], s["tk_hi"])
        s["tk_lo"] = jnp.where(go, s["ak_lo"], s["tk_lo"])
        s["tpos"] = jnp.where(go, s["a"], s["tpos"])
        s["tacc"] = jnp.where(go, 0, s["tacc"])
        s["tpop"] = jnp.where(go, True, s["tpop"])
        s["phase"] = jnp.where(go, _LDFS, s["phase"])
        # anchor at read start: the left walk succeeds trivially
        # (offset 0, empty path) — straight to the right phase
        triv = go & (s["a"] == 0)
        s["bl"] = jnp.where(triv, 0, s["bl"])
        s["phase"] = jnp.where(triv, _LRDY, s["phase"])
        # --- LRDY: left finished (bl, bloff, bllen set); start right ---
        lr = s["phase"] == _LRDY
        rem0 = lens - s["a"] - k1
        win = lr & (rem0 == 0)     # nothing right of the anchor kmer
        s["brlen"] = jnp.where(lr, 0, s["brlen"])
        s["status"] = jnp.where(win, STATUS_ALIGNED_FWD, s["status"])
        s["phase"] = jnp.where(win, _DONEX, s["phase"])
        rgo = lr & ~win
        s["best"] = jnp.where(rgo, m - s["bl"] + 1, s["best"])
        s["sp"] = jnp.where(rgo, 0, s["sp"])
        s["tk_hi"] = jnp.where(rgo, s["ak_hi"], s["tk_hi"])
        s["tk_lo"] = jnp.where(rgo, s["ak_lo"], s["tk_lo"])
        s["tpos"] = jnp.where(rgo, s["a"], s["tpos"])
        s["tacc"] = jnp.where(rgo, 0, s["tacc"])
        s["tpop"] = jnp.where(rgo, True, s["tpop"])
        s["phase"] = jnp.where(rgo, _RDFS, s["phase"])
        return s

    def dfs_step(s, env):
        lens, rwf, nmw = env["lens"], env["rwf"], env["nmw"]
        s = dict(s)
        Bidx = jnp.arange(s["phase"].shape[0], dtype=jnp.int32)
        mL = s["phase"] == _LDFS
        mR = s["phase"] == _RDFS
        active = mL | mR
        need_pop = active & s["tpop"]

        # ---- populate the top frame: ONE junction-probe bundle ----
        p = _junction_probe(
            ix, mL, mR, s["tk_hi"], s["tk_lo"], s["tpos"], lens,
            rwf, nmw, W2, Lw, k1, jl_meta,
        )
        pv = p["valid"]
        vidx = jnp.cumsum(pv.astype(jnp.int32), axis=1) - 1

        def compact(x, dtype):
            cols = []
            for t in range(4):
                selm = pv & (vidx == t)
                cols.append(jnp.sum(
                    jnp.where(selm, x, jnp.zeros((), dtype)),
                    axis=1, dtype=dtype,
                ))
            return jnp.stack(cols, axis=1)

        npos = jnp.where(
            mL[:, None],
            s["tpos"][:, None] - (p["ul"] - k1),
            s["tpos"][:, None] + (p["ul"] - k1),
        )
        nhi = jnp.where(mL[:, None], p["nxt_l_hi"], p["nxt_r_hi"])
        nlo = jnp.where(mL[:, None], p["nxt_l_lo"], p["nxt_r_lo"])
        c_sid = compact(p["sid"], jnp.int32)
        c_miss = compact(p["miss"], jnp.int32)
        c_end = compact(p["ended"].astype(jnp.int32), jnp.int32)
        c_ust = compact(p["ust"], jnp.int32)
        c_npos = compact(npos, jnp.int32)
        c_nhi = compact(nhi, jnp.uint32)
        c_nlo = compact(nlo, jnp.uint32)
        c_n = jnp.sum(pv, axis=1).astype(jnp.int32)

        def st(name, new):
            s[name] = jnp.where(
                need_pop[(...,) + (None,) * (new.ndim - 1)], new, s[name]
            )

        st("tc_sid", c_sid)
        st("tc_miss", c_miss)
        st("tc_end", c_end)
        st("tc_ust", c_ust)
        st("tc_npos", c_npos)
        st("tc_nhi", c_nhi)
        st("tc_nlo", c_nlo)
        st("tn", c_n)
        st("tci", jnp.zeros_like(s["tci"]))
        s["tpop"] = jnp.where(need_pop, False, s["tpop"])
        if partial:
            # right ROOT junction with zero candidates -> accept as-is
            phit = need_pop & mR & (s["sp"] == 0) & (c_n == 0)
            s["best"] = jnp.where(phit, 0, s["best"])

        # ---- one candidate trial / pop of the top frame ----
        step = active & ~need_pop
        popm = step & (s["tci"] >= s["tn"])
        spm = s["sp"] - 1
        under = popm & (spm < 0)
        s["phase"] = jnp.where(
            under, jnp.where(mL, _LDONE, _RDONE), s["phase"]
        )
        restore = popm & ~under
        spc = jnp.clip(spm, 0, D - 1)

        def rst(reg, stack):
            v = _ta(s[stack], spc)
            s[reg] = jnp.where(
                restore[(...,) + (None,) * (v.ndim - 1)], v, s[reg]
            )

        trial = step & ~popm
        ci = jnp.clip(s["tci"], 0, 3)
        t_sid = _pick(s["tc_sid"], ci, 4)
        t_miss = _pick(s["tc_miss"], ci, 4)
        t_end = _pick(s["tc_end"], ci, 4) != 0
        t_ust = _pick(s["tc_ust"], ci, 4)
        t_npos = _pick(s["tc_npos"], ci, 4)
        t_nhi = _pick(s["tc_nhi"], ci, 4)
        t_nlo = _pick(s["tc_nlo"], ci, 4)
        total = s["tacc"] + t_miss

        # terminal candidate: snapshot on strict improvement
        impr = trial & t_end & (total < s["best"])
        s["best"] = jnp.where(impr, total, s["best"])
        spn = s["sp"][:, None]
        snap = jnp.where(
            dcol < spn, s["csid"],
            jnp.where(dcol == spn, t_sid[:, None], 0),
        )
        iml = impr & mL
        imr = impr & mR
        s["bl_buf"] = jnp.where(iml[:, None], snap, s["bl_buf"])
        s["bllen"] = jnp.where(iml, s["sp"] + 1, s["bllen"])
        s["bloff"] = jnp.where(iml, t_ust, s["bloff"])
        s["br_buf"] = jnp.where(imr[:, None], snap, s["br_buf"])
        s["brlen"] = jnp.where(imr, s["sp"] + 1, s["brlen"])

        # advance past this candidate (push resumes here on pop)
        s["tci"] = jnp.where(trial, s["tci"] + 1, s["tci"])

        # viable non-terminal candidate: spill the top, descend
        push = trial & ~t_end & (total < s["best"])
        spcur = jnp.clip(s["sp"], 0, D - 1)

        def spill(stack, reg):
            cur = _ta(s[stack], spcur)
            v = jnp.where(
                push[(...,) + (None,) * (cur.ndim - 1)], s[reg], cur
            )
            s[stack] = s[stack].at[Bidx, spcur].set(v)

        spill("s_ci", "tci")
        spill("s_n", "tn")
        spill("s_acc", "tacc")
        spill("s_sid", "tc_sid")
        spill("s_miss", "tc_miss")
        spill("s_end", "tc_end")
        spill("s_ust", "tc_ust")
        spill("s_npos", "tc_npos")
        spill("s_nhi", "tc_nhi")
        spill("s_nlo", "tc_nlo")
        s["csid"] = s["csid"].at[Bidx, spcur].set(
            jnp.where(push, t_sid, _ta(s["csid"], spcur))
        )
        s["sp"] = jnp.where(push, s["sp"] + 1, s["sp"])
        s["tk_hi"] = jnp.where(push, t_nhi, s["tk_hi"])
        s["tk_lo"] = jnp.where(push, t_nlo, s["tk_lo"])
        s["tpos"] = jnp.where(push, t_npos, s["tpos"])
        s["tacc"] = jnp.where(push, total, s["tacc"])
        s["tpop"] = jnp.where(push, True, s["tpop"])

        # pop: restore the parent frame into the registers
        rst("tci", "s_ci")
        rst("tn", "s_n")
        rst("tacc", "s_acc")
        rst("tc_sid", "s_sid")
        rst("tc_miss", "s_miss")
        rst("tc_end", "s_end")
        rst("tc_ust", "s_ust")
        rst("tc_npos", "s_npos")
        rst("tc_nhi", "s_nhi")
        rst("tc_nlo", "s_nlo")
        s["sp"] = jnp.where(restore | under, spm, s["sp"])
        return s

    envx = dict(lens=lens, n_pos=n_pos, nxt_int=nxt_int,
                bug_hi=bug_hi, bug_lo=bug_lo, rwf=rwf, nmw=nmw)

    def run(state, env, cap: int):
        def cond(s):
            live = jnp.any(s["phase"] != _DONEX)
            return live & (s["iters"] < cap) if cap else live

        def body(s):
            s = bookkeepX(s, env)
            s = dfs_step(s, env)
            s["iters"] = s["iters"] + 1
            return s

        return jax.lax.while_loop(cond, body, state)

    # staged execution (same shape as core._run_walks): the lockstep
    # DFS runs as long as the slowest read explores, but most reads
    # resolve within a few dozen candidate trials; run the full batch
    # `stage1_iters` trials, compact the stragglers into a B/8
    # sub-batch (row gathers over every state array incl. the spill
    # stacks), finish them there, scatter back.  The final uncapped
    # full-batch loop is the correctness net for sub-batch overflow.
    if stage1_iters > 0 and uncapped and B >= 64:
        Btail = max(B // 8, 32)
        state = run(state, envx, stage1_iters)
        pending = state["phase"] != _DONEX
        tidx = jnp.nonzero(pending, size=Btail, fill_value=0)[0]
        tsel = pending[tidx]
        ts = {kk: (v if v.ndim == 0 else v[tidx])
              for kk, v in state.items()}
        ts["phase"] = jnp.where(tsel, ts["phase"], _DONEX)
        tenv = {kk: v[tidx] for kk, v in envx.items()}
        ts = run(ts, tenv, max_iters)

        def merge(full, tail):
            if full.ndim == 0:
                return tail
            keep = tsel.reshape((-1,) + (1,) * (full.ndim - 1))
            return full.at[tidx].set(jnp.where(keep, tail, full[tidx]))

        state = {kk: merge(state[kk], ts[kk]) for kk in state}
        state = run(state, envx, max_iters)
    else:
        state = run(state, envx, max_iters)
    state = bookkeepX(state, envx)  # resolve terminal LDONE/RDONE/LRDY

    res = dict(
        status=state["status"],
        orient=jnp.zeros((B,), jnp.int32),
        offset=state["bloff"],
        llen=state["bllen"],
        rlen=state["brlen"],
        lbuf=state["bl_buf"],
        rbuf=state["br_buf"],
        iters=state["iters"],
    )
    if pmax:
        res["paths"], res["plen"] = pack_paths(res, pmax)
    return res
