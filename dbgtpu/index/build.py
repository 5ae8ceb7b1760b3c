"""Host-side unitig graph index construction.

Produces:
  - the unitig pool (2-bit codes, concatenated) with offsets/lengths,
  - precomputed begin/end (k-1)-mers per unitig,
  - two junction dictionaries (left / right) mapping canonical
    (k-1)-mers to up-to-4 unitig-ID slots,
  - (dog mode) an anchor dictionary mapping canonical k-mers to a single
    (unitig, offset) pair.

Behavioral contract (vs reference indexUnitigsAux, aligner.cpp:407-534):
  - unitig IDs are 1-based; ID 0 is a sentinel empty unitig,
  - the unitig FASTA is consumed as header/sequence line pairs, stopping
    at the first sequence line shorter than k,
  - begin (k-1)-mer goes to the LEFT dict if canonical as-is, else its
    RC goes to the RIGHT dict; end (k-1)-mer to the RIGHT dict if
    canonical as-is, else its RC to the LEFT dict,
  - per key, at most 4 ID slots: the first three inserts fill slots
    1..3, every later insert overwrites slot 4 (aligner.cpp:479-531),
  - dog mode indexes every k-mer at offsets j in [0, len-k-1] (note the
    reference's `j + k < len` bound excludes the final k-mer); the last
    writer wins per canonical k-mer (aligner.cpp:466-476).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from ..seq import encode, rcb, kmers_of, canonical

_ACGT = frozenset(b"ACGT")


class AnchorView:
    """Dog-mode anchor map (canonical k-mer -> (unitig, offset)) backed
    by sorted arrays instead of a python dict.

    At 1M-unitig scale the pool holds ~10^8 k-mers; the former
    `dict(zip(...))` build was minutes of single-threaded python and
    GBs of dict overhead, where the sorted key array +
    searchsorted view costs one vectorized argsort and 12 bytes/key."""

    __slots__ = ("keys", "vals", "ucanon")

    def __init__(self, keys: np.ndarray, vals: np.ndarray,
                 ucanon: np.ndarray | None = None):
        self.keys = keys      # uint64 [n], sorted ascending
        self.vals = vals      # int32  [n, 2] (unitig_id, offset)
        # optional [n] bool: unitig k-mer at (unitig, offset) equals
        # the canonical key (forward orientation).  Computed for free
        # during the build (the k-mer array is in hand); the device
        # layout needs it and otherwise recomputes ~10^8 k-mers.
        self.ucanon = ucanon

    def get(self, key, default=None):
        i = int(np.searchsorted(self.keys, np.uint64(key)))
        if i < len(self.keys) and self.keys[i] == np.uint64(key):
            v = self.vals[i]
            return (int(v[0]), int(v[1]))
        return default

    def __len__(self) -> int:
        return len(self.keys)

    def __bool__(self) -> bool:
        return len(self.keys) > 0

    def __eq__(self, other) -> bool:
        if isinstance(other, dict):
            other = anchors_from_dict(other)
        return (isinstance(other, AnchorView)
                and np.array_equal(self.keys, other.keys)
                and np.array_equal(self.vals, other.vals))


def anchors_from_dict(d: Dict[int, Tuple[int, int]]) -> AnchorView:
    keys = np.fromiter(d.keys(), np.uint64, count=len(d))
    vals = np.array(list(d.values()), np.int64).reshape(len(d), 2)
    order = np.argsort(keys, kind="stable")
    return AnchorView(keys[order], vals[order].astype(np.int32))


_EMPTY_ANCHORS = AnchorView(np.zeros(0, np.uint64),
                            np.zeros((0, 2), np.int32))


@dataclass
class UnitigGraph:
    k: int
    n_unitigs: int                    # real unitigs (IDs 1..n_unitigs)
    pool: np.ndarray                  # uint8 codes, concatenated
    offsets: np.ndarray               # int64 [n+1], offsets[0] == 0 (sentinel)
    lengths: np.ndarray               # int32 [n+1], lengths[0] == 0
    ubeg: np.ndarray                  # uint64 [n+1] begin (k-1)-mer
    uend: np.ndarray                  # uint64 [n+1] end (k-1)-mer
    anchors: AnchorView = field(default_factory=lambda: _EMPTY_ANCHORS)
    dog_mode: bool = False
    # vectorized junction slot table (the canonical junction-index
    # form, consumed by build_device_index and persisted directly):
    # jkeys uint64 [nj] sorted canonical keys; jvals int32 [nj, 8]
    # (cols 0:4 left slots, 4:8 right slots)
    jkeys: np.ndarray | None = None
    jvals: np.ndarray | None = None
    # lazily materialized {canonical key -> [ids]} views of the slot
    # table (insert order, slot-4 overwrite), used only by the python
    # spec path — the device path never pays the O(n)-python cost
    _left_d: Dict[int, List[int]] | None = None
    _right_d: Dict[int, List[int]] | None = None

    @property
    def left(self) -> Dict[int, List[int]]:
        if self._left_d is None:
            self._build_junction_dicts()
        return self._left_d

    @left.setter
    def left(self, d) -> None:
        self._left_d = d

    @property
    def right(self) -> Dict[int, List[int]]:
        if self._right_d is None:
            self._build_junction_dicts()
        return self._right_d

    @right.setter
    def right(self, d) -> None:
        self._right_d = d

    def _build_junction_dicts(self) -> None:
        left: Dict[int, List[int]] = {}
        right: Dict[int, List[int]] = {}
        if self.jkeys is not None and len(self.jkeys):
            for key, v in zip(self.jkeys.tolist(), self.jvals.tolist()):
                ls = [x for x in v[:4] if x]
                if ls:
                    left[key] = ls
                rs = [x for x in v[4:] if x]
                if rs:
                    right[key] = rs
        self._left_d = left
        self._right_d = right

    def unitig_codes(self, sid: int) -> np.ndarray:
        """Oriented unitig codes; negative sid = reverse complement."""
        i = abs(sid)
        off = int(self.offsets[i])
        u = self.pool[off : off + int(self.lengths[i])]
        if sid < 0:
            return (3 - u)[::-1]
        return u

    def get_end(self, num: int) -> List[int]:
        """Signed IDs of unitigs whose oriented sequence ENDS with the
        (k-1)-mer `num` (slot order preserved)."""
        k1 = self.k - 1
        rc = int(rcb(np.uint64(num), k1))
        ids = self.right.get(num, []) if num <= rc else self.left.get(rc, [])
        return [i if int(self.uend[i]) == num else -i for i in ids]

    def get_begin(self, num: int) -> List[int]:
        """Signed IDs of unitigs whose oriented sequence BEGINS with
        `num` (slot order preserved)."""
        k1 = self.k - 1
        rc = int(rcb(np.uint64(num), k1))
        ids = self.left.get(num, []) if num <= rc else self.right.get(rc, [])
        return [i if int(self.ubeg[i]) == num else -i for i in ids]

    def has_junction(self, rep: int) -> bool:
        """Canonical (k-1)-mer present in either junction dict."""
        return rep in self.left or rep in self.right


def parse_unitig_lines(path: str, k: int) -> List[bytes]:
    """Sequence lines of the unitig FASTA, header/seq pairs, stopping at
    the first sequence line shorter than k."""
    seqs: List[bytes] = []
    with open(path, "rb") as f:
        while True:
            header = f.readline()
            line = f.readline().rstrip(b"\n")
            if not header or len(line) < k:
                break
            seqs.append(line)
    return seqs


def validate_k(k: int) -> None:
    """k must fit the 64-bit kmer representation (reference cap:
    `kmer`=uint64, utils.h:27-28).  dbgtpu's (hi, lo) u32-pair kmers
    share the cap; without this check a k > 32 silently overflows the
    uint64 shifts in the extremity extraction below and produces wrong
    output instead of an error."""
    if not isinstance(k, int) or not 2 <= k <= 32:
        raise ValueError(
            f"k={k} is out of range: dbgtpu (like the reference, whose "
            "kmer type is uint64) supports 2 <= k <= 32"
        )


def build_graph(path: str, k: int, dog_mode: bool = False) -> UnitigGraph:
    validate_k(k)
    seqs = parse_unitig_lines(path, k)
    return build_graph_from_seqs(seqs, k, dog_mode)


def build_graph_from_seqs(seqs: List[bytes], k: int, dog_mode: bool = False) -> UnitigGraph:
    """Vectorized bulk construction (one numpy pass over the joined
    pool; no per-unitig numpy calls — multi-million-unitig graphs build
    in seconds on host)."""
    validate_k(k)
    k1 = k - 1
    n = len(seqs)
    raw = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    bad = ~np.isin(raw, np.frombuffer(b"ACGT", np.uint8))
    lengths = np.zeros(n + 1, dtype=np.int32)
    if n:
        lengths[1:] = np.fromiter(
            (len(s) for s in seqs), dtype=np.int32, count=n
        )
    # offsets[i] = start of unitig i in the pool (sentinel 0 empty)
    offsets = np.zeros(n + 1, dtype=np.int64)
    if n > 1:
        offsets[2:] = np.cumsum(lengths[1:n], dtype=np.int64)
    if bad.any():
        i = int(np.searchsorted(offsets[1:], np.nonzero(bad)[0][0], "right"))
        raise ValueError(
            f"unitig {i} contains non-ACGT characters; dbgtpu requires "
            "clean BCALM2-style unitigs"
        )
    pool = encode(raw.tobytes())

    g = UnitigGraph(
        k=k, n_unitigs=n, pool=pool, offsets=offsets,
        lengths=lengths, ubeg=np.zeros(n + 1, np.uint64),
        uend=np.zeros(n + 1, np.uint64), dog_mode=dog_mode,
    )
    if n == 0:
        return g

    # extremity (k-1)-mers, vectorized: gather [n, k1] then weight-sum
    jj = np.arange(k1, dtype=np.int64)[None, :]
    st = offsets[1:, None]
    en = (offsets[1:] + lengths[1:].astype(np.int64) - k1)[:, None]
    wts = (2 * (k1 - 1 - jj)).astype(np.uint64)
    beg = (pool[st + jj].astype(np.uint64) << wts).sum(axis=1, dtype=np.uint64)
    end = (pool[en + jj].astype(np.uint64) << wts).sum(axis=1, dtype=np.uint64)
    g.ubeg[1:] = beg
    g.uend[1:] = end
    rc_beg = rcb(beg, k1)
    rc_end = rcb(end, k1)

    beg_left = beg <= rc_beg
    end_right = end <= rc_end
    bkeys = np.where(beg_left, beg, rc_beg)
    ekeys = np.where(end_right, end, rc_end)

    # vectorized slot table (reference insert order: unitigs ascending,
    # begin before end, aligner.cpp:479-531): records interleaved in
    # insertion order; per (key, side) group the r-th insert fills slot
    # min(r, 3) — duplicate fancy-assignment targets keep the LAST
    # write, which IS the reference's slot-4 overwrite rule
    keys_all = np.empty(2 * n, np.uint64)
    keys_all[0::2] = bkeys
    keys_all[1::2] = ekeys
    side_all = np.empty(2 * n, np.int64)     # 0 = left, 1 = right
    side_all[0::2] = np.where(beg_left, 0, 1)
    side_all[1::2] = np.where(end_right, 1, 0)
    uid_all = np.repeat(np.arange(1, n + 1, dtype=np.int32), 2)
    g.jkeys, inv = np.unique(keys_all, return_inverse=True)
    gid = inv.astype(np.int64) * 2 + side_all
    order = np.argsort(gid, kind="stable")
    gs = gid[order]
    newg = np.r_[True, gs[1:] != gs[:-1]]
    gstart = np.maximum.accumulate(np.where(newg, np.arange(2 * n), 0))
    rank = np.empty(2 * n, np.int64)
    rank[order] = np.arange(2 * n) - gstart
    slot = np.minimum(rank, 3)
    g.jvals = np.zeros((len(g.jkeys), 8), np.int32)
    g.jvals[inv, side_all * 4 + slot] = uid_all

    if dog_mode:
        # all k-mers of the pool via one rolling pass, then per-unitig
        # validity (j + k < len: reference bound, excludes last k-mer)
        kms = kmers_of(pool, k)  # [P - k + 1] at pool positions
        cnt = np.maximum(lengths[1:].astype(np.int64) - k, 0)
        uid = np.repeat(np.arange(1, n + 1), cnt)
        cum = np.zeros(n + 1, np.int64)
        np.cumsum(cnt, out=cum[1:])
        # ragged arange: j within unitig, then add its pool offset
        pos_ok = (
            np.arange(cum[-1], dtype=np.int64) - cum[uid - 1] + offsets[uid]
        )
        canon = canonical(kms[pos_ok], k)
        offs = (pos_ok - offsets[uid]).astype(np.int64)
        # last-writer-wins per canonical key (the reference's
        # `dict`-like overwrite, aligner.cpp:473), fully vectorized:
        # stable-sort by key, keep each group's LAST record
        order = np.argsort(canon, kind="stable")
        ck = canon[order]
        if len(ck):
            last = np.r_[ck[1:] != ck[:-1], True]
            sel = order[last]
            g.anchors = AnchorView(
                ck[last],
                np.column_stack([uid[sel], offs[sel]]).astype(np.int32),
                ucanon=(kms[pos_ok[sel]] == ck[last]),
            )
    return g
