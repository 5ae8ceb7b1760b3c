"""Index persistence: save/load the built graph AND its device layout.

The reference ships BooPHF save/load (BooPHF.h:927-1005) but never
calls it — every run rebuilds the index (SURVEY.md §5).  dbgtpu makes
persistence first-class: `--save-index` / `--load-index` on the CLI.

v2 format (this module's writer): the UnitigGraph flat arrays
(pool/offsets/lengths/extremities/jkeys+jvals slot table) PLUS the
device-ready artifacts — ScanTable, ProbeTable, umeta, pool rows — so
`--load-index` produces a device-ready index in O(file read) time with
no rebuild (a loaded 1M-unitig index used to be slower to become
device-ready than a fresh build, because only the python-dict-derived
arrays were stored).  Uncompressed npz: zlib at
~50 MB/s would cost more than it saves on multi-GB probe tables.

v1 files (dict-derived arrays) still load, via the legacy path.
"""

from __future__ import annotations

import numpy as np

from .build import UnitigGraph
from .device import DeviceIndex, ProbeTable, ScanTable

_MAGIC_V1 = "dbgtpu-index-v1"
_MAGIC_V2 = "dbgtpu-index-v2"


def _anchor_arrays(g: UnitigGraph) -> dict:
    if not (g.dog_mode and g.anchors):
        return {}
    # the AnchorView IS sorted arrays; persist them verbatim
    d = dict(anchor_keys=g.anchors.keys, anchor_vals=g.anchors.vals)
    if g.anchors.ucanon is not None:
        d["anchor_ucanon"] = np.asarray(g.anchors.ucanon, bool)
    return d


def save_index(g: UnitigGraph, path: str, di: DeviceIndex | None = None,
               layout: str = "scan") -> None:
    """Persist graph + device layout (v2).  `di` defaults to the graph's
    cached device index for `layout`, building it if absent.

    layout="mphf" persists the compact MPHF junction artifacts (level
    bitvectors + fused jrows + final table) so a `--load-index
    --index-layout mphf` start is device-ready in O(file read) — the
    >HBM-graph mode where a ~50 s @1M-unitig rebuild hurt most.
    Whatever junction layouts the DeviceIndex
    carries are saved; a load with the OTHER layout still works, it
    just rebuilds that layout's junction table from the slot table."""
    if di is None:
        attr = ("_device_index" if layout == "scan"
                else f"_device_index_{layout}")
        di = getattr(g, attr, None)
        if di is None:
            from .device import build_device_index

            di = build_device_index(g, layout=layout)
            setattr(g, attr, di)
    d = dict(
        magic=_MAGIC_V2, k=g.k, n_unitigs=g.n_unitigs,
        pool=g.pool, offsets=g.offsets, lengths=g.lengths,
        ubeg=g.ubeg, uend=g.uend, dog_mode=g.dog_mode,
        jkeys=(g.jkeys if g.jkeys is not None else np.zeros(0, np.uint64)),
        jvals=(g.jvals if g.jvals is not None else np.zeros((0, 8), np.int32)),
        # device layout
        d_umeta=di.umeta, d_pool_rows=di.pool_rows,
        d_n_chunks=di.n_chunks, d_halo=di.halo_bases,
        d_max_ulen=di.max_ulen, d_pool_words=di.pool_words,
        d_uoff=di.uoff, d_ulen=di.ulen,
        d_ubeg_hi=di.ubeg_hi, d_ubeg_lo=di.ubeg_lo,
        d_uend_hi=di.uend_hi, d_uend_lo=di.uend_lo,
        d_rcbeg_hi=di.rcbeg_hi, d_rcbeg_lo=di.rcbeg_lo,
        d_rcend_hi=di.rcend_hi, d_rcend_lo=di.rcend_lo,
        **_anchor_arrays(g),
    )
    if di.id_inv is not None:
        # graph-order renumbered tables: the new->file-order id map
        # must travel with them (the runner translates on drain)
        d["d_id_inv"] = di.id_inv
    st = di.scan_tbl
    if st is not None:
        d.update(st_keys=st.keys, st_vals=st.vals,
                 st_nb=st.n_buckets, st_seed=st.seed)
    pt = di.probe_tbl
    if pt is not None:
        d.update(pt_rows=pt.rows, pt_nb=pt.n_buckets,
                 pt_seed=pt.seed, pt_window=pt.window)
    at = di.anchor_scan
    if at is not None:
        d.update(at_keys=at.keys, at_vals=at.vals,
                 at_nb=at.n_buckets, at_seed=at.seed)
    ma = di.anchor_mphf
    if ma is not None:
        am = ma.mphf
        d.update(
            amph_n_keys=am.n_keys, amph_gamma=am.gamma,
            amph_n_levels=am.n_levels, amph_words=am.words,
            amph_word_off=am.word_off, amph_mask=am.mask,
            amph_rank_base=am.rank_base, amph_samples=am.samples,
            amph_sample_off=am.sample_off, amph_arows=ma.arows,
        )
        if am.final_tbl is not None:
            t = am.final_tbl
            d.update(amph_f_khi=t.khi, amph_f_klo=t.klo,
                     amph_f_vals=t.vals)
    mj = di.mphf_junction
    if mj is not None:
        m = mj.mphf
        d.update(
            mph_n_keys=m.n_keys, mph_gamma=m.gamma,
            mph_n_levels=m.n_levels, mph_words=m.words,
            mph_word_off=m.word_off, mph_mask=m.mask,
            mph_rank_base=m.rank_base, mph_samples=m.samples,
            mph_sample_off=m.sample_off, mph_jrows=mj.jrows,
        )
        if m.final_tbl is not None:
            t = m.final_tbl
            d.update(mph_f_khi=t.khi, mph_f_klo=t.klo, mph_f_vals=t.vals)
    np.savez(path, **d)


def load_index(path: str, stream_device: bool | None = None) -> UnitigGraph:
    """Load a persisted index; returns the graph with its device index
    attached (`graph._device_index`) when the file carries one (v2).

    stream_device (default: on, disable with DBGTPU_STREAM_LOAD=0):
    start each big artifact's H2D as soon as its bytes leave the npz —
    npz members read lazily per key, so the disk read of artifact i+1
    overlaps the (async) device upload of artifact i, instead of the
    former read-everything-then-upload-everything serialization that
    made a 1M-unitig persisted start pay ~8 s load + ~22 s H2D back to
    back.  The probe table (the largest artifact) is deliberately
    ordered LAST so the runner's eager start can begin mapping on the
    probe-less program while it is still in flight."""
    z = np.load(path, allow_pickle=False)
    magic = str(z["magic"])
    if magic == _MAGIC_V1:
        return _load_v1(z)
    if magic != _MAGIC_V2:
        raise ValueError(f"{path}: not a dbgtpu index file")
    import os

    if stream_device is None:
        stream_device = os.environ.get("DBGTPU_STREAM_LOAD", "1") != "0"
    g = UnitigGraph(
        k=int(z["k"]), n_unitigs=int(z["n_unitigs"]),
        pool=z["pool"], offsets=z["offsets"], lengths=z["lengths"],
        ubeg=z["ubeg"], uend=z["uend"],
        dog_mode=bool(z["dog_mode"]),
        jkeys=z["jkeys"], jvals=z["jvals"],
    )
    _load_anchors(g, z)
    from .device import PT_SLOTS

    # probe-layout guard: a file written under an older probe bucket
    # geometry must not feed mis-shaped rows to the device; drop the
    # device tables and let the first use rebuild them from the (always
    # valid) slot table — correct for every mode, just a slower first
    # start.  Scan/anchor tables need no guard: the engine derives
    # their slot geometry from the stored row width.
    stale = (
        "pt_rows" in z and z["pt_rows"].shape[1]
        != (4 if int(z["pt_window"]) == 4 else 3) * PT_SLOTS
    )
    if stale:
        return g

    jnp = None
    if stream_device:
        try:
            import jax.numpy as jnp
        except Exception:  # pragma: no cover - jax is a hard dep
            jnp = None

    def up(arr):
        """Async device upload of an artifact the moment it is read."""
        return jnp.asarray(arr) if jnp is not None else None

    # artifacts in ascending-size order, probe rows last (see docstring)
    umeta = z["d_umeta"]
    d_umeta = up(umeta)
    st = None
    d_st_fused = None
    if "st_keys" in z:
        st = ScanTable(z["st_keys"], z["st_vals"],
                       int(z["st_nb"]), int(z["st_seed"]))
        if jnp is not None:
            from ..engine.core import _fuse_scan_table

            d_st_fused = jnp.asarray(_fuse_scan_table(st))
    at = None
    d_at_fused = None
    if "at_keys" in z:
        at = ScanTable(z["at_keys"], z["at_vals"],
                       int(z["at_nb"]), int(z["at_seed"]))
        if jnp is not None:
            from ..engine.core import _fuse_scan_table

            d_at_fused = jnp.asarray(_fuse_scan_table(at))
    pool_rows = z["d_pool_rows"]
    d_pool_rows = up(pool_rows)
    def _load_mphf(z, pfx):
        from .device import HashTable
        from .mphf import MPHF

        final = None
        if f"{pfx}_f_khi" in z:
            final = HashTable(z[f"{pfx}_f_khi"], z[f"{pfx}_f_klo"],
                              z[f"{pfx}_f_vals"],
                              z[f"{pfx}_f_khi"].shape[0])
        return MPHF(
            n_keys=int(z[f"{pfx}_n_keys"]),
            gamma=float(z[f"{pfx}_gamma"]),
            n_levels=int(z[f"{pfx}_n_levels"]), words=z[f"{pfx}_words"],
            word_off=z[f"{pfx}_word_off"], mask=z[f"{pfx}_mask"],
            rank_base=z[f"{pfx}_rank_base"],
            samples=z[f"{pfx}_samples"],
            sample_off=z[f"{pfx}_sample_off"], final_tbl=final,
        )

    ma = None
    if "amph_words" in z:
        from .device import MphfAnchors

        ma = MphfAnchors(_load_mphf(z, "amph"), z["amph_arows"])
    mj = None
    if "mph_words" in z:
        from .device import HashTable, MphfJunction
        from .mphf import MPHF

        final = None
        if "mph_f_khi" in z:
            final = HashTable(z["mph_f_khi"], z["mph_f_klo"],
                              z["mph_f_vals"], z["mph_f_khi"].shape[0])
        mj = MphfJunction(
            MPHF(
                n_keys=int(z["mph_n_keys"]), gamma=float(z["mph_gamma"]),
                n_levels=int(z["mph_n_levels"]), words=z["mph_words"],
                word_off=z["mph_word_off"], mask=z["mph_mask"],
                rank_base=z["mph_rank_base"], samples=z["mph_samples"],
                sample_off=z["mph_sample_off"], final_tbl=final,
            ),
            z["mph_jrows"],
        )
    pt = None
    d_pt_rows = None
    if "pt_rows" in z:
        pt = ProbeTable(z["pt_rows"], int(z["pt_nb"]),
                        int(z["pt_seed"]), int(z["pt_window"]))
        d_pt_rows = up(pt.rows)
    di = DeviceIndex(
        k=g.k, pool=g.pool, pool_words=z["d_pool_words"],
        uoff=z["d_uoff"], ulen=z["d_ulen"],
        ubeg_hi=z["d_ubeg_hi"], ubeg_lo=z["d_ubeg_lo"],
        uend_hi=z["d_uend_hi"], uend_lo=z["d_uend_lo"],
        rcbeg_hi=z["d_rcbeg_hi"], rcbeg_lo=z["d_rcbeg_lo"],
        rcend_hi=z["d_rcend_hi"], rcend_lo=z["d_rcend_lo"],
        max_ulen=int(z["d_max_ulen"]),
        anchor_scan=at, scan_tbl=st,
        umeta=umeta, pool_rows=pool_rows,
        n_chunks=int(z["d_n_chunks"]), halo_bases=int(z["d_halo"]),
        probe_tbl=pt, mphf_junction=mj, anchor_mphf=ma,
        id_inv=(z["d_id_inv"] if "d_id_inv" in z else None),
    )
    if mj is not None:
        # attach the mphf view under its own cache attr so a
        # --index-layout mphf run starts device-ready; when the file
        # carries BOTH junction layouts, split into per-layout views so
        # engine.runner.get_device_index serves each faithfully
        if st is not None:
            from dataclasses import replace

            di_m = replace(di, scan_tbl=None)
            di = replace(di, mphf_junction=None)
            g._device_index_mphf = di_m
        else:
            g._device_index_mphf = di
            if jnp is not None:
                from ..engine.core import index_to_device

                index_to_device(di)   # async uploads start now
            return g
    if jnp is not None:
        # pre-seed the index_to_device memo with the in-flight uploads
        from ..engine.core import IndexArrays, _fuse_mphf

        if ma is not None:
            amph_rows_np, amph_f_np = _fuse_mphf(ma.mphf)
            amph = dict(
                amph_rows=jnp.asarray(amph_rows_np),
                amph_arows=jnp.asarray(ma.arows),
                amph_f=jnp.asarray(amph_f_np),
            )
        else:
            amph = dict(
                amph_rows=jnp.zeros((0, 5), jnp.uint32),
                amph_arows=jnp.zeros((0, 5), jnp.uint32),
                amph_f=jnp.zeros((0, 12), jnp.uint32),
            )
        di._ix_arrays = IndexArrays(
            st_fused=(d_st_fused if d_st_fused is not None
                      else jnp.zeros((0, 320), jnp.uint32)),
            st_seed=jnp.uint32(st.seed if st is not None else 0),
            umeta=d_umeta,
            pool_rows=d_pool_rows,
            n_chunks=jnp.int32(di.n_chunks),
            pt_rows=(d_pt_rows if d_pt_rows is not None
                     else jnp.zeros((0, 32), jnp.uint32)),
            pt_seed=jnp.uint32(pt.seed if pt is not None else 0),
            at_fused=(d_at_fused if d_at_fused is not None
                      else jnp.zeros((0, 160), jnp.uint32)),
            at_seed=jnp.uint32(at.seed if at is not None else 0),
            mph_rows=jnp.zeros((0, 5), jnp.uint32),
            mph_jrows=jnp.zeros((0, 10), jnp.uint32),
            mph_f=jnp.zeros((0, 12), jnp.uint32),
            **amph,
        )
    g._device_index = di
    return g


def _load_anchors(g: UnitigGraph, z) -> None:
    if "anchor_keys" in z:
        from .build import AnchorView

        # stored sorted; older files carried int64 vals (and no ucanon
        # column — the device build recomputes it for those)
        g.anchors = AnchorView(
            z["anchor_keys"], z["anchor_vals"].astype(np.int32),
            ucanon=(np.asarray(z["anchor_ucanon"], bool)
                    if "anchor_ucanon" in z else None),
        )


def _load_v1(z) -> UnitigGraph:
    """Legacy loader: dict-derived arrays only; the device index is
    rebuilt from the reconstructed slot table on first use."""
    g = UnitigGraph(
        k=int(z["k"]), n_unitigs=int(z["n_unitigs"]),
        pool=z["pool"], offsets=z["offsets"], lengths=z["lengths"],
        ubeg=z["ubeg"], uend=z["uend"],
        dog_mode=bool(z["dog_mode"]),
    )
    g.left = _arrays_to_dict(z["left_keys"], z["left_flat"], z["left_off"])
    g.right = _arrays_to_dict(z["right_keys"], z["right_flat"], z["right_off"])
    _load_anchors(g, z)
    # reconstruct the slot table so build_device_index takes the
    # vectorized path rather than the per-key python loop
    keys = np.union1d(
        np.fromiter(g.left.keys(), np.uint64, count=len(g.left)),
        np.fromiter(g.right.keys(), np.uint64, count=len(g.right)),
    )
    vals = np.zeros((len(keys), 8), np.int32)
    for i, key in enumerate(keys.tolist()):
        for j, uid in enumerate(g.left.get(key, [])[:4]):
            vals[i, j] = uid
        for j, uid in enumerate(g.right.get(key, [])[:4]):
            vals[i, 4 + j] = uid
    g.jkeys, g.jvals = keys, vals
    return g


# ---- legacy v1 writer kept for tests/back-compat tooling ----

def _dict_to_arrays(d: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """{key -> [ids]} -> (keys u64 [N], flat int32, off int64 [N+1])."""
    keys = np.fromiter(d.keys(), dtype=np.uint64, count=len(d))
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    lists = list(d.values())
    flat = []
    off = [0]
    for i in order:
        ids = lists[i]
        flat.extend(ids)
        off.append(off[-1] + len(ids))
    return keys, np.array(flat, np.int32), np.array(off, np.int64)


def _arrays_to_dict(keys, flat, off) -> dict:
    return {
        int(k): [int(v) for v in flat[off[i] : off[i + 1]]]
        for i, k in enumerate(keys)
    }


def save_graph(g: UnitigGraph, path: str) -> None:
    """Legacy v1 writer (graph only, dict-derived arrays)."""
    lk, lf, lo = _dict_to_arrays(g.left)
    rk, rf, ro = _dict_to_arrays(g.right)
    d = dict(
        magic=_MAGIC_V1, k=g.k, n_unitigs=g.n_unitigs,
        pool=g.pool, offsets=g.offsets, lengths=g.lengths,
        ubeg=g.ubeg, uend=g.uend,
        left_keys=lk, left_flat=lf, left_off=lo,
        right_keys=rk, right_flat=rf, right_off=ro,
        dog_mode=g.dog_mode,
        **_anchor_arrays(g),
    )
    np.savez_compressed(path, **d)


def load_graph(path: str) -> UnitigGraph:
    """Load either format (alias of load_index, kept for callers)."""
    return load_index(path)
