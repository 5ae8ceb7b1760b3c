"""K-mer arithmetic on (hi, lo) uint32 pairs.

The engine runs without 64-bit integers (JAX's default 32-bit mode),
so kmers (up to 64 bits at k=32) are carried as two uint32 lanes.  All functions are written with
plain operators so they work on BOTH numpy arrays (host index build)
and jnp arrays (device kernels) with identical wrap-around semantics.

Conventions: an n-mer occupies the LOW 2n bits of the (hi, lo) pair,
first base in the highest occupied 2 bits (reference str2num order).
"""

from __future__ import annotations

_M32 = 0xFFFFFFFF


def split64(v):
    """uint64 array -> (hi, lo) uint32 arrays (numpy host helper)."""
    import numpy as np

    v = np.asarray(v, dtype=np.uint64)
    return (v >> np.uint64(32)).astype(np.uint32), (v & np.uint64(_M32)).astype(np.uint32)


def join64(hi, lo):
    """(hi, lo) -> uint64 (numpy host helper)."""
    import numpy as np

    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)


import numpy as _np

_C1 = _np.uint32(0x9E3779B9)
_C2 = _np.uint32(0x85EBCA6B)
_C3 = _np.uint32(0xC2B2AE35)


def mix32(hi, lo):
    """Hash of a kmer pair -> uint32.  murmur3-style finalizer; must be
    bit-identical between the numpy table build and the jnp lookup.
    Constants carry dtype uint32 so neither numpy nor jax promotes."""
    h = lo ^ (hi * _C1)
    h ^= h >> 16
    h = h * _C2
    h ^= h >> 13
    h = h * _C3
    h ^= h >> 16
    return h


_H2A = _np.uint32(0x7FEB352D)
_H2B = _np.uint32(0x846CA68B)


def mix32b(hi, lo):
    """Second, independent hash of a kmer pair (two-choice bucketing).
    Same numpy/jnp bit-parity contract as mix32."""
    return mix32(lo ^ _H2A, hi ^ _H2B)


def rev2_32(x):
    """Reverse the sixteen 2-bit groups within each uint32."""
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    x = (x << 16) | (x >> 16)
    return x


_FULL = _np.uint32(0xFFFFFFFF)


def rcb_pair(hi, lo, n: int):
    """Reverse complement of an n-mer pair (semantics of reference rcb,
    utils.cpp:182-192).  n is static."""
    # complement: 3-b == b^3 per 2-bit group == full bitwise NOT
    chi = hi ^ _FULL
    clo = lo ^ _FULL
    # reverse 2-bit groups across the 64-bit value: swap words + rev each
    rhi = rev2_32(clo)
    rlo = rev2_32(chi)
    # the n-mer sat in the low 2n bits; after the full 64-bit reversal it
    # sits in the HIGH 2n bits -> shift right by 64-2n
    s = 64 - 2 * n
    if s == 0:
        return rhi, rlo
    if s < 32:
        lo2 = (rlo >> s) | (rhi << (32 - s))
        hi2 = rhi >> s
        return hi2, lo2
    if s == 32:
        return rhi * 0, rhi
    return rhi * 0, rhi >> (s - 32)


def rev_pair(hi, lo, n: int):
    """Pure 2-bit-group reversal of an n-mer pair (rcb_pair WITHOUT the
    complement): turns a little-endian packed extraction (base p+j at
    bits 2j) into the big-endian kmer value convention (first base most
    significant).  n is static."""
    rhi = rev2_32(lo)
    rlo = rev2_32(hi)
    s = 64 - 2 * n
    if s == 0:
        return rhi, rlo
    if s < 32:
        lo2 = (rlo >> s) | (rhi << (32 - s))
        hi2 = rhi >> s
        return hi2, lo2
    if s == 32:
        return rhi * 0, rhi
    return rhi * 0, rhi >> (s - 32)


def pair_eq(ahi, alo, bhi, blo):
    return (ahi == bhi) & (alo == blo)


def pair_le(ahi, alo, bhi, blo):
    return (ahi < bhi) | ((ahi == bhi) & (alo <= blo))


def pair_min(ahi, alo, bhi, blo, where_fn):
    le = pair_le(ahi, alo, bhi, blo)
    return where_fn(le, ahi, bhi), where_fn(le, alo, blo)
