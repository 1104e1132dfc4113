"""Bucketed dense packing of variable-size sketches for the device pair engine.

Variable-size sorted hash arrays don't tile; the device engine instead
operates on a dense per-genome layout:

    plane0[g, w, k] (uint32), optionally plane1[g, w, k] for 64-bit hashes

where k indexes K hash-space buckets and w indexes W slots per bucket.
Bucketing uses a *bijective* mix (Knuth/Fibonacci multiplicative hashing) so
that equality of stored values within a bucket is exactly equality of the
original hashes:

  32-bit: m = h * 2654435761 mod 2^32 (bijection);  bucket = m >> (32-b);
          stored value = m & (2^(32-b) - 1)  < 2^(32-b)  (top bit clear).
  64-bit: m = h * 0x9E3779B97F4A7C15 mod 2^64 (bijection); bucket = m >>
          (64-b); plane0 = m & 0xFFFFFFFF, plane1 = (m >> 32) & (2^(32-b)-1).

Padding: empty slots are filled with 0x80000000 | genome_id (in plane1 for
the 64-bit layout).  Real values never have the top bit set, and pads of
*different* genomes never equal each other, so a cross-genome equality is
always a true hash match — no pad correction term is needed.

W is the max bucket occupancy over the dataset (rounded up to a multiple of
4); b adapts upward if W would exceed ``max_width``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

_MIX32 = np.uint32(2654435761)
_MIX64 = np.uint64(0x9E3779B97F4A7C15)
PAD = np.uint32(0xFFFFFFFF)


@dataclass
class PackedSketches:
    plane0: np.ndarray            # (N, W, K) uint32
    plane1: Optional[np.ndarray]  # (N, W, K) uint32 or None (32-bit hashes)
    sizes: np.ndarray             # (N,) int32 — true sketch sizes
    bucket_bits: int
    width: int

    @property
    def n(self) -> int:
        return self.plane0.shape[0]

    @property
    def k(self) -> int:
        return self.plane0.shape[2]

    def row_block(self, start: int, count: int) -> "PackedSketches":
        sl = slice(start, start + count)
        return PackedSketches(
            plane0=self.plane0[sl], sizes=self.sizes[sl],
            plane1=None if self.plane1 is None else self.plane1[sl],
            bucket_bits=self.bucket_bits, width=self.width)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pack_sketches(hashes: List[np.ndarray], use64: bool,
                  bucket_bits: Optional[int] = None,
                  max_width: int = 32, pad_n_to: int = 8) -> PackedSketches:
    n = len(hashes)
    sizes = np.array([len(h) for h in hashes], dtype=np.int32)
    avg = max(int(sizes.mean()) if n else 1, 1)
    if bucket_bits is None:
        bucket_bits = max(6, int(np.ceil(np.log2(avg))))
    total_bits = 64 if use64 else 32

    while True:
        k = 1 << bucket_bits
        shift = np.uint64(total_bits - bucket_bits) if use64 else \
            np.uint32(total_bits - bucket_bits)
        # flatten and mix
        gid = np.concatenate(
            [np.full(len(hashes[i]), i, dtype=np.int64) for i in range(n)]) \
            if n else np.empty(0, dtype=np.int64)
        hv = np.concatenate([np.asarray(h) for h in hashes]) if n else \
            np.empty(0, dtype=np.uint64 if use64 else np.uint32)
        with np.errstate(over="ignore"):
            if use64:
                m = hv.astype(np.uint64) * _MIX64
                bucket = (m >> shift).astype(np.int64)
                v0 = (m & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                v1 = ((m >> np.uint64(32)) &
                      np.uint64((1 << (32 - bucket_bits)) - 1
                                if bucket_bits < 32 else 0)).astype(np.uint32)
            else:
                m = hv.astype(np.uint32) * _MIX32
                bucket = (m >> shift).astype(np.int64)
                v0 = (m & np.uint32((1 << (32 - bucket_bits)) - 1)).astype(
                    np.uint32)
                v1 = None
        # occupancy per (genome, bucket)
        cell = gid * k + bucket
        if len(cell):
            order = np.argsort(cell, kind="stable")
            cell_s = cell[order]
            starts = np.flatnonzero(np.r_[True, cell_s[1:] != cell_s[:-1]])
            lens = np.diff(np.r_[starts, len(cell_s)])
            width = int(lens.max())
        else:
            order = cell.astype(np.int64)
            starts = np.empty(0, dtype=np.int64)
            lens = np.empty(0, dtype=np.int64)
            width = 1
        if width <= max_width or bucket_bits >= total_bits - 1:
            break
        bucket_bits += 1

    w = max(_round_up(width, 4), 4)
    n_pad = max(_round_up(n, pad_n_to), pad_n_to)
    # per-genome pads: top bit set + genome id -> cross-genome inequality
    pad_col = (np.uint32(0x80000000) |
               np.arange(n_pad, dtype=np.uint32))[:, None, None]
    plane0 = np.broadcast_to(pad_col, (n_pad, w, k)).copy()
    plane1 = np.broadcast_to(pad_col, (n_pad, w, k)).copy() if use64 else None
    if len(cell):
        slot = np.arange(len(cell_s)) - np.repeat(starts, lens)
        g_s = cell_s // k
        b_s = cell_s % k
        plane0[g_s, slot, b_s] = v0[order]
        if use64:
            plane1[g_s, slot, b_s] = v1[order]
    sizes_pad = np.zeros(n_pad, dtype=np.int32)
    sizes_pad[:n] = sizes
    packed = PackedSketches(plane0=plane0, plane1=plane1, sizes=sizes_pad,
                            bucket_bits=bucket_bits, width=w)
    packed._true_n = n  # type: ignore[attr-defined]
    return packed
