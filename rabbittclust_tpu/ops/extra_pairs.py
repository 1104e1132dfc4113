"""Pairwise distances for the extra sketch types (WMH / HLL / OMH).

The reference reaches these only through the legacy dense all-pairs path
(modifyMST, src/MST.cpp:809-1018: no prefilter, every (i, j) scored with the
sketch type's ->distance() virtual).  Device formulation: WMH and OMH
similarities are *positional token matches* — sample s of genome i matches
sample s of genome j iff all token components are equal — so the whole
N x N similarity matrix is one batched integer-equality reduction on
device (int32 compare + sum, elementwise; no matrix product needed since
S is tiny).  HLL needs per-pair register maxima (not a positional match);
computed host-side in f64 NumPy chunks.

Distances returned as float64 NumPy matrices; integer match counts are
exact, so device and host paths agree bit-for-bit.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np

from ..sketch.extra import HllSketch, OmhSketch, WMinHashSketch, hll_distance


def _to_planes(cols: List[np.ndarray]) -> np.ndarray:
    """Stack 64-bit token columns (each (N, S)) into (N, S, 2*len(cols))
    uint32 planes (lo, hi per column)."""
    planes = []
    for c in cols:
        c = c.astype(np.uint64)
        planes.append((c & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        planes.append((c >> np.uint64(32)).astype(np.uint32))
    return np.stack(planes, axis=-1)


def _match_counts_numpy(tok: np.ndarray) -> np.ndarray:
    n = tok.shape[0]
    out = np.empty((n, n), dtype=np.int32)
    for i in range(n):
        eq = np.all(tok[i][None, :, :] == tok, axis=-1)
        out[i] = eq.sum(axis=-1, dtype=np.int32)
    return out


@functools.lru_cache(maxsize=1)
def _jitted_match():
    import jax
    import jax.numpy as jnp

    def fn(ti, t):
        eq = jnp.all(ti[:, None, :, :] == t[None, :, :, :], axis=-1)
        return jnp.sum(eq, axis=-1, dtype=jnp.int32)

    return jax.jit(fn)


def pairwise_tuple_matches(tok: np.ndarray, device: bool = True,
                           row_block: int = 512) -> np.ndarray:
    """(N, S, C) uint32 token planes -> (N, N) int32 positional match counts
    (count of s where all C planes are equal).  Device path when JAX is
    usable; NumPy fallback is bit-identical (integer equality)."""
    n = tok.shape[0]
    if n == 0:
        return np.zeros((0, 0), dtype=np.int32)
    if not device:
        return _match_counts_numpy(tok)
    try:
        import jax.numpy as jnp
        from ..utils.jaxcfg import configure_jax
        configure_jax()
        td = jnp.asarray(tok)
        fn = _jitted_match()
        rows = []
        for r0 in range(0, n, row_block):
            rows.append(np.asarray(fn(td[r0:r0 + row_block], td)))
        return np.concatenate(rows, axis=0)
    except Exception:  # pragma: no cover - device unavailable
        return _match_counts_numpy(tok)


def _mash_from_jaccard(j: np.ndarray, kmer_size: int) -> np.ndarray:
    d = np.ones_like(j, dtype=np.float64)
    mid = (j > 0.0) & (j < 1.0)
    d[mid] = np.minimum(
        -1.0 / kmer_size * np.log(2.0 * j[mid] / (1.0 + j[mid])), 1.0)
    d[j >= 1.0] = 0.0
    return d


def wmh_pair_distances(sketches: List[WMinHashSketch],
                       device: bool = True) -> np.ndarray:
    """1 - (fraction of matching (idx, y) samples) for all pairs
    (== sketch.extra.wminhash_distance)."""
    n = len(sketches)
    if n == 0:
        return np.zeros((0, 0), dtype=np.float64)
    idx = np.stack([s.idx for s in sketches])
    y = np.stack([s.y for s in sketches]).astype(np.int64)
    tok = _to_planes([idx, y.view(np.uint64)])
    counts = pairwise_tuple_matches(tok, device=device)
    return 1.0 - counts.astype(np.float64) / idx.shape[1]


def omh_pair_distances(sketches: List[OmhSketch], kmer_size: int,
                       device: bool = True) -> np.ndarray:
    """Mash-transformed fraction of identical ordered l-tuples for all pairs
    (== sketch.extra.omh_distance)."""
    n = len(sketches)
    if n == 0:
        return np.zeros((0, 0), dtype=np.float64)
    vecs = np.stack([s.vectors for s in sketches])  # (N, m, l)
    tok = _to_planes([vecs[:, :, c] for c in range(vecs.shape[2])])
    counts = pairwise_tuple_matches(tok, device=device)
    j = counts.astype(np.float64) / vecs.shape[1]
    return _mash_from_jaccard(j, kmer_size)


def hll_pair_distances(sketches: List[HllSketch],
                       kmer_size: int) -> np.ndarray:
    """Pairwise HLL Mash distances (inclusion-exclusion Jaccard), f64 host
    math == sketch.extra.hll_distance pairwise."""
    n = len(sketches)
    out = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for j in range(i + 1, n):
            d = hll_distance(sketches[i], sketches[j], kmer_size)
            out[i, j] = out[j, i] = d
    return out
