"""MST clustering engine — host reference implementation.

Re-derivation of the reference clust-mst pipeline (src/MST.cpp:216-807):
candidate pairs from shared sketch hashes, exact integer intersection counts,
Mash/AAF distances in float64, streaming Kruskal, threshold forest cut and
BFS component labeling.

The candidate generation here is fully vectorized NumPy (sort + run-length
pair expansion) — semantically identical to the reference's inverted-index
walk: a pair (i, j) is a candidate iff the sketches share >= 1 hash.  The
device engine in ops/ produces the same integer counts for dense pair
tiles; both feed this module's Kruskal/labeling.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..distance.mash import aaf_distance, mash_distance, size_ratio_limit
from .union_find import UnionFind

DENSE_SPAN = 100  # reference common.hpp:26 (buckets of 0.01)


# ---------------------------------------------------------------------------
# Candidate generation (shared-hash pairs with exact intersection counts)
# ---------------------------------------------------------------------------

def flatten_sketches(hashes: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate per-genome sorted hash arrays into (hash, gid) columns."""
    if not hashes:
        return (np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.int32))
    sizes = np.fromiter((len(h) for h in hashes), dtype=np.int64,
                        count=len(hashes))
    gid = np.repeat(np.arange(len(hashes), dtype=np.int32), sizes)
    hv = np.concatenate([np.asarray(h) for h in hashes])
    return hv, gid


def candidate_pair_counts(
    hashes: List[np.ndarray],
    start_index: int = 0,
    pair_chunk: int = 1 << 26,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (i, j, common) over all genome pairs sharing >= 1 hash.

    Always i < j.  With ``start_index`` > 0, only pairs whose larger id is a
    new genome (j >= start_index) are produced — the append-mode semantics
    of the reference (src/MST.cpp:394-400).

    Counts are *row-block complete*: a pair (i, j) is emitted exactly once,
    with its full count, when genome j's row block is processed (all shared
    hashes of the pair contribute in the same pass).  Blocks are sized so
    the expanded pair-instance buffer stays under ``pair_chunk`` entries.
    """
    n = len(hashes)
    if n < 2:
        return
    hv, gid = flatten_sketches(hashes)
    order = np.argsort(hv, kind="stable")  # stable => gid ascending within run
    gid_s = gid[order].astype(np.int64)
    hv_s = hv[order]
    boundaries = np.r_[True, hv_s[1:] != hv_s[:-1]]
    run_id = np.cumsum(boundaries) - 1
    starts = np.flatnonzero(boundaries)
    run_start = starts[run_id]                       # per position
    # pairs contributed by each position: all earlier members of its run
    # (gid ascending in a run, sketches deduplicated -> earlier == smaller id)
    count_p = np.arange(len(gid_s), dtype=np.int64) - run_start
    del hv, gid, hv_s, boundaries, run_id

    # per-genome instance totals -> adaptive row blocks under pair_chunk
    per_genome = np.zeros(n, dtype=np.int64)
    np.add.at(per_genome, gid_s, count_p)
    j0 = start_index
    while j0 < n:
        j1 = j0 + 1
        budget = per_genome[j0]
        while j1 < n and budget + per_genome[j1] <= pair_chunk:
            budget += per_genome[j1]
            j1 += 1
        sel = np.flatnonzero((gid_s >= j0) & (gid_s < j1) & (count_p > 0))
        if len(sel) == 0:
            j0 = j1
            continue
        cnt = count_p[sel]
        total = int(cnt.sum())
        j_arr = np.repeat(gid_s[sel], cnt)
        base = np.repeat(run_start[sel], cnt)
        offs = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(cnt) - cnt, cnt)
        i_arr = gid_s[base + offs]               # smaller ids within run
        keys = i_arr * n + j_arr
        uk, counts = np.unique(keys, return_counts=True)
        yield ((uk // n).astype(np.int64), (uk % n).astype(np.int64),
               counts.astype(np.int64))
        j0 = j1


def native_pair_counts(hashes: List[np.ndarray], j_min: float = 0.0,
                       ratio2: int = 0, start_index: int = 0,
                       threads: int = 0):
    """Native (i, j, common) over all pairs sharing >= 1 hash (i < j), with
    optional integer prefilters: common >= ceil(j_min*(sA+sB)/(1+j_min)) and
    max_size <= ratio2 * min_size.  Returns None when the native library is
    unavailable — callers fall back to candidate_pair_counts.  ~30-50x the
    NumPy instance-expansion path on dense clusters (rtc_pairs_*)."""
    import ctypes
    import os
    from ..utils import native as native_mod
    lib = native_mod.load_native()
    if lib is None or not hasattr(lib, "rtc_pairs_u32"):
        return None
    n = len(hashes)
    if n < 2:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy(), e.copy()
    use64 = hashes[0].dtype == np.uint64
    flat = np.concatenate(hashes).astype(np.uint64 if use64 else np.uint32)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(h) for h in hashes], out=offs[1:])
    fn = lib.rtc_pairs_u64 if use64 else lib.rtc_pairs_u32
    fn.restype = ctypes.c_void_p
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_double, ctypes.c_int, ctypes.c_int64,
                   ctypes.c_int]
    lib.rtc_pairs_count.restype = ctypes.c_int64
    lib.rtc_pairs_count.argtypes = [ctypes.c_void_p]
    lib.rtc_pairs_data.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p]
    lib.rtc_pairs_free.argtypes = [ctypes.c_void_p]
    h = fn(flat.ctypes.data, offs.ctypes.data, n, j_min, ratio2,
           start_index, threads or (os.cpu_count() or 1))
    try:
        m = int(lib.rtc_pairs_count(h))
        pi = np.empty(m, dtype=np.int32)
        pj = np.empty(m, dtype=np.int32)
        common = np.empty(m, dtype=np.int32)
        if m:
            lib.rtc_pairs_data(h, pi.ctypes.data, pj.ctypes.data,
                               common.ctypes.data)
    finally:
        lib.rtc_pairs_free(h)
    return (pi.astype(np.int64), pj.astype(np.int64),
            common.astype(np.int64))


# ---------------------------------------------------------------------------
# Edge construction + streaming Kruskal
# ---------------------------------------------------------------------------

Edges = Tuple[np.ndarray, np.ndarray, np.ndarray]  # (i int64, j int64, dist f64)


def _empty_edges() -> Edges:
    return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64),
            np.empty(0, dtype=np.float64))


def concat_edges(parts: List[Edges]) -> Edges:
    if not parts:
        return _empty_edges()
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]))


def sort_edges(e: Edges) -> Edges:
    """Sort by (dist, i, j) — deterministic tie order.  The reference sorts
    by dist only with unstable std::sort; single-linkage clusters are
    invariant to tie order, so only edge-file byte order can differ."""
    i, j, d = e
    order = np.lexsort((j, i, d))
    return i[order], j[order], d[order]


def kruskal(e: Edges, n: int, presorted: bool = False) -> Edges:
    """Minimum spanning forest via Kruskal (reference src/MST.cpp:59-75)."""
    if not presorted:
        e = sort_edges(e)
    i, j, d = e
    if len(i) == 0:
        return _empty_edges()
    uf = UnionFind(n)
    keep = np.zeros(len(i), dtype=bool)
    kept = 0
    find = uf.find
    parent = uf.parent
    rank = uf.rank
    for k in range(len(i)):
        a, b = i[k], j[k]
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        if rank[ra] < rank[rb]:
            ra, rb = rb, ra
        parent[rb] = ra
        if rank[ra] == rank[rb]:
            rank[ra] += 1
        keep[k] = True
        kept += 1
        if kept == n - 1:
            break
    return i[keep], j[keep], d[keep]


@dataclass
class MstResult:
    mst: Edges                          # spanning forest edges, Kruskal order
    n: int
    dense: Optional[np.ndarray] = None  # (DENSE_SPAN, n) cumulative counts
    ani: Optional[np.ndarray] = None    # (101,) histogram of int((1-d)*100)


def compute_mst(
    hashes: List[np.ndarray],
    threshold: float,
    kmer_size: int,
    is_containment: bool = False,
    start_index: int = 0,
    with_dense: bool = False,
    pre_edges: Optional[Edges] = None,
    backend: str = "auto",
    threads: int = 0,
) -> MstResult:
    """Full MST over candidate pairs (reference compute_kssd_mst semantics).

    ``pre_edges``: existing MST edges to merge (append mode,
    src/sub_command.cpp:1450-1457).  ``backend``: "auto" uses the native
    C++/OpenMP engine when available, "numpy" forces the vectorized host
    path (both produce identical MSTs modulo tie order).
    """
    n = len(hashes)
    if backend == "auto" and n >= 2:
        from ..utils import native as native_mod
        import os as _os
        res = native_mod.native_mst(hashes, threshold, kmer_size,
                                    is_containment, start_index, with_dense,
                                    threads or (_os.cpu_count() or 1))
        if res is not None:
            (mst, dense, ani) = res
            if pre_edges is not None and len(pre_edges[0]):
                mst = kruskal(concat_edges([pre_edges, mst]), n)
            return MstResult(mst=mst, n=n, dense=dense, ani=ani)
    sizes = np.array([len(h) for h in hashes], dtype=np.int64)
    radio = size_ratio_limit(threshold, kmer_size - 1)

    dense = np.zeros((DENSE_SPAN, n), dtype=np.int64) if with_dense else None
    ani = np.zeros(101, dtype=np.int64) if with_dense else None

    partial: List[Edges] = []
    if pre_edges is not None and len(pre_edges[0]):
        partial.append(pre_edges)
    budget = 0
    for i, j, common in candidate_pair_counts(hashes, start_index=start_index):
        s0 = sizes[i]
        s1 = sizes[j]
        mn = np.minimum(s0, s1)
        mx = np.maximum(s0, s1)
        ok = (mn > 0) & (mx <= radio * mn)
        if not ok.any():
            continue
        i, j, common, s0, s1 = i[ok], j[ok], common[ok], s0[ok], s1[ok]
        if is_containment:
            d = aaf_distance(common, s0, s1, kmer_size)
        else:
            d = mash_distance(common, s0, s1, kmer_size)
        if with_dense:
            radii = np.arange(DENSE_SPAN) / DENSE_SPAN
            t0 = np.searchsorted(radii, d, side="left")  # == std::lower_bound
            inb = t0 < DENSE_SPAN
            np.add.at(dense, (t0[inb], i[inb]), 1)
            np.add.at(dense, (t0[inb], j[inb]), 1)
            a = np.minimum(((1.0 - d) * 100.0).astype(np.int64), 100)
            np.add.at(ani, a, 1)
        partial.append((i, j, d))
        budget += len(i)
        if budget > 4 * max(n, 1):
            # streaming reduction: collapse buffered edges to a partial forest
            partial = [kruskal(concat_edges(partial), n)]
            budget = len(partial[0][0])

    mst = kruskal(concat_edges(partial), n)
    if with_dense:
        dense = np.cumsum(dense, axis=0)  # cumulative over radius buckets
    return MstResult(mst=mst, n=n, dense=dense, ani=ani)


# ---------------------------------------------------------------------------
# Forest cut, components, noise
# ---------------------------------------------------------------------------

def cut_forest(mst: Edges, threshold: float) -> Edges:
    i, j, d = mst
    keep = d <= threshold
    return i[keep], j[keep], d[keep]


def clusters_from_forest(forest: Edges, n: int) -> List[List[int]]:
    """Connected components via BFS, replicating reference member order
    (src/MST.cpp:109-142): adjacency in forest-edge order, BFS from the
    lowest unvisited id.  Native fast path (rtc_forest_clusters — the
    Python BFS costs ~3 s at 1M genomes); identical output
    (test_forest_clusters_native_matches_python)."""
    from collections import deque

    from ..utils import native as native_mod

    fi, fj, _ = forest
    lib = native_mod.load_native()
    if lib is not None and n:
        import ctypes
        ei = np.ascontiguousarray(fi, dtype=np.int64)
        ej = np.ascontiguousarray(fj, dtype=np.int64)
        order = np.empty(n, dtype=np.int32)
        bounds = np.empty(n + 1, dtype=np.int64)
        fn = lib.rtc_forest_clusters
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + \
            [ctypes.c_void_p] * 2
        nc = fn(ei.ctypes.data, ej.ctypes.data, len(ei), n,
                order.ctypes.data, bounds.ctypes.data)
        ol = order.tolist()
        return [ol[bounds[k]:bounds[k + 1]] for k in range(nc)]

    adj: List[List[int]] = [[] for _ in range(n)]
    for u, v in zip(fi.tolist(), fj.tolist()):
        adj[u].append(v)
        adj[v].append(u)
    visited = np.zeros(n, dtype=bool)
    res: List[List[int]] = []
    for s in range(n):
        if visited[s]:
            continue
        visited[s] = True
        q = deque([s])
        comp = [s]
        while q:
            k = q.popleft()
            for v in adj[k]:
                if visited[v]:
                    continue
                visited[v] = True
                q.append(v)
                comp.append(v)
        res.append(comp)
    return res


def get_noise_nodes(dense_row: np.ndarray, alpha: int = 2) -> np.ndarray:
    """Noise = nodes with density <= min(Q1-1, alpha) (src/MST.cpp:189-211).

    ``dense_row``: per-node neighbor counts at the cluster threshold bucket.
    """
    order = np.argsort(dense_row, kind="stable")
    q1 = int(dense_row[order[len(order) // 4]])
    thr = max(min(q1 - 1, alpha), 0)
    return order[dense_row[order] <= thr]


def modify_forest(forest: Edges, noise: np.ndarray) -> Edges:
    i, j, d = forest
    bad = np.isin(i, noise) | np.isin(j, noise)
    return i[~bad], j[~bad], d[~bad]
