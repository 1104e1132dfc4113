"""DBSCAN density clustering engine (clust-dbscan).

Re-derivation of reference src/dbscan.cpp:
  * neighbor criterion: Jaccard >= j_min(eps) with the reference's 1e-12
    tolerance (c*(1+t) + 1e-12 >= t*(sizeRef+sizeQry), dbscan.cpp:559-565),
    j_min = e^{-eps*k}/(2-e^{-eps*k});
  * size prefilter: sizeQry in [floor(t*sizeRef), ceil(sizeRef/t)]
    (dbscan.cpp:464-467);
  * optional per-point k-NN cap (approximate accelerator) and posting-list
    truncation max_posting (dbscan.cpp:81-365);
  * classic expansion with minPts *including* the point itself
    (dbscan.cpp:831-832); labels -1 unvisited / -2 noise / >=0 cluster;
    noise points reachable from a core point get relabeled (dbscan.cpp:870).
"""

from __future__ import annotations

import math
import sys
from collections import deque
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .mst import candidate_pair_counts, flatten_sketches


@dataclass
class DBSCANResult:
    clusters: List[List[int]]
    noise: List[int]
    labels: np.ndarray

    @property
    def num_clusters(self) -> int:
        return len(self.clusters)

    @property
    def num_noise(self) -> int:
        return len(self.noise)


def trim_postings(hashes, max_posting: int) -> List[np.ndarray]:
    """Drop hash keys whose GLOBAL posting size exceeds ``max_posting``
    (the reference's posting-list truncation accelerator,
    dbscan.cpp:81-365).  Deterministic given the full sketch store —
    the multihost engine applies it identically on every host."""
    n = len(hashes)
    hv, gid = flatten_sketches(hashes)
    order = np.argsort(hv, kind="stable")
    hv_s, gid_s = hv[order], gid[order]
    starts = np.flatnonzero(np.r_[True, hv_s[1:] != hv_s[:-1]])
    lens = np.diff(np.r_[starts, len(hv_s)])
    keep_run = lens <= max_posting
    keep_pos = np.repeat(keep_run, lens)
    kept_h = hv_s[keep_pos]
    kept_g = gid_s[keep_pos]
    ordg = np.argsort(kept_g, kind="stable")
    kept_g2, kept_h2 = kept_g[ordg], kept_h[ordg]
    bounds = np.searchsorted(kept_g2, np.arange(n + 1))
    return [np.sort(kept_h2[bounds[i]:bounds[i + 1]]) for i in range(n)]


def _neighbor_lists(hashes, eps: float, kmer_size: int, knn_k: int,
                    max_posting: int,
                    use_device: bool = False) -> List[np.ndarray]:
    """Adjacency (neighbors within eps) for every point.

    ``use_device`` routes candidate generation through the bitmap
    filter (ops/bitmap.py) — the DBSCAN neighbor criterion is exactly the
    threshold-bounded candidate set, so the filter's no-false-negative
    bound applies directly."""
    n = len(hashes)
    sizes = np.array([len(h) for h in hashes], dtype=np.int64)
    x = math.exp(-eps * kmer_size)
    t = x / (2.0 - x)  # jaccard_min
    if max_posting > 0:
        # sizes above stay the ORIGINAL sketch sizes: truncation only
        # drops candidate-generation keys, the jaccard test is unchanged
        hashes = trim_postings(hashes, max_posting)
    adj: List[List[int]] = [[] for _ in range(n)]
    adj_j: List[List[float]] = [[] for _ in range(n)]
    if use_device and max_posting <= 0:
        from ..ops.bitmap import candidate_pairs_threshold
        pair_iter = [candidate_pairs_threshold(hashes, eps, kmer_size)]
    else:
        from .mst import native_pair_counts
        nat = native_pair_counts(hashes)  # same pair set (common >= 1)
        pair_iter = [nat] if nat is not None \
            else candidate_pair_counts(hashes)
    for i, j, c in pair_iter:
        s0 = sizes[i].astype(np.float64)
        s1 = sizes[j].astype(np.float64)
        lhs = c.astype(np.float64) * (1.0 + t)
        rhs = t * (s0 + s1)
        ok = (lhs + 1e-12 >= rhs) & (sizes[i] > 0) & (sizes[j] > 0)
        # size prefilter (floor/ceil window) — same acceptance as the
        # jaccard test for passing pairs; kept for parity
        denom = s0 + s1 - c
        jac = np.where(denom > 0, c / np.maximum(denom, 1.0), 0.0)
        for a, b, jv in zip(i[ok].tolist(), j[ok].tolist(),
                            jac[ok].tolist()):
            adj[a].append(b)
            adj_j[a].append(jv)
            adj[b].append(a)
            adj_j[b].append(jv)
    if knn_k > 0:
        out = []
        for i in range(n):
            if len(adj[i]) > knn_k:
                # canonical tie order at the k-th cut: neighbor id ascending
                # within equal jaccard (pre-sort by id, then stable argsort)
                # — matches the multihost engine, and replaces the old
                # insertion order, which was thread-nondeterministic when
                # pairs came from the native rtc_pairs engine anyway
                ai = np.asarray(adj[i], dtype=np.int64)
                aj = np.asarray(adj_j[i])
                by_id = np.argsort(ai, kind="stable")
                ai, aj = ai[by_id], aj[by_id]
                idx = np.argsort(-aj, kind="stable")[:knn_k]
                out.append(ai[idx])
            else:
                out.append(np.asarray(adj[i], dtype=np.int64))
        return out
    return [np.asarray(a, dtype=np.int64) for a in adj]


def expand_labels(adj, n: int, min_pts: int,
                  include_self: bool) -> Tuple[np.ndarray, int]:
    """Shared DBSCAN label expansion over a fixed adjacency.

    ``include_self`` selects the KSSD convention (minPts counts the point
    itself, dbscan.cpp:831-832) vs the MinHash one (self excluded,
    dbscan.cpp:1017).  Given the adjacency SETS, the labels are
    BFS-order-independent: cluster ids are seeded in index order, a border
    point reachable from several clusters is always claimed by the
    lowest-seed cluster, and noise relabeling (dbscan.cpp:870) is a set
    property too — the multihost engine relies on this."""
    extra = 1 if include_self else 0
    labels = np.full(n, -1, dtype=np.int64)  # -1 unvisited, -2 noise
    cluster_id = 0
    for i in range(n):
        if labels[i] != -1:
            continue
        neighbors = adj[i]
        if len(neighbors) + extra < min_pts:
            labels[i] = -2
            continue
        labels[i] = cluster_id
        queue = deque(neighbors.tolist())
        enqueued = set(neighbors.tolist())
        while queue:
            q = queue.popleft()
            if labels[q] == -2:
                labels[q] = cluster_id  # border point reclaimed from noise
                continue
            if labels[q] != -1:
                continue
            labels[q] = cluster_id
            q_nbrs = adj[q]
            if len(q_nbrs) + extra >= min_pts:  # q is core: expand
                for v in q_nbrs.tolist():
                    if labels[v] in (-1, -2) and v not in enqueued:
                        enqueued.add(v)
                        queue.append(v)
        cluster_id += 1
    return labels, cluster_id


def result_from_labels(labels: np.ndarray, n: int, cluster_id: int,
                       drop_empty: bool = False) -> DBSCANResult:
    """Members/noise in genome-id order (the final loops of both reference
    engines); ``drop_empty`` replicates the MinHash engine's filter."""
    clusters: List[List[int]] = [[] for _ in range(cluster_id)]
    noise: List[int] = []
    for i in range(n):
        if labels[i] == -2:
            noise.append(i)
        elif labels[i] >= 0:
            clusters[labels[i]].append(i)
    if drop_empty:
        clusters = [c for c in clusters if c]
    return DBSCANResult(clusters=clusters, noise=noise, labels=labels)


def dbscan_cluster(hashes, eps: float, min_pts: int, kmer_size: int,
                   knn_k: int = 0, max_posting: int = 0,
                   use_device: bool = False) -> DBSCANResult:
    n = len(hashes)
    if knn_k > 0 and knn_k < min_pts - 1:
        print(f"-----WARNING: knn_k ({knn_k}) < minPts-1 ({min_pts - 1}). "
              f"Adjusting knn_k to {min_pts - 1}.", file=sys.stderr)
        knn_k = min_pts - 1
    adj = _neighbor_lists(hashes, eps, kmer_size, knn_k, max_posting,
                          use_device=use_device)
    labels, cluster_id = expand_labels(adj, n, min_pts, include_self=True)
    return result_from_labels(labels, n, cluster_id)


def _minhash_neighbor_lists(hashes, eps: float, kmer_size: int,
                            is_containment: bool) -> List[np.ndarray]:
    """Adjacency under the MinHash mash-distance criterion
    (reference findNeighborsMinHash, dbscan.cpp:685-719): dist <= eps with
    dist from MinHash::distance (or containDistance when isContainment),
    self excluded.  Distance formulas mirror RabbitSketch exactly:
    j = |A∩B| / |A∪B| (containment: / min(|A|,|B|)); j==1 -> 0, j==0 -> 1,
    else -log(2j/(1+j))/k (containment: -log(j)/k), clamped at 1.0."""
    n = len(hashes)
    sizes = np.array([len(h) for h in hashes], dtype=np.int64)
    adj: List[List[int]] = [[] for _ in range(n)]
    from .mst import native_pair_counts
    nat = native_pair_counts(hashes)  # all pairs with common >= 1
    pair_iter = [nat] if nat is not None else candidate_pair_counts(hashes)
    for i, j, c in pair_iter:
        cc = c.astype(np.float64)
        if is_containment:
            denom = np.minimum(sizes[i], sizes[j]).astype(np.float64)
        else:
            denom = (sizes[i] + sizes[j]).astype(np.float64) - cc
        jac = np.where(denom > 0, cc / np.maximum(denom, 1.0), 0.0)
        with np.errstate(divide="ignore"):
            if is_containment:
                dist = -np.log(jac) / kmer_size
            else:
                dist = -np.log(2.0 * jac / (1.0 + jac)) / kmer_size
        dist = np.minimum(dist, 1.0)
        dist = np.where(jac >= 1.0, 0.0, np.where(jac <= 0.0, 1.0, dist))
        ok = dist <= eps
        for a, b in zip(i[ok].tolist(), j[ok].tolist()):
            adj[a].append(b)
            adj[b].append(a)
    if eps >= 1.0:
        # j == 0 pairs have dist exactly 1.0 <= eps: everything neighbors
        # everything (including common == 0 pairs the index never yields)
        full = np.arange(n, dtype=np.int64)
        return [np.delete(full, i) for i in range(n)]
    return [np.asarray(sorted(set(a)), dtype=np.int64) for a in adj]


def minhash_dbscan_cluster(hashes, eps: float, min_pts: int, kmer_size: int,
                           is_containment: bool = False) -> DBSCANResult:
    """The reference's latent MinHashDBSCAN (dbscan.cpp:987-1097 —
    CLI-unreachable there because main.cpp:481-484 requires --fast).

    Semantics differ from the KSSD engine in two ways we replicate:
    minPts counts neighbors EXCLUDING the point itself
    (``neighbors.size() < minPts``, dbscan.cpp:1017), and the neighbor
    test is mash-distance <= eps with no 1e-12 tolerance."""
    n = len(hashes)
    adj = _minhash_neighbor_lists(hashes, eps, kmer_size, is_containment)
    labels, cluster_id = expand_labels(adj, n, min_pts, include_self=False)
    return result_from_labels(labels, n, cluster_id, drop_empty=True)


def write_dbscan_result(result: DBSCANResult, ss, output_file: str,
                        eps: float, min_pts: int) -> None:
    """printKssdDBSCANResult format (dbscan.cpp:1212-1278): clusters, then
    each noise point as its own cluster."""
    with open(output_file, "w") as fp:
        fp.write(f"# DBSCAN clustering parameters: eps={eps:.6f}, "
                 f"minPts={min_pts}\n")
        fp.write(f"# Total clusters: {result.num_clusters}\n")
        if result.num_noise > 0:
            fp.write(f"# Total noise points (outliers): {result.num_noise}\n")
        fp.write("#\n")
        by_file = ss.sketch_by_file

        def row(local, gid):
            if by_file:
                fp.write("\t%5d\t%6d\t%12dnt\t%20s\t%20s\t%s\n" % (
                    local, gid, ss.total_lens[gid], ss.file_names[gid],
                    ss.names[gid], ss.comments[gid]))
            else:
                fp.write("\t%6d\t%6d\t%12dnt\t%20s\t%s\n" % (
                    local, gid, ss.seq0_lens[gid], ss.names[gid],
                    ss.comments[gid]))

        for ci, members in enumerate(result.clusters):
            fp.write(f"the cluster {ci} is: \n")
            for li, gid in enumerate(members):
                row(li, gid)
            fp.write("\n")
        for k, gid in enumerate(result.noise):
            fp.write(f"the cluster {result.num_clusters + k} is: \n")
            row(0, gid)
            fp.write("\n")
