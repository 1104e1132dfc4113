"""Fast exact threshold clustering: bitmap filter + union-find-gated verify.

The single-linkage partition at threshold d is the connected components of
the graph of pairs with dist <= d.  Key observation: once two genomes are in
the same component, no further edge between that component's members can
change the partition — so their candidate pairs never need exact
verification.  Processing candidates in decreasing bitmap similarity makes
most true edges arrive first, collapsing components early; the number of
exact verifications drops from O(#candidates) to roughly
O(N + #cross-component rejects) while the result stays exactly the
single-linkage partition (every cross-component candidate is verified).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..cluster.union_find import UnionFind
from ..distance.mash import aaf_distance, mash_distance
from .bitmap import CsrSketches, candidate_pair_blocks


def threshold_clusters_device(
    hashes: List[np.ndarray],
    threshold: float,
    kmer_size: int,
    is_containment: bool = False,
    bits: int = 8192,
    row_block: int = 4096,
    verify_chunk: int = 65536,
    engine: str = "auto",
) -> List[List[int]]:
    """Exact single-linkage clusters at ``threshold`` (BFS-ordered like the
    reference MST cut; see cluster.mst.clusters_from_forest).

    Two device engines, auto-selected by size (override with ``engine`` or
    RTC_CLUSTER_ENGINE=stream|lp):

    * "stream" (small N): candidate blocks stream from the device filter
      with one-block prefetch (ops.bitmap.candidate_pair_blocks), so the
      host verifies block b while the device filters block b+1.  Pulls
      O(N^2/8) packed-mask bytes (or compacted indices when sparse).
    * "lp" (large N): device-resident label propagation
      (ops.labelprop.threshold_clusters_device_lp) — masks stay in HBM and
      each Boruvka round pulls only O(N) proposal bytes, breaking the
      O(N^2/8) transfer floor.  A few more dispatch round-trips, so it wins
      once the mask transfer dominates (n_pad >= 32768 by default).
    """
    n = len(hashes)
    if n == 0:
        return []
    bits = int(os.environ.get("RTC_CLUSTER_BITS", bits))
    row_block = int(os.environ.get("RTC_CLUSTER_RB", row_block))
    engine = os.environ.get("RTC_CLUSTER_ENGINE", engine)
    if engine == "auto":
        # crossover set on other hardware; re-decided on the H100 by
        # ROADMAP 1.6
        engine = "lp" if n > 16384 else "stream"
    if engine == "lp":
        from .labelprop import threshold_clusters_device_lp
        return threshold_clusters_device_lp(
            hashes, threshold, kmer_size, is_containment=is_containment,
            bits=bits, row_block=max(row_block, 4096))
    sizes = np.array([len(h) for h in hashes], dtype=np.int64)

    uf = UnionFind(n)
    kept_i: List[int] = []
    kept_j: List[int] = []
    kept_d: List[float] = []
    csr = CsrSketches(hashes)  # built once, reused across verify rounds
    from ..utils.profiling import maybe_trace
    with maybe_trace("bitmap_filter_cluster"):
        for ii, jj in candidate_pair_blocks(
                hashes, threshold, kmer_size, is_containment=is_containment,
                bits=bits, row_block=row_block):
            _gated_verify_block(uf, csr, sizes, ii, jj, threshold, kmer_size,
                                is_containment, kept_i, kept_j, kept_d,
                                verify_chunk)
    # components -> clusters in reference BFS order: build forest from kept
    # edges (they span every component) and BFS from lowest id
    from ..cluster.mst import clusters_from_forest, kruskal
    forest = kruskal((np.asarray(kept_i, dtype=np.int64),
                      np.asarray(kept_j, dtype=np.int64),
                      np.asarray(kept_d, dtype=np.float64)), n)
    return clusters_from_forest(forest, n)


def threshold_clusters_device_exact_order(
    hashes: List[np.ndarray],
    threshold: float,
    kmer_size: int,
    is_containment: bool = False,
    **kwargs,
) -> "tuple[List[List[int]], bool]":
    """Device-partition clusters with the reference's -t 1 member order.

    Phase 1 (device): exact partition via threshold_clusters_device.
    Phase 2 (host): rtc_intra_mst replays the reference's serial
    streaming-Kruskal cadence (subSize=8 blocks by global id, unstable
    dist-only std::sort + Kruskal, MST.cpp:388-766) over the
    WITHIN-cluster candidate stream, cuts at the threshold and BFS-orders
    members exactly like generateClusterWithBfs (MST.cpp:109-142).

    Returns (clusters, certified): the member order is ALWAYS the -t 1
    reference's.  ``certified`` True means the cheap intra replay
    sufficed: no hash is shared across clusters, so the replayed stream
    (and every unstable-tie permutation in it) provably equals the global
    -t 1 engine's.  When cross-cluster sharing exists, tie groups
    interleaved with cross-cluster candidates can permute differently
    (measured: 128/4800 tie-substituted tree edges on an adversarial
    corpus), so the full global parity engine runs instead — same bytes,
    serial-cadence cost (the -t 1 tax is inherent: the reference's output
    is DEFINED by an unstable introsort permutation chain over the full
    candidate stream; no restricted replay can shortcut it)."""
    from ..cluster.mst import clusters_from_forest, cut_forest
    from ..utils.native import native_intra_mst, native_mst

    n = len(hashes)
    clusters = threshold_clusters_device(hashes, threshold, kmer_size,
                                         is_containment=is_containment,
                                         **kwargs)
    res = native_intra_mst(hashes,
                           labels_from_clusters(clusters, n), threshold,
                           kmer_size, is_containment, abort_on_cross=True)
    if res is None:  # no native library: keep the fast BFS order
        return clusters, False
    edges, has_cross = res
    if has_cross:
        full = native_mst(hashes, threshold, kmer_size, is_containment,
                          0, False, 1)
        if full is None:
            return clusters, False
        edges = full[0]
    ordered = clusters_from_forest(cut_forest(edges, threshold), n)
    # partition-identity guard: the (label_a, label_b) relation must be a
    # bijection (distinct pairs == clusters on both sides)
    la = labels_from_clusters(clusters, n).astype(np.int64)
    lb = labels_from_clusters(ordered, n).astype(np.int64)
    if len(np.unique(la * len(ordered) + lb)) != len(clusters) or \
            len(clusters) != len(ordered):
        raise RuntimeError(
            "intra-MST order finish changed the partition "
            f"({len(ordered)} vs {len(clusters)} clusters) — engine bug")
    return ordered, not has_cross


def labels_from_clusters(clusters: List[List[int]], n: int) -> np.ndarray:
    labels = np.empty(n, dtype=np.int32)
    for ci, members in enumerate(clusters):
        labels[members] = ci
    return labels


def gated_verify_merge(uf, csr, sizes, ii, jj, threshold, kmer_size,
                       is_containment):
    """Exact-verify the (ii, jj) pairs and merge passes into ``uf`` in one
    native pass (count_common + float64 libm distance + union-find, see
    rtc_verify_merge_* in native/rtc_native.cpp).  Returns
    (kept_i, kept_j, kept_d, ok): the kept edges — pairs that verified at
    d <= threshold AND connected two previously separate components — in
    input order, plus the per-pair verified-pass mask (False = verified
    FAIL, the caller's clear-list), exactly like the count/distance/merge
    loop it replaces (ops/labelprop.py rounds).  libm log keeps distances
    bit-identical to the native MST engine; the NumPy fallback may differ
    by 1 ulp (cannot change any partition)."""
    import ctypes
    from ..utils import native as native_mod

    m = len(ii)
    if m == 0:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy(), np.empty(0, dtype=np.float64), \
            np.empty(0, dtype=bool)
    lib = native_mod.load_native()
    if lib is not None:
        fn = (lib.rtc_verify_merge_u64 if csr.use64
              else lib.rtc_verify_merge_u32)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_double, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int]
        ii64 = np.ascontiguousarray(ii, dtype=np.int64)
        jj64 = np.ascontiguousarray(jj, dtype=np.int64)
        sizes64 = np.ascontiguousarray(sizes, dtype=np.int64)
        assert uf.parent.dtype == np.int64 and uf.rank.dtype == np.int8
        out_i = np.empty(m, dtype=np.int64)
        out_j = np.empty(m, dtype=np.int64)
        out_d = np.empty(m, dtype=np.float64)
        ok = np.empty(m, dtype=np.uint8)
        kept = fn(csr.flat.ctypes.data, csr.offs.ctypes.data,
                  ii64.ctypes.data, jj64.ctypes.data, m,
                  sizes64.ctypes.data, ctypes.c_double(threshold),
                  kmer_size, int(is_containment), uf.parent.ctypes.data,
                  uf.rank.ctypes.data, out_i.ctypes.data,
                  out_j.ctypes.data, out_d.ctypes.data, ok.ctypes.data,
                  os.cpu_count() or 1)
        return out_i[:kept], out_j[:kept], out_d[:kept], ok.astype(bool)
    common = csr.count_common(ii, jj)
    if is_containment:
        d = aaf_distance(common, sizes[ii], sizes[jj], kmer_size)
    else:
        d = mash_distance(common, sizes[ii], sizes[jj], kmer_size)
    ok = (common > 0) & (d <= threshold)
    ki, kj, kd = [], [], []
    for a, b, dd in zip(ii[ok].tolist(), jj[ok].tolist(), d[ok].tolist()):
        if not uf.connected(a, b):
            uf.merge(a, b)
            ki.append(a)
            kj.append(b)
            kd.append(dd)
    return (np.asarray(ki, dtype=np.int64), np.asarray(kj, dtype=np.int64),
            np.asarray(kd, dtype=np.float64), ok)


def _gated_verify_block(uf, csr, sizes, ii, jj, threshold, kmer_size,
                        is_containment, kept_i, kept_j, kept_d,
                        verify_chunk=65536, max_rounds=48):
    """Round-structured exact verification of one candidate block.

    Gating insight: a pair whose endpoints are already connected cannot
    change the single-linkage partition — but with bulk verification the
    gate barely fires, because candidates arrive row-major and row i's pairs
    are all alive the first time i is seen.  Instead, verify in Borůvka-like
    rounds: pick ONE candidate per live (root_i, root_j) component pair
    (round 1 degenerates to one per row), verify that small batch exactly,
    merge the passes, re-gate.  A row whose first candidate is a true edge
    joins its component immediately and its remaining pairs die in the next
    gate — verifications drop from O(#candidates) to roughly
    O(N + #failed candidates) while the partition stays exactly the
    single-linkage one (every cross-component candidate is either verified
    or gated by an already-verified connection).  After ``max_rounds`` the
    remainder falls back to bulk chunked verification, bounding the
    worst-case (adversarially failing candidates) at the old cost."""
    pi, pj = ii, jj
    rounds = 0
    while len(pi):
        roots = uf.roots_array()
        ri = roots[pi]
        rj = roots[pj]
        alive = ri != rj
        pi, pj, ri, rj = pi[alive], pj[alive], ri[alive], rj[alive]
        if len(pi) == 0:
            break
        rounds += 1
        if rounds == 1:
            # bootstrap: roots are mostly fresh, so root-pair dedup would
            # degenerate to "verify everything"; one candidate per row
            # connects most rows to their component in a single batch
            _, sel = np.unique(pi, return_index=True)
        elif rounds <= max_rounds:
            # first occurrence per unordered live root pair
            lo = np.minimum(ri, rj)
            hi = np.maximum(ri, rj)
            key = lo * np.int64(len(uf.parent) + 1) + hi
            _, sel = np.unique(key, return_index=True)
        else:  # fallback: bulk-verify a chunk (degenerate candidate sets)
            sel = np.arange(min(len(pi), verify_chunk))
        ci, cj = pi[sel], pj[sel]
        common = csr.count_common(ci, cj)
        if is_containment:
            d = aaf_distance(common, sizes[ci], sizes[cj], kmer_size)
        else:
            d = mash_distance(common, sizes[ci], sizes[cj], kmer_size)
        ok = (common > 0) & (d <= threshold)
        for a, b, dd in zip(ci[ok].tolist(), cj[ok].tolist(),
                            d[ok].tolist()):
            if not uf.connected(a, b):
                uf.merge(a, b)
                kept_i.append(a)
                kept_j.append(b)
                kept_d.append(dd)
        keep = np.ones(len(pi), dtype=bool)
        keep[sel] = False  # verified pairs (pass or fail) leave the pool
        pi, pj = pi[keep], pj[keep]
