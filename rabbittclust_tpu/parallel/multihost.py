"""Multi-host (DCN) distribution layer — process-sharded genomes over a
global device mesh.

The reference is single-node shared-memory only (SURVEY.md §2.14); this
layer is new design, not a port.  Topology:

  * N processes (one per host), each owning its local cards; a global
    1-D "data" mesh spans every card of every host
    (``jax.distributed.initialize`` + ``jax.devices()``).
  * genomes are data-parallel across processes in contiguous global-id
    blocks (``shard_bounds``); each process ingests + sketches ONLY its
    block on its own host (process-sharded ingest — no host ever touches
    the full FASTA set).
  * each process bit-packs its rows and contributes them to a globally
    sharded signature array (``jax.make_array_from_process_local_data``);
    the SAME bitmap-filter ring as the single-process engine
    (dist_engine.build_ring_bitmap_fn) runs over the global mesh — the
    ``ppermute`` hops ride NVLink within a host and the network between
    hosts, with
    no host in the loop.
  * compacted candidates land on the device owning the row shard; each
    process exact-verifies ITS candidates against the allgathered sketch
    store (sketches are ~genome_len/4096 — the full store fits every host
    by design, mirroring the reference's in-RAM sketch vectors) and the
    per-process verified edge forests are allgathered (DCN, tiny) and
    merged by a deterministic Kruskal on every process — all hosts end
    with identical clusters, no further communication.

Exactness: the ring covers every global pair exactly once (triangular
schedule), the bitmap bound has no false negatives, verification uses the
native two-pointer kernel and float64 distances — the partition equals the
single-host engine's bit-exactly.

Launching on real pods: run one copy of the program per host with
  init_multihost("host0:8476", num_processes=N, process_id=i)
before any other JAX call (same contract as jax.distributed.initialize).
For CPU simulation (tests, dry-runs), ``launch_local_sim`` spawns N local
processes with M virtual CPU devices each.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import List, Optional, Tuple

import numpy as np


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int,
                   virtual_cpu_devices: Optional[int] = None) -> None:
    """Initialize the JAX distributed runtime.  MUST run before any JAX
    backend query.  ``virtual_cpu_devices`` forces a CPU simulation with
    that many virtual devices per process (tests / dry-runs)."""
    if virtual_cpu_devices is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        want = f"--xla_force_host_platform_device_count={virtual_cpu_devices}"
        if "--xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (flags + " " + want).strip()
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh():
    """1-D "data" mesh over every device of every process."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), axis_names=("data",))


def shard_bounds(n_total: int, num_processes: int,
                 process_id: int) -> Tuple[int, int]:
    """Contiguous genome block [lo, hi) owned by ``process_id``.  Blocks
    follow the device-shard layout of a length-``n_pad`` array sharded over
    the global mesh: padding (if any) lands in the LAST process."""
    per = -(-n_total // num_processes)
    lo = min(process_id * per, n_total)
    return lo, min(lo + per, n_total)


def _allgather_ragged(local: np.ndarray) -> List[np.ndarray]:
    """Allgather 1-D arrays of DIFFERENT lengths across processes (pad to
    the global max, gather, trim).  Returns one array per process.

    Gathers raw BYTES (uint8 view): process_allgather routes through JAX,
    which silently truncates float64 -> float32 and (u)int64 -> 32-bit
    while x64 is off — byte views keep every dtype bit-exact.  Per-process
    payloads are bounded by int32 byte lengths (< 2 GiB), far above any
    sketch-store or edge-forest shard."""
    from jax.experimental import multihost_utils

    dt = local.dtype
    raw = np.ascontiguousarray(local).view(np.uint8).reshape(-1)
    assert len(raw) < (1 << 31)
    n = np.int32(len(raw))
    lens = np.asarray(multihost_utils.process_allgather(n)).reshape(-1)
    m = int(lens.max()) if len(lens) else 0
    padded = np.zeros(m, dtype=np.uint8)
    padded[:len(raw)] = raw
    gathered = np.asarray(multihost_utils.process_allgather(padded))
    return [np.ascontiguousarray(gathered[p, :int(lens[p])]).view(dt)
            for p in range(len(lens))]


def allgather_sketches(local_hashes: List[np.ndarray],
                       use64: bool) -> List[np.ndarray]:
    """Gather every process's per-genome hash arrays, in process (= global
    id) order, so each host holds the full sketch store for verification."""
    dt = np.uint64 if use64 else np.uint32
    flat = (np.concatenate(local_hashes).astype(dt) if local_hashes
            else np.empty(0, dtype=dt))
    sizes = np.array([len(h) for h in local_hashes], dtype=np.int64)
    flats = _allgather_ragged(flat)
    sizess = _allgather_ragged(sizes)
    out: List[np.ndarray] = []
    for f, s in zip(flats, sizess):
        offs = np.zeros(len(s) + 1, dtype=np.int64)
        np.cumsum(s, out=offs[1:])
        out.extend(f[offs[g]:offs[g + 1]] for g in range(len(s)))
    return out


def _global_sharded(mesh, local_np: np.ndarray):
    """Build a globally sharded jax.Array (axis 0 over "data") from this
    process's contiguous row block."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("data")), local_np)


def multihost_candidate_pairs_bitmap(
        local_hashes: List[np.ndarray], n_total: int, threshold: float,
        kmer_size: int, is_containment: bool = False, bits: int = 8192,
        cap: Optional[int] = None, radio: Optional[int] = None,
        mesh=None) -> Tuple[np.ndarray, np.ndarray]:
    """Bitmap-filter candidates over the GLOBAL (multi-process) mesh.

    Each process passes only its own contiguous genome block; returns the
    candidate pairs (global ids, i > j, unverified) whose owning row shard
    lives on this process's devices.  Union over processes = the exact
    single-host candidate set (dist_engine.distributed_candidate_pairs_
    bitmap)."""
    import math
    import jax
    from jax.experimental import multihost_utils
    from ..distance.mash import min_jaccard_for_threshold, size_ratio_limit
    from ..ops.bitmap import _pull_quantum, pack_bitmaps_packed
    from .dist_engine import _n_ring_steps, build_ring_bitmap_fn

    if mesh is None:
        mesh = global_mesh()
    n_dev = int(mesh.devices.size)
    n_proc = jax.process_count()
    pid = jax.process_index()
    lo, hi = shard_bounds(n_total, n_proc, pid)
    if len(local_hashes) != hi - lo:
        raise ValueError(
            f"process {pid} passed {len(local_hashes)} local sketches but "
            f"owns the global block [{lo}, {hi}) of n_total={n_total}; "
            f"slice the input with shard_bounds(n_total, {n_proc}, {pid})")
    # global row padding: every process block padded to the same length so
    # device shards align (n_pad = per * n_proc, divisible by n_dev)
    per = -(-n_total // n_proc)
    if n_dev % n_proc != 0:
        raise ValueError(
            f"the global mesh has {n_dev} devices across {n_proc} processes "
            f"— devices must divide evenly per process (pods do); got "
            f"{n_dev} % {n_proc} != 0")
    dev_per_proc = n_dev // n_proc
    per = -(-per // dev_per_proc) * dev_per_proc
    n_pad = per * n_proc
    xp_l, coll_l = pack_bitmaps_packed(local_hashes, bits=bits, pad_n_to=1)
    # pack pads rows only to a multiple of pad_n_to=1; extend to `per`
    if xp_l.shape[0] < per:
        xp_l = np.vstack([xp_l, np.zeros((per - xp_l.shape[0], bits // 8),
                                         dtype=np.uint8)])
        coll_l = np.concatenate(
            [coll_l, np.zeros(per - len(coll_l), dtype=np.int32)])
    xp_l, coll_l = xp_l[:per], coll_l[:per]
    sizes_l = np.zeros(per, dtype=np.int32)
    sizes_l[:len(local_hashes)] = [len(h) for h in local_hashes]
    row_ids_l = (lo + np.arange(per)).astype(np.int32)

    j_min = min_jaccard_for_threshold(threshold, kmer_size)
    c_min = math.exp(-threshold * kmer_size)
    if radio is None:
        radio = size_ratio_limit(threshold, kmer_size - 1)
    shard = n_pad // n_dev
    if cap is None:
        cap = max(1 << 16, shard * shard // 16)

    from jax.sharding import PartitionSpec as P
    args = (_global_sharded(mesh, xp_l), _global_sharded(mesh, coll_l),
            _global_sharded(mesh, sizes_l), _global_sharded(mesh, row_ids_l))
    while True:
        ring_fn = build_ring_bitmap_fn(cap, j_min, 1.0 + j_min, c_min,
                                       radio, is_containment)
        fn = jax.shard_map(
            ring_fn, mesh=mesh,
            in_specs=(P("data"), P("data"), P("data"), P("data")),
            out_specs=P("data"), check_vma=False)
        out = jax.jit(fn)(*args)  # global (n_dev*n_steps, 1 + 2*cap)
        # this process decodes ONLY its addressable row-shard outputs
        local_blocks = [np.asarray(s.data) for s in out.addressable_shards]
        max_local = max((int(b[:, 0].max()) for b in local_blocks
                         if b.size), default=0)
        # cap growth must be agreed globally (same compiled ring everywhere)
        max_cnt = int(np.asarray(multihost_utils.process_allgather(
            np.int64(max_local))).max())
        if max_cnt <= cap:
            break
        while cap < max_cnt:
            cap *= 4
    ii_all, jj_all = [], []
    for b in local_blocks:
        for row in b:
            c = int(row[0])
            if c:
                ii_all.append(row[1:1 + c])
                jj_all.append(row[1 + cap:1 + cap + c])
    if not ii_all:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy()
    ii = np.concatenate(ii_all).astype(np.int64)
    jj = np.concatenate(jj_all).astype(np.int64)
    # canonical host orientation (i > j) — see the dist_engine ring decode
    ii, jj = np.maximum(ii, jj), np.minimum(ii, jj)
    keep = (ii < n_total) & (jj < n_total)
    return ii[keep], jj[keep]


def multihost_threshold_clusters(
        local_hashes: List[np.ndarray], n_total: int, threshold: float,
        kmer_size: int, is_containment: bool = False, bits: int = 8192,
        cap: Optional[int] = None, mesh=None) -> List[List[int]]:
    """Exact single-linkage partition at ``threshold`` across hosts.

    Every process returns the identical full partition (BFS-ordered from
    the merged forest).  Pipeline: global bitmap ring -> per-process gated
    native exact verify of its own candidates -> allgather of the verified
    edge forests -> deterministic Kruskal + BFS on every host."""
    from jax.experimental import multihost_utils
    from ..cluster.mst import clusters_from_forest, kruskal
    from ..cluster.union_find import UnionFind
    from ..ops.bitmap import CsrSketches
    from ..ops.cluster_fast import _gated_verify_block

    if mesh is None:
        mesh = global_mesh()
    use64 = bool(np.asarray(multihost_utils.process_allgather(np.int64(
        len(local_hashes) > 0 and local_hashes[0].dtype == np.uint64
    ))).max())
    ii, jj = multihost_candidate_pairs_bitmap(
        local_hashes, n_total, threshold, kmer_size,
        is_containment=is_containment, bits=bits, cap=cap, mesh=mesh)
    # full sketch store on every host (sketches are tiny by design)
    all_hashes = allgather_sketches(local_hashes, use64)
    assert len(all_hashes) == n_total, (len(all_hashes), n_total)
    sizes = np.array([len(h) for h in all_hashes], dtype=np.int64)
    uf = UnionFind(n_total)
    csr = CsrSketches(all_hashes)
    ki: List[int] = []
    kj: List[int] = []
    kd: List[float] = []
    _gated_verify_block(uf, csr, sizes, ii, jj, threshold, kmer_size,
                        is_containment, ki, kj, kd)
    # merge per-process forests: ragged allgather, then deterministic
    # Kruskal on the union — identical result on every host
    gi = np.concatenate(_allgather_ragged(np.asarray(ki, dtype=np.int64)))
    gj = np.concatenate(_allgather_ragged(np.asarray(kj, dtype=np.int64)))
    gd = np.concatenate(_allgather_ragged(np.asarray(kd, dtype=np.float64)))
    forest = kruskal((gi, gj, gd), n_total)
    return clusters_from_forest(forest, n_total)


def multihost_mst(local_hashes: List[np.ndarray], n_total: int,
                  threshold: float, kmer_size: int,
                  is_containment: bool = False, bits: int = 8192,
                  cap: Optional[int] = None, mesh=None):
    """Distributed MST across hosts via the bitmap ring: exact for every
    cut <= threshold (see dist_engine.distributed_mst engine="bitmap").
    Every process returns the identical MstResult."""
    from jax.experimental import multihost_utils
    from ..cluster.mst import MstResult, kruskal
    from ..distance.mash import aaf_distance, mash_distance
    from ..ops.bitmap import CsrSketches

    if mesh is None:
        mesh = global_mesh()
    use64 = bool(np.asarray(multihost_utils.process_allgather(np.int64(
        len(local_hashes) > 0 and local_hashes[0].dtype == np.uint64
    ))).max())
    ii, jj = multihost_candidate_pairs_bitmap(
        local_hashes, n_total, threshold, kmer_size,
        is_containment=is_containment, bits=bits, cap=cap, mesh=mesh)
    all_hashes = allgather_sketches(local_hashes, use64)
    sizes = np.array([len(h) for h in all_hashes], dtype=np.int64)
    common = CsrSketches(all_hashes).count_common(ii, jj).astype(np.int64)
    nz = common > 0
    ii, jj, common = ii[nz], jj[nz], common[nz]
    if is_containment:
        d = aaf_distance(common, sizes[ii], sizes[jj], kmer_size)
    else:
        d = mash_distance(common, sizes[ii], sizes[jj], kmer_size)
    # per-process partial MST (<= N-1 edges) -> allgather -> global Kruskal
    part = kruskal((ii, jj, d), n_total)
    gi = np.concatenate(_allgather_ragged(part[0]))
    gj = np.concatenate(_allgather_ragged(part[1]))
    gd = np.concatenate(_allgather_ragged(part[2]))
    return MstResult(mst=kruskal((gi, gj, gd), n_total), n=n_total)


def multihost_similarity_graph(local_hashes: List[np.ndarray], n_total: int,
                               threshold: float, kmer_size: int,
                               bits: int = 8192, cap: Optional[int] = None,
                               mesh=None):
    """Leiden similarity graph across hosts: edge iff dist < threshold and
    size ratio >= 0.5, weight = 1 - dist (leiden.cpp:188-256 semantics) —
    identical edge set and float64 weights as
    cluster.leiden.build_similarity_graph on every host.

    The global bitmap ring generates candidates (ratio prefilter widened to
    cover the Leiden >= 0.5 window); each process exact-verifies ITS
    candidates against the allgathered sketch store; the per-process edge
    lists are allgathered (tiny) so every host holds the full graph."""
    import math
    from jax.experimental import multihost_utils
    from ..distance.mash import mash_distance
    from ..ops.bitmap import CsrSketches

    if mesh is None:
        mesh = global_mesh()
    use64 = bool(np.asarray(multihost_utils.process_allgather(np.int64(
        len(local_hashes) > 0 and local_hashes[0].dtype == np.uint64
    ))).max())
    radio_safe = max(2, int(math.ceil(2.0 * math.exp(
        threshold * kmer_size))) + 1)
    ii, jj = multihost_candidate_pairs_bitmap(
        local_hashes, n_total, threshold, kmer_size, bits=bits, cap=cap,
        radio=radio_safe, mesh=mesh)
    all_hashes = allgather_sketches(local_hashes, use64)
    sizes = np.array([len(h) for h in all_hashes], dtype=np.int64)
    common = CsrSketches(all_hashes).count_common(ii, jj).astype(np.int64)
    nz = common > 0
    ii, jj, common = ii[nz], jj[nz], common[nz]
    s0, s1 = sizes[ii], sizes[jj]
    ratio = np.minimum(s0, s1) / np.maximum(np.maximum(s0, s1), 1)
    d = np.clip(mash_distance(common, s0, s1, kmer_size), 0.0, 1.0)
    ok = (ratio >= 0.5) & (d < threshold)
    frm = np.minimum(ii[ok], jj[ok])
    to = np.maximum(ii[ok], jj[ok])
    ww = 1.0 - d[ok]
    # allgather per-process edges; canonical (frm, to) sort -> identical
    # graph arrays on every host regardless of ring decode order
    gf = np.concatenate(_allgather_ragged(frm))
    gt = np.concatenate(_allgather_ragged(to))
    gw = np.concatenate(_allgather_ragged(ww))
    order = np.lexsort((gt, gf))
    return gf[order], gt[order], gw[order], all_hashes


def multihost_leiden(local_hashes: List[np.ndarray], n_total: int,
                     threshold: float, kmer_size: int,
                     resolution: float = 1.0, use_leiden: bool = True,
                     knn_k: int = 0, bits: int = 8192,
                     cap: Optional[int] = None, mesh=None,
                     edge_parallel: bool = False) -> List[List[int]]:
    """Distributed clust-leiden: graph build sharded across hosts, then the
    deterministic Louvain/Leiden runs on every host over the identical
    merged graph — all processes return the same partition as the
    single-host cluster.leiden.community_clusters."""
    from ..cluster.leiden import _knn_prune, cluster_graph

    frm, to, ww, _ = multihost_similarity_graph(
        local_hashes, n_total, threshold, kmer_size, bits=bits, cap=cap,
        mesh=mesh)
    graph = _knn_prune(frm, to, ww, knn_k)
    return cluster_graph(n_total, graph, resolution, use_leiden,
                         edge_parallel=edge_parallel)


def multihost_greedy(local_hashes: List[np.ndarray], n_total: int,
                     threshold: float, kmer_size: int,
                     is_containment: bool = False, batch: int = 2048):
    """Distributed greedy clustering with EXACT serial semantics.

    Returns (clusters_in_sorted_space, order) — identical on every process
    and equal to greedy_cluster(sorted_hashes, presorted=True) on the
    kssd greedy order (reference KssdGreedyClusterWithInvertedIndex,
    greedy.cpp:566-899).

    Design: sketches are allgathered (tiny by design); the O(N x postings)
    SCORING phase — probing each genome against the representative
    inverted index — is sharded across processes per batch; the serial
    commit is replayed identically on every host.  Exactness on intra-batch
    conflicts: a genome whose batch created an earlier new rep that could
    beat-or-tie its pre-scored best is re-probed against the live index,
    preserving the serial engine's first-touch tie order (a strictly-worse
    new rep can never win under the strict '>' rule, so the pre-scored
    winner stands)."""
    import math
    import jax
    from jax.experimental import multihost_utils
    from ..cluster.greedy import RepInvertedIndex
    from ..distance.mash import min_jaccard_for_threshold
    from ..sketch.base import stdsort_size_desc

    use64 = bool(np.asarray(multihost_utils.process_allgather(np.int64(
        len(local_hashes) > 0 and local_hashes[0].dtype == np.uint64
    ))).max())
    all_hashes = allgather_sketches(local_hashes, use64)
    sizes0 = np.array([len(h) for h in all_hashes], dtype=np.int64)
    order = stdsort_size_desc(sizes0)
    inv = [all_hashes[i] for i in order]
    sizes = sizes0[order]
    n = n_total
    j_min = min_jaccard_for_threshold(threshold, kmer_size)
    c_min = math.exp(-threshold * kmer_size)
    n_proc = jax.process_count()
    pid = jax.process_index()

    index = RepInvertedIndex()
    representatives = [0]
    rep2cid = {0: 0}
    members: List[List[int]] = [[]]
    if n:
        index.add_representative(0, inv[0])

    def pair_sim(g: int, r: int) -> float:
        """Similarity of (g, r) under the greedy bound filter; -1 = no
        candidate (same math as greedy_cluster's inner loop).  The sizes
        alone bound |A∩B| <= min(|A|, |B|), so size-incompatible pairs
        skip the O(s) set intersection entirely — the conflict scan over a
        batch's new reps is dominated by these rejects."""
        sg, sr = int(sizes[g]), int(sizes[r])
        mn = min(sg, sr)
        if is_containment:
            bound = math.ceil(c_min * mn)
        else:
            bound = math.ceil(j_min * (sg + sr) / (1.0 + j_min))
        if mn < bound:
            return -1.0
        common = len(np.intersect1d(inv[g], inv[r], assume_unique=True))
        if common < bound:
            return -1.0
        if is_containment:
            return 1.0 if mn == 0 else common / mn
        denom = sg + sr - common
        return 1.0 if denom == 0 else common / denom

    def score(g: int):
        touched, counts = index.probe(inv[g])
        best_sim, best_rep = -1.0, -1
        sg = int(sizes[g])
        for rep_id, common in zip(touched, counts):
            sr = int(sizes[rep_id])
            if is_containment:
                mn = min(sg, sr)
                if common < math.ceil(c_min * mn):
                    continue
                sim = 1.0 if mn == 0 else common / mn
            else:
                common_min = math.ceil(j_min * (sg + sr) / (1.0 + j_min))
                if common < common_min:
                    continue
                denom = sg + sr - common
                sim = 1.0 if denom == 0 else common / denom
            if sim > best_sim:  # strict: first-touch wins ties
                best_sim = sim
                best_rep = rep_id
        return best_sim, best_rep

    b0 = 1
    while b0 < n:
        b1 = min(b0 + batch, n)
        gs = np.arange(b0, b1, dtype=np.int64)
        lo, hi = shard_bounds(len(gs), n_proc, pid)
        my_sim = np.empty(hi - lo, dtype=np.float64)
        my_rep = np.empty(hi - lo, dtype=np.int64)
        for t, g in enumerate(gs[lo:hi].tolist()):
            s, r = score(g)
            my_sim[t], my_rep[t] = s, r
        sims = np.concatenate(_allgather_ragged(my_sim))
        reps_pre = np.concatenate(_allgather_ragged(my_rep))
        new_reps: List[int] = []
        for t, g in enumerate(gs.tolist()):
            best_sim, best_rep = float(sims[t]), int(reps_pre[t])
            # conflict: an intra-batch new rep is a CANDIDATE (passes the
            # bound) and beats-or-ties the pre-scored best — only then can
            # the serial outcome differ, so re-probe against the live index
            if any(s >= 0.0 and s >= best_sim
                   for s in (pair_sim(g, r) for r in new_reps)):
                best_sim, best_rep = score(g)  # exact serial re-probe
            if best_rep != -1:
                members[rep2cid[best_rep]].append(g)
            else:
                rep2cid[g] = len(representatives)
                representatives.append(g)
                members.append([])
                index.add_representative(g, inv[g])
                new_reps.append(g)
        b0 = b1
    clusters = [[rep] + mem for rep, mem in zip(representatives, members)]
    return clusters, order


def multihost_dbscan(local_hashes: List[np.ndarray], n_total: int,
                     eps: float, min_pts: int, kmer_size: int,
                     knn_k: int = 0, max_posting: int = 0,
                     minhash: bool = False, is_containment: bool = False,
                     bits: int = 8192, cap: Optional[int] = None, mesh=None):
    """Distributed clust-dbscan across hosts (KSSD or MinHash semantics).

    Pipeline: global bitmap ring at threshold=eps (a no-false-negative
    superset of the neighbor criterion — jaccard >= x/(2-x) with
    x = e^{-eps*k} implies size ratio <= 2/x, covered by the widened
    ``radio``) -> each process exact-verifies ITS candidates against the
    allgathered sketch store -> edge allgather -> identical serial
    expansion on every host (cluster.dbscan.expand_labels).

    Exactness: labels equal the single-host engine's because expansion
    outcomes depend only on the adjacency SETS (see expand_labels).  For
    knn_k > 0 the per-node cap breaks exact-jaccard ties at the k-th
    neighbor canonically (neighbor id ascending within equal jaccard) —
    the single-host _neighbor_lists uses the SAME canonical order, so the
    two engines agree even at tied cuts.  Mirrors
    dbscan_cluster / minhash_dbscan_cluster (reference dbscan.cpp:559-565,
    831-870, 987-1097)."""
    import math
    import jax
    from jax.experimental import multihost_utils
    from ..cluster.dbscan import (expand_labels, result_from_labels,
                                  trim_postings)
    from ..ops.bitmap import CsrSketches

    if minhash and (knn_k or max_posting):
        raise ValueError("knn_k/max_posting are KSSD-engine accelerators; "
                         "the MinHash DBSCAN engine has neither "
                         "(dbscan.cpp:987-1097)")
    if is_containment and not minhash:
        raise ValueError("is_containment applies to the MinHash DBSCAN "
                         "criterion only (KSSD dbscan has no containment "
                         "mode, dbscan.cpp:559-565)")
    if mesh is None:
        mesh = global_mesh()
    n_proc = jax.process_count()
    pid = jax.process_index()
    use64 = bool(np.asarray(multihost_utils.process_allgather(np.int64(
        len(local_hashes) > 0 and local_hashes[0].dtype == np.uint64
    ))).max())
    all_hashes = allgather_sketches(local_hashes, use64)
    # criterion sizes are the ORIGINAL sketch sizes even under truncation
    sizes = np.array([len(h) for h in all_hashes], dtype=np.int64)
    if knn_k > 0 and knn_k < min_pts - 1:
        knn_k = min_pts - 1  # dbscan_cluster's adjustment, warning elided
    if max_posting > 0:
        all_hashes = trim_postings(all_hashes, max_posting)
        lo, hi = shard_bounds(n_total, n_proc, pid)
        local_hashes = all_hashes[lo:hi]
    x = math.exp(-eps * kmer_size)
    t = x / (2.0 - x)  # jaccard_min
    if minhash and eps >= 1.0:
        # dist caps at 1.0 <= eps: everything neighbors everything,
        # including common == 0 pairs the ring never yields
        full = np.arange(n_total, dtype=np.int64)
        adj = [np.delete(full, i) for i in range(n_total)]
        labels, k = expand_labels(adj, n_total, min_pts, include_self=False)
        return result_from_labels(labels, n_total, k, drop_empty=True)
    # containment jaccard is size-ratio-free (c/min ignores the max side):
    # radio=0 DISABLES the ring's ratio gate (None would substitute the MST
    # default and silently drop high-ratio containment neighbors);
    # otherwise widen the ring ratio prefilter to the criterion's bound
    radio = 0 if (minhash and is_containment) else max(
        2, int(math.ceil(2.0 / x))) + 1
    ii, jj = multihost_candidate_pairs_bitmap(
        local_hashes, n_total, eps, kmer_size,
        is_containment=minhash and is_containment, bits=bits, cap=cap,
        radio=radio, mesh=mesh)
    common = CsrSketches(all_hashes).count_common(ii, jj).astype(np.int64)
    nz = common > 0  # both engines enumerate index pairs (common >= 1) only
    ii, jj, common = ii[nz], jj[nz], common[nz]
    s0 = sizes[ii].astype(np.float64)
    s1 = sizes[jj].astype(np.float64)
    cc = common.astype(np.float64)
    if minhash:
        if is_containment:
            denom = np.minimum(sizes[ii], sizes[jj]).astype(np.float64)
        else:
            denom = s0 + s1 - cc
        jac = np.where(denom > 0, cc / np.maximum(denom, 1.0), 0.0)
        with np.errstate(divide="ignore"):
            if is_containment:
                dist = -np.log(jac) / kmer_size
            else:
                dist = -np.log(2.0 * jac / (1.0 + jac)) / kmer_size
        dist = np.minimum(dist, 1.0)
        dist = np.where(jac >= 1.0, 0.0, np.where(jac <= 0.0, 1.0, dist))
        ok = dist <= eps
    else:
        ok = (cc * (1.0 + t) + 1e-12 >= t * (s0 + s1)) \
            & (sizes[ii] > 0) & (sizes[jj] > 0)
    denomj = s0 + s1 - cc
    jacv = np.where(denomj > 0, cc / np.maximum(denomj, 1.0), 0.0)
    a = np.minimum(ii[ok], jj[ok])
    b = np.maximum(ii[ok], jj[ok])
    jv = jacv[ok]
    ga = np.concatenate(_allgather_ragged(a))
    gb = np.concatenate(_allgather_ragged(b))
    gj = np.concatenate(_allgather_ragged(jv))
    # canonical lexsort + dedupe -> identical edge arrays on every host
    order = np.lexsort((gb, ga))
    ga, gb, gj = ga[order], gb[order], gj[order]
    if len(ga):
        keep = np.r_[True, (ga[1:] != ga[:-1]) | (gb[1:] != gb[:-1])]
        ga, gb, gj = ga[keep], gb[keep], gj[keep]
    # adjacency (both directions), neighbor-id ascending per node
    src = np.concatenate([ga, gb])
    dst = np.concatenate([gb, ga])
    wts = np.concatenate([gj, gj])
    order2 = np.lexsort((dst, src))
    src, dst, wts = src[order2], dst[order2], wts[order2]
    bounds = np.searchsorted(src, np.arange(n_total + 1))
    adj = [dst[bounds[i]:bounds[i + 1]] for i in range(n_total)]
    if knn_k > 0:
        for i in range(n_total):
            if len(adj[i]) > knn_k:
                w = wts[bounds[i]:bounds[i + 1]]
                idx = np.argsort(-w, kind="stable")[:knn_k]
                adj[i] = adj[i][idx]
    labels, k = expand_labels(adj, n_total, min_pts,
                              include_self=not minhash)
    return result_from_labels(labels, n_total, k, drop_empty=minhash)


def multihost_repdb_query(state, local_query_hashes: List[np.ndarray],
                          topk: int) -> List[List[dict]]:
    """Sharded RepDB probe (distributed serving of --db --query).

    Every process holds a replica of the RepDB state (loaded from the same
    file — the reference serving model, sub_command.cpp query verb) and
    probes ONLY its contiguous query shard; per-query hit rows
    (rep_idx, distance) are allgathered and every host reconstructs the
    full ordered hit lists from its replica — identical to the serial
    ``[state.query_topk(q, topk) for q in queries]`` over the concatenated
    query shards.  Works for both KssdClusterState and MinHashClusterState
    (same query_topk contract)."""
    counts: List[int] = []
    reps: List[int] = []
    dists: List[float] = []
    for q in local_query_hashes:
        hits = state.query_topk(q, topk)
        counts.append(len(hits))
        for h in hits:
            reps.append(h["rep_idx"])
            dists.append(h["distance"])
    gc = np.concatenate(_allgather_ragged(
        np.asarray(counts, dtype=np.int64)))
    gr = np.concatenate(_allgather_ragged(np.asarray(reps, dtype=np.int64)))
    gd = np.concatenate(_allgather_ragged(
        np.asarray(dists, dtype=np.float64)))
    out: List[List[dict]] = []
    off = 0
    for c in gc.tolist():
        row = []
        for t in range(c):
            rep_idx = int(gr[off + t])
            gid = state.representative_ids[rep_idx]
            row.append({
                "rep_idx": rep_idx, "genome_id": gid,
                "genome_name": state.file_names[gid],
                "distance": float(gd[off + t]), "cluster_id": rep_idx,
                "cluster_size": len(state.clusters[rep_idx]),
            })
        out.append(row)
        off += c
    return out


def multihost_repdb_assign(state,
                           local_query_hashes: List[np.ndarray]
                           ) -> List[dict]:
    """Sharded RepDB assignment: top-1 probe + the threshold acceptance of
    ``state.assign`` replayed on the gathered hits (identical to the
    serial assign loop over the concatenated query shards)."""
    res = multihost_repdb_query(state, local_query_hashes, 1)
    out = []
    for hits in res:
        if hits and hits[0]["distance"] <= state.threshold:
            out.append(hits[0])
        else:
            out.append({"rep_idx": -1, "genome_id": -1,
                        "genome_name": "unassigned", "distance": -1.0,
                        "cluster_id": -1, "cluster_size": 0})
    return out


# ----------------------------------------------------------------------
# CPU-simulation launcher + self-test child (used by tests and the driver
# dry-run; mirrors how a real pod launch would run one process per host)

def launch_local_sim(num_processes: int = 2, devices_per_proc: int = 4,
                     n_genomes: int = 48, port: int = 0,
                     timeout: float = 420.0) -> List[str]:
    """Spawn ``num_processes`` local processes, each with
    ``devices_per_proc`` virtual CPU devices, running the multihost
    self-test (see _sim_child).  Returns each child's last stdout line."""
    import socket
    if port == 0:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
    procs = []
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    for pid in range(num_processes):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "rabbittclust_tpu.parallel.multihost",
             str(pid), str(num_processes), str(port),
             str(devices_per_proc), str(n_genomes)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise RuntimeError("multihost sim timed out")
        if p.returncode != 0:
            raise RuntimeError(
                f"multihost sim child failed (rc={p.returncode}):\n"
                f"{err[-4000:]}")
        outs.append(out.strip().splitlines()[-1] if out.strip() else "")
    return outs


def _make_sim_sketches(n: int, seed: int = 3) -> List[np.ndarray]:
    """Deterministic clustered synthetic sketches (same on every process)."""
    rng = np.random.default_rng(seed)
    bases = [np.unique(rng.integers(0, 2 ** 28, size=120).astype(np.uint32))
             for _ in range(max(n // 8, 1))]
    out = []
    for i in range(n):
        b = bases[i % len(bases)]
        keep = b[rng.random(len(b)) < 0.8]
        extra = np.unique(
            rng.integers(0, 2 ** 28, size=130 - len(keep)).astype(np.uint32))
        out.append(np.unique(np.concatenate([keep, extra])))
    return out


def _make_sim_sketches_sized(n: int, seed: int = 3) -> List[np.ndarray]:
    """Clustered synthetic sketches with per-genome size variation —
    distinct jaccard values at every kNN cut (no ties), so the knn-capped
    DBSCAN comparison below is deterministic on both engines."""
    rng = np.random.default_rng(seed)
    bases = [np.unique(rng.integers(0, 2 ** 28,
                                    size=120 + 11 * b).astype(np.uint32))
             for b in range(max(n // 8, 1))]
    out = []
    for i in range(n):
        b = bases[i % len(bases)]
        keep = b[rng.random(len(b)) < 0.8]
        extra = np.unique(rng.integers(
            0, 2 ** 28,
            size=max(8, 140 + 7 * (i % 13) - len(keep))).astype(np.uint32))
        out.append(np.unique(np.concatenate([keep, extra])))
    return out


def _make_sim_sketches_spread(n: int, seed: int = 11) -> List[np.ndarray]:
    """Subset-containment corpus with a >5x sketch-size spread: each group
    is one 300-hash 'big' genome plus two 40-hash random SUBSETS of it
    (containment jaccard 1.0, size ratio 7.5).  The multihost ring's MST
    size-ratio gate (radio ~4 at eps=0.05, k=21) would silently drop every
    big-small pair — the regression the radio=0 mode exists for."""
    rng = np.random.default_rng(seed)
    out = []
    big = None
    for i in range(n):
        if i % 3 == 0 or big is None:
            big = np.unique(
                rng.integers(0, 2 ** 28, size=300).astype(np.uint32))
            out.append(big)
        else:
            out.append(np.sort(rng.choice(big, size=40, replace=False)))
    return out


def _sim_child(process_id: int, num_processes: int, port: int,
               devices_per_proc: int, n_genomes: int) -> None:
    init_multihost(f"127.0.0.1:{port}", num_processes, process_id,
                   virtual_cpu_devices=devices_per_proc)
    import hashlib
    import jax
    assert jax.process_count() == num_processes
    assert len(jax.devices()) == num_processes * devices_per_proc
    hashes = _make_sim_sketches(n_genomes)
    lo, hi = shard_bounds(n_genomes, num_processes, process_id)
    clusters = multihost_threshold_clusters(
        hashes[lo:hi], n_genomes, 0.05, 21, bits=2048)
    # single-host reference partition, computed locally from the full set
    from ..cluster.mst import (
        clusters_from_forest, compute_mst, cut_forest)
    res = compute_mst(hashes, 0.05, 21)
    expect = clusters_from_forest(cut_forest(res.mst, 0.05), n_genomes)
    canon = sorted(tuple(sorted(c)) for c in clusters)
    canon_h = sorted(tuple(sorted(c)) for c in expect)
    assert canon == canon_h, "multihost partition != single-host partition"
    # bitmap-ring MST cut must be byte-equal to the host MST cut
    res_mh = multihost_mst(hashes[lo:hi], n_genomes, 0.05, 21, bits=2048)
    cb = cut_forest(res_mh.mst, 0.05)
    chost = cut_forest(res.mst, 0.05)
    assert cb[0].tolist() == chost[0].tolist()
    assert cb[1].tolist() == chost[1].tolist()
    assert cb[2].tolist() == chost[2].tolist()
    # multihost leiden == single-host community_clusters (identical graph,
    # same deterministic Louvain/Leiden on every host)
    from ..cluster.leiden import build_similarity_graph, community_clusters
    cl_mh = multihost_leiden(hashes[lo:hi], n_genomes, 0.05, 21, bits=2048)
    cl_host = community_clusters(hashes, 0.05, 21)
    assert cl_mh == cl_host, "multihost leiden != single-host leiden"
    gf, gt, gw, _ = multihost_similarity_graph(hashes[lo:hi], n_genomes,
                                               0.05, 21, bits=2048)
    hf, ht, hw = build_similarity_graph(hashes, 0.05, 21)
    assert sorted(zip(gf.tolist(), gt.tolist(), gw.tolist())) == \
        sorted(zip(hf.tolist(), ht.tolist(), hw.tolist())), \
        "multihost similarity graph != host graph"
    # multihost greedy == serial greedy on the same sorted order
    from ..cluster.greedy import greedy_cluster
    from ..sketch.base import stdsort_size_desc
    g_mh, g_order = multihost_greedy(hashes[lo:hi], n_genomes, 0.05, 21,
                                     batch=13)
    order = stdsort_size_desc(
        np.array([len(h) for h in hashes], dtype=np.int64))
    assert g_order.tolist() == order.tolist()
    g_host = greedy_cluster([hashes[i] for i in order], 0.05, 21,
                            presorted=True)
    assert g_mh == g_host.clusters, "multihost greedy != serial greedy"
    # containment (AAF) greedy semantics must survive the multihost path
    gc_mh, _ = multihost_greedy(hashes[lo:hi], n_genomes, 0.05, 21,
                                is_containment=True, batch=13)
    gc_host = greedy_cluster([hashes[i] for i in order], 0.05, 21,
                             presorted=True, is_containment=True)
    assert gc_mh == gc_host.clusters, \
        "multihost containment greedy != serial containment greedy"
    # multihost dbscan == single-host engines (labels, clusters, noise)
    from ..cluster.dbscan import dbscan_cluster, minhash_dbscan_cluster
    db_mh = multihost_dbscan(hashes[lo:hi], n_genomes, 0.05, 3, 21,
                             bits=2048)
    db_host = dbscan_cluster(hashes, 0.05, 3, 21)
    assert db_mh.labels.tolist() == db_host.labels.tolist(), \
        "multihost dbscan labels != single-host labels"
    assert db_mh.clusters == db_host.clusters
    assert db_mh.noise == db_host.noise
    dbp_mh = multihost_dbscan(hashes[lo:hi], n_genomes, 0.05, 3, 21,
                              max_posting=32, bits=2048)
    dbp_host = dbscan_cluster(hashes, 0.05, 3, 21, max_posting=32)
    assert dbp_mh.labels.tolist() == dbp_host.labels.tolist(), \
        "multihost dbscan (max_posting) != single-host"
    # knn-capped comparison on the tie-free sized corpus (cap binds:
    # degrees reach 7 > knn_k=4)
    sized = _make_sim_sketches_sized(n_genomes)
    dbk_mh = multihost_dbscan(sized[lo:hi], n_genomes, 0.05, 3, 21,
                              knn_k=4, bits=2048)
    dbk_host = dbscan_cluster(sized, 0.05, 3, 21, knn_k=4)
    assert dbk_mh.labels.tolist() == dbk_host.labels.tolist(), \
        "multihost dbscan (knn) != single-host"
    # MinHash-semantics dbscan, plain + containment
    dbm_mh = multihost_dbscan(hashes[lo:hi], n_genomes, 0.05, 3, 21,
                              minhash=True, bits=2048)
    dbm_host = minhash_dbscan_cluster(hashes, 0.05, 3, 21)
    assert dbm_mh.labels.tolist() == dbm_host.labels.tolist(), \
        "multihost minhash dbscan != single-host"
    assert dbm_mh.clusters == dbm_host.clusters
    dbc_mh = multihost_dbscan(hashes[lo:hi], n_genomes, 0.05, 3, 21,
                              minhash=True, is_containment=True, bits=2048)
    dbc_host = minhash_dbscan_cluster(hashes, 0.05, 3, 21,
                                      is_containment=True)
    assert dbc_mh.labels.tolist() == dbc_host.labels.tolist(), \
        "multihost containment minhash dbscan != single-host"
    # containment with a 7.5x sketch-size spread: the ring must NOT apply
    # the MST size-ratio gate (radio=0 mode) or every big-subset pair drops
    sp = _make_sim_sketches_spread(n_genomes)
    dbs_mh = multihost_dbscan(sp[lo:hi], n_genomes, 0.05, 2, 21,
                              minhash=True, is_containment=True, bits=2048)
    dbs_host = minhash_dbscan_cluster(sp, 0.05, 2, 21, is_containment=True)
    assert any(len(c) >= 3 for c in dbs_host.clusters), \
        "spread corpus failed to form big+subset clusters (bad fixture)"
    assert dbs_mh.labels.tolist() == dbs_host.labels.tolist(), \
        "multihost containment dbscan (size spread) != single-host"
    # multihost RepDB probe/assign == the serial query loop over the same
    # replica (sharded serving; every process loads the identical state)
    from ..sketch.base import SketchSet
    from ..sketch.kssd import KssdParams
    from ..state.greedy_state import KssdClusterState
    p_db = KssdParams.from_kmer_size(21, 3)
    ss_db = SketchSet("kssd", p_db, True, False)
    for i, h in enumerate(hashes):
        ss_db.append_genome(file_name=f"g{i}.fna", name=f"g{i}", comment="",
                            seq0_len=1000, total_len=1000, num_seqs=1,
                            hashes=h)
    ss_db2 = ss_db.reorder(ss_db.kssd_greedy_order())
    st = KssdClusterState.from_clustering(
        ss_db2, p_db, greedy_cluster(ss_db2.hashes, 0.05, 21,
                                     presorted=True), 0.05)
    queries = _make_sim_sketches(n_genomes, seed=7)
    qlo, qhi = shard_bounds(len(queries), num_processes, process_id)
    q_mh = multihost_repdb_query(st, queries[qlo:qhi], 3)
    q_host = [st.query_topk(q, 3) for q in queries]
    assert q_mh == q_host, "multihost repdb query != serial query loop"
    a_mh = multihost_repdb_assign(st, queries[qlo:qhi])
    a_host = [st.assign(q) for q in queries]
    assert a_mh == a_host, "multihost repdb assign != serial assign loop"
    digest = hashlib.sha256(repr(
        (canon, cl_mh, g_mh, db_mh.labels.tolist())).encode()
    ).hexdigest()[:16]
    print(f"OK proc={process_id}/{num_processes} "
          f"devices={len(jax.devices())} clusters={len(clusters)} "
          f"leiden={len(cl_mh)} greedy={len(g_mh)} dbscan={len(db_mh.clusters)} "
          f"digest={digest}", flush=True)


if __name__ == "__main__":
    _sim_child(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               int(sys.argv[4]), int(sys.argv[5]))
