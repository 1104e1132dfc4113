#!/usr/bin/env python
"""Rerunnable scale validation for the host engines.  Host-only — never
touches the GPU, safe to run alongside device jobs.

    python scripts/scale_bench.py greedy --n 1000000   # ~2 min on 2 cores
    python scripts/scale_bench.py mst    --n 300000    # ~3 min on 2 cores
    python scripts/scale_bench.py leiden --n 100000    # ~2 min on 2 cores
    python scripts/scale_bench.py all    --n 50000

Workload: N synthetic KSSD-like sketches (~S hashes each) drawn from
``--clusters`` base genomes with 20% dropout + random noise hashes — the
same generator family as bench.py, sized to the reference papers' headline
scales (GenBank ~1.13M genomes greedy / RefSeq ~0.29M genomes MST).
Prints one JSON line per phase: {"phase", "n", "seconds", "clusters",
"max_rss_mb"}.
"""

import argparse
import json
import os
import resource
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_sketches(n, s=1000, n_clusters=None, seed=7):
    rng = np.random.default_rng(seed)
    n_clusters = n_clusters or max(64, n // 200)
    bases = [np.unique(rng.integers(0, 2 ** 31, size=s).astype(np.uint32))
             for _ in range(n_clusters)]
    hashes = []
    for i in range(n):
        b = bases[i % n_clusters]
        keep = b[rng.random(len(b)) < 0.8]
        extra = np.unique(
            rng.integers(0, 2 ** 31, size=s - len(keep)).astype(np.uint32))
        hashes.append(np.unique(np.concatenate([keep, extra])))
    return hashes


def report(phase, n, t0, n_clusters):
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024
    print(json.dumps({"phase": phase, "n": n,
                      "seconds": round(time.perf_counter() - t0, 1),
                      "clusters": n_clusters, "max_rss_mb": rss}),
          flush=True)


def run_greedy(hashes, threshold, k):
    from rabbittclust_tpu.cluster.greedy import greedy_cluster
    t0 = time.perf_counter()
    res = greedy_cluster(hashes, threshold, k, backend="auto")
    report("greedy", len(hashes), t0, len(res.clusters))


def run_mst(hashes, threshold, k):
    from rabbittclust_tpu.cluster.mst import (clusters_from_forest,
                                              compute_mst, cut_forest)
    t0 = time.perf_counter()
    res = compute_mst(hashes, threshold, k)
    clusters = clusters_from_forest(cut_forest(res.mst, threshold),
                                    len(hashes))
    report("mst", len(hashes), t0, len(clusters))


def run_leiden(hashes, threshold, k):
    from rabbittclust_tpu.cluster.leiden import (build_similarity_graph,
                                                 cluster_graph)
    t0 = time.perf_counter()
    graph = build_similarity_graph(hashes, threshold, k, knn_k=1000)
    t_graph = time.perf_counter() - t0
    # --louvain CLI mode: edge-parallel Louvain with warm start
    t1 = time.perf_counter()
    clusters = cluster_graph(len(hashes), graph, 1.0, use_leiden=False,
                             edge_parallel=True)
    t_comm = time.perf_counter() - t1
    print(json.dumps({"phase": "leiden_phases", "n": len(hashes),
                      "edges": int(len(graph[0])),
                      "graph_s": round(t_graph, 1),
                      "community_s": round(t_comm, 1),
                      "louvain_impl": os.environ.get("RTC_LOUVAIN",
                                                     "native")}),
          flush=True)
    report("leiden", len(hashes), t0, len(clusters))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("phase", choices=["greedy", "mst", "leiden", "all"])
    p.add_argument("--n", type=int, default=100000)
    p.add_argument("--s", type=int, default=1000)
    p.add_argument("--clusters", type=int, default=0)
    p.add_argument("-d", "--threshold", type=float, default=0.05)
    p.add_argument("-k", "--kmer-size", type=int, default=21)
    args = p.parse_args()
    t0 = time.perf_counter()
    hashes = make_sketches(args.n, s=args.s,
                           n_clusters=args.clusters or None)
    report("synth", args.n, t0, args.clusters or max(64, args.n // 200))
    runners = {"greedy": run_greedy, "mst": run_mst, "leiden": run_leiden}
    phases = list(runners) if args.phase == "all" else [args.phase]
    for ph in phases:
        runners[ph](hashes, args.threshold, args.kmer_size)


if __name__ == "__main__":
    main()
