#!/usr/bin/env python
"""Measured multihost (N>=2 process) clustering throughput — CPU-mesh
SIMULATION.

This measures the full jax.distributed pipeline (process-sharded sketches
-> global bitmap ring -> per-process exact verify -> forest allgather ->
deterministic Kruskal) on 2 local processes x 4 virtual CPU devices.  The
number is a FUNCTIONAL simulation datapoint (host cores doing the
device's matmuls), not device performance.

    python scripts/multihost_bench.py --n 2048 --procs 2

Prints one JSON line from process 0:
{"n", "procs", "devices", "t_multihost_s", "pairs_per_s", "t_single_s",
 "partitions_equal"}.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def make_sketches(n, s=500, seed=7):
    rng = np.random.default_rng(seed)
    n_clusters = max(64, n // 200)
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


def child(pid, nproc, port, ndev, n, threshold, k, module):
    from rabbittclust_tpu.parallel import multihost as mh
    mh.init_multihost(f"127.0.0.1:{port}", nproc, pid,
                      virtual_cpu_devices=ndev)
    hashes = make_sketches(n)
    lo, hi = mh.shard_bounds(n, nproc, pid)
    local = hashes[lo:hi]

    if module == "leiden":
        run = lambda: mh.multihost_leiden(local, n, threshold, k)
    elif module == "greedy":
        run = lambda: mh.multihost_greedy(local, n, threshold, k)[0]
    elif module == "dbscan":
        run = lambda: mh.multihost_dbscan(local, n, threshold, 3, k)
    else:
        run = lambda: mh.multihost_threshold_clusters(local, n, threshold, k)
    run()  # warm (compiles), then timed
    t0 = time.perf_counter()
    result = run()
    t_mh = time.perf_counter() - t0
    if pid == 0:
        t0 = time.perf_counter()
        if module == "leiden":
            from rabbittclust_tpu.cluster.leiden import community_clusters
            single = community_clusters(hashes, threshold, k)
            eq = result == single
        elif module == "greedy":
            from rabbittclust_tpu.cluster.greedy import greedy_cluster
            from rabbittclust_tpu.sketch.base import stdsort_size_desc
            order = stdsort_size_desc(
                np.array([len(h) for h in hashes], dtype=np.int64))
            single = greedy_cluster([hashes[i] for i in order], threshold,
                                    k, presorted=True).clusters
            eq = result == single
        elif module == "dbscan":
            from rabbittclust_tpu.cluster.dbscan import dbscan_cluster
            single = dbscan_cluster(hashes, threshold, 3, k)
            eq = result.labels.tolist() == single.labels.tolist()
        else:
            from rabbittclust_tpu.ops.cluster_fast import \
                threshold_clusters_device as threshold_clusters
            single = threshold_clusters(hashes, threshold, k)
            eq = sorted(map(sorted, result)) == sorted(map(sorted, single))
        t_single = time.perf_counter() - t0
        print(json.dumps({
            "n": n, "module": module, "procs": nproc,
            "devices": nproc * ndev,
            "t_multihost_s": round(t_mh, 2),
            "pairs_per_s": round(n * (n - 1) / 2 / t_mh, 1),
            "t_single_s": round(t_single, 2),
            "partitions_equal": bool(eq),
            "note": "CPU-mesh simulation, not device performance"}),
            flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=4)
    ap.add_argument("--threshold", type=float, default=0.05)
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--module", default="clusters",
                    choices=["clusters", "leiden", "greedy", "dbscan"])
    ap.add_argument("--child", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.child >= 0:
        child(args.child, args.procs, args.port, args.devices_per_proc,
              args.n, args.threshold, args.k, args.module)
        return

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", str(pid),
         "--port", str(port), "--procs", str(args.procs),
         "--devices-per-proc", str(args.devices_per_proc),
         "--n", str(args.n), "--threshold", str(args.threshold),
         "--k", str(args.k), "--module", args.module],
        env=env, cwd=REPO) for pid in range(args.procs)]
    rc = [p.wait() for p in procs]
    if any(rc):
        sys.exit(f"child failed: {rc}")


if __name__ == "__main__":
    main()
