#!/usr/bin/env python
"""One-shot device-greedy vs native-host timing on the GPU.

    python scripts/device_greedy_bench.py --n 16384

Same synthetic generator as scale_bench.py.  Prints one JSON line:
{"n", "t_host_s", "t_device_s", "t_device_warm_s", "pulled_bytes",
 "pulls", "partitions_equal"}.  Run nothing else on the card meanwhile.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scale_bench import make_sketches  # noqa: E402


def one_case(n, threshold, k, n_clusters=None, tag=""):
    hashes = make_sketches(n, n_clusters=n_clusters)

    from rabbittclust_tpu.cluster.greedy import greedy_cluster
    t0 = time.perf_counter()
    host = greedy_cluster(hashes, threshold, k, backend="native")
    t_host = time.perf_counter() - t0

    from rabbittclust_tpu.ops import bitmap
    from rabbittclust_tpu.ops.greedy_device import greedy_cluster_device
    bitmap.reset_pull_stats()
    t0 = time.perf_counter()
    dev = greedy_cluster_device(hashes, threshold, k)
    t_dev = time.perf_counter() - t0
    stats = dict(bitmap.PULL_STATS)
    # warm rerun (compiles cached)
    t0 = time.perf_counter()
    dev2 = greedy_cluster_device(hashes, threshold, k)
    t_warm = time.perf_counter() - t0

    equal = (host.clusters == dev.clusters
             and host.representatives == dev.representatives
             and dev2.clusters == dev.clusters)
    row = {
        "n": n, "case": tag, "t_host_s": round(t_host, 2),
        "t_device_s": round(t_dev, 2), "t_device_warm_s": round(t_warm, 2),
        "pulled_bytes": stats.get("bytes", 0), "pulls": stats.get("pulls", 0),
        "partitions_equal": bool(equal),
        "winner": "host-native" if t_host <= t_warm else "device-sweep"}
    print(json.dumps(row), flush=True)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--threshold", type=float, default=0.05)
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--table", action="store_true",
                    help="A/B sweep: 16k/32k/64k x sparse/dense, the "
                    "evidence for the --device greedy auto-routing "
                    "(workflows.compute_kssd_clusters)")
    args = ap.parse_args()
    if not args.table:
        one_case(args.n, args.threshold, args.k)
        return
    rows = []
    for n in (16384, 32768, 65536):
        # dense: few big clusters (n/200 bases, the scale_bench default);
        # sparse: mostly-singleton corpus (n/2 bases -> tiny clusters)
        rows.append(one_case(n, args.threshold, args.k, tag="dense"))
        rows.append(one_case(n, args.threshold, args.k,
                             n_clusters=n // 2, tag="sparse"))
    with open(".cache/device_greedy_ab.json", "w") as fp:
        json.dump(rows, fp, indent=1)
    print(f"table written to .cache/device_greedy_ab.json",
          file=sys.stderr)


if __name__ == "__main__":
    main()
