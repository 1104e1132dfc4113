#!/usr/bin/env python
"""A/B: leiden similarity-graph construction — device bitmap engine vs the
native host pairs engine.

Workload: the scale_bench synthetic corpus (N sketches, ~s hashes,
clustered) at the leiden CLI's defaults (d=0.05, k=21, knn autoselect
disabled here — the prune is identical post-processing for both sides).
Both sides must produce the IDENTICAL edge set/weights (exact counts).

Usage:
    python scripts/leiden_graph_ab.py --n 100000          # on the GPU
    JAX_PLATFORMS=cpu python scripts/leiden_graph_ab.py --n 4096  # smoke

Writes one JSON line; appends to .cache/leiden_graph_ab.jsonl.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100000)
    ap.add_argument("--s", type=int, default=1000)
    ap.add_argument("-d", "--threshold", type=float, default=0.05)
    ap.add_argument("-k", "--kmer-size", type=int, default=21)
    ap.add_argument("--skip-host", action="store_true")
    args = ap.parse_args()

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from scale_bench import make_sketches
    from rabbittclust_tpu.cluster.leiden import build_similarity_graph

    hashes = make_sketches(args.n, s=args.s)
    print(f"-----{args.n} sketches ready", file=sys.stderr, flush=True)

    def digest(graph):
        frm, to, w = graph
        order = np.lexsort((to, frm))
        import hashlib
        h = hashlib.sha256()
        h.update(frm[order].astype(np.int64).tobytes())
        h.update(to[order].astype(np.int64).tobytes())
        h.update(w[order].astype(np.float64).tobytes())
        return h.hexdigest()[:16]

    out = {"metric": "leiden_graph_build_ab", "n_genomes": args.n,
           "sketch_size": args.s}
    t_host = None
    if not args.skip_host:
        t0 = time.perf_counter()
        gh = build_similarity_graph(hashes, args.threshold, args.kmer_size,
                                    use_device=False)
        t_host = time.perf_counter() - t0
        out["t_host_native_s"] = round(t_host, 1)
        out["edges"] = int(len(gh[0]))
        out["digest_host"] = digest(gh)
        print(f"-----host native graph: {t_host:.1f} s, {len(gh[0])} edges",
              file=sys.stderr, flush=True)

    os.environ["RTC_LEIDEN_DEVICE"] = "force"  # bypass the measured router
    t0 = time.perf_counter()
    gd = build_similarity_graph(hashes, args.threshold, args.kmer_size,
                                use_device=True)
    t_dev = time.perf_counter() - t0
    out["t_device_s"] = round(t_dev, 1)
    out["edges_device"] = int(len(gd[0]))
    out["digest_device"] = digest(gd)
    if t_host is not None:
        out["graphs_identical"] = out["digest_host"] == out["digest_device"]
        out["speedup_device"] = round(t_host / t_dev, 2)
    print(f"-----device graph: {t_dev:.1f} s, {len(gd[0])} edges",
          file=sys.stderr, flush=True)

    line = json.dumps(out)
    print(line)
    os.makedirs(os.path.join(REPO, ".cache"), exist_ok=True)
    with open(os.path.join(REPO, ".cache", "leiden_graph_ab.jsonl"),
              "a") as fp:
        fp.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
