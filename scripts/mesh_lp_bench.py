#!/usr/bin/env python
"""Mesh scaling table for the distributed labelprop engine (the bench.py
headline engine on an n-device mesh, parallel/dist_engine.py).

Runs distributed_threshold_clusters_lp at a fixed N on 1/2/4/8 VIRTUAL
CPU devices and records wall time, per-device resident-mask bytes, pulled
bytes, and partition equality vs the single-host engine.

Caveat (printed into the JSON): the virtual devices SHARE the host's
cores, so wall time cannot show real multi-card speedup — the table
evidences (a) correctness at every mesh size, (b) the per-device
memory/work division (N^2/8/n_dev mask bytes — the quantity that scales
on real cards), and (c) interconnect volume.  On real cards each device's
build is an independent filter sweep of 1/n_dev of the tiles; chip_smoke.py
--gpus 4 runs the engine on four cards.

Usage: python scripts/mesh_lp_bench.py [--n 65536] [--devices 1,2,4,8]
Must run with JAX_PLATFORMS=cpu (the script forces it before jax loads).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=65536)
    # sketch/signature sizing: bits must be selective for s^2 (the filter
    # bound is useless when E[random shared] ~ s^2/bits approaches
    # common_min) — s=120 keeps bits=2048 selective AND the CPU-simulated
    # matmuls affordable; production runs use s=1000/bits=8192
    ap.add_argument("--s", type=int, default=120)
    ap.add_argument("--bits", type=int, default=2048)
    ap.add_argument("--devices", default="1,2,4,8")
    args = ap.parse_args()
    dev_list = [int(x) for x in args.devices.split(",")]

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               f" --xla_force_host_platform_device_count="
                               f"{max(dev_list)}").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")

    from bench import make_sketches, partition_digest
    from rabbittclust_tpu.ops import bitmap as bm
    from rabbittclust_tpu.parallel.dist_engine import (
        distributed_threshold_clusters_lp, make_mesh)

    hashes = make_sketches(n=args.n, s=args.s)
    rows = []
    base_digest = None
    for nd in dev_list:
        mesh = make_mesh(nd)
        bm.reset_pull_stats()
        # single timed run per mesh size (includes the CPU compile; on 2
        # shared cores a cold+warm pair per size exceeds any sane budget)
        t0 = time.perf_counter()
        clusters = distributed_threshold_clusters_lp(
            hashes, 0.05, 21, mesh=mesh, bits=args.bits)
        t_warm = t_cold = time.perf_counter() - t0
        dig = partition_digest(clusters)
        if base_digest is None:
            base_digest = dig
        n_pad = -(-args.n // (nd * 128)) * nd * 128
        shard = n_pad // nd
        n_steps = nd // 2 + 1
        from rabbittclust_tpu.parallel.dist_engine import (
            DIST_LP_LAST, dist_lp_comm_stats, ring_comm_stats)
        comm = dist_lp_comm_stats(n_pad, nd, args.bits,
                                  DIST_LP_LAST.get("rounds", 0))
        rows.append({
            "devices": nd,
            "t_warm_s": round(t_warm, 2),
            "t_cold_s": round(t_cold, 2),
            "clusters": len(clusters),
            "digest_matches_1dev": dig == base_digest,
            "per_device_mask_bytes": n_steps * shard * (shard // 8),
            "pulled_bytes": bm.PULL_STATS["bytes"],
            "pulls": bm.PULL_STATS["pulls"],
            "comm": comm,
            "ring_engine_comm": ring_comm_stats(n_pad, nd, args.bits // 8),
        })
        print(f"-----{nd} devices: warm {t_warm:.2f} s, "
              f"{len(clusters)} clusters", file=sys.stderr, flush=True)
        # append incrementally: a timeout must not lose completed rows
        os.makedirs(".cache", exist_ok=True)
        with open(".cache/mesh_lp_bench.jsonl", "a") as fp:
            fp.write(json.dumps({"partial_row": rows[-1],
                                 "n_genomes": args.n,
                                 "bits": args.bits}) + "\n")
    out = {
        "metric": "mesh_labelprop_scaling",
        "n_genomes": args.n,
        "sketch_size": args.s,
        "bits": args.bits,
        "backend": "cpu-simulated-mesh (2 physical cores shared)",
        "rows": rows,
        "note": ("virtual CPU devices share 2 physical cores: wall time "
                 "measures correctness+overhead, not chip speedup; "
                 "per_device_mask_bytes is the quantity that divides "
                 "across real chips"),
    }
    line = json.dumps(out)
    print(line)
    os.makedirs(".cache", exist_ok=True)
    with open(".cache/mesh_lp_bench.jsonl", "a") as fp:
        fp.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
