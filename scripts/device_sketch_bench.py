#!/usr/bin/env python
"""One-shot device-sketcher vs native timing on the GPU.

    python scripts/device_sketch_bench.py --mbases 32

Synthetic random genomes (2 Mb each).  Prints one JSON line:
{"mbases", "t_native_s", "t_device_s", "t_device_warm_s",
 "native_mbps", "device_mbps", "bit_identical"}.  Run nothing else on the
card meanwhile."""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbases", type=int, default=32)
    ap.add_argument("--genome-mb", type=float, default=2.0)
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--drlevel", type=int, default=3)
    args = ap.parse_args()

    import tempfile
    rng = np.random.default_rng(7)
    glen = int(args.genome_mb * 1e6)
    n_genomes = max(1, int(args.mbases * 1e6) // glen)
    total_bases = n_genomes * glen
    tmpd = tempfile.mkdtemp(prefix="rtc_sketch_bench_")
    files = []
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    for g in range(n_genomes):
        seq = rng.choice(alpha, size=glen).tobytes().decode()
        path = os.path.join(tmpd, f"g{g}.fna")
        with open(path, "w") as f:
            f.write(f">g{g} synthetic\n")
            for i in range(0, glen, 80):
                f.write(seq[i:i + 80] + "\n")
        files.append(path)

    from rabbittclust_tpu.sketch.kssd import sketch_files_kssd
    t0 = time.perf_counter()
    ss_n, p = sketch_files_kssd(files, min_len=0, kmer_size=args.k,
                                drlevel=args.drlevel)
    t_nat = time.perf_counter() - t0

    from rabbittclust_tpu.ops.sketch_device import sketch_files_kssd_device
    t0 = time.perf_counter()
    ss_d, _ = sketch_files_kssd_device(files, min_len=0, kmer_size=args.k,
                                       drlevel=args.drlevel)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    ss_d2, _ = sketch_files_kssd_device(files, min_len=0, kmer_size=args.k,
                                        drlevel=args.drlevel)
    t_warm = time.perf_counter() - t0

    ident = len(ss_n) == len(ss_d) and all(
        np.array_equal(a, b) for a, b in zip(ss_n.hashes, ss_d.hashes)) \
        and all(np.array_equal(a, b)
                for a, b in zip(ss_d.hashes, ss_d2.hashes))
    print(json.dumps({
        "mbases": total_bases / 1e6, "t_native_s": round(t_nat, 2),
        "t_device_s": round(t_dev, 2), "t_device_warm_s": round(t_warm, 2),
        "native_mbps": round(total_bases / 1e6 / t_nat, 2),
        "device_mbps": round(total_bases / 1e6 / t_warm, 2),
        "bit_identical": bool(ident)}), flush=True)


if __name__ == "__main__":
    main()
