#!/usr/bin/env python
"""End-to-end FASTA -> clusters wall-clock: reference binary vs our CLI.

bench.py times the pair phase on synthetic sketches; the reference's
headline claim is whole-pipeline.  This script generates a synthetic
genome corpus (numpy, one file per genome), runs the COMPILED reference
clust-mst (-t 2) and our CLI wall-to-wall, and emits both times plus a
partition-equality check (clusters compared as sets of file names — the
reference's genome ids at -t 2 are completion-order nondeterministic, so
byte comparison is only defined at -t 1; partition equality is the
thread-count-invariant contract).

Our side runs the production configuration: native C++ sketcher + the
device label-propagation cluster engine on a GPU
(RTC_MST_CLUSTERS_FAST=1 --device -e), or the native MST engine on a
CPU-only box.

Usage: python scripts/e2e_bench.py [--n-genomes 10000] [--device]
Writes one JSON line; also appends to .cache/e2e_bench.jsonl.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(REPO, ".cache", "ref_build", "clust-mst")

_B = np.frombuffer(b"ACGT", dtype=np.uint8)


def gen_corpus(root, n_genomes, genome_len=11000, n_clusters=None,
               seed=20260820):
    n_clusters = n_clusters or max(64, n_genomes // 25)
    per = -(-n_genomes // n_clusters)
    rng = np.random.default_rng(seed)
    files = []
    gi = 0
    for c in range(n_clusters):
        base = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
        for m in range(per):
            if gi >= n_genomes:
                break
            g = base.copy()
            mut = rng.random(genome_len) < 0.02
            g[mut] = rng.integers(0, 4, size=int(mut.sum()),
                                  dtype=np.uint8)
            seq = _B[g].tobytes()
            fp = os.path.join(root, f"g{gi:05d}.fna")
            with open(fp, "wb") as f:
                f.write(b">genome_%05d cluster%04d\n" % (gi, c))
                for k in range(0, genome_len, 80):
                    f.write(seq[k:k + 80] + b"\n")
            files.append(fp)
            gi += 1
    lst = os.path.join(root, "list.txt")
    with open(lst, "w") as f:
        f.write("\n".join(files) + "\n")
    return lst


def parse_cluster_sets(path):
    """Clusters as frozensets of file basenames (thread-invariant)."""
    out = []
    cur = None
    rx = re.compile(r"(g\d+\.fna)")
    with open(path, errors="ignore") as fp:
        for line in fp:
            if line.startswith("the cluster"):
                if cur:
                    out.append(frozenset(cur))
                cur = []
            elif cur is not None:
                m = rx.search(line)
                if m:
                    cur.append(m.group(1))
    if cur:
        out.append(frozenset(cur))
    return sorted(out, key=lambda s: sorted(s))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-genomes", type=int, default=10000)
    ap.add_argument("--genome-len", type=int, default=100000,
                    help="per-genome length; 100kb makes ingest+sketch a "
                    "real workload (1 GB FASTA at 10k genomes) instead of "
                    "interpreter-startup noise")
    ap.add_argument("--drlevel", type=int, default=2)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--device", action="store_true",
                    help="device cluster engine on our side "
                         "(RTC_MST_CLUSTERS_FAST lp path)")
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args()
    if not os.path.exists(ORACLE):
        print("reference oracle not built — run "
              "tests/reference_oracle/build_oracle.sh", file=sys.stderr)
        return 2

    root = tempfile.mkdtemp(prefix="e2e_bench_")
    t0 = time.perf_counter()
    lst = gen_corpus(root, args.n_genomes, genome_len=args.genome_len)
    print(f"-----corpus: {args.n_genomes} genomes in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)

    ref_d = os.path.join(root, "ref")
    our_d = os.path.join(root, "our")
    os.makedirs(ref_d)
    os.makedirs(our_d)
    t0 = time.perf_counter()
    # no --no-save: the reference's clust-mst writes the sketch index
    # regardless and ERRORS without a run folder (transSketchesFromIndex)
    # — both sides run the default saving workflow
    r = subprocess.run([ORACLE, "--fast", "-l", "-i", lst, "-o",
                        "r.cluster", "-d", "0.05", "--drlevel",
                        str(args.drlevel), "-t", str(args.threads)],
                       cwd=ref_d, capture_output=True, text=True)
    t_ref = time.perf_counter() - t0
    assert r.returncode == 0, r.stderr[-2000:]

    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "rabbittclust_tpu.cli.clust_mst", "--fast",
           "-l", "-i", lst, "-o", "o.cluster", "-d", "0.05", "--drlevel",
           str(args.drlevel), "-t", str(args.threads)]
    if args.device:
        # the lp fast path requires clusters-only -e --no-save mode; the
        # skipped sketch save is milliseconds at this corpus size
        env["RTC_MST_CLUSTERS_FAST"] = "1"
        env["RTC_CLUSTER_ENGINE"] = "lp"
        cmd.extend(["--device", "-e"])
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=our_d, capture_output=True, text=True,
                       env=env)
    t_ours = time.perf_counter() - t0
    assert r.returncode == 0, r.stderr[-2000:]

    ref_sets = parse_cluster_sets(os.path.join(ref_d, "r.cluster"))
    our_sets = parse_cluster_sets(os.path.join(our_d, "o.cluster"))
    equal = ref_sets == our_sets
    out = {
        "metric": "end_to_end_fasta_to_clusters",
        "n_genomes": args.n_genomes,
        "genome_len": args.genome_len,
        "drlevel": args.drlevel,
        "threads": args.threads,
        "t_reference_s": round(t_ref, 1),
        "t_ours_s": round(t_ours, 1),
        "speedup": round(t_ref / t_ours, 2),
        "engine": ("native-sketch + device-lp-cluster" if args.device
                   else "native-sketch + native-mst"),
        "partitions_equal": equal,
        "clusters": len(our_sets),
    }
    line = json.dumps(out)
    print(line)
    os.makedirs(os.path.join(REPO, ".cache"), exist_ok=True)
    with open(os.path.join(REPO, ".cache", "e2e_bench.jsonl"), "a") as fp:
        fp.write(line + "\n")
    if not args.keep:
        import shutil
        shutil.rmtree(root, ignore_errors=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
