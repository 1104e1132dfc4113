"""Shared CLI machinery — flag surface mirrors reference src/main.cpp.

One parser per binary flavor (clust-mst / clust-greedy / clust-leiden /
clust-dbscan), identical flags and defaults (main.cpp:59-262).
"""

from __future__ import annotations

import argparse
import os
import sys


VERSION = "2.2.1"


def base_parser(module: str) -> argparse.ArgumentParser:
    descriptions = {
        "mst": f"clust-mst v.{VERSION}, minimum-spanning-tree-based module "
               "for RabbitTClust",
        "greedy": f"clust-greedy v.{VERSION}, greedy incremental clustering "
                  "module for RabbitTClust",
        "leiden": f"clust-leiden v.{VERSION}, Graph-based community "
                  "detection (Louvain) clustering module",
        "dbscan": f"clust-dbscan v.{VERSION}, DBSCAN density-based "
                  "clustering module",
    }
    p = argparse.ArgumentParser(description=descriptions[module])
    p.add_argument("-t", "--threads", type=int,
                   default=os.cpu_count() or 1,
                   help="set the thread number, default all CPUs of the "
                        "platform")
    p.add_argument("-m", "--min-length", dest="min_len", type=int,
                   default=10000,
                   help="set the filter minimum length (minLen), genome "
                        "length less than minLen will be ignore, default "
                        "10,000")
    p.add_argument("-c", "--containment", dest="contain_compress", type=int,
                   default=None,
                   help="use AAF distance with containment coefficient, set "
                        "the containCompress, the sketch size is in "
                        "proportion with 1/containCompress")
    p.add_argument("-k", "--kmer-size", dest="kmer_size", type=int,
                   default=None, help="set the kmer size")
    p.add_argument("-s", "--sketch-size", dest="sketch_size", type=int,
                   default=None,
                   help="set the sketch size for Jaccard Index and Mash "
                        "distance, default 1000")
    p.add_argument("-l", "--list", dest="sketch_by_file", action="store_true",
                   help="input is genome list, one genome per line")
    p.add_argument("--sketch-func", dest="sketch_func", default="MinHash",
                   choices=["MinHash", "WMH", "HLL", "OMH"],
                   help="sketch function (default MinHash; --fast selects "
                        "KSSD). WMH/HLL/OMH run the dense all-pairs path "
                        "(latent in the reference: its CLI hard-wires "
                        "MinHash, main.cpp:73; clust-mst only)")
    p.add_argument("-e", "--no-save", dest="no_save", action="store_true",
                   help="not save the intermediate files, such as sketches "
                        "or MST")
    p.add_argument("--save-rep", dest="save_rep", action="store_true",
                   help="save representative inverted index for incremental "
                        "clustering (greedy or mst)")
    p.add_argument("-d", "--threshold", type=float, default=None,
                   help="set the distance threshold for clustering")
    p.add_argument("-o", "--output", default=None,
                   help="set the output name of cluster result")
    p.add_argument("-i", "--input", default=None,
                   help="set the input file, single FASTA genome file "
                        "(without -l option) or genome list file (with -l "
                        "option)")
    p.add_argument("--presketched", default=None,
                   help="clustering by the pre-generated sketch files rather "
                        "than genomes")
    p.add_argument("--fast", dest="is_fast", action="store_true",
                   help="use the kssd algorithm for sketching and distance "
                        "computing")
    p.add_argument("--inverted-index", dest="use_inverted_index",
                   action="store_true", default=True,
                   help="use inverted index optimization for greedy "
                        "clustering (MinHash only)")
    p.add_argument("--append", default=None,
                   help="append genome file or file list with the "
                        "pre-generated sketch or MST files")
    p.add_argument("--device", dest="use_device", action="store_true",
                   help="run the pairwise-distance engine on the GPU "
                        "(JAX) instead of the host path; with more than "
                        "one visible device the mesh ring engine is "
                        "auto-selected for the MST phase.  Refused when no "
                        "GPU is found, unless JAX_PLATFORMS=cpu is set")
    if module in ("mst", "greedy", "leiden", "dbscan"):
        p.add_argument("--multihost", default=None,
                       metavar="COORD:PORT,NPROC,PID",
                       help="run distributed across jax.distributed "
                            "processes (one per host): coordinator "
                            "address, process count, this process's id. "
                            "KSSD (--fast) fresh-genome input only; see "
                            "scripts/launch_multihost.py")
    if module in ("mst", "greedy"):
        p.add_argument("--dense", action="store_true",
                       help="enable density maps, ANI histogram, and MST "
                            "noise-removal pass (high memory; default: off)")
        p.add_argument("--db", dest="repdb_path", default=None,
                       help="RepDB file path for representative database "
                            "operations (--build/--query/--assign/--append/"
                            "--stats)")
        p.add_argument("--build", dest="repdb_build", action="store_true")
        p.add_argument("--query", dest="repdb_query", action="store_true")
        p.add_argument("--assign", dest="repdb_assign", action="store_true")
        p.add_argument("--stats", dest="repdb_stats", action="store_true")
        p.add_argument("--top-k", dest="topk", type=int, default=5,
                       help="Number of top matches to return in --query mode "
                            "(default 5)")
    if module in ("greedy", "dbscan", "leiden", "mst"):
        p.add_argument("--drlevel", type=int, default=3,
                       help="set the dimention reduction level for Kssd "
                            "sketches, default 3 with a dimention reduction "
                            "of 1/4096")
    if module == "mst":
        p.add_argument("--premsted", default=None,
                       help="clustering by the pre-generated mst files "
                            "rather than genomes for clust-mst")
        p.add_argument("--newick-tree", dest="newick_tree",
                       action="store_true",
                       help="output the newick tree format file")
        p.add_argument("--phylip-tree", dest="phylip_tree",
                       action="store_true",
                       help="output the PHYLIP tree format file")
        p.add_argument("--nexus-tree", dest="nexus_tree",
                       action="store_true",
                       help="output the NEXUS tree format file")
        p.add_argument("--linkage-matrix", dest="linkage_matrix",
                       action="store_true",
                       help="output the single-linkage linkage matrix")
        p.add_argument("--auto-threshold", dest="auto_threshold",
                       action="store_true",
                       help="automatically select optimal threshold based on "
                            "MST edge length distribution")
        p.add_argument("--stability", action="store_true",
                       help="evaluate threshold stability under small "
                            "perturbations")
        p.add_argument("--dedup-dist", dest="dedup_dist", type=float,
                       default=-1.0,
                       help="collapse near-duplicate nodes connected by "
                            "forest edges with dist <= dedup-dist; output to "
                            "<output>.dedup")
        p.add_argument("--reps-per-cluster", dest="reps_per_cluster",
                       type=int, default=0,
                       help="select up to k representatives per cluster; "
                            "output to <output>.reps")
        p.add_argument("--buildDB", dest="build_db", default=None,
                       help="build a reusable KSSD sketch+index database "
                            "into the given folder and exit")
    if module == "leiden":
        p.add_argument("--resolution", type=float, default=1.0,
                       help="Resolution parameter (higher = more clusters, "
                            "default 1.0)")
        p.add_argument("--louvain", dest="use_louvain", action="store_true",
                       help="Use Louvain algorithm (auto-enables "
                            "edge-parallel + warm-start + knn=1000)")
        p.add_argument("--knn", dest="knn_k", type=int, default=0,
                       help="k-NN filtering: keep only k nearest neighbors "
                            "per node (default: 1000 for --louvain, 500 for "
                            "leiden; 0 to disable)")
        p.add_argument("--pregraph", default=None,
                       help="Cluster from pre-built graph (for fast "
                            "resolution adjustment)")
    if module == "dbscan":
        p.add_argument("--eps", type=float, default=0.05,
                       help="DBSCAN epsilon parameter (distance threshold, "
                            "default 0.05)")
        p.add_argument("--minpts", type=int, default=5,
                       help="DBSCAN minPts parameter (minimum points to form "
                            "cluster, default 5)")
        p.add_argument("--knn", dest="knn_k", type=int, default=0,
                       help="k-NN pre-filtering: keep only k nearest "
                            "neighbors per point (0=disabled)")
        p.add_argument("--max-posting", dest="max_posting", type=int,
                       default=0,
                       help="drop hash keys with posting size > max-posting "
                            "(0=disabled)")
        p.add_argument("--minhash", dest="minhash_dbscan",
                       action="store_true",
                       help="run DBSCAN over MinHash sketches without "
                            "--fast (the reference ships this engine, "
                            "dbscan.cpp:987, but its CLI cannot reach it; "
                            "extension flag)")
    return p


def validate_common(args, module: str) -> None:
    build_db = getattr(args, "build_db", None)
    repdb_stats = getattr(args, "repdb_stats", False)
    if not build_db and not repdb_stats and args.output is None:
        print("ERROR: option -o/--output is required (unless --buildDB or "
              "--stats is used)", file=sys.stderr)
        sys.exit(1)
    if args.threads < 1:
        print(f"-----Invalid thread number {args.threads}", file=sys.stderr)
        sys.exit(1)
    if args.append and args.input:
        print("ERROR: --append excludes --input", file=sys.stderr)
        sys.exit(1)
    if args.threshold is None:
        args.threshold = 0.05
        print(f"-----use default threshold: {args.threshold}",
              file=sys.stderr)
    if getattr(args, "sketch_func", "MinHash") != "MinHash" \
            and module in ("leiden", "dbscan"):
        print(f"ERROR: clust-{module} supports KSSD (--fast) sketches only",
              file=sys.stderr)
        sys.exit(1)
    if getattr(args, "use_device", False) and \
            not getattr(args, "multihost", None):
        # (--multihost must initialize jax.distributed before any backend
        # query, so the check is skipped there)
        from ..utils.jaxcfg import check_device_platform, configure_jax
        configure_jax()
        try:
            check_device_platform()
        except RuntimeError as e:
            print(f"ERROR: {e}", file=sys.stderr)
            sys.exit(1)


def make_output_options(args, module: str):
    from ..workflows import OutputOptions
    return OutputOptions(
        newick_tree=getattr(args, "newick_tree", False),
        phylip_tree=getattr(args, "phylip_tree", False),
        nexus_tree=getattr(args, "nexus_tree", False),
        linkage_matrix=getattr(args, "linkage_matrix", False),
        auto_threshold=getattr(args, "auto_threshold", False),
        stability=getattr(args, "stability", False),
        dense=getattr(args, "dense", False),
        dedup_dist=getattr(args, "dedup_dist", -1.0),
        reps_per_cluster=getattr(args, "reps_per_cluster", 0),
        save_rep=args.save_rep,
        no_save=args.no_save,
        use_device=getattr(args, "use_device", False),
    )
