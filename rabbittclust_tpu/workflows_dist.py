"""Multi-host workflows: end-to-end clustering from real inputs across
jax.distributed processes, with PROCESS-SHARDED ingest.

This is the production entry point for the multihost layer
(parallel/multihost.py): each process reads + sketches ONLY its contiguous
block of the input file list on its own host (the expensive IO/string
phase — reference SketchInfo.cpp:878-980 is the loop being sharded), the
tiny sketch store + genome metadata are allgathered (sketches are
~genome_len/4096 by design, mirroring the reference's in-RAM sketch
vectors), and the bitmap-filter ring runs over the GLOBAL device mesh
(NVLink within a host, the network between hosts).  Every process finishes with the
identical partition; process 0 writes the outputs.

ID parity: sketch ids are input-list order among kept genomes (same as the
single-host sketcher), so per-process blocks concatenate to exactly the
single-host ordering and the .cluster file is byte-identical to a
single-host run.

Launch (one command per host, same contract as jax.distributed):

    python -m rabbittclust_tpu.cli.clust_mst --fast -l -i list -o out \
        --multihost host0:8476,NUM_PROCESSES,PROCESS_ID

CPU simulation (tests / dry-runs): scripts/launch_multihost.py spawns N
local processes with M virtual CPU devices each.
"""

from __future__ import annotations

import pickle
import sys
from typing import List, Optional, Tuple

import numpy as np

from .cluster.mst import clusters_from_forest, cut_forest
from .io.fasta import read_file_list
from .sketch.base import SketchSet
from .sketch.kssd import sketch_files_kssd, sketch_sequences_kssd
from .state.cluster_io import write_cluster_file
from .workflows import log, tune_kssd_parameters


def _allgather_metadata(ss: SketchSet) -> List[tuple]:
    """Allgather per-genome metadata records in process (= global id)
    order: (file_name, name, comment, seq0_len, total_len, num_seqs)."""
    from .parallel.multihost import _allgather_ragged

    recs = [(ss.file_names[i], ss.names[i], ss.comments[i], ss.seq0_lens[i],
             ss.total_lens[i], ss.num_seqs[i]) for i in range(len(ss))]
    blob = np.frombuffer(pickle.dumps(recs), dtype=np.uint8)
    out: List[tuple] = []
    for part in _allgather_ragged(blob):
        out.extend(pickle.loads(part.tobytes()))
    return out


def parse_multihost_spec(spec: str) -> Tuple[str, int, int]:
    """"coordinator:port,num_processes,process_id" -> parsed triple."""
    parts = spec.rsplit(",", 2)
    if len(parts) != 3:
        raise ValueError(
            f"--multihost expects 'coordinator:port,num_processes,"
            f"process_id', got {spec!r}")
    return parts[0], int(parts[1]), int(parts[2])


def gather_global_sketches(local_ss: SketchSet, params,
                           sketch_by_file: bool) -> SketchSet:
    """Allgather every process's sketches + metadata into the full
    SketchSet (identical on every host, global-id order)."""
    from .parallel.multihost import allgather_sketches

    all_hashes = allgather_sketches(local_ss.hashes, local_ss.use64)
    meta = _allgather_metadata(local_ss)
    assert len(meta) == len(all_hashes)
    ss = SketchSet("kssd", params, sketch_by_file, local_ss.use64)
    for (fn, nm, cm, s0, tl, nsq), h in zip(meta, all_hashes):
        ss.append_genome(file_name=fn, name=nm, comment=cm, seq0_len=s0,
                         total_len=tl, num_seqs=nsq, hashes=h)
    return ss


def ingest_sharded_kssd(input_file: str, sketch_by_file: bool,
                        num_processes: int, process_id: int, min_len: int,
                        kmer_size: int, drlevel: int, threads: int):
    """Process-sharded ingest: this process sketches only its contiguous
    block of the input; returns (global SketchSet, params)."""
    from .parallel.multihost import shard_bounds

    if sketch_by_file:
        files = read_file_list(input_file)
        lo, hi = shard_bounds(len(files), num_processes, process_id)
        log(f"-----process {process_id}: sketching files [{lo}, {hi}) of "
            f"{len(files)}")
        local_ss, p = sketch_files_kssd(files[lo:hi], min_len, kmer_size,
                                        drlevel, threads)
    else:
        # by-sequence mode: a single FASTA cannot be read range-sharded
        # without a byte index (the reference also reads it on one node),
        # so every process sketches the file locally and keeps only its
        # canonical kept-sequence block — the PAIR phase (the O(N^2) part)
        # is still fully distributed
        full, p = sketch_sequences_kssd(input_file, min_len, kmer_size,
                                        drlevel, threads)
        lo, hi = shard_bounds(len(full), num_processes, process_id)
        local_ss = full.reorder(np.arange(lo, hi))
    return gather_global_sketches(local_ss, p, sketch_by_file), p


def clust_mst_multihost(input_file: str, output_file: str,
                        coordinator: str, num_processes: int,
                        process_id: int, *, sketch_by_file: bool = True,
                        is_containment: bool = False,
                        kmer_size: Optional[int] = None,
                        threshold: float = 0.05, drlevel: int = 3,
                        min_len: int = 10000, threads: int = 0,
                        virtual_cpu_devices: Optional[int] = None,
                        bits: int = 8192, module: str = "mst",
                        resolution: float = 1.0, use_leiden: bool = True,
                        knn_k: int = 0, min_pts: int = 5,
                        max_posting: int = 0):
    """clust-mst/--multihost: distributed KSSD clustering from genomes.

    Every process returns the identical (clusters, SketchSet); process 0
    writes the .cluster file — byte-identical to the single-host
    clust_from_genome_fast output (ring MST cut == host MST cut, see
    parallel/multihost._sim_child)."""
    from .parallel import multihost as mh

    mh.init_multihost(coordinator, num_processes, process_id,
                      virtual_cpu_devices=virtual_cpu_devices)
    # parameter tuning scans file sizes only — identical on every process
    tuned = tune_kssd_parameters(sketch_by_file, kmer_size is not None,
                                 input_file, threads, min_len,
                                 is_containment, kmer_size or 19, threshold,
                                 drlevel)
    import time as _time
    t0 = _time.perf_counter()
    ss, p = ingest_sharded_kssd(input_file, sketch_by_file, num_processes,
                                process_id, min_len, tuned.kmer_size,
                                drlevel, threads)
    log(f"-----process {process_id}: ingest+sketch+allgather "
        f"{_time.perf_counter() - t0:.2f} s")
    n_total = len(ss)
    log(f"-----the size of sketches (genomes) is: {n_total}")
    lo, hi = mh.shard_bounds(n_total, num_processes, process_id)
    t0 = _time.perf_counter()
    if module == "greedy":
        clusters, order = mh.multihost_greedy(
            ss.hashes[lo:hi], n_total, threshold, p.kmer_size,
            is_containment=is_containment)
        # greedy ids are in the sorted (size-desc) space, like the
        # single-host workflow (compute_kssd_clusters reorders the set)
        ss = ss.reorder(order)
        header_threshold = None  # greedy main output has no header
    elif module == "dbscan":
        # threshold plays the role of eps (clust-dbscan --eps)
        dbscan_res = mh.multihost_dbscan(
            ss.hashes[lo:hi], n_total, threshold, min_pts, p.kmer_size,
            knn_k=knn_k, max_posting=max_posting, bits=bits)
        clusters = dbscan_res.clusters
        header_threshold = None
    elif module == "leiden":
        clusters = mh.multihost_leiden(
            ss.hashes[lo:hi], n_total, threshold, p.kmer_size, bits=bits,
            resolution=resolution, use_leiden=use_leiden, knn_k=knn_k)
        header_threshold = threshold  # clust-leiden writes the header
    else:
        res = mh.multihost_mst(ss.hashes[lo:hi], n_total, threshold,
                               p.kmer_size, is_containment=is_containment,
                               bits=bits)
        forest = cut_forest(res.mst, threshold)
        clusters = clusters_from_forest(forest, n_total)
        header_threshold = threshold
    log(f"-----process {process_id}: distributed {module} cluster phase "
        f"{_time.perf_counter() - t0:.2f} s")
    import jax
    if jax.process_index() == 0:
        if module == "dbscan":
            from .cluster.dbscan import write_dbscan_result
            write_dbscan_result(dbscan_res, ss, output_file, threshold,
                                min_pts)
        elif header_threshold is not None:
            write_cluster_file(output_file, clusters, ss, header_threshold)
        else:
            write_cluster_file(output_file, clusters, ss)
        log(f"-----write the cluster result into: {output_file}")
        log(f"-----the number of clusters is: {len(clusters)}")
    return clusters, ss


def repdb_query_multihost(db_path: str, input_file: str, output_file: str,
                          coordinator: str, num_processes: int,
                          process_id: int, *, sketch_by_file: bool = True,
                          topk: int = 5, assign: bool = False,
                          min_len: int = 10000, threads: int = 0,
                          virtual_cpu_devices: Optional[int] = None):
    """Distributed RepDB serving (--db --query/--assign --multihost):
    every process loads the same RepDB replica, sketches ONLY its block of
    the query list, probes it, and the gathered hits are written by
    process 0 — TSV byte-identical to the single-host query/assign verbs
    (reference sub_command.cpp:337-450 writers)."""
    from .parallel import multihost as mh
    from .state.greedy_state import KssdClusterState
    from .cli.repdb import write_assign_tsv, write_query_tsv

    mh.init_multihost(coordinator, num_processes, process_id,
                      virtual_cpu_devices=virtual_cpu_devices)
    state = KssdClusterState.load_repdb(db_path)
    if sketch_by_file:
        files = read_file_list(input_file)
        lo, hi = mh.shard_bounds(len(files), num_processes, process_id)
        log(f"-----process {process_id}: sketching query files [{lo}, {hi})"
            f" of {len(files)}")
        local_ss, _ = sketch_files_kssd(files[lo:hi], min_len,
                                        state.kmer_size,
                                        state.params.drlevel, threads)
        ss = gather_global_sketches(local_ss, state.params, True)
    else:
        ss, _ = sketch_sequences_kssd(input_file, min_len, state.kmer_size,
                                      state.params.drlevel, threads)
        lo, hi = mh.shard_bounds(len(ss), num_processes, process_id)
        local_ss = ss.reorder(np.arange(lo, hi))
    if assign:
        res = mh.multihost_repdb_assign(state, local_ss.hashes)
    else:
        res = mh.multihost_repdb_query(state, local_ss.hashes, topk)
    import jax
    if jax.process_index() == 0:
        if assign:
            write_assign_tsv(state, ss, output_file, precomputed=res)
        else:
            write_query_tsv(state, ss, output_file, topk, precomputed=res)
        log(f"-----write the query result into: {output_file}")
    return res, ss


def main(argv=None) -> int:  # pragma: no cover - exercised via subprocess
    """Standalone module entry (python -m rabbittclust_tpu.workflows_dist)
    for launching one multihost process directly; scripts/launch_multihost.py
    spawns the clust_{module} console CLIs instead — both accept the same
    dbscan options."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--multihost", required=True)
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("-l", "--list", dest="sketch_by_file",
                    action="store_true")
    ap.add_argument("-k", "--kmer-size", dest="kmer_size", type=int,
                    default=None)
    ap.add_argument("-d", "--threshold", type=float, default=0.05)
    ap.add_argument("--drlevel", type=int, default=3)
    ap.add_argument("-m", "--min-length", dest="min_len", type=int,
                    default=10000)
    ap.add_argument("-t", "--threads", type=int, default=0)
    ap.add_argument("--bits", type=int, default=8192)
    ap.add_argument("--module", default="mst",
                    choices=["mst", "greedy", "leiden", "dbscan"])
    ap.add_argument("--minpts", type=int, default=5)
    # leiden options — same surface as the clust_leiden CLI
    ap.add_argument("--resolution", type=float, default=1.0)
    ap.add_argument("--louvain", dest="use_louvain", action="store_true")
    # dbscan accelerators — same surface as the clust_dbscan CLI so both
    # launch paths (this module entry and the clust_* console scripts)
    # accept identical options
    ap.add_argument("--knn", dest="knn_k", type=int, default=0)
    ap.add_argument("--max-posting", dest="max_posting", type=int, default=0)
    ap.add_argument("--virtual-cpu-devices", type=int, default=None)
    args = ap.parse_args(argv)
    coord, n_proc, pid = parse_multihost_spec(args.multihost)
    clust_mst_multihost(
        args.input, args.output, coord, n_proc, pid,
        sketch_by_file=args.sketch_by_file, kmer_size=args.kmer_size,
        threshold=args.threshold, drlevel=args.drlevel,
        min_len=args.min_len, threads=args.threads, bits=args.bits,
        module=args.module, min_pts=args.minpts, knn_k=args.knn_k,
        max_posting=args.max_posting, resolution=args.resolution,
        use_leiden=not args.use_louvain,
        virtual_cpu_devices=args.virtual_cpu_devices)
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
