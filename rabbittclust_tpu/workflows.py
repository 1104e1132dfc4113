"""Workflow orchestration — the reference sub_command.cpp layer.

Each public function is one end-to-end workflow wired from the building
blocks: ingest/sketch -> distance/cluster engine -> postprocess -> outputs +
persistence.  Reference call stacks: SURVEY.md §3.
"""

from __future__ import annotations

import math
import os
import sys
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .cluster.greedy import greedy_cluster
from .cluster.mst import (
    MstResult,
    clusters_from_forest,
    compute_mst,
    cut_forest,
    get_noise_nodes,
    modify_forest,
)
from .distance.mash import max_distance_for_sketch
from .io.prescan import cal_size
from .sketch.base import SketchSet
from .sketch.kssd import KssdParams, sketch_files_kssd, sketch_sequences_kssd
from .sketch.minhash import (
    MinHashParams,
    sketch_files_minhash,
    sketch_sequences_minhash,
)
from .io.fasta import read_file_list
from .state import sketch_io
from .state.cluster_io import write_cluster_file


def log(msg: str) -> None:
    print(msg, file=sys.stderr)


# ---------------------------------------------------------------------------
# Parameter auto-tuning (reference sub_command.cpp:2317-2467)
# ---------------------------------------------------------------------------

@dataclass
class TunedParams:
    kmer_size: int
    threshold: float
    is_containment: bool
    contain_compress: int
    sketch_size: int
    max_dist: float


def tune_kssd_parameters(sketch_by_file: bool, is_set_kmer: bool,
                         input_file: str, threads: int, min_len: int,
                         is_containment: bool, kmer_size: int,
                         threshold: float, drlevel: int) -> TunedParams:
    max_size, min_size, avg_size = cal_size(sketch_by_file, input_file,
                                            threads, min_len)
    compression = 1 << (4 * drlevel)
    sketch_size = avg_size // compression
    kmer_size = _tune_kmer(is_set_kmer, kmer_size, max_size)
    if not is_containment:
        min_jaccard = 1.0 / sketch_size if sketch_size else 1.0
    else:
        denom = min_size // compression
        min_jaccard = 1.0 / denom if denom else 1.0
    max_dist = max_distance_for_sketch(min_jaccard, kmer_size)
    log(f"-----the max recommand distance threshold is: {max_dist}")
    if threshold > max_dist:
        raise ValueError(
            f"tune_parameters(): the threshold {threshold} is out of the "
            f"valid distance range estimated by Mash distance or AAF distance")
    return TunedParams(kmer_size=kmer_size, threshold=threshold,
                       is_containment=is_containment, contain_compress=0,
                       sketch_size=sketch_size, max_dist=max_dist)


def tune_parameters(sketch_by_file: bool, is_set_kmer: bool, input_file: str,
                    threads: int, min_len: int, is_containment: bool,
                    is_jaccard: bool, kmer_size: int, threshold: float,
                    contain_compress: int, sketch_size: int,
                    greedy_default_containment: bool = False) -> TunedParams:
    max_size, min_size, avg_size = cal_size(sketch_by_file, input_file,
                                            threads, min_len)
    if is_containment and is_jaccard:
        raise ValueError("conflicting Mash (fixed-size) and AAF "
                         "(variable-size) distance measurements")
    if greedy_default_containment:
        # clust-greedy defaults to containment (sub_command.cpp:2392-2407)
        if not is_containment and not is_jaccard:
            contain_compress = max(avg_size // 1000, 1)
            is_containment = True
        elif is_containment and avg_size // max(contain_compress, 1) < 10:
            log(f"the containCompress {contain_compress} is too large and "
                f"the sketch size is too small")
            contain_compress = max(avg_size // 1000, 1)
            log(f"set the containCompress to: {contain_compress}")
    kmer_size = _tune_kmer(is_set_kmer, kmer_size, max_size)
    if not is_containment:
        min_jaccard = 1.0 / sketch_size
    else:
        denom = min_size // max(contain_compress, 1)
        min_jaccard = 1.0 / denom if denom else 1.0
    max_dist = max_distance_for_sketch(min_jaccard, kmer_size)
    log(f"-----the max recommand distance threshold is: {max_dist}")
    if threshold > max_dist:
        raise ValueError(
            f"tune_parameters(): the threshold {threshold} is out of the "
            f"valid distance range estimated by Mash distance or AAF distance")
    return TunedParams(kmer_size=kmer_size, threshold=threshold,
                       is_containment=is_containment,
                       contain_compress=contain_compress,
                       sketch_size=sketch_size, max_dist=max_dist)


def _tune_kmer(is_set_kmer: bool, kmer_size: int, max_size: int) -> int:
    warning_rate = 0.01
    recommend_rate = 0.0001
    recommended = math.ceil(
        math.log(max_size * (1 - recommend_rate) / recommend_rate) / math.log(4))
    warning = math.ceil(
        math.log(max_size * (1 - warning_rate) / warning_rate) / math.log(4))
    if not is_set_kmer:
        return recommended
    if kmer_size < warning:
        log(f"the kmerSize {kmer_size} is too small for the maximum genome "
            f"size of {max_size}")
        log(f"replace the kmerSize to the: {recommended} for reducing the "
            f"random collision of kmers")
        return recommended
    if kmer_size > recommended + 3:
        log(f"the kmerSize {kmer_size} maybe too large for the maximum "
            f"genome size of {max_size}")
        log(f"replace the kmerSize to the {recommended} for increasing the "
            f"sensitivity of genome comparison")
        return recommended
    return kmer_size


# ---------------------------------------------------------------------------
# Tree / linkage / postprocess dispatch helpers
# ---------------------------------------------------------------------------

@dataclass
class OutputOptions:
    newick_tree: bool = False
    phylip_tree: bool = False
    nexus_tree: bool = False
    linkage_matrix: bool = False
    auto_threshold: bool = False
    stability: bool = False
    dense: bool = False
    dedup_dist: float = -1.0
    reps_per_cluster: int = 0
    save_rep: bool = False
    no_save: bool = False
    use_device: bool = False     # GPU pair engine for the distance phase


def _emit_trees(ss: SketchSet, mst, output_file: str, opts: OutputOptions):
    if not (opts.newick_tree or opts.phylip_tree or opts.nexus_tree
            or opts.linkage_matrix):
        return
    from .post.trees import (
        write_linkage_matrix,
        write_newick_tree,
        write_nexus_tree,
        write_phylip_tree,
    )
    if opts.newick_tree:
        write_newick_tree(ss, mst, output_file + ".newick.tree")
    if opts.phylip_tree:
        write_phylip_tree(ss, mst, output_file + ".phylip.tree")
    if opts.nexus_tree:
        write_nexus_tree(ss, mst, output_file + ".nexus.tree")
    if opts.linkage_matrix:
        write_linkage_matrix(len(ss), mst, output_file + ".linkage.txt")


def _mst_outputs(ss: SketchSet, res: MstResult, threshold: float,
                 output_file: str, opts: OutputOptions,
                 folder_path: Optional[str], kssd: bool = True):
    """Shared tail of every clust-mst workflow: trees, auto-threshold
    report, clusters, per-cluster noise removal, dedup/reps.

    Matches reference semantics: auto-threshold only *reports* (clustering
    keeps the user threshold, sub_command.cpp:1853-1897); the threshold
    header appears only in the KSSD main cluster file
    (printKssdResult calls at sub_command.cpp:2078 vs printResult at :1898).
    """
    if opts.auto_threshold:
        from .post.auto_threshold import select_and_report_threshold
        select_and_report_threshold(res.mst, output_file,
                                    stability=opts.stability,
                                    fallback=threshold, num_vertices=res.n)
    elif opts.stability:
        from .post.auto_threshold import report_threshold_stability
        report_threshold_stability(res.mst, threshold, output_file,
                                   num_vertices=res.n)
    _emit_trees(ss, res.mst, output_file, opts)

    forest = cut_forest(res.mst, threshold)
    clusters = clusters_from_forest(forest, res.n)
    write_cluster_file(output_file, clusters, ss,
                       threshold if kssd else -1.0)
    log(f"-----write the cluster result into: {output_file}")
    log(f"-----the number of clusters is: {len(clusters)}")

    if opts.dense and res.dense is not None:
        # per-cluster noise removal (reference sub_command.cpp:2105-2128):
        # within each multi-member cluster, flag nodes whose density at the
        # threshold bucket is <= min(cluster Q1 - 1, alpha=2)
        dense_index = min(int(threshold / 0.01), res.dense.shape[0] - 1)
        row = res.dense[dense_index]
        noise: List[int] = []
        for cl in clusters:
            if len(cl) == 1:
                continue
            noise.extend(int(x) for x in
                         np.asarray(cl)[get_noise_nodes(row[np.asarray(cl)])])
        log(f"-----the total noiseArr size is: {len(noise)}")
        new_forest = modify_forest(forest, np.asarray(noise, dtype=np.int64))
        new_clusters = clusters_from_forest(new_forest, res.n)
        write_cluster_file(output_file + ".removeNoise", new_clusters, ss)
        log(f"-----write the cluster without noise into: "
            f"{output_file}.removeNoise")
    if opts.dedup_dist >= 0.0 or opts.reps_per_cluster > 0:
        from .post.postprocess import dedup_and_reps
        dedup_and_reps(ss, forest, clusters, opts.dedup_dist,
                       opts.reps_per_cluster, output_file)
    return clusters, threshold


def _compute_mst_engine(ss: SketchSet, threshold: float, kmer_size: int,
                        is_containment: bool, opts: OutputOptions,
                        start_index: int = 0, pre_edges=None,
                        threads: int = 0) -> MstResult:
    if opts.use_device:
        from .utils.jaxcfg import configure_jax
        configure_jax()
        import jax
        n_dev = len(jax.devices())
        mesh_pref = os.environ.get("RTC_MESH", "auto")
        use_mesh = (mesh_pref == "1" or
                    (mesh_pref == "auto" and n_dev > 1)) \
            and start_index == 0 and pre_edges is None and not opts.dense
        if use_mesh:
            # >1 visible devices: ring-sharded pair tiles over the mesh
            # (interconnect traffic; edge-partition MST theorem).  The fast bitmap
            # ring suffices when the MST is only cut at <= threshold
            # (plain -e cluster run); anything that persists or analyzes
            # the MST (edge.mst reuse at other thresholds, trees,
            # auto-threshold) needs the full exact ring.
            from .parallel.dist_engine import distributed_mst
            full = (not opts.no_save) or opts.newick_tree \
                or opts.phylip_tree or opts.nexus_tree \
                or opts.linkage_matrix or opts.auto_threshold \
                or opts.stability
            log(f"-----using the {n_dev}-device mesh ring engine "
                f"({'exact' if full else 'bitmap'})")
            return distributed_mst(ss.hashes, threshold, kmer_size,
                                   is_containment=is_containment,
                                   full_mst=full)
        from .ops.engine import compute_mst_device
        return compute_mst_device(
            ss.hashes, threshold, kmer_size, is_containment=is_containment,
            with_dense=opts.dense, start_index=start_index,
            pre_edges=pre_edges)
    return compute_mst(ss.hashes, threshold, kmer_size,
                       is_containment=is_containment, with_dense=opts.dense,
                       start_index=start_index, pre_edges=pre_edges,
                       threads=threads)


# ---------------------------------------------------------------------------
# clust-mst workflows (KSSD --fast)
# ---------------------------------------------------------------------------

def clust_from_genome_fast(input_file: str, output_file: str,
                           folder_path: Optional[str], sketch_by_file: bool,
                           is_containment: bool, kmer_size: int,
                           threshold: float, drlevel: int, min_len: int,
                           threads: int, opts: OutputOptions,
                           module: str = "mst"):
    """clust-mst/clust-greedy --fast from genomes
    (reference sub_command.cpp:1934)."""
    from .utils.timers import Timer
    timer = Timer()
    with timer.phase("computing sketch (with index)"):
        if sketch_by_file:
            files = read_file_list(input_file)
            if opts.use_device and \
                    os.environ.get("RTC_DEVICE_SKETCH", "0") == "1":
                # opt-in device sketch phase (bit-identical to native);
                # the native C++ sketcher is the default until the H100
                # decides otherwise (ROADMAP 3.5)
                from .ops.sketch_device import sketch_files_kssd_device
                ss, p = sketch_files_kssd_device(files, min_len, kmer_size,
                                                 drlevel)
            else:
                ss, p = sketch_files_kssd(files, min_len, kmer_size,
                                          drlevel, threads)
        else:
            ss, p = sketch_sequences_kssd(input_file, min_len, kmer_size,
                                          drlevel, threads)
    log(f"-----the size of sketches (genomes) is: {len(ss)}")
    folder = folder_path or sketch_io.default_folder_path()
    if not opts.no_save:
        sketch_io.ensure_folder(folder)
        sketch_io.save_kssd_sketches(ss, p, folder)
        sketch_io.save_kssd_index(ss.hashes, ss.use64, folder)
    return compute_kssd_clusters(ss, p, threshold, threads, output_file,
                                 is_containment, opts, folder, module)


def _greedy_corpus_is_dense(hashes, threshold: float, kmer_size: int,
                            probe_n: int = 1024,
                            degree_cut: float = 10.0) -> bool:
    """Candidate-density probe for the --device greedy crossover: exact
    candidate pairs (greedy accept bound) among the ``probe_n`` largest
    genomes via the native pair engine; dense iff the average per-genome
    candidate degree exceeds ``degree_cut``.  Planted 'dense' corpora
    probe ~100, 'sparse' ~1.  Small corpora (< 16384) always count as
    dense.  The cut and the size floor were set on other hardware;
    re-deciding them on the H100 is ROADMAP 1.6."""
    from .distance.mash import min_jaccard_for_threshold
    from .cluster.mst import native_pair_counts

    n = len(hashes)
    if n < 16384:
        return True
    m = min(probe_n, n)
    sub = hashes[:m]  # size-sorted corpus: the sweep's own first tile
    j_min = min_jaccard_for_threshold(threshold, kmer_size)
    nat = native_pair_counts(sub, j_min=j_min * (1.0 - 1e-9), ratio2=2)
    if nat is None:  # no native lib: stay on the measured-safe default
        return True
    pairs = len(nat[0])
    return (2.0 * pairs / m) >= degree_cut


def compute_kssd_clusters(ss: SketchSet, p: KssdParams, threshold: float,
                          threads: int, output_file: str,
                          is_containment: bool, opts: OutputOptions,
                          folder: Optional[str], module: str):
    if module == "greedy":
        order = ss.kssd_greedy_order()
        ss2 = ss.reorder(order)
        mode = os.environ.get("RTC_GREEDY_DEVICE", "auto")
        if opts.use_device and mode != "native":
            # density-aware crossover (scripts/device_greedy_bench.py
            # --table): DENSE corpora favor the native engine (mask pulls
            # dominate the sweep) while SPARSE corpora favor the device
            # sweep (the host rep index blows up when most genomes become
            # reps).  The probe measures candidate degree on the top-1024
            # genomes: avg candidates/genome >= 10 -> dense -> native.
            if mode == "auto" and _greedy_corpus_is_dense(
                    ss2.hashes, threshold, p.kmer_size):
                log("-----device greedy: dense corpus — routing to the "
                    "native engine (RTC_GREEDY_DEVICE=force overrides)")
                gres = greedy_cluster(ss2.hashes, threshold, p.kmer_size,
                                      presorted=True, is_containment=False,
                                      progress=True)
            else:
                from .ops.greedy_device import greedy_cluster_device
                gres = greedy_cluster_device(
                    ss2.hashes, threshold, p.kmer_size, presorted=True,
                    is_containment=False)
        else:
            gres = greedy_cluster(ss2.hashes, threshold, p.kmer_size,
                                  presorted=True, is_containment=False,
                                  progress=True)
        # greedy main output has no threshold header (sub_command.cpp:1969)
        write_cluster_file(output_file, gres.clusters, ss2)
        log(f"-----write the cluster result into: {output_file}")
        log(f"-----the number of clusters is: {len(gres.clusters)}")
        if opts.save_rep and folder:
            from .state.greedy_state import KssdClusterState
            st = KssdClusterState.from_clustering(ss2, p, gres, threshold)
            st.save(os.path.join(folder, "cluster_state.bin"))
        return gres.clusters, ss2
    # MST module
    from .utils.timers import Timer
    timer = Timer()
    if (os.environ.get("RTC_MST_CLUSTERS_FAST", "1") != "0"
            and opts.use_device and opts.no_save and not opts.dense
            and not opts.save_rep and not opts.newick_tree
            and not opts.phylip_tree and not opts.nexus_tree
            and not opts.linkage_matrix and not opts.auto_threshold
            and not opts.stability and opts.dedup_dist < 0.0
            and opts.reps_per_cluster <= 0):
        # DEFAULT MST-free clusters path for `--device -e` with no MST
        # consumer (RTC_MST_CLUSTERS_FAST=0 restores the dense MST
        # engine): the gated-verify / label-propagation engine produces
        # the IDENTICAL partition with O(N)-per-round pulls at scale (the
        # bench headline engine).  Member order:
        #   -t 1  -> ALWAYS the reference's serial order: the certified
        #            intra-cluster cadence replay when no hash crosses
        #            clusters (rtc_intra_mst), else the full serial
        #            parity engine (byte-identical goldens at 400/5k);
        #   -t >1 -> BFS over the distance-sorted verified spanning
        #            forest (the reference's own member order is
        #            completion-order nondeterministic multithreaded,
        #            MST.cpp:562-571, so there is no byte target here).
        if threads == 1:
            from .ops.cluster_fast import (
                threshold_clusters_device_exact_order)
            log("-----using the MST-free device cluster engine "
                "(-t 1: reference serial member order)")
            with timer.phase("computing clusters (device, MST-free)"):
                clusters, exact = threshold_clusters_device_exact_order(
                    ss.hashes, threshold, p.kmer_size,
                    is_containment=is_containment)
            if not exact:
                log("-----note: clusters share hashes across the "
                    "threshold partition — ran the full serial engine "
                    "for the reference-exact member order (the -t 1 "
                    "output is defined by its serial sort cadence)")
        else:
            from .ops.cluster_fast import threshold_clusters_device
            log("-----using the MST-free device cluster engine "
                "(partition-exact; member order is deterministic but "
                "not the serial reference's — use -t 1 for that)")
            with timer.phase("computing clusters (device, MST-free)"):
                clusters = threshold_clusters_device(
                    ss.hashes, threshold, p.kmer_size,
                    is_containment=is_containment)
        write_cluster_file(output_file, clusters, ss, threshold)
        log(f"-----write the cluster result into: {output_file}")
        log(f"-----the number of clusters is: {len(clusters)}")
        return clusters, ss
    with timer.phase("computing mst"):
        res = _compute_mst_engine(ss, threshold, p.kmer_size, is_containment,
                                  opts, threads=threads)
    if not opts.no_save and folder:
        sketch_io.ensure_folder(folder)
        sketch_io.save_genome_info(ss, folder, "mst", kssd=True)
        sketch_io.save_mst(res.mst, folder)
        if opts.dense and res.dense is not None:
            sketch_io.save_dense(folder, res.dense)
            sketch_io.save_ani(folder, res.ani)
    clusters, used = _mst_outputs(ss, res, threshold, output_file, opts,
                                  folder)
    if opts.save_rep and folder:
        from .state.mst_state import KssdMstState
        st = KssdMstState.from_clustering(ss, p, res.mst, clusters, used)
        st.save(os.path.join(folder, "mst_cluster_state.bin"))
    return clusters, ss


def clust_from_sketch_fast(folder_path: str, output_file: str,
                           threshold: float, threads: int,
                           is_containment: bool, opts: OutputOptions,
                           module: str = "mst"):
    """--presketched path (reference sub_command.cpp:2469)."""
    ss, p = sketch_io.load_kssd_sketches(folder_path)
    log(f"-----load {len(ss)} kssd sketches from: {folder_path}")
    return compute_kssd_clusters(ss, p, threshold, threads, output_file,
                                 is_containment, opts, folder_path, module)


def clust_from_mst_fast(folder_path: str, output_file: str, threshold: float,
                        threads: int, opts: OutputOptions, kssd: bool = True):
    """--premsted path: re-cluster from a saved MST at a new threshold.

    ``kssd=False`` replicates the reference's MinHash-premsted quirk of
    omitting the threshold header (sub_command.cpp:1898 vs 1790)."""
    by_file, info = sketch_io.load_genome_info(folder_path, "mst", kssd=kssd)
    mst = sketch_io.load_mst(folder_path)
    n = len(info["names"])
    ss = SketchSet("kssd" if kssd else "minhash", None, by_file,
                   info["use64"])
    for i in range(n):
        ss.append_genome(
            file_name=info["file_names"][i], name=info["names"][i],
            comment=info["comments"][i], seq0_len=info["seq0_lens"][i],
            total_len=info["total_lens"][i], num_seqs=1,
            hashes=np.empty(0, dtype=np.uint64))
    res = MstResult(mst=mst, n=n)
    if opts.dense:
        try:
            res.dense = sketch_io.load_dense(folder_path)
            res.ani = sketch_io.load_ani(folder_path)
        except FileNotFoundError:
            log("-----no dense/ani files in folder; skipping noise removal")
            opts.dense = False
    return _mst_outputs(ss, res, threshold, output_file, opts, folder_path,
                        kssd=kssd)


def append_clust_mst_fast(folder_path: str, input_file: str,
                          output_file: str, sketch_by_file: bool,
                          is_containment: bool, min_len: int,
                          threshold: float, threads: int,
                          opts: OutputOptions):
    """--append with --presketched/--premsted (reference
    sub_command.cpp:1286-1528): uses the saved MST medoid state when
    mst_cluster_state.bin exists, else the classic pre-MST merge path."""
    state_file = os.path.join(folder_path, "mst_cluster_state.bin")
    if os.path.exists(state_file):
        from .state.mst_state import MstState
        st = MstState.load(state_file)
        if st.kind == "kssd":
            p = KssdParams(half_k=st.half_k, half_subk=st.half_subk,
                           drlevel=st.drlevel)
            if sketch_by_file:
                new_ss, _ = sketch_files_kssd(
                    read_file_list(input_file), min_len, p.kmer_size,
                    p.drlevel, threads)
            else:
                new_ss, _ = sketch_sequences_kssd(
                    input_file, min_len, p.kmer_size, p.drlevel, threads)
        else:
            mp = MinHashParams(kmer_size=st.kmer_size,
                               sketch_size=st.sketch_size,
                               is_containment=st.is_containment,
                               contain_compress=st.contain_compress)
            if sketch_by_file:
                new_ss = sketch_files_minhash(read_file_list(input_file),
                                              min_len, mp, threads)
            else:
                new_ss = sketch_sequences_minhash(input_file, min_len, mp,
                                                  threads)
        live = st.append_cluster(new_ss)
        if not opts.no_save:
            st.save(state_file)
        st.write_cluster_result(live, output_file, st.threshold)
        log(f"-----write the cluster result into: {output_file}")
        return live, None
    ss, p = sketch_io.load_kssd_sketches(folder_path)
    pre_n = len(ss)
    log(f"-----load {pre_n} pre-generated sketches from: {folder_path}")
    if sketch_by_file:
        files = read_file_list(input_file)
        new_ss, p2 = sketch_files_kssd(files, min_len, p.kmer_size,
                                       p.drlevel, threads)
    else:
        new_ss, p2 = sketch_sequences_kssd(input_file, min_len, p.kmer_size,
                                           p.drlevel, threads)
    if p2 != p:
        raise ValueError(f"append parameter mismatch: {p2} vs stored {p}")
    if new_ss.use64 != ss.use64:
        raise ValueError("append use64 mismatch with stored sketches")
    ss.extend(new_ss)
    pre_mst = None
    try:
        pre_mst = sketch_io.load_mst(folder_path)
    except FileNotFoundError:
        pre_n = 0  # no MST: recompute everything
    res = _compute_mst_engine(ss, threshold, p.kmer_size, is_containment,
                              opts, start_index=pre_n if pre_mst else 0,
                              pre_edges=pre_mst, threads=threads)
    # the merged artifacts go into a NEW run folder — the source folder is
    # never mutated (reference append_clust_mst_fast writes
    # new_folder_path, sub_command.cpp:1450-1470)
    out_folder = folder_path
    if not opts.no_save:
        out_folder = sketch_io.default_folder_path()
        sketch_io.ensure_folder(out_folder)
        sketch_io.save_kssd_sketches(ss, p, out_folder)
        sketch_io.save_kssd_index(ss.hashes, ss.use64, out_folder)
        sketch_io.save_genome_info(ss, out_folder, "mst", kssd=True)
        sketch_io.save_mst(res.mst, out_folder)
    return _mst_outputs(ss, res, threshold, output_file, opts, out_folder)


def append_clust_greedy_fast(folder_path: str, input_file: str,
                             output_file: str, sketch_by_file: bool,
                             min_len: int, threshold: float, threads: int,
                             opts: OutputOptions):
    """Greedy append: incremental clustering against saved state."""
    from .state.greedy_state import KssdClusterState
    state_file = os.path.join(folder_path, "cluster_state.bin")

    def sketch_new(p):
        if sketch_by_file:
            files = read_file_list(input_file)
            return sketch_files_kssd(files, min_len, p.kmer_size, p.drlevel,
                                     threads)[0]
        return sketch_sequences_kssd(input_file, min_len, p.kmer_size,
                                     p.drlevel, threads)[0]

    if os.path.exists(state_file):
        st = KssdClusterState.load(state_file)
        new_ss = sketch_new(st.params)
        if not opts.no_save:  # new-genome sketches get their own run folder
            nf = sketch_io.default_folder_path()
            sketch_io.ensure_folder(nf)
            sketch_io.save_kssd_sketches(new_ss, st.params, nf)
        st.incremental_cluster(new_ss)
        st.write_cluster_result(output_file)
        # state re-saved only when --save-rep is given on the append run
        # (reference: if (!no_save && save_rep_index), sub_command.cpp)
        if not opts.no_save and opts.save_rep:
            st.save(state_file)
        return st.clusters, None
    # no saved state: build it from the pre-sketched genomes, then append
    # incrementally — the reference's greedy --fast append ALWAYS uses the
    # state machine (KssdInitialClusterWithState + KssdIncrementalCluster),
    # never a full merged re-cluster
    ss, p = sketch_io.load_kssd_sketches(folder_path)
    new_ss = sketch_new(p)
    if not opts.no_save:
        nf = sketch_io.default_folder_path()
        sketch_io.ensure_folder(nf)
        sketch_io.save_kssd_sketches(new_ss, p, nf)
    order = ss.kssd_greedy_order()
    ss2 = ss.reorder(order)
    gres = greedy_cluster(ss2.hashes, threshold, p.kmer_size, presorted=True)
    st = KssdClusterState.from_clustering(ss2, p, gres, threshold)
    if not opts.no_save and opts.save_rep:
        st.save(state_file)
    st.incremental_cluster(new_ss)
    if not opts.no_save and opts.save_rep:
        st.save(state_file)
    st.write_cluster_result(output_file)
    return st.clusters, None


# ---------------------------------------------------------------------------
# MinHash (default, no --fast) workflows
# ---------------------------------------------------------------------------

def clust_from_genomes(input_file: str, output_file: str,
                       folder_path: Optional[str], sketch_by_file: bool,
                       kmer_size: int, sketch_size: int, threshold: float,
                       is_containment: bool, contain_compress: int,
                       min_len: int, threads: int, opts: OutputOptions,
                       module: str = "mst"):
    p = MinHashParams(kmer_size=kmer_size, sketch_size=sketch_size,
                      is_containment=is_containment,
                      contain_compress=contain_compress)
    if sketch_by_file:
        files = read_file_list(input_file)
        ss = sketch_files_minhash(files, min_len, p, threads)
    else:
        ss = sketch_sequences_minhash(input_file, min_len, p, threads)
    log(f"-----the size of sketches (genomes) is: {len(ss)}")
    folder = folder_path or sketch_io.default_folder_path()
    if not opts.no_save:
        sketch_io.ensure_folder(folder)
        sketch_io.save_minhash_sketches(ss, folder, kmer_size,
                                        is_containment, contain_compress,
                                        sketch_size)
        sketch_io.save_minhash_index(ss.hashes, folder)
    return compute_minhash_clusters(ss, p, threshold, threads, output_file,
                                    opts, folder, module)


def compute_minhash_clusters(ss: SketchSet, p: MinHashParams,
                             threshold: float, threads: int,
                             output_file: str, opts: OutputOptions,
                             folder: Optional[str], module: str,
                             presketched: bool = False):
    if module == "greedy":
        # Reference ordering quirk: the FRESH-genome path runs greedy in
        # input order (compute_clusters never sorts,
        # sub_command.cpp:2891-2914); only the PRESKETCHED path sorts, by
        # genome length desc (sub_command.cpp:2658-2660).
        if presketched:
            order = ss.minhash_presketched_order()
        else:
            order = np.arange(len(ss), dtype=np.int64)
        ss2 = ss.reorder(order)
        if opts.use_device:
            # device sweep with the reference's MinHash-parity semantics
            # (param-size asymmetry, first-touch ties) — bit-exact vs the
            # host engine below
            from .ops.greedy_device import minhash_greedy_device
            gres = minhash_greedy_device(ss2.hashes, ss2.param_sizes,
                                         threshold, p.kmer_size,
                                         p.is_containment)
        else:
            from .cluster.greedy import minhash_greedy_parity
            gres = minhash_greedy_parity(ss2.hashes, ss2.param_sizes,
                                         threshold, p.kmer_size,
                                         p.is_containment)
        write_cluster_file(output_file, gres.clusters, ss2)
        log(f"-----the number of clusters is: {len(gres.clusters)}")
        if opts.save_rep and folder and not opts.no_save:
            from .state.greedy_state import MinHashClusterState
            st = MinHashClusterState.from_clustering(ss2, p, gres, threshold)
            sketch_io.ensure_folder(folder)
            st.save(os.path.join(folder, "cluster_state.bin"))
        return gres.clusters, ss2
    res = _compute_mst_engine(ss, threshold, p.kmer_size, p.is_containment,
                              opts, threads=threads)
    if not opts.no_save and folder:
        sketch_io.ensure_folder(folder)
        sketch_io.save_genome_info(ss, folder, "mst", kssd=False)
        sketch_io.save_mst(res.mst, folder)
        if opts.dense and res.dense is not None:
            sketch_io.save_dense(folder, res.dense)
            sketch_io.save_ani(folder, res.ani)
    # MinHash fresh/presketched MST output includes the threshold header
    # (reference printResult calls at sub_command.cpp:2809,3051)
    return _mst_outputs(ss, res, threshold, output_file, opts, folder,
                        kssd=True)


def clust_from_sketches(folder_path: str, output_file: str, threshold: float,
                        threads: int, opts: OutputOptions,
                        module: str = "mst"):
    ss, p = sketch_io.load_minhash_sketches(folder_path)
    log(f"-----load {len(ss)} minhash sketches from: {folder_path}")
    return compute_minhash_clusters(ss, p, threshold, threads, output_file,
                                    opts, folder_path, module,
                                    presketched=True)
