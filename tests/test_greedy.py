"""Greedy engine: recovery, determinism, bounds, containment mode."""

import numpy as np
import pytest

from rabbittclust_tpu.cluster.greedy import greedy_cluster
from rabbittclust_tpu.sketch.kssd import sketch_files_kssd
from tests.helpers import clusters_to_labels, same_partition


def test_greedy_recovery(synthetic_genomes):
    ss, p = sketch_files_kssd(synthetic_genomes.files, min_len=1000,
                              kmer_size=19, drlevel=2)
    res = greedy_cluster(ss.hashes, 0.05, p.kmer_size)
    labels = clusters_to_labels(res.clusters, len(ss))
    assert same_partition(labels, synthetic_genomes.labels)
    # representative is the first member of each cluster
    for cl, rep in zip(res.clusters, res.representatives):
        assert cl[0] == rep


def test_greedy_first_genome_seeds_cluster0(synthetic_genomes):
    ss, p = sketch_files_kssd(synthetic_genomes.files, min_len=1000,
                              kmer_size=19, drlevel=2)
    res = greedy_cluster(ss.hashes, 0.05, p.kmer_size)
    # cluster 0's rep must be the largest sketch (size-desc order)
    sizes = ss.sizes
    assert sizes[res.representatives[0]] == sizes.max()


def test_greedy_zero_threshold_singletons(synthetic_genomes):
    ss, p = sketch_files_kssd(synthetic_genomes.files, min_len=1000,
                              kmer_size=19, drlevel=2)
    res = greedy_cluster(ss.hashes, 1e-9, p.kmer_size)
    # mutated copies are not identical -> all singletons
    assert len(res.clusters) == len(ss)


def test_greedy_presorted_matches_unsorted(synthetic_genomes):
    ss, p = sketch_files_kssd(synthetic_genomes.files, min_len=1000,
                              kmer_size=19, drlevel=2)
    r1 = greedy_cluster(ss.hashes, 0.05, p.kmer_size)
    order = ss.sort_by_size_desc()
    ss2 = ss.reorder(order)
    r2 = greedy_cluster(ss2.hashes, 0.05, p.kmer_size, presorted=True)
    # map r2 (sorted ids) back to original ids
    mapped = [[int(order[g]) for g in cl] for cl in r2.clusters]
    assert [sorted(c) for c in mapped] == [sorted(c) for c in r1.clusters]


def test_greedy_containment_mode(synthetic_genomes):
    ss, p = sketch_files_kssd(synthetic_genomes.files, min_len=1000,
                              kmer_size=19, drlevel=2)
    res = greedy_cluster(ss.hashes, 0.05, p.kmer_size, is_containment=True)
    labels = clusters_to_labels(res.clusters, len(ss))
    assert same_partition(labels, synthetic_genomes.labels)


def test_greedy_batched_purity(synthetic_genomes):
    """Batched greedy (reference KssdGreedyClusterWithInvertedIndexBatched)
    can split clusters across batch boundaries (members of one batch never
    see each other as representatives), but every produced cluster must be
    pure, and large batches converge to the serial result."""
    from rabbittclust_tpu.cluster.greedy import greedy_cluster_batched
    ss, p = sketch_files_kssd(synthetic_genomes.files, min_len=1000,
                              kmer_size=19, drlevel=2)
    res = greedy_cluster_batched(ss.hashes, 0.05, p.kmer_size, batch_size=4)
    labels = synthetic_genomes.labels
    for cl in res.clusters:
        assert len({labels[g] for g in cl}) == 1  # purity
    # batch of 1 degenerates to the serial algorithm's partition
    res1 = greedy_cluster_batched(ss.hashes, 0.05, p.kmer_size, batch_size=1)
    ser = greedy_cluster(ss.hashes, 0.05, p.kmer_size)
    assert {frozenset(c) for c in res1.clusters} == \
        {frozenset(c) for c in ser.clusters}


def test_native_greedy_matches_python():
    """Native C++ greedy engine == Python loop bit-exactly, both modes,
    including the monotonic-prune path (tiny prune interval forces it)."""
    import numpy as np
    from rabbittclust_tpu.cluster.greedy import greedy_cluster
    rng = np.random.default_rng(11)
    # clustered + size-varied sketches (sizes descending after sort)
    bases = [np.unique(rng.integers(0, 2**31, size=s).astype(np.uint32))
             for s in (2000, 1500, 1200, 900, 700, 500)]
    hashes = []
    for i in range(120):
        b = bases[i % len(bases)]
        keep = b[rng.random(len(b)) < 0.85]
        extra = np.unique(rng.integers(0, 2**31, size=60).astype(np.uint32))
        hashes.append(np.unique(np.concatenate([keep, extra])))
    for is_cont in (False, True):
        for pi in (0, 16):  # default and prune-forcing interval
            r_nat = greedy_cluster(hashes, 0.05, 21, is_containment=is_cont,
                                   backend="native", prune_interval=pi)
            r_py = greedy_cluster(hashes, 0.05, 21, is_containment=is_cont,
                                  backend="python", prune_interval=pi)
            assert r_nat.clusters == r_py.clusters, (is_cont, pi)
            assert r_nat.representatives == r_py.representatives
    # 64-bit hashes
    h64 = [h.astype(np.uint64) for h in hashes]
    r_nat = greedy_cluster(h64, 0.05, 21, backend="native")
    r_py = greedy_cluster(h64, 0.05, 21, backend="python")
    assert r_nat.clusters == r_py.clusters


def test_greedy_density_probe_classifies_corpora():
    """The --device greedy crossover probe must separate the A/B table's
    corpus classes: big-cluster (dense -> native) vs mostly-singleton
    (sparse -> device), as scripts/device_greedy_bench.py --table
    builds them."""
    import numpy as np
    from rabbittclust_tpu.workflows import _greedy_corpus_is_dense

    def corpus(n, n_clusters, s=200, seed=3):
        rng = np.random.default_rng(seed)
        bases = [np.unique(rng.integers(0, 2 ** 31, size=s).astype(
            np.uint32)) for _ in range(n_clusters)]
        out = []
        for i in range(n):
            b = bases[i % n_clusters]
            keep = b[rng.random(len(b)) < 0.8]
            extra = np.unique(rng.integers(
                0, 2 ** 31, size=s - len(keep)).astype(np.uint32))
            out.append(np.unique(np.concatenate([keep, extra])))
        return out

    n = 16384
    dense = corpus(n, n // 200)
    sparse = corpus(n, n // 2)
    assert _greedy_corpus_is_dense(dense, 0.05, 21)
    assert not _greedy_corpus_is_dense(sparse, 0.05, 21)
    # below the device floor everything is "dense" (route native)
    assert _greedy_corpus_is_dense(corpus(512, 256), 0.05, 21)
