"""Louvain/Leiden and DBSCAN engines."""

import numpy as np
import pytest

from rabbittclust_tpu.cluster.dbscan import dbscan_cluster
from rabbittclust_tpu.cluster.leiden import (
    build_similarity_graph,
    community_clusters,
    load_graph,
    louvain,
    save_graph,
)
from rabbittclust_tpu.sketch.kssd import sketch_files_kssd
from tests.helpers import clusters_to_labels, same_partition


@pytest.fixture()
def sketched(synthetic_genomes):
    return sketch_files_kssd(synthetic_genomes.files, min_len=1000,
                             kmer_size=19, drlevel=2)


def test_graph_construction(sketched, synthetic_genomes):
    ss, p = sketched
    frm, to, w = build_similarity_graph(ss.hashes, 0.05, p.kmer_size)
    assert len(frm) > 0
    assert (frm < to).all()
    assert ((w > 0.9) & (w <= 1.0)).all()   # weights = 1 - dist, dist small
    # only intra-cluster edges exist (clusters share no hashes)
    lab = synthetic_genomes.labels
    for a, b in zip(frm, to):
        assert lab[a] == lab[b]


def test_knn_pruning(sketched):
    ss, p = sketched
    frm, to, w = build_similarity_graph(ss.hashes, 0.05, p.kmer_size,
                                        knn_k=2)
    # at most 2 forward edges per node
    counts = np.bincount(frm, minlength=len(ss))
    assert counts.max() <= 2


def test_louvain_recovers_components(sketched, synthetic_genomes):
    ss, p = sketched
    clusters = community_clusters(ss.hashes, 0.05, p.kmer_size,
                                  use_leiden=False)
    labels = clusters_to_labels(clusters, len(ss))
    assert same_partition(labels, synthetic_genomes.labels)
    # sorted by size descending
    sizes = [len(c) for c in clusters]
    assert sizes == sorted(sizes, reverse=True)


def test_leiden_mode_with_normalization(sketched, synthetic_genomes):
    ss, p = sketched
    clusters = community_clusters(ss.hashes, 0.05, p.kmer_size,
                                  use_leiden=True)
    labels = clusters_to_labels(clusters, len(ss))
    assert same_partition(labels, synthetic_genomes.labels)


def test_louvain_splits_weakly_linked():
    """Two dense cliques joined by one weak edge split into two communities."""
    edges = []
    for block, off in ((0, 0), (1, 8)):
        for a in range(8):
            for b in range(a):
                edges.append((off + b, off + a, 1.0))
    edges.append((0, 8, 0.05))
    frm = np.array([e[0] for e in edges])
    to = np.array([e[1] for e in edges])
    w = np.array([e[2] for e in edges])
    mem = louvain(16, (frm, to, w))
    assert len(set(mem[:8].tolist())) == 1
    assert len(set(mem[8:].tolist())) == 1
    assert mem[0] != mem[8]


def test_graph_save_load(tmp_path, sketched):
    ss, p = sketched
    g = build_similarity_graph(ss.hashes, 0.05, p.kmer_size)
    path = str(tmp_path / "g.graph")
    save_graph(g, len(ss), path)
    n, g2 = load_graph(path)
    assert n == len(ss)
    assert np.array_equal(g[0], g2[0])
    assert np.array_equal(g[1], g2[1])
    assert np.allclose(g[2], g2[2], atol=1e-6)


def test_dbscan_recovery(sketched, synthetic_genomes):
    ss, p = sketched
    # 5 per cluster; minPts=3 -> every point core, clusters recovered
    res = dbscan_cluster(ss.hashes, eps=0.05, min_pts=3,
                         kmer_size=p.kmer_size)
    assert res.num_noise == 0
    labels = clusters_to_labels(res.clusters, len(ss))
    assert same_partition(labels, synthetic_genomes.labels)


def test_dbscan_noise():
    """Isolated points become noise; dense blob becomes one cluster."""
    rng = np.random.default_rng(0)
    base = np.unique(rng.integers(0, 2 ** 28, size=300).astype(np.uint32))
    hashes = []
    for _ in range(6):  # dense blob
        keep = base[rng.random(len(base)) < 0.9]
        hashes.append(np.unique(keep))
    for _ in range(3):  # isolated points
        hashes.append(np.unique(
            rng.integers(0, 2 ** 28, size=300).astype(np.uint32)))
    res = dbscan_cluster(hashes, eps=0.05, min_pts=4, kmer_size=21)
    assert res.num_clusters == 1
    assert sorted(res.clusters[0]) == [0, 1, 2, 3, 4, 5]
    assert sorted(res.noise) == [6, 7, 8]


def test_dbscan_minpts_includes_self(sketched):
    ss, p = sketched
    # minPts=6 > cluster size 5 -> everything noise
    res = dbscan_cluster(ss.hashes, eps=0.05, min_pts=6,
                         kmer_size=p.kmer_size)
    assert res.num_clusters == 0
    assert res.num_noise == len(ss)
    # minPts=5 == cluster size (4 neighbors + self) -> clusters form
    res = dbscan_cluster(ss.hashes, eps=0.05, min_pts=5,
                         kmer_size=p.kmer_size)
    assert res.num_clusters == 4


def test_dbscan_device_path_matches_host(sketched, synthetic_genomes):
    """Bitmap-filter candidate generation yields the same DBSCAN result
    (CPU jax backend in tests)."""
    ss, p = sketched
    host = dbscan_cluster(ss.hashes, 0.05, 3, p.kmer_size)
    dev = dbscan_cluster(ss.hashes, 0.05, 3, p.kmer_size, use_device=True)
    assert [sorted(c) for c in host.clusters] == \
        [sorted(c) for c in dev.clusters]
    assert host.noise == dev.noise


def test_leiden_device_graph_matches_host(sketched):
    """build_similarity_graph(use_device=True) — bitmap candidate
    generation — yields the identical edge set and f64 weights as the
    host inverted-index path."""
    from rabbittclust_tpu.cluster.leiden import build_similarity_graph
    ss, p = sketched
    hf, ht, hw = build_similarity_graph(ss.hashes, 0.05, p.kmer_size)
    df, dt, dw = build_similarity_graph(ss.hashes, 0.05, p.kmer_size,
                                        use_device=True)
    ho = np.lexsort((ht, hf))
    do = np.lexsort((dt, df))
    assert np.array_equal(hf[ho], df[do])
    assert np.array_equal(ht[ho], dt[do])
    assert np.array_equal(hw[ho], dw[do])


def test_edge_parallel_warm_start(sketched, synthetic_genomes):
    from rabbittclust_tpu.cluster.leiden import (
        build_similarity_graph, louvain_edge_parallel)
    ss, p = sketched
    g = build_similarity_graph(ss.hashes, 0.05, p.kmer_size)
    mem = louvain_edge_parallel(len(ss), g, partitions=3)
    clusters = {}
    for i, c in enumerate(mem.tolist()):
        clusters.setdefault(c, []).append(i)
    labels = clusters_to_labels(list(clusters.values()), len(ss))
    assert same_partition(labels, synthetic_genomes.labels)


def test_leiden_splits_weakly_linked():
    """True Leiden (refinement path) also splits two weakly-joined cliques."""
    from rabbittclust_tpu.cluster.leiden import leiden
    edges = []
    for block, off in ((0, 0), (1, 8)):
        for a in range(8):
            for b in range(a):
                edges.append((off + b, off + a, 1.0))
    edges.append((0, 8, 0.05))
    frm = np.array([e[0] for e in edges])
    to = np.array([e[1] for e in edges])
    w = np.array([e[2] for e in edges])
    mem = leiden(16, (frm, to, w))
    assert len(set(mem[:8].tolist())) == 1
    assert len(set(mem[8:].tolist())) == 1
    assert mem[0] != mem[8]


def test_leiden_deterministic_and_quality():
    """Leiden is reproducible and its modularity matches or beats Louvain on
    a planted-partition graph."""
    from rabbittclust_tpu.cluster.leiden import leiden, modularity
    rng = np.random.default_rng(7)
    n, k = 60, 4
    labels = np.repeat(np.arange(k), n // k)
    frm_l, to_l, w_l = [], [], []
    for a in range(n):
        for b in range(a):
            p = 0.6 if labels[a] == labels[b] else 0.02
            if rng.random() < p:
                frm_l.append(b)
                to_l.append(a)
                w_l.append(1.0)
    g = (np.array(frm_l), np.array(to_l), np.array(w_l, dtype=np.float64))
    m1 = leiden(n, g)
    m2 = leiden(n, g)
    assert np.array_equal(m1, m2)
    from rabbittclust_tpu.cluster.leiden import louvain as _louvain
    q_leiden = modularity(n, g, m1)
    q_louvain = modularity(n, g, _louvain(n, g))
    assert q_leiden >= q_louvain - 1e-9


def test_leiden_communities_internally_connected():
    """The Leiden guarantee Louvain lacks: every community induces a
    connected subgraph."""
    from rabbittclust_tpu.cluster.leiden import leiden
    from rabbittclust_tpu.cluster.union_find import UnionFind
    rng = np.random.default_rng(11)
    n = 80
    frm_l, to_l, w_l = [], [], []
    for a in range(n):
        for b in range(a):
            if rng.random() < 0.08:
                frm_l.append(b)
                to_l.append(a)
                w_l.append(float(rng.random()))
    g = (np.array(frm_l), np.array(to_l), np.array(w_l))
    mem = leiden(n, g)
    for c in set(mem.tolist()):
        nodes = np.flatnonzero(mem == c)
        if len(nodes) == 1:
            continue
        node_set = set(nodes.tolist())
        uf = UnionFind(n)
        for a, b in zip(g[0].tolist(), g[1].tolist()):
            if a in node_set and b in node_set:
                uf.merge(a, b)
        roots = {uf.find(int(x)) for x in nodes}
        assert len(roots) == 1, f"community {c} not internally connected"


def test_leiden_nmi_on_planted_communities():
    """External quality anchor for the own-implementation community
    detection (the reference delegates to igraph, leiden.cpp:337-400,
    which cannot be built here): on simulated ground-truth corpora with
    well-separated planted communities, both Leiden and Louvain must
    recover the planted partition at NMI >= 0.99."""
    import numpy as np
    from sklearn.metrics import normalized_mutual_info_score
    from rabbittclust_tpu.cluster.leiden import community_clusters

    rng = np.random.default_rng(5)
    n_comm, per = 10, 24
    hashes, truth = [], []
    for c in range(n_comm):
        base = np.unique(rng.integers(0, 2 ** 31, size=260).astype(
            np.uint32))
        for _ in range(per):
            keep = base[rng.random(len(base)) < 0.85]
            extra = np.unique(rng.integers(
                0, 2 ** 31, size=300 - len(keep)).astype(np.uint32))
            hashes.append(np.unique(np.concatenate([keep, extra])))
            truth.append(c)
    for use_leiden in (True, False):
        clusters = community_clusters(hashes, 0.05, 21,
                                      use_leiden=use_leiden)
        labels = np.empty(len(hashes), dtype=np.int64)
        for ci, mem in enumerate(clusters):
            labels[mem] = ci
        nmi = normalized_mutual_info_score(truth, labels)
        assert nmi >= 0.99, (use_leiden, nmi, len(clusters))
