"""Scale golden test: 400 genomes BYTE-identical vs the reference binaries.

The small golden corpus (12 genomes) can miss behaviors that only appear
with real cluster structure at hundreds of genomes: sketch-size ties in
the greedy sort (the reference uses an UNSTABLE std::sort with a
size-only comparator, greedy.cpp:594-597 — tie order is libstdc++
introsort order, which only differs from id order at n > 16), exact
float64 distance-tie resolution in the MST edge sort (unstable
dist-only cmpEdge + the subSize=8 block reduce cadence, MST.cpp:388-786),
and the candidate-filter boundary.

We replicate the reference's "implementation-defined" tie behavior
bit-for-bit by calling the real libstdc++ std::sort with the reference's
comparators on the reference's input sequences (native
rtc_stdsort_size_desc + the parity reduce cadence in mst_engine), so
these tests demand FULL byte equality — even on the tie-pressure corpus
whose 25 kb equal-length genomes at drlevel=3 yield ~6-hash sketches and
mass d=0.0 ties.  Both tools run with -t 1: the reference's tie behavior
is only deterministic single-threaded (its multithreaded IDs are
completion-order nondeterministic, see CLAUDE.md).

Marked slow: builds the reference oracles and runs both tools end to end
on 400 x ~25 kb genomes.
"""

import os
import subprocess

import pytest

from tests.test_golden_reference import (  # reuse oracle build + runners
    BUILD_SCRIPT,
    ORACLE_DIR,
    run_ours,
    run_ref,
    same_bytes,
)


@pytest.fixture(scope="module")
def oracle():
    tools = {
        "mst": os.path.join(ORACLE_DIR, "clust-mst"),
        "greedy": os.path.join(ORACLE_DIR, "clust-greedy"),
    }
    if not all(os.path.exists(p) for p in tools.values()):
        if not os.path.exists("/root/reference/src/main.cpp"):
            pytest.skip("reference sources unavailable")
        r = subprocess.run(["bash", BUILD_SCRIPT], capture_output=True,
                           text=True)
        if r.returncode != 0:
            pytest.skip(f"oracle build failed: {r.stderr[-500:]}")
    return tools


@pytest.fixture(scope="module")
def varied_genomes(tmp_path_factory):
    """20 clusters x 20 genomes, lengths 20-25 kb (varied sketch sizes —
    the realistic regime; distances mostly unique, a few exact ties)."""
    from tests.helpers import make_clustered_genomes
    tmp = tmp_path_factory.mktemp("golden_scale_varied")
    return make_clustered_genomes(tmp, n_clusters=20, per_cluster=20,
                                  length=25000, mutation=0.012, seed=99,
                                  length_jitter=5000)


@pytest.fixture(scope="module")
def tie_genomes(tmp_path_factory):
    """20 clusters x 20 genomes of identical 25 kb length: maximal tie
    pressure (equal sketch sizes everywhere; at default drlevel=3 the
    ~6-hash sketches give mass exact-d ties including d=0.0)."""
    from tests.helpers import make_clustered_genomes
    tmp = tmp_path_factory.mktemp("golden_scale_tie")
    return make_clustered_genomes(tmp, n_clusters=20, per_cluster=20,
                                  length=25000, mutation=0.012, seed=99)


def _run_folder(d):
    runs = [x for x in os.listdir(d) if x.startswith("20")]
    assert len(runs) == 1, runs
    return os.path.join(d, runs[0])


def _mst_pair(oracle, fx, tmp_path, extra):
    ref_d = tmp_path / "ref"
    our_d = tmp_path / "our"
    ref_d.mkdir()
    our_d.mkdir()
    args = ["--fast", "-l", "-i", fx.list_file, "-d", "0.05", *extra]
    # run_ref appends -t 1 itself; ours needs it explicitly (parity mode)
    run_ref(oracle, "mst", [*args, "-o", "r.cluster"], str(ref_d))
    run_ours("clust_mst", [*args, "-t", "1", "-o", "o.cluster"], str(our_d))
    assert same_bytes(str(ref_d / "r.cluster"), str(our_d / "o.cluster"))
    rf, of = _run_folder(ref_d), _run_folder(our_d)
    for f in ("kssd.hash.sketch", "kssd.info.sketch", "edge.mst"):
        assert same_bytes(os.path.join(rf, f), os.path.join(of, f)), f


def _greedy_pair(oracle, fx, tmp_path, extra):
    ref_d = tmp_path / "ref"
    our_d = tmp_path / "our"
    ref_d.mkdir()
    our_d.mkdir()
    args = ["--fast", "-l", "-i", fx.list_file, "-d", "0.05", *extra]
    run_ref(oracle, "greedy", [*args, "-o", "r.cluster"], str(ref_d))
    run_ours("clust_greedy", [*args, "-t", "1", "-o", "o.cluster"],
             str(our_d))
    assert same_bytes(str(ref_d / "r.cluster"), str(our_d / "o.cluster"))


@pytest.mark.slow
def test_scale_mst_varied_byte_identical(oracle, varied_genomes, tmp_path):
    _mst_pair(oracle, varied_genomes, tmp_path, ["--drlevel", "2"])


@pytest.mark.slow
def test_scale_greedy_varied_byte_identical(oracle, varied_genomes,
                                            tmp_path):
    _greedy_pair(oracle, varied_genomes, tmp_path, ["--drlevel", "2"])


@pytest.mark.slow
def test_scale_mst_tie_pressure_byte_identical(oracle, tie_genomes,
                                               tmp_path):
    """Equal-length corpus at drlevel=2: dense exact-weight tie collisions
    across different pairs — byte equality proves the introsort-order
    replication, not just tie-free agreement."""
    _mst_pair(oracle, tie_genomes, tmp_path, ["--drlevel", "2"])


@pytest.mark.slow
def test_scale_mst_degenerate_ties_byte_identical(oracle, tie_genomes,
                                                  tmp_path):
    """drlevel=3 on 25 kb gives ~6-hash sketches: mass d=0.0 ties (many
    identical sketches) — the harshest tie regime."""
    _mst_pair(oracle, tie_genomes, tmp_path, [])


@pytest.mark.slow
def test_scale_greedy_tie_pressure_byte_identical(oracle, tie_genomes,
                                                  tmp_path):
    """Equal lengths -> equal sketch sizes everywhere: the greedy
    size-sort is ALL ties; byte equality requires the libstdc++
    introsort permutation (id-order ties fail this at n=400)."""
    _greedy_pair(oracle, tie_genomes, tmp_path, ["--drlevel", "2"])


@pytest.mark.slow
def test_scale_device_engine_partition_matches_host(varied_genomes):
    """The bitmap device path (CPU backend here; chip_smoke.py runs its
    twins on the card) must give the reference partition at 400 genomes."""
    from rabbittclust_tpu.cluster.mst import (
        clusters_from_forest, compute_mst, cut_forest)
    from rabbittclust_tpu.ops.cluster_fast import threshold_clusters_device
    from rabbittclust_tpu.sketch.kssd import sketch_files_kssd

    ss, p = sketch_files_kssd(varied_genomes.files, min_len=10000,
                              kmer_size=21, drlevel=2)
    cd = threshold_clusters_device(ss.hashes, 0.05, p.kmer_size,
                                   row_block=256)
    res = compute_mst(ss.hashes, 0.05, p.kmer_size)
    ch = clusters_from_forest(cut_forest(res.mst, 0.05), len(ss))
    assert sorted(map(sorted, cd)) == sorted(map(sorted, ch))


def _device_fast_pair(oracle, fx, tmp_path, monkeypatch, extra):
    """clust-mst --device -e -t 1 (the DEFAULT MST-free device clusters
    path since round 5) vs the reference: byte-identical .cluster, always.
    With an explicit -k 21 no hash crosses clusters on these corpora, so
    the certified intra-cluster cadence replay (rtc_intra_mst) supplies
    the order; with the tuned k cross-cluster sharing exists and the path
    falls back to the full serial parity engine — both arms are byte
    targets.  In-process (conftest pins the CPU backend); the reference
    cannot run -e from fresh genomes (replicated quirk), so its full
    run's .cluster is the byte target."""
    from rabbittclust_tpu.cli.clust_mst import main as mst_main
    ref_d = tmp_path / "ref"
    ref_d.mkdir()
    args = ["--fast", "-l", "-i", fx.list_file, "-d", "0.05", *extra]
    run_ref(oracle, "mst", [*args, "-o", "r.cluster"], str(ref_d))
    monkeypatch.setenv("RTC_CLUSTER_BITS", "2048")
    monkeypatch.setenv("RTC_CLUSTER_RB", "256")
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "o.cluster")
    mst_main([*args, "-e", "--device", "-t", "1", "-o", out])
    assert same_bytes(str(ref_d / "r.cluster"), out)


@pytest.mark.slow
def test_scale_mst_device_fast_varied_byte_identical(oracle, varied_genomes,
                                                     tmp_path, monkeypatch):
    """Tuned k: cross-cluster kmer sharing -> full-engine fallback arm."""
    _device_fast_pair(oracle, varied_genomes, tmp_path, monkeypatch,
                      ["--drlevel", "2"])


@pytest.mark.slow
def test_scale_mst_device_fast_certified_byte_identical(oracle,
                                                        varied_genomes,
                                                        tmp_path,
                                                        monkeypatch):
    """Explicit -k 21: no cross-cluster sharing -> the certified intra
    replay arm supplies the reference order without the full engine."""
    _device_fast_pair(oracle, varied_genomes, tmp_path, monkeypatch,
                      ["--drlevel", "2", "-k", "21"])


@pytest.mark.slow
def test_scale_mst_device_fast_tie_pressure_byte_identical(oracle,
                                                           tie_genomes,
                                                           tmp_path,
                                                           monkeypatch):
    """Equal-length corpus at drlevel=2: the replay must reproduce the
    unstable-sort tie permutations, not just tie-free agreement."""
    _device_fast_pair(oracle, tie_genomes, tmp_path, monkeypatch,
                      ["--drlevel", "2", "-k", "21"])
