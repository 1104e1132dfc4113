"""End-to-end multihost workflow: the --multihost CLI path with
process-sharded ingest from real FASTA files must produce a .cluster file
BYTE-IDENTICAL to the single-host run (VERDICT r2 item 2)."""

import importlib.util
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _single_host_cluster(list_file, out, module="mst", extra=(),
                         threads="2"):
    """Single-host reference run.  -t 2 selects the framework's
    deterministic (dist, id) tie order — the order the multihost engines
    implement; -t 1 instead replicates the reference's introsort tie order
    (a single-machine parity quirk, covered by the golden tests)."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    thr = (("--eps", "0.05") if module == "dbscan" else ("-d", "0.05"))
    r = subprocess.run(
        [sys.executable, "-m", f"rabbittclust_tpu.cli.clust_{module}",
         "--fast", "-l", "-i", list_file, "-o", out, *thr,
         "-m", "1000", "-e", "-t", threads, *extra],
        capture_output=True, text=True, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    return open(out).read()


def _launcher():
    spec = importlib.util.spec_from_file_location(
        "launch_multihost", os.path.join(REPO, "scripts",
                                         "launch_multihost.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jittered_genomes(tmp_path_factory):
    """Length-jittered corpus -> distinct distances -> unique MST / unique
    Louvain gains, so byte-equality is well-defined.  (On exact-tie corpora
    the multihost merged Kruskal / allgathered edge order cannot replicate
    the single-host -t 1 reference introsort order; partitions still match
    — asserted separately below.)"""
    import sys as _sys
    _sys.path.insert(0, os.path.join(REPO, "tests"))
    from helpers import make_clustered_genomes
    tmp = str(tmp_path_factory.mktemp("jit_genomes"))
    return make_clustered_genomes(tmp, length_jitter=3000, seed=11)


@pytest.mark.parametrize("module,nproc", [("mst", 2), ("greedy", 2),
                                          ("leiden", 3), ("dbscan", 2)])
def test_multihost_cli_byte_equal_single_host(tmp_path, jittered_genomes,
                                              module, nproc):
    single = str(tmp_path / f"single_{module}.cluster")
    multi = str(tmp_path / f"multi_{module}.cluster")
    extra = ("--knn", "0") if module == "leiden" else \
        ("--minpts", "3") if module == "dbscan" else ()
    want = _single_host_cluster(jittered_genomes.list_file, single,
                                module, extra)
    lm = _launcher()
    thr = (("--eps", "0.05") if module == "dbscan" else ("-d", "0.05"))
    rc = lm.launch(
        nproc, ["--fast", "-l", "-i", jittered_genomes.list_file,
                "-o", multi, *thr, "-m", "1000", "-t", "1",
                *extra],
        module=module, virtual_cpu_devices=2, timeout=600.0)
    assert rc == 0
    got = open(multi).read()
    assert got == want, f"{module}: multihost .cluster != single-host"


def test_multihost_repdb_query_assign_byte_equal(tmp_path,
                                                 jittered_genomes):
    """--db --query/--assign --multihost: sharded query sketching + probe
    must write TSVs byte-identical to the single-host verbs."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    db = str(tmp_path / "rep.db")
    lf = jittered_genomes.list_file
    r = subprocess.run(
        [sys.executable, "-m", "rabbittclust_tpu.cli.clust_greedy",
         "--fast", "-l", "-i", lf, "-o", str(tmp_path / "b.cluster"),
         "-d", "0.05", "-m", "1000", "-t", "2", "--db", db, "--build"],
        capture_output=True, text=True, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    lm = _launcher()
    for verb, flag in (("query", ("--query", "--top-k", "3")),
                       ("assign", ("--assign",))):
        single = str(tmp_path / f"single_{verb}.tsv")
        multi = str(tmp_path / f"multi_{verb}.tsv")
        r = subprocess.run(
            [sys.executable, "-m", "rabbittclust_tpu.cli.clust_greedy",
             "--fast", "-l", "-i", lf, "-o", single, "-m", "1000",
             "-t", "2", "--db", db, *flag],
            capture_output=True, text=True, env=env, cwd=REPO)
        assert r.returncode == 0, r.stderr[-3000:]
        rc = lm.launch(2, ["--fast", "-l", "-i", lf, "-o", multi,
                           "-m", "1000", "-t", "1", "--db", db, *flag],
                       module="greedy", virtual_cpu_devices=2,
                       timeout=600.0)
        assert rc == 0
        assert open(multi).read() == open(single).read(), \
            f"repdb {verb}: multihost TSV != single-host"


def _parse_partition(text):
    out = []
    for block in text.split("the cluster ")[1:]:
        ids = [int(line.split("\t")[2]) for line in block.splitlines()[1:]
               if "\t" in line]
        out.append(tuple(sorted(ids)))
    return sorted(out)


def test_multihost_mst_tie_corpus(tmp_path, synthetic_genomes):
    """Equal-length genomes -> massed distance ties.  Byte-equality holds
    vs the deterministic -t 2 order; vs the -t 1 reference-introsort order
    only the PARTITION is guaranteed (within-cluster BFS order may
    differ)."""
    single = str(tmp_path / "single.cluster")
    multi = str(tmp_path / "multi.cluster")
    want = _single_host_cluster(synthetic_genomes.list_file, single)
    lm = _launcher()
    rc = lm.launch(2, ["--fast", "-l", "-i", synthetic_genomes.list_file,
                       "-o", multi, "-d", "0.05", "-m", "1000", "-t", "1"],
                   module="mst", virtual_cpu_devices=2, timeout=600.0)
    assert rc == 0
    got = open(multi).read()
    assert got == want  # deterministic tie order: byte-equal
    t1 = _single_host_cluster(synthetic_genomes.list_file,
                              str(tmp_path / "t1.cluster"), threads="1")
    assert _parse_partition(got) == _parse_partition(t1)


@pytest.mark.parametrize("cards,nproc,want", [
    (["0", "1", "2", "3"], 4, ["0", "1", "2", "3"]),
    (["0", "1", "2", "3"], 2, ["0,1", "2,3"]),
    (["4", "5", "6"], 1, ["4,5,6"]),
    (["0", "1"], 4, None),
])
def test_launcher_one_process_per_card(cards, nproc, want):
    """Real-device launches give every process its own cards and refuse
    more processes than there are cards."""
    lm = _launcher()
    if want is None:
        with pytest.raises(ValueError):
            lm.card_sets(cards, nproc)
    else:
        assert lm.card_sets(cards, nproc) == want
