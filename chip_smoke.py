#!/usr/bin/env python
"""Smoke test of the ``--device`` clustering paths on NVIDIA GPUs.

Drives every device path once, through the entry points a user calls, at
sizes users run, and compares each result exactly (all device outputs are
integers: counts, masks, partitions) with the host engine or the planted
truth:

  a. FASTA ingest     clust-mst --fast -l --device -e -t 1 on 256 genomes of
                      200 kb == the same command without --device, byte for
                      byte
  b. labelprop        clust-mst --fast --presketched --device -e -t 4 on
                      262,144 sketches of ~1,000 hashes (two mask panels) ==
                      the 64 planted clusters
  c. labelprop -t 1   32,768 sketches == the host engine's .cluster, bytes
  d. dense MST        clust-mst --fast --presketched --device (MST saved) on
                      16,384 sketches: edge.mst and .cluster == host
  e. device greedy    clust-greedy --fast --presketched --device on 65,536
                      mostly-singleton sketches == native greedy, bytes
  f. filter bound     candidate_pairs_threshold at 8,192 sketches and 8,192
                      bits misses no pair of the exact native pair counts;
                      the bf16 filter product equals integer counts
  g. device sketcher  device_kmer_hashes over 32 Mbases == the NumPy
                      sketcher, bit for bit

With ``--gpus 4`` only the four-card mesh paths run, each beside what it is
compared with: the exact mesh ring (clust-mst --presketched --device, MST
saved) at 65,536 sketches == the host engine, and mesh labelprop at 262,144
sketches == one-card labelprop.

Usage:  python chip_smoke.py [--seed 7]
        python chip_smoke.py --gpus 4

All data is generated from ``--seed``.  Each phase function also takes
its sizes (and ``s``, the hashes per sketch) as arguments, so the CPU
tests and rehearsals run the same code at small sizes.  Everything runs in
this one process, so no second process opens a card.  Earlier lines report the
cards' name and power limit, versions, the native library, each phase's
wall and compile time and peak device memory; the last line is one JSON
object ``{"ok": true, "device": {...}}``.  The script exits non-zero
without that line when JAX finds no GPU, the native library did not load,
or any comparison fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

THRESHOLD = 0.05
KMER = 21
DRLEVEL = 3
SKETCH = 1000       # hashes per sketch (genomes of ~4 Mb at drlevel 3)
PLANTED = 64        # planted clusters of the presketched corpora

FULL = {
    "a": dict(clusters=32, per_cluster=8, length=200_000),
    "b": dict(n=262_144),
    "c": dict(n=32_768),
    "d": dict(n=16_384),
    "e": dict(n=65_536),
    "f": dict(n=8192, bits=8192),
    "g": dict(bases=32_000_000),
}
MESH = {
    "mesh_mst": dict(n=65_536),
    "mesh_lp": dict(n=262_144),
}


class Mismatch(RuntimeError):
    """A device result differs from what it is compared with."""


def check(cond, msg: str) -> None:
    if not cond:
        raise Mismatch(msg)


# ---------------------------------------------------------------------------
# data, generated from the seed
# ---------------------------------------------------------------------------

def planted_sketches(n: int, seed: int, n_clusters: int = PLANTED,
                     s: int = SKETCH, keep: float = 0.8):
    """Sorted uint32 sketches of ~``s`` hashes; genome i belongs to planted
    cluster i % n_clusters.  Each hash slot holds the cluster's base hash
    with probability ``keep``, else a fresh random one (bench.make_sketches'
    model, vectorized).  Hashes stay below 2^31, inside the 32-bit KSSD hash
    domain of k=21, drlevel 3.  Members of a cluster lie at Mash distance
    ~0.02, other pairs share almost nothing."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2 ** 31, size=(n_clusters, s), dtype=np.uint32)
    out = []
    for lo in range(0, n, 16384):
        hi = min(n, lo + 16384)
        vals = base[np.arange(lo, hi) % n_clusters]
        fresh = rng.random(vals.shape) >= keep
        vals[fresh] = rng.integers(0, 2 ** 31, size=int(fresh.sum()),
                                   dtype=np.uint32)
        vals.sort(axis=1)
        uniq = np.ones(vals.shape, dtype=bool)
        uniq[:, 1:] = vals[:, 1:] != vals[:, :-1]
        out.extend(row[u] for row, u in zip(vals, uniq))
    return out


def write_presketched(folder: str, hashes) -> None:
    """A --presketched folder in the reference's KSSD format."""
    from rabbittclust_tpu.sketch.base import SketchSet
    from rabbittclust_tpu.sketch.kssd import KssdParams
    from rabbittclust_tpu.state.sketch_io import save_kssd_sketches

    p = KssdParams.from_kmer_size(KMER, DRLEVEL)
    ss = SketchSet("kssd", p, True, p.use64)
    for i, h in enumerate(hashes):
        ss.append_genome(file_name=f"genome{i}.fna", name=f"genome{i}",
                         comment="planted", seq0_len=len(h) << 12,
                         total_len=len(h) << 12, num_seqs=1, hashes=h)
    save_kssd_sketches(ss, p, folder)


def random_bases(rng, n: int) -> np.ndarray:
    return np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, n)]


def write_genomes(folder: str, clusters: int, per_cluster: int, length: int,
                  seed: int, mutation: float = 0.01) -> str:
    """simulate-longSequence corpus: ``clusters`` random seed genomes, each
    with ``per_cluster`` copies mutated at ``mutation``; returns the -l list
    file."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    files = []
    for c in range(clusters):
        base = random_bases(rng, length)
        for m in range(per_cluster):
            seq = base.copy()
            hit = rng.random(length) < mutation
            seq[hit] = acgt[rng.integers(0, 4, int(hit.sum()))]
            raw = seq.tobytes()
            path = os.path.join(folder, f"sim{c}_{m}.fna")
            with open(path, "wb") as f:
                f.write(f">sim{c}_{m} cluster{c}\n".encode())
                f.write(b"\n".join(raw[k:k + 80]
                                   for k in range(0, length, 80)) + b"\n")
            files.append(path)
    lst = os.path.join(folder, "genomes.list")
    with open(lst, "w") as f:
        f.write("\n".join(files) + "\n")
    return lst


def read_clusters(path: str):
    """Member ids of each cluster of a .cluster file."""
    clusters, cur = [], None
    with open(path) as f:
        for line in f:
            if line.startswith("the cluster"):
                cur = []
                clusters.append(cur)
            elif line.startswith("\t") and cur is not None:
                cur.append(int(line.split("\t")[2]))
    return clusters


def canonical(clusters):
    return sorted(tuple(sorted(c)) for c in clusters)


def run_cli(module: str, argv) -> None:
    """One in-process CLI run (the console entry's own main)."""
    import importlib
    mod = importlib.import_module(f"rabbittclust_tpu.cli.clust_{module}")
    try:
        rc = mod.main(list(argv))
    except SystemExit as e:
        rc = e.code
    check(rc in (0, None), f"clust-{module} {' '.join(argv)} exited {rc}")


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def same_mst(dir_a: str, dir_b: str, hashes) -> str:
    """The edge.mst files of two runs describe the same minimum spanning
    forest.  Equal bytes settle it.  Otherwise the two engines broke
    distance ties (or rounded a distance in its last bit) differently, and
    the forests must still have equal edge counts, equal connectivity and
    equal multisets of edge distances recomputed by one function from
    exact integer counts — which makes every single-linkage cut equal."""
    from rabbittclust_tpu.cluster.union_find import UnionFind
    from rabbittclust_tpu.distance.mash import mash_distance
    from rabbittclust_tpu.ops.bitmap import CsrSketches
    from rabbittclust_tpu.sketch.kssd import KssdParams
    from rabbittclust_tpu.state.sketch_io import load_mst

    fa, fb = (os.path.join(d, "edge.mst") for d in (dir_a, dir_b))
    if same_bytes(fa, fb):
        return "bytes"
    k = KssdParams.from_kmer_size(KMER, DRLEVEL).kmer_size
    csr = CsrSketches(hashes)
    sizes = np.array([len(h) for h in hashes], dtype=np.int64)
    dists, comps = [], []
    for path in (fa, fb):
        ii, jj, _ = load_mst(os.path.dirname(path))
        common = csr.count_common(ii, jj).astype(np.int64)
        dists.append(np.sort(mash_distance(common, sizes[ii], sizes[jj], k)))
        uf = UnionFind(len(hashes))
        for a, b in zip(ii.tolist(), jj.tolist()):
            uf.merge(a, b)
        comps.append(min_member_labels(uf.roots_array()))
    check(len(dists[0]) == len(dists[1]), "edge.mst edge counts differ")
    check(np.array_equal(comps[0], comps[1]), "edge.mst connectivity differs")
    check(np.array_equal(dists[0], dists[1]),
          "edge.mst distance multisets differ")
    return "equivalent"


def min_member_labels(roots: np.ndarray) -> np.ndarray:
    """Each element's label: the smallest index in its component, so two
    partitions are equal iff their label arrays are."""
    lab = np.full(len(roots), len(roots), dtype=np.int64)
    np.minimum.at(lab, roots, np.arange(len(roots)))
    return lab[roots]


def check_planted(clusters, n: int, n_clusters: int = PLANTED) -> None:
    check(len(clusters) == n_clusters,
          f"{len(clusters)} clusters, {n_clusters} planted")
    want = [tuple(range(c, n, n_clusters)) for c in range(n_clusters)]
    check(canonical(clusters) == sorted(want),
          "partition differs from the planted clusters")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_a(work: str, seed: int, clusters: int, per_cluster: int,
            length: int) -> dict:
    lst = write_genomes(work, clusters, per_cluster, length, seed)
    dev, host = (os.path.join(work, f"{t}.cluster") for t in ("dev", "host"))
    common = ["--fast", "-l", "-i", lst, "-e", "-t", "1",
              "-d", str(THRESHOLD)]
    run_cli("mst", common + ["--device", "-o", dev])
    run_cli("mst", common + ["-o", host])
    check(same_bytes(dev, host), "device .cluster != host .cluster")
    got = read_clusters(dev)
    check(len(got) == clusters, f"{len(got)} clusters, {clusters} simulated")
    return {"genomes": clusters * per_cluster, "clusters": len(got)}


def _lp_stats() -> dict:
    from rabbittclust_tpu.ops.labelprop import LP_STATS
    return {k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in LP_STATS.items()}


def phase_b(work: str, seed: int, n: int, s: int = SKETCH) -> dict:
    folder = os.path.join(work, "sketches")
    write_presketched(folder, planted_sketches(n, seed, s=s))
    out = os.path.join(work, "dev.cluster")
    run_cli("mst", ["--fast", "--presketched", folder, "--device", "-e",
                    "-t", "4", "-d", str(THRESHOLD), "-o", out])
    check_planted(read_clusters(out), n)
    return {"n": n, "clusters": PLANTED, "labelprop": _lp_stats()}


def phase_c(work: str, seed: int, n: int, s: int = SKETCH) -> dict:
    folder = os.path.join(work, "sketches")
    write_presketched(folder, planted_sketches(n, seed + 1, s=s))
    dev, host = (os.path.join(work, f"{t}.cluster") for t in ("dev", "host"))
    common = ["--fast", "--presketched", folder, "-e", "-t", "1",
              "-d", str(THRESHOLD)]
    run_cli("mst", common + ["--device", "-o", dev])
    run_cli("mst", common + ["-o", host])
    check(same_bytes(dev, host), "device .cluster != host .cluster")
    check_planted(read_clusters(dev), n)
    return {"n": n, "clusters": PLANTED}


def phase_d(work: str, seed: int, n: int, s: int = SKETCH) -> dict:
    import jax
    from rabbittclust_tpu.ops.intersect import pick_pair_kernel
    from rabbittclust_tpu.ops.pack import pack_sketches

    hashes = planted_sketches(n, seed + 2, s=s)
    dev_dir, host_dir = (os.path.join(work, t) for t in ("dev", "host"))
    write_presketched(dev_dir, hashes)
    shutil.copytree(dev_dir, host_dir)
    k = pack_sketches(hashes[:4096], False, pad_n_to=4096).k
    kernel = pick_pair_kernel(jax.default_backend(), 4096, 4096, k)
    dev, host = (os.path.join(work, f"{t}.cluster") for t in ("dev", "host"))
    run_cli("mst", ["--fast", "--presketched", dev_dir, "--device",
                    "-d", str(THRESHOLD), "-o", dev])
    run_cli("mst", ["--fast", "--presketched", host_dir,
                    "-d", str(THRESHOLD), "-o", host])
    mst = same_mst(dev_dir, host_dir, hashes)
    check(same_bytes(dev, host), "device .cluster != host .cluster")
    check_planted(read_clusters(dev), n)
    return {"n": n, "pair_kernel": kernel, "edge_mst": mst}


def sparse_sketches(n: int, seed: int, s: int = SKETCH):
    """Mostly singletons: 7/8 as many planted clusters as genomes, so one
    genome in four has a partner and the rest stand alone."""
    return planted_sketches(n, seed, n_clusters=max(1, n * 7 // 8), s=s)


def phase_e(work: str, seed: int, n: int, s: int = SKETCH,
            probe: bool = True) -> dict:
    """``probe`` checks that the CLI's density probe sends this corpus to
    the device sweep (the probe calls every corpus under 16,384 genomes
    dense, so small rehearsals force the route instead)."""
    from rabbittclust_tpu.workflows import _greedy_corpus_is_dense
    from rabbittclust_tpu.sketch.base import stdsort_size_desc

    hashes = sparse_sketches(n, seed + 3, s)
    if probe:
        order = stdsort_size_desc(np.array([len(h) for h in hashes]))
        check(not _greedy_corpus_is_dense([hashes[i] for i in order],
                                          THRESHOLD, KMER),
              "the density probe routed the corpus to the host")
    folder = os.path.join(work, "sketches")
    write_presketched(folder, hashes)
    dev, host = (os.path.join(work, f"{t}.cluster") for t in ("dev", "host"))
    common = ["--fast", "--presketched", folder, "-d", str(THRESHOLD)]
    run_cli("greedy", common + ["--device", "-o", dev])
    run_cli("greedy", common + ["-o", host])
    check(same_bytes(dev, host), "device greedy .cluster != native greedy")
    return {"n": n, "clusters": len(read_clusters(dev))}


def phase_f(work: str, seed: int, n: int, bits: int,
            s: int = SKETCH) -> dict:
    import jax
    import jax.numpy as jnp
    from rabbittclust_tpu.cluster.mst import native_pair_counts
    from rabbittclust_tpu.distance.mash import mash_distance, size_ratio_limit
    from rabbittclust_tpu.ops import bitmap as bm

    hashes = planted_sketches(n, seed + 4, s=s)
    ii, jj, common = bm.candidate_pairs_threshold(
        hashes, THRESHOLD, KMER, bits=bits, row_block=8192)
    nat = native_pair_counts(hashes)
    check(nat is not None, "native pair counts unavailable")
    ti, tj, tc = nat
    sizes = np.array([len(h) for h in hashes], dtype=np.int64)
    mn = np.minimum(sizes[ti], sizes[tj])
    mx = np.maximum(sizes[ti], sizes[tj])
    radio = size_ratio_limit(THRESHOLD, KMER - 1)
    d = mash_distance(tc, sizes[ti], sizes[tj], KMER)
    true = (mx <= radio * mn) & (d <= THRESHOLD)
    akey = np.maximum(ti, tj) * n + np.minimum(ti, tj)
    gkey = ii * n + jj
    missing = int((~np.isin(akey[true], gkey)).sum())
    check(missing == 0, f"filter dropped {missing} true pairs")
    # every candidate's exact count agrees with the native engine
    order = np.argsort(akey)
    pos = np.minimum(np.searchsorted(akey[order], gkey), len(akey) - 1)
    check(np.array_equal(akey[order][pos], gkey)
          and np.array_equal(tc[order][pos], common),
          "candidate exact counts differ from native pair counts")
    # the filter's bf16 x bf16 -> f32 product is exact on 0/1 signatures
    xp, _ = bm.pack_bitmaps_packed(hashes[:2048], bits=bits, pad_n_to=2048)
    xd = bm._unpack_bits_device(jnp.asarray(xp))
    shared = np.asarray(jax.lax.dot_general(
        xd, xd, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32))
    xb = np.unpackbits(xp, axis=1, bitorder="little").astype(np.float32)
    check(np.array_equal(shared, xb @ xb.T),
          "bf16 shared-bit counts differ from integer counts")
    return {"n": n, "bits": bits, "true_pairs": int(true.sum()),
            "candidates": int(len(ii))}


def phase_g(work: str, seed: int, bases: int) -> dict:
    from rabbittclust_tpu.ops.sketch_device import device_kmer_hashes
    from rabbittclust_tpu.sketch.kssd import (
        KssdParams, get_shuffle_table, kssd_kmer_hashes_numpy)

    rng = np.random.default_rng(seed + 5)
    seq = random_bases(rng, bases)
    seq[rng.random(bases) < 1e-3] = ord("N")
    seq = seq.tobytes()
    p = KssdParams.from_kmer_size(KMER, DRLEVEL)
    want = np.unique(kssd_kmer_hashes_numpy(
        seq, p, get_shuffle_table(p.half_subk)))
    got = np.unique(device_kmer_hashes(seq, p))
    check(np.array_equal(want, got), "device sketch != NumPy sketch")
    return {"bases": bases, "hashes": int(len(got))}


def phase_mesh_mst(work: str, seed: int, n: int, s: int = SKETCH) -> dict:
    import jax
    check(len(jax.devices()) > 1, "the mesh ring needs more than one device")
    hashes = planted_sketches(n, seed + 6, s=s)
    dev_dir, host_dir = (os.path.join(work, t) for t in ("dev", "host"))
    write_presketched(dev_dir, hashes)
    shutil.copytree(dev_dir, host_dir)
    dev, host = (os.path.join(work, f"{t}.cluster") for t in ("dev", "host"))
    run_cli("mst", ["--fast", "--presketched", dev_dir, "--device",
                    "-d", str(THRESHOLD), "-o", dev])
    run_cli("mst", ["--fast", "--presketched", host_dir,
                    "-d", str(THRESHOLD), "-o", host])
    mst = same_mst(dev_dir, host_dir, hashes)
    check(same_bytes(dev, host), "mesh ring .cluster != host .cluster")
    check_planted(read_clusters(dev), n)
    return {"n": n, "devices": len(jax.devices()), "edge_mst": mst}


def phase_mesh_lp(work: str, seed: int, n: int, s: int = SKETCH) -> dict:
    from rabbittclust_tpu.ops.labelprop import threshold_clusters_device_lp
    from rabbittclust_tpu.parallel.dist_engine import (
        distributed_threshold_clusters_lp, make_mesh)

    hashes = planted_sketches(n, seed + 7, s=s)
    mesh = make_mesh()
    t0 = time.perf_counter()
    got = distributed_threshold_clusters_lp(hashes, THRESHOLD, KMER,
                                            mesh=mesh)
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = threshold_clusters_device_lp(hashes, THRESHOLD, KMER)
    t_one = time.perf_counter() - t0
    check(canonical(got) == canonical(one),
          "mesh labelprop partition != one-card labelprop")
    check_planted(got, n)
    return {"n": n, "devices": int(mesh.devices.size),
            "mesh_s": round(t_mesh, 3), "one_card_s": round(t_one, 3)}


PHASES = {
    "a": ("FASTA ingest, clust-mst -l --device -e -t 1", phase_a),
    "b": ("labelprop multi-panel, clust-mst --presketched --device -e -t 4",
          phase_b),
    "c": ("labelprop vs host, -t 1", phase_c),
    "d": ("dense MST engine, MST saved", phase_d),
    "e": ("device greedy, sparse corpus", phase_e),
    "f": ("filter bound", phase_f),
    "g": ("device sketcher", phase_g),
    "mesh_mst": ("mesh exact ring vs host, MST saved", phase_mesh_mst),
    "mesh_lp": ("mesh labelprop vs one-card labelprop", phase_mesh_lp),
}


# ---------------------------------------------------------------------------
# measurements that set the candidate-pull priors (ops/bitmap.py)
# ---------------------------------------------------------------------------

def pull_priors() -> dict:
    """Device->host rate of one 8 MB packed-mask pull and the jnp.nonzero
    cost per pair of one 8192^2 tile — the readings behind bitmap._BW_EST
    and bitmap._COMPACT_S_PER_PAIR."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    x = jax.device_put(rng.integers(0, 256, 8 << 20, dtype=np.uint8))
    pulls = []
    for i in range(7):
        y = (x + jnp.uint8(i)).block_until_ready()
        t0 = time.perf_counter()
        np.asarray(y)
        pulls.append(time.perf_counter() - t0)
    rb = 8192
    mask = jax.device_put(rng.random((rb, rb), dtype=np.float32) < 1e-5)
    nz = jax.jit(lambda m: jnp.nonzero(m.reshape(-1), size=1 << 16,
                                       fill_value=-1)[0])
    nz(mask).block_until_ready()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        nz(mask).block_until_ready()
        runs.append(time.perf_counter() - t0)
    return {"pull_8mb_bytes_per_s": (8 << 20) / float(np.median(pulls[2:])),
            "nonzero_s_per_pair": float(np.median(runs)) / (rb * rb)}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling (its own
    monitoring events)."""

    def __init__(self):
        import jax
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event: str, duration: float, **_):
        if event.startswith("/jax/core/compile/"):
            self.total += duration


def card_lines():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True)
    return r.stdout.strip().splitlines() or [f"nvidia-smi: {r.stderr.strip()}"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--gpus", type=int, choices=(1, 4), default=1,
                    help="4 runs the four-card mesh phases only")
    args = ap.parse_args(argv)
    if args.gpus == 1:
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")

    import jax
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    if len(devices) != args.gpus:
        print(f"chip_smoke: --gpus {args.gpus} but JAX sees {len(devices)} "
              f"devices", file=sys.stderr)
        return 2
    try:
        import jaxlib
        from rabbittclust_tpu.utils import native
        from rabbittclust_tpu.utils.jaxcfg import configure_jax
    except ImportError as e:
        print(f"chip_smoke: {e}; run it from the repository's root",
              file=sys.stderr)
        return 2

    for line in card_lines():
        print(f"card: {line}")
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
          f"{len(devices)} x {dev.device_kind}")
    lib = native.load_native()
    print(f"native library loaded: {lib is not None} "
          f"({native.library_path()}, g++ {' '.join(native.BUILD_FLAGS)})")
    if lib is None:
        return 3
    configure_jax()
    clock = CompileClock()

    if args.gpus == 1:
        from rabbittclust_tpu.ops import bitmap as bm
        pri = pull_priors()
        print(f"pull priors measured: {json.dumps(pri)}; in use: "
              f"_BW_EST {bm._BW_EST['bps']:.4g} B/s, "
              f"_COMPACT_S_PER_PAIR {bm._COMPACT_S_PER_PAIR:.4g} s")
    plan = MESH if args.gpus == 4 else FULL
    failed = []
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        for key, size in plan.items():
            title, fn = PHASES[key]
            work = os.path.join(root, key)
            os.makedirs(work)
            c0, t0 = clock.total, time.perf_counter()
            try:
                info = fn(work, args.seed, **size)
                status = "ok"
            except Exception:
                traceback.print_exc()
                info, status = {}, "FAILED"
                failed.append(key)
            wall = time.perf_counter() - t0
            print(f"phase {key} ({title}): {status}, wall {wall:.3f} s, "
                  f"compile {clock.total - c0:.3f} s, {json.dumps(info)}",
                  flush=True)
            if key == "b":
                stats = dev.memory_stats() or {}
                print(f"peak_bytes_in_use after labelprop: "
                      f"{stats.get('peak_bytes_in_use')}")
            shutil.rmtree(work, ignore_errors=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
