#!/usr/bin/env python
"""Benchmark: exact pairwise sketch clustering throughput (GPU vs host CPU).

Workload: N synthetic KSSD-like sketches (~S hashes each, clustered data),
cluster at Mash distance <= d — the reference's hot path (candidate
generation + exact intersection counts + distance + single-linkage).

Device path: bitmap candidate filter (bf16 matmul of 0/1 signatures,
           safe lower bound — no false negatives) -> native exact verify ->
           f64 distances -> union-find.
Host path: sort-based candidate generation + exact counts (NumPy/C++), the
           same code the CPU-only deployment uses.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
vs_baseline = host_time / device_time on identical input with identical
(verified) cluster output.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np


def make_sketches(n=4096, s=1000, n_clusters=64, seed=7):
    rng = np.random.default_rng(seed)
    bases = [np.unique(rng.integers(0, 2 ** 31, size=s).astype(np.uint32))
             for _ in range(n_clusters)]
    hashes = []
    for i in range(n):
        b = bases[i % n_clusters]
        keep = b[rng.random(len(b)) < 0.8]
        extra = np.unique(
            rng.integers(0, 2 ** 31, size=s - len(keep)).astype(np.uint32))
        hashes.append(np.unique(np.concatenate([keep, extra])))
    return hashes


def clusters_host(hashes, threshold, kmer_size):
    from rabbittclust_tpu.cluster.mst import (
        compute_mst, cut_forest, clusters_from_forest)
    res = compute_mst(hashes, threshold, kmer_size)
    return clusters_from_forest(cut_forest(res.mst, threshold), len(hashes))


def clusters_device(hashes, threshold, kmer_size, row_block=8192):
    from rabbittclust_tpu.ops.cluster_fast import threshold_clusters_device
    return threshold_clusters_device(hashes, threshold, kmer_size,
                                     row_block=row_block)


# Published dense peaks per device kind (jax.devices()[0].device_kind).
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM part, without
# sparsity, at the full 700 W power limit.  The filter runs in bf16, so its
# share is read against the bf16 peak.
PEAKS_BY_KIND = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops_per_s": 989e12,
                              "int8_ops_per_s": 1979e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def device_peaks(device_kind: str) -> dict:
    """Peak rates of ``device_kind``; a device missing from the table is an
    error, never a default."""
    try:
        return PEAKS_BY_KIND[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind "
                       f"{device_kind!r}; add it to PEAKS_BY_KIND") from None


def measure_filter_compute(hashes, threshold, kmer_size, reps=8,
                           bits=8192, row_block=8192):
    """Device-compute-only throughput of the candidate filter (staged
    arrays, no host pulls; amortizes dispatch latency over reps).

    Measures the production dense-path program (_batched_mask_fn: bf16
    matmul + bound mask + bit-pack, NO index compaction) over the full
    triangular tile sweep — the same device work candidate_pair_blocks
    dispatches.  Counted pairs = the n_pad^2/2 unordered pairs the sweep
    filters per rep."""
    import math
    import jax
    import jax.numpy as jnp
    from rabbittclust_tpu.ops import bitmap as bm
    from rabbittclust_tpu.distance.mash import (
        min_jaccard_for_threshold, size_ratio_limit)
    rb = min(row_block, max(128, 1 << max(len(hashes) - 1, 1).bit_length()))
    xp, coll = bm.pack_bitmaps_packed(hashes, bits=bits, pad_n_to=rb)
    n_pad = xp.shape[0]
    sizes = np.zeros(n_pad, dtype=np.int32)
    sizes[: len(hashes)] = [len(h) for h in hashes]
    j_min = min_jaccard_for_threshold(threshold, kmer_size)
    c_min = math.exp(-threshold * kmer_size)
    radio = size_ratio_limit(threshold, kmer_size - 1)
    xd = jax.device_put(jnp.asarray(xp))
    cd = jax.device_put(jnp.asarray(coll))
    sd = jax.device_put(jnp.asarray(sizes))
    filt = bm._jitted_batched_mask()
    tiles = [(r0, c0) for r0 in range(0, n_pad, rb)
             for c0 in range(0, r0 + rb, rb)]
    batch_k = 16
    batches = [tiles[i:i + batch_k] for i in range(0, len(tiles), batch_k)]

    def sweep():
        out = None
        for batch in batches:
            r0s = np.zeros(batch_k, dtype=np.int32)
            c0s = np.zeros(batch_k, dtype=np.int32)
            val = np.zeros(batch_k, dtype=np.int32)
            for t, (r0, c0) in enumerate(batch):
                r0s[t], c0s[t], val[t] = r0, c0, 1
            out = filt(xd, cd, sd, jnp.asarray(r0s), jnp.asarray(c0s),
                       jnp.asarray(val), jnp.float32(j_min),
                       jnp.float32(1 + j_min), jnp.float32(c_min),
                       jnp.int32(radio), False, rb)
        return out

    sweep()[0].block_until_ready()  # warm / compile
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = sweep()
    out[0].block_until_ready()  # in-order execution: all reps done
    dt = (time.perf_counter() - t0) / reps
    return n_pad * n_pad / 2 / dt


def partition_digest(clusters):
    canon = sorted(tuple(sorted(c)) for c in clusters if c)
    return hashlib.sha256(repr(canon).encode()).hexdigest()


def device_child():
    """Run the device path in its own process (invoked as a subprocess, so
    the parent, which times the host engine, never opens the card)."""
    n = int(os.environ.get("BENCH_N", "131072"))
    s = int(os.environ.get("BENCH_S", "1000"))
    threshold = 0.05
    kmer_size = 21
    bits = 8192
    hashes = make_sketches(n=n, s=s)
    import jax
    from rabbittclust_tpu.ops import bitmap as bm
    backend = jax.default_backend()
    device_kind = jax.devices()[0].device_kind
    # warm-up with identical shapes (compile; cached persistently)
    _ = clusters_device(hashes, threshold, kmer_size)
    t_device = float("inf")
    for _rep in range(2):
        bm.reset_pull_stats()
        t0 = time.perf_counter()
        ct = clusters_device(hashes, threshold, kmer_size)
        t_device = min(t_device, time.perf_counter() - t0)
    out = {"backend": backend, "device_kind": device_kind,
           "t_device_s": t_device, "digest": partition_digest(ct),
           "pulled_bytes": bm.PULL_STATS["bytes"],
           "pulls": bm.PULL_STATS["pulls"]}
    from rabbittclust_tpu.ops.labelprop import LP_STATS
    if LP_STATS.get("rounds"):
        # phase decomposition of the (last timed) labelprop run.  pull_s
        # blocks on all queued device work, so it contains the build +
        # round device compute; the remainder is host-side.
        out["phases"] = {k: (round(v, 3) if isinstance(v, float) else v)
                         for k, v in LP_STATS.items()}
    if os.environ.get("BENCH_FILTER", "1") == "1":
        # device-compute-only filter rate; BENCH_FILTER=0 skips it
        fpps = measure_filter_compute(hashes, threshold, kmer_size,
                                      bits=bits)
        out["filter_pairs_per_s"] = fpps
        # one candidate-filter pair = `bits` bf16 MACs = 2*bits flops
        out["filter_bf16_flops_per_s"] = fpps * bits * 2
        peak = device_peaks(device_kind)["bf16_flops_per_s"]
        out["bf16_peak_flops_per_s"] = peak
        out["mfu"] = fpps * bits * 2 / peak
    print(json.dumps(out), flush=True)


def _baseline_cache_path():
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, "bench_host_baseline.json")


def _load_baseline_cache():
    try:
        with open(_baseline_cache_path()) as fp:
            return json.load(fp)
    except Exception:
        return {}


def _save_baseline_cache(cache):
    tmp = _baseline_cache_path() + ".tmp"
    with open(tmp, "w") as fp:
        json.dump(cache, fp)
    os.replace(tmp, _baseline_cache_path())


def host_baseline(hashes, n, s, threshold, kmer_size):
    """Host baseline time + partition digest with a min-of-k cache.

    Above 65536 genomes a single host pass takes minutes on this 2-core
    box and carries the shared machine's +-30% noise directly into
    vs_baseline; the cache (keyed by the exact workload parameters)
    accumulates the MIN across rounds so the reported baseline converges.
    BENCH_HOST=force re-times even when cached; BENCH_HOST=cache trusts a
    cached entry without a fresh run (used for the N=1M datapoint where a
    host pass is ~an hour)."""
    key = f"n{n}_s{s}_d{threshold}_k{kmer_size}_seed7"
    cache = _load_baseline_cache()
    ent = cache.get(key)
    mode = os.environ.get("BENCH_HOST", "auto")
    if ent and mode == "cache":
        return float(ent["t_min"]), ent["digest"], dict(
            ent, source="cache-only")
    reps = 2 if n <= 65536 else 1
    t_host = float("inf")
    ch = None
    for _rep in range(reps):
        t0 = time.perf_counter()
        ch = clusters_host(hashes, threshold, kmer_size)
        t_host = min(t_host, time.perf_counter() - t0)
    digest = partition_digest(ch)
    if ent and ent.get("digest") not in (None, digest):
        print(f"bench: WARNING cached baseline digest differs for {key}",
              file=sys.stderr)
        ent = None
    runs = (ent.get("runs", 0) if ent else 0) + reps
    t_min = min(t_host, float(ent["t_min"])) if ent else t_host
    cache[key] = {"t_min": t_min, "digest": digest, "runs": runs}
    _save_baseline_cache(cache)
    return t_min, digest, dict(cache[key], source="timed+cache",
                               t_this_run=round(t_host, 3))


def main():
    n = int(os.environ.get("BENCH_N", "131072"))
    s = int(os.environ.get("BENCH_S", "1000"))
    threshold = 0.05
    kmer_size = 21
    hashes = make_sketches(n=n, s=s)
    pairs = n * (n - 1) / 2

    # host baseline (this process never touches the device, which belongs
    # to the child); min-of-k accumulated across rounds in
    # .cache/bench_host_baseline.json (provenance in the output JSON)
    t_host, host_digest, baseline_prov = host_baseline(
        hashes, n, s, threshold, kmer_size)

    # device path in a child process; a failed device run fails the bench
    timeout = float(os.environ.get("BENCH_DEVICE_TIMEOUT", "1800"))
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--device-child"],
        capture_output=True, text=True, timeout=timeout)
    sys.stderr.write(proc.stderr[-2000:])
    if proc.returncode != 0:
        sys.exit(f"bench: device run failed with exit code {proc.returncode}")
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    backend = info["backend"]
    t_device = float(info["t_device_s"])
    ok = info["digest"] == host_digest

    if not ok:
        print("bench: WARNING device clusters != host clusters",
              file=sys.stderr)

    # headline = the fastest engine
    t_best = min(t_host, t_device)
    fpps = info.get("filter_pairs_per_s")
    ops = info.get("filter_bf16_flops_per_s")
    result = {
        "metric": "exact_pair_cluster_throughput",
        "value": round(pairs / t_best, 1),
        "unit": "pairs/s",
        "vs_baseline": round(t_host / t_best, 3),
        "engine": "device-bitmap" if t_device < t_host else "host-native",
        "n_genomes": n,
        "sketch_size": s,
        "backend": backend,
        "device_kind": info.get("device_kind"),
        "t_host_s": round(t_host, 3),
        "t_device_s": round(t_device, 3),
        "clusters_match": ok,
        "pairs_per_s_per_chip": round(pairs / t_device, 1),
        "filter_compute_pairs_per_s": round(fpps) if fpps else None,
        "filter_bf16_flops_per_s": round(ops) if ops else None,
        "bf16_peak_flops_per_s": info.get("bf16_peak_flops_per_s"),
        # filter_mfu is the FILTER-PHASE-ONLY MFU (staged arrays, no
        # pulls); end_to_end_mfu charges the whole device wall time —
        # the honest utilization of the headline number
        "filter_mfu": (round(info["mfu"], 4) if info.get("mfu") else None),
        "end_to_end_mfu": (
            round(pairs * 8192 * 2 / t_device
                  / info["bf16_peak_flops_per_s"], 4)
            if info.get("bf16_peak_flops_per_s") else None),
        "device_pulled_bytes": info.get("pulled_bytes"),
        "device_pulls": info.get("pulls"),
        # phase decomposition of the device run (labelprop engine):
        # pull_s contains the build+round DEVICE compute (async runtime —
        # the pull blocks on queued work); verify_s is host exact-verify;
        # pack/stage/finish are host-side pre/post phases
        "device_phases": info.get("phases"),
        "baseline": baseline_prov,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    if "--device-child" in sys.argv:
        device_child()
    else:
        main()
