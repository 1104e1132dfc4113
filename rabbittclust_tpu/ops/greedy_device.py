"""Device-accelerated greedy clustering: batch-vs-reps bitmap matmul.

Device counterpart of the reference's batched greedy
(KssdGreedyClusterWithInvertedIndexBatched, greedy.cpp:1412-1543).  The
host batched variant probes a rep-only inverted index per genome; here each
batch's candidate generation is ONE bf16 matmul of 0/1 signatures:

    shared = unpack(sig[batch]) @ unpack(sig[reps]).T        (B, R) int32

with the same deterministic no-false-negative bound as ops/bitmap.py
(shared_bits >= common_min - min(collisions)).  Survivor pairs are verified
with the exact native two-pointer kernel and the final decision (min exact
float64 distance <= threshold, ties to the smallest rep id, conflicts
resolved distance-descending) is identical to
cluster.greedy.greedy_cluster_batched — the result matches it bit-exactly.

All genome signatures are packed once and stay device-resident; the rep set
is addressed by a padded index vector whose capacity doubles as reps grow,
so recompiles are O(log reps) and each batch costs one device round trip.
"""

from __future__ import annotations

import functools
import math
import os
from typing import List

import numpy as np

from ..cluster.greedy import GreedyResult
from ..distance.mash import aaf_distance, mash_distance, \
    min_jaccard_for_threshold
from .bitmap import CsrSketches, _unpack_bits_device, \
    candidate_pair_blocks, pack_bitmaps_packed


def _first_shared_pos(inv: List[np.ndarray], j: int, r: int) -> int:
    """Position, in genome j's sorted hash array, of the first hash shared
    with rep r — the probe-touch key of the serial host engine (sketches
    are sorted ascending, so the first shared hash in probe order is the
    smallest common hash)."""
    common = np.intersect1d(inv[j], inv[r], assume_unique=True)
    return int(np.searchsorted(inv[j], common[0]))


def _sweep_rows(hashes: List[np.ndarray], threshold: float, kmer_size: int,
                is_containment: bool, bits: int, row_block: int,
                bound: str, col_sizes=None, row_sizes=None):
    """Stream (j, candidate row indices int32) for j = 1..n-1 IN ORDER from
    one triangular device sweep, buffering at most one row PANEL of
    candidate pairs (candidate_pair_blocks markers=True) — memory stays
    O(row_block * N * density) instead of O(N^2 * density) pairs."""
    n = len(hashes)
    buf = {}
    next_row = 1  # row 0 never has candidates (pairs have i > j)
    empty = np.empty(0, dtype=np.int32)
    for item in candidate_pair_blocks(
            hashes, threshold, kmer_size, is_containment=is_containment,
            bits=bits, row_block=row_block, bound=bound,
            col_sizes=col_sizes, markers=True, row_sizes=row_sizes):
        if isinstance(item[0], str):  # ("panel", row_end)
            row_end = min(item[1], n)
            for j in range(next_row, row_end):
                parts = buf.pop(j, None)
                yield j, (np.concatenate(parts) if parts else empty)
            next_row = max(next_row, row_end)
            continue
        ii, jj = item
        ii = ii.astype(np.int32)
        jj = jj.astype(np.int32)
        o = np.argsort(ii, kind="stable")
        ii_s, jj_s = ii[o], jj[o]
        cuts = np.flatnonzero(np.diff(ii_s)) + 1
        bounds = np.r_[0, cuts, len(ii_s)]
        for a, b in zip(bounds[:-1], bounds[1:]):
            buf.setdefault(int(ii_s[a]), []).append(jj_s[a:b])
    for j in range(next_row, n):  # guard: markers should have covered all
        parts = buf.pop(j, None)
        yield j, (np.concatenate(parts) if parts else empty)


def _greedy_serial_sweep(inv: List[np.ndarray], sizes: np.ndarray,
                         threshold: float, kmer_size: int,
                         is_containment: bool, bits: int,
                         row_block: int = 4096):
    """Serial greedy replay over ONE triangular all-pairs device sweep.

    Reps are always earlier genomes in processing order, so the triangular
    candidate set {(j, i): i < j passing the greedy bound} is a SUPERSET of
    every (genome, rep) pair the serial loop can ever score — one
    scan-batched sweep (ops.bitmap.candidate_pair_blocks, bound="greedy")
    replaces the per-batch blocking dispatches of the old device path
    (2 round trips x ceil(n/2048) batches; the sweep is
    ceil(tiles/RTC_BATCH_TILES) pipelined dispatches total).
    Exact common counts are computed LAZILY on the host, per genome,
    restricted to candidates that are reps at that genome's turn —
    decisions replicate cluster.greedy.greedy_cluster bit-for-bit
    (reference greedy.cpp:566-899) including exact-similarity ties
    (first-touched rep = minimal (first-shared-hash position, creation
    rank)).  Returns (rep_order, members)."""
    j_min = min_jaccard_for_threshold(threshold, kmer_size)
    c_min = math.exp(-threshold * kmer_size)
    csr = CsrSketches(inv)
    n = len(inv)

    sizes_f = sizes.astype(np.float64)
    rep_order: List[int] = [0]
    members = {0: []}
    rep_rank = {0: 0}
    is_rep = np.zeros(n, dtype=bool)
    is_rep[0] = True
    for j, cand in _sweep_rows(inv, threshold, kmer_size, is_containment,
                               bits, row_block, "greedy"):
        cand = cand[is_rep[cand]]
        best_rep = -1
        if cand.size:
            common = csr.count_common(
                np.full(cand.size, j, dtype=np.int64),
                cand).astype(np.int64)
            # exact f64 accept bound + similarity, replicating the serial
            # host engine bit-for-bit (greedy_cluster / reference
            # greedy.cpp:770-816): the integer common-count bound IS the
            # decision; comparisons use the f64 similarity
            sj = sizes_f[j]
            sr = sizes_f[cand]
            if is_containment:
                den = np.minimum(sj, sr)
                ok = common >= np.ceil(c_min * den)
            else:
                ok = common >= np.ceil(j_min * (sj + sr) / (1.0 + j_min))
                den = sj + sr - common
            if ok.any():
                c_ok = cand[ok]
                den_ok = den[ok]
                zero = den_ok == 0
                sim = np.where(zero, 1.0,
                               common[ok] / np.where(zero, 1.0, den_ok))
                best = sim.max()
                tied = c_ok[sim == best]
                if tied.size > 1:
                    # exact-similarity tie: the serial host's winner is the
                    # FIRST-TOUCHED rep during the index probe
                    best_rep = min(
                        (int(r) for r in tied),
                        key=lambda r: (_first_shared_pos(inv, j, r),
                                       rep_rank[r]))
                else:
                    best_rep = int(tied[0])
        if best_rep != -1:
            members[best_rep].append(j)
        else:
            rep_rank[j] = len(rep_order)
            rep_order.append(j)
            members[j] = []
            is_rep[j] = True
    return rep_order, members


def minhash_greedy_device(
    hashes: List[np.ndarray],
    param_sizes,
    threshold: float,
    kmer_size: int,
    is_containment: bool = False,
    bits: int = 8192,
    row_block: int = 4096,
) -> GreedyResult:
    """Device-swept MinHash-parity greedy — BIT-EXACT vs
    cluster.greedy.minhash_greedy_parity (the reference's default
    clust-greedy MinHash engine, MinHashGreedyClusterWithInvertedIndex,
    src/greedy.cpp:986-1360) including first-touch tie order.

    One triangular all-pairs sweep (bound="minhash": query side = actual
    kept-hash count, rep side = the reference's per-genome param size —
    the asymmetry greedy.cpp has) yields a candidate superset of every
    (genome, rep) probe; the serial loop is replayed on the host with
    exact common counts and the reference's metric:
      * fast path (first min(100, n) genomes standard-mode with identical
        param size): fixed bound, winner = max common, no distance;
      * slow path: per-pair bound, MASH-transform distance of containment
        or jaccard (libm log via math.log — NumPy's SIMD log is 1 ulp
        off), winner = min distance;
    strict comparisons in first-touch order = minimal
    (first-shared-hash position, rep creation rank).

    threshold >= 1.0 falls back to the host engine: the reference clamps
    distances to 1.0, so EVERY probed pair becomes acceptable and no
    common-count bound can express the accept set."""
    from ..cluster.greedy import minhash_greedy_parity

    n = len(hashes)
    if n == 0:
        return GreedyResult([], [], np.empty(0, dtype=np.int64))
    if threshold >= 1.0:
        return minhash_greedy_parity(hashes, list(param_sizes), threshold,
                                     kmer_size, is_containment)

    x = math.exp(-threshold * kmer_size)
    j_min = x / (2.0 - x)
    psizes = np.asarray(param_sizes, dtype=np.int64)
    sample = min(100, n)
    fast = (not is_containment) and all(
        int(psizes[i]) == int(psizes[0]) for i in range(1, sample))
    fixed_common_min = (int(math.ceil(j_min * (2 * int(psizes[0]))
                                      / (1.0 + j_min))) if fast else 0)

    if fast:
        # the fast path accepts with ONE fixed bound ceil(jmin*2*S0/(1+jmin))
        # for EVERY pair regardless of actual/param sizes (only the first
        # min(100, n) genomes are sampled; later ones may differ) — feed
        # the filter constant S0 sizes on BOTH axes so its per-pair bound
        # floor(jmin*2*S0/(1+jmin))-1 can never exceed the fixed accept
        # bound (with actual sizes, a later larger genome's bound could
        # prune a pair the reference's fast path accepts)
        const_s = np.full(n, int(psizes[0]), dtype=np.int64)
        filt_cols = filt_rows = const_s
    else:
        filt_cols, filt_rows = psizes, None  # actual kept counts per row

    csr = CsrSketches(hashes)
    rep_order: List[int] = [0]
    members = {0: []}
    rep_rank = {0: 0}
    is_rep = np.zeros(n, dtype=bool)
    is_rep[0] = True
    for j, cand in _sweep_rows(hashes, threshold, kmer_size, is_containment,
                               bits, row_block, "minhash",
                               col_sizes=filt_cols, row_sizes=filt_rows):
        cand = cand[is_rep[cand]]
        best_rep = -1
        if cand.size:
            common = csr.count_common(
                np.full(cand.size, j, dtype=np.int64),
                cand).astype(np.int64)
            size_ref = len(hashes[j])  # the reference's size_ref = QUERY
            best_metric = None
            tied: List[int] = []
            for r, cm in zip(cand.tolist(), common.tolist()):
                if cm <= 0:
                    continue  # the index probe never touches disjoint reps
                size_qry = int(psizes[r])
                if fast:
                    if cm < fixed_common_min:
                        continue
                    metric = -cm
                else:
                    if is_containment:
                        if cm < math.ceil(j_min * min(size_ref, size_qry)):
                            continue
                        mn = min(size_ref, size_qry)
                        jac = 0.0 if mn == 0 else cm / mn
                        if mn == 0:
                            dist = 1.0
                        elif jac >= 1.0:
                            dist = 0.0
                        elif jac <= 0.0:
                            dist = 1.0
                        else:
                            dist = min(1.0,
                                       -math.log(2.0 * jac / (1.0 + jac))
                                       / kmer_size)
                    else:
                        if cm < math.ceil(j_min * (size_ref + size_qry)
                                          / (1.0 + j_min)):
                            continue
                        denom = size_ref + size_qry - cm
                        if denom == 0:
                            dist = 0.0
                        else:
                            jac = cm / denom
                            if jac >= 1.0:
                                dist = 0.0
                            elif jac <= 0.0:
                                dist = 1.0
                            else:
                                dist = min(1.0,
                                           -math.log(2.0 * jac / (1.0 + jac))
                                           / kmer_size)
                    if dist > threshold:
                        continue
                    metric = dist
                # track metric-equal ties; the O(s) first-touch key is
                # resolved lazily, only among exact ties (rare)
                if best_metric is None or metric < best_metric:
                    best_metric, tied = metric, [r]
                elif metric == best_metric:
                    tied.append(r)
            if tied:
                if len(tied) > 1:
                    best_rep = min(
                        tied, key=lambda r: (_first_shared_pos(hashes, j, r),
                                             rep_rank[r]))
                else:
                    best_rep = tied[0]
        if best_rep != -1:
            members[best_rep].append(j)
        else:
            rep_rank[j] = len(rep_order)
            rep_order.append(j)
            members[j] = []
            is_rep[j] = True

    order = np.arange(n, dtype=np.int64)
    clusters = [[r] + members[r] for r in rep_order]
    return GreedyResult(clusters=clusters, representatives=list(rep_order),
                        order=order)


def _greedy_filter_fn(x_all, batch_idx, rep_idx, coll, sizes, jmin_num,
                      jmin_den, c_min, radio_f, is_containment, cap,
                      triangular=False):
    """Device: candidate (batch, rep) pairs for one batch.

    Returns one fused int32 array [count, flat_idx(cap)] where
    flat = b_local * R_cap + r_local.  Pad slots (batch or rep) point at a
    zero-size padding genome, so the size > 0 check masks them out.
    ``triangular`` restricts to column position < row position (used for
    in-batch pairs, where both axes are the batch in ascending order)."""
    import jax
    import jax.numpy as jnp

    xb = _unpack_bits_device(jnp.take(x_all, batch_idx, axis=0))
    xr = _unpack_bits_device(jnp.take(x_all, rep_idx, axis=0))
    shared = jax.lax.dot_general(
        xb, xr, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32).astype(jnp.int32)
    sb = jnp.take(sizes, batch_idx)
    sr = jnp.take(sizes, rep_idx)
    cb = jnp.take(coll, batch_idx)
    cr = jnp.take(coll, rep_idx)
    sb_f = sb[:, None].astype(jnp.float32)
    sr_f = sr[None, :].astype(jnp.float32)
    # float32 bound with a -1 safety margin (see ops/bitmap._filter_block_fn)
    if is_containment:
        mn = jnp.minimum(sb_f, sr_f)
        common_min = jnp.floor(c_min * mn).astype(jnp.int32) - 1
    else:
        common_min = jnp.floor(
            jmin_num * (sb_f + sr_f) / jmin_den).astype(jnp.int32) - 1
    thresh = common_min - jnp.minimum(cb[:, None], cr[None, :])
    # size window in float with +1 slack: d <= t implies max <= min/j_min,
    # never truncate this bound down (false negatives are correctness bugs).
    # Containment has NO size-ratio implication (a small sketch may be fully
    # contained in an arbitrarily large one) — only require nonzero sizes.
    mn_i = jnp.minimum(sb_f, sr_f)
    mx_i = jnp.maximum(sb_f, sr_f)
    if is_containment:
        ratio_ok = mn_i > 0
    else:
        ratio_ok = (mn_i > 0) & (mx_i <= radio_f * mn_i + 1.0)
    mask = (shared >= thresh) & ratio_ok
    if triangular:
        b, r = mask.shape
        iidx = jax.lax.broadcasted_iota(jnp.int32, (b, r), 0)
        jidx = jax.lax.broadcasted_iota(jnp.int32, (b, r), 1)
        mask &= jidx < iidx
    # two-level compaction (see ops.bitmap): safe because the caller
    # regrows whenever count > cap, and chunks_hit <= count <= cap
    from .bitmap import compact_mask_two_level
    count, flat_idx = compact_mask_two_level(mask, cap, cap)
    return jnp.concatenate([count[None], flat_idx])


@functools.lru_cache(maxsize=1)
def _jitted_greedy_filter():
    import jax
    return jax.jit(_greedy_filter_fn,
                   static_argnames=("is_containment", "cap", "triangular"))


def greedy_cluster_device(
    hashes: List[np.ndarray],
    threshold: float,
    kmer_size: int,
    batch_size: int = 2048,
    presorted: bool = False,
    is_containment: bool = False,
    bits: int = 8192,
    conflict: str = "serial",
) -> GreedyResult:
    """Greedy clustering with device candidate generation.

    ``conflict`` selects the in-batch semantics:
      * "serial" (default): BIT-EXACT vs the reference's default serial
        algorithm (greedy.cpp:566-899) including exact-similarity ties,
        which resolve to the first-touched rep of the index probe (minimal
        (first-shared-hash position, rep creation rank)).  Candidates come
        from ONE pipelined triangular all-pairs sweep (_greedy_serial_sweep;
        reps are always earlier genomes, so the sweep is a superset of
        every (genome, rep) probe) with lazy host verify; set
        RTC_GREEDY_DEVICE=batchloop for the legacy 2-dispatches-per-batch
        loop (A/B);
      * "batched": bit-exact match of
        cluster.greedy.greedy_cluster_batched at the same batch_size
        (reference's experimental batched variant semantics — batch members
        never match reps created within their own batch)."""
    import jax.numpy as jnp
    from ..utils.jaxcfg import configure_jax
    configure_jax()

    n = len(hashes)
    if n == 0:
        return GreedyResult([], [], np.empty(0, dtype=np.int64))
    if presorted:
        order = np.arange(n, dtype=np.int64)
        inv = list(hashes)
    else:
        sizes0 = np.array([len(h) for h in hashes], dtype=np.int64)
        order = np.lexsort((np.arange(n), -sizes0))
        inv = [hashes[i] for i in order]

    if conflict == "serial" and \
            os.environ.get("RTC_GREEDY_DEVICE", "sweep") != "batchloop":
        # every value except the legacy "batchloop" A/B mode selects the
        # single-sweep engine ("sweep"/"force"/"auto"; the workflow layer
        # interprets "auto"/"native" BEFORE calling here)
        sizes = np.array([len(h) for h in inv], dtype=np.int64)
        rep_order, members = _greedy_serial_sweep(
            inv, sizes, threshold, kmer_size, is_containment, bits)
        clusters = [[int(order[r])] + [int(order[m]) for m in members[r]]
                    for r in rep_order]
        reps_orig = [int(order[r]) for r in rep_order]
        return GreedyResult(clusters=clusters, representatives=reps_orig,
                            order=order)

    xp, coll = pack_bitmaps_packed(inv, bits=bits, pad_n_to=128)
    n_pad = xp.shape[0]
    pad_slot = n_pad - 1 if n < n_pad else n_pad  # zero-size row for padding
    if n == n_pad:  # no spare padded row: append one
        xp = np.vstack([xp, np.zeros((1, xp.shape[1]), dtype=np.uint8)])
        coll = np.r_[coll, np.int32(0)]
        pad_slot = n_pad
    sizes_pad = np.zeros(xp.shape[0], dtype=np.int32)
    sizes = np.array([len(h) for h in inv], dtype=np.int64)
    sizes_pad[:n] = sizes

    j_min = min_jaccard_for_threshold(threshold, kmer_size)
    c_min = math.exp(-threshold * kmer_size)
    radio_f = 2.0 * math.exp(threshold * kmer_size) - 1.0

    xd = jnp.asarray(xp)
    cd = jnp.asarray(coll)
    sd = jnp.asarray(sizes_pad)
    filt = _jitted_greedy_filter()
    csr = CsrSketches(inv)

    rep_order: List[int] = [0]
    members = {0: []}
    rep_cap = 1024
    cap = max(1 << 18, batch_size * 64)

    def _run_filter(batch_idx, other_idx, other_cap, triangular):
        nonlocal cap
        while True:
            fused = np.asarray(filt(
                xd, jnp.asarray(batch_idx), jnp.asarray(other_idx), cd, sd,
                jnp.float32(j_min), jnp.float32(1.0 + j_min),
                jnp.float32(c_min), jnp.float32(radio_f), is_containment,
                cap, triangular))
            count = int(fused[0])
            if count <= cap:
                break
            cap *= 4
        if not count:
            e = np.empty(0, dtype=np.int64)
            return e, e.copy(), e.copy(), np.empty(0, dtype=np.float64)
        flat = fused[1:1 + count].astype(np.int64)
        bi = batch_idx[flat // other_cap].astype(np.int64)
        ri = other_idx[flat % other_cap].astype(np.int64)
        common = csr.count_common(bi, ri).astype(np.int64)
        if is_containment:
            d = aaf_distance(common, sizes[bi], sizes[ri], kmer_size)
        else:
            d = mash_distance(common, sizes[bi], sizes[ri], kmer_size)
        ok = common > 0
        return bi[ok], ri[ok], common[ok], d[ok]

    for b0 in range(1, n, batch_size):
        b1 = min(b0 + batch_size, n)
        batch_idx = np.full(batch_size, pad_slot, dtype=np.int32)
        batch_idx[:b1 - b0] = np.arange(b0, b1, dtype=np.int32)
        while rep_cap < len(rep_order):
            rep_cap *= 2
        rep_idx = np.full(rep_cap, pad_slot, dtype=np.int32)
        rep_idx[:len(rep_order)] = rep_order
        vs_reps = _run_filter(batch_idx, rep_idx, rep_cap, False)
        if conflict == "serial":
            # in-batch candidate pairs (column position < row position)
            vs_batch = _run_filter(batch_idx, batch_idx, batch_size, True)
            # per-batch-member candidate list: (cand_id, common)
            cand = {j: [] for j in range(b0, b1)}
            for b, r, cm in zip(vs_reps[0].tolist(), vs_reps[1].tolist(),
                                vs_reps[2].tolist()):
                cand[b].append((r, cm))
            for b, r, cm in zip(vs_batch[0].tolist(), vs_batch[1].tolist(),
                                vs_batch[2].tolist()):
                cand[b].append((r, cm))
            rep_rank = {r: k for k, r in enumerate(rep_order)}
            for j in range(b0, b1):
                sj = int(sizes[j])
                best_sim, best_rep = -1.0, -1
                tied: List[int] = []
                for r, cm in cand[j]:
                    if r not in rep_rank:
                        continue
                    # exact accept bound + similarity, replicating the
                    # serial host engine bit-for-bit (greedy_cluster /
                    # reference greedy.cpp:770-816): the integer
                    # common-count bound IS the decision, and comparisons
                    # use the f64 similarity, not the log distance
                    sr = int(sizes[r])
                    if is_containment:
                        mn = min(sj, sr)
                        if cm < math.ceil(c_min * mn):
                            continue
                        sim = 1.0 if mn == 0 else cm / mn
                    else:
                        if cm < math.ceil(
                                j_min * (sj + sr) / (1.0 + j_min)):
                            continue
                        denom = sj + sr - cm
                        sim = 1.0 if denom == 0 else cm / denom
                    if sim > best_sim:
                        best_sim, best_rep = sim, r
                        tied = [r]
                    elif sim == best_sim:
                        tied.append(r)
                if len(tied) > 1:
                    # exact-similarity tie: the serial host's winner is the
                    # FIRST-TOUCHED rep during the index probe — minimal
                    # (position of first shared hash in j's sorted array,
                    # rep creation rank); replicated exactly here
                    best_rep = min(
                        tied, key=lambda r: (_first_shared_pos(inv, j, r),
                                             rep_rank[r]))
                if best_rep != -1:
                    members[best_rep].append(j)
                else:
                    rep_rank[j] = len(rep_order)
                    rep_order.append(j)
                    members[j] = []
        else:  # "batched"
            ok = vs_reps[3] <= threshold
            best = {}
            for b, r, dd in zip(vs_reps[0][ok].tolist(),
                                vs_reps[1][ok].tolist(),
                                vs_reps[3][ok].tolist()):
                cur = best.get(b)
                if cur is None or dd < cur[0] or (dd == cur[0] and
                                                  r < cur[1]):
                    best[b] = (dd, r)
            results = [(j,) + best.get(j, (float("inf"), -1))
                       for j in range(b0, b1)]
            # distance-descending conflict resolution (ties: stable order)
            results.sort(key=lambda t: -t[1])
            for j, _d, rep in results:
                if rep != -1:
                    members[rep].append(j)
                else:
                    rep_order.append(j)
                    members[j] = []

    clusters = [[int(order[r])] + [int(order[m]) for m in members[r]]
                for r in rep_order]
    reps_orig = [int(order[r]) for r in rep_order]
    return GreedyResult(clusters=clusters, representatives=reps_orig,
                        order=order)
