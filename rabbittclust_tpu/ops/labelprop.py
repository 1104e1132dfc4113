"""Device-resident label-propagation clustering — breaks the O(N^2/8)
mask-pull floor of the streaming bitmap engine, and (panel-streamed) the
O(N^2/8) resident-HBM ceiling too.

The streaming engine (ops/cluster_fast.py) pulls EVERY candidate pair to
the host (packed masks: N^2/8 bytes regardless of density, 302 MB at
N=65536) even though single-linkage clustering only ever needs ~N-1 true
edges plus the verified rejections.  This engine keeps the candidate masks
RESIDENT on the device and runs Boruvka-style rounds:

  build   one dispatch computes the bitmap filter for a PANEL of
          triangular tiles (ops.bitmap._batched_mask_fn) and leaves the
          bit-packed candidate masks in HBM — nothing is pulled.
  round   one dispatch (a) clears bits of pairs the host exact-verified as
          failing, (b) recomputes, under the CURRENT component labels, each
          row's minimum cross-component candidate partner and each column's
          minimum cross-component candidate row (a sweep over the resident
          masks — pure HBM reads, no matmul), and (c) returns one fused
          int32 array [cross_count, row_proposals, col_proposals].
  host    verifies the <= 2*N proposed pairs exactly (native two-pointer
          counts + float64 distances), merges passes into a union-find,
          and pushes the new labels + the failed pairs' clear-list into the
          next round.

Panel streaming (the HBM-scale mode): resident masks are N^2/8 bytes, which
outgrow any one card well before the reference's flagship claim of 1.13M
genomes (reference README.md:258-262).  The triangular tile sweep is
therefore split into panels of at most RTC_LP_PANEL_TILES tiles (default
512 = 4.3 GB at rb=8192, 1.1 GB at the CLI's rb=4096); the value was sized
for a 16 GB card and is to be re-decided on the H100's 80 GB (ROADMAP
1.5).  Each panel's filter is computed ONCE (so total filter work is
exactly one full sweep), labelprop rounds run until
the PANEL has no cross-label candidates left, the panel's masks are freed,
and the union-find labels carry into the next panel.  Per-panel
convergence is sufficient for global exactness: the union-find only ever
merges, so a pair that was same-label when its panel retired can never
become cross-label again.  For N <= ~panel capacity this degenerates to
the original single-panel all-resident engine.

Pulled bytes per round: single-panel runs pull the full fused
[cross, row_p, col_p] = 4*(1 + 2*n_pad); multi-panel runs pull the
COMPACTED [cross, ncol, row_p[panel row span], col idx/val (<= cap)]
(~1.8 MB at N=1M vs 8.4 MB full — 59 MB total across 33 rounds, was
277 MB).  The row slice is lossless (only panel-resident rows propose);
col overflow past RTC_LP_COL_CAP is deferred to later rounds (masks are
resident, proposals only feed the verify gate — see
_round_fn_compact).  Rounds are few: round 1 star-collapses most
clusters (every member proposes the cluster's minimum-index member),
later rounds only touch unresolved rows and inter-cluster false
positives of the bitmap bound.  Panel p+1's filter build is dispatched
during panel p's rounds (RTC_LP_PREFETCH=0 disables) so it runs in the
device's host-verify idle windows.

Exactness: identical argument as ops/cluster_fast.py — the bitmap bound has
no false negatives, so the true-edge graph is a subgraph of the candidate
masks.  Every candidate pair ends in exactly one state: (a) exact-verified
pass (merged, edge kept), (b) exact-verified fail (bit cleared on device —
it is never proposed again), or (c) same-label (gated: its endpoints are
already connected by verified edges, so it cannot change the partition).
Each panel's loop exits only when its cross_count == 0, i.e. every
remaining candidate in the panel is same-label.  Progress per round is
guaranteed (a nonzero cross_count implies at least one proposal, and every
proposal is merged or cleared), so termination is unconditional;
``max_rounds`` only bounds pathological inputs before an exact host-side
fallback finishes the panel.

Reference role: the streaming per-thread Kruskal memory trick at
MST.cpp:571-574,779-787 — done device-natively (device holds a bounded
window of the O(N^2) candidate state; the host sees O(N) per round).
"""

from __future__ import annotations

import functools
import math
import os
import time
from typing import List, Tuple

import numpy as np

from ..cluster.union_find import UnionFind
from ..distance.mash import min_jaccard_for_threshold, size_ratio_limit
from . import bitmap as bm

SENT = np.int32(1 << 30)

# phase decomposition of the last run (read by bench.py; wall seconds).
# "pull" blocks on all queued device work, so it includes the device
# compute of the build + round dispatches it waits for — the honest split
# between device time and host time on an async runtime is pull vs the
# rest.  reset_lp_stats() zeroes it.
LP_STATS = {"pack_s": 0.0, "stage_s": 0.0, "csr_s": 0.0, "pull_s": 0.0,
            "verify_s": 0.0, "finish_s": 0.0, "total_s": 0.0, "rounds": 0,
            "panels": 0, "proposals": 0}


def reset_lp_stats() -> None:
    for k in LP_STATS:
        LP_STATS[k] = 0.0 if isinstance(LP_STATS[k], float) else 0


def _round_fn(packs, labels, clr_t, clr_r, clr_b, clr_sub, r0s, c0s, valid,
              rb):
    """One device round: clear failed bits, then propose, per genome, its
    minimum cross-label candidate partner.

    packs: (T, rb, rb//8) resident bit-packed candidate masks (donated);
    labels: (n_pad,) current component labels; clr_*: (C,) coordinates of
    bits to clear (t, row, byte, bit-value) — no-op entries have sub == 0.
    Returns (new_packs, fused) where fused = [cross_count,
    row_prop (n_pad,), col_prop (n_pad,)] int32."""
    import jax
    import jax.numpy as jnp

    n_pad = labels.shape[0]
    # (a) clear verified-failed pairs: each bit is cleared at most once
    # ever (a cleared bit leaves the mask, so it is never proposed again),
    # so subtracting the bit value == clearing it; no-op pads subtract 0.
    packs = packs.at[clr_t, clr_r, clr_b].add(-clr_sub)

    shifts = jnp.arange(8, dtype=jnp.uint8)
    iota_r = jax.lax.iota(jnp.int32, rb)

    def step(carry, xs):
        row_p, col_p, cross = carry
        pk, r0, c0, ok = xs
        bits = ((pk[:, :, None] >> shifts[None, None, :]) & jnp.uint8(1))
        m = bits.reshape(rb, rb).astype(jnp.bool_)
        lr = jax.lax.dynamic_slice(labels, (r0,), (rb,))
        lc = jax.lax.dynamic_slice(labels, (c0,), (rb,))
        m = m & (lr[:, None] != lc[None, :]) & (ok > 0)
        cross = cross + jnp.sum(m, dtype=jnp.int32)
        colv = jnp.where(m, iota_r[None, :] + c0, SENT)
        rowv = jnp.where(m, iota_r[:, None] + r0, SENT)
        rmin = jnp.min(colv, axis=1)
        cmin = jnp.min(rowv, axis=0)
        cur = jax.lax.dynamic_slice(row_p, (r0,), (rb,))
        row_p = jax.lax.dynamic_update_slice(
            row_p, jnp.minimum(cur, rmin), (r0,))
        cur = jax.lax.dynamic_slice(col_p, (c0,), (rb,))
        col_p = jax.lax.dynamic_update_slice(
            col_p, jnp.minimum(cur, cmin), (c0,))
        return (row_p, col_p, cross), None

    init = (jnp.full((n_pad,), SENT, dtype=jnp.int32),
            jnp.full((n_pad,), SENT, dtype=jnp.int32), jnp.int32(0))
    (row_p, col_p, cross), _ = jax.lax.scan(
        step, init, (packs, r0s, c0s, valid))
    fused = jnp.concatenate([cross[None], row_p, col_p])
    return packs, fused


def _round_fn_compact(packs, labels, clr_t, clr_r, clr_b, clr_sub, r0s,
                      c0s, valid, r_lo, rb, span, cap):
    """_round_fn with a compacted pull: instead of the full
    [cross, row_p(n_pad), col_p(n_pad)] (8.4 MB at N=1M, every round),
    return [cross, ncol, row_p[r_lo:r_lo+span], col_idx(cap),
    col_val(cap)].  The row slice loses nothing (only the panel's
    resident rows can propose); the col compaction is a HINT channel —
    when more than ``cap`` columns propose, the overflow is simply
    deferred (the masks are resident, so undelivered proposals re-surface
    next round) — exactness is untouched because proposals only ever
    FEED the host verify gate, and termination is driven by ``cross``
    plus the guaranteed row proposals."""
    import jax
    import jax.numpy as jnp

    packs, fused = _round_fn(packs, labels, clr_t, clr_r, clr_b, clr_sub,
                             r0s, c0s, valid, rb)
    n_pad = labels.shape[0]
    cross = fused[:1]
    row_p = fused[1:1 + n_pad]
    col_p = fused[1 + n_pad:]
    row_span = jax.lax.dynamic_slice(row_p, (r_lo,), (span,))
    mask = col_p < SENT
    ncol = jnp.sum(mask, dtype=jnp.int32)
    idx = jnp.nonzero(mask, size=cap, fill_value=0)[0].astype(jnp.int32)
    val = col_p[idx]
    out = jnp.concatenate([cross, ncol[None], row_span, idx, val])
    return packs, out


def _split_host_input(hin, clr_cap, extra):
    """hin = [labels(n_pad), clr_t, clr_r, clr_b, clr_sub (clr_cap each),
    extra scalars] int32 — ONE host->device transfer per round instead of
    five-plus (each separate push pays this link's fixed per-transfer
    overhead; at N=1M that is 4 x 33 saved round trips)."""
    import jax.numpy as jnp

    n_pad = hin.shape[0] - 4 * clr_cap - extra
    labels = hin[:n_pad]
    o = n_pad
    clr_t = hin[o:o + clr_cap]
    clr_r = hin[o + clr_cap:o + 2 * clr_cap]
    clr_b = hin[o + 2 * clr_cap:o + 3 * clr_cap]
    clr_sub = hin[o + 3 * clr_cap:o + 4 * clr_cap].astype(jnp.uint8)
    return labels, clr_t, clr_r, clr_b, clr_sub


def _round_fn_hin(packs, hin, r0s, c0s, valid, rb, clr_cap):
    labels, clr_t, clr_r, clr_b, clr_sub = _split_host_input(hin, clr_cap,
                                                             0)
    return _round_fn(packs, labels, clr_t, clr_r, clr_b, clr_sub, r0s,
                     c0s, valid, rb)


def _round_fn_compact_hin(packs, hin, r0s, c0s, valid, rb, span, cap,
                          clr_cap):
    labels, clr_t, clr_r, clr_b, clr_sub = _split_host_input(hin, clr_cap,
                                                             1)
    r_lo = hin[-1]
    return _round_fn_compact(packs, labels, clr_t, clr_r, clr_b, clr_sub,
                             r0s, c0s, valid, r_lo, rb, span, cap)


@functools.lru_cache(maxsize=1)
def _jitted_round_hin():
    import jax
    return jax.jit(_round_fn_hin, static_argnames=("rb", "clr_cap"),
                   donate_argnums=(0,))


@functools.lru_cache(maxsize=1)
def _jitted_round_compact_hin():
    import jax
    return jax.jit(_round_fn_compact_hin,
                   static_argnames=("rb", "span", "cap", "clr_cap"),
                   donate_argnums=(0,))


def _round_fn_compact_delta(packs, labels_dev, hin, r0s, c0s, valid, rb,
                            span, cap, clr_cap, dcap):
    """Compact round with DEVICE-RESIDENT labels (opt-in,
    RTC_LP_LABEL_DELTA=1): instead of pushing the full (n_pad,) label
    array every round (4 MB x 33 rounds at N=1M), the host pushes only
    the entries that changed since the last round —
    hin = [delta idx (dcap), delta val (dcap), clear lists, r_lo] — and
    the device scatters them into its resident copy.  Pad entries repeat
    (idx 0, current labels[0]): idempotent.  When more than ``dcap``
    labels changed the caller re-pushes the full array instead (one
    fixed dcap = one compiled shape)."""
    import jax.numpy as jnp

    labels = labels_dev.at[hin[:dcap]].set(hin[dcap:2 * dcap])
    rest = hin[2 * dcap:]
    clr_t = rest[:clr_cap]
    clr_r = rest[clr_cap:2 * clr_cap]
    clr_b = rest[2 * clr_cap:3 * clr_cap]
    clr_sub = rest[3 * clr_cap:4 * clr_cap].astype(jnp.uint8)
    r_lo = rest[-1]
    packs, fused = _round_fn_compact(packs, labels, clr_t, clr_r, clr_b,
                                     clr_sub, r0s, c0s, valid, r_lo, rb,
                                     span, cap)
    return packs, labels, fused


@functools.lru_cache(maxsize=1)
def _jitted_round_compact_delta():
    import jax
    return jax.jit(_round_fn_compact_delta,
                   static_argnames=("rb", "span", "cap", "clr_cap",
                                    "dcap"),
                   donate_argnums=(0, 1))


def _clear_quantum(count: int) -> int:
    """Ladder for the clear-list length (few distinct compiled shapes)."""
    k = 1024
    while k < count:
        k *= 4
    return k


def threshold_clusters_device_lp(
    hashes: List[np.ndarray],
    threshold: float,
    kmer_size: int,
    is_containment: bool = False,
    bits: int = 8192,
    row_block: int = 8192,
    max_rounds: int = 256,
    panel_tiles: int = 0,
) -> List[List[int]]:
    """Exact single-linkage clusters at ``threshold`` (BFS-ordered like the
    reference MST cut) with O(N)-per-round device pulls and an HBM
    footprint bounded by ``panel_tiles`` resident mask tiles (default
    RTC_LP_PANEL_TILES=512 = 4.3 GB at rb=8192 — any N fits)."""
    import jax.numpy as jnp
    from ..utils.jaxcfg import configure_jax
    configure_jax()

    n = len(hashes)
    if n == 0:
        return []
    from ..cluster.mst import clusters_from_forest, sort_edges

    reset_lp_stats()
    t_all = time.perf_counter()
    rb = min(row_block, max(128, 1 << max(n - 1, 1).bit_length()))
    t0 = time.perf_counter()
    # pack + push overlap: chunks transfer while the next chunk packs
    xd, coll = bm.pack_bitmaps_packed_staged(hashes, bits=bits, pad_n_to=rb)
    LP_STATS["pack_s"] = time.perf_counter() - t0
    n_pad = xd.shape[0]
    sizes = np.zeros(n_pad, dtype=np.int32)
    sizes[:n] = [len(h) for h in hashes]
    j_min = min_jaccard_for_threshold(threshold, kmer_size)
    c_min = math.exp(-threshold * kmer_size)
    radio = size_ratio_limit(threshold, kmer_size - 1)

    # triangular tile sweep, split into panels of <= t_cap tiles (t_cap a
    # power of two so the number of distinct compiled shapes stays
    # logarithmic); each panel's masks are resident only while it runs
    tiles = [(r0, c0) for r0 in range(0, n_pad, rb)
             for c0 in range(0, r0 + rb, rb)]
    if panel_tiles <= 0:
        panel_tiles = int(os.environ.get("RTC_LP_PANEL_TILES", "512"))
    t_cap = 1
    while t_cap < min(len(tiles), panel_tiles):
        t_cap *= 2
    panels = [tiles[p:p + t_cap] for p in range(0, len(tiles), t_cap)]

    # signatures staged ONCE for every panel build
    t0 = time.perf_counter()
    cd = jnp.asarray(coll)
    sd = jnp.asarray(sizes)
    scalars = (jnp.float32(j_min), jnp.float32(1.0 + j_min),
               jnp.float32(c_min), jnp.int32(radio))
    LP_STATS["stage_s"] = time.perf_counter() - t0

    uf = UnionFind(n)
    csr = None  # built AFTER the first build dispatch (overlaps device)
    sizes64 = sizes.astype(np.int64)
    kept_i: List[int] = []
    kept_j: List[int] = []
    kept_d: List[float] = []
    build_prog = bm._jitted_batched_mask()

    def labels_arr():
        roots = np.full(n_pad, -1, dtype=np.int32)
        roots[:n] = uf.roots_array()[:n]
        # padded rows keep distinct labels (they are maskless anyway)
        roots[n:] = n + np.arange(n_pad - n, dtype=np.int32)
        return roots

    # Compact-pull geometry (multi-panel only; a single panel keeps the
    # original full-pull program and its compiled shape).  ONE (span, cap)
    # pair serves every panel — span covers the widest panel's row blocks
    # — so exactly two round programs compile regardless of panel count.
    # (The minimal shape count was chosen where compiles took minutes;
    # whether per-panel shapes would pay on the H100 is ROADMAP 3.2.)
    multi = len(panels) > 1
    span = cap = 0
    panel_geo = []
    for panel in panels:
        lo = min(r0 for r0, _ in panel)
        hi = max(r0 for r0, _ in panel) + rb
        panel_geo.append((lo, hi))
    if multi:
        span = min(n_pad, max(hi - lo for lo, hi in panel_geo))
        cap = min(n_pad, int(os.environ.get("RTC_LP_COL_CAP", "65536")))
        round_compact_hin = _jitted_round_compact_hin()
    use_delta = multi and os.environ.get("RTC_LP_LABEL_DELTA", "0") == "1"
    if use_delta:
        round_compact_delta = _jitted_round_compact_delta()
        dcap = min(n_pad, 65536)
    labels_dev = None
    prev_labels = None
    prefetch = os.environ.get("RTC_LP_PREFETCH", "1") != "0" and multi

    def _panel_arrays(panel):
        r0s = np.zeros(t_cap, dtype=np.int32)
        c0s = np.zeros(t_cap, dtype=np.int32)
        valid = np.zeros(t_cap, dtype=np.int32)
        for t, (r0, c0) in enumerate(panel):
            r0s[t], c0s[t], valid[t] = r0, c0, 1
        return jnp.asarray(r0s), jnp.asarray(c0s), jnp.asarray(valid)

    round_hin = _jitted_round_hin()

    def _mk_hin(labels, clr, r_lo=None):
        parts = [labels, clr[0], clr[1], clr[2], clr[3].astype(np.int32)]
        if r_lo is not None:
            parts.append(np.array([r_lo], dtype=np.int32))
        return np.concatenate(parts)

    from ..utils.profiling import maybe_trace
    with maybe_trace("labelprop_cluster"):
        next_packs = None
        for p_idx, panel in enumerate(panels):
            LP_STATS["panels"] += 1
            t_off = p_idx * t_cap  # global index of the panel's first tile
            r0s_d, c0s_d, val_d = _panel_arrays(panel)
            # build: one async dispatch, masks stay resident — counts are
            # NOT pulled; its device time lands in the first round's pull.
            # With prefetch on, panel p+1's build was already dispatched
            # during panel p's rounds (fills the device's idle window
            # while the host verifies).
            if next_packs is not None:
                packs = next_packs
                next_packs = None
            else:
                _counts_dev, packs = build_prog(
                    xd, cd, sd, r0s_d, c0s_d, val_d, *scalars,
                    is_containment, rb)
            if csr is None:
                # CSR flattening overlaps the first panel's device filter
                # sweep (its wall time mostly hides behind pull_s)
                t0 = time.perf_counter()
                csr = bm.CsrSketches(hashes)
                LP_STATS["csr_s"] += time.perf_counter() - t0
            clr = (np.zeros(1024, dtype=np.int32),
                   np.zeros(1024, dtype=np.int32),
                   np.zeros(1024, dtype=np.int32),
                   np.zeros(1024, dtype=np.uint8))
            r_lo = min(panel_geo[p_idx][0], n_pad - span) if multi else 0
            rounds = 0
            converged = False
            while rounds < max_rounds:
                rounds += 1
                LP_STATS["rounds"] += 1
                # panel 0 round 1: full pull (columns are panel-internal
                # and dense); everything else: compacted pull — row slice
                # is lossless, col compaction defers overflow harmlessly
                use_compact = multi and not (p_idx == 0 and rounds == 1)
                clr_cap = len(clr[0])
                if use_compact and use_delta:
                    cur = labels_arr()
                    if labels_dev is None or int(
                            np.count_nonzero(cur != prev_labels)) > dcap:
                        labels_dev = jnp.asarray(cur)  # full (re)push
                        dd = np.empty(0, dtype=np.int32)
                    else:
                        dd = np.flatnonzero(
                            cur != prev_labels).astype(np.int32)
                    didx = np.zeros(dcap, dtype=np.int32)
                    dval = np.full(dcap, cur[0], dtype=np.int32)
                    didx[:len(dd)] = dd
                    dval[:len(dd)] = cur[dd]
                    prev_labels = cur
                    hin = np.concatenate(
                        [didx, dval, clr[0], clr[1], clr[2],
                         clr[3].astype(np.int32),
                         np.array([r_lo], dtype=np.int32)])
                    packs, labels_dev, fused_dev = round_compact_delta(
                        packs, labels_dev, jnp.asarray(hin), r0s_d,
                        c0s_d, val_d, rb=rb, span=span, cap=cap,
                        clr_cap=clr_cap, dcap=dcap)
                elif use_compact:
                    packs, fused_dev = round_compact_hin(
                        packs, jnp.asarray(_mk_hin(labels_arr(), clr,
                                                   r_lo)),
                        r0s_d, c0s_d, val_d, rb=rb, span=span, cap=cap,
                        clr_cap=clr_cap)
                else:
                    packs, fused_dev = round_hin(
                        packs, jnp.asarray(_mk_hin(labels_arr(), clr)),
                        r0s_d, c0s_d, val_d, rb=rb, clr_cap=clr_cap)
                if prefetch and rounds == 1 and p_idx + 1 < len(panels):
                    # dispatch the NEXT panel's filter sweep now: it
                    # queues behind this panel's remaining rounds and
                    # runs in the device's host-verify idle windows
                    nxt = _panel_arrays(panels[p_idx + 1])
                    _nc, next_packs = build_prog(
                        xd, cd, sd, *nxt, *scalars, is_containment, rb)
                t0 = time.perf_counter()
                fused = np.asarray(fused_dev)
                dt = time.perf_counter() - t0
                LP_STATS["pull_s"] += dt
                bm._note_pull_time(fused.nbytes, dt)
                bm._account_pull(fused.nbytes)
                cross = int(fused[0])
                if cross == 0:
                    converged = True
                    break
                t0 = time.perf_counter()
                from .cluster_fast import gated_verify_merge
                g = np.arange(n_pad, dtype=np.int64)
                if use_compact:
                    ncol = int(fused[1])
                    row_p = np.full(n_pad, SENT, dtype=np.int32)
                    row_p[r_lo:r_lo + span] = fused[2:2 + span]
                    col_p = np.full(n_pad, SENT, dtype=np.int32)
                    k = min(ncol, cap)
                    ci_idx = fused[2 + span:2 + span + k]
                    col_p[ci_idx] = fused[2 + span + cap:
                                          2 + span + cap + k]
                else:
                    row_p = fused[1:1 + n_pad]
                    col_p = fused[1 + n_pad:]
                rp = row_p < SENT
                cp = col_p < SENT
                # rows first: row proposals star-collapse most components,
                # after which the re-gate below kills the bulk of the col
                # proposals (they became same-label) before the exact
                # verify — ~2x less two-pointer work per round, and the
                # row/col duplicate pairs dedup themselves via the gate
                ri, rj = g[rp], row_p[rp].astype(np.int64)
                LP_STATS["proposals"] += len(ri)
                ki, kj, kd, ok_r = gated_verify_merge(
                    uf, csr, sizes64, ri, rj, threshold, kmer_size,
                    is_containment)
                kept_i.extend(ki.tolist())
                kept_j.extend(kj.tolist())
                kept_d.extend(kd.tolist())
                ci, cj = col_p[cp].astype(np.int64), g[cp]
                roots = uf.roots_array()
                alive = roots[ci] != roots[cj]
                ci, cj = ci[alive], cj[alive]
                LP_STATS["proposals"] += len(ci)
                ki, kj, kd, ok_c = gated_verify_merge(
                    uf, csr, sizes64, ci, cj, threshold, kmer_size,
                    is_containment)
                kept_i.extend(ki.tolist())
                kept_j.extend(kj.tolist())
                kept_d.extend(kd.tolist())
                # failed pairs -> clear-list for the next dispatch; a pair
                # can fail in BOTH batches (row and col proposed it and the
                # gate didn't kill it) — dedup, each bit clears at most once
                fi = np.concatenate([ri[~ok_r], ci[~ok_c]])
                fj = np.concatenate([rj[~ok_r], cj[~ok_c]])
                if len(fi):
                    _, sel = np.unique(fi * n_pad + fj, return_index=True)
                    fi, fj = fi[sel], fj[sel]
                clr = _encode_clear(fi, fj, rb, t_off)
                LP_STATS["verify_s"] += time.perf_counter() - t0
            if not converged:
                _lp_fallback(packs, panel, rb, n, uf, csr, sizes64,
                             threshold, kmer_size, is_containment, kept_i,
                             kept_j, kept_d)
            del packs  # free this panel's masks before the next build

    t0 = time.perf_counter()
    # kept edges are union-find-gated, so they already FORM a spanning
    # forest: kruskal would keep every one of them, and its only effect is
    # the (dist, i, j) sort order that clusters_from_forest's BFS adjacency
    # sees — sort_edges alone is identical and skips the Python UF loop
    forest = sort_edges((np.asarray(kept_i, dtype=np.int64),
                         np.asarray(kept_j, dtype=np.int64),
                         np.asarray(kept_d, dtype=np.float64)))
    out = clusters_from_forest(forest, n)
    LP_STATS["finish_s"] = time.perf_counter() - t0
    LP_STATS["total_s"] = time.perf_counter() - t_all
    return out


def _encode_clear(fi: np.ndarray, fj: np.ndarray, rb: int,
                  t_off: int = 0) -> Tuple[np.ndarray, ...]:
    """(t, row, byte, bit-value) clear-list arrays (ladder-padded) for
    failed pairs (i > j) in the triangular tile order of the build sweep.
    ``t_off`` rebases the global triangular tile index onto the current
    panel's local pack index (proposals only ever come from panel tiles)."""
    cap = _clear_quantum(len(fi))
    t = np.zeros(cap, dtype=np.int32)
    r = np.zeros(cap, dtype=np.int32)
    b = np.zeros(cap, dtype=np.int32)
    sub = np.zeros(cap, dtype=np.uint8)
    if len(fi):
        rblk = fi // rb
        cblk = fj // rb
        t[:len(fi)] = (rblk * (rblk + 1) // 2 + cblk - t_off).astype(
            np.int32)
        if t[:len(fi)].min() < 0:
            # A negative tile index would wrap through int32 inside the
            # device scatter and silently corrupt another panel's mask —
            # fail loudly instead (and survive ``python -O``, which strips
            # bare asserts).
            raise RuntimeError(
                "labelprop clear target outside current panel "
                f"(min rebased tile {int(t[:len(fi)].min())}, t_off={t_off})")
        r[:len(fi)] = (fi % rb).astype(np.int32)
        jl = fj % rb
        b[:len(fi)] = (jl // 8).astype(np.int32)
        sub[:len(fi)] = (1 << (jl % 8)).astype(np.uint8)
    return t, r, b, sub


def _lp_fallback(packs, tiles, rb, n, uf, csr, sizes64, threshold,
                 kmer_size, is_containment, kept_i, kept_j, kept_d):
    """Exact termination for pathological inputs that exhaust max_rounds:
    pull the remaining resident masks once and finish with the
    union-find-gated host verifier (ops.cluster_fast semantics)."""
    from .cluster_fast import _gated_verify_block

    packs_np = np.asarray(packs)
    bm._account_pull(packs_np.nbytes)
    roots = uf.roots_array()
    for t, (r0, c0) in enumerate(tiles):
        bits2d = np.unpackbits(packs_np[t], axis=1, bitorder="little")
        il, jl = np.nonzero(bits2d)
        ii = il.astype(np.int64) + r0
        jj = jl.astype(np.int64) + c0
        inb = (ii < n) & (jj < n)
        ii, jj = ii[inb], jj[inb]
        keep = roots[ii] != roots[jj]
        _gated_verify_block(uf, csr, sizes64, ii[keep], jj[keep], threshold,
                            kmer_size, is_containment, kept_i, kept_j,
                            kept_d)
        roots = uf.roots_array()
