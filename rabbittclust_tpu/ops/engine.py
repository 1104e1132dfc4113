"""Device MST engine: tiled exact pair counts -> host streaming Kruskal.

Semantics identical to cluster.mst.compute_mst (edges for every pair with
common >= 1 passing the size-ratio filter), but the O(N^2) intersection
counting runs on the GPU.  Per-tile candidate edges are reduced by the same
streaming Kruskal — the partition-MST theorem (MST of edge-partition MSTs
== global MST) guarantees exactness.

Two pull modes (``pull`` / RTC_MST_PULL):

* "compact" (default): square-tile batched sweep.  One dispatch filters a
  batch of tiles (exact pair counts, the Triton kernel on a GPU ->
  candidate mask -> count + bit-packed mask); the host pulls the tiny
  per-tile counts, then only the packed masks of nonempty tiles (rb^2/8 bytes/tile), decodes the surviving
  pairs natively, and a second dispatch gathers the exact common counts for
  JUST those pairs from the resident packed planes (O(W^2 K) per pair — a
  density-fraction of the tile recompute).  Pulled bytes scale with
  candidates + N^2/64 instead of 2*N^2 — ~an order of magnitude less than
  the full-counts mode at real densities.  Mirrors the reference's sparse
  accumulation (MST.cpp:399-487 never materializes dense counts either).
* "full": legacy row-panel sweep pulling whole (gi x nc) count tiles
  (uint16 when every sketch fits) — kept for A/B measurement.
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional

import numpy as np

from ..cluster.mst import (
    DENSE_SPAN,
    Edges,
    MstResult,
    concat_edges,
    kruskal,
)
from ..distance.mash import aaf_distance, mash_distance, size_ratio_limit
from .pack import pack_sketches
from .intersect import (pair_counts_jnp, pair_counts_row,
                        pair_counts_triton, pick_pair_kernel)


def _tile_counts(a0, b0, a1, b1, backend: str):
    """Exact pair counts for one (rb x rb) tile of resident packed planes
    (``backend`` "triton" | "jnp", see intersect.pick_pair_kernel)."""
    if backend == "triton":
        return pair_counts_triton(a0, b0, a1, b1)
    return pair_counts_jnp(a0, b0, a1, b1)


def _mst_batch_fn(p0, p1, sizes, r0s, c0s, valid, radio, start_index, n,
                  two_plane, backend, rb):
    """One dispatch: exact counts + candidate mask for a batch of (rb x rb)
    pair tiles; returns (per-tile candidate counts, bit-packed masks).
    Counts are NOT kept — survivors' exact values come from the cheap
    per-pair gather program (_pair_common_fn)."""
    import jax
    import jax.numpy as jnp

    w, k = p0.shape[1], p0.shape[2]

    def tile(r0, c0):
        a0 = jax.lax.dynamic_slice(p0, (r0, 0, 0), (rb, w, k))
        b0 = jax.lax.dynamic_slice(p0, (c0, 0, 0), (rb, w, k))
        a1 = b1 = None
        if two_plane:
            a1 = jax.lax.dynamic_slice(p1, (r0, 0, 0), (rb, w, k))
            b1 = jax.lax.dynamic_slice(p1, (c0, 0, 0), (rb, w, k))
        counts = _tile_counts(a0, b0, a1, b1, backend)
        si = jax.lax.dynamic_slice(sizes, (r0,), (rb,))
        sj = jax.lax.dynamic_slice(sizes, (c0,), (rb,))
        mn = jnp.minimum(si[:, None], sj[None, :])
        mx = jnp.maximum(si[:, None], sj[None, :])
        ratio_ok = (mn > 0) & (mx <= radio * mn)
        iidx = jax.lax.broadcasted_iota(jnp.int32, (rb, rb), 0) + r0
        jidx = jax.lax.broadcasted_iota(jnp.int32, (rb, rb), 1) + c0
        m = (counts > 0) & ratio_ok & (jidx < iidx) & (iidx < n) \
            & (iidx >= start_index)
        cnt = jnp.sum(m, dtype=jnp.int32)
        from .bitmap import pack_mask_u8
        return cnt, pack_mask_u8(m)

    def body(_, xs):
        r0, c0, ok = xs
        cnt, packed = jax.lax.cond(
            ok > 0, lambda: tile(r0, c0),
            lambda: (jnp.int32(0), jnp.zeros((rb, rb // 8), jnp.uint8)))
        return 0, (cnt, packed)

    _, (cnts, packs) = jax.lax.scan(body, 0, (r0s, c0s, valid))
    return cnts, packs


@functools.lru_cache(maxsize=1)
def _jitted_mst_batch():
    import jax
    return jax.jit(_mst_batch_fn,
                   static_argnames=("two_plane", "backend", "rb"))


def _pair_common_fn(p0, p1, ii, jj, two_plane, chunk):
    """Exact common counts for explicit pairs from the resident packed
    planes: (q,) int32.  Chunked scan keeps the (chunk, W, W, K) compare
    intermediate small."""
    import jax
    import jax.numpy as jnp

    q = ii.shape[0]
    n_chunks = q // chunk

    def body(_, xs):
        ic, jc = xs
        a0 = jnp.take(p0, ic, axis=0)
        b0 = jnp.take(p0, jc, axis=0)
        eq = a0[:, :, None, :] == b0[:, None, :, :]
        if two_plane:
            a1 = jnp.take(p1, ic, axis=0)
            b1 = jnp.take(p1, jc, axis=0)
            eq &= a1[:, :, None, :] == b1[:, None, :, :]
        return 0, jnp.sum(eq, axis=(1, 2, 3), dtype=jnp.int32)

    _, vals = jax.lax.scan(
        body, 0, (ii.reshape(n_chunks, chunk), jj.reshape(n_chunks, chunk)))
    return vals.reshape(-1)


@functools.lru_cache(maxsize=1)
def _jitted_pair_common():
    import jax
    return jax.jit(_pair_common_fn, static_argnames=("two_plane", "chunk"))


def _quantum(count: int, floor: int = 1 << 13) -> int:
    """Shared doubling ladder (one source of truth in ops.bitmap)."""
    from .bitmap import _quantum as bm_quantum
    return bm_quantum(count, floor)


def compute_mst_device(
    hashes: List[np.ndarray],
    threshold: float,
    kmer_size: int,
    is_containment: bool = False,
    with_dense: bool = False,
    start_index: int = 0,
    pre_edges: Optional[Edges] = None,
    row_tile: int = 256,
    col_tile: int = 128,
    backend: str = "auto",
    pull: str = "auto",
) -> MstResult:
    n = len(hashes)
    if n < 2:
        return MstResult(mst=(np.empty(0, np.int64), np.empty(0, np.int64),
                              np.empty(0, np.float64)), n=n,
                         dense=np.zeros((DENSE_SPAN, n), np.int64)
                         if with_dense else None,
                         ani=np.zeros(101, np.int64) if with_dense else None)
    pull = os.environ.get("RTC_MST_PULL", pull)
    if pull == "auto":
        pull = "compact"
    if pull == "compact":
        return _compute_mst_device_compact(
            hashes, threshold, kmer_size, is_containment=is_containment,
            with_dense=with_dense, start_index=start_index,
            pre_edges=pre_edges, backend=backend)
    return _compute_mst_device_full(
        hashes, threshold, kmer_size, is_containment=is_containment,
        with_dense=with_dense, start_index=start_index, pre_edges=pre_edges,
        row_tile=row_tile, col_tile=col_tile)


def _edges_from_pairs(ii, jj, common, sizes, threshold, kmer_size,
                      is_containment, with_dense, dense, ani, radii):
    s0 = sizes[ii]
    s1 = sizes[jj]
    if is_containment:
        d = aaf_distance(common, s0, s1, kmer_size)
    else:
        d = mash_distance(common, s0, s1, kmer_size)
    if with_dense:
        t0 = np.searchsorted(radii, d, side="left")
        inb = t0 < DENSE_SPAN
        np.add.at(dense, (t0[inb], ii[inb]), 1)
        np.add.at(dense, (t0[inb], jj[inb]), 1)
        a = np.minimum(((1.0 - d) * 100.0).astype(np.int64), 100)
        np.add.at(ani, a, 1)
    return d


def _compute_mst_device_compact(hashes, threshold, kmer_size,
                                is_containment, with_dense, start_index,
                                pre_edges, backend, row_block: int = 4096,
                                batch_k: int = 8):
    import jax
    import jax.numpy as jnp
    from ..utils.jaxcfg import configure_jax
    from . import bitmap as bm
    configure_jax()

    n = len(hashes)
    use64 = hashes[0].dtype == np.uint64
    rb = min(row_block, max(128, 1 << max(n - 1, 1).bit_length()))
    packed = pack_sketches(hashes, use64, pad_n_to=rb)
    sizes = packed.sizes.astype(np.int64)
    radio = size_ratio_limit(threshold, kmer_size - 1)
    if int(sizes[:n].max(initial=0)) * radio >= (1 << 31):
        raise ValueError("sketch sizes too large for int32 device ratio "
                         "filter; use the host engine")
    n_pad = packed.n
    if backend == "auto":
        backend = pick_pair_kernel(jax.default_backend(), rb, rb, packed.k)

    dense = np.zeros((DENSE_SPAN, n), dtype=np.int64) if with_dense else None
    ani = np.zeros(101, dtype=np.int64) if with_dense else None
    radii = np.arange(DENSE_SPAN) / DENSE_SPAN

    p0 = jnp.asarray(packed.plane0)
    p1 = jnp.asarray(packed.plane1) if use64 else p0[:1]
    sz = jnp.asarray(packed.sizes)
    batch_prog = _jitted_mst_batch()
    pair_prog = _jitted_pair_common()

    # triangular square-tile sweep; append mode skips tiles fully below
    # start_index (mask handles partial tiles)
    tiles = [(r0, c0) for r0 in range(0, n_pad, rb)
             for c0 in range(0, r0 + rb, rb) if r0 + rb > start_index]
    batches = [tiles[b:b + batch_k] for b in range(0, len(tiles), batch_k)]

    def dispatch(batch):
        r0s = np.zeros(batch_k, dtype=np.int32)
        c0s = np.zeros(batch_k, dtype=np.int32)
        val = np.zeros(batch_k, dtype=np.int32)
        for t, (r0, c0) in enumerate(batch):
            r0s[t], c0s[t], val[t] = r0, c0, 1
        cnts, packs = batch_prog(p0, p1, sz, jnp.asarray(r0s),
                                 jnp.asarray(c0s), jnp.asarray(val),
                                 jnp.int32(radio), jnp.int32(start_index),
                                 jnp.int32(n), use64, backend, rb)
        try:
            cnts.copy_to_host_async()
        except Exception:
            pass
        return cnts, packs, r0s, c0s, len(batch)

    partial: List[Edges] = []
    if pre_edges is not None and len(pre_edges[0]):
        partial.append(pre_edges)
    budget = 0

    from ..utils.profiling import maybe_trace
    with maybe_trace("dense_mst_device_compact"):
        pending = dispatch(batches[0]) if batches else None
        for b, batch in enumerate(batches):
            cnts_dev, packs_dev, r0s, c0s, n_valid = pending
            cnts = np.asarray(cnts_dev)
            bm._account_pull(4 * batch_k)
            sel = [t for t in range(n_valid) if cnts[t]]
            packs_pull = (packs_dev[jnp.asarray(sel, dtype=np.int32)]
                          if sel else None)
            if b + 1 < len(batches):
                pending = dispatch(batches[b + 1])
            if not sel:
                continue
            packs = np.ascontiguousarray(np.asarray(packs_pull))
            bm._account_pull(packs.nbytes)
            ii_all, jj_all = [], []
            for s_i, t in enumerate(sel):
                ti, tj = bm._decode_packed_mask(
                    packs[s_i], rb, int(r0s[t]), int(c0s[t]), n,
                    int(cnts[t]))
                ii_all.append(ti)
                jj_all.append(tj)
            ii = np.concatenate(ii_all)
            jj = np.concatenate(jj_all)
            # exact common values for the survivors only: pad to a ladder
            # quantum, gather-count on device, pull the prefix
            q = _quantum(len(ii))
            iq = np.zeros(q, dtype=np.int32)
            jq = np.zeros(q, dtype=np.int32)
            iq[:len(ii)] = ii
            jq[:len(jj)] = jj
            vals_dev = pair_prog(p0, p1, jnp.asarray(iq), jnp.asarray(jq),
                                 use64, min(q, 2048))
            common = np.asarray(vals_dev)[:len(ii)].astype(np.int64)
            bm._account_pull(4 * q)
            d = _edges_from_pairs(ii, jj, common, sizes, threshold,
                                  kmer_size, is_containment, with_dense,
                                  dense, ani, radii)
            partial.append((ii.astype(np.int64), jj.astype(np.int64), d))
            budget += len(ii)
            if budget > 4 * n:
                partial = [kruskal(concat_edges(partial), n)]
                budget = len(partial[0][0])

    mst = kruskal(concat_edges(partial), n)
    if with_dense:
        dense = np.cumsum(dense, axis=0)
    return MstResult(mst=mst, n=n, dense=dense, ani=ani)


def _compute_mst_device_full(
    hashes: List[np.ndarray],
    threshold: float,
    kmer_size: int,
    is_containment: bool = False,
    with_dense: bool = False,
    start_index: int = 0,
    pre_edges: Optional[Edges] = None,
    row_tile: int = 256,
    col_tile: int = 128,
) -> MstResult:
    n = len(hashes)
    use64 = hashes[0].dtype == np.uint64
    packed = pack_sketches(hashes, use64, pad_n_to=col_tile)
    sizes = packed.sizes.astype(np.int64)
    radio = size_ratio_limit(threshold, kmer_size - 1)

    dense = np.zeros((DENSE_SPAN, n), dtype=np.int64) if with_dense else None
    ani = np.zeros(101, dtype=np.int64) if with_dense else None
    radii = np.arange(DENSE_SPAN) / DENSE_SPAN

    partial: List[Edges] = []
    if pre_edges is not None and len(pre_edges[0]):
        partial.append(pre_edges)
    budget = 0

    n_pad = packed.n
    first_row = (start_index // row_tile) * row_tile
    row_starts = list(range(first_row, n_pad, row_tile))

    # counts never exceed the smaller sketch size, so when every sketch is
    # < 2^16 the count tiles pull losslessly as uint16 — halves the
    # dominant (gi x N) transfer (sketches that large need >256 Mb
    # genomes at drlevel 3; int32 stays for that corner)
    u16_ok = int(sizes[:n].max(initial=0)) < (1 << 16)

    def dispatch(i0):
        gi = min(row_tile, n_pad - i0)
        # triangular column trim: only pairs j < i are kept, so this row
        # panel needs columns [0, i0+gi) only — padded to a power of two
        # (multiple of col_tile) to keep compiled shapes logarithmic in N.
        # Halves both the device compute and the dominant (gi x N) int32
        # count pulls across the run.
        pow2 = 1 << (i0 + gi - 1).bit_length()
        nc = min(n_pad, max(col_tile, -(-pow2 // col_tile) * col_tile))
        c = pair_counts_row(packed.row_block(i0, gi),
                            packed.row_block(0, nc), gj_tile=col_tile)
        if u16_ok:
            import jax.numpy as jnp
            c = c.astype(jnp.uint16)
        return c

    from ..utils.profiling import maybe_trace
    with maybe_trace("dense_mst_device"):
        # one-tile async prefetch: the device computes tile t+1 while the
        # host extracts edges / runs the streaming Kruskal for tile t
        pending = dispatch(row_starts[0]) if row_starts else None
        for t, i0 in enumerate(row_starts):
            fut = pending
            if t + 1 < len(row_starts):
                pending = dispatch(row_starts[t + 1])
            counts = np.asarray(fut)
            # host-side edge extraction for this row block
            # pair (i, j) kept once with i > j; append mode keeps only i >= start
            ii_local, jj = np.nonzero(counts)
            ii = ii_local + i0
            keep = (jj < ii) & (ii < n) & (ii >= start_index)
            ii, jj = ii[keep], jj[keep]
            if len(ii) == 0:
                continue
            common = counts[ii - i0, jj].astype(np.int64)
            s0 = sizes[ii]
            s1 = sizes[jj]
            mn = np.minimum(s0, s1)
            mx = np.maximum(s0, s1)
            ok = (mn > 0) & (mx <= radio * mn)
            ii, jj, common = ii[ok], jj[ok], common[ok]
            if len(ii) == 0:
                continue
            d = _edges_from_pairs(ii, jj, common, sizes, threshold,
                                  kmer_size, is_containment, with_dense,
                                  dense, ani, radii)
            partial.append((ii.astype(np.int64), jj.astype(np.int64), d))
            budget += len(ii)
            if budget > 4 * n:
                partial = [kruskal(concat_edges(partial), n)]
                budget = len(partial[0][0])

    mst = kruskal(concat_edges(partial), n)
    if with_dense:
        dense = np.cumsum(dense, axis=0)
    return MstResult(mst=mst, n=n, dense=dense, ani=ani)
