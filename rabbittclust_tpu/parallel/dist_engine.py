"""Multi-card distance engine — mesh-sharded pair tiles over the
interconnect.

Design (SURVEY.md §2.14/§5: the reference is single-node OpenMP only; the
distributed layer is new):

  * genomes are sharded row-block data-parallel over a 1-D device mesh
    ("data" axis); every device holds its packed sketch shard;
  * pairwise tiles are computed ring-style: at step t each device compares
    its resident rows against the visiting column shard, then forwards the
    visiting shard to its ring neighbor with ``jax.lax.ppermute``
    (interconnect traffic only, no host gathers; on NVLink every card
    reaches every other at the same rate, so a flat 1-D mesh fits);
  * per-shard candidate edges are reduced locally (streaming Kruskal on the
    host per shard) and merged into the global MST by the driver — exact by
    the edge-partition MST theorem.

``ring_pair_step`` is the jittable one-step unit the dry-run compiles over
an N-device mesh; ``distributed_candidate_counts`` runs the full ring.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np


def make_mesh(n_devices: Optional[int] = None):
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), axis_names=("data",))


def _counts_block(a0, b0, a1=None, b1=None):
    """(GI, W, K) x (GJ, W, K) -> (GI, GJ) int32 exact counts: the Triton
    kernel on a GPU when the shard shapes tile, else the jnp reference."""
    import jax
    from ..ops.intersect import (pair_counts_jnp, pair_counts_triton,
                                 pick_pair_kernel)

    if pick_pair_kernel(jax.default_backend(), a0.shape[0], b0.shape[0],
                        a0.shape[2]) == "triton":
        return pair_counts_triton(a0, b0, a1, b1)
    return pair_counts_jnp(a0, b0, a1, b1)


def _shard_rows(mesh, *arrays):
    """Host arrays placed row-sharded over the mesh's "data" axis: each
    device receives only its own rows, nothing is staged whole on one
    device first."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P("data"))
    return tuple(jax.device_put(np.ascontiguousarray(a), sharding)
                 for a in arrays)


def _replicate(mesh, array):
    """A host array copied to every device of the mesh."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(np.ascontiguousarray(array),
                          NamedSharding(mesh, P()))


def _n_ring_steps(n_dev: int) -> int:
    """Triangular ring schedule length: floor(n_dev/2) + 1 steps instead of
    n_dev.  At step t every device compares its resident rows against shard
    (d - t) mod n_dev; the unordered shard pair {a, b} with
    (a - b) mod n_dev = t <= n_dev/2 is visited only by device a, so steps
    t in [1, ceil(n_dev/2)) run FULL tiles with no ownership discard.  Only
    the self tile (t=0) and, for even n_dev, the antipodal tile
    (t = n_dev/2, computed by both endpoints) need the global i > j mask.
    Halves the ring's device FLOPs vs the n_dev-step schedule whose i > j
    mask threw away ~50% of every tile."""
    return n_dev // 2 + 1


def _ownership_mask(t, n_dev, row_ids, vis_ids):
    """Per-step pair-ownership mask for the triangular schedule (see
    _n_ring_steps): full tile on interior steps, global i > j on the self
    and (even n_dev) antipodal steps."""
    import jax.numpy as jnp

    shared_step = (t == 0) | ((n_dev % 2 == 0) & (t == n_dev // 2))
    return (row_ids[:, None] > vis_ids[None, :]) | ~shared_step


def build_ring_fn(threshold: float, kmer_size: int, radio: int):
    """Returns a shard_map-able function: local row shard + ring rotation ->
    (local candidate-edge count, local min distance, thresholded counts)."""
    import jax
    import jax.numpy as jnp

    def ring_fn(rows0, sizes, row_ids):
        """Executes per device under shard_map.

        rows0: (L, W, K) local packed shard;  sizes: (L,) sketch sizes;
        row_ids: (L,) global genome ids of local rows.
        """
        n_dev = jax.lax.axis_size("data")

        def step(t, carry):
            visiting0, vis_sizes, vis_ids, n_cand, min_d = carry
            counts = _counts_block(rows0, visiting0)
            s0 = sizes[:, None].astype(jnp.float32)
            s1 = vis_sizes[None, :].astype(jnp.float32)
            mn = jnp.minimum(s0, s1)
            mx = jnp.maximum(s0, s1)
            ok = (counts > 0) & (mn > 0)
            if radio:  # 0 = no size-ratio gate (see build_ring_bitmap_fn)
                ok &= (mx <= radio * mn)
            # triangular schedule: each unordered pair lands on one device
            ok &= _ownership_mask(t, n_dev, row_ids, vis_ids)
            common = counts.astype(jnp.float32)
            denom = s0 + s1 - common
            j = jnp.where(denom > 0, common / jnp.maximum(denom, 1.0), 0.0)
            d = jnp.where(
                j >= 1.0, 0.0,
                jnp.where(j <= 0.0, 1.0,
                          -(1.0 / kmer_size) * jnp.log(
                              2.0 * j / (1.0 + j))))
            n_cand = n_cand + jnp.sum(ok & (d <= threshold),
                                      dtype=jnp.int32)
            min_d = jnp.minimum(min_d, jnp.min(jnp.where(ok, d, 1.0)))
            # rotate the visiting shard around the ring
            perm = [(k, (k + 1) % n_dev) for k in range(n_dev)]
            visiting0 = jax.lax.ppermute(visiting0, "data", perm)
            vis_sizes = jax.lax.ppermute(vis_sizes, "data", perm)
            vis_ids = jax.lax.ppermute(vis_ids, "data", perm)
            return visiting0, vis_sizes, vis_ids, n_cand, min_d

        init = (rows0, sizes, row_ids, jnp.int32(0), jnp.float32(1.0))
        _, _, _, n_cand, min_d = jax.lax.fori_loop(
            0, _n_ring_steps(n_dev), step, init)
        total = jax.lax.psum(n_cand, "data")
        global_min = jax.lax.pmin(min_d, "data")
        return total, global_min

    return ring_fn


def distributed_candidate_stats(packed_plane0: np.ndarray,
                                sizes: np.ndarray,
                                threshold: float, kmer_size: int,
                                mesh=None) -> Tuple[int, float]:
    """Run the full ring over a mesh; returns (# pairs with dist <=
    threshold, min pair distance).  Demonstrates/validates the multi-chip
    sharded path; exact edge extraction reuses the same tiles."""
    import jax
    from jax.sharding import PartitionSpec as P
    from ..distance.mash import size_ratio_limit

    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.devices.size
    n = packed_plane0.shape[0]
    if n % n_dev != 0:
        raise ValueError(
            f"packed rows ({n}) must be a multiple of the mesh size "
            f"({n_dev}); pad with pack_sketches(pad_n_to=n_dev)")
    radio = size_ratio_limit(threshold, kmer_size - 1)
    ring_fn = build_ring_fn(threshold, kmer_size, radio)

    fn = jax.shard_map(
        ring_fn, mesh=mesh,
        in_specs=(P("data"), P("data"), P("data")),
        out_specs=(P(), P()),
        check_vma=False,
    )
    row_ids = np.arange(n, dtype=np.int32)
    total, min_d = jax.jit(fn)(*_shard_rows(
        mesh, packed_plane0, sizes.astype(np.int32), row_ids))
    return int(np.asarray(total)), float(np.asarray(min_d))


def build_ring_edges_fn(threshold: float, kmer_size: int, radio: int,
                        cap: int, two_plane: bool = False):
    """shard_map-able ring that EXTRACTS candidate edges exactly.

    Each device emits, per ring step, a fused int32 block
    [count, local_i*N_total + j (cap entries), common (cap entries)] for
    pairs (global_i > global_j) passing the candidate + size-ratio filters.
    Counts are exact (bucket-packed compare), so the host computes float64
    distances from them directly and merges per-shard partial MSTs.
    ``two_plane`` handles 64-bit KSSD hashes (plane0/plane1 both rotate
    around the ring)."""
    import jax
    import jax.numpy as jnp

    def ring_fn(rows0, rows1, sizes, row_ids):
        n_dev = jax.lax.axis_size("data")

        def step(carry, t):
            visiting0, visiting1, vis_sizes, vis_ids = carry
            if two_plane:
                counts = _counts_block(rows0, visiting0, rows1, visiting1)
            else:
                counts = _counts_block(rows0, visiting0)
            s0 = sizes[:, None]
            s1 = vis_sizes[None, :]
            mn = jnp.minimum(s0, s1)
            mx = jnp.maximum(s0, s1)
            ok = (counts > 0) & (mn > 0)
            if radio:  # 0 = no size-ratio gate (see build_ring_bitmap_fn)
                ok &= (mx <= radio * mn)
            ok &= _ownership_mask(t, n_dev, row_ids, vis_ids)
            # two-level compaction (see ops.bitmap): safe because the host
            # regrows whenever cnt > cap, and chunks_hit <= cnt <= cap
            from ..ops.bitmap import compact_mask_two_level
            cnt, flat = compact_mask_two_level(ok, cap, cap)
            li = flat // counts.shape[1]
            vj = flat % counts.shape[1]
            gid_i = jnp.where(flat >= 0, jnp.take(row_ids, li), -1)
            gid_j = jnp.where(flat >= 0, jnp.take(vis_ids, vj), -1)
            common = jnp.where(
                flat >= 0,
                jnp.take(counts.reshape(-1), jnp.maximum(flat, 0)), 0)
            perm = [(k, (k + 1) % n_dev) for k in range(n_dev)]
            visiting0 = jax.lax.ppermute(visiting0, "data", perm)
            if two_plane:
                visiting1 = jax.lax.ppermute(visiting1, "data", perm)
            vis_sizes = jax.lax.ppermute(vis_sizes, "data", perm)
            vis_ids = jax.lax.ppermute(vis_ids, "data", perm)
            fused = jnp.concatenate(
                [cnt[None], gid_i, gid_j, common.astype(jnp.int32)])
            return (visiting0, visiting1, vis_sizes, vis_ids), fused

        init = (rows0, rows1, sizes, row_ids)
        n_steps = _n_ring_steps(n_dev)
        _, out = jax.lax.scan(step, init,
                              jnp.arange(n_steps, dtype=jnp.int32))
        return out  # (n_steps, 1 + 3*cap)

    return ring_fn


def distributed_candidate_edges(packed_plane0: np.ndarray,
                                sizes: np.ndarray, threshold: float,
                                kmer_size: int, mesh=None,
                                cap: Optional[int] = None,
                                radio: Optional[int] = None,
                                packed_plane1: Optional[np.ndarray] = None):
    """Exact candidate edges (i, j, common) across the mesh, every pair
    covered exactly once (pair ownership: global_i > global_j).

    ``radio`` overrides the size-ratio prefilter; default (None) is the
    reference's int-truncated MST prefilter (size_ratio_limit with k-1).
    Callers whose downstream filter differs (e.g. the Leiden graph's ratio
    >= 0.5) pass a safe superset bound instead; ``radio=0`` disables the
    gate entirely (containment criteria are ratio-free).  ``packed_plane1``
    enables 64-bit KSSD hashes (two uint32 planes per slot)."""
    import jax
    from jax.sharding import PartitionSpec as P
    from ..distance.mash import size_ratio_limit

    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.devices.size
    n = packed_plane0.shape[0]
    if n % n_dev != 0:
        raise ValueError(
            f"packed rows ({n}) must be a multiple of the mesh size "
            f"({n_dev}); pad with pack_sketches(pad_n_to=n_dev)")
    if radio is None:
        radio = size_ratio_limit(threshold, kmer_size - 1)
    if cap is None:
        # one sixteenth of a step's pairs, as the bitmap ring: clustered
        # corpora share hashes within clusters, and every overflow re-runs
        # the whole ring
        shard = n // n_dev
        cap = max(4096, min(shard * shard // 16, 1 << 24))
    two = packed_plane1 is not None
    row_ids = np.arange(n, dtype=np.int32)
    plane1 = packed_plane1 if two else packed_plane0[:, :1, :1]
    args = _shard_rows(mesh, packed_plane0, plane1, sizes.astype(np.int32),
                       row_ids)
    while True:
        ring_fn = build_ring_edges_fn(threshold, kmer_size, radio, cap,
                                      two_plane=two)
        fn = jax.shard_map(
            ring_fn, mesh=mesh,
            in_specs=(P("data"), P("data"), P("data"), P("data")),
            out_specs=P("data"), check_vma=False)
        out = np.asarray(jax.jit(fn)(*args))
        # out: (n_dev * n_steps, 1 + 3*cap); decode every block
        blocks = out.reshape(-1, 1 + 3 * cap)
        max_cnt = int(blocks[:, 0].max()) if len(blocks) else 0
        if max_cnt <= cap:
            break
        # auto-regrow (mirrors ops/bitmap.py): re-run the ring with a
        # buffer big enough for the densest step
        while cap < max_cnt:
            cap *= 4
    ii_all, jj_all, cc_all = [], [], []
    for block in blocks:
        cnt = int(block[0])
        if cnt:
            ii_all.append(block[1:1 + cnt].astype(np.int64))
            jj_all.append(block[1 + cap:1 + cap + cnt].astype(np.int64))
            cc_all.append(block[1 + 2 * cap:1 + 2 * cap + cnt].astype(np.int64))
    if not ii_all:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy(), e.copy()
    ii = np.concatenate(ii_all)
    jj = np.concatenate(jj_all)
    # canonical host orientation (i > j) — see the bitmap ring decode
    return (np.maximum(ii, jj), np.minimum(ii, jj), np.concatenate(cc_all))


def build_ring_bitmap_fn(cap: int, jmin_num: float, jmin_den: float,
                         c_min: float, radio: int, is_containment: bool):
    """shard_map-able bitmap-filter ring — the distributed twin of
    ops.bitmap._filter_block_fn.

    Each device keeps its row shard's bit-packed signatures resident
    (unpacked to 0/1 bf16 once) and rotates the visiting shard's PACKED
    uint8 signatures (+ collisions/sizes/ids) around the ring — 16x less
    interconnect traffic than bf16; shared-bit counts come from ONE bf16
    matmul on the tensor cores (bits MACs/pair, exact: 0/1 products, f32
    accumulation) instead of the exact ring's O(W^2 K) bucket compares.
    The same deterministic no-false-negative bound as the
    single-chip filter (shared >= common_min - min(collisions)) gates the
    candidates; survivors are verified exactly on the host."""
    import jax
    import jax.numpy as jnp
    from ..ops.bitmap import _unpack_bits_device

    def ring_fn(xp, coll, sizes, row_ids):
        n_dev = jax.lax.axis_size("data")
        rows_bits = _unpack_bits_device(xp)  # resident rows, unpacked once

        def step(carry, t):
            vxp, vcoll, vsizes, vis_ids = carry
            vbits = _unpack_bits_device(vxp)
            shared = jax.lax.dot_general(
                rows_bits, vbits, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32).astype(jnp.int32)
            si_c = sizes[:, None].astype(jnp.float32)
            s_c = vsizes[None, :].astype(jnp.float32)
            # f32 bound with -1 safety margin: must never exceed the exact
            # f64 ceil the host uses (see ops/bitmap.py:_filter_block_fn)
            if is_containment:
                common_min = jnp.floor(
                    c_min * jnp.minimum(si_c, s_c)).astype(jnp.int32) - 1
            else:
                common_min = jnp.floor(
                    jmin_num * (si_c + s_c) / jmin_den).astype(jnp.int32) - 1
            thresh = common_min - jnp.minimum(coll[:, None], vcoll[None, :])
            mni = jnp.minimum(sizes[:, None], vsizes[None, :])
            mxi = jnp.maximum(sizes[:, None], vsizes[None, :])
            ok = (shared >= thresh) & (mni > 0)
            if radio:  # radio == 0 disables the size-ratio gate (static):
                # containment jaccard (common/min) implies NO ratio bound,
                # so containment callers pass 0 — see multihost_dbscan
                ok &= (mxi <= radio * mni)
            ok &= _ownership_mask(t, n_dev, row_ids, vis_ids)
            # two-level compaction (see ops.bitmap): safe because the host
            # regrows whenever cnt > cap, and chunks_hit <= cnt <= cap
            from ..ops.bitmap import compact_mask_two_level
            cnt, flat = compact_mask_two_level(ok, cap, cap)
            li = flat // ok.shape[1]
            vj = flat % ok.shape[1]
            gid_i = jnp.where(flat >= 0, jnp.take(row_ids, li), -1)
            gid_j = jnp.where(flat >= 0, jnp.take(vis_ids, vj), -1)
            perm = [(k, (k + 1) % n_dev) for k in range(n_dev)]
            vxp = jax.lax.ppermute(vxp, "data", perm)
            vcoll = jax.lax.ppermute(vcoll, "data", perm)
            vsizes = jax.lax.ppermute(vsizes, "data", perm)
            vis_ids = jax.lax.ppermute(vis_ids, "data", perm)
            fused = jnp.concatenate([cnt[None], gid_i, gid_j])
            return (vxp, vcoll, vsizes, vis_ids), fused

        init = (xp, coll, sizes, row_ids)
        _, out = jax.lax.scan(
            step, init, jnp.arange(_n_ring_steps(n_dev), dtype=jnp.int32))
        return out  # (n_steps, 1 + 2*cap)

    return ring_fn


def distributed_candidate_pairs_bitmap(hashes, threshold: float,
                                       kmer_size: int,
                                       is_containment: bool = False,
                                       mesh=None, bits: int = 8192,
                                       cap: Optional[int] = None,
                                       radio: Optional[int] = None):
    """bitmap-filter candidates (i > j, unverified) over a device mesh.

    The distributed counterpart of ops.bitmap.candidate_pair_blocks: no
    false negatives for pairs reachable at distance <= threshold (and
    passing the size-ratio prefilter), so downstream exact verification
    reproduces host results bit-exactly.  Signatures are hash-based, so
    32- and 64-bit sketches share one plane.  The compacted-output cap
    auto-regrows (re-runs the ring 4x larger) on overflow."""
    import math
    import jax
    from jax.sharding import PartitionSpec as P
    from ..distance.mash import min_jaccard_for_threshold, size_ratio_limit
    from ..ops.bitmap import _pull_quantum, pack_bitmaps_packed

    if mesh is None:
        mesh = make_mesh()
    n_dev = int(mesh.devices.size)
    n = len(hashes)
    xp, coll = pack_bitmaps_packed(hashes, bits=bits, pad_n_to=n_dev)
    n_pad = xp.shape[0]
    sizes = np.zeros(n_pad, dtype=np.int32)
    sizes[:n] = [len(h) for h in hashes]
    j_min = min_jaccard_for_threshold(threshold, kmer_size)
    c_min = math.exp(-threshold * kmer_size)
    if radio is None:
        radio = size_ratio_limit(threshold, kmer_size - 1)
    row_ids = np.arange(n_pad, dtype=np.int32)
    shard = n_pad // n_dev
    if cap is None:
        cap = max(1 << 16, shard * shard // 16)
    args = _shard_rows(mesh, xp, coll, sizes, row_ids)
    while True:
        ring_fn = build_ring_bitmap_fn(cap, j_min, 1.0 + j_min, c_min,
                                       radio, is_containment)
        fn = jax.shard_map(
            ring_fn, mesh=mesh,
            in_specs=(P("data"), P("data"), P("data"), P("data")),
            out_specs=P("data"), check_vma=False)
        out_dev = jax.jit(fn)(*args)  # (n_dev*n_steps, 1 + 2*cap)
        # fused minimal pulls: counts column first (tiny), then one
        # quantized prefix of each id plane (never the full cap buffer)
        counts = np.asarray(out_dev[:, 0])
        max_cnt = int(counts.max()) if counts.size else 0
        if max_cnt <= cap:
            break
        while cap < max_cnt:
            cap *= 4  # auto-regrow, mirrors ops/bitmap.py
    if max_cnt == 0:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy()
    q = _pull_quantum(max_cnt, cap)
    gi = np.asarray(out_dev[:, 1:1 + q])
    gj = np.asarray(out_dev[:, 1 + cap:1 + cap + q])
    ii_all, jj_all = [], []
    for b in range(gi.shape[0]):
        c = int(counts[b])
        if c:
            ii_all.append(gi[b, :c])
            jj_all.append(gj[b, :c])
    ii = np.concatenate(ii_all).astype(np.int64)
    jj = np.concatenate(jj_all).astype(np.int64)
    # canonical host orientation (i > j): interior triangular-ring steps
    # emit row-id-first pairs where the row id may be the smaller one
    ii, jj = np.maximum(ii, jj), np.minimum(ii, jj)
    keep = (ii < n) & (jj < n)  # drop padded rows
    return ii[keep], jj[keep]


def distributed_mst(hashes, threshold: float, kmer_size: int,
                    is_containment: bool = False, mesh=None,
                    cap: Optional[int] = None, engine: str = "auto",
                    bits: int = 8192, full_mst: bool = False):
    """MST over a device mesh (edge-partition MST theorem).

    engine="auto" (default) mirrors cluster.mst.compute_mst(backend="auto"):
    it selects by USE — the fast "bitmap" ring when the MST only needs
    to be exact for cuts <= ``threshold`` (clustering / re-clustering at
    smaller d, the common case), and the full "exact" ring when
    ``full_mst=True`` (the MST will be persisted as edge.mst and re-cut at
    ARBITRARY thresholds, e.g. --premsted at a larger d).

    engine="exact": bucket-packed exact-count ring -> float64 distances on
    host -> Kruskal.  The candidate set is every pair with common >= 1
    passing the size-ratio prefilter — byte-equal to the host compute_mst /
    reference edge.mst, valid for cuts at ANY threshold.

    engine="bitmap": bitmap-filter ring (build_ring_bitmap_fn) + native
    exact verify — inherits the single-chip filter's speed.  The candidate
    bound is threshold-dependent, so the returned MST is exact for every
    cut <= threshold but may lack candidate edges above it."""
    from ..ops.pack import pack_sketches
    from ..cluster.mst import MstResult, kruskal
    from ..distance.mash import aaf_distance, mash_distance

    if mesh is None:
        mesh = make_mesh()
    if engine == "auto":
        engine = "exact" if full_mst else "bitmap"
    if engine == "bitmap":
        from ..ops.bitmap import CsrSketches

        n = len(hashes)
        ii, jj = distributed_candidate_pairs_bitmap(
            hashes, threshold, kmer_size, is_containment=is_containment,
            mesh=mesh, bits=bits)
        common = CsrSketches(hashes).count_common(ii, jj).astype(np.int64)
        nz = common > 0
        ii, jj, common = ii[nz], jj[nz], common[nz]
        s = np.array([len(h) for h in hashes], dtype=np.int64)
        if is_containment:
            d = aaf_distance(common, s[ii], s[jj], kmer_size)
        else:
            d = mash_distance(common, s[ii], s[jj], kmer_size)
        return MstResult(mst=kruskal((ii, jj, d), n), n=n)
    n_dev = int(mesh.devices.size)
    n = len(hashes)
    use64 = n > 0 and hashes[0].dtype == np.uint64
    pad = ((n + n_dev - 1) // n_dev) * n_dev
    packed = pack_sketches(hashes, use64, pad_n_to=max(pad, n_dev))
    np_pad = packed.plane0.shape[0]
    # re-pad rows to exactly pad (pack may round further; slice)
    plane0 = packed.plane0[:pad] if np_pad >= pad else packed.plane0
    plane1 = (None if packed.plane1 is None
              else packed.plane1[:plane0.shape[0]])
    sizes = packed.sizes[:plane0.shape[0]]
    ii, jj, common = distributed_candidate_edges(
        plane0, sizes, threshold, kmer_size, mesh=mesh, cap=cap,
        packed_plane1=plane1)
    keep = (ii < n) & (jj < n)
    ii, jj, common = ii[keep], jj[keep], common[keep]
    s = np.array([len(h) for h in hashes], dtype=np.int64)
    if is_containment:
        d = aaf_distance(common, s[ii], s[jj], kmer_size)
    else:
        d = mash_distance(common, s[ii], s[jj], kmer_size)
    mst = kruskal((ii, jj, d), n)
    return MstResult(mst=mst, n=n)


def _pack_rows_for_mesh(hashes, mesh):
    """Bucket-pack sketches (32- or 64-bit) with rows padded to a mesh
    multiple; returns (plane0, plane1-or-None, sizes)."""
    from ..ops.pack import pack_sketches

    n_dev = int(mesh.devices.size)
    n = len(hashes)
    use64 = n > 0 and hashes[0].dtype == np.uint64
    pad = ((n + n_dev - 1) // n_dev) * n_dev
    packed = pack_sketches(hashes, use64, pad_n_to=max(pad, n_dev))
    plane0 = packed.plane0[:pad] if packed.plane0.shape[0] >= pad \
        else packed.plane0
    plane1 = (None if packed.plane1 is None
              else packed.plane1[:plane0.shape[0]])
    return plane0, plane1, packed.sizes[:plane0.shape[0]]


def distributed_similarity_graph(hashes, threshold: float, kmer_size: int,
                                 mesh=None, cap: Optional[int] = None,
                                 bits: int = 8192):
    """Leiden similarity graph over the mesh: edge iff dist < threshold and
    size ratio >= 0.5, weight = 1 - dist (leiden.cpp:188-256 semantics).

    Identical edge set and float64 weights as
    cluster.leiden.build_similarity_graph (no kNN): the bitmap-filter
    ring produces a no-false-negative candidate superset (with a ratio
    prefilter that also covers the Leiden >= 0.5 window) and the exact
    filters run on the host from exact native counts."""
    import math
    from ..distance.mash import mash_distance
    from ..ops.bitmap import CsrSketches

    if mesh is None:
        mesh = make_mesh()
    n = len(hashes)
    # superset of both the Mash bound max <= min * (2e^{dk}-1) and the
    # Leiden ratio >= 0.5 window
    radio_safe = max(2, int(math.ceil(2.0 * math.exp(
        threshold * kmer_size))) + 1)
    ii, jj = distributed_candidate_pairs_bitmap(
        hashes, threshold, kmer_size, mesh=mesh, bits=bits, cap=cap,
        radio=radio_safe)
    common = CsrSketches(hashes).count_common(ii, jj).astype(np.int64)
    nz = common > 0
    ii, jj, common = ii[nz], jj[nz], common[nz]
    s = np.array([len(h) for h in hashes], dtype=np.int64)
    s0, s1 = s[ii], s[jj]
    ratio = np.minimum(s0, s1) / np.maximum(np.maximum(s0, s1), 1)
    d = np.clip(mash_distance(common, s0, s1, kmer_size), 0.0, 1.0)
    ok = (ratio >= 0.5) & (d < threshold)
    frm = np.minimum(ii[ok], jj[ok])
    to = np.maximum(ii[ok], jj[ok])
    return frm, to, 1.0 - d[ok]


def distributed_threshold_clusters(hashes, threshold: float, kmer_size: int,
                                   is_containment: bool = False, mesh=None,
                                   cap: Optional[int] = None,
                                   bits: int = 8192,
                                   engine: str = "bitmap"):
    """Exact single-linkage clusters at ``threshold`` over a device mesh
    (BFS-ordered like the reference MST cut).

    Default engine: bitmap-filter ring + union-find-gated native exact
    verify — the distributed twin of ops.cluster_fast.threshold_clusters_
    device, inheriting the single-chip engine's speed.  engine="exact"
    keeps the bucket-packed exact-count ring (slower, used for A/B)."""
    from ..cluster.mst import clusters_from_forest, cut_forest, kruskal

    if engine == "exact":
        res = distributed_mst(hashes, threshold, kmer_size,
                              is_containment=is_containment, mesh=mesh,
                              cap=cap, engine="exact")
        return clusters_from_forest(cut_forest(res.mst, threshold),
                                    len(hashes))
    from ..cluster.union_find import UnionFind
    from ..ops.bitmap import CsrSketches
    from ..ops.cluster_fast import _gated_verify_block

    n = len(hashes)
    if n == 0:
        return []
    ii, jj = distributed_candidate_pairs_bitmap(
        hashes, threshold, kmer_size, is_containment=is_containment,
        mesh=mesh, bits=bits, cap=cap)
    sizes = np.array([len(h) for h in hashes], dtype=np.int64)
    uf = UnionFind(n)
    csr = CsrSketches(hashes)
    kept_i: list = []
    kept_j: list = []
    kept_d: list = []
    _gated_verify_block(uf, csr, sizes, ii, jj, threshold, kmer_size,
                        is_containment, kept_i, kept_j, kept_d)
    forest = kruskal((np.asarray(kept_i, dtype=np.int64),
                      np.asarray(kept_j, dtype=np.int64),
                      np.asarray(kept_d, dtype=np.float64)), n)
    return clusters_from_forest(forest, n)


# ---------------------------------------------------------------------------
# Distributed label propagation — the bench headline engine on a mesh.
# Masks stay RESIDENT per device (the single-chip ops/labelprop.py design,
# sharded: each device holds its triangular-schedule mask slab, N^2/8/D
# bytes), Boruvka rounds pull O(N) proposals; collectives (ppermute for the
# build ring, pmin/psum for proposal merging) ride the interconnect.

def build_ring_masks_fn(jmin_num: float, jmin_den: float, c_min: float,
                        radio: int, is_containment: bool):
    """shard_map-able build: one ring sweep computing the RESIDENT packed
    candidate masks for the triangular schedule — per device a
    (n_steps, shard, shard//8) slab covering every unordered pair exactly
    once (ownership as _ownership_mask).  Same deterministic
    no-false-negative bound as build_ring_bitmap_fn."""
    import jax
    import jax.numpy as jnp
    from ..ops.bitmap import _unpack_bits_device, pack_mask_u8

    def fn(xp, coll, sizes, row_ids):
        n_dev = jax.lax.axis_size("data")
        rows_bits = _unpack_bits_device(xp)

        def step(carry, t):
            vxp, vcoll, vsizes, vis_ids = carry
            vbits = _unpack_bits_device(vxp)
            shared = jax.lax.dot_general(
                rows_bits, vbits, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32).astype(jnp.int32)
            si_c = sizes[:, None].astype(jnp.float32)
            s_c = vsizes[None, :].astype(jnp.float32)
            if is_containment:
                common_min = jnp.floor(
                    c_min * jnp.minimum(si_c, s_c)).astype(jnp.int32) - 1
            else:
                common_min = jnp.floor(
                    jmin_num * (si_c + s_c) / jmin_den).astype(jnp.int32) - 1
            thresh = common_min - jnp.minimum(coll[:, None], vcoll[None, :])
            mni = jnp.minimum(sizes[:, None], vsizes[None, :])
            mxi = jnp.maximum(sizes[:, None], vsizes[None, :])
            ok = (shared >= thresh) & (mni > 0)
            if radio:  # 0 = no size-ratio gate
                ok &= (mxi <= radio * mni)
            ok &= _ownership_mask(t, n_dev, row_ids, vis_ids)
            perm = [(k, (k + 1) % n_dev) for k in range(n_dev)]
            vxp = jax.lax.ppermute(vxp, "data", perm)
            vcoll = jax.lax.ppermute(vcoll, "data", perm)
            vsizes = jax.lax.ppermute(vsizes, "data", perm)
            vis_ids = jax.lax.ppermute(vis_ids, "data", perm)
            return (vxp, vcoll, vsizes, vis_ids), pack_mask_u8(ok)

        init = (xp, coll, sizes, row_ids)
        _, masks = jax.lax.scan(
            step, init, jnp.arange(_n_ring_steps(n_dev), dtype=jnp.int32))
        return masks  # (n_steps, shard, shard//8)

    return fn


def dist_lp_round_fn(masks, labels, clr):
    """shard_map-able Boruvka round over the resident mask slabs.

    masks: per-device (n_steps, shard, shard//8), donated; labels: global
    (n_pad,) replicated; clr: per-device FUSED clear list
    [step(C), local row(C), byte(C), bit value(C)] int32 — one
    host->device push instead of four (each separate push pays the
    link's fixed per-transfer overhead).  Returns (new_masks, row_p
    sharded (n_pad,), fused replicated [cross, col_p (n_pad,)])."""
    import jax
    import jax.numpy as jnp
    from ..ops.labelprop import SENT

    n_dev = jax.lax.axis_size("data")
    d = jax.lax.axis_index("data")
    n_steps, shard, _ = masks.shape
    n_pad = labels.shape[0]
    cap = clr.shape[0] // 4
    clr_t = clr[:cap]
    clr_r = clr[cap:2 * cap]
    clr_b = clr[2 * cap:3 * cap]
    clr_sub = clr[3 * cap:].astype(jnp.uint8)
    masks = masks.at[clr_t, clr_r, clr_b].add(-clr_sub)
    shifts = jnp.arange(8, dtype=jnp.uint8)
    iota = jax.lax.iota(jnp.int32, shard)
    lr = jax.lax.dynamic_slice(labels, (d * shard,), (shard,))

    def step(carry, xs):
        col_p, row_p, cross = carry
        pk, t = xs
        b = (d - t) % n_dev
        bits = ((pk[:, :, None] >> shifts[None, None, :]) & jnp.uint8(1))
        m = bits.reshape(shard, shard).astype(jnp.bool_)
        lc = jax.lax.dynamic_slice(labels, (b * shard,), (shard,))
        m = m & (lr[:, None] != lc[None, :])
        cross = cross + jnp.sum(m, dtype=jnp.int32)
        colv = jnp.where(m, iota[None, :] + b * shard, SENT)
        rowv = jnp.where(m, iota[:, None] + d * shard, SENT)
        row_p = jnp.minimum(row_p, jnp.min(colv, axis=1))
        cmin = jnp.min(rowv, axis=0)
        cur = jax.lax.dynamic_slice(col_p, (b * shard,), (shard,))
        col_p = jax.lax.dynamic_update_slice(
            col_p, jnp.minimum(cur, cmin), (b * shard,))
        return (col_p, row_p, cross), None

    init = (jnp.full((n_pad,), SENT, dtype=jnp.int32),
            jnp.full((shard,), SENT, dtype=jnp.int32), jnp.int32(0))
    (col_p, row_p, cross), _ = jax.lax.scan(
        step, init, (masks, jnp.arange(n_steps, dtype=jnp.int32)))
    col_p = jax.lax.pmin(col_p, "data")
    cross = jax.lax.psum(cross, "data")
    fused = jnp.concatenate([cross[None], col_p])
    return masks, row_p, fused


def _dist_lp_clear(fi, fj, shard: int, n_dev: int, n_steps: int):
    """Host-side clear-list encode for the mesh slabs: pair (i > j) ->
    (device, step, local row, byte, bit) under the triangular ownership
    rule (mirrors _ownership_mask; each bit exists on exactly one
    device/step).  Returns (D*C,) arrays, C ladder-padded per device."""
    from ..ops.labelprop import _clear_quantum

    a = fi // shard
    b = fj // shard
    t_ab = (a - b) % n_dev
    own_a = t_ab < n_steps
    dev = np.where(own_a, a, b)
    stp = np.where(own_a, t_ab, (b - a) % n_dev)
    row = np.where(own_a, fi % shard, fj % shard)
    col = np.where(own_a, fj % shard, fi % shard)
    per_dev = np.bincount(dev, minlength=n_dev) if len(dev) else \
        np.zeros(n_dev, dtype=np.int64)
    cap = _clear_quantum(int(per_dev.max()) if len(dev) else 0)
    ct = np.zeros((n_dev, cap), dtype=np.int32)
    cr = np.zeros((n_dev, cap), dtype=np.int32)
    cb = np.zeros((n_dev, cap), dtype=np.int32)
    cs = np.zeros((n_dev, cap), dtype=np.uint8)
    fill = np.zeros(n_dev, dtype=np.int64)
    for k in range(len(dev)):
        dv = int(dev[k])
        p = fill[dv]
        fill[dv] += 1
        ct[dv, p] = stp[k]
        cr[dv, p] = row[k]
        cb[dv, p] = col[k] // 8
        cs[dv, p] = 1 << (col[k] % 8)
    return (ct.reshape(-1), cr.reshape(-1), cb.reshape(-1),
            cs.reshape(-1), cap)


@functools.lru_cache(maxsize=8)
def _jitted_dist_lp(mesh, jmin_num: float, jmin_den: float,
                    c_min: float, radio: int, is_containment: bool):
    """(build, round) jitted shard_map programs, cached per (mesh, bound)
    so repeat calls reuse the in-memory trace (jax Mesh is hashable)."""
    import jax
    from jax.sharding import PartitionSpec as P

    build = jax.jit(jax.shard_map(
        build_ring_masks_fn(jmin_num, jmin_den, c_min, radio,
                            is_containment),
        mesh=mesh, in_specs=(P("data"),) * 4, out_specs=P("data"),
        check_vma=False))
    rnd = jax.jit(jax.shard_map(
        dist_lp_round_fn, mesh=mesh,
        in_specs=(P("data"), P(), P("data")),
        out_specs=(P("data"), P("data"), P()), check_vma=False),
        donate_argnums=(0,))
    return build, rnd


def distributed_threshold_clusters_lp(hashes, threshold: float,
                                      kmer_size: int,
                                      is_containment: bool = False,
                                      mesh=None, bits: int = 8192,
                                      max_rounds: int = 256):
    """Exact single-linkage clusters over the mesh via resident-mask label
    propagation — the distributed twin of the bench headline engine
    (ops.labelprop.threshold_clusters_device_lp).  Per-device memory is
    N^2/8/n_dev mask bytes (the mesh IS the panel streaming: 8 cards hold
    1M genomes' masks at ~8.7 GB each); per-round host traffic is O(N).
    Exactness: the same argument as the single-chip engine — the slabs
    jointly hold every unordered pair exactly once (triangular ownership),
    rounds only retire pairs by verified merge, verified clear, or
    same-label gating."""
    import math
    from ..cluster.mst import clusters_from_forest, sort_edges
    from ..cluster.union_find import UnionFind
    from ..distance.mash import min_jaccard_for_threshold, size_ratio_limit
    from ..ops import bitmap as bm
    from ..ops.cluster_fast import gated_verify_merge
    from ..ops.labelprop import SENT, _clear_quantum

    n = len(hashes)
    if n == 0:
        return []
    if mesh is None:
        mesh = make_mesh()
    n_dev = int(mesh.devices.size)
    n_steps = _n_ring_steps(n_dev)
    # shard rows must divide by 8 (bit-packed mask columns); 128 keeps
    # every shard a multiple of the filter's row tiles
    xp, coll = bm.pack_bitmaps_packed(hashes, bits=bits,
                                      pad_n_to=n_dev * 128)
    n_pad = xp.shape[0]
    shard = n_pad // n_dev
    sizes = np.zeros(n_pad, dtype=np.int32)
    sizes[:n] = [len(h) for h in hashes]
    row_ids = np.arange(n_pad, dtype=np.int32)
    j_min = min_jaccard_for_threshold(threshold, kmer_size)
    c_min = math.exp(-threshold * kmer_size)
    radio = size_ratio_limit(threshold, kmer_size - 1)
    build, rnd = _jitted_dist_lp(
        mesh, j_min, 1.0 + j_min, c_min, radio, is_containment)

    masks = build(*_shard_rows(mesh, xp, coll, sizes, row_ids))
    uf = UnionFind(n)
    csr = bm.CsrSketches(hashes)
    sizes64 = sizes.astype(np.int64)
    kept_i: list = []
    kept_j: list = []
    kept_d: list = []

    def labels_arr():
        roots = np.full(n_pad, -1, dtype=np.int32)
        roots[:n] = uf.roots_array()[:n]
        roots[n:] = n + np.arange(n_pad - n, dtype=np.int32)
        return roots

    cap = _clear_quantum(0)
    clr = np.zeros(n_dev * 4 * cap, dtype=np.int32)
    rounds = 0
    g = np.arange(n_pad, dtype=np.int64)
    while rounds < max_rounds:
        rounds += 1
        masks, row_p_dev, fused_dev = rnd(
            masks, _replicate(mesh, labels_arr()), *_shard_rows(mesh, clr))
        row_p = np.asarray(row_p_dev)
        fused = np.asarray(fused_dev)
        bm._account_pull(row_p.nbytes + fused.nbytes)
        cross = int(fused[0])
        if cross == 0:
            break
        col_p = fused[1:]
        rp = row_p < SENT
        ri, rj = g[rp], row_p[rp].astype(np.int64)
        ki, kj, kd, ok_r = gated_verify_merge(
            uf, csr, sizes64, ri, rj, threshold, kmer_size, is_containment)
        kept_i.extend(ki.tolist())
        kept_j.extend(kj.tolist())
        kept_d.extend(kd.tolist())
        cp = col_p < SENT
        ci, cj = col_p[cp].astype(np.int64), g[cp]
        roots = uf.roots_array()
        alive = roots[ci] != roots[cj]
        ci, cj = ci[alive], cj[alive]
        ki, kj, kd, ok_c = gated_verify_merge(
            uf, csr, sizes64, ci, cj, threshold, kmer_size, is_containment)
        kept_i.extend(ki.tolist())
        kept_j.extend(kj.tolist())
        kept_d.extend(kd.tolist())
        fi = np.concatenate([ri[~ok_r], ci[~ok_c]])
        fj = np.concatenate([rj[~ok_r], cj[~ok_c]])
        if len(fi):
            _, sel = np.unique(fi * n_pad + fj, return_index=True)
            fi, fj = fi[sel], fj[sel]
        ct, cr, cb, cs, cap2 = _dist_lp_clear(fi, fj, shard, n_dev,
                                              n_steps)
        # fused device-major layout: per device [t, r, b, sub] (C each)
        clr = np.concatenate(
            [ct.reshape(n_dev, cap2), cr.reshape(n_dev, cap2),
             cb.reshape(n_dev, cap2),
             cs.reshape(n_dev, cap2).astype(np.int32)],
            axis=1).reshape(-1)
    else:
        # pathological-input fallback (single-chip _lp_fallback twin):
        # pull the remaining slabs once and finish with the gated host
        # verifier — exact, just no longer O(N)-pull
        from ..ops.cluster_fast import _gated_verify_block
        mk = np.asarray(masks)
        for dv in range(n_dev):
            for t in range(n_steps):
                slab = mk[dv * n_steps + t]
                bits2d = np.unpackbits(slab, axis=1, bitorder="little")
                il, jl = np.nonzero(bits2d)
                ii = il.astype(np.int64) + dv * shard
                jj = jl.astype(np.int64) + ((dv - t) % n_dev) * shard
                ii, jj = np.maximum(ii, jj), np.minimum(ii, jj)
                inb = (ii < n) & (jj < n)
                ii, jj = ii[inb], jj[inb]
                roots = uf.roots_array()
                keep = roots[ii] != roots[jj]
                _gated_verify_block(uf, csr, sizes64, ii[keep], jj[keep],
                                    threshold, kmer_size, is_containment,
                                    kept_i, kept_j, kept_d)

    DIST_LP_LAST.update(rounds=rounds, n_pad=n_pad, n_dev=n_dev,
                        bits=bits)
    forest = sort_edges((np.asarray(kept_i, dtype=np.int64),
                         np.asarray(kept_j, dtype=np.int64),
                         np.asarray(kept_d, dtype=np.float64)))
    return clusters_from_forest(forest, n)


# last mesh-lp run's shape facts, for communication accounting
DIST_LP_LAST: dict = {}


def dist_lp_comm_stats(n_pad: int, n_dev: int, bits: int, rounds: int
                       ) -> dict:
    """Per-device interconnect volume of the mesh labelprop engine.

    Analytic, not sampled: the compiled programs are static, so the
    collective payloads are exactly the buffers in the code —
    build ring (build_ring_masks_fn): ``n_steps`` hops each ppermuting
    vxp (shard x bits/8 u8) + vcoll/vsizes/vis_ids (shard i32);
    each Boruvka round (dist_lp_round_fn): pmin over col_p (n_pad i32)
    + psum of one i32, costed at the ring-allreduce volume
    2(n_dev-1)/n_dev x payload per device.  This is the quantity a
    projection divides by the interconnect's bandwidth (wall clock on the
    core-shared virtual mesh cannot evidence it)."""
    shard = n_pad // max(n_dev, 1)
    n_steps = _n_ring_steps(n_dev)
    # a 1-device "ring" self-permutes in device memory: nothing crosses
    # the interconnect
    hop = (shard * (bits // 8) + 3 * shard * 4) if n_dev > 1 else 0
    ar = 2.0 * (n_dev - 1) / max(n_dev, 1)
    per_round = int(ar * (n_pad * 4 + 4))
    return {
        "link_bytes_per_hop": hop,
        "build_hops": n_steps,
        "build_link_bytes_per_device": n_steps * hop,
        "allreduce_bytes_per_round_per_device": per_round,
        "rounds": rounds,
        "total_link_bytes_per_device": n_steps * hop + rounds * per_round,
    }


def ring_comm_stats(n_pad: int, n_dev: int, row_bytes: int,
                    extra_i32_vectors: int = 3) -> dict:
    """Per-device interconnect volume of the ppermute ring engines
    (build_ring_bitmap_fn / build_ring_edges_fn / build_ring_fn): each of
    the n_steps hops moves the visiting shard's payload
    (shard x row_bytes) plus ``extra_i32_vectors`` shard-length i32
    vectors (sizes/ids/collision counts)."""
    shard = n_pad // max(n_dev, 1)
    n_steps = _n_ring_steps(n_dev)
    hop = (shard * row_bytes + extra_i32_vectors * shard * 4) \
        if n_dev > 1 else 0
    return {
        "link_bytes_per_hop": hop,
        "hops": n_steps,
        "total_link_bytes_per_device": n_steps * hop,
    }
